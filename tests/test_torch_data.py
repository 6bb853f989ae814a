"""The port's data pipeline (``stgcn_tpu_torch.data``, no pandas) against
the JAX package's ``stgcn_tpu.data``.

Held here, exactly (numpy on both sides, from the same seeds):

* ``generate_dataset`` (three subjects, both styles) writes byte-identical
  ``.npy`` files and ``metadata.csv``;
* the three splits give equal row-index lists, ``split_stratified`` and
  the randomized subject split included, also on a table whose subject
  column pandas reads as integers (sorted as numbers, not as text);
* ``collate`` and ``batches`` give equal batches in every mode ("max",
  "bucket", "fixed"), with ``sort_by_length``, shuffling and
  ``drop_remainder``, and with augmentation inside the dataset;
* augmentation draws from one ``default_rng`` seed are equal;
* ``calculate_distances`` and ``calculate_distances_from_dir`` are equal;
* ``random_batch`` is equal; ``prefetch`` keeps the order and re-raises a
  producer's exception at the consumer.
"""

import os

import numpy as np
import pytest

from stgcn_tpu import data as jd
from stgcn_tpu_torch import data as td
from stgcn_tpu_torch.data.datasets import read_metadata


@pytest.fixture(scope="module")
def dataset_dirs(tmp_path_factory):
    """``{style: (port dir, JAX dir)}`` of a three-subject dataset."""
    out = {}
    for style in ("marginal", "relational"):
        dirs = tuple(str(tmp_path_factory.mktemp(f"{pkg}_{style}"))
                     for pkg in ("port", "jax"))
        td.generate_dataset(dirs[0], num_subjects=3, style=style, seed=4)
        jd.generate_dataset(dirs[1], num_subjects=3, style=style, seed=4)
        out[style] = dirs
    return out


@pytest.mark.parametrize("style", ["marginal", "relational"])
def test_synthetic_files_are_byte_identical(dataset_dirs, style):
    port, jax_dir = dataset_dirs[style]
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(jax_dir))
    assert len(names) == 3 * 6 * 4 - 1 + 1      # one video skipped, + csv
    for name in names:
        with open(os.path.join(port, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_split_indices_equal(dataset_dirs):
    meta = os.path.join(dataset_dirs["marginal"][0], "metadata.csv")
    ps, js = td.MetadataSplitter(meta), jd.MetadataSplitter(meta)
    cases = [("split_by_subject", dict(train=1, val=1, test=1)),
             ("split_by_subject", dict(train=2, val=0, test=1,
                                       randomize=True, seed=3)),
             ("split_by_scenario", dict(train_scenarios=["d1", "d2"],
                                        val_scenarios=["d3"])),
             ("split_stratified", dict(seed=0)),
             ("split_stratified", dict(seed=5, train_frac=0.5,
                                       val_frac=0.3, test_frac=0.2))]
    for name, kw in cases:
        got = getattr(ps, name)(**kw)
        want = getattr(js, name)(**kw)
        assert [list(map(int, s)) for s in got] == [
            list(map(int, s)) for s in want], (name, kw)
    with pytest.raises(ValueError, match="subjects"):
        ps.split_by_subject(train=1, val=1, test=2)


def test_numeric_columns_are_typed_as_pandas_types_them(tmp_path):
    """Subjects 1..12 read as integers sort 1, 2, ..., 10 (as numbers), so
    the subject split takes pandas' rows."""
    path = tmp_path / "metadata.csv"
    rows = [(s, a, f"d{1 + i % 4}", f"{s}_{a}.npy")
            for i, (s, a) in enumerate((s, a) for s in range(1, 13)
                                       for a in ("boxing", "walking"))]
    path.write_text("subject,action,scenario,filename\n" + "".join(
        f"{s},{a},{d},{f}\n" for s, a, d, f in rows))
    table = read_metadata(str(path))
    assert table["subject"][:3] == [1, 1, 2]
    assert table["scenario"][0] == "d1"
    got = td.MetadataSplitter(str(path)).split_by_subject(7, 3, 2)
    want = jd.MetadataSplitter(str(path)).split_by_subject(7, 3, 2)
    assert [list(map(int, s)) for s in got] == [list(map(int, s))
                                                for s in want]


def datasets(dirs, indices, **kw):
    port, _ = dirs
    meta = os.path.join(port, "metadata.csv")
    return (td.SkeletonDataset(meta, port, indices, **kw),
            jd.SkeletonDataset(meta, port, indices, **kw))


BATCH_CASES = [
    dict(mode="max"),
    dict(mode="bucket"),
    dict(mode="bucket", buckets=(150, 300, 500)),
    dict(mode="fixed", fixed_len=100),
    dict(mode="fixed", fixed_len=400, shuffle=True, seed=2),
    dict(mode="bucket", sort_by_length=True, shuffle=True, seed=7),
    dict(mode="max", sort_by_length=True, drop_remainder=True),
    dict(mode="max", shuffle=True, seed=1, drop_remainder=True),
]


@pytest.mark.parametrize("kw", BATCH_CASES,
                         ids=[str(i) for i in range(len(BATCH_CASES))])
def test_batches_equal(dataset_dirs, kw):
    pds, jds = datasets(dataset_dirs["marginal"], range(0, 71, 2))
    got = list(td.batches(pds, 5, **kw))
    want = list(jd.batches(jds, 5, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compat", [True, False])
def test_augmentation_draws_equal(dataset_dirs, compat):
    rng_p, rng_j = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(20):
        for a, b in zip(td.sample_transform(rng_p, compat),
                        jd.sample_transform(rng_j, compat)):
            np.testing.assert_array_equal(a, b)
    seq = np.random.default_rng(0).normal(0, 1, (30, 25, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(td.augment_sequence(seq, rng_p, compat),
                                  jd.augment_sequence(seq, rng_j, compat))
    # the dataset's augmentation coin and draws, through batches
    pds, jds = datasets(
        dataset_dirs["marginal"], None, seed=3,
        transforms=None)
    pds.transforms = td.make_augmenter(compat)
    jds.transforms = jd.make_augmenter(compat)
    for g, w in zip(td.batches(pds, 8, mode="fixed", fixed_len=64),
                    jd.batches(jds, 8, mode="fixed", fixed_len=64)):
        np.testing.assert_array_equal(g[0], w[0])


def test_distances_equal(dataset_dirs):
    pds, jds = datasets(dataset_dirs["marginal"], range(20))
    np.testing.assert_array_equal(td.calculate_distances(pds),
                                  jd.calculate_distances(jds))
    port_dir = dataset_dirs["relational"][0]
    np.testing.assert_array_equal(td.calculate_distances_from_dir(port_dir),
                                  jd.calculate_distances_from_dir(port_dir))


def test_random_batch_equal():
    for a, b in zip(td.random_batch(np.random.default_rng(5), 4, 20),
                    jd.random_batch(np.random.default_rng(5), 4, 20)):
        np.testing.assert_array_equal(a, b)


def test_prefetch_keeps_order_and_reraises():
    assert list(td.prefetch(iter(range(50)), depth=3)) == list(range(50))
    assert list(td.prefetch(range(4), depth=0)) == [0, 1, 2, 3]

    def failing():
        yield from range(3)
        raise ValueError("producer failed")

    got = []
    with pytest.raises(ValueError, match="producer failed"):
        for item in td.prefetch(failing()):
            got.append(item)
    assert got == [0, 1, 2]
