"""The C++ batch loader of the port (``stgcn_tpu_torch.data.native_loader``).

It builds ``native/npy_loader.cc`` with g++ into ``build/stgcn_tpu_torch/``
under a name that hashes the source, and never touches the JAX package's
``native/libstgcn_native.so`` (its mtime and bytes are the same after a
build and a load).  ``collate_batch_native`` and ``native_batches`` give
the port's numpy ``collate``/``batches`` bitwise, in fixed, bucket and max
modes, with and without length sorting and shuffling; a file it cannot read
raises ``IOError``; the train CLI says which loader ran.
"""

import hashlib
import os

import numpy as np
import pytest

from stgcn_tpu_torch.cli import train as cli_train
from stgcn_tpu_torch.data import (
    SkeletonDataset,
    batches,
    collate,
    generate_dataset,
    native_batches,
    native_loader,
)

ROOT = native_loader.REPO_ROOT
JAX_LIB = ROOT / "native" / "libstgcn_native.so"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    meta = generate_dataset(str(d), num_subjects=2, seed=3)
    return SkeletonDataset(meta, str(d))


def fingerprint(path):
    return (os.stat(path).st_mtime_ns,
            hashlib.sha256(path.read_bytes()).hexdigest())


def test_builds_into_the_build_directory_and_leaves_the_jax_library():
    before = fingerprint(JAX_LIB)
    lib = native_loader.build()
    native_loader.load_library()
    assert lib == native_loader.library_path() and lib.exists()
    assert lib.parent == ROOT / "build" / "stgcn_tpu_torch"
    digest = hashlib.sha256(native_loader.SOURCE.read_bytes()).hexdigest()
    assert lib.name == f"libstgcn_native-{digest}.so"
    assert fingerprint(JAX_LIB) == before


def bitwise(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def test_collate_batch_native_equals_collate(dataset):
    idx = [0, 5, 9, 3]
    for mode, target in (("fixed", 40), ("max", None), ("bucket", None)):
        want, _, lengths = collate([dataset[i] for i in idx], mode=mode,
                                   fixed_len=target)
        got = native_loader.collate_batch_native(
            [dataset.files[i] for i in idx], want.shape[1])
        assert bitwise(got, want), mode
        assert [native_loader.npy_frames(dataset.files[i])
                for i in idx] == lengths.tolist()


@pytest.mark.parametrize("mode", ["fixed", "bucket", "max"])
@pytest.mark.parametrize("sort_by_length,shuffle", [(True, True),
                                                    (False, True),
                                                    (False, False)])
def test_native_batches_equal_batches(dataset, mode, sort_by_length,
                                      shuffle):
    kw = dict(shuffle=shuffle, seed=4, sort_by_length=sort_by_length,
              mode=mode, fixed_len=48, drop_remainder=False)
    want = list(batches(dataset, 8, **kw))
    got = list(native_batches(dataset, 8, **kw))
    assert len(got) == len(want) == -(-len(dataset) // 8)
    for g, w in zip(got, want):
        assert all(bitwise(a, b) for a, b in zip(g, w))


def test_reused_output_buffer_and_its_checks(dataset):
    out = np.full((2, 30, 25, 2), np.nan, np.float32)
    got = native_loader.collate_batch_native(dataset.files[:2], 30, out=out)
    assert got is out and np.isfinite(out).all()
    with pytest.raises(ValueError, match="C-contiguous float32"):
        native_loader.collate_batch_native(dataset.files[:2], 30,
                                           out=np.empty((2, 31, 25, 2),
                                                        np.float32))


def test_missing_file_raises_ioerror(dataset, tmp_path):
    missing = str(tmp_path / "absent.npy")
    with pytest.raises(IOError):
        native_loader.collate_batch_native([dataset.files[0], missing], 16)
    with pytest.raises(IOError, match="cannot read npy header"):
        native_loader.npy_frames(missing)


def test_the_cli_says_which_loader_ran(monkeypatch, capsys):
    assert cli_train.choose_batches(True) is native_batches
    assert "[data] using native C++ batch loader" in capsys.readouterr().out
    assert cli_train.choose_batches(False) is batches
    assert "numpy batches (--data.use_native_loader false)" in \
        capsys.readouterr().out

    def broken():
        raise RuntimeError("g++ failed (1): no compiler")

    monkeypatch.setattr(native_loader, "load_library", broken)
    assert cli_train.choose_batches(True) is batches
    out = capsys.readouterr().out
    assert "numpy batches: the native C++ batch loader did not build" in out
    assert "no compiler" in out
