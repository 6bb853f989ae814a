"""Skeleton sequence dataset and metadata splits (port of
``stgcn_tpu/data/datasets.py``), without pandas.

A ``metadata.csv`` with columns ``subject, action, scenario, filename``
indexes per-video ``.npy`` arrays of shape ``(T, V, 3)`` (x, y, OpenPose
confidence); the loader drops the confidence column and yields ``(T, V, 2)``
float sequences plus an integer label (the reference's
``KTHDataset``/``SplitDataset``, src/data/datasets.py:15-165).

The GPU machine has no pandas, so the table is read with the ``csv`` module
into a dictionary of columns (:func:`read_metadata`), each column typed as
``pandas.read_csv`` would type it (int, else float, else str).  Every split
returns the row indices the JAX package returns for the same file.
"""

from __future__ import annotations

import csv
import os
from collections.abc import Callable, Sequence

import numpy as np

from stgcn_tpu_torch.graph.skeleton import label_name_to_number

Table = dict[str, list]


def _typed(values: list[str]) -> list:
    for kind in (int, float):
        try:
            return [kind(v) for v in values]
        except ValueError:
            continue
    return values


def read_metadata(path: str) -> Table:
    """``{column: [value per row]}`` of a CSV file with a header row."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: _typed([row[j] for row in body])
            for j, name in enumerate(header)}


def _rows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


class MetadataSplitter:
    """Train/val/test index splits over the metadata table.

    Mirrors ``SplitDataset`` (src/data/datasets.py:15-77): cross-subject
    (sorted subjects 15/5/5 by default), cross-scenario (d1-d4 membership)
    and stratified-by-action splits, each returning metadata row indices.
    """

    def __init__(self, metadata: Table | str):
        if isinstance(metadata, str):
            metadata = read_metadata(metadata)
        self.metadata = metadata

    def __len__(self) -> int:
        return _rows(self.metadata)

    def _where(self, column: str, keep) -> list[int]:
        return [i for i, v in enumerate(self.metadata[column]) if keep(v)]

    def split_by_subject(
        self, train: int = 15, val: int = 5, test: int = 5,
        randomize: bool = False, seed: int | None = None,
    ) -> tuple[list[int], list[int], list[int]]:
        subjects = sorted(set(self.metadata["subject"]))
        if train + val + test != len(subjects):
            raise ValueError(
                f"split {train}+{val}+{test} != {len(subjects)} subjects")
        if randomize:
            rng = np.random.default_rng(seed)
            subjects = list(rng.permutation(subjects))
        parts = (subjects[:train], subjects[train:train + val],
                 subjects[train + val:])
        out = tuple(self._where("subject", lambda s, p=set(p): s in p)
                    for p in parts)
        assert sum(map(len, out)) == len(self)
        return out

    def split_by_scenario(
        self, train_scenarios: Sequence[str], val_scenarios: Sequence[str],
    ) -> tuple[list[int], list[int], list[int]]:
        tr_s, va_s = set(train_scenarios), set(val_scenarios)
        tr = self._where("scenario", lambda s: s in tr_s)
        va = self._where("scenario", lambda s: s in va_s)
        te = self._where("scenario", lambda s: s not in tr_s | va_s)
        assert len(tr) + len(va) + len(te) == len(self)
        return tr, va, te

    def split_stratified(
        self, train_frac: float = 0.6, val_frac: float = 0.2,
        test_frac: float = 0.2, seed: int = 0,
    ) -> tuple[list[int], list[int], list[int]]:
        """Per-action stratified split (reference: sklearn train_test_split
        with random_state=0, src/data/datasets.py:64-77).  The actions are
        visited in sorted order, as pandas' ``groupby`` visits them, so the
        per-action shuffles draw what the JAX package's draw."""
        rng = np.random.default_rng(seed)
        tr, va, te = [], [], []
        total = train_frac + val_frac + test_frac
        for action in sorted(set(self.metadata["action"])):
            idx = self._where("action", lambda a: a == action)
            rng.shuffle(idx)
            n = len(idx)
            n_tr = int(round(n * train_frac / total))
            n_va = int(round(n * val_frac / total))
            tr += idx[:n_tr]
            va += idx[n_tr:n_tr + n_va]
            te += idx[n_tr + n_va:]
        assert len(tr) + len(va) + len(te) == len(self)
        return sorted(tr), sorted(va), sorted(te)


class SkeletonDataset:
    """Indexable skeleton-sequence dataset.

    Args:
      metadata: metadata table (:func:`read_metadata`) or path to
        ``metadata.csv``.
      data_dir: folder holding the per-video ``.npy`` files.
      indices: optional metadata row filter (a split).
      transforms: optional per-fetch augmentation ``f(seq (T,V,2), rng) ->
        (T,V,2)``; applied with probability ``augment_prob`` per fetch
        (reference: 50% coin at src/data/datasets.py:154).
      keep_confidence: keep the third OpenPose channel instead of dropping
        it.
      preload: load all sequences into RAM up front.
      seed: RNG seed for the augmentation coin + transform draws.
    """

    def __init__(
        self,
        metadata: Table | str,
        data_dir: str,
        indices: Sequence[int] | None = None,
        transforms: Callable | None = None,
        augment_prob: float = 0.5,
        keep_confidence: bool = False,
        preload: bool = True,
        seed: int = 0,
    ):
        if isinstance(metadata, str):
            metadata = read_metadata(metadata)
        if indices is not None:
            rows = [int(i) for i in indices]
            metadata = {k: [v[i] for i in rows] for k, v in metadata.items()}
        self.metadata = metadata
        self.data_dir = data_dir
        self.transforms = transforms
        self.augment_prob = augment_prob
        self.keep_confidence = keep_confidence
        self.labels = np.asarray(
            [label_name_to_number(a) for a in metadata["action"]], np.int32)
        self.files = [os.path.join(data_dir, f) for f in metadata["filename"]]
        self.rng = np.random.default_rng(seed)
        self._cache: dict[int, np.ndarray] = {}
        if preload:
            for i in range(len(self.files)):
                self._cache[i] = self._load(i)

    def _load(self, i: int) -> np.ndarray:
        seq = np.load(self.files[i]).astype(np.float32)  # (T, V, 3)
        if not self.keep_confidence:
            seq = seq[:, :, :2]
        return seq

    def __len__(self) -> int:
        return len(self.labels)

    def sequence_lengths(self) -> np.ndarray:
        return np.asarray([self.raw(i).shape[0] for i in range(len(self))])

    def raw(self, i: int) -> np.ndarray:
        """Un-augmented sequence (cached)."""
        if i not in self._cache:
            self._cache[i] = self._load(i)
        return self._cache[i]

    def __getitem__(self, i: int) -> tuple[np.ndarray, int]:
        seq = self.raw(i)
        if (self.transforms is not None
                and self.rng.random() < self.augment_prob):
            seq = self.transforms(seq, self.rng)
        return seq, int(self.labels[i])
