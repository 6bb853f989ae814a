"""Batch collation: wrap-padding, length buckets, fixed-length batches.

The port's copy of ``stgcn_tpu/data/collate.py:23-129`` (numpy only):
``wrap_pad``, ``default_buckets``, ``bucket_length``, ``collate`` and
``batches``.  The reference pads every sequence by *wrapping* (tiling from
the start), so padded frames are real repeated motion and global average
pooling over the padded extent is harmless (src/data/util.py:12-47).
Buckets, or one fixed length, bound the number of distinct batch shapes.
``native_batches`` yields the same batches through the C++ loader
(:mod:`stgcn_tpu_torch.data.native_loader`).
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np


def wrap_pad(seq: np.ndarray, target_len: int) -> np.ndarray:
    """Pad ``(T, V, C)`` along T to ``target_len`` by wrapping from the start.

    Sequences longer than ``target_len`` are cropped from the front.
    """
    t = seq.shape[0]
    if t == target_len:
        return seq
    if t > target_len:
        return seq[:target_len]
    reps = -(-target_len // t)  # ceil
    return np.tile(seq, (reps, 1, 1))[:target_len]


def default_buckets(max_len: int = 1024) -> tuple[int, ...]:
    """Power-of-two-ish bucket edges: 64, 96, 128, 192, ... up to max_len."""
    edges = []
    b = 64
    while b < max_len:
        edges += [b, b + b // 2]
        b *= 2
    return tuple(e for e in edges if e <= max_len) + (max_len,)


def bucket_length(t: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if t <= b:
            return b
    return buckets[-1]


def target_length(max_len: int, mode: str,
                  buckets: Sequence[int] | None = None,
                  fixed_len: int | None = None) -> int:
    """The padded length of a batch whose longest sequence has
    ``max_len`` frames, by collate ``mode`` (:func:`collate`)."""
    if mode == "max":
        return max_len
    if mode == "bucket":
        return bucket_length(max_len, default_buckets() if buckets is None
                             else buckets)
    if mode == "fixed":
        if fixed_len is None:
            raise ValueError("fixed mode needs fixed_len")
        return fixed_len
    raise ValueError(f"unknown collate mode: {mode!r}")


def collate(
    batch: Sequence[tuple[np.ndarray, int]],
    mode: str = "max",
    buckets: Sequence[int] | None = None,
    fixed_len: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack ``[(seq (T_i, V, C), label)]`` into a batch.

    Args:
      mode: ``"max"`` (reference parity: pad to batch max), ``"bucket"``
        (pad to the smallest bucket edge >= batch max) or ``"fixed"``
        (wrap-pad/crop everything to ``fixed_len``).

    Returns:
      ``(x (N, T*, V, C), labels (N,), lengths (N,))``; lengths are the
      original frame counts.
    """
    lengths = np.asarray([seq.shape[0] for seq, _ in batch], np.int32)
    target = target_length(int(lengths.max()), mode, buckets, fixed_len)
    x = np.stack([wrap_pad(seq, target) for seq, _ in batch])
    labels = np.asarray([lbl for _, lbl in batch], np.int64)
    return x, labels, lengths


def batches(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
    mode: str = "max",
    buckets: Sequence[int] | None = None,
    fixed_len: int | None = None,
    sort_by_length: bool = False,
):
    """Yield collated batches from an indexable dataset.

    ``sort_by_length`` groups similar-length sequences (before shuffling
    the batch order) to keep padding small.
    """
    lengths = dataset.sequence_lengths() if sort_by_length else None
    for chunk in batch_chunks(len(dataset), batch_size, lengths=lengths,
                              shuffle=shuffle, seed=seed,
                              drop_remainder=drop_remainder):
        batch = [dataset[int(i)] for i in chunk]
        yield collate(batch, mode=mode, buckets=buckets, fixed_len=fixed_len)


def batch_chunks(n: int, batch_size: int, *,
                 lengths: np.ndarray | None = None, shuffle: bool = False,
                 seed: int = 0, drop_remainder: bool = False
                 ) -> list[np.ndarray]:
    """The dataset indices of each batch.  With ``lengths``, the indices
    are sorted by length (stable) and the batch order is shuffled; without,
    the indices are shuffled.  ``drop_remainder`` drops a short last
    batch."""
    order = np.arange(n)
    rng = np.random.default_rng(seed)
    if lengths is not None:
        order = order[np.argsort(lengths, kind="stable")]
        starts = np.arange(0, n, batch_size)
        if shuffle:
            rng.shuffle(starts)
        chunks = [order[s:s + batch_size] for s in starts]
    else:
        if shuffle:
            rng.shuffle(order)
        chunks = [order[s:s + batch_size] for s in range(0, n, batch_size)]
    return [c for c in chunks
            if not (drop_remainder and len(c) < batch_size)]


def native_batches(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    seed: int = 0,
    drop_remainder: bool = False,
    mode: str = "fixed",
    buckets: Sequence[int] | None = None,
    fixed_len: int | None = None,
    sort_by_length: bool = False,
    n_threads: int = 0,
):
    """:func:`batches` through the C++ loader (port of the JAX
    ``native_batches``, ``stgcn_tpu/data/collate.py:132-194``).

    Whole batches are read, stripped of the confidence channel and
    wrap-padded in the loader's thread pool, past the dataset's per-item
    ``__getitem__`` and its cache; frame counts come from the files'
    headers.  Augmentation, where the dataset has ``transforms``, runs per
    sequence after padding, which equals the numpy path's pad-after-augment
    order because the transforms are affine and wrap-padding repeats
    frames.  The chunks are :func:`batches`' own, so without augmentation
    the two yield the same arrays.
    """
    from stgcn_tpu_torch.data.native_loader import (
        collate_batch_native,
        npy_frames,
    )

    lengths = np.asarray([npy_frames(p) for p in dataset.files])
    keep_c = 3 if dataset.keep_confidence else 2
    for chunk in batch_chunks(len(dataset), batch_size,
                              lengths=lengths if sort_by_length else None,
                              shuffle=shuffle, seed=seed,
                              drop_remainder=drop_remainder):
        lens = lengths[chunk]
        target = target_length(int(lens.max()), mode, buckets, fixed_len)
        x = collate_batch_native([dataset.files[int(i)] for i in chunk],
                                 target, keep_c=keep_c, n_threads=n_threads)
        if dataset.transforms is not None:
            for j in range(x.shape[0]):
                if dataset.rng.random() < dataset.augment_prob:
                    x[j] = dataset.transforms(x[j], dataset.rng)
        yield x, dataset.labels[chunk].astype(np.int64), lens.astype(np.int32)
