"""Batch collation: wrap-padding, length buckets, fixed-length batches.

The port's copy of ``stgcn_tpu/data/collate.py:23-129`` (numpy only):
``wrap_pad``, ``default_buckets``, ``bucket_length``, ``collate`` and
``batches``.  The reference pads every sequence by *wrapping* (tiling from
the start), so padded frames are real repeated motion and global average
pooling over the padded extent is harmless (src/data/util.py:12-47).
Buckets, or one fixed length, bound the number of distinct batch shapes.
The JAX package's ``native_batches`` (the C++ loader) is not ported yet.
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
    if mode == "max":
        target = int(lengths.max())
    elif mode == "bucket":
        if buckets is None:
            buckets = default_buckets()
        target = bucket_length(int(lengths.max()), buckets)
    elif mode == "fixed":
        if fixed_len is None:
            raise ValueError("fixed mode needs fixed_len")
        target = fixed_len
    else:
        raise ValueError(f"unknown collate mode: {mode!r}")

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
    order = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    if sort_by_length:
        lengths = dataset.sequence_lengths()
        order = order[np.argsort(lengths, kind="stable")]
        starts = np.arange(0, len(order), batch_size)
        if shuffle:
            rng.shuffle(starts)
        chunks = [order[s:s + batch_size] for s in starts]
    else:
        if shuffle:
            rng.shuffle(order)
        chunks = [order[s:s + batch_size]
                  for s in range(0, len(order), batch_size)]

    for chunk in chunks:
        if drop_remainder and len(chunk) < batch_size:
            continue
        batch = [dataset[int(i)] for i in chunk]
        yield collate(batch, mode=mode, buckets=buckets, fixed_len=fixed_len)
