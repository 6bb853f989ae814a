"""Serving-side collation: wrap-padding and length buckets.

The port's copy of ``wrap_pad``, ``default_buckets`` and ``bucket_length``
from ``stgcn_tpu/data/collate.py:23-55`` (numpy only).  The reference pads
every sequence by *wrapping* (tiling from the start), so padded frames are
real repeated motion and global average pooling over the padded extent is
harmless (src/data/util.py:12-47).  Buckets bound the number of distinct
batch shapes.
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
