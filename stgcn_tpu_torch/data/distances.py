"""Gravity-center distance precompute for spatial-configuration partitioning.

The port's copy of ``stgcn_tpu/data/distances.py`` (numpy only).

Counterpart of src/data/calculate_distances.py:7-48: for every joint, the
mean Euclidean distance to the per-frame gravity center (mean x, mean y over
joints), averaged over every frame of every sequence in the dataset.
Vectorized over frames instead of the reference's per-frame Python loop.
"""

from __future__ import annotations

import os

import numpy as np


def sequence_distances(seq: np.ndarray) -> tuple[np.ndarray, int]:
    """Summed per-joint gravity-center distances for one ``(T, V, >=2)`` seq.

    Returns ``(sums (V,), frame_count)``.
    """
    xy = seq[:, :, :2].astype(np.float64)
    grav = xy.mean(axis=1, keepdims=True)  # (T, 1, 2)
    dist = np.linalg.norm(xy - grav, axis=-1)  # (T, V)
    return dist.sum(axis=0), seq.shape[0]


def calculate_distances(dataset, num_joints: int = 25) -> np.ndarray:
    """Mean gravity-center distance per joint over an indexable dataset."""
    total = np.zeros(num_joints)
    count = 0
    for i in range(len(dataset)):
        s, n = sequence_distances(dataset.raw(i))
        total += s
        count += n
    return total / max(count, 1)


def calculate_distances_from_dir(data_dir: str, output_file: str | None = None,
                                 num_joints: int = 25) -> np.ndarray:
    """Directory-of-npy variant matching the reference CLI usage."""
    total = np.zeros(num_joints)
    count = 0
    for f in sorted(os.listdir(data_dir)):
        if not f.endswith(".npy"):
            continue
        seq = np.load(os.path.join(data_dir, f))
        s, n = sequence_distances(seq)
        total += s
        count += n
    out = total / max(count, 1)
    if output_file:
        os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
        np.save(output_file, out)
    return out
