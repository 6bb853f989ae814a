"""Partitioned adjacency construction for the skeleton graph.

A copy of ``stgcn_tpu/graph/adjacency.py`` (numpy only), kept in this
package so that the port imports nothing of the JAX package.

Reimplements, from behavioral spec, the four partitioning strategies of the
reference (src/data/adjacency.py:34-158) and its degree normalization
(src/data/adjacency.py:161-183), as pure numpy host-side precompute.

Two normalization modes exist because the reference has a documented numerical
quirk (SURVEY.md Q1): it computes ``(diag(rowsum(A)) + alpha) ** (-1/2)``
*elementwise*, which turns every off-diagonal zero of the diagonal degree
matrix into ``alpha**-0.5`` and makes the "normalized" adjacency dense with
O(1e3) entries.  ``mode="reference"`` reproduces that exactly (needed for
per-layer allclose parity); ``mode="symmetric"`` is the mathematically
intended ``D^{-1/2} A D^{-1/2}`` and is the default for new training runs.
"""

from __future__ import annotations

import enum

import numpy as np

from stgcn_tpu_torch.graph.skeleton import (
    ADJACENCY_LIST,
    NUM_JOINTS,
    OPPOSITE_JOINTS,
)


class Strategy(enum.IntEnum):
    """Partitioning strategies, numbered as the reference CLI numbers them
    (src/data/adjacency.py:7-11)."""

    UNI_LABELING = 0
    DISTANCE = 1
    SPATIAL_CONFIGURATION = 2
    SYMMETRICAL = 3


class NormalizationMode(str, enum.Enum):
    REFERENCE = "reference"  # elementwise dense-Lambda quirk (SURVEY.md Q1)
    SYMMETRIC = "symmetric"  # D^-1/2 (A) D^-1/2
    ROW = "row"  # D^-1 A  (random-walk normalization)


def _neighborhood_sets(d: int) -> tuple[list[list[int]], list[list[list[int]]]]:
    """BFS neighborhoods for every joint.

    Returns:
      closed: ``closed[i]`` = all joints within ``d`` hops of ``i`` (incl. ``i``).
      rings:  ``rings[i][k]`` = joints at exactly ``k+1`` hops from ``i``
              (the "new frontier" of BFS step ``k+1``, matching the reference's
              ``increase_neighbourhood``, src/data/adjacency.py:13-32).
    """
    closed: list[list[int]] = []
    rings: list[list[list[int]]] = []
    for i in range(NUM_JOINTS):
        seen = [i]
        frontier = [i]
        my_rings: list[list[int]] = []
        for _ in range(d):
            nxt: list[int] = []
            for u in frontier:
                for w in ADJACENCY_LIST[u]:
                    if w not in seen:
                        seen.append(w)
                        nxt.append(w)
            my_rings.append(nxt)
            frontier = nxt
        closed.append(seen)
        rings.append(my_rings)
    return closed, rings


def create_adjacency_matrices(
    strat: Strategy = Strategy.UNI_LABELING,
    d: int = 1,
    distances: np.ndarray | None = None,
    distance_file: str | None = None,
) -> list[np.ndarray]:
    """Build the list of ``(V, V)`` partition matrices for a strategy.

    Mirrors the observable output of the reference's construction
    (src/data/adjacency.py:34-158), including:
      * uni-labeling folds self-loops into the single partition (quirk Q5);
      * distance/symmetrical put the identity in partition 0 explicitly;
      * symmetrical adds mirror-joint edges into every hop partition and the
        root's own mirror into the last partition (src/data/adjacency.py:153-156).

    Args:
      strat: partitioning strategy.
      d: neighborhood radius (number of BFS hops).
      distances: per-joint mean gravity-center distance, shape ``(V,)``
        (required for SPATIAL_CONFIGURATION).
      distance_file: ``.npy`` path to load ``distances`` from if not given.
    """
    strat = Strategy(strat)
    V = NUM_JOINTS
    closed, rings = _neighborhood_sets(d)

    if strat == Strategy.UNI_LABELING:
        A = np.zeros((V, V), dtype=np.float32)
        for i in range(V):
            A[i, closed[i]] = 1.0
        return [A]

    if strat == Strategy.DISTANCE:
        mats = [np.eye(V, dtype=np.float32)]
        for k in range(d):
            M = np.zeros((V, V), dtype=np.float32)
            for i in range(V):
                M[i, rings[i][k]] = 1.0
            mats.append(M)
        return mats

    if strat == Strategy.SPATIAL_CONFIGURATION:
        if distances is None:
            if distance_file is None:
                raise ValueError(
                    "SPATIAL_CONFIGURATION needs per-joint gravity-center "
                    "distances (pass `distances` or `distance_file`)"
                )
            distances = np.load(distance_file)
        distances = np.asarray(distances).reshape(-1)
        if distances.shape[0] != V:
            raise ValueError(f"expected ({V},) distances, got {distances.shape}")
        mats = [np.zeros((V, V), dtype=np.float32) for _ in range(3)]
        for i in range(V):
            for j in closed[i]:
                if distances[j] == distances[i]:
                    label = 0  # same distance (includes the root itself)
                elif distances[j] < distances[i]:
                    label = 1  # closer to gravity center (centripetal)
                else:
                    label = 2  # farther from gravity center (centrifugal)
                mats[label][i, j] = 1.0
        return mats

    if strat == Strategy.SYMMETRICAL:
        mats = [np.eye(V, dtype=np.float32)]
        for _ in range(d):
            mats.append(np.zeros((V, V), dtype=np.float32))
        for i in range(V):
            for k in range(d):
                for j in rings[i][k]:
                    mats[k + 1][i, j] = 1.0
                    if j in OPPOSITE_JOINTS:
                        mats[k + 1][i, OPPOSITE_JOINTS[j]] = 1.0
            # The reference adds the root's own mirror to the *last* hop
            # partition regardless of d (src/data/adjacency.py:155-156).
            if i in OPPOSITE_JOINTS:
                mats[d][i, OPPOSITE_JOINTS[i]] = 1.0
        return mats

    raise ValueError(f"unknown strategy: {strat!r}")


def normalize(
    matrices: list[np.ndarray],
    mode: NormalizationMode | str = NormalizationMode.SYMMETRIC,
    alpha: float = 0.001,
) -> np.ndarray:
    """Degree-normalize each partition matrix; stack into ``(K, V, V)``.

    ``mode="reference"`` reproduces the reference's elementwise exponentiation
    of ``diag(rowsum(A)) + alpha`` (src/data/adjacency.py:180-181): the dense
    Lambda quirk Q1.  ``mode="symmetric"`` computes the intended
    ``(D + alpha I)^{-1/2} A (D + alpha I)^{-1/2}`` with Lambda kept diagonal;
    ``mode="row"`` computes ``(D + alpha I)^{-1} A``.
    """
    mode = NormalizationMode(mode)
    out = []
    for A in matrices:
        A = np.asarray(A, dtype=np.float64)
        deg = A.sum(axis=1)
        if mode == NormalizationMode.REFERENCE:
            lam = (np.diag(deg) + alpha) ** -0.5  # elementwise: dense Lambda
            out.append(lam @ A @ lam)
        elif mode == NormalizationMode.SYMMETRIC:
            inv_sqrt = (deg + alpha) ** -0.5
            out.append(inv_sqrt[:, None] * A * inv_sqrt[None, :])
        else:
            out.append(A / (deg + alpha)[:, None])
    return np.stack(out).astype(np.float32)


def get_normalized_adjacency(
    strat: Strategy = Strategy.UNI_LABELING,
    d: int = 1,
    alpha: float = 0.001,
    mode: NormalizationMode | str = NormalizationMode.SYMMETRIC,
    distances: np.ndarray | None = None,
    distance_file: str | None = None,
) -> np.ndarray:
    """One-call entry point: build + normalize into a ``(K, V, V)`` float32
    array.  Counterpart of ``get_normalized_adjacency_matrices``
    (src/data/adjacency.py:186-200)."""
    mats = create_adjacency_matrices(
        strat, d, distances=distances, distance_file=distance_file
    )
    return normalize(mats, mode=mode, alpha=alpha)


def num_partitions(strat: Strategy, d: int = 1) -> int:
    strat = Strategy(strat)
    if strat == Strategy.UNI_LABELING:
        return 1
    if strat == Strategy.SPATIAL_CONFIGURATION:
        return 3
    return d + 1
