"""The NTU-RGB+D Kinect v2 skeleton and 2s-AGCN's three subsets.

The 25 joints of the Kinect v2 body (NTU-RGB+D, Shahroudy et al., CVPR
2016), joint 21 (index 20, the spine) at the centre, and the labeling of
2s-AGCN (Shi et al., CVPR 2019, ``graph/ntu_rgb_d.py`` of
github.com/lshiwjx/2s-AGCN): the identity, the inward graph (each edge
pointing to the joint nearer the centre) and the outward graph (the same
edges reversed), each directed graph normalized by column::

    edge2mat(links)[j, i] = 1 for each link (i, j)
    normalize_digraph(A) = A . diag(1 / column sums)   (a zero column stays 0)
    A = stack(I, normalize_digraph(edge2mat(inward)),
              normalize_digraph(edge2mat(outward)))

This sits beside :mod:`~stgcn_tpu_torch.graph.skeleton` (OpenPose BODY_25),
which the ST-GCN models use.
"""

from __future__ import annotations

import numpy as np

NUM_JOINTS: int = 25
CENTER: int = 20        # joint 21, the spine, 0-indexed

# The 24 inward edges (i, j) of graph/ntu_rgb_d.py, 1-indexed there.
INWARD_1: tuple[tuple[int, int], ...] = (
    (1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6), (8, 7),
    (9, 21), (10, 9), (11, 10), (12, 11), (13, 1), (14, 13), (15, 14),
    (16, 15), (17, 1), (18, 17), (19, 18), (20, 19), (22, 23), (23, 8),
    (24, 25), (25, 12))
INWARD: tuple[tuple[int, int], ...] = tuple((i - 1, j - 1)
                                            for i, j in INWARD_1)
OUTWARD: tuple[tuple[int, int], ...] = tuple((j, i) for i, j in INWARD)


def edge2mat(links, num_joints: int = NUM_JOINTS) -> np.ndarray:
    """``A[j, i] = 1`` for each link ``(i, j)``."""
    a = np.zeros((num_joints, num_joints), dtype=np.float64)
    for i, j in links:
        a[j, i] = 1.0
    return a


def normalize_digraph(a: np.ndarray) -> np.ndarray:
    """``A . diag(1 / column sums)``, a zero column left at zero."""
    col = a.sum(axis=0)
    inv = np.zeros_like(col)
    inv[col > 0] = 1.0 / col[col > 0]
    return a @ np.diag(inv)


def agcn_subsets(num_joints: int = NUM_JOINTS) -> np.ndarray:
    """``(3, V, V)`` float32: identity, normalized inward, normalized
    outward."""
    return np.stack([
        np.eye(num_joints),
        normalize_digraph(edge2mat(INWARD, num_joints)),
        normalize_digraph(edge2mat(OUTWARD, num_joints)),
    ]).astype(np.float32)
