"""Skeleton graph constants for the OpenPose BODY_25 model.

A copy of ``stgcn_tpu/graph/skeleton.py`` (numpy only), kept in this package
so that the port imports nothing of the JAX package.  The reference keeps
these in ``src/data/util.py:50-180`` (joint count, label map, joint names,
edge list, mirror pairs, adjacency list).  They are the static graph
definition consumed by :mod:`stgcn_tpu_torch.graph.adjacency`; graph
construction is a one-time host-side precompute and only the resulting
``(K, V, V)`` tensors reach the device.
"""

from __future__ import annotations

import numpy as np

NUM_JOINTS: int = 25

# KTH action labels (reference: src/data/util.py:52-58).
KTH_LABELS: dict[str, int] = {
    "boxing": 0,
    "handclapping": 1,
    "handwaving": 2,
    "jogging": 3,
    "running": 4,
    "walking": 5,
}


def label_name_to_number(name: str) -> int:
    return KTH_LABELS[name]


def label_number_to_name(num: int) -> str:
    for k, v in KTH_LABELS.items():
        if v == num:
            return k
    raise KeyError(num)


# BODY_25 joint names (reference: src/data/util.py:64-90).
JOINT_NAMES: list[str] = [
    "Nose",
    "Neck",
    "RShoulder",
    "RElbow",
    "RWrist",
    "LShoulder",
    "LElbow",
    "LWrist",
    "MidHip",
    "RHip",
    "RKnee",
    "RAnkle",
    "LHip",
    "LKnee",
    "LAnkle",
    "REye",
    "LEye",
    "REar",
    "LEar",
    "LBigToe",
    "LSmallToe",
    "LHeel",
    "RBigToe",
    "RSmallToe",
    "RHeel",
    "Background",
]

JOINT_INDEX: dict[str, int] = {name: i for i, name in enumerate(JOINT_NAMES)}

# Undirected bone list (reference: src/data/util.py:93-116).
EDGES: list[tuple[int, int]] = [
    (0, 1),
    (1, 2),
    (2, 3),
    (3, 4),
    (1, 5),
    (5, 6),
    (6, 7),
    (1, 8),
    (8, 9),
    (9, 10),
    (10, 11),
    (8, 12),
    (12, 13),
    (13, 14),
    (0, 15),
    (0, 16),
    (15, 17),
    (16, 18),
    (14, 19),
    (19, 20),
    (14, 21),
    (11, 22),
    (22, 23),
    (11, 24),
]

# Mirror-symmetric joint pairs, as a mapping (reference: src/data/util.py:131-152).
OPPOSITE_JOINTS: dict[int, int] = {
    2: 5,
    3: 6,
    4: 7,
    5: 2,
    6: 3,
    7: 4,
    9: 12,
    10: 13,
    11: 14,
    12: 9,
    13: 10,
    14: 11,
    15: 16,
    16: 15,
    17: 18,
    18: 17,
    19: 22,
    20: 23,
    21: 24,
    22: 19,
    23: 20,
    24: 21,
}


def build_adjacency_list() -> dict[int, list[int]]:
    """Neighbour list derived from ``EDGES``.

    Matches the hand-written table in the reference (src/data/util.py:156-180);
    a unit test asserts the equivalence of derivation and table.
    """
    adj: dict[int, list[int]] = {i: [] for i in range(NUM_JOINTS)}
    for a, b in EDGES:
        adj[a].append(b)
        adj[b].append(a)
    return adj


ADJACENCY_LIST: dict[int, list[int]] = build_adjacency_list()


def hop_distance_matrix(max_hops: int | None = None) -> np.ndarray:
    """All-pairs hop distances over the skeleton via BFS.

    Returns an ``(V, V)`` int array; unreachable pairs (only the Background
    joint 25, which has no bones) get ``-1``.
    """
    V = NUM_JOINTS
    dist = -np.ones((V, V), dtype=np.int64)
    for src in range(V):
        dist[src, src] = 0
        frontier = [src]
        d = 0
        while frontier:
            d += 1
            if max_hops is not None and d > max_hops:
                break
            nxt = []
            for u in frontier:
                for w in ADJACENCY_LIST[u]:
                    if dist[src, w] < 0:
                        dist[src, w] = d
                        nxt.append(w)
            frontier = nxt
    return dist


def bone_pairs_for_motion() -> list[tuple[int, int]]:
    """(child, parent) pairs usable for bone-vector features."""
    return list(EDGES)
