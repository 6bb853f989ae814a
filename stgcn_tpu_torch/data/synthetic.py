"""Synthetic KTH-format skeleton data (port of
``stgcn_tpu/data/synthetic.py``), without pandas.

The real KTH Action Dataset is not redistributable with the repo, so this
module fabricates structurally identical data (per-video ``(T, 25, 3)``
``.npy`` files plus a ``metadata.csv`` with subject/action/scenario/filename
columns) for tests, end-to-end training runs and benchmarks.  The draws are
the JAX package's, in the same order, so the same seed writes byte-identical
``.npy`` files; ``metadata.csv`` is written with the ``csv`` module in
``pandas.DataFrame.to_csv(index=False)``'s bytes (minimal quoting, the
platform's line separator), so both packages can share one directory.

Motion is class-dependent (distinct limb oscillation frequencies, amplitudes
and drift per action) so a model trained on it has signal to learn.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from stgcn_tpu_torch.graph.skeleton import (
    EDGES,
    JOINT_NAMES,
    KTH_LABELS,
    NUM_JOINTS,
    hop_distance_matrix,
)

# A rough upright rest pose (x right, y down, OpenPose pixel-ish units).
_REST_POSE = np.array([
    [80, 30],   # Nose
    [80, 50],   # Neck
    [65, 50],   # RShoulder
    [58, 75],   # RElbow
    [55, 100],  # RWrist
    [95, 50],   # LShoulder
    [102, 75],  # LElbow
    [105, 100], # LWrist
    [80, 105],  # MidHip
    [70, 105],  # RHip
    [68, 140],  # RKnee
    [66, 175],  # RAnkle
    [90, 105],  # LHip
    [92, 140],  # LKnee
    [94, 175],  # LAnkle
    [75, 27],   # REye
    [85, 27],   # LEye
    [70, 30],   # REar
    [90, 30],   # LEar
    [98, 185],  # LBigToe
    [101, 184], # LSmallToe
    [92, 180],  # LHeel
    [62, 185],  # RBigToe
    [59, 184],  # RSmallToe
    [68, 180],  # RHeel
], dtype=np.float64)

# Per-action motion programs: (moving joints, frequency, amplitude, x-drift).
_ACTION_MOTION = {
    "boxing":       ([3, 4, 6, 7], 0.9, 18.0, 0.0),
    "handclapping": ([3, 4, 6, 7], 0.5, 10.0, 0.0),
    "handwaving":   ([2, 3, 4, 5, 6, 7], 0.3, 25.0, 0.0),
    "jogging":      ([10, 11, 13, 14, 3, 6], 0.7, 12.0, 1.2),
    "running":      ([10, 11, 13, 14, 3, 6], 1.1, 16.0, 2.2),
    "walking":      ([10, 11, 13, 14], 0.4, 8.0, 0.6),
}


# ---------------------------------------------------------------------------
# "relational" style: classes differ ONLY in inter-joint phase structure
# ---------------------------------------------------------------------------
#
# Every joint in every class oscillates with the SAME marginal statistics
# (frequency, amplitude and global phase drawn per sequence from shared
# distributions), so no per-joint feature separates the classes.  What
# differs is the *phase relation* between joints:
#
#     phase(j) = alpha * hops(j, MidHip) + beta * pi * side(j) + phi0
#
# * ``alpha`` — hop-graded phase lag along the skeleton chains: its sign is
#   the direction a motion wave travels (down vs up the limbs).  A first
#   uni-labeling layer is sign-blind at interior joints (the symmetric
#   neighborhood sum sin(wt+a(h-1)) + sin(wt+ah) + sin(wt+a(h+1)) =
#   (1+2cos a) loses sign(a)), while the spatial-configuration partitioning
#   separates closer/farther neighbors and can REPRESENT it directly.
#   Representable is not learnable at every setting: the JAX module's
#   comment records the strategy ablation's result.
# * ``beta`` — mirror-pair phase offset (side = +-1/2 for L/R joints):
#   beta=1 puts every joint in anti-phase with its mirror partner, the
#   relation the symmetrical strategy's mirror edges observe directly.
#
# This is the synthetic analog of the reference's Table 1 experiment
# (report.pdf §5.2/§5.7): a task where the choice of partitioning strategy
# has signal to act on.

_RELATIONAL_CLASSES = {
    # action: (alpha, beta)
    "boxing":       (0.0, 0.0),
    "handclapping": (0.0, 1.0),
    "handwaving":   (0.8, 0.0),
    "jogging":      (0.8, 1.0),
    "running":      (-0.8, 0.0),
    "walking":      (-0.8, 1.0),
}

_HOPS_FROM_MIDHIP = hop_distance_matrix()[8].astype(np.float64)  # (V,)
_SIDE = np.array([0.5 if n.startswith("L") else -0.5 if n.startswith("R")
                  else 0.0 for n in JOINT_NAMES[:NUM_JOINTS]])
# fixed per-joint unit motion directions (dataset-wide, so the phase
# relations live in a stable coordinate frame)
_DIRS = np.random.default_rng(2024).normal(0, 1, (NUM_JOINTS, 2))
_DIRS /= np.linalg.norm(_DIRS, axis=1, keepdims=True)


def subject_directions(subject_id: int, sigma: float = 0.8) -> np.ndarray:
    """Per-subject joint motion directions: the dataset-wide base vectors
    plus a subject-seeded perturbation, re-normalized.

    This is the nuisance axis that makes the cross-SUBJECT split a real
    generalization test: a model that memorizes the training subjects'
    coordinate directions fails on held-out subjects, so test accuracy
    measures how well a partitioning extracts direction-invariant phase
    relations — the axis on which strategies differ in efficiency (without
    it every strategy eventually saturates: relational information plus an
    identical train/test distribution lets any labeling reach 100%).
    """
    d = _DIRS + sigma * np.random.default_rng(
        910_000 + subject_id).normal(0, 1, _DIRS.shape)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def synth_sequence_relational(action: str, rng: np.random.Generator,
                              t_range: tuple[int, int] = (120, 480),
                              dirs: np.ndarray | None = None) -> np.ndarray:
    """One ``(T, 25, 3)`` sequence whose class is encoded purely in the
    inter-joint phase structure (see module comment).

    ``dirs``: per-joint unit motion directions (e.g. subject_directions);
    defaults to the dataset-wide base vectors.
    """
    if dirs is None:
        dirs = _DIRS
    T = int(rng.integers(*t_range))
    alpha, beta = _RELATIONAL_CLASSES[action]
    omega = rng.uniform(0.5, 0.9)           # shared across classes
    amp = rng.uniform(9.0, 13.0)            # shared across classes
    phi0 = rng.uniform(0, 2 * np.pi)
    # small whole-body drift, shared distribution: large drift would act as
    # a common-mode term dominating every joint's variance and washing out
    # the phase relations that ARE the class signal
    drift = rng.normal(0.0, 0.05)
    pose = _REST_POSE + rng.normal(0, 2.0, _REST_POSE.shape)
    tt = np.arange(T)[:, None]
    phase = alpha * _HOPS_FROM_MIDHIP + beta * np.pi * _SIDE + phi0
    osc = amp * np.sin(omega * tt + phase[None, :])      # (T, V)
    seq = pose[None] + osc[:, :, None] * dirs[None]
    seq[:, :, 0] += drift * tt
    seq += rng.normal(0, 0.8, seq.shape)
    conf = rng.uniform(0.5, 1.0, (T, NUM_JOINTS, 1))
    return np.concatenate([seq, conf], axis=-1).astype(np.float32)


def synth_sequence(action: str, rng: np.random.Generator,
                   t_range: tuple[int, int] = (120, 480),
                   style: str = "marginal",
                   dirs: np.ndarray | None = None) -> np.ndarray:
    """One ``(T, 25, 3)`` sequence with class-dependent motion + noise.

    ``style="marginal"`` (default) separates classes by per-joint frequency/
    amplitude — easy for any graph labeling.  ``style="relational"``
    separates them only through inter-joint phase relations, so the
    partitioning-strategy ablation has signal to discriminate on.
    """
    if style == "relational":
        return synth_sequence_relational(action, rng, t_range, dirs=dirs)
    if style != "marginal":
        raise ValueError(f"style must be marginal|relational, got {style!r}")
    T = int(rng.integers(*t_range))
    joints, freq, amp, drift = _ACTION_MOTION[action]
    pose = _REST_POSE + rng.normal(0, 2.0, _REST_POSE.shape)
    seq = np.tile(pose, (T, 1, 1))
    tt = np.arange(T)[:, None]
    phase = rng.uniform(0, 2 * np.pi)
    osc = np.sin(freq * tt + phase)
    for j in joints:
        direction = rng.normal(0, 1.0, 2)
        direction /= np.linalg.norm(direction) + 1e-9
        seq[:, j, :] += amp * osc * direction
    seq[:, :, 0] += drift * tt  # whole-body horizontal drift
    seq += rng.normal(0, 0.8, seq.shape)  # keypoint jitter
    conf = rng.uniform(0.5, 1.0, (T, NUM_JOINTS, 1))
    return np.concatenate([seq, conf], axis=-1).astype(np.float32)


def generate_dataset(
    out_dir: str,
    num_subjects: int = 25,
    scenarios: tuple[str, ...] = ("d1", "d2", "d3", "d4"),
    actions: tuple[str, ...] = tuple(KTH_LABELS),
    t_range: tuple[int, int] = (120, 480),
    seed: int = 0,
    skip_one: bool = True,
    style: str = "marginal",
) -> str:
    """Write a synthetic KTH-shaped dataset; returns the metadata.csv path.

    ``skip_one`` drops one (subject, action, scenario) combination to mirror
    the real dataset's 599-of-600 missing video
    (src/data/process_openpose.py:91).
    """
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    meta = {"subject": [], "action": [], "scenario": [], "filename": []}
    skipped = False
    for s in range(1, num_subjects + 1):
        subject = f"person{s:02d}"
        # relational style: per-subject joint motion directions, so the
        # cross-subject split tests direction-invariant relational features
        dirs = subject_directions(s) if style == "relational" else None
        for action in actions:
            for scen in scenarios:
                if skip_one and not skipped:
                    skipped = True
                    continue
                fname = f"{subject}_{action}_{scen}.npy"
                np.save(os.path.join(out_dir, fname),
                        synth_sequence(action, rng, t_range, style=style,
                                       dirs=dirs))
                meta["subject"].append(subject)
                meta["action"].append(action)
                meta["scenario"].append(scen)
                meta["filename"].append(fname)
    meta_path = os.path.join(out_dir, "metadata.csv")
    with open(meta_path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator=os.linesep)
        writer.writerow(list(meta))
        writer.writerows(zip(*meta.values()))
    return meta_path


def random_batch(rng: np.random.Generator, batch: int, t: int,
                 num_classes: int = 6) -> tuple[np.ndarray, np.ndarray]:
    """In-memory labeled batch for benchmarks: ``(x (N,T,25,2), y (N,))``."""
    actions = list(KTH_LABELS)[:num_classes]
    xs, ys = [], []
    for _ in range(batch):
        a = actions[int(rng.integers(num_classes))]
        seq = synth_sequence(a, rng, (t, t + 1))[:, :, :2]
        xs.append(seq)
        ys.append(KTH_LABELS[a])
    return np.stack(xs), np.asarray(ys, np.int64)
