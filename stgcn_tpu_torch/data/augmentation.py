"""Skeleton-sequence augmentation: random rotation / translation / scale / flip.

The port's copy of ``stgcn_tpu/data/augmentation.py`` (numpy only).

The reference (src/data/augmentation.py:8-69) composes a 3x3 homogeneous
matrix from a random subset of transforms and applies it as a row-vector
product — with two quirks (SURVEY.md Q3) that ``compat=True`` reproduces:

* it samples **2** transforms **with replacement** (despite the "3 out of 4"
  comment, augmentation.py:19-21), and
* it leaves the homogeneous coordinate at **0** (augmentation.py:55-56), so
  translation terms are routed into the discarded third component —
  translation is a silent no-op.

``compat=False`` is the intended behavior: 3 distinct transforms, translation
actually applied.

Transform pools match the reference: rotations ±{5,10,15}°, translations
{(5,5),(0,5),(5,0)}, scales {0.95,1.05,1.1}, x-flip.
"""

from __future__ import annotations

import numpy as np

ROTATIONS_DEG = (15, -15, 5, -5, 10, -10)
TRANSLATIONS = ((5, 5), (0, 5), (5, 0))
SCALE_FACTORS = (1.05, 1.1, 0.95)
TRANSFORM_NAMES = ("rotation", "translation", "scaling", "flip")


def sample_transform(rng: np.random.Generator, compat: bool = True
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Draw a random affine transform.

    Returns ``(M (2,2), t (2,))`` to be applied as ``x @ M + t`` on row-vector
    coordinates.  In compat mode ``t`` is always zero (the translation no-op
    quirk) and 2 names are drawn with replacement; otherwise 3 distinct names
    are drawn and translation takes effect.
    """
    if compat:
        chosen = rng.choice(TRANSFORM_NAMES, 2, replace=True)
    else:
        chosen = rng.choice(TRANSFORM_NAMES, 3, replace=False)
    M = np.eye(2)
    t = np.zeros(2)
    if "rotation" in chosen:
        theta = np.radians(rng.choice(ROTATIONS_DEG))
        c, s = np.cos(theta), np.sin(theta)
        # Row-vector convention: x' = x @ R with R = [[c, s], [-s, c]]
        # (matches the reference's rot_matx acting on row vectors).
        M = M @ np.array([[c, s], [-s, c]])
    if "translation" in chosen and not compat:
        t = t + np.asarray(TRANSLATIONS[rng.choice(len(TRANSLATIONS))], float)
    if "scaling" in chosen:
        M = M * SCALE_FACTORS[rng.choice(len(SCALE_FACTORS))]
    if "flip" in chosen:
        M = M @ np.array([[-1.0, 0.0], [0.0, 1.0]])
    return M, t


def augment_sequence(seq: np.ndarray, rng: np.random.Generator,
                     compat: bool = True) -> np.ndarray:
    """Apply one random affine transform to a ``(T, V, 2)`` sequence.

    Pure (the input array is never mutated), like the reference's
    ``augment_data`` asserts for itself (augmentation.py:84).
    """
    M, t = sample_transform(rng, compat=compat)
    return (seq @ M + t).astype(seq.dtype)


def make_augmenter(compat: bool = True):
    """Transform callable in the :class:`SkeletonDataset` signature."""
    def fn(seq: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        return augment_sequence(seq, rng, compat=compat)
    return fn
