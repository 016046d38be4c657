"""Host-side Siamese pairs (numpy only). Counterpart of
weaksuppointcloudseg_tpu/data/augment.py: the second element of each pair
is, for ShapeNet (ShapeNet_DGCNN_trainer.py:261-289), the cloud jittered
with eps = 2e-3 x per-axis extent and then randomly z-mirrored; for S3DIS
(S3DIS_DGCNN_trainer.py:261-300), one of 8 dihedral xy flips and swaps
applied coherently to the raw (0, 1) and normalized (6, 7) coordinates.
Before the rampup epoch the pair is an exact duplicate. Draws from the
generator exactly as the reference does, so a seed gives both packages the
same pairs; the S3DIS pairs are (original, augmented), as the JAX package
has them (its quirk Q11 note: the released code augmented both).
"""

from __future__ import annotations

import numpy as np


def shapenet_augment(points: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Jitter + random z-mirror for one sample [N, 3]."""
    extent = points.max(axis=0) - points.min(axis=0)
    eps = 2e-3 * extent[None, :]
    out = points + eps * rng.standard_normal(points.shape).astype(points.dtype)
    if rng.integers(0, 2) == 1:
        out = out.copy()
        out[:, 2] = -out[:, 2]
    return out


def s3dis_augment(block: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One of 8 dihedral transforms for one block [N, 9]."""
    out = block.copy()
    choice = int(rng.integers(0, 8))
    if choice in (1, 5, 6, 7):  # swap x and y
        out[:, [0, 1]] = out[:, [1, 0]]
        out[:, [6, 7]] = out[:, [7, 6]]
    if choice in (2, 4, 5, 7):  # flip x
        out[:, 0] = -out[:, 0]
        out[:, 6] = -out[:, 6] + 1
    if choice in (3, 4, 6, 7):  # flip y
        out[:, 1] = -out[:, 1]
        out[:, 7] = -out[:, 7] + 1
    return out


def make_siamese_batch(data: np.ndarray, rng: np.random.Generator,
                       augment_fn=None) -> np.ndarray:
    """Interleave [B, ...] -> [2B, ...]: (x_i, augment(x_i)) pairs, or exact
    duplicates with ``augment_fn=None``."""
    out = np.empty((2 * data.shape[0],) + data.shape[1:], dtype=data.dtype)
    out[0::2] = data
    if augment_fn is None:
        out[1::2] = data
    else:
        for i, sample in enumerate(data):
            out[2 * i + 1] = augment_fn(sample, rng)
    return out


def interleave_duplicate(arr: np.ndarray) -> np.ndarray:
    """[B, ...] -> [2B, ...] with each row duplicated (labels, masks). The
    reference's native batcher and its numpy fallback give the same."""
    return np.repeat(np.asarray(arr), 2, axis=0)
