"""Host-side Siamese pairs (numpy only). Counterpart of the ShapeNet half of
weaksuppointcloudseg_tpu/data/augment.py (reference: ShapeNet/
ShapeNet_DGCNN_trainer.py:261-289): per-sample jitter with eps = 2e-3 x
per-axis extent, then a random z-mirror, as the second element of each
pair; before the rampup epoch the pair is an exact duplicate. Draws from
the generator exactly as the reference does, so a seed gives both packages
the same pairs.
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
