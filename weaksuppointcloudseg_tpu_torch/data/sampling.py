"""Labelled-point indices, the "SampIndex" weak-label budgets (numpy only).

Counterpart of the m > 0 half of weaksuppointcloudseg_tpu/data/sampling.py:
the reference's ``SampIndex_m-*.mat`` file where one exists (read with
scipy), else floor(m * N) points drawn uniformly per training sample from a
seeded generator, on the same draws as the reference's. The S3DIS
one-point-per-class scheme (m = 0) comes with S3DIS.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def generate_sample_index(num_samples: int, num_points: int, m: float,
                          seed: int = 0) -> np.ndarray:
    """Uniform labelled-point indices: int64 [num_samples, floor(m*N)]."""
    if m <= 0:
        raise ValueError("m must be > 0 (the m = 0 scheme is S3DIS's)")
    n_labelled = max(1, int(m * num_points))
    rng = np.random.default_rng(seed)
    out = np.empty((num_samples, n_labelled), dtype=np.int64)
    for i in range(num_samples):
        out[i] = rng.choice(num_points, size=n_labelled, replace=False)
    return out


def load_or_generate(preprocess_dir: str, m: float, *, num_samples: int,
                     num_points: int, seed: int = 0) -> np.ndarray:
    """The reference's .mat if present, else a seeded draw."""
    path = os.path.join(preprocess_dir, f"SampIndex_m-{m:.3f}.mat")
    if os.path.exists(path):
        import scipy.io as scio

        return np.asarray(scio.loadmat(path)["pts_idx_list"])
    return generate_sample_index(num_samples, num_points, m, seed=seed)


def indices_to_mask(pts_idx: np.ndarray, sample_ids: Sequence[int],
                    num_points: int) -> np.ndarray:
    """Binary f32 [B, N] mask from per-sample labelled indices
    (ShapeNet_DGCNN_trainer.py:243-258)."""
    mask = np.zeros((len(sample_ids), num_points), np.float32)
    for i, s in enumerate(sample_ids):
        mask[i, np.asarray(pts_idx[s]).reshape(-1)] = 1.0
    return mask
