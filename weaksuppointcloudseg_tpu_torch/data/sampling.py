"""Labelled-point indices, the "SampIndex" weak-label budgets (numpy only).

Counterpart of weaksuppointcloudseg_tpu/data/sampling.py: the reference's
``SampIndex_m-*.mat`` file where one exists (read with scipy), else a
seeded draw on the same draws as the reference's: for m > 0, floor(m * N)
points uniformly per training sample; for m = 0 (S3DIS), one random point
of each class present in a block (a ragged list).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Union

import numpy as np

IndexList = Union[np.ndarray, List[np.ndarray]]


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


def generate_one_point_per_class(seg_labels: np.ndarray,
                                 seed: int = 0) -> List[np.ndarray]:
    """S3DIS m = 0: one random labelled point of each class present in each
    block of seg_labels [num_samples, N], sorted."""
    rng = np.random.default_rng(seed)
    out = []
    for seg in seg_labels:
        idxs = [rng.choice(np.nonzero(seg == c)[0]) for c in np.unique(seg)]
        out.append(np.asarray(sorted(idxs), dtype=np.int64))
    return out


def load_or_generate(preprocess_dir: str, m: float, *, num_samples: int,
                     num_points: int, seg_labels: np.ndarray = None,
                     seed: int = 0) -> IndexList:
    """The reference's .mat if present, else a seeded draw (m = 0 needs the
    blocks' seg_labels)."""
    path = os.path.join(preprocess_dir, f"SampIndex_m-{m:.3f}.mat")
    if os.path.exists(path):
        import scipy.io as scio

        arr = scio.loadmat(path)["pts_idx_list"]
        if m == 0:  # ragged rows (train_S3DIS.py:96-99)
            return [np.asarray(arr[0, b][0]).reshape(-1)
                    for b in range(arr.shape[1])]
        return np.asarray(arr)
    if m == 0:
        if seg_labels is None:
            raise ValueError("m = 0 draws from the blocks' seg labels")
        return generate_one_point_per_class(seg_labels, seed=seed)
    return generate_sample_index(num_samples, num_points, m, seed=seed)


def indices_to_mask(pts_idx: IndexList, sample_ids: Sequence[int],
                    num_points: int) -> np.ndarray:
    """Binary f32 [B, N] mask from per-sample labelled indices
    (ShapeNet_DGCNN_trainer.py:243-258)."""
    mask = np.zeros((len(sample_ids), num_points), np.float32)
    for i, s in enumerate(sample_ids):
        mask[i, np.asarray(pts_idx[s]).reshape(-1)] = 1.0
    return mask
