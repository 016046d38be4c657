"""ShapeNet part-segmentation data.

Counterpart of weaksuppointcloudseg_tpu/data/shapenet.py: the category/part
maps under ``hdf5_data/``, the h5 train/val splits (``data`` [S,2048,3],
``label`` [S,1], ``pid`` [S,2048]; DataIO_ShapeNet.py:317-325) served as
fixed-shape batches, the raw ``.pts``/``.seg`` test files listed in
``testing_ply_file_list.txt`` (DataIO_ShapeNet.py:122-142, 235-344), and
the fixed-size views that cover every point of a shape. ``h5py`` is
imported only when a split is read.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ShapeNetMeta:
    """Category/part-id maps (DataIO_ShapeNet.py:18-50)."""

    objnames: List[str]
    objcats: List[str]  # category ids (e.g. '02691156')
    on2oid: dict  # catid -> category index
    cpid2oid: dict  # '<catid>_<partid>' -> overall part id
    object2setofoid: dict  # catid -> list of overall part ids
    num_categories: int
    num_part_cats: int

    @classmethod
    def load(cls, h5_base_path: str) -> "ShapeNetMeta":
        with open(os.path.join(h5_base_path, "all_object_categories.txt")) as f:
            pairs = [line.split() for line in f.read().splitlines() if line.strip()]
        objcats = [p[1] for p in pairs]
        with open(os.path.join(h5_base_path, "overallid_to_catid_partid.json")) as f:
            oid2cpid = json.load(f)
        with open(os.path.join(h5_base_path, "catid_partid_to_overallid.json")) as f:
            cpid2oid = json.load(f)
        object2setofoid: dict = {}
        for idx, (objid, _pid) in enumerate(oid2cpid):
            object2setofoid.setdefault(objid, []).append(idx)
        return cls(objnames=[p[0] for p in pairs], objcats=objcats,
                   on2oid={c: i for i, c in enumerate(objcats)},
                   cpid2oid=cpid2oid, object2setofoid=object2setofoid,
                   num_categories=len(objcats), num_part_cats=len(oid2cpid))

    def iou_oids(self, category_index: int) -> List[int]:
        """Overall part ids belonging to one shape category."""
        return self.object2setofoid[self.objcats[category_index]]


def load_h5_seg(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read one h5 shard -> (data [S,N,3] f32, label [S] i32, seg [S,N] i32)."""
    import h5py

    with h5py.File(path, "r") as f:
        data = f["data"][:]
        label = f["label"][:]
        seg = f["pid"][:]
    return (np.asarray(data, np.float32),
            np.asarray(label).reshape(-1).astype(np.int32),
            np.asarray(seg, np.int32))


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center + scale to the unit sphere (DataIO_ShapeNet.py:337-344)."""
    pc = pc - pc.mean(axis=0)
    return pc / np.max(np.sqrt(np.sum(pc**2, axis=1)))


def cover_partition(n_points: int, target: int, rng: np.random.Generator) -> list:
    """Fixed-size index views whose union covers every original point.

    <= target points: one view, the original points first, padded with
    random repeats (ShapeNet_DGCNN_trainer.py:530-535). > target points:
    ceil(n/target) views of one random permutation, the last padded with
    already-covered indices. Draws from ``rng`` exactly as the reference
    does, so a seed gives both packages the same views.
    """
    if n_points <= target:
        if n_points == target:
            return [np.arange(target)]
        extra = rng.choice(n_points, target - n_points, replace=True)
        return [np.concatenate([np.arange(n_points), extra])]
    perm = rng.permutation(n_points)
    views = []
    for s in range(0, n_points, target):
        chunk = perm[s:s + target]
        if len(chunk) < target:
            pad = rng.choice(s, target - len(chunk), replace=False)
            chunk = np.concatenate([chunk, perm[pad]])
        views.append(chunk)
    return views


@dataclasses.dataclass
class Batch:
    """One fixed-shape training/eval batch."""

    data: np.ndarray  # [B, N, 3]
    label: np.ndarray  # [B] category index
    seg: np.ndarray  # [B, N] part labels
    sample_ids: np.ndarray  # [B] global sample index (for SampIndex masks)
    valid: int  # number of real (non-padding) samples


class ShapeNetDataset:
    """Train/val splits concatenated from the hdf5 shard lists."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir
        self.h5_base_path = os.path.join(base_dir, "hdf5_data")
        self.meta = ShapeNetMeta.load(self.h5_base_path)
        self._splits = {}

    def _load_split(self, list_name: str):
        with open(os.path.join(self.h5_base_path, list_name)) as f:
            files = [line.strip() for line in f if line.strip()]
        parts = [load_h5_seg(os.path.join(self.h5_base_path,
                                          os.path.basename(name)))
                 for name in files]
        return tuple(np.concatenate(a) for a in zip(*parts))

    def split(self, name: str):
        """name: 'train' | 'val'. Returns (data, label, seg) arrays."""
        if name not in self._splits:
            self._splits[name] = self._load_split(f"{name}_hdf5_file_list.txt")
        return self._splits[name]

    def num_samples(self, name: str) -> int:
        return self.split(name)[0].shape[0]

    def batches(self, name: str, batch_size: int, *, shuffle: bool = False,
                drop_last: bool = False,
                rng: Optional[np.random.Generator] = None) -> Iterator[Batch]:
        """Fixed-shape batches; the short tail is zero-index padded (or
        dropped, as the reference trains: ShapeNet_DGCNN_trainer.py:163-164).
        A shuffle draws one permutation from ``rng``, as the reference's
        dataset does, so a seed gives both packages the same order."""
        data, label, seg = self.split(name)
        n = data.shape[0]
        order = np.arange(n)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        for start in range(0, n, batch_size):
            idx = order[start:start + batch_size]
            valid = len(idx)
            if valid < batch_size:
                if drop_last:
                    return
                idx = np.concatenate([idx, np.zeros(batch_size - valid, np.int64)])
            yield Batch(data=data[idx], label=label[idx], seg=seg[idx],
                        sample_ids=idx, valid=valid)


class ShapeNetTestSet:
    """Raw .pts/.seg test files (DataIO_ShapeNet.py:122-142, 235-299)."""

    def __init__(self, base_dir: str):
        self.ply_data_dir = os.path.join(base_dir, "PartAnnotation")
        self.meta = ShapeNetMeta.load(os.path.join(base_dir, "hdf5_data"))
        with open(os.path.join(base_dir, "testing_ply_file_list.txt")) as f:
            rows = [line.split() for line in f.read().splitlines() if line.strip()]
        self.pts_files = [r[0] for r in rows]
        self.seg_files = [r[1] for r in rows]
        self.labels = [r[2] for r in rows]

    def __len__(self) -> int:
        return len(self.pts_files)

    def __getitem__(self, i: int):
        """Returns (points [n,3] normalized, seg [n], category_index)."""
        cat_idx = self.meta.on2oid[self.labels[i]]
        catid = self.meta.objcats[cat_idx]
        pts = np.loadtxt(os.path.join(self.ply_data_dir, self.pts_files[i]),
                         dtype=np.float32).reshape(-1, 3)
        with open(os.path.join(self.ply_data_dir, self.seg_files[i])) as f:
            part_ids = [int(x) for x in f.read().split()]
        seg = np.array([self.meta.cpid2oid[f"{catid}_{p}"] for p in part_ids],
                       np.int32)
        return pc_normalize(pts), seg, cat_idx
