"""S3DIS indoor semantic-segmentation training data.

Counterpart of the training half of weaksuppointcloudseg_tpu/data/s3dis.py
(reference: S3DIS/DataIO_S3DIS.py:36-83): every h5 block shard listed in
``all_files.txt`` (``data`` [S, 4096, 9], ``label`` [S, 4096]), split into
train and test blocks by matching ``Area_<k>`` against
``room_filelist.txt``, served as fixed-shape batches. Channels 0:3 are xyz
with the block xy-centred, 3:6 rgb/255, 6:9 xyz normalized by the room
extent. ``h5py`` is imported only when a shard is read. The test-time
block sweep of whole rooms comes with the S3DIS test path (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np

NUM_CLASSES = 13


def load_h5(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """One h5 shard -> (data [S, N, 9] f32, label [S, N] i32)."""
    import h5py

    with h5py.File(path, "r") as f:
        return (np.asarray(f["data"][:], np.float32),
                np.asarray(f["label"][:], np.int32))


def weak_class_onehot(seg: np.ndarray, num_classes: int = NUM_CLASSES) -> np.ndarray:
    """[B, num_classes] multi-hot of the classes present in each block."""
    b = seg.shape[0]
    out = np.zeros((b, num_classes), np.float32)
    out[np.repeat(np.arange(b), seg.shape[1]), seg.reshape(-1)] = 1.0
    return out


@dataclasses.dataclass
class Batch:
    data: np.ndarray  # [B, N, 9]
    seg: np.ndarray  # [B, N]
    sample_ids: np.ndarray  # [B] global block index
    valid: int


class S3DISDataset:
    """All blocks loaded from the h5 shards, split by area."""

    def __init__(self, h5filepath: str, num_classes: int = NUM_CLASSES):
        self.base = h5filepath
        self.num_classes = num_classes
        with open(os.path.join(h5filepath, "all_files.txt")) as f:
            self.all_files = [line.strip() for line in f if line.strip()]
        with open(os.path.join(h5filepath, "room_filelist.txt")) as f:
            self.room_filelist = [line.strip() for line in f if line.strip()]
        self._data = None
        self._label = None

    def load_all(self) -> None:
        if self._data is not None:
            return
        datas, labels = [], []
        for fname in self.all_files:
            # the reference keeps only the basename (DataIO_S3DIS.py:54)
            d, l = load_h5(os.path.join(self.base, os.path.basename(fname)))
            datas.append(d)
            labels.append(l)
        self._data = np.concatenate(datas)
        self._label = np.concatenate(labels)

    @property
    def data(self) -> np.ndarray:
        self.load_all()
        return self._data

    @property
    def label(self) -> np.ndarray:
        self.load_all()
        return self._label

    def split_indices(self, test_area: int) -> Tuple[np.ndarray, np.ndarray]:
        """(train_idx, test_idx): blocks whose room name holds Area_<k> are
        the test blocks."""
        rooms = np.asarray(self.room_filelist)
        is_test = np.char.find(rooms, f"Area_{test_area}") >= 0
        idx = np.arange(len(rooms))
        return idx[~is_test], idx[is_test]

    def batches(self, indices: np.ndarray, batch_size: int, *,
                shuffle: bool = False, drop_last: bool = False,
                rng: Optional[np.random.Generator] = None) -> Iterator[Batch]:
        """Batches of the given blocks; a short last batch is dropped or
        padded with the first blocks of the order (``valid`` counts the
        real ones)."""
        order = np.array(indices)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            valid = len(idx)
            if valid < batch_size:
                if drop_last:
                    return
                idx = np.concatenate([idx, order[:batch_size - valid]])
            yield Batch(data=self.data[idx], seg=self.label[idx],
                        sample_ids=idx, valid=valid)
