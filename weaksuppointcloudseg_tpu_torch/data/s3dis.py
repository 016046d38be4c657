"""S3DIS indoor semantic-segmentation data.

Counterpart of weaksuppointcloudseg_tpu/data/s3dis.py (reference:
S3DIS/DataIO_S3DIS.py):

- training: every h5 block shard listed in ``all_files.txt`` (``data``
  [S, 4096, 9], ``label`` [S, 4096]), split into train and test blocks by
  matching ``Area_<k>`` against ``room_filelist.txt``, served as
  fixed-shape batches (DataIO_S3DIS.py:36-83). ``h5py`` is imported only
  when a shard is read;
- test: ``room_to_blocks``, the 1 m x 1 m block sweep of a raw room with
  the >= 100-point filter and resampling to ``num_point`` points
  (DataIO_S3DIS.py:301-433), and ``S3DISTestRooms``, the rooms of one area
  from ``meta/<area>_data_label.txt`` (DataIO_S3DIS.py:254-299, with the
  path join fixed: the reference's leading '/' discarded the base dir).

Channels 0:3 are xyz with the block xy-centred, 3:6 rgb/255, 6:9 xyz
normalized by the room extent. The reference's random block corners
(``random_sample``) are not ported: the test path sweeps the regular grid.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from weaksuppointcloudseg_tpu_torch.utils.profiling import span

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

    @classmethod
    def from_arrays(cls, data: np.ndarray, label: np.ndarray, room_filelist,
                    num_classes: int = NUM_CLASSES) -> "S3DISDataset":
        """A dataset of blocks held in memory: data [S, N, 9], label [S, N]
        and one room name per block (no shards to read)."""
        ds = cls.__new__(cls)
        ds.base, ds.num_classes, ds.all_files = None, num_classes, []
        ds.room_filelist = list(room_filelist)
        ds._data = np.asarray(data, np.float32)
        ds._label = np.asarray(label, np.int32)
        return ds

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


def sample_to_num_points(n: int, num_point: int,
                         rng: np.random.Generator) -> np.ndarray:
    """Indices resampling n points to ``num_point`` (DataIO_S3DIS.py:417-433):
    a draw with replacement when there are more, all of them plus such a
    draw when there are fewer."""
    if n == num_point:
        return np.arange(n)
    if n > num_point:
        return rng.choice(n, num_point)
    return np.concatenate([np.arange(n), rng.choice(n, num_point - n)])


BLOCK_SIZE = 1.0  # metres, the sweep's block edge and stride
MIN_POINTS = 100  # blocks with fewer points are dropped


def _block_members(x: np.ndarray, y: np.ndarray, num_x: int, num_y: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every point's blocks on the grid, bucketed: (the point indices of
    block 0, block 1, ... in turn, each block's in ascending index; where
    each block starts among them; each block's count), blocks numbered
    i * num_y + j.

    Block (i, j) holds i <= x <= i + 1 and j <= y <= j + 1 (bounds
    inclusive, as the reference's mask): a point's own block is (floor(x),
    floor(y)), and a point on an interior edge (x == floor(x) >= 1, or y)
    also belongs to the block below it on that axis, and on a corner to
    the diagonal one too. Blocks off the grid are dropped, such as the own
    block of a point at an integer far extent (x == limit == 5.0). Block
    edges are whole metres (BLOCK_SIZE is 1), so these tests are exact."""
    n, nblocks = len(x), num_x * num_y
    fx, fy = np.floor(x), np.floor(y)
    on_x, on_y = np.flatnonzero(x == fx), np.flatnonzero(y == fy)
    # each point's own block; a point off the grid goes to one more
    # bucket, nblocks, which sorts last and is never read
    key = fx * num_y
    key += fy
    key[(fx < 0) | (fx >= num_x) | (fy < 0) | (fy >= num_y)] = nblocks
    # the edge points' copies: into the block below in x, below in y, and
    # for a corner the diagonal one
    on_x = on_x[(fx[on_x] >= 1) & (fx[on_x] <= num_x)]
    on_y = on_y[(fy[on_y] >= 1) & (fy[on_y] <= num_y)]
    diag = np.intersect1d(on_x, on_y, assume_unique=True)
    on_x = on_x[(fy[on_x] >= 0) & (fy[on_x] < num_y)]
    on_y = on_y[(fx[on_y] >= 0) & (fx[on_y] < num_x)]
    copies = np.concatenate([on_x, on_y, diag])
    kdt = np.int16 if nblocks <= np.iinfo(np.int16).max else np.int64
    keys = np.empty(n + len(copies), kdt)
    keys[:n] = key
    keys[n:] = np.concatenate([(fx[on_x] - 1) * num_y + fy[on_x],
                               fx[on_y] * num_y + fy[on_y] - 1,
                               (fx[diag] - 1) * num_y + fy[diag] - 1])
    # a stable sort keeps each block's own points in index order (numpy
    # sorts 16-bit keys by radix); copies follow them (positions n on), so
    # they are mapped to their points and their blocks put back in order
    members = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=nblocks + 1)[:nblocks]
    members = members[:counts.sum()]
    moved = members >= n
    members[moved] = copies[members[moved] - n]
    starts = np.cumsum(counts) - counts
    for b in np.unique(keys[n:]):
        members[starts[b]:starts[b] + counts[b]].sort()
    return members, starts, counts


def _sweep(data_label: np.ndarray, num_point: int, min_points: int,
           rng: Optional[np.random.Generator]
           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`room_to_blocks` and the room's extent ``limit`` [3] f64."""
    rng = rng or np.random.default_rng(0)
    x = data_label[:, 0].astype(np.float64)
    y = data_label[:, 1].astype(np.float64)
    limit = np.array([x.max(), y.max(), data_label[:, 2].max()], np.float64)
    num_x = int(np.ceil((limit[0] - BLOCK_SIZE) / BLOCK_SIZE)) + 1
    num_y = int(np.ceil((limit[1] - BLOCK_SIZE) / BLOCK_SIZE)) + 1
    empty = (np.zeros((0, num_point, 9), np.float32),
             np.zeros((0, num_point), np.int32), limit)
    if num_x <= 0 or num_y <= 0:
        return empty
    members, starts, counts = _block_members(x, y, num_x, num_y)
    # the draws in the reference's order (i outer, j inner), one call per
    # kept block, so the caller's generator ends where the reference's does
    picks = [starts[b] + sample_to_num_points(int(counts[b]), num_point, rng)
             for b in np.flatnonzero(counts >= min_points)]
    if not picks:
        return empty
    rows = members[np.concatenate(picks)]
    picked = data_label[rows]
    pts = picked[:, 0:6].astype(np.float64).reshape(len(picks), num_point, 6)
    pts[..., 3:6] /= 255.0
    out = np.empty((len(picks), num_point, 9), np.float32)
    out[..., 6:9] = pts[..., 0:3] / limit
    pts[..., 0:2] -= pts[..., 0:2].min(axis=1, keepdims=True) + BLOCK_SIZE / 2
    out[..., 0:6] = pts
    labels = picked[:, -1].astype(np.int32).reshape(len(picks), num_point)
    return out, labels, limit


def room_to_blocks(data_label: np.ndarray, num_point: int, *,
                   min_points: int = MIN_POINTS,
                   rng: Optional[np.random.Generator] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Room -> fixed-size 9-channel blocks (DataIO_S3DIS.py:301-414).

    One pass over the room: each point's 1 m block on the grid is computed
    once, the points are bucketed by block with one stable sort, blocks of
    fewer than ``min_points`` are dropped, and every kept block's
    resampled rows are gathered at once. A point on a block edge belongs
    to both blocks, and on a corner to all four (inclusive bounds, as the
    reference's mask per block); each block's points are in room order.
    The result is bitwise the reference's sweep, the generator's draws
    included.

    Args:
      data_label: [N, 7] (xyz in metres from the room's min corner, rgb
        0-255, class label).
      min_points: blocks with fewer points are dropped.
      rng: the resampling draws, in block order (default: seed 0).

    Returns:
      (blocks [K, num_point, 9] f32, labels [K, num_point] i32).
    """
    blocks, labels, _ = _sweep(data_label, num_point, min_points, rng)
    return blocks, labels


def synthetic_blocks(*, num_rooms_per_area: int = 2,
                     areas: Tuple[int, ...] = (1, 5), blocks_per_room: int = 4,
                     num_points: int = 128, num_classes: int = NUM_CLASSES,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray, list]:
    """The training blocks of the JAX package's ``data/s3dis.py::
    write_synthetic`` (same arguments, same draws), in memory: rooms of
    uniform points in a 2 x 2 x 3 m box whose labels follow the height,
    cut into blocks. Returns (data [S, num_points, 9] f32, label [S,
    num_points] i32, one room name per block), what that writer puts in
    its h5 shard and room_filelist.txt; numpy only."""
    rng = np.random.default_rng(seed)
    all_data, all_labels, room_rows = [], [], []
    for a in areas:
        for r in range(num_rooms_per_area):
            n_raw = blocks_per_room * num_points * 2
            xyz = rng.uniform([0, 0, 0], [2.0, 2.0, 3.0], (n_raw, 3))
            rgb = rng.uniform(0, 255, (n_raw, 3))
            lab = np.minimum((xyz[:, 2] / 3.0 * num_classes).astype(np.int64),
                             num_classes - 1)
            room = np.concatenate([xyz, rgb, lab[:, None]], axis=1)
            blocks, blabels = room_to_blocks(room, num_points, min_points=10,
                                             rng=rng)
            all_data.append(blocks[:blocks_per_room])
            all_labels.append(blabels[:blocks_per_room])
            room_rows += [f"Area_{a}_room_{r}"] * len(all_data[-1])
    return (np.concatenate(all_data).astype(np.float32),
            np.concatenate(all_labels).astype(np.int32), room_rows)


class S3DISTestRooms:
    """The raw rooms of one area, listed in ``meta/<area>_data_label.txt``
    under ``base_dir`` (paths relative to it), swept room by room."""

    def __init__(self, base_dir: str, test_area: str = "area5",
                 num_point: int = 4096):
        self.num_point = num_point
        meta = os.path.join(base_dir, "meta", f"{test_area}_data_label.txt")
        with open(meta) as f:
            self.room_paths = [os.path.join(base_dir, line.strip())
                               for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.room_paths)

    def load_room(self, i: int, rng: Optional[np.random.Generator] = None):
        """(blocks [K, N, 9], labels [K, N], room path, room_max [3] f32).

        ``room_max`` is the room's xyz extent in metres, the scale of block
        channels 6:9: channels 6:9 times it are the points' room
        coordinates, which room-level label propagation needs; the sweep
        computes it in its one pass over the room. Spans
        (utils/profiling.py::span): ``room.read`` (the file) and
        ``room.sweep`` (the sweep, the extent included).
        """
        path = self.room_paths[i]
        with span("room.read"):
            if path.endswith(".txt"):
                data_label = np.loadtxt(path)
            elif path.endswith(".npy"):
                data_label = np.load(path)
            else:
                raise ValueError(f"unknown room file type: {path}")
        with span("room.sweep"):
            blocks, labels, limit = _sweep(data_label, self.num_point,
                                           MIN_POINTS, rng)
            room_max = limit.astype(np.float32)
        return blocks, labels, path, room_max
