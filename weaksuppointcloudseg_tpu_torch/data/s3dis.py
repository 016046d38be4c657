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

The sweep runs on a torch device, the CPU by default: the raw room goes
to the device once, its bucketing, gather and normalisation run there
(ops/room_sweep.py) and the blocks stay there; the host makes the
reference's numpy draws from the block counts alone. ``room_to_blocks``
is that sweep on the CPU with numpy results.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from weaksuppointcloudseg_tpu_torch.ops import room_sweep
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


def _grid(limit: np.ndarray) -> Tuple[int, int]:
    """(num_x, num_y): the blocks of the sweep's grid over a room of
    extent ``limit`` (either may be 0 or less: no block)."""
    return tuple(int(np.ceil((limit[a] - BLOCK_SIZE) / BLOCK_SIZE)) + 1
                 for a in (0, 1))


def _draws(counts: np.ndarray, num_point: int, min_points: int,
           rng: np.random.Generator, picks_buf: _HostBuffer) -> np.ndarray:
    """The draws of every block with at least ``min_points`` members, in
    the reference's order (i outer, j inner), one call per kept block, so
    the caller's generator ends where the reference's does: [K, num_point]
    int32 positions among the bucketed members (a block's start plus its
    draws), filled into ``picks_buf`` for its upload."""
    counts = counts.astype(np.int64)
    starts = np.cumsum(counts) - counts
    kept = np.flatnonzero(counts >= min_points)
    picks = picks_buf.fill((len(kept), num_point), np.int32)
    for row, b in zip(picks, kept):
        row[:] = starts[b] + sample_to_num_points(int(counts[b]), num_point, rng)
    return picks


def _sweep(raw: torch.Tensor, num_point: int, min_points: int,
           rng: Optional[np.random.Generator], picks_buf: _HostBuffer
           ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """The block sweep of a raw room on its torch device: (blocks [K,
    num_point, 9] f32 and labels [K, num_point] i32 on that device, the
    extent ``limit`` [3] f64). The bucketing and the gather run in
    ops/room_sweep.py (the kernels on the card, their plain versions on
    the CPU); the extent and the block counts are fetched (two
    synchronises), the draws are made on the host with the caller's
    generator and their member positions go back through ``picks_buf``."""
    rng = rng or np.random.default_rng(0)
    dev = raw.device
    limit = raw[:, 0:3].amax(0).double().cpu().numpy()
    num_x, num_y = _grid(limit)
    empty = (torch.zeros((0, num_point, 9), dtype=torch.float32, device=dev),
             torch.zeros((0, num_point), dtype=torch.int32, device=dev), limit)
    if num_x <= 0 or num_y <= 0:
        return empty
    members, counts = room_sweep.block_members(raw, num_x, num_y)
    counts = counts.cpu().numpy()
    picks = _draws(counts, num_point, min_points, rng, picks_buf)
    if not len(picks):
        return empty
    blocks, labels = room_sweep.gather_blocks(
        raw, members[:int(counts.sum())], picks_buf.upload(), limit)
    return blocks, labels, limit


def _row_dtype(dtype: np.dtype) -> np.dtype:
    """The dtype a raw room is swept in: float32 and float64 rows as they
    are (in native byte order), any other type as float64."""
    kept = dtype.type in (np.float32, np.float64)
    return np.dtype(dtype.type if kept else np.float64)


def room_to_blocks(data_label: np.ndarray, num_point: int, *,
                   min_points: int = MIN_POINTS,
                   rng: Optional[np.random.Generator] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Room -> fixed-size 9-channel blocks (DataIO_S3DIS.py:301-414).

    :meth:`S3DISTestRooms.load_room`'s sweep on a CPU tensor of the room,
    with the results as numpy arrays. Each point's 1 m block on the grid
    is computed once, the points are bucketed by block, blocks of fewer
    than ``min_points`` are dropped, and every kept block's resampled rows
    are gathered at once. A point on a block edge belongs to both blocks,
    and on a corner to all four (inclusive bounds, as the reference's mask
    per block); each block's points are in room order. The result is
    bitwise the reference's sweep, the generator's draws included. A room
    whose grid has more than ``ops/room_sweep.py::MAX_BLOCKS`` blocks
    (12,288 square metres of floor plan) is refused, as on the card.

    Args:
      data_label: [N, 7] (xyz in metres from the room's min corner, rgb
        0-255, class label); float32 or float64 rows are swept as they
        are, any other type as float64.
      min_points: blocks with fewer points are dropped.
      rng: the resampling draws, in block order (default: seed 0).

    Returns:
      (blocks [K, num_point, 9] f32, labels [K, num_point] i32).
    """
    data_label = np.asarray(data_label)
    raw = torch.from_numpy(np.ascontiguousarray(
        data_label, _row_dtype(data_label.dtype)))
    blocks, labels, _ = _sweep(raw, num_point, min_points, rng,
                               _HostBuffer(raw.device))
    return blocks.numpy(), labels.numpy()


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


_TORCH_DTYPES = {np.float32: torch.float32, np.float64: torch.float64,
                 np.int32: torch.int32}


class _HostBuffer:
    """Host memory that feeds one device, reused from room to room and
    grown to the largest room seen: page-locked where the device is CUDA,
    so that the copy runs without blocking the host. Before it is refilled
    it waits on the event recorded after the copy that last read it."""

    def __init__(self, device: torch.device):
        self.device = device
        self._pinned = device.type == "cuda"
        self._bytes = torch.empty(0, dtype=torch.uint8)
        self._filled: Optional[torch.Tensor] = None
        self._copied = None  # the event after the last copy

    def fill(self, shape, dtype) -> np.ndarray:
        """A writable array of ``shape`` and ``dtype`` (float32, float64 or
        int32) over the buffer, to be filled and then uploaded."""
        if self._copied is not None:
            self._copied.synchronize()
            self._copied = None
        dtype = _TORCH_DTYPES[np.dtype(dtype).type]
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if self._bytes.numel() < nbytes:
            self._bytes = torch.empty(nbytes, dtype=torch.uint8,
                                      pin_memory=self._pinned)
        self._filled = self._bytes[:nbytes].view(dtype).view(tuple(shape))
        return self._filled.numpy()

    def upload(self) -> torch.Tensor:
        """The filled array on the device, one copy that does not block the
        host (on the CPU: the buffer itself, valid until the next fill)."""
        out = self._filled.to(self.device, non_blocking=True)
        if self._pinned:
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self.device))
        return out


def _npy_header(f) -> Optional[Tuple[tuple, np.dtype]]:
    """(shape, dtype) of an open .npy file whose payload is read as it is
    stored (2-D, C order, native float32 or float64), the file then at the
    payload; None for any other."""
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        return None
    if (len(shape) != 2 or fortran or not dtype.isnative
            or dtype.type not in (np.float32, np.float64)):
        return None
    return shape, dtype


READ_WORKERS = 4  # threads that read one room's payload at once


def _read_into(path: str, offset: int, out: np.ndarray) -> None:
    """Fill ``out`` with the bytes of ``path`` from ``offset`` on, in
    READ_WORKERS slices read at once: the copy out of the page cache is
    the cost, and each ``os.preadv`` releases the interpreter lock (an
    86 MB room on the card's host: ~22 ms in one read, 7.5-10 ms in 4)."""
    flat = memoryview(out).cast("B")
    n = len(flat)
    if n == 0:
        return
    step = -(-n // READ_WORKERS)
    fd = os.open(path, os.O_RDONLY)

    def part(a: int) -> None:
        b = min(n, a + step)
        while a < b:
            got = os.preadv(fd, [flat[a:b]], offset + a)
            if got == 0:
                raise ValueError(f"{path}: the payload ends {n - a} bytes short")
            a += got

    try:
        with ThreadPoolExecutor(READ_WORKERS) as pool:
            list(pool.map(part, range(0, n, step)))
    finally:
        os.close(fd)


def read_room(path: str, buf: _HostBuffer) -> np.ndarray:
    """The raw room at ``path`` [n, C] in ``buf``, float32 or float64 rows
    as stored (other types as float64): a 2-D C-order float .npy straight
    into the buffer, any other room through ``np.load`` or ``np.loadtxt``
    and copied in. Returns the buffer's array, valid until its next fill."""
    if path.endswith(".npy"):
        with open(path, "rb") as f:
            header = _npy_header(f)
            offset = f.tell()
        if header is not None:
            out = buf.fill(*header)
            _read_into(path, offset, out)
            return out
        data = np.load(path)
    elif path.endswith(".txt"):
        data = np.loadtxt(path)
    else:
        raise ValueError(f"unknown room file type: {path}")
    if data.ndim != 2:
        raise ValueError(f"{path}: shape {data.shape}, expected [n, C]")
    out = buf.fill(data.shape, _row_dtype(data.dtype))
    out[...] = data
    return out


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
        self._bufs: Optional[Tuple[_HostBuffer, _HostBuffer]] = None

    def __len__(self) -> int:
        return len(self.room_paths)

    def load_room(self, i: int, rng: Optional[np.random.Generator] = None,
                  device="cpu"):
        """(blocks [K, N, 9] f32, labels [K, N] i32, room path, room_max [3]
        f32), the blocks and labels as tensors on ``device``.

        The room is swept on ``device`` (:func:`_sweep`: ops/room_sweep.py's
        kernels on the card, their plain versions on the CPU). ``room_max``
        is the room's xyz extent in metres, the scale of block channels
        6:9: channels 6:9 times it are the points' room coordinates, which
        room-level label propagation needs; the sweep computes it. Spans
        (utils/profiling.py::span): ``room.read`` (the file, into a host
        buffer that the reader reuses from room to room) and ``room.sweep``
        (the sweep, the extent included), which holds ``room.upload`` (the
        room's one copy to the device). A room whose grid has more than
        ``ops/room_sweep.py::MAX_BLOCKS`` blocks (12,288 square metres of
        floor plan) is refused.
        """
        device = torch.device(device)
        if self._bufs is None or self._bufs[0].device != device:
            self._bufs = (_HostBuffer(device), _HostBuffer(device))
        room_buf, picks_buf = self._bufs
        path = self.room_paths[i]
        with span("room.read"):
            read_room(path, room_buf)
        with span("room.sweep"):
            with span("room.upload"):
                raw = room_buf.upload()
            blocks, labels, limit = _sweep(raw, self.num_point, MIN_POINTS,
                                           rng, picks_buf)
            room_max = limit.astype(np.float32)
        return blocks, labels, path, room_max
