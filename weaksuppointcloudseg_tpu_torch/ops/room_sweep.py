"""The room sweep's bucketing, gather and normalisation
(``ops/csrc/room_sweep.cu`` on the card), the port's one block sweep of a
raw S3DIS room (data/s3dis.py::_sweep).

Replaces no Pallas kernel: the JAX package sweeps a raw room with numpy on
the host (data/s3dis.py::room_to_blocks, a mask per block). The kernels
were added because that sweep was the largest share of a room request and
its blocks go to the card anyway; the host keeps the reference's numpy
draws and fetches only the block counts for them. Their bound is bytes:
30.7 MB for the bucketing and 20.4 MB for the gather of the largest
benchmark room (1.54 M float64 rows, 48 blocks of 4096 points), 0.0092
and 0.0061 ms at 3.35 TB/s (chip_smoke.py's phase 2 times them).

Both follow the JAX package's sweep rules:

- :func:`block_members`: every grid block's member rows in ascending
  point index. Block (i, j) holds i <= x <= i + 1 and j <= y <= j + 1
  (inclusive bounds), so a point on an interior block edge is in both
  blocks and on a corner in all four, and a block off the grid holds
  nothing;
- :func:`gather_blocks`: the drawn rows of each kept block (the draws
  made i outer, j inner, as the reference's loop), normalised in the
  reference's float64 arithmetic and rounded once to float32.

Each wrapper launches its CUDA kernels on CUDA tensors and takes its plain
version (``*_ref``) on CPU tensors; any other device raises. The plain
versions are the CPU path and the card tests' oracle; the CPU tests hold
them bitwise to the JAX package's ``room_to_blocks``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from weaksuppointcloudseg_tpu_torch.ops import _build

MAX_BLOCKS = 12288  # grid blocks of one room: the bucketing's shared memory
MIN_TILE = 1024  # points a warp buckets (a multiple of 32)
HIST_ENTRIES = 1 << 22  # the most per-tile counts the bucketing keeps


def _check_room(raw: torch.Tensor, min_cols: int) -> None:
    if raw.dim() != 2 or raw.shape[0] < 1 or raw.shape[1] < min_cols:
        raise ValueError(f"raw room: shape {tuple(raw.shape)}, expected "
                         f"[n >= 1, C >= {min_cols}]")
    if raw.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"raw room: dtype {raw.dtype}, expected float32 or float64")


def _check_grid(raw: torch.Tensor, num_x: int, num_y: int) -> None:
    _check_room(raw, 2)
    if num_x < 1 or num_y < 1 or num_x * num_y > MAX_BLOCKS:
        raise ValueError(f"grid {num_x} x {num_y}: expected 1 to {MAX_BLOCKS} blocks")


def block_members_ref(raw: torch.Tensor, num_x: int, num_y: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`block_members` (same contract): the
    entries (block, point) sorted by block, then point."""
    _check_grid(raw, num_x, num_y)
    x, y = raw[:, 0].double(), raw[:, 1].double()
    fx, fy = x.floor(), y.floor()
    in_x, in_y = (fx >= 0) & (fx < num_x), (fy >= 0) & (fy < num_y)
    edge_x = (x == fx) & (fx >= 1) & (fx <= num_x)
    edge_y = (y == fy) & (fy >= 1) & (fy <= num_y)
    ix = torch.where(in_x | edge_x, fx, 0).long()
    iy = torch.where(in_y | edge_y, fy, 0).long()
    keys = torch.stack([ix * num_y + iy, (ix - 1) * num_y + iy,
                        ix * num_y + iy - 1, (ix - 1) * num_y + iy - 1], 1)
    valid = torch.stack([in_x & in_y, edge_x & in_y, edge_y & in_x,
                         edge_x & edge_y], 1)
    n = raw.shape[0]
    points = torch.arange(n, device=raw.device)[:, None].expand(n, 4)
    keys, points = keys[valid], points[valid]
    members = points[torch.argsort(keys * n + points)]
    counts = torch.bincount(keys, minlength=num_x * num_y)
    return members.int(), counts.int()


def block_members(raw: torch.Tensor, num_x: int, num_y: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every block's member rows of a raw room on a num_x x num_y grid of
    1 m blocks (block i * num_y + j holds i <= x <= i + 1, j <= y <= j + 1).

    Args:
      raw: float32 or float64 [n, C], contiguous; x and y in columns 0, 1.

    Returns:
      (members int32 [>= M], counts int32 [num_x * num_y]): block b's rows,
      in ascending index, are ``members[s, s + counts[b])`` with s the sum
      of the counts before b; M is the sum of all counts. On the card
      ``members`` has room for 4 n entries and only its first M are set.
    """
    if raw.device.type == "cpu":
        return block_members_ref(raw, num_x, num_y)
    if raw.device.type != "cuda":
        raise ValueError(f"block_members: unsupported device {raw.device}")
    _check_grid(raw, num_x, num_y)
    dev = raw.device
    _build.check_operand(raw, "raw", raw.dtype, dev)
    n, ncols = raw.shape
    nblocks = num_x * num_y
    tile = max(MIN_TILE, -(-n * nblocks // HIST_ENTRIES))
    tile = -(-tile // 32) * 32
    tiles = -(-n // tile)
    if 4 * n > torch.iinfo(torch.int32).max:
        raise ValueError(f"block_members: {n} points, more than int32 slots hold")
    hist = torch.empty(nblocks * tiles, dtype=torch.int32, device=dev)
    counts = torch.empty(nblocks, dtype=torch.int32, device=dev)
    starts = torch.empty(nblocks, dtype=torch.int32, device=dev)
    members = torch.empty(4 * n, dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.room_sweep_members_launch(
            raw.data_ptr(), int(raw.dtype == torch.float64), n, ncols, num_x,
            num_y, tile, tiles, hist.data_ptr(), counts.data_ptr(),
            starts.data_ptr(), members.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "block_members")
    block_members.launches += 1
    return members, counts


def gather_blocks_ref(raw: torch.Tensor, members: torch.Tensor,
                      picks: torch.Tensor, limit) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`gather_blocks` (same contract)."""
    _check_room(raw, 7)
    picked = raw[members[picks.long()].long()].double()  # [K, P, C]
    out = torch.empty(picked.shape[:2] + (9,), dtype=torch.float32,
                      device=raw.device)
    # divisors as tensors, not scalars: a true division by each element
    lim = torch.tensor([float(v) for v in limit], dtype=torch.float64,
                       device=raw.device)
    out[..., 6:9] = picked[..., 0:3] / lim
    centre = picked[..., 0:2].amin(1, keepdim=True) + 0.5  # BLOCK_SIZE / 2
    out[..., 0:2] = picked[..., 0:2] - centre
    out[..., 2] = picked[..., 2]
    out[..., 3:6] = picked[..., 3:6] / torch.full_like(lim, 255.0)
    return out, picked[..., -1].int()


def gather_blocks(raw: torch.Tensor, members: torch.Tensor, picks: torch.Tensor,
                  limit) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kept blocks of a room from their drawn rows, as the JAX
    package's room_to_blocks makes them: channels x - (min x + 0.5), y - (min
    y + 0.5), z, rgb / 255, xyz / limit, the min over the block's picks,
    in float64 and rounded once to float32.

    Args:
      raw: float32 or float64 [n, C >= 7], contiguous (xyz, rgb, ..., the
        class label last).
      members: int32 [M], :func:`block_members`' first M entries.
      picks: int32 [K, P], positions in ``members`` (a block's start plus
        its draws). The kernel does not clamp: a position or row out of
        range stops it with a device trap.
      limit: the room's xyz extent, 3 floats.

    Returns:
      (blocks float32 [K, P, 9], labels int32 [K, P], the label column
      truncated).
    """
    if raw.device.type == "cpu":
        return gather_blocks_ref(raw, members, picks, limit)
    if raw.device.type != "cuda":
        raise ValueError(f"gather_blocks: unsupported device {raw.device}")
    _check_room(raw, 7)
    dev = raw.device
    n, ncols = raw.shape
    k, p = picks.shape
    _build.check_operand(raw, "raw", raw.dtype, dev)
    _build.check_operand(members, "members", torch.int32, dev)
    _build.check_operand(picks, "picks", torch.int32, dev, (k, p))
    blocks = torch.empty((k, p, 9), dtype=torch.float32, device=dev)
    labels = torch.empty((k, p), dtype=torch.int32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.room_sweep_gather_launch(
            raw.data_ptr(), int(raw.dtype == torch.float64), n, ncols,
            members.data_ptr(), members.numel(), picks.data_ptr(), k, p,
            *(float(v) for v in limit), blocks.data_ptr(), labels.data_ptr(),
            _build.stream_ptr(dev))
    _build.check(code, "gather_blocks")
    gather_blocks.launches += 1
    return blocks, labels


block_members.launches = 0  # calls of the bucketing (4 kernels each) since the last reset
gather_blocks.launches = 0  # kernel launches since the last reset
