"""Kernel B12: k nearest neighbours of f32 points (``ops/csrc/knn.cu``).

Counterpart of weaksuppointcloudseg_tpu/ops/knn_pallas.py::knn_pallas. The
B x N x N distances never reach device memory: the kernel
(``ops/csrc/knn_tiles.cuh``) computes them tile by tile in registers and
streams each row's k smallest through a threshold filter into a per-row
heap, so shared memory does not grow with N.

``knn`` launches the CUDA kernel on CUDA tensors and takes the plain
version ``knn_ref`` on CPU tensors; any other device raises. The plain
selection here (``select_ref``) also serves kernel B1's plain version
(ops/edgeconv.py).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from weaksuppointcloudseg_tpu_torch.ops import _build

_PAD_PACKED = 0x7F000000  # packed value of a column >= n_valid (fast mode)
_SMEM_LIMIT = 227 * 1024  # shared memory one block may use on an H100
K_MAX = 64  # the largest k of B12 (knn_tiles.cuh keeps 64-entry row lists)
_GRID_Y_MAX = 65535  # the tiled kernels' grid holds the batch in y


def idx_bits(n: int) -> int:
    """Low bits of a packed fast-mode entry that hold the column index."""
    return max(1, (n - 1).bit_length())


def distances(x: torch.Tensor) -> torch.Tensor:
    """(-2 x_i.x_j + |x_i|^2) + |x_j|^2 in f32, in the Pallas kernels'
    order of additions (knn_pallas.py:121-127, edgeconv_pallas.py:110-119),
    unclamped. The Gram is IEEE f32 (the package disables TF32)."""
    xf = x.float()
    sq = torch.sum(xf * xf, dim=-1)
    d = -2.0 * torch.bmm(xf, xf.transpose(1, 2))
    d = d + sq[:, :, None]
    return d + sq[:, None, :]


def select_ref(d: torch.Tensor, k: int, *, fast: bool,
               n_valid: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 idx, f32 sqd) [B, N, k] of the k smallest entries of each row
    of d [B, N, N], nearest first.

    Exact: ties go to the lowest index (a stable sort; ``torch.topk``
    promises no tie order), values unclamped. Fast: d clamped at 0, one
    top-k over the packed "distance bits | column" int32, whose low
    ``idx_bits(N)`` mantissa bits are dropped from the values. Columns >=
    n_valid are never selected. In both modes NaN distances come after
    every number, in column order (the CUDA kernels keep that order).
    """
    n = d.shape[-1]
    nv = n if n_valid is None else min(n_valid, n)
    col = torch.arange(n, device=d.device, dtype=torch.int32)
    if fast:
        mask = (1 << idx_bits(n)) - 1
        bits = torch.clamp_min(d, 0.0).view(torch.int32)
        packed = (bits & ~mask) | col
        if nv < n:
            packed = torch.where(col < nv, packed, _PAD_PACKED | col)
        # packed values are unique (the column sits in the low bits)
        sel = torch.topk(packed, k, dim=-1, largest=False, sorted=True).values
        return sel & mask, (sel & ~mask).view(torch.float32)
    if nv < n:
        d = torch.where(col < nv, d, torch.inf)
    sqd, idx = torch.sort(d, dim=-1, stable=True)
    return idx[..., :k].int(), sqd[..., :k]


def check_tiles_launch(what: str, b: int, n: int, c: int, k: int,
                       k_max: int = K_MAX) -> None:
    """Raise for a launch the tiled kNN kernels (ops/csrc/knn_tiles.cuh,
    kernels B1, B12 and B15) do not take: k outside [1, min(k_max, N)] (a
    row's sorted list holds 32 or 64 entries: B1 and B12 take k <= 64, B15
    k <= 32), a batch outside the grid's y dimension [1, 65535], or points
    without channels. Shared memory does not depend on N or k beyond the
    list, so any N and C are taken."""
    if not 1 <= k <= min(k_max, n):
        raise ValueError(f"{what}: k={k} must be in [1, min({k_max}, N={n})]")
    if not 1 <= b <= _GRID_Y_MAX:
        raise ValueError(f"{what}: batch {b} outside the grid's "
                         f"[1, {_GRID_Y_MAX}]")
    if c < 1:
        raise ValueError(f"{what}: C={c}, points need a channel")


def check_rows_launch(what: str, b: int, n: int, c: int) -> None:
    """Raise for a shape the distance-rows kernel (ops/csrc/knn_rows.cuh,
    kernel B9) cannot launch: a block keeps 8 full distance rows and a
    256-point tile of C-channel points in shared memory, and the grid
    holds the batch in its y dimension."""
    if b > 65535:
        raise ValueError(f"{what}: batch {b} exceeds the grid limit")
    stride = (c + 3) // 4 * 4 + 4
    if 4 * (264 * stride + 8 * n) > _SMEM_LIMIT:
        raise ValueError(f"{what}: N={n}, C={c} exceeds the kernel's shared "
                         "memory")


def knn_ref(x: torch.Tensor, k: int, *, fast: bool = False,
            with_values: bool = False
            ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Plain PyTorch version of :func:`knn` (same contract)."""
    idx, sqd = select_ref(distances(x), k, fast=fast)
    return (idx, sqd) if with_values else idx


def knn(x: torch.Tensor, k: int, *, fast: bool = False,
        with_values: bool = False
        ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The k nearest neighbours of every point, the point itself first.

    Args:
      x: [B, N, C] f32 points or features.
      k: neighbours per point, 1 <= k <= N; on CUDA also k <= 64.
      fast: packed-min selection (distances clamped at 0; near-ties may
        order differently from the exact mode, so it is held to an
        agreement rate, never equality).
      with_values: also return the selected squared distances.

    Returns:
      int32 idx [B, N, k] nearest first; with ``with_values`` a tuple
      (idx, sqd f32 [B, N, k]).

    On CUDA any N and C are taken; k above 64 or a batch past 65535 raises
    (:func:`check_tiles_launch`).
    """
    if x.device.type == "cpu":
        return knn_ref(x, k, fast=fast, with_values=with_values)
    if x.device.type != "cuda":
        raise ValueError(f"knn: unsupported device {x.device}")
    b, n, c = x.shape
    dev = x.device
    _build.check_operand(x, "x", torch.float32, dev, (b, n, c))
    check_tiles_launch("knn", b, n, c, k)
    idx = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    sqd = (torch.empty((b, n, k), dtype=torch.float32, device=dev)
           if with_values else None)
    norms = torch.empty((b, n), dtype=torch.float32, device=dev)  # scratch
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.knn_launch(x.data_ptr(), b, n, c, k, int(fast),
                              idx_bits(n) if fast else 0, norms.data_ptr(),
                              idx.data_ptr(), _build.ptr(sqd),
                              _build.stream_ptr(dev))
    _build.check(code, "knn")
    knn.launches += 1
    return (idx, sqd) if with_values else idx


knn.launches = 0  # kernel launches since the last reset
