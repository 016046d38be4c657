"""Kernel B15: kNN + neighbour-row gather in one pass
(``ops/csrc/knn_gather.cu``).

Counterpart of weaksuppointcloudseg_tpu/ops/edgeconv_pallas.py::
_knn_gather_fwd_impl and its public functions ``knn_gather``,
``knn_gather_with_sqdist`` (edgeconv_pallas.py:310, 367) and
``edge_feature_fused`` (:1216): the k nearest neighbours of every point
of ``g`` and the rows ``f[idx]``, with the selected squared distances on
request. The selection is kernel B12's (exact: ties to the lowest index;
fast: packed-min), run on ``g`` widened exactly to f32, so the exact
indices equal kernel B1's on the same bf16 ``g``. The rows are copied
exactly in bf16 and f32 (the reference rounds f32 rows only because its
TPU gather is a matrix-unit product).

Gradients flow to ``f`` only (:class:`KnnGather`): ``df`` scatter-adds the
cotangent of the rows back along ``idx`` through kernel B13; ``g`` gets
none, as the reference's ``_make_vjp`` (:339-360).

``knn_gather`` launches the CUDA kernel on CUDA tensors and takes the plain
version ``knn_gather_ref`` on CPU tensors; any other device raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from weaksuppointcloudseg_tpu_torch.ops import _build
from weaksuppointcloudseg_tpu_torch.ops.gather import gather_rows_ref
from weaksuppointcloudseg_tpu_torch.ops.knn import (
    check_tiles_launch,
    distances,
    idx_bits,
    select_ref,
)
from weaksuppointcloudseg_tpu_torch.ops.scatter import scatter_add

_DTYPES = (torch.bfloat16, torch.float32)
K_MAX = 32  # the largest k of B15


def knn_gather_ref(g: torch.Tensor, f: torch.Tensor, k: int, *,
                   fast: bool = False, with_values: bool = False
                   ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the forward of :func:`knn_gather`."""
    idx, sqd = select_ref(distances(g), k, fast=fast)
    out = (idx, gather_rows_ref(f, idx))
    return out + (sqd,) if with_values else out


def _forward(g: torch.Tensor, f: torch.Tensor, k: int, fast: bool,
             with_values: bool) -> Tuple[torch.Tensor, ...]:
    """(idx, nbr [, sqd]) from the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if g.device.type == "cpu":
        return knn_gather_ref(g, f, k, fast=fast, with_values=with_values)
    if g.device.type != "cuda":
        raise ValueError(f"knn_gather: unsupported device {g.device}")
    b, n, cg = g.shape
    cf = f.shape[-1]
    dev = g.device
    for name, t, c in (("g", g, cg), ("f", f, cf)):
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name}: dtype {t.dtype}, expected bf16 or f32")
        _build.check_operand(t, name, t.dtype, dev, (b, n, c))
    check_tiles_launch("knn_gather", b, n, cg, k, K_MAX)
    g32 = g.float()  # exact for bf16: the distances are B1's
    idx = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    nbr = torch.empty((b, n, k, cf), dtype=f.dtype, device=dev)
    sqd = (torch.empty((b, n, k), dtype=torch.float32, device=dev)
           if with_values else None)
    norms = torch.empty((b, n), dtype=torch.float32, device=dev)  # scratch
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.knn_gather_launch(
            g32.data_ptr(), f.data_ptr(), b, n, cg, cf * f.element_size(), k,
            int(fast), idx_bits(n) if fast else 0, norms.data_ptr(),
            idx.data_ptr(), nbr.data_ptr(), _build.ptr(sqd),
            _build.stream_ptr(dev))
    _build.check(code, "knn_gather")
    knn_gather.launches += 1
    return (idx, nbr, sqd) if with_values else (idx, nbr)


class KnnGather(torch.autograd.Function):
    """(idx, nbr [, sqd]) of :func:`knn_gather` with its VJP: the rows'
    cotangent scatter-adds back onto f's rows along idx in f32 (kernel
    B13), rounded to f's dtype; g, idx and sqd get no gradient."""

    @staticmethod
    def forward(ctx, g, f, k, fast, with_values):
        out = _forward(g.detach(), f.detach(), k, fast, with_values)
        ctx.save_for_backward(out[0])
        ctx.n, ctx.dtype = f.shape[1], f.dtype
        ctx.mark_non_differentiable(out[0], *out[2:])
        return out

    @staticmethod
    def backward(ctx, _didx, dnbr, *_):
        (idx,) = ctx.saved_tensors
        df = scatter_add(idx, dnbr.float().contiguous(), ctx.n)
        return None, df.to(ctx.dtype), None, None, None


def knn_gather(g: torch.Tensor, f: torch.Tensor, k: int, *, fast: bool = False,
               with_values: bool = False) -> Tuple[torch.Tensor, ...]:
    """Fused kNN graph on ``g`` + gather of ``f`` at the neighbours.

    Args:
      g: [B, N, Cg] bf16 or f32 points the graph is built on (no gradient).
      f: [B, N, Cf] bf16 or f32 features to gather (gradient via B13).
      k: neighbours per point, the point itself first; on CUDA
        1 <= k <= min(32, N).
      fast: packed-min selection: near-ties may order differently from the
        exact mode (held to an agreement rate), and the selected distance
        has its low ``idx_bits(N)`` mantissa bits cleared.
      with_values: also return the selected squared distances.

    Returns:
      (idx int32 [B,N,k], nbr [B,N,k,Cf] in f's dtype [, sqd f32 [B,N,k]]).

    On CUDA any N and Cg are taken; k above 32 or a batch past 65535
    raises (ops/knn.py::check_tiles_launch).
    """
    return KnnGather.apply(g, f, k, fast, with_values)


knn_gather.launches = 0  # kernel launches since the last reset


def knn_gather_with_sqdist(g: torch.Tensor, f: torch.Tensor, k: int, *,
                           fast: bool = False) -> Tuple[torch.Tensor, ...]:
    """:func:`knn_gather` with the selected squared distances:
    (idx, nbr, sqd)."""
    return knn_gather(g, f, k, fast=fast, with_values=True)


def edge_feature_fused(g: torch.Tensor, f: torch.Tensor, k: int, *,
                       fast: bool = False) -> torch.Tensor:
    """EdgeConv edge features concat([f_i, f_j - f_i]) [B, N, k, 2Cf] on
    the graph of ``g``, through :func:`knn_gather`."""
    nbr = knn_gather(g, f, k, fast=fast)[1]
    central = f[:, :, None, :].expand_as(nbr)
    return torch.cat([central, nbr - central], dim=-1)
