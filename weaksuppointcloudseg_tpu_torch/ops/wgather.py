"""Weighted neighbour gathers of the smoothness loss, counterparts of
weaksuppointcloudseg_tpu/ops/edgeconv_pallas.py:

- B6 ``wgather_pre`` (``ops/csrc/wgather.cu``, _wgather_pre_impl):
  ``s[b, n] = sum_j w[b, n, j] * f[b, idx[b, n, j]]`` from a given graph;
- B9 ``knn_wgather`` (``ops/csrc/knn_wgather.cu``, _knn_wgather_impl): kNN
  of f32 points (kernel B12's selection, self included), ``w = exp(-max(d,
  0) / gamma)`` and the same weighted sum, in one pass.

``weighted_gather_pre`` and ``knn_weighted_gather`` are their
differentiable forms (the reference's ``custom_vjp``s): s is linear in f,
so the backward is B6's scatter ``df[idx] += w * ds``
(ops/scatter.py::scatter_add_weighted), rounded to f's dtype; the graph,
the weights and the points carry no gradient.

Each kernel wrapper launches its CUDA kernel on CUDA tensors and takes its
plain version (``*_ref``) on CPU tensors; any other device raises. The
kernels sum the k products exactly in f32, where the Pallas kernels split
the f32 weights into two bf16 halves inside a one-hot matmul: the two
differ by ~2^-16 relative.
"""

from __future__ import annotations

from typing import Tuple

import torch

from weaksuppointcloudseg_tpu_torch.ops import _build
from weaksuppointcloudseg_tpu_torch.ops.knn import (
    check_rows_launch,
    distances,
    idx_bits,
    select_ref,
)
from weaksuppointcloudseg_tpu_torch.ops.scatter import scatter_add_weighted

def wgather_pre_ref(idx: torch.Tensor, w: torch.Tensor,
                    f: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`wgather_pre` (same contract)."""
    bi = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
    return (w[..., None] * f[bi, idx.long()].float()).sum(dim=2)


def wgather_pre(idx: torch.Tensor, w: torch.Tensor,
                f: torch.Tensor) -> torch.Tensor:
    """``s[b, n] = sum_j w[b, n, j] * f[b, idx[b, n, j]]`` -> f32 [B, N, Cf].

    Args:
      idx: int32 [B, N, k] neighbour rows, each in [0, N).
      w: f32 [B, N, k] weights.
      f: bf16 [B, N, Cf] features.
    """
    if f.device.type == "cpu":
        return wgather_pre_ref(idx, w, f)
    if f.device.type != "cuda":
        raise ValueError(f"wgather_pre: unsupported device {f.device}")
    b, n, k = idx.shape
    cf = f.shape[-1]
    dev = f.device
    _build.check_operand(idx, "idx", torch.int32, dev, (b, n, k))
    _build.check_operand(w, "w", torch.float32, dev, (b, n, k))
    _build.check_operand(f, "f", torch.bfloat16, dev, (b, n, cf))
    s = torch.empty((b, n, cf), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.wgather_pre_launch(idx.data_ptr(), w.data_ptr(),
                                      f.data_ptr(), b, n, k, cf, s.data_ptr(),
                                      _build.stream_ptr(dev))
    _build.check(code, "wgather_pre")
    wgather_pre.launches += 1
    return s


def knn_wgather_ref(g: torch.Tensor, f: torch.Tensor, k: int, gamma: float, *,
                    fast: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`knn_wgather` (same contract)."""
    idx, sqd = select_ref(distances(g), k, fast=fast)
    w = torch.exp(-torch.clamp_min(sqd, 0.0) * (1.0 / gamma))
    return idx, wgather_pre_ref(idx, w, f), w


def knn_wgather(g: torch.Tensor, f: torch.Tensor, k: int, gamma: float, *,
                fast: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kNN on ``g`` + exp-weighted neighbour sum of ``f``.

    Args:
      g: f32 [B, N, Cg] points (IEEE f32 distances, as kernel B12's).
      f: bf16 [B, N, Cf] features.
      k: neighbours per point, the point itself included (1 <= k <= 32,
        2k <= N on CUDA).
      gamma: the weights' length scale.
      fast: packed-min selection (near-ties may order differently; the
        distances behind the weights lose their low ``idx_bits(N)``
        mantissa bits, as in the reference).

    Returns:
      (idx int32 [B, N, k] nearest first, s f32 [B, N, Cf], w f32 [B, N, k]
      with w = exp(-max(d, 0) / gamma)).

    On CUDA a block keeps 8 full distance rows and a 256-point tile of g
    in shared memory (B12's layout); a launch past 227 KB raises.
    """
    if g.device.type == "cpu":
        return knn_wgather_ref(g, f, k, gamma, fast=fast)
    if g.device.type != "cuda":
        raise ValueError(f"knn_wgather: unsupported device {g.device}")
    b, n, cg = g.shape
    cf = f.shape[-1]
    dev = g.device
    _build.check_operand(g, "g", torch.float32, dev, (b, n, cg))
    _build.check_operand(f, "f", torch.bfloat16, dev, (b, n, cf))
    if not 1 <= k <= 32 or 2 * k > n:
        raise ValueError(f"knn_wgather: k={k} must be in [1, 32] and 2k <= N={n}")
    check_rows_launch("knn_wgather", b, n, cg)
    idx = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    s = torch.empty((b, n, cf), dtype=torch.float32, device=dev)
    w = torch.empty((b, n, k), dtype=torch.float32, device=dev)
    norms = torch.empty((b, n), dtype=torch.float32, device=dev)  # scratch
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.knn_wgather_launch(
            g.data_ptr(), f.data_ptr(), b, n, cg, cf, k, int(fast),
            idx_bits(n) if fast else 0, 1.0 / gamma, norms.data_ptr(),
            idx.data_ptr(), s.data_ptr(), w.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, "knn_wgather")
    knn_wgather.launches += 1
    return idx, s, w


wgather_pre.launches = 0  # kernel launches since the last reset
knn_wgather.launches = 0


def _scatter_back(ctx, ds):
    """df = scatter of w * ds into f's rows, rounded to f's dtype."""
    idx, w = ctx.saved_tensors
    return scatter_add_weighted(idx, w, ds.float().contiguous(),
                                ctx.f_rows).to(ctx.f_dtype)


def _save(ctx, idx, w, f):
    ctx.save_for_backward(idx, w)
    ctx.f_rows, ctx.f_dtype = f.shape[1], f.dtype


class _WeightedGatherPre(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, w, f):
        _save(ctx, idx, w, f)
        return wgather_pre(idx, w, f)

    @staticmethod
    def backward(ctx, ds):
        return None, None, _scatter_back(ctx, ds)


class _KnnWeightedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, f, k, gamma, fast):
        idx, s, w = knn_wgather(g, f, k, gamma, fast=fast)
        _save(ctx, idx, w, f)
        ctx.mark_non_differentiable(idx, w)
        return idx, s, w

    @staticmethod
    def backward(ctx, _didx, ds, _dw):
        return None, _scatter_back(ctx, ds), None, None, None


def weighted_gather_pre(idx: torch.Tensor, w: torch.Tensor,
                        f: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`wgather_pre` (edgeconv_pallas.py::
    weighted_gather_pre): the gradient reaches ``f`` only, through B6's
    scatter."""
    return _WeightedGatherPre.apply(idx.detach().contiguous(),
                                    w.detach().contiguous(), f.contiguous())


def knn_weighted_gather(g: torch.Tensor, f: torch.Tensor, k: int,
                        gamma: float, *, fast: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable :func:`knn_wgather` (edgeconv_pallas.py::
    knn_weighted_gather): only ``s`` carries a gradient, to ``f``, through
    B6's scatter."""
    return _KnnWeightedGather.apply(g.detach().float().contiguous(),
                                    f.contiguous(), k, gamma, fast)
