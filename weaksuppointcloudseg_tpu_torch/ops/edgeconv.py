"""Kernel B1: fused kNN + first EdgeConv conv (``ops/csrc/knn_edge.cu``),
and kernel B11: the same first conv on a given graph
(``ops/csrc/knn_edge_pre.cu``).

B1 is the counterpart of weaksuppointcloudseg_tpu/ops/edgeconv_pallas.py::
_knn_edge_impl. The first conv of an EdgeConv stage factors as
``conv(concat([f_i, f_j - f_i])) = u_i + v_j`` with per-point
``u = f (W_top - W_bot) + b`` and ``v = f W_bot`` (models/layers.py::
_uv_factor), so the kernel only adds ``u`` to each selected neighbor's
``v``: the edge tensor and the distance matrix never reach memory.

B11 (``knn_edge_pre``, counterpart of ``_knn_edge_pre_impl``) is B1's
epilogue with the neighbours read from a given ``idx`` instead of
selected: the static-graph mode's reusing stages. Given B1's own indices
it returns B1's y1 and extrema bit for bit. ``KnnEdgeGatherPre`` is its
VJP (``knn_edge_gather_pre``, edgeconv_pallas.py:892-943), whose scatter
is kernel B13.

``knn_edge`` and ``knn_edge_pre`` launch their CUDA kernels on CUDA
tensors and take their plain versions (``knn_edge_ref``,
``knn_edge_pre_ref``) on CPU tensors; any other device raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from weaksuppointcloudseg_tpu_torch.ops import _build
from weaksuppointcloudseg_tpu_torch.ops.knn import distances, idx_bits, select_ref
from weaksuppointcloudseg_tpu_torch.ops.scatter import scatter_add


def knn_edge_ref(g: torch.Tensor, v: torch.Tensor, u: torch.Tensor, k: int, *,
                 fast: bool, with_minmax: bool = False,
                 with_values: bool = False,
                 n_valid: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`knn_edge` (same contract)."""
    n = g.shape[1]
    nv = n if n_valid is None else min(n_valid, n)
    idx, sqd = select_ref(distances(g), k, fast=fast, n_valid=nv)
    out = edge_outputs_ref(idx, v, u, with_minmax=with_minmax, n_valid=nv)
    return out + (sqd,) if with_values else out


def edge_outputs_ref(idx: torch.Tensor, v: torch.Tensor, u: torch.Tensor, *,
                     with_minmax: bool = False,
                     n_valid: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """:func:`knn_edge`'s outputs at the given neighbour indices ``idx``
    [B, N, k]: (idx, y1, mom [, ymax, amax, ymin, amin])."""
    b, n = idx.shape[:2]
    nv = n if n_valid is None else min(n_valid, n)
    bi = torch.arange(b, device=idx.device)[:, None, None]
    y = (v.float()[bi, idx.long()] + u.float()[:, :, None, :]).to(v.dtype)
    if nv < n:
        y[:, nv:] = 0  # rows past n_valid hold zeros, as the reference's do
    y32 = y.float()
    yv = y32[:, :nv]
    mom = torch.stack([yv.sum(dim=(0, 1, 2)), (yv * yv).sum(dim=(0, 1, 2))])
    out = (idx, y, mom)
    if with_minmax:
        # argmax/argmin return the first extremal slot, the kernel's rule
        amax = torch.argmax(y32, dim=2, keepdim=True)
        amin = torch.argmin(y32, dim=2, keepdim=True)
        out += (torch.gather(y, 2, amax)[:, :, 0], amax[:, :, 0].int(),
                torch.gather(y, 2, amin)[:, :, 0], amin[:, :, 0].int())
    return out


def knn_edge(g: torch.Tensor, v: torch.Tensor, u: torch.Tensor, k: int, *,
             fast: bool, with_minmax: bool = False, with_values: bool = False,
             n_valid: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """kNN on ``g`` + ``y1 = bf16(v[idx] + u)`` + moments, in one pass.

    Args:
      g: [B, N, Cg] bf16 graph coordinates.
      v, u: [B, N, C] bf16 factored first-conv terms.
      k: neighbors per point (the point itself is the first).
      fast: packed-min selection. Near-ties may order differently from
        the exact mode; the packing width follows this N, not the TPU's
        padded width, so it is held to an agreement rate, never equality.
      with_minmax: also return the per-channel max/min of y1 over the k
        slots with the first winning slot.
      with_values: also return the selected squared distances.
      n_valid: only columns < n_valid are candidates and only rows <
        n_valid enter the moments; rows past it hold zeros.

    Returns:
      (idx int32 [B,N,k], y1 bf16 [B,N,k,C], mom f32 [2,C]
       [, ymax bf16 [B,N,C], amax int32, ymin bf16, amin int32]
       [, sqd f32 [B,N,k]]).

    On CUDA a block keeps 8 full distance rows and a 256-point tile of g
    in shared memory, which bounds the shape (C=64, k=20: Cg <= 124 at
    N=3000, Cg <= 152 at N=2048); a launch past that raises.
    """
    if g.device.type == "cpu":
        return knn_edge_ref(g, v, u, k, fast=fast, with_minmax=with_minmax,
                            with_values=with_values, n_valid=n_valid)
    if g.device.type != "cuda":
        raise ValueError(f"knn_edge: unsupported device {g.device}")
    b, n, cg = g.shape
    c = v.shape[-1]
    dev = g.device
    _build.check_operand(g, "g", torch.bfloat16, dev, (b, n, cg))
    _build.check_operand(v, "v", torch.bfloat16, dev, (b, n, c))
    _build.check_operand(u, "u", torch.bfloat16, dev, (b, n, c))
    if not 1 <= k <= n:
        raise ValueError(f"knn_edge: k={k} must be in [1, N={n}]")
    if b > 65535:
        raise ValueError(f"knn_edge: batch {b} exceeds the grid limit")
    nv = n if n_valid is None else max(0, min(n_valid, n))
    idx = torch.empty((b, n, k), dtype=torch.int32, device=dev)
    y = torch.empty((b, n, k, c), dtype=torch.bfloat16, device=dev)
    mom = torch.zeros((2, c), dtype=torch.float32, device=dev)
    mm = (torch.empty((b, n, c), dtype=torch.bfloat16, device=dev),
          torch.empty((b, n, c), dtype=torch.int32, device=dev),
          torch.empty((b, n, c), dtype=torch.bfloat16, device=dev),
          torch.empty((b, n, c), dtype=torch.int32, device=dev)
          ) if with_minmax else (None,) * 4
    sqd = (torch.empty((b, n, k), dtype=torch.float32, device=dev)
           if with_values else None)
    norms = torch.empty((b, n), dtype=torch.float32, device=dev)  # scratch
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.knn_edge_launch(
            g.data_ptr(), v.data_ptr(), u.data_ptr(), b, n, cg, c, k,
            int(fast), nv, idx_bits(n) if fast else 0, norms.data_ptr(),
            idx.data_ptr(), y.data_ptr(), mom.data_ptr(),
            *[_build.ptr(t) for t in mm],
            _build.ptr(sqd), _build.stream_ptr(dev))
    _build.check(code, "knn_edge")
    knn_edge.launches += 1
    out = (idx, y, mom)
    if with_minmax:
        out += mm
    if with_values:
        out += (sqd,)
    return out


knn_edge.launches = 0  # kernel launches since the last reset


def knn_edge_pre_ref(idx: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
                     k: int, *, with_minmax: bool = False,
                     n_valid: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`knn_edge_pre` (same contract):
    :func:`edge_outputs_ref` without the indices."""
    if idx.shape[-1] != k:
        raise ValueError(f"knn_edge_pre: idx holds {idx.shape[-1]} neighbours, "
                         f"expected k={k}")
    return edge_outputs_ref(idx, v, u, with_minmax=with_minmax,
                            n_valid=n_valid)[1:]


def knn_edge_pre(idx: torch.Tensor, v: torch.Tensor, u: torch.Tensor, k: int,
                 *, with_minmax: bool = False,
                 n_valid: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """``y1 = bf16(v[idx] + u)`` + moments on a given kNN graph (kernel B11).

    Args:
      idx: int32 [B, N, k] neighbour rows, each in [0, N). The kernel does
        not clamp: an index outside the range stops it with a device trap.
      v, u: [B, N, C] bf16 factored first-conv terms.
      k: neighbours per point (idx's last dimension).
      with_minmax: also return the per-channel max/min of y1 over the k
        slots with the first winning slot.
      n_valid: only rows < n_valid enter the moments; rows past it hold
        zeros (and zero extrema at slot 0), as B1 writes them.

    Returns:
      (y1 bf16 [B,N,k,C], mom f32 [2,C]
       [, ymax bf16 [B,N,C], amax int32, ymin bf16, amin int32]).
    """
    if idx.device.type == "cpu":
        return knn_edge_pre_ref(idx, v, u, k, with_minmax=with_minmax,
                                n_valid=n_valid)
    if idx.device.type != "cuda":
        raise ValueError(f"knn_edge_pre: unsupported device {idx.device}")
    b, n, c = v.shape
    dev = idx.device
    _build.check_operand(idx, "idx", torch.int32, dev, (b, n, k))
    _build.check_operand(v, "v", torch.bfloat16, dev, (b, n, c))
    _build.check_operand(u, "u", torch.bfloat16, dev, (b, n, c))
    if k < 1 or b > 65535:
        raise ValueError(f"knn_edge_pre: k={k}, batch {b} out of range")
    nv = n if n_valid is None else max(0, min(n_valid, n))
    y = torch.empty((b, n, k, c), dtype=torch.bfloat16, device=dev)
    mom = torch.zeros((2, c), dtype=torch.float32, device=dev)
    mm = (torch.empty((b, n, c), dtype=torch.bfloat16, device=dev),
          torch.empty((b, n, c), dtype=torch.int32, device=dev),
          torch.empty((b, n, c), dtype=torch.bfloat16, device=dev),
          torch.empty((b, n, c), dtype=torch.int32, device=dev)
          ) if with_minmax else (None,) * 4
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.knn_edge_pre_launch(
            idx.data_ptr(), v.data_ptr(), u.data_ptr(), b, n, c, k, nv,
            y.data_ptr(), mom.data_ptr(), *[_build.ptr(t) for t in mm],
            _build.stream_ptr(dev))
    _build.check(code, "knn_edge_pre")
    knn_edge_pre.launches += 1
    return (y, mom) + mm if with_minmax else (y, mom)


knn_edge_pre.launches = 0  # kernel launches since the last reset


class KnnEdgeGatherPre(torch.autograd.Function):
    """``(y1, mom) = knn_edge_pre(idx, v, u, k)`` with its VJP
    (edgeconv_pallas.py:892-943): the moments' cotangent folds into
    ``dy_eff = bf16(dy + dmom[0] + 2 y dmom[1])``; ``du`` sums dy_eff over
    the k slots in f32, ``dv`` scatters it along idx (kernel B13), and idx
    gets no gradient. Only tests reach it: the fused stages fold this
    backward into their own (models/layers.py)."""

    @staticmethod
    def forward(ctx, idx, v, u, k):
        y, mom = knn_edge_pre(idx, v.detach(), u.detach(), k)
        ctx.save_for_backward(idx, y)
        ctx.dtypes = (v.dtype, u.dtype)
        ctx.mark_non_differentiable(idx)
        return y, mom

    @staticmethod
    def backward(ctx, dy, dmom):
        idx, y = ctx.saved_tensors
        dy_eff = (dy.float() + dmom[0] + 2.0 * y.float() * dmom[1]).to(y.dtype)
        du = dy_eff.float().sum(dim=2).to(ctx.dtypes[1])
        dv = scatter_add(idx, dy_eff.float().contiguous(), y.shape[1])
        return None, dv.to(ctx.dtypes[0]), du, None


def knn_edge_gather_pre(idx: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
                        k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (y1, mom) of :func:`knn_edge_pre` in v and u."""
    return KnnEdgeGatherPre.apply(idx, v, u, k)
