"""Layers: shared-MLP conv, batch norm, EdgeConv first conv, dropout, and
the fused eval EdgeConv blocks. Counterpart of
weaksuppointcloudseg_tpu/models/layers.py.

Parameters keep the JAX package's names and layouts (``w`` [in, out],
``b``, ``gamma``, ``beta``; BN state ``mean``, ``var``) so a JAX
checkpoint maps onto them leaf for leaf (utils/checkpoint.py).

bf16 rounding happens where the reference rounds (ROADMAP C6): a conv's
product accumulates in f32, the bias is added in f32, then the result is
rounded; BN is computed in f32 from the rounded value, then rounded.
``torch.matmul`` on bf16 tensors would round before the bias, so every
product here runs on f32 upcasts of the (exact) bf16 values.

Training runs the plain composition: batch-moment BN, the first EdgeConv
conv as an ``autograd.Function`` with the reference's factored backward,
and dropout. The fused blocks are eval only; their training kernels (B2-B6)
are still to port (ROADMAP queue A). BN state lives in each conv's
``mean``/``var`` buffers; a training forward updates them in place.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from weaksuppointcloudseg_tpu_torch.ops.conv_kmax import conv_zmax, conv_znmax
from weaksuppointcloudseg_tpu_torch.ops.edgeconv import knn_edge

BN_EPS = 1e-3


class Conv(nn.Module):
    """One shared-MLP conv layer: ``w`` [in_c, out_c], ``b`` [out_c] and,
    with ``bn``, ``gamma``/``beta`` plus the population stats
    ``mean``/``var`` (buffers)."""

    def __init__(self, in_c: int, out_c: int, *, bn: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # Glorot-uniform, as tf.contrib.layers.xavier_initializer for a
        # [1, 1, in, out] kernel (layers.py::xavier_uniform)
        limit = math.sqrt(6.0 / (in_c + out_c))
        w = torch.rand((in_c, out_c), generator=generator) * (2 * limit) - limit
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(out_c))
        self.bn = bn
        if bn:
            self.gamma = nn.Parameter(torch.ones(out_c))
            self.beta = nn.Parameter(torch.zeros(out_c))
            self.register_buffer("mean", torch.zeros(out_c))
            self.register_buffer("var", torch.ones(out_c))


def batch_norm(y: torch.Tensor, p: Conv, eps: float, *, training: bool = False,
               decay=None) -> torch.Tensor:
    """BN over all axes but the last, in f32, rounded to y's dtype
    (layers.py:87-118). Eval: population stats. Training: one-pass biased
    batch moments, the variance clamped at 0, and the population stats
    updated in place as ``pop * decay + batch * (1 - decay)``."""
    if training:
        y32 = y.float()
        axes = tuple(range(y.ndim - 1))
        mean = y32.mean(dim=axes)
        var = torch.clamp_min(y32.square().mean(dim=axes) - mean.square(), 0.0)
        with torch.no_grad():
            p.mean.copy_(p.mean * decay + mean * (1.0 - decay))
            p.var.copy_(p.var * decay + var * (1.0 - decay))
    else:
        mean, var = p.mean, p.var
    inv = torch.rsqrt(var + eps) * p.gamma
    return ((y.float() - mean) * inv + p.beta).to(y.dtype)


def apply_conv(p: Conv, x: torch.Tensor, *, eps: float = BN_EPS,
               relu: bool = True, training: bool = False,
               decay=None) -> torch.Tensor:
    """conv (channel matmul) + bias [+ BN if the layer has it] [+ ReLU]."""
    y = torch.matmul(x.float(), p.w.to(x.dtype).float()) + p.b
    y = y.to(x.dtype)
    if p.bn:
        y = batch_norm(y, p, eps, training=training, decay=decay)
    return torch.relu(y) if relu else y


def apply_conv_bcast(p: Conv, x_bcast: torch.Tensor, x_point: torch.Tensor,
                     *, eps: float = BN_EPS, training: bool = False,
                     decay=None) -> torch.Tensor:
    """conv over concat([broadcast_N(x_bcast), x_point]) without the
    concat: ``broadcast_N(g @ W[:Cg]) + p @ W[Cg:]`` (+ BN + ReLU).

    x_bcast: [B, Cg] per-sample features; x_point: [B, N, Cp].
    """
    cg = x_bcast.shape[-1]
    yg = x_bcast.float() @ p.w[:cg].to(x_bcast.dtype).float()
    yp = torch.matmul(x_point.float(), p.w[cg:].to(x_point.dtype).float())
    y = (yg[:, None, :] + yp + p.b).to(x_point.dtype)
    return torch.relu(batch_norm(y, p, eps, training=training, decay=decay))


class _EdgeConvMatmul(torch.autograd.Function):
    """conv(concat([f_i, f_j - f_i])) + bias (layers.py:188-238).

    The forward is the concat and the matmul. The backward is the same
    linear map's transpose, factored so that nothing 2C wide exists:
        d_f = (sum_k dy) @ (W_top - W_bot)^T,  d_nbr = dy @ W_bot^T,
        dW_top = f^T @ (sum_k dy),  dW_bot = nbr^T @ dy - dW_top.
    """

    @staticmethod
    def forward(ctx, f, nbr, w, b):
        ctx.save_for_backward(f, nbr, w)
        central = f[:, :, None, :].expand_as(nbr)
        ef = torch.cat([central, nbr - central], dim=-1)
        y = torch.matmul(ef.float(), w.to(ef.dtype).float()) + b
        return y.to(f.dtype)

    @staticmethod
    def backward(ctx, dy):
        f, nbr, w = ctx.saved_tensors
        c = f.shape[-1]
        wc = w.to(f.dtype)
        w_top, w_bot = wc[:c], wc[c:]
        dy32 = dy.float()
        # k-reduce first, in f32
        dy_sum = dy32.sum(dim=2)
        d_f = torch.matmul(dy_sum.to(dy.dtype).float(),
                           (w_top - w_bot).float().t()).to(f.dtype)
        d_nbr = torch.matmul(dy32, w_bot.float().t()).to(nbr.dtype)
        dw_top = torch.einsum("bnc,bno->co", f.float(),
                              dy_sum.to(f.dtype).float())
        dw_nbr = torch.einsum("bnkc,bnko->co", nbr.float(), dy32)
        dw = torch.cat([dw_top, dw_nbr - dw_top], dim=0)
        db = dy32.sum(dim=(0, 1, 2))
        return d_f, d_nbr, dw.to(w.dtype), db.to(w.dtype)


def edge_conv_matmul(f: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """First EdgeConv conv with the d_ef-free backward. f: [B, N, C],
    nbr: [B, N, k, C], w: [2C, Cout] -> [B, N, k, Cout] in f's dtype."""
    return _EdgeConvMatmul.apply(f, nbr, w, b)


def apply_edge_conv(p: Conv, f: torch.Tensor, nbr: torch.Tensor, *,
                    eps: float = BN_EPS, training: bool = False,
                    decay=None) -> torch.Tensor:
    """conv(concat([f_i, f_j - f_i])) + bias + BN + ReLU (plain path).

    f: [B, N, C] point features, nbr: [B, N, k, C] gathered neighbors.
    """
    y = edge_conv_matmul(f, nbr, p.w, p.b)
    return torch.relu(batch_norm(y, p, eps, training=training, decay=decay))


def dropout(x: torch.Tensor, keep_prob: Optional[float], *, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout as tf.nn.dropout(keep_prob) (layers.py:1276-1281),
    its mask drawn from ``generator`` (on x's device)."""
    if not training or keep_prob is None or keep_prob >= 1.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0).to(x.dtype)


def bn_affine(p: Conv, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Population BN as the per-channel affine ``z = s*y + t``."""
    s = torch.rsqrt(p.var + eps) * p.gamma
    return s, p.beta - p.mean * s


def minmax_select(ymax, ymin, s):
    """The k-extremum that realizes ``max_j (s*y_j + t)`` per channel."""
    return torch.where(s >= 0, ymax, ymin)


def uv_factor(p: Conv, f: torch.Tensor):
    """First-conv factorization ``u = f (W_top - W_bot) + b``,
    ``v = f W_bot``, each rounded to f's dtype (the bias is added first)."""
    c = f.shape[-1]
    w = p.w.to(f.dtype)
    w_top, w_bot = w[:c], w[c:]
    u = (torch.matmul(f.float(), (w_top - w_bot).float()) + p.b).to(f.dtype)
    v = torch.matmul(f.float(), w_bot.float()).to(f.dtype)
    return u.contiguous(), v.contiguous()


def apply_edge_conv_stage_fused(p1: Conv, p2: Conv, f: torch.Tensor,
                                g_src: torch.Tensor, k: int, *,
                                eps: float = BN_EPS, fast: bool = False,
                                n_valid: Optional[int] = None) -> torch.Tensor:
    """Whole two-conv EdgeConv stage at eval: kNN + conv1 (B1) and
    BN1 + relu + conv2 + BN2 + relu + k-max (B7). f, g_src: bf16."""
    u, v = uv_factor(p1, f)
    _, y1, _ = knn_edge(g_src.contiguous(), v, u, k, fast=fast,
                        n_valid=n_valid)
    s1, t1 = bn_affine(p1, eps)
    s2, t2 = bn_affine(p2, eps)
    return conv_zmax(y1, p2.w.to(f.dtype), p2.b, s2, t2, s1, t1)


def apply_edge_conv_stage1_fused(p: Conv, f: torch.Tensor,
                                 g_src: torch.Tensor, k: int, *,
                                 eps: float = BN_EPS, fast: bool = False,
                                 n_valid: Optional[int] = None) -> torch.Tensor:
    """Single-conv EdgeConv stage at eval: B1 emits the per-channel
    k-extrema of the conv output; BN's sign picks max or min."""
    u, v = uv_factor(p, f)
    _, _, _, ymax, _, ymin, _ = knn_edge(
        g_src.contiguous(), v, u, k, fast=fast, with_minmax=True,
        n_valid=n_valid)
    s, t = bn_affine(p, eps)
    z = minmax_select(ymax, ymin, s).float() * s + t
    return torch.relu(z).to(f.dtype)


def apply_conv_bn_relu_nmax(p: Conv, h: torch.Tensor, *, eps: float = BN_EPS,
                            n_valid: Optional[int] = None) -> torch.Tensor:
    """Global-aggregation conv + BN + relu + max over N at eval (B8).
    h: [B, N, C1] bf16 -> [B, C2] in h's dtype."""
    s, t = bn_affine(p, eps)
    out = conv_znmax(h.contiguous(), p.w.to(h.dtype), p.b, s, t,
                     n_valid=n_valid)
    return out.to(h.dtype)
