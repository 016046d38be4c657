"""Layers: shared-MLP conv, batch norm, EdgeConv first conv, dropout, and
the fused EdgeConv blocks. Counterpart of
weaksuppointcloudseg_tpu/models/layers.py.

Parameters keep the JAX package's names and layouts (``w`` [in, out],
``b``, ``gamma``, ``beta``; BN state ``mean``, ``var``) so a JAX
checkpoint maps onto them leaf for leaf (utils/checkpoint.py).

bf16 rounding happens where the reference rounds (ROADMAP C6): a conv's
product accumulates in f32, the bias is added in f32, then the result is
rounded; BN is computed in f32 from the rounded value, then rounded.
``torch.matmul`` on bf16 tensors would round before the bias, so every
product here runs on f32 upcasts of the (exact) bf16 values.

The plain composition trains and evaluates: batch-moment BN, the first
EdgeConv conv as an ``autograd.Function`` with the reference's factored
backward, and dropout. The fused blocks (bf16) evaluate over kernels B1,
B7, B8 and train as ``autograd.Function``s over B1-B5 (the reference's
``custom_vjp``s ``_edge_conv_stage_train``, ``_edge_conv_stage1_train`` and
``_conv_bn_nmax_train``). The first conv of a stage of three or more
convs evaluates over B1 and trains as :class:`_EdgeConvBnReluTrain` (the
reference's ``_edge_conv_bn_relu_train``: B1, backward B13). With
``reuse_idx``
(static-graph mode) an
EdgeConv stage takes its neighbours from a given graph through kernel B11
instead of selecting them with B1; everything downstream, the backward
included, is the selecting stage's (the reference's
``_edge_conv_stage_pre_train`` / ``_edge_conv_stage1_pre_train``). BN
state lives in each conv's ``mean``/``var`` buffers; a training forward
updates them in place. The reference's ``axis_name`` (BN moments summed
across data-parallel replicas) is absent: data parallelism is not ported
yet (ROADMAP queue A, "Data parallelism").
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from weaksuppointcloudseg_tpu_torch.ops.conv_kmax import (
    conv_kmax_bwd,
    conv_minmax,
    conv_nmax,
    conv_nmax_bwd,
    conv_zmax,
    conv_znmax,
)
from weaksuppointcloudseg_tpu_torch.ops.edgeconv import knn_edge, knn_edge_pre
from weaksuppointcloudseg_tpu_torch.ops.scatter import scatter_add, scatter_bn_bwd

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


def batch_moments(y32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pass biased batch moments over all axes but the last of f32
    ``y32``: (mean, var clamped at 0)."""
    axes = tuple(range(y32.ndim - 1))
    mean = y32.mean(dim=axes)
    return mean, torch.clamp_min(y32.square().mean(dim=axes) - mean.square(),
                                 0.0)


def batch_norm(y: torch.Tensor, p: Conv, eps: float, *, training: bool = False,
               decay=None) -> torch.Tensor:
    """BN over all axes but the last, in f32, rounded to y's dtype
    (layers.py:87-118). Eval: population stats. Training: one-pass biased
    batch moments, the variance clamped at 0, and the population stats
    updated in place as ``pop * decay + batch * (1 - decay)``."""
    if training:
        mean, var = batch_moments(y.float())
        _update_bn(p, mean, var, decay)
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


def minmax_select(ymax, amax, ymin, amin, s):
    """The k-extremum (and its slot or row) that realizes
    ``max (s*y + t)`` per channel: the max where s >= 0, else the min."""
    pos = s >= 0
    return torch.where(pos, ymax, ymin), torch.where(pos, amax, amin)


def uv_factor(w1: torch.Tensor, b1: torch.Tensor, f: torch.Tensor):
    """First-conv factorization ``u = f (W_top - W_bot) + b``,
    ``v = f W_bot``, each rounded to f's dtype (the bias is added first)."""
    c = f.shape[-1]
    w = w1.to(f.dtype)
    w_top, w_bot = w[:c], w[c:]
    u = (torch.matmul(f.float(), (w_top - w_bot).float()) + b1).to(f.dtype)
    v = torch.matmul(f.float(), w_bot.float()).to(f.dtype)
    return u.contiguous(), v.contiguous()


def _uv_grads(w1, f, du, dv):
    """(df, dw1, db1) through the u/v factorization from the f32 cotangents
    du (of u) and dv (of v), as the reference's ``_uv_grads``
    (layers.py:923-940): the cotangents and weights in f's dtype, products
    in f32."""
    c = f.shape[-1]
    w = w1.to(f.dtype)
    w_top, w_bot = w[:c], w[c:]
    du_c = du.to(f.dtype).float()
    dv_c = dv.to(f.dtype).float()
    df = (torch.matmul(du_c, (w_top - w_bot).float().t())
          + torch.matmul(dv_c, w_bot.float().t())).to(f.dtype)
    dw_a = torch.einsum("bnc,bno->co", f.float(), du_c)
    dw_b = torch.einsum("bnc,bno->co", f.float(), dv_c)
    return df, torch.cat([dw_a, dw_b - dw_a], dim=0), du.sum(dim=(0, 1))


def _stage_consts(mom, r: int, gamma, beta, eps: float):
    """Batch BN from in-kernel moments (layers.py:600-605): (mean, var, s,
    t, inv) with the biased variance clamped at 0 and ``z = s*y + t``."""
    mean = mom[0] / r
    var = torch.clamp_min(mom[1] / r - mean.square(), 0.0)
    inv = torch.rsqrt(var + eps)
    s = inv * gamma
    return mean, var, s, beta - mean * s, inv


def _bn_bwd_from_extrema(dout, ysel, mean, inv, gamma, beta, r: int):
    """BN backward evaluated on the selected extrema (layers.py:453-486):
    with dz supported on the selected positions only, the BN backward is
    ``q * 1[selected] + A + Bv * y``. Returns (q, A, Bv, a1, a2, db) with
    a1 = dbeta, a2 = dgamma and db = sum(dy), the conv bias's gradient."""
    s = inv * gamma
    ysel32 = ysel.float()
    z = ysel32 * s + (beta - mean * s)
    dz = dout * (z > 0)
    xhat = (ysel32 - mean) * inv
    axes = tuple(range(dz.ndim - 1))
    a1 = dz.sum(dim=axes)
    a2 = (dz * xhat).sum(dim=axes)
    q = s * dz
    big_a = (-s * a1 + s * inv * a2 * mean) / r
    big_b = -s * inv * a2 / r
    db = q.sum(dim=axes) + r * big_a + big_b * (r * mean)
    return q, big_a, big_b, a1, a2, db


def _update_bn(p: Conv, mean, var, decay) -> None:
    """The population update pop*decay + batch*(1-decay), in place."""
    with torch.no_grad():
        p.mean.copy_(p.mean * decay + mean * (1.0 - decay))
        p.var.copy_(p.var * decay + var * (1.0 - decay))


class _EdgeConvStageTrain(torch.autograd.Function):
    """A whole two-conv EdgeConv stage in training (layers.py:608-762):
    kNN + conv1 (B1 emits the raw y1 and BN1's moments), BN1 + relu +
    conv2 folded into B2 (k-extrema + BN2's moments), BN2 + relu + k-max
    on the selected extrema. Only y1 reaches memory.

    Backward: BN2's backward from the extrema, then one pass of B3 over y1
    (h1 recomputed; dz1, conv2's Gram sums and BN1's reductions), and B4
    folds BN1's backward into the scatter of the first conv's factored
    cotangents. Gradients as the reference returns them: dgamma = a2,
    dbeta = a1; ``g_src`` gets none.

    Outputs (out [B,N,C2], mean1, var1, mean2, var2); the moments feed the
    BN buffer updates only. With ``want_graph`` B1 also emits the selected
    squared distances, and the stage's kNN graph (idx int32 [B,N,k], sqd
    f32 [B,N,k], nearest first, gradient-free) follows the moments. With
    ``reuse_idx`` (static-graph mode, the reference's
    ``_edge_conv_stage_pre_train``) B11 gathers along that graph in place
    of B1 and ``g_src`` is unused; the backward is the same."""

    @staticmethod
    def forward(ctx, f, w1, b1, gamma1, beta1, w2, b2, gamma2, beta2, g_src,
                k, eps, fast, want_graph=False, reuse_idx=None):
        u, v = uv_factor(w1, b1, f)
        if reuse_idx is None:
            idx, y1, mom1, *sqd = knn_edge(g_src.detach().contiguous(), v, u,
                                           k, fast=fast, with_values=want_graph)
        else:
            idx = reuse_idx
            y1, mom1 = knn_edge_pre(idx, v, u, k)
        r = y1.shape[0] * y1.shape[1] * y1.shape[2]
        mean1, var1, s1, t1, inv1 = _stage_consts(mom1, r, gamma1, beta1, eps)
        ymax, amax, ymin, amin, mom2 = conv_minmax(
            y1, w2.to(f.dtype), b2, s1, t1)
        mean2, var2, s2, t2, inv2 = _stage_consts(mom2, r, gamma2, beta2, eps)
        ysel, asel = minmax_select(ymax, amax, ymin, amin, s2)
        out = torch.relu(ysel.float() * s2 + t2).to(f.dtype)
        ctx.save_for_backward(idx, y1, ysel, asel, mean1, inv1, mean2, inv2,
                              w1, b1, gamma1, beta1, w2, b2, gamma2, beta2, f)
        graph = (idx, sqd[0]) if want_graph else ()
        ctx.mark_non_differentiable(mean1, var1, mean2, var2, *graph)
        return (out, mean1, var1, mean2, var2, *graph)

    @staticmethod
    def backward(ctx, dout, *_):
        (idx, y1, ysel, asel, mean1, inv1, mean2, inv2, w1, b1, gamma1,
         beta1, w2, b2, gamma2, beta2, f) = ctx.saved_tensors
        b_, n_, k_, _ = y1.shape
        r = b_ * n_ * k_
        q, big_a, big_b, a1, a2, db2 = _bn_bwd_from_extrema(
            dout.float(), ysel, mean2, inv2, gamma2, beta2, r)
        w232 = w2.float()
        m = (w232 * big_b[None, :]) @ w232.t()
        row0 = (big_a + b2 * big_b) @ w232.t()
        s1 = inv1 * gamma1
        t1 = beta1 - mean1 * s1
        dz1, t_sp, gram, s1sum, ab = conv_kmax_bwd(
            y1, q.contiguous(), asel.contiguous(),
            w232.t().to(y1.dtype).contiguous(), m.to(y1.dtype), row0, s1, t1,
            mean1, inv1)
        dw2 = (t_sp + s1sum[:, None] * big_a[None, :]
               + (gram @ w232 + s1sum[:, None] * b2[None, :]) * big_b[None, :])
        a1p, a2p = ab[0], ab[1]
        alpha1 = s1 * (-a1p / r + (a2p / r) * inv1 * mean1)
        beta1v = -s1 * (a2p / r) * inv1
        dv, du = scatter_bn_bwd(idx, y1, dz1, s1, alpha1, beta1v, n_)
        df, dw1, db1 = _uv_grads(w1, f, du, dv)
        return (df if ctx.needs_input_grad[0] else None, dw1, db1, a2p, a1p,
                dw2, db2, a2, a1, None, None, None, None, None, None)


class _EdgeConvStage1Train(torch.autograd.Function):
    """The single-conv EdgeConv stage in training (layers.py:943-1018): B1
    emits y1, BN's moments and the k-extrema of y1 with their slots;
    BN + relu + k-max act on the selected extrema. Backward: BN's backward
    from the extrema, then B4 in its sparse mode (the routed gradient at
    the selected slot plus BN's dense correction) scatters the factored
    cotangents. Outputs (out, mean, var). With ``reuse_idx`` B11 (with its
    extrema) gathers along that graph in place of B1 (the reference's
    ``_edge_conv_stage1_pre_train``); the backward is the same."""

    @staticmethod
    def forward(ctx, f, w1, b1, gamma1, beta1, g_src, k, eps, fast,
                reuse_idx=None):
        u, v = uv_factor(w1, b1, f)
        if reuse_idx is None:
            idx, y1, mom, ymax, amax, ymin, amin = knn_edge(
                g_src.detach().contiguous(), v, u, k, fast=fast,
                with_minmax=True)
        else:
            idx = reuse_idx
            y1, mom, ymax, amax, ymin, amin = knn_edge_pre(
                idx, v, u, k, with_minmax=True)
        r = y1.shape[0] * y1.shape[1] * y1.shape[2]
        mean, var, s, t, inv = _stage_consts(mom, r, gamma1, beta1, eps)
        ysel, asel = minmax_select(ymax, amax, ymin, amin, s)
        out = torch.relu(ysel.float() * s + t).to(f.dtype)
        ctx.save_for_backward(idx, y1, ysel, asel, mean, inv, w1, gamma1,
                              beta1, f)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, *_):
        idx, y1, ysel, asel, mean, inv, w1, gamma1, beta1, f = ctx.saved_tensors
        b_, n_, k_, _ = y1.shape
        q, alpha, beta_v, a1, a2, _ = _bn_bwd_from_extrema(
            dout.float(), ysel, mean, inv, gamma1, beta1, b_ * n_ * k_)
        # sv (the dz scale of the dense mode) is unused: q carries it
        dv, du = scatter_bn_bwd(idx, y1, (q.contiguous(), asel.contiguous()),
                                None, alpha, beta_v, n_)
        df, dw1, db1 = _uv_grads(w1, f, du, dv)
        return (df if ctx.needs_input_grad[0] else None, dw1, db1, a2, a1,
                None, None, None, None, None)


class _ConvBnNmaxTrain(torch.autograd.Function):
    """Global-aggregation conv + BN + relu + max over N in training
    (layers.py:1161-1234): B5 reduces y = bf16(h @ W + b) to its extrema
    over the points with their rows and BN's moments; B5's backward
    recomputes y and forms dh, dW and db from the routed gradient and BN's
    dense correction. Outputs (out [B, C2], mean, var)."""

    @staticmethod
    def forward(ctx, h, w, b, gamma, beta, eps):
        ymax, amax, ymin, amin, mom = conv_nmax(h, w.to(h.dtype), b)
        r = h.shape[0] * h.shape[1]
        mean, var, s, t, inv = _stage_consts(mom, r, gamma, beta, eps)
        ysel, asel = minmax_select(ymax, amax, ymin, amin, s)
        out = torch.relu(ysel * s + t).to(h.dtype)
        ctx.save_for_backward(h, ysel, asel, mean, inv, w, b, gamma, beta)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, *_):
        h, ysel, asel, mean, inv, w, b, gamma, beta = ctx.saved_tensors
        # db comes from the kernel (the numeric sum of dy)
        q, alpha, beta_v, a1, a2, _ = _bn_bwd_from_extrema(
            dout.float(), ysel, mean, inv, gamma, beta, h.shape[0] * h.shape[1])
        dh, dw, db = conv_nmax_bwd(h, q.contiguous(), asel.contiguous(),
                                   w.to(h.dtype), b, alpha, beta_v)
        return dh, dw, db, a2, a1, None


class _EdgeConvBnReluTrain(torch.autograd.Function):
    """The first conv of a fused EdgeConv stage of three or more convs in
    training, + BN + ReLU (layers.py:260-352): B1 emits y1 and BN's
    moments. Backward by hand: the standard BN backward from the saved y1
    (dz = dh 1[h > 0]; dy = inv gamma (dz - mean(dz) - xhat mean(dz
    xhat)), rounded to y1's dtype), then the factored conv's ``du = sum_k
    dy`` and ``dv = scatter(idx, dy)`` (kernel B13) into
    :func:`_uv_grads`. Gradients as the reference returns them: dgamma =
    a2, dbeta = a1; ``g_src`` gets none. Outputs (h [B,N,k,C], mean, var);
    the moments feed the BN buffer update only."""

    @staticmethod
    def forward(ctx, f, w, b, gamma, beta, g_src, k, eps, fast):
        u, v = uv_factor(w, b, f)
        idx, y, mom = knn_edge(g_src.detach().contiguous(), v, u, k,
                               fast=fast)
        r = y.shape[0] * y.shape[1] * y.shape[2]
        mean, var, _, _, inv = _stage_consts(mom, r, gamma, beta, eps)
        z = (y.float() - mean) * (inv * gamma) + beta
        h = torch.relu(z).to(y.dtype)
        ctx.save_for_backward(idx, y, h, mean, inv, w, gamma, f)
        ctx.mark_non_differentiable(mean, var)
        return h, mean, var

    @staticmethod
    def backward(ctx, dh, *_):
        idx, y, h, mean, inv, w, gamma, f = ctx.saved_tensors
        r = y.shape[0] * y.shape[1] * y.shape[2]
        xhat = (y.float() - mean) * inv
        dz = dh.float() * (h > 0)
        a1 = dz.sum(dim=(0, 1, 2))
        a2 = (dz * xhat).sum(dim=(0, 1, 2))
        dy = ((inv * gamma) * (dz - a1 / r - xhat * (a2 / r))).to(y.dtype)
        du = dy.float().sum(dim=2)
        dv = scatter_add(idx, dy.float().contiguous(), f.shape[1])
        df, dw, db = _uv_grads(w, f, du, dv)
        return (df if ctx.needs_input_grad[0] else None, dw, db, a2, a1,
                None, None, None, None)


def apply_edge_conv_knn_fused(p: Conv, f: torch.Tensor, g_src: torch.Tensor,
                              k: int, *, eps: float = BN_EPS,
                              fast: bool = False, training: bool = False,
                              decay=None) -> torch.Tensor:
    """The first conv of a fused EdgeConv stage of three or more convs:
    kNN on ``g_src`` + conv(concat([f_i, f_j - f_i])) + BN + ReLU, the
    conv factored as ``u_i + v_j`` inside kernel B1 (layers.py:355-397).
    Eval: B1's y1 (the forward of the reference's B16, ``knn_edge_gather``),
    then population BN + ReLU. Training: :class:`_EdgeConvBnReluTrain`, BN's population
    stats updated in place. f, g_src: bf16 -> h [B, N, k, C] bf16."""
    if training:
        h, mean, var = _EdgeConvBnReluTrain.apply(
            f, p.w, p.b, p.gamma, p.beta, g_src, k, eps, fast)
        _update_bn(p, mean, var, decay)
        return h
    u, v = uv_factor(p.w, p.b, f)
    y = knn_edge(g_src.contiguous(), v, u, k, fast=fast)[1]
    inv = torch.rsqrt(p.var + eps) * p.gamma
    return torch.relu((y.float() - p.mean) * inv + p.beta).to(y.dtype)


def apply_edge_conv_stage_fused(p1: Conv, p2: Conv, f: torch.Tensor,
                                g_src: Optional[torch.Tensor], k: int, *,
                                eps: float = BN_EPS, fast: bool = False,
                                n_valid: Optional[int] = None,
                                training: bool = False, decay=None,
                                want_graph: bool = False,
                                reuse_idx: Optional[torch.Tensor] = None):
    """Whole two-conv EdgeConv stage (layers.py:817-907). Eval: kNN +
    conv1 (B1) and BN1 + relu + conv2 + BN2 + relu + k-max (B7). Training:
    :class:`_EdgeConvStageTrain` (B1, B2; backward B3, B4), with both BN
    layers' population stats updated in place. f, g_src: bf16.

    ``want_graph``: return ``(out, (idx, sqd))``, the stage's
    gradient-free kNN graph on ``g_src`` beside its output, for the
    smoothness loss or later static-graph stages to reuse (at eval with
    ``n_valid``: only rows < n_valid are candidates). ``reuse_idx``
    (static-graph mode): take the neighbours from this int32 [B, N, k]
    graph through B11 instead of selecting them (``g_src`` unused; at
    eval rows >= n_valid are zeroed as B1 zeroes them)."""
    if want_graph and reuse_idx is not None:
        raise ValueError("a reusing stage has no graph to emit")
    if training:
        if n_valid is not None:
            raise ValueError("n_valid is an eval-only option")
        out, mean1, var1, mean2, var2, *graph = _EdgeConvStageTrain.apply(
            f, p1.w, p1.b, p1.gamma, p1.beta, p2.w, p2.b, p2.gamma, p2.beta,
            g_src, k, eps, fast, want_graph, reuse_idx)
        _update_bn(p1, mean1, var1, decay)
        _update_bn(p2, mean2, var2, decay)
        return (out, tuple(graph)) if want_graph else out
    u, v = uv_factor(p1.w, p1.b, f)
    graph = None
    if reuse_idx is not None:
        y1, _ = knn_edge_pre(reuse_idx, v, u, k, n_valid=n_valid)
    else:
        idx, y1, _, *sqd = knn_edge(g_src.contiguous(), v, u, k, fast=fast,
                                    with_values=want_graph, n_valid=n_valid)
        graph = (idx, sqd[0]) if want_graph else None
    s1, t1 = bn_affine(p1, eps)
    s2, t2 = bn_affine(p2, eps)
    out = conv_zmax(y1, p2.w.to(f.dtype), p2.b, s2, t2, s1, t1)
    return (out, graph) if want_graph else out


def apply_edge_conv_stage1_fused(p: Conv, f: torch.Tensor,
                                 g_src: Optional[torch.Tensor], k: int, *,
                                 eps: float = BN_EPS, fast: bool = False,
                                 n_valid: Optional[int] = None,
                                 training: bool = False, decay=None,
                                 reuse_idx: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Single-conv EdgeConv stage (layers.py:1069-1123): B1 emits the
    per-channel k-extrema of the conv output; BN's sign picks max or min.
    Training: :class:`_EdgeConvStage1Train` (backward B4, sparse mode).
    ``reuse_idx`` (static-graph mode): B11 emits the extrema along that
    graph instead (``g_src`` unused)."""
    if training:
        if n_valid is not None:
            raise ValueError("n_valid is an eval-only option")
        out, mean, var = _EdgeConvStage1Train.apply(
            f, p.w, p.b, p.gamma, p.beta, g_src, k, eps, fast, reuse_idx)
        _update_bn(p, mean, var, decay)
        return out
    u, v = uv_factor(p.w, p.b, f)
    if reuse_idx is not None:
        _, _, ymax, amax, ymin, amin = knn_edge_pre(
            reuse_idx, v, u, k, with_minmax=True, n_valid=n_valid)
    else:
        _, _, _, ymax, amax, ymin, amin = knn_edge(
            g_src.contiguous(), v, u, k, fast=fast, with_minmax=True,
            n_valid=n_valid)
    s, t = bn_affine(p, eps)
    z = minmax_select(ymax, amax, ymin, amin, s)[0].float() * s + t
    return torch.relu(z).to(f.dtype)


def apply_conv_bn_relu_nmax(p: Conv, h: torch.Tensor, *, eps: float = BN_EPS,
                            n_valid: Optional[int] = None,
                            training: bool = False, decay=None) -> torch.Tensor:
    """Global-aggregation conv + BN + relu + max over N (layers.py:
    1237-1273): B8 at eval, :class:`_ConvBnNmaxTrain` (B5) in training.
    h: [B, N, C1] bf16 -> [B, C2] in h's dtype."""
    if training:
        if n_valid is not None:
            raise ValueError("n_valid is an eval-only option")
        out, mean, var = _ConvBnNmaxTrain.apply(h.contiguous(), p.w, p.b,
                                                p.gamma, p.beta, eps)
        _update_bn(p, mean, var, decay)
        return out
    s, t = bn_affine(p, eps)
    out = conv_znmax(h.contiguous(), p.w.to(h.dtype), p.b, s, t,
                     n_valid=n_valid)
    return out.to(h.dtype)
