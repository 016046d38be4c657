"""Weak-supervision losses. Counterpart of weaksuppointcloudseg_tpu/losses/
weaksup.py (reference: ShapeNet/ShapeNet_DGCNN_trainer.py:88-133 and
Util/SmoothConstraint.py:130-167):

- masked (incomplete-label) softmax cross-entropy, sum(mask*CE)/sum(mask);
- Siamese consistency between interleaved pairs;
- inexact (MIL) category supervision, sigmoid CE on per-class max logits;
- kNN-Laplacian smoothness of the softmax output.

The smoothness loss has the reference's two branches. The plain one
(weaksup.py:186-210): kNN with distances by kernel B12 (its plain version
on CPU tensors), ``w = exp(-max(sqd, 0) / gamma)``, and a plain gather of
the probabilities whose backward is PyTorch's own scatter, as the
reference keeps XLA's there. The fused one (weaksup.py:152-185), which the
bf16 fused model trains with on the card: the loss from exp-weighted
neighbour sums of bf16 ``[P, |P|^2]`` (kernel B6's gather on a reused
graph, or kernel B9's kNN + gather), whose backward is kernel B6's scatter
(ops/wgather.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from weaksuppointcloudseg_tpu_torch.ops import wgather
from weaksuppointcloudseg_tpu_torch.ops.knn import knn


def masked_softmax_ce(logits: torch.Tensor, labels_onehot: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """sum(mask * CE) / sum(mask), CE over the last axis; a batch with no
    labelled point gives 0, not NaN."""
    log_p = torch.log_softmax(logits, dim=-1)
    ce = -torch.sum(labels_onehot.to(log_p.dtype) * log_p, dim=-1)
    return torch.sum(mask * ce) / torch.clamp_min(torch.sum(mask), 1e-12)


def siamese_consistency(prob: torch.Tensor) -> torch.Tensor:
    """mean over pairs and points of sum_K (P[0::2] - P[1::2])^2."""
    d = prob[0::2] - prob[1::2]
    return torch.mean(torch.sum(d.square(), dim=-1))


def mil_inexact(logits: torch.Tensor, labels_onehot: torch.Tensor) -> torch.Tensor:
    """Sigmoid CE between per-class max logits and the classes present."""
    x = torch.amax(logits, dim=1)
    z = torch.amax(labels_onehot.float(), dim=1)
    loss = torch.clamp_min(x, 0.0) - x * z + torch.log1p(torch.exp(-x.abs()))
    return torch.mean(loss)


def smooth_knn_laplacian(prob: torch.Tensor, x: torch.Tensor, *,
                         gamma: float = 1e-1, k: int = 10,
                         channels: Optional[Tuple[int, int]] = None,
                         fast: bool = False) -> torch.Tensor:
    """mean_{b,n,j} exp(-d_nj / gamma) * mean_K (P_n - P_nbr(j))^2 over the
    k nearest neighbors (self included) on ``x``'s channels. The graph
    and weights depend on the input only, so no gradient reaches them."""
    if channels is not None:
        x = x[..., channels[0]:channels[1]]
    idx, sqd = knn(x.detach().float().contiguous(), k, fast=fast,
                   with_values=True)
    w = torch.exp(-torch.clamp_min(sqd, 0.0) / gamma)
    b = torch.arange(prob.shape[0], device=prob.device)[:, None, None]
    p_nbr = prob[b, idx.long()]  # [B, N, k, K]
    diff2 = torch.mean(torch.square(prob[:, :, None, :] - p_nbr), dim=-1)
    return torch.mean(w * diff2)


def smooth_knn_laplacian_fused(
        prob: torch.Tensor, x: torch.Tensor, *, gamma: float = 1e-1,
        k: int = 10, channels: Optional[Tuple[int, int]] = None,
        fast: bool = False,
        graph: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
) -> torch.Tensor:
    """The smoothness loss from weighted neighbour sums, without the [B, N,
    k, K] neighbour tensor (weaksup.py:152-185):

        sum_j w_j |P_n - P_j|^2 = (sum_j w_j)|P_n|^2 - 2 P_n.s1_n + s2_n,
        s1_n = sum_j w_j P_j,   s2_n = sum_j w_j |P_j|^2,

    with s = [s1, s2] the weighted sum of f = bf16([P, |P|^2]) (|P|^2
    summed in f32 first). ``graph`` (idx [B, N, k'], sqd [B, N, k'],
    nearest first, k' >= k): reuse its k-nearest prefix, w = exp(-max(sqd,
    0) / gamma), and gather with kernel B6; else kNN + weights + gather in
    one pass of kernel B9 on ``x``'s channels (f32). Per-point values are
    clamped at 0 (bf16 rounding could make them negative); the mean is
    divided by k * K. Gradients reach ``prob`` directly and through f (B6's
    scatter); the graph, the weights and ``x`` get none. On CPU tensors the
    kernels' plain versions run."""
    n_cls = prob.shape[-1]
    q = torch.sum(prob.square(), dim=-1)
    f = torch.cat([prob, q[..., None]], dim=-1).to(torch.bfloat16)
    if graph is not None:
        if graph[0].shape[-1] < k:
            raise ValueError(
                f"precomputed graph has k'={graph[0].shape[-1]} neighbors but "
                f"the loss needs k={k}; the k-nearest prefix reuse requires "
                "k' >= k")
        idx = graph[0].detach()[..., :k]
        w = torch.exp(-torch.clamp_min(graph[1].detach()[..., :k], 0.0) / gamma)
        s = wgather.weighted_gather_pre(idx, w, f)
    else:
        if channels is not None:
            x = x[..., channels[0]:channels[1]]
        _, s, w = wgather.knn_weighted_gather(x, f, k, gamma, fast=fast)
    s1, s2 = s[..., :n_cls], s[..., n_cls]
    per_point = w.sum(dim=-1) * q - 2.0 * torch.sum(prob * s1, dim=-1) + s2
    return torch.mean(torch.clamp_min(per_point, 0.0)) / (k * n_cls)


def total_weaksup_loss(logits: torch.Tensor, labels_onehot: torch.Tensor,
                       mask: torch.Tensor, x: torch.Tensor, *, gate,
                       siamese_weight: float = 1.0, smooth_gamma: float = 1e-1,
                       smooth_knn: int = 10,
                       smooth_channels: Optional[Tuple[int, int]] = None,
                       smooth_fast: bool = False,
                       smooth_fused_bf16: bool = False,
                       smooth_graph: Optional[Tuple[torch.Tensor,
                                                    torch.Tensor]] = None,
                       compat_frozen_gate: bool = False
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-style loss seg + gate * (siamese + inexact + smooth), the gate a
    runtime 0/1 scalar (0 throughout with ``compat_frozen_gate``, the
    released code's frozen constant). ``smooth_fused_bf16`` selects
    :func:`smooth_knn_laplacian_fused`, which reuses ``smooth_graph`` where
    one is given. Returns (total, components)."""
    prob = torch.softmax(logits, dim=-1)
    loss_seg = masked_softmax_ce(logits, labels_onehot, mask)
    loss_siam = siamese_weight * siamese_consistency(prob)
    loss_mil = mil_inexact(logits, labels_onehot)
    smooth_kw = dict(gamma=smooth_gamma, k=smooth_knn,
                     channels=smooth_channels, fast=smooth_fast)
    if smooth_fused_bf16:
        loss_smooth = smooth_knn_laplacian_fused(prob, x, graph=smooth_graph,
                                                 **smooth_kw)
    elif smooth_graph is not None:
        raise ValueError("smooth_graph is an option of the fused smoothness "
                         "loss (smooth_fused_bf16)")
    else:
        loss_smooth = smooth_knn_laplacian(prob, x, **smooth_kw)
    if compat_frozen_gate:
        gate = 0.0
    total = loss_seg + gate * (loss_siam + loss_mil + loss_smooth)
    return total, {"seg": loss_seg, "siamese": loss_siam,
                   "inexact": loss_mil, "smooth": loss_smooth}
