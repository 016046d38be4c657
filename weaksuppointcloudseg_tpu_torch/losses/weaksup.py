"""Weak-supervision losses. Counterpart of weaksuppointcloudseg_tpu/losses/
weaksup.py (reference: ShapeNet/ShapeNet_DGCNN_trainer.py:88-133 and
Util/SmoothConstraint.py:130-167):

- masked (incomplete-label) softmax cross-entropy, sum(mask*CE)/sum(mask);
- Siamese consistency between interleaved pairs;
- inexact (MIL) category supervision, sigmoid CE on per-class max logits;
- kNN-Laplacian smoothness of the softmax output.

The smoothness loss is the reference's non-fused branch (weaksup.py:
186-210): kNN with distances by kernel B12 (its plain version on CPU
tensors), ``w = exp(-max(sqd, 0) / gamma)``, and a plain gather of the
probabilities whose backward is PyTorch's own scatter, as the reference
keeps XLA's there. The fused bf16 branch (kernels B6) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

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


def total_weaksup_loss(logits: torch.Tensor, labels_onehot: torch.Tensor,
                       mask: torch.Tensor, x: torch.Tensor, *, gate,
                       siamese_weight: float = 1.0, smooth_gamma: float = 1e-1,
                       smooth_knn: int = 10,
                       smooth_channels: Optional[Tuple[int, int]] = None,
                       smooth_fast: bool = False,
                       compat_frozen_gate: bool = False
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-style loss seg + gate * (siamese + inexact + smooth), the gate a
    runtime 0/1 scalar (0 throughout with ``compat_frozen_gate``, the
    released code's frozen constant). Returns (total, components)."""
    prob = torch.softmax(logits, dim=-1)
    loss_seg = masked_softmax_ce(logits, labels_onehot, mask)
    loss_siam = siamese_weight * siamese_consistency(prob)
    loss_mil = mil_inexact(logits, labels_onehot)
    loss_smooth = smooth_knn_laplacian(prob, x, gamma=smooth_gamma,
                                       k=smooth_knn, channels=smooth_channels,
                                       fast=smooth_fast)
    if compat_frozen_gate:
        gate = 0.0
    total = loss_seg + gate * (loss_siam + loss_mil + loss_smooth)
    return total, {"seg": loss_seg, "siamese": loss_siam,
                   "inexact": loss_mil, "smooth": loss_smooth}
