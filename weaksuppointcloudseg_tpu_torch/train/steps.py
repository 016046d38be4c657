"""Train and eval steps. Counterpart of weaksuppointcloudseg_tpu/train/
steps.py (``_loss_fn``, ``_accuracy``, ``make_train_step``,
``make_eval_logits_fn``, ``make_eval_step``).

The reference jits one pure function per config; here the steps run
eagerly and update the model (parameters, BN buffers) and the optimizer in
place. Everything a step returns stays on the device: the caller fetches
the metrics once per epoch.

The reference pads N to a multiple of 512 before the fused TPU kernels
(steps.py:265-278) only because Mosaic needs aligned tiles. The CUDA
kernels take any N, so nothing is padded here; ``n_valid`` is still
honoured where a caller passes it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from weaksuppointcloudseg_tpu_torch.configs import ExperimentConfig
from weaksuppointcloudseg_tpu_torch.losses.weaksup import (
    masked_softmax_ce,
    total_weaksup_loss,
)
from weaksuppointcloudseg_tpu_torch.models import layers
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.ops.schedules import (
    bn_decay_schedule,
    learning_rate_schedule,
)
from weaksuppointcloudseg_tpu_torch.train.state import Adam


def fused_route(cfg: ExperimentConfig, device) -> bool:
    """True where training runs the fused blocks and the fused smoothness
    loss: models/layers.py::fused_route for ``cfg``'s model on ``device``."""
    m = cfg.model
    return layers.fused_route(getattr(torch, m.compute_dtype),
                              m.use_fused_knn, device)


def smooth_graph_reusable(cfg: ExperimentConfig, device) -> bool:
    """True when the Full-style smoothness loss can reuse the fused
    transform stage's kNN graph instead of running its own selection
    (steps.py:73-85): the fused route with a transform net whose graph lives
    on the coordinates the loss uses (no ``knn_channels`` or
    ``smooth_channels``: both span the raw xyz) and whose k covers the
    loss's k-nearest prefix."""
    m, w = cfg.model, cfg.weaksup
    return bool(fused_route(cfg, device) and m.use_transform_net
                and w.smooth_knn <= m.k and m.knn_channels is None
                and w.smooth_channels is None)


def loss_fn(model: DGCNNSeg, batch: Dict[str, torch.Tensor], *,
            cfg: ExperimentConfig, style: str, bn_decay, gate,
            generator: Optional[torch.Generator] = None):
    """Training forward + loss (steps.py:88-124). Returns (total,
    components incl. ``total``, logits); the model's BN buffers hold the
    new population stats afterwards. On the fused route the Full-style
    smoothness loss is the fused one, over the transform stage's reused
    graph (ShapeNet) or its own kNN (S3DIS)."""
    device = batch["data"].device
    fused = fused_route(cfg, device)
    reuse_graph = style == "Full" and smooth_graph_reusable(cfg, device)
    out = model(batch["data"], batch.get("cat_onehot"), training=True,
                bn_decay=bn_decay, generator=generator,
                want_smooth_graph=reuse_graph)
    logits, graph = out if reuse_graph else (out, None)
    if style == "Full":
        w = cfg.weaksup
        total, components = total_weaksup_loss(
            logits, batch["seg_onehot"], batch["mask"], batch["data"],
            gate=gate, siamese_weight=w.siamese_weight,
            smooth_gamma=w.smooth_gamma, smooth_knn=w.smooth_knn,
            smooth_channels=w.smooth_channels, smooth_fast=cfg.model.knn_fast,
            smooth_fused_bf16=fused, smooth_graph=graph,
            compat_frozen_gate=w.compat_frozen_gate)
    else:
        total = masked_softmax_ce(logits, batch["seg_onehot"], batch["mask"])
        components = {"seg": total}
    components["total"] = total
    return total, components, logits


def accuracy(logits: torch.Tensor, seg_labels: torch.Tensor,
             valid_mask: torch.Tensor,
             part_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fraction of correctly classified points over valid samples;
    ``part_bias`` [B, K] (1.0 on the category's part ids) is the
    reference's category-biased argmax (ShapeNet_DGCNN_trainer.py:199-201)."""
    prob = torch.softmax(logits, dim=-1)
    if part_bias is not None:
        prob = prob + part_bias[:, None, :]
    pred = torch.argmax(prob, dim=-1)
    correct = (pred == seg_labels).float() * valid_mask[:, None]
    den = torch.sum(valid_mask) * seg_labels.shape[1]
    return torch.sum(correct) / torch.clamp_min(den, 1.0)


def make_train_step(cfg: ExperimentConfig, model: DGCNNSeg, opt: Adam,
                    style: Optional[str] = None) -> Callable:
    """``(batch, gate, generator) -> metrics``: one Adam step on ``model``.

    ``batch`` holds device tensors: data [B, N, C] (Full style: B = 2 x
    unique, pairs interleaved), seg_onehot [B, N, K], seg [B, N] int, mask
    [B, N], cat_onehot [B, num_categories], part_bias [B, K], valid [B].
    ``gate`` is the rampup gate (epoch >= rampup: 1.0, else 0.0). The
    metrics are seg, siamese, inexact, smooth (Full), total, acc as
    device scalars and lr, bn_decay as host floats.
    """
    style = style or cfg.train.style
    # the schedules count UNIQUE samples (train_ShapeNet.py:82)
    batch_size = cfg.train.batch_size

    def step(batch: Dict[str, torch.Tensor], gate,
             generator: Optional[torch.Generator] = None):
        lr = learning_rate_schedule(opt.step, batch_size, cfg.schedule)
        bn_decay = bn_decay_schedule(opt.step, batch_size, cfg.schedule)
        opt.zero_grad()
        total, components, logits = loss_fn(
            model, batch, cfg=cfg, style=style, bn_decay=bn_decay, gate=gate,
            generator=generator)
        total.backward()
        opt.apply_gradients(lr)
        metrics = {k: v.detach() for k, v in components.items()}
        metrics["lr"] = lr
        metrics["bn_decay"] = bn_decay
        with torch.no_grad():
            metrics["acc"] = accuracy(logits, batch["seg"], batch["valid"],
                                      batch.get("part_bias"))
        return metrics

    return step


def make_eval_logits_fn(model: DGCNNSeg) -> Callable:
    """``(x, cat_onehot=None, n_valid=None) -> logits [B, N, C]`` f32 at
    eval (population BN, no dropout), without autograd."""

    @torch.inference_mode()
    def logits_fn(x: torch.Tensor, cat_onehot: Optional[torch.Tensor] = None,
                  n_valid: Optional[int] = None) -> torch.Tensor:
        return model(x, cat_onehot, n_valid)

    return logits_fn


def make_eval_step(model: DGCNNSeg) -> Callable:
    """``batch -> (prob, loss)``: the eval forward with population BN
    stats and no dropout, and the masked CE (steps.py:288-318)."""
    logits_fn = make_eval_logits_fn(model)

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]):
        logits = logits_fn(batch["data"], batch.get("cat_onehot"))
        loss = masked_softmax_ce(logits, batch["seg_onehot"], batch["mask"])
        return torch.softmax(logits, dim=-1), loss

    return eval_step
