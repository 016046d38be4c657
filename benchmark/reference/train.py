"""Plain weakly supervised training steps (Xu & Lee, CVPR 2020:
ShapeNet_DGCNN_trainer.py and S3DIS_DGCNN_trainer.py, Full style).

A batch of B unique samples becomes 2B clouds, each sample followed by
its Siamese twin; the loss is

    seg + gate * (siamese_weight * siamese + inexact + smooth)

- seg: softmax cross entropy over the labelled points, sum(mask CE) /
  sum(mask);
- siamese: mean over pairs and points of |P_a - P_b|^2 of the softmax
  outputs of the two twins;
- inexact: sigmoid cross entropy between each class's largest logit over
  the cloud and whether the class is present in the cloud's labels;
- smooth: mean over clouds, points and their k nearest neighbours (the
  point itself included) on the configured channels of
  exp(-d^2 / gamma) * mean over classes of (P_n - P_j)^2.

Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) applies the gradient of
that loss at the staircase learning rate of the trainers.

The twin of a sample is drawn as the trainers draw it, from one numpy
generator seeded with the run's seed: one shuffle of the epoch's sample
order, then per sample in batch order, ShapeNet: a jitter of standard
normals times 2e-3 of the cloud's extent per axis, then a z mirror with
probability one half; S3DIS: one of the 8 symmetries of the square,
applied to the raw and the room-normalised xy alike.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from reference import dgcnn

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


# -- host assembly ------------------------------------------------------------

def shapenet_twin(points: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    extent = points.max(axis=0) - points.min(axis=0)
    out = points + (2e-3 * extent[None, :]) * rng.standard_normal(
        points.shape).astype(points.dtype)
    if rng.integers(0, 2) == 1:
        out[:, 2] = -out[:, 2]
    return out


def s3dis_twin(block: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    out = block.copy()
    choice = int(rng.integers(0, 8))
    if choice in (1, 5, 6, 7):
        out[:, [0, 1, 6, 7]] = out[:, [1, 0, 7, 6]]
    if choice in (2, 4, 5, 7):
        out[:, 0], out[:, 6] = -out[:, 0], 1 - out[:, 6]
    if choice in (3, 4, 6, 7):
        out[:, 1], out[:, 7] = -out[:, 1], 1 - out[:, 7]
    return out


TWINS = {"shapenet": shapenet_twin, "s3dis": s3dis_twin}


def assemble(dataset: str, data: np.ndarray, seg: np.ndarray,
             label: Optional[np.ndarray], labelled: Sequence[np.ndarray],
             num_classes: int, num_categories: int,
             rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """One epoch of one batch: the shuffled order, the twins, the masks and
    the one-hots. data [B, N, C], seg [B, N], label [B] (ShapeNet's
    categories), labelled[i]: the labelled points of sample i."""
    order = np.arange(len(data))
    rng.shuffle(order)
    twin = TWINS[dataset]
    b, n = seg.shape
    pairs = np.empty((2 * b,) + data.shape[1:], np.float32)
    mask = np.zeros((b, n), np.float32)
    for i, s in enumerate(order):
        pairs[2 * i] = data[s]
        pairs[2 * i + 1] = twin(data[s], rng)
        mask[i, labelled[s]] = 1.0
    out = {"data": pairs, "mask": np.repeat(mask, 2, axis=0),
           "seg_onehot": np.eye(num_classes, dtype=np.float32)[
               np.repeat(seg[order], 2, axis=0)]}
    if num_categories:
        out["cat_onehot"] = np.eye(num_categories, dtype=np.float32)[
            np.repeat(label[order], 2, axis=0)]
    return out


# -- losses -------------------------------------------------------------------

def losses(logits: torch.Tensor, batch: Dict[str, torch.Tensor], cfg: dict,
           gate: float, q) -> torch.Tensor:
    w = cfg["weaksup"]
    onehot, mask, x = batch["seg_onehot"], batch["mask"], batch["data"]
    log_p = torch.log_softmax(logits, dim=-1)
    prob = log_p.exp()
    ce = -(onehot * log_p).sum(dim=-1)
    seg = (mask * ce).sum() / torch.clamp_min(mask.sum(), 1e-12)
    siam = (prob[0::2] - prob[1::2]).square().sum(dim=-1).mean()
    z = onehot.amax(dim=1)
    xm = logits.amax(dim=1)
    inexact = (torch.clamp_min(xm, 0.0) - xm * z
               + torch.log1p(torch.exp(-xm.abs()))).mean()
    ch = w["smooth_channels"]
    xs = x[..., ch[0]:ch[1]] if ch else x
    idx, sqd = dgcnn.knn(xs, w["smooth_knn"], q)
    aff = torch.exp(-torch.clamp_min(sqd, 0.0) / w["smooth_gamma"])
    diff = (prob[:, :, None, :] - dgcnn.gather(prob, idx)).square().mean(dim=-1)
    smooth = (aff * diff).mean()
    parts = {"seg": seg, "siamese": w["siamese_weight"] * siam,
             "inexact": inexact, "smooth": smooth}
    return seg + gate * (parts["siamese"] + inexact + smooth), parts


def learning_rate(step: int, batch_size: int, schedule: dict) -> float:
    """The trainers' staircase: base * rate^floor(samples / decay_step),
    at least the floor; samples count unique clouds."""
    e = math.floor(step * batch_size / schedule["lr_decay_step"])
    return max(schedule["base_learning_rate"] * schedule["lr_decay_rate"] ** e,
               schedule["lr_floor"])


class Trainer:
    """Parameters, Adam moments and the dropout stream of one run."""

    def __init__(self, cfg: dict, params: dgcnn.Params, seed: int, device,
                 q: Optional[dgcnn.Quant] = None):
        self.cfg = cfg
        self.names = [n for n, _, kind in dgcnn.param_specs(cfg["model"])
                      if kind not in ("mean", "var")]
        self.p = {n: t.detach().clone().float().to(device)
                  for n, t in params.items()}
        self.mu = {n: torch.zeros_like(self.p[n]) for n in self.names}
        self.nu = {n: torch.zeros_like(self.p[n]) for n in self.names}
        self.t = 0
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed + 1)
        self.q = q or (lambda x: x)
        self.device = device

    def step(self, host_batch: Dict[str, np.ndarray], gate: float,
             batch_size: int, graphs: Optional[List[torch.Tensor]] = None
             ) -> Dict[str, object]:
        """One Adam step; returns the loss, the gradients, the kNN graphs
        the forward gathered along and, where ``graphs`` were given (one
        per stage, dgcnn.Net), their selection excess."""
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in host_batch.items()}
        leaves = {n: self.p[n].clone().requires_grad_(True) for n in self.names}
        params = dict(self.p, **leaves)
        net = dgcnn.Net(self.cfg["model"], params, self.q, graphs)
        logits = net.forward(batch["data"], batch.get("cat_onehot"),
                             training=True, generator=self.generator)
        loss, parts = losses(logits, batch, self.cfg, gate, self.q)
        grads = torch.autograd.grad(loss, [leaves[n] for n in self.names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(self.p[n]) if g is None else g
                 for n, g in zip(self.names, grads)}
        lr = learning_rate(self.t, batch_size, self.cfg["schedule"])
        self.t += 1
        with torch.no_grad():
            for n in self.names:
                g = grads[n]
                self.mu[n].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
                self.nu[n].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
                m_hat = self.mu[n] / (1 - ADAM_B1 ** self.t)
                v_hat = self.nu[n] / (1 - ADAM_B2 ** self.t)
                self.p[n] -= lr * m_hat / (v_hat.sqrt() + ADAM_EPS)
        return {"loss": loss.item(), "grads": grads,
                "parts": {k: v.item() for k, v in parts.items()},
                "graphs": net.used, "excess": net.excess}


def leaf_norms(tensors: Dict[str, torch.Tensor], names: List[str]) -> np.ndarray:
    return np.array([float(torch.linalg.vector_norm(tensors[n].double()))
                     for n in names])
