"""DGCNN point-cloud classification network and its loss.

Counterpart of weaksuppointcloudseg_tpu/models/dgcnn_cls.py (Wang et
al.'s classifier, Networks/dgcnn/models/dgcnn.py:20-107): the input
transform net, four single-conv EdgeConv stages (64/64/64/128), a 1024-wide
aggregation conv with a max over the points, fc 512 -> 256 with dropout,
and a linear layer to the classes. The parameters carry init_dgcnn_cls's
names (``transform_net.tconv1.w``, ``dgcnn1`` .. ``dgcnn4``, ``agg``,
``fc1``, ``fc2``, ``fc_out``), so ``utils/checkpoint.params_from_jax``
carries JAX weights across.

The dtype of the input points decides the route, as at dgcnn_cls.py:92-93,
with the tensors' device in place of the reference's backend gate:

  CUDA, bf16, use_fused_knn -> forward_fused: the transform net's fused
                               stage (B1 + B2/B7, backward B3/B4) and N-max
                               (B5/B8), four single-conv fused stages (B1
                               with the k-extrema, backward B4 sparse), the
                               aggregation's N-max (B5/B8); with
                               ``static_graph`` the transform stage's graph
                               feeds B11 in every stage
  CUDA, f32, use_fused_knn  -> forward_plain: kNN by B12, gathers by
                               indexing, their backward by B13
  CUDA, no use_fused_knn    -> forward_plain: the plain distance + stable
                               sort, bf16 gathers through B14, backward B13
  CPU, anything             -> forward_plain over plain versions

Logits come out in the input's dtype, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from weaksuppointcloudseg_tpu_torch.configs import ClsConfig
from weaksuppointcloudseg_tpu_torch.models import layers
from weaksuppointcloudseg_tpu_torch.models.transform_net import (
    TransformNet,
    apply_transform,
)
from weaksuppointcloudseg_tpu_torch.ops import neighbors


class DGCNNCls(nn.Module):
    """The classifier with seeded random weights (``seed``)."""

    def __init__(self, cfg: ClsConfig = ClsConfig(), *, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.transform_net = TransformNet(6, K=3, generator=gen)
        in_c = 3
        for i, w in enumerate(cfg.edge_channels):
            setattr(self, f"dgcnn{i + 1}", layers.Conv(2 * in_c, w, generator=gen))
            in_c = w
        self.agg = layers.Conv(sum(cfg.edge_channels), cfg.global_channels,
                               generator=gen)
        c = cfg.global_channels
        for i, w in enumerate(cfg.fc_channels):
            setattr(self, f"fc{i + 1}", layers.Conv(c, w, generator=gen))
            c = w
        self.fc_out = layers.Conv(c, cfg.num_classes, bn=False, generator=gen)

    def _stages(self):
        return [getattr(self, f"dgcnn{i + 1}")
                for i in range(len(self.cfg.edge_channels))]

    def forward(self, x: torch.Tensor, *, training: bool = False,
                bn_decay=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [B, num_classes] of points x [B, N, 3] (bf16 or f32).

        ``training``: batch-moment BN (the population stats in the BN
        buffers are updated in place with ``bn_decay``) and dropout with
        masks from ``generator`` (on x's device)."""
        kw = dict(training=training, bn_decay=bn_decay, generator=generator)
        if x.device.type == "cuda":
            if self.cfg.use_fused_knn and x.dtype == torch.bfloat16:
                return self.forward_fused(x, **kw)
        elif x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        return self.forward_plain(x, **kw)

    def forward_plain(self, x: torch.Tensor, *, training: bool = False,
                      bn_decay=None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Plain composition (dgcnn_cls.py:123-171) in x's dtype: kNN graphs
        by B12 with ``use_fused_knn`` (its plain version on CPU tensors),
        else the plain distance + sort; edge features through
        ``neighbors.edge_feature`` (B14 for bf16 rows, backward B13).
        Static-graph mode: one graph on the input points for the transform
        net and every stage."""
        cfg = self.cfg
        kw = dict(eps=cfg.bn_eps, training=training, decay=bn_decay)
        static_idx = None
        if cfg.static_graph:
            static_idx = self._knn_graph(x)
        transform = self.transform_net.forward_plain(
            x, x, cfg.k, use_fused=cfg.use_fused_knn, fast=cfg.knn_fast,
            idx=static_idx, **kw)
        feat = apply_transform(x, transform)
        outs = []
        for conv in self._stages():
            idx = static_idx if static_idx is not None else self._knn_graph(feat)
            h = layers.apply_conv(conv, neighbors.edge_feature(feat, idx), **kw)
            feat = torch.amax(h, dim=2)
            outs.append(feat)
        g = layers.apply_conv(self.agg, torch.cat(outs, dim=-1), **kw)
        return self._head(torch.amax(g, dim=1), generator=generator, **kw)

    def forward_fused(self, x: torch.Tensor, *, training: bool = False,
                      bn_decay=None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Composition over the fused blocks (the reference's fused_tpu
        branch, dgcnn_cls.py:113-166) on bf16 points: on CUDA tensors each
        block launches its kernels, on CPU tensors it takes the kernels'
        plain versions. With ``static_graph`` the transform stage's kNN
        graph on the input points is reused by every stage (B11)."""
        cfg = self.cfg
        kw = dict(eps=cfg.bn_eps, training=training, decay=bn_decay)
        x = x.contiguous()
        transform = self.transform_net.forward_fused(
            x, cfg.k, fast=cfg.knn_fast, want_graph=cfg.static_graph, **kw)
        static_idx = None
        if cfg.static_graph:
            transform, (static_idx, _) = transform
        feat = apply_transform(x, transform).contiguous()
        outs = []
        for conv in self._stages():
            feat = layers.apply_edge_conv_stage1_fused(
                conv, feat, feat, cfg.k, fast=cfg.knn_fast,
                reuse_idx=static_idx, **kw)
            outs.append(feat)
        h = layers.apply_conv_bn_relu_nmax(self.agg, torch.cat(outs, dim=-1),
                                           **kw)
        return self._head(h, generator=generator, **kw)

    def _knn_graph(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.use_fused_knn:
            return neighbors.knn_graph_fused(x, cfg.k, fast=cfg.knn_fast)
        return neighbors.knn_graph(x, cfg.k)

    def _head(self, h: torch.Tensor, *, eps: float, training: bool = False,
              decay=None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """fc layers with dropout, then the class logits in h's dtype
        (dgcnn_cls.py:173-182)."""
        for i in range(len(self.cfg.fc_channels)):
            h = layers.apply_conv(getattr(self, f"fc{i + 1}"), h, eps=eps,
                                  training=training, decay=decay)
            h = layers.dropout(h, self.cfg.keep_prob, training=training,
                               generator=generator)
        return layers.apply_conv(self.fc_out, h, relu=False, training=training)


def classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                        label_smoothing: float = 0.2) -> torch.Tensor:
    """Label-smoothed softmax CE (dgcnn_cls.py:186-193; the reference's
    dgcnn.py:101-107), f32. The log-softmax follows jax.nn.log_softmax's
    arithmetic in the logits' dtype (max shift, log of the sum of exps),
    so bf16 logits round where the reference rounds them."""
    k = logits.shape[-1]
    onehot = nn.functional.one_hot(labels.long(), k).float()
    smoothed = onehot * (1.0 - label_smoothing) + label_smoothing / k
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    log_p = shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))
    return -(smoothed * log_p.float()).sum(dim=-1).mean()
