"""Input (XYZ) spatial transform net.

Counterpart of weaksuppointcloudseg_tpu/models/transform_net.py: edge
features -> conv 64 -> conv 128 -> max over k -> conv 1024 -> max over N ->
fc 512 -> fc 256 -> linear to K*K (zero weights, identity bias at init).
Both the plain and the fused path train and evaluate.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from weaksuppointcloudseg_tpu_torch.models import layers
from weaksuppointcloudseg_tpu_torch.ops import neighbors


class TransformNet(nn.Module):
    """Parameters named as init_transform_net's pytree."""

    def __init__(self, in_c: int, K: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.K = K
        for name, ci, co in (("tconv1", in_c, 64), ("tconv2", 64, 128),
                             ("tconv3", 128, 1024), ("tfc1", 1024, 512),
                             ("tfc2", 512, 256)):
            setattr(self, name, layers.Conv(ci, co, generator=generator))
        self.transform_out = layers.Conv(256, K * K, bn=False,
                                         generator=generator)
        with torch.no_grad():
            self.transform_out.w.zero_()
            self.transform_out.b.copy_(torch.eye(K).reshape(-1))

    def _head(self, net: torch.Tensor, eps: float, **kw) -> torch.Tensor:
        net = layers.apply_conv(self.tfc1, net, eps=eps, **kw)
        net = layers.apply_conv(self.tfc2, net, eps=eps, **kw)
        out = self.transform_out
        transform = net.float() @ out.w + out.b
        return transform.reshape(-1, self.K, self.K)

    def forward_plain(self, g: torch.Tensor, f: torch.Tensor, k: int, *,
                      eps: float, use_fused: bool = True, fast: bool = False,
                      training: bool = False, decay=None,
                      idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Plain path (transform_net.py:80-106): kNN graph on ``g`` (kernel
        B12 with ``use_fused``), or the given graph ``idx`` (static-graph
        mode), edge features of ``f``, convs with batch moments when
        ``training``. Returns the [B, K, K] transform. ``f`` is data, so no
        gradient reaches the neighbor gather."""
        kw = dict(eps=eps, training=training, decay=decay)
        ef = (neighbors.edge_feature(f, idx) if idx is not None else
              neighbors.edge_feature_auto(g, f, k, use_fused=use_fused,
                                          fast=fast))
        net = layers.apply_conv(self.tconv1, ef, **kw)
        net = layers.apply_conv(self.tconv2, net, **kw)
        net = torch.amax(net, dim=2)
        net = layers.apply_conv(self.tconv3, net, **kw)
        return self._head(torch.amax(net, dim=1), **kw)

    def forward_fused(self, g: torch.Tensor, k: int, *, eps: float,
                      fast: bool, n_valid: Optional[int] = None,
                      training: bool = False, decay=None,
                      want_graph: bool = False):
        """Fused path over the kernels: tconv1+tconv2+k-max as one
        EdgeConv stage on the bf16 coordinates ``g`` (B1 + B7 at eval; B1 +
        B2, backward B3 + B4, in training), then tconv3 + max over N (B8;
        B5 in training) (transform_net.py:55-108). ``g`` is data: no
        gradient reaches it. ``want_graph`` (training and eval): return
        ``(transform, (idx, sqd))`` with the stage's kNN graph on ``g``, for
        the smoothness loss and the static-graph stages."""
        kw = dict(eps=eps, training=training, decay=decay)
        net = layers.apply_edge_conv_stage_fused(
            self.tconv1, self.tconv2, g, g, k, fast=fast, n_valid=n_valid,
            want_graph=want_graph, **kw)
        net, graph = net if want_graph else (net, None)
        net = layers.apply_conv_bn_relu_nmax(self.tconv3, net,
                                             n_valid=n_valid, **kw)
        transform = self._head(net, **kw)
        return (transform, graph) if want_graph else transform
