"""DGCNN (EdgeConv) segmentation network.

Counterpart of weaksuppointcloudseg_tpu/models/dgcnn.py. The parameters
carry init_dgcnn_seg's names (``transform_net.tconv1.w``,
``adj_conv1.gamma``, ``agg_conv``, ``cat_embed``, ``seg_conv1``, ...,
``seg_out``), so the module's state_dict keys are the JAX pytree's key
paths joined with dots (utils/checkpoint.py). One class serves both
presets: ShapeNet (transform net, category branch) and S3DIS (9 input
channels, kNN on channels 6:9, no transform net, head convs whose BN
population stats decay at the fixed ``head_bn_fixed_decay``).

Which path runs is decided by the compute dtype, ``use_fused_knn`` and
where the tensors live, in place of the reference's
``jax.default_backend()`` gate (dgcnn.py:144-145):

  CUDA, bf16, use_fused_knn, eval     -> forward_fused, kernels B1/B7/B8
  CUDA, bf16, use_fused_knn, training -> forward_fused, kernels B1-B5
                                         (forward B1/B2/B5, backward
                                         B3/B4/B5); a stage of three or
                                         more convs: B1, backward B13
  CUDA, f32, use_fused_knn            -> forward_plain, kNN by kernel B12
                                         and the gather's backward by B13
  CUDA, bf16, no use_fused_knn        -> forward_plain, kNN by the plain
                                         distance (IEEE f32 Gram) + stable
                                         sort, gathers by kernel B14, their
                                         backward by B13
  CUDA, f32, no use_fused_knn         -> forward_plain, kNN by the plain
                                         distance + stable sort, gathers by
                                         indexing, their backward by B13
  CPU, anything                       -> forward_plain over plain versions

On the fused training route ``want_smooth_graph`` also returns the
transform stage's kNN graph, which the Full-style smoothness loss reuses
with kernels B6 (train/steps.py).

Static-graph mode (``ModelConfig.static_graph``, opt-in, not reference
parity: dgcnn.py:186-309) builds one kNN graph on the input coordinates
and every EdgeConv stage reuses it. The graph comes from the transform
stage (fused route: B1 on the raw kNN-input coordinates in the compute
dtype, the graph the smoothness loss reuses too; plain route: one kNN
on the same coordinates, B12 with ``use_fused_knn``, else the plain
distance + sort), else from a fused two-conv stage 0 (B1 on the kNN
channels), else from one standalone kNN on the kNN channels. The fused
stages then gather along it with kernel B11 (training and eval), the
plain stages with ``neighbors.gather_neighbors`` (B14 in bf16, backward
B13).

A fused EdgeConv stage of three or more convs (no preset has one;
dgcnn.py:297-316) runs its first conv through
``layers.apply_edge_conv_knn_fused`` (B1 at eval through B16's VJP, in
training with a hand-written backward over B13), or with a static graph
through ``neighbors.gather_neighbors`` (B14) + ``layers.apply_edge_conv``;
its other convs are ``layers.apply_conv`` and the k-max ``torch.amax``.
Such stages take no ``n_valid``, as the reference asserts
(dgcnn.py:180-184).

The reference's ``allow_known_bad_bf16`` guard is absent on purpose: the
bf16 miscompile it guards against is a TPU backend fault.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from weaksuppointcloudseg_tpu_torch.configs import ModelConfig
from weaksuppointcloudseg_tpu_torch.models import layers
from weaksuppointcloudseg_tpu_torch.models.transform_net import (
    TransformNet,
    apply_transform,
)
from weaksuppointcloudseg_tpu_torch.ops import neighbors

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DGCNNSeg(nn.Module):
    """The segmentation network with seeded random weights (``seed``)."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0):
        super().__init__()
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}")
        self.cfg = cfg
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        gen = torch.Generator().manual_seed(seed)
        knn_c = (cfg.knn_channels[1] - cfg.knn_channels[0]
                 if cfg.knn_channels else cfg.in_channels)
        if cfg.use_transform_net:
            self.transform_net = TransformNet(2 * knn_c, K=knn_c, generator=gen)
        conv_i, in_c, stage_out = 1, cfg.in_channels, []
        for widths in cfg.edge_channels:
            c = 2 * in_c
            for w in widths:
                setattr(self, f"adj_conv{conv_i}", layers.Conv(c, w, generator=gen))
                c, conv_i = w, conv_i + 1
            in_c = widths[-1]
            stage_out.append(in_c)
        self.agg_conv = layers.Conv(sum(stage_out), cfg.global_channels,
                                    generator=gen)
        global_c = cfg.global_channels
        if cfg.num_categories > 0:
            self.cat_embed = layers.Conv(
                cfg.num_categories, cfg.category_embed_channels, generator=gen)
            global_c += cfg.category_embed_channels
        c = global_c + sum(stage_out)
        for h_i, w in enumerate(cfg.head_channels):
            setattr(self, f"seg_conv{h_i + 1}", layers.Conv(c, w, generator=gen))
            c = w
        self.seg_out = layers.Conv(c, cfg.num_classes, bn=False, generator=gen)

    def _knn_input(self, x):
        if self.cfg.knn_channels is not None:
            lo, hi = self.cfg.knn_channels
            return x[..., lo:hi]
        return x

    def _static_graph(self, g: torch.Tensor) -> torch.Tensor:
        """The static-graph mode's one kNN graph on ``g`` outside a fused
        stage: B12 with ``use_fused_knn`` (f32 on the card), else the
        plain distance + sort."""
        cfg = self.cfg
        if cfg.use_fused_knn:
            return neighbors.knn_graph_fused(g, cfg.k, fast=cfg.knn_fast)
        return neighbors.knn_graph(g, cfg.k)

    def _convs(self, widths, conv_i):
        return [getattr(self, f"adj_conv{conv_i + j}") for j in range(len(widths))]

    def forward(self, x: torch.Tensor, cat_onehot: Optional[torch.Tensor] = None,
                n_valid: Optional[int] = None, *, training: bool = False,
                bn_decay=None, generator: Optional[torch.Generator] = None,
                want_smooth_graph: bool = False):
        """Logits [B, N, num_classes] f32 of points x [B, N, C].

        ``training``: batch-moment BN (the population stats in the BN
        buffers are updated in place with ``bn_decay``) and dropout with
        masks from ``generator``. ``n_valid`` (fused eval path only): rows
        >= n_valid of x are padding; they are never neighbors and never
        win the max over points. ``want_smooth_graph`` (fused training
        route only): return ``(logits, (idx, sqd))``, see
        :meth:`forward_fused`.
        """
        if x.device.type == "cuda":
            if self._cuda_route() == "fused":
                return self.forward_fused(x, cat_onehot, n_valid,
                                          training=training,
                                          bn_decay=bn_decay,
                                          generator=generator,
                                          want_smooth_graph=want_smooth_graph)
        elif x.device.type != "cpu":
            raise ValueError(f"unsupported device {x.device}")
        if n_valid is not None:
            raise ValueError("n_valid is a fused-path option")
        if want_smooth_graph:
            raise ValueError("want_smooth_graph is a fused-path option")
        return self.forward_plain(x, cat_onehot, training=training,
                                  bn_decay=bn_decay, generator=generator)

    def _cuda_route(self) -> str:
        """"fused" (bf16 with ``use_fused_knn``) or "plain" (everything
        else) on CUDA, in training and at eval alike: the reference's one
        fused_tpu gate (dgcnn.py:141-145)."""
        if self.compute_dtype == torch.bfloat16 and self.cfg.use_fused_knn:
            return "fused"
        return "plain"

    def forward_plain(self, x: torch.Tensor, cat_onehot: Optional[torch.Tensor],
                      *, training: bool = False, bn_decay=None,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """Plain composition (reference dgcnn.py:216-232, 300-317,
        327-365) in the compute dtype: kNN graphs by B12 with
        ``use_fused_knn`` (its plain version on CPU tensors), else the plain
        distance + sort; neighbor gathers through B14 in bf16 (indexing in
        f32) whose backward is B13. Static-graph mode: one graph on the raw
        kNN-input coordinates in the compute dtype, which the transform net
        and every stage gather along."""
        cfg, dt = self.cfg, self.compute_dtype
        kw = dict(eps=cfg.bn_eps, training=training, decay=bn_decay)
        nkw = dict(use_fused=cfg.use_fused_knn, fast=cfg.knn_fast)
        static_idx = None
        if cfg.use_transform_net:
            g = self._knn_input(x)
            gc = g.to(dt)
            if cfg.static_graph:
                static_idx = self._static_graph(gc)
            # graph on the raw coordinates, features in the compute dtype
            transform = self.transform_net.forward_plain(
                g, gc, cfg.k, idx=static_idx, **nkw, **kw)
            x = apply_transform(x, transform)
        feat = x.to(dt)
        graph_feat = feat if cfg.use_transform_net else self._knn_input(x).to(dt)
        if cfg.static_graph and static_idx is None:
            static_idx = self._static_graph(graph_feat)
        conv_i, outs = 1, []
        for s_i, widths in enumerate(cfg.edge_channels):
            src = graph_feat if s_i == 0 else outs[-1]
            f_in = feat if s_i == 0 else outs[-1]
            convs = self._convs(widths, conv_i)
            nbr = (neighbors.gather_neighbors(f_in, static_idx)
                   if static_idx is not None else
                   neighbors.neighbor_features_auto(src, f_in, cfg.k, **nkw))
            h = layers.apply_edge_conv(convs[0], f_in, nbr, **kw)
            for p in convs[1:]:
                h = layers.apply_conv(p, h, **kw)
            outs.append(torch.amax(h, dim=2))
            conv_i += len(widths)
        concat = torch.cat(outs, dim=-1)
        global_feat = torch.amax(
            layers.apply_conv(self.agg_conv, concat, **kw), dim=1)
        return self._head(global_feat, concat, cat_onehot, generator=generator,
                          **kw)

    def forward_fused(self, x: torch.Tensor, cat_onehot: Optional[torch.Tensor],
                      n_valid: Optional[int] = None, *, training: bool = False,
                      bn_decay=None,
                      generator: Optional[torch.Generator] = None,
                      want_smooth_graph: bool = False):
        """Composition over the fused blocks (reference fused_tpu branch,
        dgcnn.py:175-365): on CUDA tensors each block launches its kernels,
        on CPU tensors it takes the kernels' plain versions. ``training``:
        the blocks' training forms (batch moments, BN buffers updated in
        place with ``bn_decay``) and the head's dropout from
        ``generator``. ``want_smooth_graph`` (training with a transform
        net): return ``(logits, (idx, sqd))``, the transform stage's
        gradient-free kNN graph on the raw kNN-input coordinates (cast to
        the compute dtype), for the smoothness loss to reuse. Static-graph
        mode reuses the same graph in every stage (B11); without a
        transform net a two-conv stage 0 produces it."""
        cfg, dt, eps = self.cfg, self.compute_dtype, self.cfg.bn_eps
        if training and n_valid is not None:
            raise ValueError("n_valid is an eval-only option")
        if n_valid is not None and any(len(w) > 2 for w in cfg.edge_channels):
            raise ValueError("n_valid needs EdgeConv stages of 1 or 2 convs")
        if want_smooth_graph and not (training and cfg.use_transform_net):
            raise ValueError("want_smooth_graph reuses the transform stage's "
                             "graph: training with a transform net only")
        kw = dict(eps=eps, training=training, decay=bn_decay)
        graph = static_idx = None
        if cfg.use_transform_net:
            g = self._knn_input(x).to(dt).contiguous()
            # the smoothness loss and the static stages share this graph
            want_tgraph = want_smooth_graph or cfg.static_graph
            transform = self.transform_net.forward_fused(
                g, cfg.k, fast=cfg.knn_fast, n_valid=n_valid,
                want_graph=want_tgraph, **kw)
            if want_tgraph:
                transform, tgraph = transform
                graph = tgraph if want_smooth_graph else None
                static_idx = tgraph[0] if cfg.static_graph else None
            x = apply_transform(x, transform)
        feat = x.to(dt).contiguous()
        graph_feat = feat if cfg.use_transform_net else self._knn_input(x).to(dt)
        if (cfg.static_graph and static_idx is None
                and len(cfg.edge_channels[0]) != 2):
            # no fused stage-0 producer either: one standalone kNN
            if n_valid is not None:
                raise ValueError("n_valid does not thread through the "
                                 "standalone static-graph kNN producer")
            static_idx = self._static_graph(graph_feat)
        conv_i, outs = 1, []
        for s_i, widths in enumerate(cfg.edge_channels):
            src = graph_feat if s_i == 0 else outs[-1]
            f_in = feat if s_i == 0 else outs[-1]
            convs = self._convs(widths, conv_i)
            skw = dict(fast=cfg.knn_fast, n_valid=n_valid,
                       reuse_idx=static_idx, **kw)
            if len(widths) == 2:
                produce = cfg.static_graph and static_idx is None
                out = layers.apply_edge_conv_stage_fused(
                    convs[0], convs[1], f_in, src, cfg.k, want_graph=produce,
                    **skw)
                if produce:
                    out, (static_idx, _) = out
            elif len(widths) == 1:
                out = layers.apply_edge_conv_stage1_fused(
                    convs[0], f_in, src, cfg.k, **skw)
            else:
                if static_idx is None:
                    h = layers.apply_edge_conv_knn_fused(
                        convs[0], f_in, src, cfg.k, fast=cfg.knn_fast, **kw)
                else:
                    h = layers.apply_edge_conv(
                        convs[0], f_in,
                        neighbors.gather_neighbors(f_in, static_idx), **kw)
                for p in convs[1:]:
                    h = layers.apply_conv(p, h, **kw)
                out = torch.amax(h, dim=2)
            outs.append(out)
            conv_i += len(widths)
        concat = torch.cat(outs, dim=-1)
        global_feat = layers.apply_conv_bn_relu_nmax(
            self.agg_conv, concat, n_valid=n_valid, **kw)
        logits = self._head(global_feat, concat, cat_onehot,
                            generator=generator, **kw)
        return (logits, graph) if want_smooth_graph else logits

    def _head(self, global_feat, concat, cat_onehot, *, eps: float,
              training: bool = False, decay=None,
              generator: Optional[torch.Generator] = None):
        cfg, dt = self.cfg, self.compute_dtype
        kw = dict(eps=eps, training=training, decay=decay)
        if cfg.num_categories > 0:
            if cat_onehot is None:
                raise ValueError("model was built with a category branch")
            cat = layers.apply_conv(self.cat_embed, cat_onehot.to(dt), **kw)
            global_feat = torch.cat([global_feat, cat], dim=-1)
        # the head convs' BN stats decay at the fixed rate where the preset
        # sets one (S3DIS, dgcnn.py:170-172); the category branch above
        # keeps the scheduled one
        if cfg.head_bn_fixed_decay is not None:
            kw["decay"] = cfg.head_bn_fixed_decay
        # first head conv: the global feature is constant over N, so its
        # product runs once per sample and broadcasts (layers.apply_conv_bcast)
        h = layers.apply_conv_bcast(self.seg_conv1, global_feat.to(dt), concat,
                                    **kw)
        h = layers.dropout(h, cfg.head_keep_prob[0], training=training,
                           generator=generator)
        for h_i in range(2, len(cfg.head_channels) + 1):
            h = layers.apply_conv(getattr(self, f"seg_conv{h_i}"), h, **kw)
            h = layers.dropout(h, cfg.head_keep_prob[h_i - 1],
                               training=training, generator=generator)
        return layers.apply_conv(self.seg_out, h, relu=False, **kw).float()
