"""Plain DGCNN part and semantic segmentation (Wang et al., "Dynamic Graph
CNN for Learning on Point Clouds", arXiv:1801.07829, as configured by Xu &
Lee, "Weakly Supervised Semantic Point Cloud Segmentation", CVPR 2020:
ShapeNet/DGCNN_ShapeNet.py and S3DIS/DGCNN_S3DIS.py).

One function serves both configurations, read from the configuration
file's ``model`` group:

- an optional spatial transform net on the kNN coordinates: EdgeConv
  (64, 128), max over k, conv 1024, max over points, fc 512, fc 256, a
  linear map to a K x K matrix that multiplies the points;
- EdgeConv stages: a kNN graph (the point itself included) on the stage's
  graph features, the edge feature concat(f_i, f_j - f_i), a chain of
  shared-MLP convs each with batch norm and ReLU, max over the k edges;
- the concatenated stage outputs through a conv to the global width with
  BN and ReLU, max over points; an optional category embedding (one-hot
  conv + BN + ReLU) appended to it;
- a head of convs over concat(global broadcast to every point, stage
  outputs), each with BN, ReLU and optional dropout, then a linear conv to
  the class logits.

Every conv is ``x @ w + b`` in the parameters' dtype (float32 in every
run), the edge convs on the
whole [B, N, k, 2C] edge tensor: no factorisation, no kernels. Batch norm
in training uses the batch's biased moments over every axis but the
channel (two-pass), at eval the stored population moments. Dropout keeps
a unit where ``torch.rand(shape, generator) < keep`` and divides it by
``keep`` (inverted dropout), drawing one tensor of the layer's shape per
dropout layer in head order.

Parameters are a dict from names to tensors; :func:`param_specs` lists
them with the kind of value each holds at initialisation. A training
forward keeps each BN layer's batch moments in ``Net.moments``.

A forward may be given the kNN graphs that the program under test
selected, one per EdgeConv stage in order (the transform net's first):
each stage then gathers along its given graph, so the reference follows
the program's choice among near-tied neighbours instead of making its
own, and the choice itself is checked by :func:`selection_excess`
against this forward's own distances. ``Net.used`` keeps the graph each
stage gathered along, ``Net.excess`` each given graph's excess.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
Quant = Callable[[torch.Tensor], torch.Tensor]


def knn_width(model: dict) -> int:
    ch = model["knn_channels"]
    return ch[1] - ch[0] if ch else model["in_channels"]


def param_specs(model: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every parameter and BN statistic. Kinds: w
    (a conv's [in, out] weight), b (its bias), gamma, beta, mean, var,
    tw and tb (the transform's output weight and bias)."""
    specs = []

    def conv(name, ci, co, bn=True):
        specs.extend([(f"{name}.w", (ci, co), "w"), (f"{name}.b", (co,), "b")])
        if bn:
            specs.extend((f"{name}.{k}", (co,), k)
                         for k in ("gamma", "beta", "mean", "var"))

    kc = knn_width(model)
    if model["use_transform_net"]:
        for name, ci, co in (("tconv1", 2 * kc, 64), ("tconv2", 64, 128),
                             ("tconv3", 128, 1024), ("tfc1", 1024, 512),
                             ("tfc2", 512, 256)):
            conv(f"transform_net.{name}", ci, co)
        specs.append(("transform_net.transform_out.w", (256, kc * kc), "tw"))
        specs.append(("transform_net.transform_out.b", (kc * kc,), "tb"))
    conv_i, in_c, outs = 1, model["in_channels"], []
    for widths in model["edge_channels"]:
        c = 2 * in_c
        for w in widths:
            conv(f"adj_conv{conv_i}", c, w)
            c, conv_i = w, conv_i + 1
        in_c = widths[-1]
        outs.append(in_c)
    conv("agg_conv", sum(outs), model["global_channels"])
    g = model["global_channels"]
    if model["num_categories"] > 0:
        conv("cat_embed", model["num_categories"],
             model["category_embed_channels"])
        g += model["category_embed_channels"]
    c = g + sum(outs)
    for i, w in enumerate(model["head_channels"]):
        conv(f"seg_conv{i + 1}", c, w)
        c = w
    conv("seg_out", c, model["num_classes"], bn=False)
    return specs


def knn(x: torch.Tensor, k: int, q: Quant, rows: int = 8
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx int64, squared distances) [B, N, k] of the k nearest points of
    every point of x [B, N, C], nearest first, itself included. The
    distances come from a Gram in x's dtype, ``rows`` clouds at a time."""
    x = q(x.detach())
    idx, sqd = [], []
    for s in range(0, x.shape[0], rows):
        xs = x[s:s + rows]
        sq = torch.sum(xs * xs, dim=-1)
        d = sq[:, :, None] - 2.0 * torch.bmm(xs, xs.transpose(1, 2)) + sq[:, None, :]
        v, i = torch.topk(d, k, dim=-1, largest=False, sorted=True)
        idx.append(i)
        sqd.append(v)
    return torch.cat(idx), torch.cat(sqd)


def selection_excess(x: torch.Tensor, idx: torch.Tensor, k: int, dtype: str,
                     rows: int = 4) -> float:
    """How far a given graph idx [B, N, k] lies from the k nearest points of
    x [B, N, C] rounded to ``dtype`` (the configuration's compute dtype,
    the points the selection runs on): the mean over every edge (i, j) of
    max(0, d(i, j) - d_k(i)), d the squared distance in float64 and d_k(i)
    the k-th smallest of row i (the point itself included), each cloud's
    over its median d_k. Exact ties cost nothing; 0 for a graph of k
    nearest points."""
    x = x.detach().to(getattr(torch, dtype)).double()
    total = 0.0
    for s in range(0, x.shape[0], rows):
        xs = x[s:s + rows]
        sq = torch.sum(xs * xs, dim=-1)
        d = sq[:, :, None] - 2.0 * torch.bmm(xs, xs.transpose(1, 2)) + sq[:, None, :]
        kth = torch.kthvalue(d, k, dim=-1).values
        chosen = torch.gather(d, 2, idx[s:s + rows].long())
        scale = torch.clamp_min(torch.median(kth, dim=1).values, 1e-30)
        total += float((torch.clamp_min(chosen - kth[..., None], 0.0).sum(dim=(1, 2))
                        / scale).sum())
        del d
    return total / idx.numel()


def gather(f: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """f [B, N, C] rows at idx [B, N, k] -> [B, N, k, C]."""
    b = torch.arange(f.shape[0], device=f.device)[:, None, None]
    return f[b, idx]


class Net:
    """The forward pass of one configuration over a parameter dict."""

    def __init__(self, model: dict, params: Params, q: Quant,
                 graphs: Optional[List[torch.Tensor]] = None):
        self.m, self.p, self.q = model, params, q
        self.moments: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.graphs = graphs
        self.used: List[torch.Tensor] = []
        self.excess: List[float] = []

    def conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ self.q(self.p[f"{name}.w"]) + self.p[f"{name}.b"]

    def bn(self, name: str, y: torch.Tensor, training: bool) -> torch.Tensor:
        axes = tuple(range(y.ndim - 1))
        if training:
            mean = y.mean(dim=axes)
            var = (y - mean).square().mean(dim=axes)
            self.moments[name] = (mean.detach(), var.detach())
        else:
            mean, var = self.p[f"{name}.mean"], self.p[f"{name}.var"]
        inv = torch.rsqrt(var + self.m["bn_eps"]) * self.p[f"{name}.gamma"]
        return (y - mean) * inv + self.p[f"{name}.beta"]

    def layer(self, name, x, training):
        y = self.q(self.conv(name, x))
        return self.q(torch.relu(self.bn(name, y, training)))

    def graph(self, src: torch.Tensor) -> torch.Tensor:
        """The next stage's graph: the given one, its selection checked on
        ``src``, else this forward's own kNN."""
        k = self.m["k"]
        if self.graphs is None:
            idx = knn(src, k, self.q)[0]
        else:
            idx = self.graphs[len(self.used)].long()
            if idx.shape != src.shape[:2] + (k,):
                raise ValueError(f"a given graph of shape {tuple(idx.shape)} "
                                 f"for points {tuple(src.shape)}")
            self.excess.append(selection_excess(src, idx, k,
                                                self.m["compute_dtype"]))
        self.used.append(idx)
        return idx

    def edge_stage(self, names, f, src, training):
        idx = self.graph(src)
        nbr = gather(f, idx)
        central = f[:, :, None, :].expand_as(nbr)
        h = torch.cat([central, nbr - central], dim=-1)
        for name in names:
            h = self.layer(name, h, training)
        return h.amax(dim=2)

    def knn_input(self, x):
        ch = self.m["knn_channels"]
        return x[..., ch[0]:ch[1]] if ch else x

    def forward(self, x: torch.Tensor, cat_onehot: Optional[torch.Tensor], *,
                training: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits [B, N, classes] of points x [B, N, C]."""
        m = self.m
        x = x.to(self.p["seg_out.w"].dtype)
        if m["use_transform_net"]:
            g = self.knn_input(x)
            t = "transform_net."
            net = self.edge_stage([t + "tconv1", t + "tconv2"], g, g, training)
            net = self.layer(t + "tconv3", net, training).amax(dim=1)
            net = self.layer(t + "tfc1", net, training)
            net = self.layer(t + "tfc2", net, training)
            kc = knn_width(m)
            transform = self.conv(t + "transform_out", net).reshape(-1, kc, kc)
            x = torch.matmul(x, transform)
            graph = x
        else:
            graph = self.knn_input(x)
        conv_i, outs = 1, []
        for s, widths in enumerate(m["edge_channels"]):
            names = [f"adj_conv{conv_i + j}" for j in range(len(widths))]
            f = x if s == 0 else outs[-1]
            src = graph if s == 0 else outs[-1]
            outs.append(self.edge_stage(names, f, src, training))
            conv_i += len(widths)
        concat = torch.cat(outs, dim=-1)
        glob = self.layer("agg_conv", concat, training).amax(dim=1)
        if m["num_categories"] > 0:
            glob = torch.cat([glob, self.layer("cat_embed", cat_onehot.to(x.dtype),
                                               training)], dim=-1)
        h = torch.cat([glob[:, None, :].expand(-1, concat.shape[1], -1), concat],
                      dim=-1)
        for i in range(len(m["head_channels"])):
            keep = m["head_keep_prob"][i]
            h = self.layer(f"seg_conv{i + 1}", h, training)
            if training and keep is not None and keep < 1.0:
                mask = torch.rand(h.shape, generator=generator,
                                  device=h.device) < keep
                h = torch.where(mask, h / keep, 0.0)
        return self.conv("seg_out", h)
