"""Pairwise distance, kNN and neighbor gather.

Counterpart of weaksuppointcloudseg_tpu/ops/neighbors.py. ``knn_graph`` is
the plain distance + sort (the reference's XLA path), which serves the CPU
and the kernels' plain versions; the model never runs it on the card.
``knn_graph_fused`` is kernel B12 on CUDA tensors (its plain version on CPU
tensors), and the backward of ``gather_neighbors`` is kernel B13.
"""

from __future__ import annotations

import torch

from weaksuppointcloudseg_tpu_torch.ops import knn as knn_ops
from weaksuppointcloudseg_tpu_torch.ops.scatter import scatter_add


def pairwise_sqdist(x: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean pairwise distances [B, N, N] of x [B, N, C].

    ``|x_i|^2 - 2 x_i.x_j + |x_j|^2`` with an f32 Gram of the (possibly
    bf16) inputs, not clamped. The Gram must be IEEE f32: label
    propagation feeds it into exp(-1e3 d^2), where TF32's error turns
    affinities into noise (the package sets ``allow_tf32=False``).
    """
    xf = x.float()
    inner = torch.bmm(xf, xf.transpose(1, 2))
    sq = torch.sum(xf * xf, dim=-1)
    return sq[:, :, None] - 2.0 * inner + sq[:, None, :]


def knn(sqdist: torch.Tensor, k: int) -> torch.Tensor:
    """int64 [B, N, k] indices of the k smallest distances, nearest first.

    Ties go to the lowest index, as ``lax.top_k`` orders them;
    ``torch.topk`` promises no tie order, so this is a stable sort.
    """
    return torch.sort(sqdist, dim=-1, stable=True).indices[..., :k]


class _GatherNeighbors(torch.autograd.Function):
    """Exact indexing forward; the cotangent scatter-adds back onto x's
    rows through kernel B13 (its plain version on CPU tensors)."""

    @staticmethod
    def forward(ctx, x, idx):
        idx = idx.int()
        ctx.save_for_backward(idx)
        ctx.n, ctx.dtype = x.shape[1], x.dtype
        b = torch.arange(x.shape[0], device=x.device)[:, None, None]
        return x[b, idx.long()]

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        dx = scatter_add(idx.contiguous(), ct.float().contiguous(), ctx.n)
        return dx.to(ctx.dtype), None


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, C], idx [B, N, k] -> neighbor features [B, N, k, C]."""
    return _GatherNeighbors.apply(x, idx)


def edge_feature(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """EdgeConv edge features concat([x_i, x_j - x_i]) [B, N, k, 2C] along
    the given graph idx [B, N, k] (neighbors.py:123-137)."""
    nbr = gather_neighbors(x, idx)
    central = x[:, :, None, :].expand_as(nbr)
    return torch.cat([central, nbr - central], dim=-1)


def knn_graph(x: torch.Tensor, k: int) -> torch.Tensor:
    """Pairwise distance + kNN in one call. [B, N, C] -> [B, N, k]."""
    return knn(pairwise_sqdist(x), k)


def knn_graph_fused(x: torch.Tensor, k: int, fast: bool = False) -> torch.Tensor:
    """int32 [B, N, k] kNN graph through kernel B12 (ops/knn.py): on CUDA
    the kernel (f32 x), on CPU its plain version. No gradient flows."""
    return knn_ops.knn(x.detach().contiguous(), k, fast=fast)


def neighbor_features_auto(g: torch.Tensor, f: torch.Tensor, k: int,
                           use_fused: bool = True,
                           fast: bool = False) -> torch.Tensor:
    """Neighbor features f[idx(knn(g))] -> [B, N, k, C]. With ``use_fused``
    the graph comes from B12, else from the plain distance + sort (the
    reference's f32 routes, neighbors.py:145-160). Gradients flow to ``f``
    through the B13 scatter; ``g`` gets none."""
    idx = knn_graph_fused(g, k, fast=fast) if use_fused else knn_graph(g, k)
    return gather_neighbors(f, idx)


def edge_feature_auto(g: torch.Tensor, f: torch.Tensor, k: int,
                      use_fused: bool = True, fast: bool = False) -> torch.Tensor:
    """EdgeConv edge features concat([f_i, f_j - f_i]) with the graph built
    on ``g`` (neighbors.py:163-178)."""
    idx = knn_graph_fused(g, k, fast=fast) if use_fused else knn_graph(g, k)
    return edge_feature(f, idx)
