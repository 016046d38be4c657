"""Pairwise distance, kNN and neighbor gather.

Counterpart of weaksuppointcloudseg_tpu/ops/neighbors.py. ``knn_graph`` is
the plain distance + stable sort (the reference's XLA path): the model runs
it wherever ``use_fused_knn`` is off, on the card too, and it serves the
kernels' plain versions. ``knn_graph_fused`` is kernel B12 on CUDA tensors
(its plain version on CPU tensors). ``gather_neighbors`` gathers bf16 rows
through kernel B14 (ops/gather.py; its plain version on CPU tensors) and
f32 rows by indexing, as the reference leaves f32 to XLA's gather
(neighbors.py:65-81); its backward is kernel B13 in both dtypes.
"""

from __future__ import annotations

import torch

from weaksuppointcloudseg_tpu_torch.ops import knn as knn_ops
from weaksuppointcloudseg_tpu_torch.ops.gather import gather_rows
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
    """Exact gather forward: bf16 rows through kernel B14, f32 rows by
    indexing; the cotangent scatter-adds back onto x's rows through kernel
    B13 (on CPU tensors both take their plain versions)."""

    @staticmethod
    def forward(ctx, x, idx):
        idx = idx.int().contiguous()
        ctx.save_for_backward(idx)
        ctx.n, ctx.dtype = x.shape[1], x.dtype
        if x.dtype == torch.bfloat16:
            return gather_rows(x.contiguous(), idx)
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
    """Pairwise distance + kNN in one call, on x's device: [B, N, C] ->
    int64 [B, N, k]. The indices carry no gradient, so neither the [B, N, N]
    distances nor the sort enter autograd."""
    return knn(pairwise_sqdist(x.detach()), k)


def knn_graph_fused(x: torch.Tensor, k: int, fast: bool = False) -> torch.Tensor:
    """int32 [B, N, k] kNN graph through kernel B12 (ops/knn.py): on CUDA
    the kernel (f32 x), on CPU its plain version. No gradient flows."""
    return knn_ops.knn(x.detach().contiguous(), k, fast=fast)


def neighbor_features_auto(g: torch.Tensor, f: torch.Tensor, k: int,
                           use_fused: bool = True,
                           fast: bool = False) -> torch.Tensor:
    """Neighbor features f[idx(knn(g))] -> [B, N, k, C]. With ``use_fused``
    the graph comes from B12, else from the plain distance + sort (the
    reference's routes off its fused bf16 kernel, neighbors.py:145-160);
    the gather is :func:`gather_neighbors`. Gradients flow to ``f`` through
    the B13 scatter; ``g`` gets none."""
    idx = knn_graph_fused(g, k, fast=fast) if use_fused else knn_graph(g, k)
    return gather_neighbors(f, idx)


def edge_feature_auto(g: torch.Tensor, f: torch.Tensor, k: int,
                      use_fused: bool = True, fast: bool = False) -> torch.Tensor:
    """EdgeConv edge features concat([f_i, f_j - f_i]) with the graph built
    on ``g`` (neighbors.py:163-178)."""
    idx = knn_graph_fused(g, k, fast=fast) if use_fused else knn_graph(g, k)
    return edge_feature(f, idx)
