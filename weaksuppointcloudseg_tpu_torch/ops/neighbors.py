"""Pairwise distance, kNN and neighbor gather.

Counterpart of weaksuppointcloudseg_tpu/ops/neighbors.py. The routes:

- ``knn_graph``: the plain distance + stable sort (the reference's XLA
  path). The model runs it wherever ``use_fused_knn`` is off, on the card
  too, and it serves the kernels' plain versions.
- ``knn_graph_fused``: kernel B12 on CUDA tensors (bf16 points widened
  exactly to f32), its plain version on CPU tensors.
- ``gather_neighbors``: bf16 rows through kernel B14 (ops/gather.py), f32
  rows by indexing, as the reference leaves f32 to XLA's gather
  (neighbors.py:65-81); its backward is kernel B13 in both dtypes.
- ``neighbor_features_auto`` / ``edge_feature_auto`` with ``use_fused``:
  bf16 features through kernel B15 (ops/knn_gather.py: the kNN and the
  gather in one pass, backward B13), as the reference routes them to its
  fused kernel (neighbors.py:152-158); f32 features through B12 +
  ``gather_neighbors``. Without ``use_fused``: ``knn_graph`` +
  ``gather_neighbors``.

Every kernel takes its plain version on CPU tensors.
"""

from __future__ import annotations

import torch

from weaksuppointcloudseg_tpu_torch.ops import knn as knn_ops
from weaksuppointcloudseg_tpu_torch.ops.gather import gather_rows
from weaksuppointcloudseg_tpu_torch.ops.knn_gather import knn_gather
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
    the kernel on x widened exactly to f32 (bf16 points as the reference's
    knn_pallas takes them), on CPU its plain version. No gradient flows."""
    return knn_ops.knn(x.detach().float().contiguous(), k, fast=fast)


def neighbor_features_auto(g: torch.Tensor, f: torch.Tensor, k: int,
                           use_fused: bool = True,
                           fast: bool = False) -> torch.Tensor:
    """Neighbor features f[idx(knn(g))] -> [B, N, k, C] (neighbors.py:
    145-160). With ``use_fused``: bf16 ``f`` through kernel B15 (kNN and
    gather in one pass), f32 ``f`` through B12 + :func:`gather_neighbors`;
    without: the plain distance + sort + :func:`gather_neighbors`.
    Gradients flow to ``f`` through the B13 scatter; ``g`` gets none."""
    if use_fused and f.dtype == torch.bfloat16:
        return knn_gather(g.detach().contiguous(), f.contiguous(), k,
                          fast=fast)[1]
    idx = knn_graph_fused(g, k, fast=fast) if use_fused else knn_graph(g, k)
    return gather_neighbors(f, idx)


def edge_feature_auto(g: torch.Tensor, f: torch.Tensor, k: int,
                      use_fused: bool = True, fast: bool = False) -> torch.Tensor:
    """EdgeConv edge features concat([f_i, f_j - f_i]) with the graph built
    on ``g``, the neighbours by :func:`neighbor_features_auto`
    (neighbors.py:163-178)."""
    nbr = neighbor_features_auto(g, f, k, use_fused, fast)
    central = f[:, :, None, :].expand_as(nbr)
    return torch.cat([central, nbr - central], dim=-1)
