"""Affinities for label propagation.

Counterpart of weaksuppointcloudseg_tpu/propagate/laplacian.py: the
product kernel, which the factored CG uses alone, and the graph Laplacian
that the dense-LU solver ("solve") is built on:

    W    = exp(-D_xyz * bw_xyz) * exp(-D_rgb * bw_rgb)  (negative D clamped to 0)
    d    = sum_j W_ij
    L    = diag(d + eps) - W
    Lsym = diag(d^-1/2) (diag(d + eps) - W) diag(d^-1/2)

The squared distances come from an IEEE f32 Gram (ops/neighbors.py): the
exp(-1e3 d^2) kernel amplifies Gram error about a thousandfold.
"""

from __future__ import annotations

import torch

from weaksuppointcloudseg_tpu_torch.ops.neighbors import pairwise_sqdist


def product_kernel_weights(xyz: torch.Tensor, rgb: torch.Tensor, *,
                           xyz_bandwidth: float = 1e3,
                           rgb_bandwidth: float = 1e1) -> torch.Tensor:
    """Affinity W [B, N, N] f32 of xyz [B, N, Cx] and rgb [B, N, Cr]."""
    d_xyz = torch.clamp_min(pairwise_sqdist(xyz), 0.0)
    d_rgb = torch.clamp_min(pairwise_sqdist(rgb), 0.0)
    # one exp of the summed scaled distances (= the product of the two)
    return torch.exp(-(d_xyz * xyz_bandwidth + d_rgb * rgb_bandwidth))


def laplacian_from_weights(w: torch.Tensor, *, sym: bool = False,
                           degree_eps: float = 1e-8,
                           eps_always: bool = False) -> torch.Tensor:
    """L = diag(d [+ eps]) - W [B, N, N] of affinities w [B, N, N],
    optionally symmetric-normalized by d^-1/2 on both sides, with the
    degrees guarded by max(d, 1e-30) (laplacian.py:91-111).

    The epsilon follows the reference: the generic unnormalized Laplacian
    adds none, the symmetric one adds ``degree_eps``, and ``eps_always``
    (the XYZRGB Laplacians) adds it in both. Built in one new [B, N, N]
    tensor (``w`` is not changed), in the reference's order of operations.
    """
    d = torch.sum(w, dim=-1)  # [B, N]
    add = degree_eps if (sym or eps_always) else 0.0
    lap = torch.neg(w)
    lap.diagonal(dim1=-2, dim2=-1).add_(d + add)
    if sym:
        s = torch.rsqrt(torch.clamp_min(d, 1e-30))
        lap.mul_(s[..., :, None]).mul_(s[..., None, :])
    return lap


def laplacian_xyz_rgb(xyz: torch.Tensor, rgb: torch.Tensor, *,
                      sym: bool = True, xyz_bandwidth: float = 1e3,
                      rgb_bandwidth: float = 1e1,
                      degree_eps: float = 1e-8) -> torch.Tensor:
    """The (symmetric-normalized) graph Laplacian [B, N, N] of the product
    kernel of xyz [B, N, Cx] and rgb [B, N, Cr] (laplacian.py:52-73): both
    variants add the diagonal epsilon."""
    w = product_kernel_weights(xyz, rgb, xyz_bandwidth=xyz_bandwidth,
                               rgb_bandwidth=rgb_bandwidth)
    return laplacian_from_weights(w, sym=sym, degree_eps=degree_eps,
                                  eps_always=True)
