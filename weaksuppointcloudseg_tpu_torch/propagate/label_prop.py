"""Probabilistic label propagation (inference-time refinement).

Counterpart of weaksuppointcloudseg_tpu/propagate/label_prop.py, solvers
"cg" (the factored-W conjugate gradient, the default), "solve" (batched
dense LU) and "cg_matfree" (room-level LP):

    w_i = 1 - H(G_i) / log2(K)                               (confidence)
    Y   = beta * (alpha Lsym + beta diag(w) + ridge I)^-1 diag(w) G
    Y_prob = Y / sum_k Y

"cg" never forms the Laplacian: its matvec applies ``A v = diag v - alpha
s (W (s v))`` with ``s = d^-1/2``, building the affinity W once and leaving
W @ v to ``torch.bmm`` (the reference leaves it to XLA; no Pallas kernel on
that path). "solve" builds Lsym and the system matrix and factors it with
``torch.linalg.solve`` in IEEE f32 (the reference leaves it to
``jnp.linalg.solve``; the package disables TF32, which would turn the
Gram's error into affinity noise). It holds three [B, N, N] f32 arrays at
once (Lsym, A and A's LU factors): 1.15 GB each at the ShapeNet test batch
(32 x 3000). "cg_matfree" builds no [N, N] array: every matvec recomputes
W through kernel B10 (ops/affinity.py).

CG semantics follow ``jax.scipy.sparse.linalg.cg`` exactly as the
reference calls it: the whole array is ONE vector, so every dot product
and the stop test ``|r|^2 <= tol^2 |b|^2`` (atol 0, at most ``cg_iters``
iterations) run over the batch. A per-sample CG would stop each sample on
its own residual and give other answers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from weaksuppointcloudseg_tpu_torch.ops.affinity import (
    affinity_matvec_t,
    morton_order,
    tile_mask,
    tile_plan,
)
from weaksuppointcloudseg_tpu_torch.propagate.laplacian import (
    laplacian_xyz_rgb,
    product_kernel_weights,
)
from weaksuppointcloudseg_tpu_torch.utils.profiling import span

_DEGREE_EPS = 1e-8  # LabelPropConfig.degree_eps; no caller changes it
_NOT_PORTED = {
    "sharded": "point-axis-sharded CG (ROADMAP queue A, data parallelism)",
}
# The centred Gram |f_i|^2 - 2 f_i.f_j + |f_j|^2 cancels in f32 to an error
# of a few ulps of max |f|^2 (its bound: 4 x 2^-23 x max |f|^2), which
# exp(-d^2) turns into a factor e^(+-error) on the affinities. A bound
# above 1 (some point more than ~45 m from the centroid at the xyz
# bandwidth 1e3) corrupts them: real rooms, tens of metres long, stay
# below it, and pad points placed 1 km away (once the room-LP pads, which
# gave 0.86 argmax agreement with the dense solve) go far above.
_GRAM_ULPS = 4
_GRAM_ERROR_LIMIT = 1.0


def entropy_confidence(g: torch.Tensor) -> torch.Tensor:
    """Per-point confidence w = 1 - H(g)/log2(K) of g [..., N, K] (with the
    reference's +1e-5 inside the log, which lets w dip below 0)."""
    entropy = -torch.sum(g * torch.log2(g + 1e-5), dim=-1)
    return 1.0 - entropy / math.log2(g.shape[-1])


def _cg(matvec, rhs: torch.Tensor, maxiter: int, tol: float,
        M=None) -> torch.Tensor:
    """Conjugate gradient with x0 = 0, one vector over the whole array,
    optionally preconditioned by ``M`` (a function v -> M v). As
    ``jax.scipy.sparse.linalg.cg``: gamma = r.M(r), and the stop test reads
    r.r when M is given (gamma without it).

    Spans (utils/profiling.py::span): ``lp.cg`` around the solve and an
    ``lp.cg_step`` per step that runs a matvec, from the matvec through
    the updates; the stop test that admits the step (a synchronise) runs
    just before its span, since only its answer says whether a step
    follows."""
    with span("lp.cg"):
        precond = (lambda v: v) if M is None else M
        x = torch.zeros_like(rhs)
        r = rhs.clone()  # b - A(0)
        p = precond(r)
        gamma = torch.sum(r * p)
        atol2 = tol * tol * torch.sum(rhs * rhs)
        for _ in range(maxiter):
            rs = gamma if M is None else torch.sum(r * r)
            if not bool(rs > atol2):  # the reference's while-loop condition
                break
            with span("lp.cg_step"):
                ap = matvec(p)
                alpha = gamma / torch.sum(p * ap)
                x = x + alpha * p
                r = r - alpha * ap
                z = precond(r)
                gamma_new = torch.sum(r * z)
                p = z + (gamma_new / gamma) * p
                gamma = gamma_new
        return x


def _normalize(y: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """y / sum(y) along ``dim``, a sum below 1e-30 in magnitude left as 1."""
    denom = torch.sum(y, dim=dim, keepdim=True)
    return y / torch.where(denom.abs() < 1e-30, torch.ones_like(denom), denom)


def label_propagation(
    lap: torch.Tensor, g: torch.Tensor, *, alpha: float = 1.0,
    beta: float = 1.0, ridge: float = 1e-5, solver: str = "solve",
    cg_iters: int = 50, cg_tol: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form label propagation on a given Laplacian (label_prop.py:
    44-93). lap [B, N, N] (symmetric-normalized) Laplacians, g [B, N, K]
    probabilities -> (Y [B, N, K], Y_prob row-normalized, w [B, N]).

    "solve": ``beta * solve(alpha L + beta diag(w) + ridge I, diag(w) G)``,
    one LU per sample. "cg": the same system by CG with the matvec straight
    off ``lap`` (A never formed), :func:`_cg`'s batch-global semantics.
    """
    w = entropy_confidence(g)  # [B, N]
    rhs = w[..., None] * g  # diag(w) @ G
    if solver == "cg":
        diag = beta * w + ridge

        def matvec(v):
            return alpha * torch.bmm(lap, v) + diag[..., None] * v

        y = beta * _cg(matvec, rhs, cg_iters, cg_tol)
    elif solver == "solve":
        # alpha L + beta diag(w) + ridge I, in the reference's order of
        # additions on the diagonal, without an [N, N] identity
        a = lap * alpha
        a.diagonal(dim1=-2, dim2=-1).add_(beta * w).add_(ridge)
        y = beta * torch.linalg.solve(a, rhs)
    else:
        raise ValueError(f"label_propagation: solver {solver!r} is not "
                         f"'solve' or 'cg'")
    return y, _normalize(y), w


def label_propagation_factored(
    xyz: torch.Tensor, g: torch.Tensor, rgb: torch.Tensor, *,
    alpha: float = 1.0, beta: float = 1.0, xyz_bandwidth: float = 1e3,
    rgb_bandwidth: float = 1e1, ridge: float = 1e-5, cg_iters: int = 50,
    cg_tol: float = 1e-5,
) -> torch.Tensor:
    """Dense-affinity CG label propagation. xyz [B,N,Cx], g [B,N,K]
    probabilities, rgb [B,N,Cr] -> Y_prob [B, N, K] f32."""
    w = product_kernel_weights(xyz, rgb, xyz_bandwidth=xyz_bandwidth,
                               rgb_bandwidth=rgb_bandwidth)
    d = torch.sum(w, dim=-1)  # degrees [B, N]
    s = torch.rsqrt(torch.clamp_min(d, 1e-30))
    w_conf = entropy_confidence(g)
    diag = alpha * (d + _DEGREE_EPS) * s * s + beta * w_conf + ridge

    def matvec(v):
        wv = torch.bmm(w, s[..., None] * v)
        return diag[..., None] * v - alpha * s[..., None] * wv

    y = beta * _cg(matvec, w_conf[..., None] * g, cg_iters, cg_tol)
    return _normalize(y)


def check_gram_cancellation(feat: torch.Tensor) -> float:
    """The f32 cancellation bound of the Gram of centred features feat
    [B, N, F] (4 ulps of the largest |f|^2); raises above its limit 1
    (ROADMAP C8: pad points must stay near the cloud)."""
    bound = _GRAM_ULPS * 2.0 ** -23 * float(torch.sum(feat * feat, dim=-1).max())
    if not bound <= _GRAM_ERROR_LIMIT:
        raise ValueError(
            f"label_propagation_matfree: the f32 cancellation bound of the "
            f"centred Gram, {_GRAM_ULPS} ulps of max |f|^2 = {bound:.3g}, "
            f"exceeds the limit {_GRAM_ERROR_LIMIT} (some point lies more "
            f"than ~45 m from the centroid at the xyz bandwidth 1e3): "
            f"exp(-d^2) would be corrupted; keep pad points near the cloud")
    return bound


def matfree_features(
    xyz: torch.Tensor, rgb: torch.Tensor, *, xyz_bandwidth: float = 1e3,
    rgb_bandwidth: float = 1e1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The features kernel B10 sees in :func:`label_propagation_matfree`:
    the xyz and rgb kernels folded into one Gaussian of (sqrt(bw_xyz) xyz |
    sqrt(bw_rgb) rgb), centred per sample (distances are translation-
    invariant, and centring shrinks the f32 cancellation of the Gram:
    :func:`check_gram_cancellation`, which it runs), Morton-sorted so that
    B10 skips far tile pairs. xyz [B, N, Cx], rgb [B, N, Cr] -> (feat_t
    [B, Cx + Cr, N] in the sorted order, order [B, N] int64)."""
    feat = torch.cat([xyz * math.sqrt(xyz_bandwidth),
                      rgb * math.sqrt(rgb_bandwidth)], dim=-1)
    feat = feat - torch.mean(feat, dim=1, keepdim=True)
    check_gram_cancellation(feat)
    order = morton_order(xyz).long()
    feat = torch.gather(feat, 1, order[..., None].expand(-1, -1, feat.shape[-1]))
    return feat.transpose(1, 2).contiguous(), order


def label_propagation_matfree(
    xyz: torch.Tensor, g: torch.Tensor, rgb: torch.Tensor, *,
    alpha: float = 1.0, beta: float = 1.0, xyz_bandwidth: float = 1e3,
    rgb_bandwidth: float = 1e1, ridge: float = 1e-5, cg_iters: int = 50,
    cg_tol: float = 1e-5,
) -> torch.Tensor:
    """Matrix-free label propagation: the CG recomputes the affinities in
    every matvec (kernel B10), so memory stays O(N). xyz [B,N,Cx], g
    [B,N,K] probabilities, rgb [B,N,Cr] -> Y_prob [B, N, K] f32.

    The features are :func:`matfree_features`; B10's tile mask and its
    work plan are built once for them and passed to every launch. The CG
    runs in the Morton order in the [B, K, N] layout, Jacobi-preconditioned
    (M = v / diag), and the result is unsorted at the end. Padding the CG to tiles, as the reference's kernel needs, is not
    needed here. Spans (utils/profiling.py::span): ``lp.features`` (its
    Gram check synchronises), ``lp.plan`` (the mask and the plan, one
    synchronise) and :func:`_cg`'s.
    """
    with span("lp.features"):
        feat_t, order = matfree_features(xyz, rgb, xyz_bandwidth=xyz_bandwidth,
                                         rgb_bandwidth=rgb_bandwidth)
    with span("lp.plan"):
        plan = tile_plan(tile_mask(feat_t))
    g = torch.gather(g, 1, order[..., None].expand(-1, -1, g.shape[-1]))
    d = affinity_matvec_t(feat_t, torch.ones_like(feat_t[:, :1]), plan=plan)[:, 0]
    s = torch.rsqrt(torch.clamp_min(d, 1e-30))[:, None, :]  # [B, 1, N]
    w_conf = entropy_confidence(g)[:, None, :]
    diag = alpha * (d[:, None, :] + _DEGREE_EPS) * s * s + beta * w_conf + ridge

    def matvec(v):  # [B, K, N]
        return diag * v - alpha * s * affinity_matvec_t(feat_t, s * v, plan=plan)

    rhs = w_conf * g.transpose(1, 2)
    y = beta * _cg(matvec, rhs.contiguous(), cg_iters, cg_tol,
                   M=lambda v: v / diag)
    y = _normalize(y, dim=1)
    inv = torch.argsort(order, dim=1)
    y = y.transpose(1, 2)
    return torch.gather(y, 1, inv[..., None].expand(-1, -1, y.shape[-1]))


def _label_propagation_solve(
    xyz: torch.Tensor, g: torch.Tensor, rgb: torch.Tensor, *,
    alpha: float, beta: float, xyz_bandwidth: float, rgb_bandwidth: float,
    ridge: float, cg_iters: int, cg_tol: float,
) -> torch.Tensor:
    """The "solve" solver of :func:`propagate_batch` (label_prop.py:
    400-413): Lsym of the product kernel, then the batched LU."""
    lap = laplacian_xyz_rgb(xyz, rgb, sym=True, xyz_bandwidth=xyz_bandwidth,
                            rgb_bandwidth=rgb_bandwidth)
    return label_propagation(lap, g, alpha=alpha, beta=beta, ridge=ridge,
                             solver="solve", cg_iters=cg_iters,
                             cg_tol=cg_tol)[1]


def propagate_batch(
    xyz: torch.Tensor, g: torch.Tensor, rgb: Optional[torch.Tensor] = None, *,
    alpha: float = 1.0, beta: float = 1.0, xyz_bandwidth: float = 1e3,
    rgb_bandwidth: float = 1e1, ridge: float = 1e-5, solver: str = "cg",
    cg_iters: int = 50, cg_tol: float = 1e-5,
) -> torch.Tensor:
    """Affinity build + LP solve. Returns Y_prob [B, N, K].

    Solvers: "cg" (dense affinity, factored CG), "solve" (the symmetric
    Laplacian and a batched dense LU, the closest to the reference's
    explicit inverse) and "cg_matfree" (no [N, N] array; the room-level
    mode). ShapeNet passes rgb=None: the reference feeds xyz twice
    (ShapeNet_DGCNN_trainer.py:551).
    """
    solvers = {"cg": label_propagation_factored,
               "solve": _label_propagation_solve,
               "cg_matfree": label_propagation_matfree}
    if solver not in solvers:
        what = _NOT_PORTED.get(solver, "an unknown solver")
        raise NotImplementedError(
            f"LP solver {solver!r} is not ported yet: {what}")
    if rgb is None:
        rgb = xyz
    return solvers[solver](
        xyz.float(), g.float(), rgb.float(), alpha=alpha, beta=beta,
        xyz_bandwidth=xyz_bandwidth, rgb_bandwidth=rgb_bandwidth, ridge=ridge,
        cg_iters=cg_iters, cg_tol=cg_tol)
