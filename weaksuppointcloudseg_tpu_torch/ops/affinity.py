"""Kernels B10 and B17: the Gaussian-affinity matvec of the matrix-free
label propagation (``ops/csrc/affinity.cu``), counterparts of
weaksuppointcloudseg_tpu/ops/affinity_pallas.py:

    out = exp(-max(|f_i|^2 - 2 f_i.f_j + |f_j|^2, 0)) @ u

over all points j of the same sample, no [N, N] array ever in memory.

- B10 ``affinity_matvec_t``: feat [B, F, N], u and out [B, K, N], the
  transposed layout in which the label propagation keeps its CG state
  (affinity_matvec_pallas_t);
- B17 ``affinity_matvec``: feat [B, N, F], u and out [B, N, K]
  (affinity_matvec_pallas).

Tile skipping: the kernel computes a (128-row tile, 128-column tile) pair
only where its :func:`tile_mask` keeps it, that is where the squared
distance between the two tiles' feature bounding boxes is at most
``SKIP_CUTOFF`` (30). The bound is exact: every affinity of a skipped
pair is <= exp(-30) = 9.4e-14. Point order changes how many pairs
are skipped, never the result; :func:`morton_order` gives spatially near
points neighbouring positions.

The kernel keeps one row's K sums in registers, up to ``K_MAX`` (16): a
wrapper given more classes (ShapeNet's 50 parts) launches it once per group
of at most 16, each group's sums bitwise what one wider launch would give.

Each wrapper launches its CUDA kernel on CUDA tensors and takes its plain
version (``*_ref``: row tiles of an IEEE f32 ``bmm``, clamp, exp and a
second ``bmm``, nothing skipped) on CPU tensors; any other device raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as nnf

from weaksuppointcloudseg_tpu_torch.ops import _build

TILE = 128  # the kernel's row and column tile (ops/csrc/affinity.cu)
SKIP_CUTOFF = 30.0
K_MAX, F_MAX = 16, 6  # the kernel keeps K sums and F features in registers
_REF_ELEMS = 1 << 26  # affinities of one row tile of the plain version


def morton_order(xyz: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Z-order permutation [B, N] int32 of points xyz [B, N, 3]: each axis
    quantized to ``bits`` over its per-sample range, the bits interleaved,
    and a stable sort (the same permutation as the reference's
    ``jnp.argsort``)."""
    lo = xyz.amin(dim=1, keepdim=True)
    hi = xyz.amax(dim=1, keepdim=True)
    q = ((xyz - lo) / torch.clamp_min(hi - lo, 1e-12)
         * (2 ** bits - 1)).to(torch.int32)

    def spread(v):  # interleave two zero bits after each of the 10 bits
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    key = spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (spread(q[..., 2]) << 2)
    return torch.argsort(key, dim=1, stable=True).to(torch.int32)


def _tile_bbox(feat_t: torch.Tensor, tile: int):
    """Per-tile (min, max) over the point axis of feat_t [B, F, N]: [B, F,
    ceil(N / tile)] each. A ragged last tile repeats its last point, which
    moves neither."""
    b, f, n = feat_t.shape
    nt = -(-n // tile)
    if nt * tile != n:
        feat_t = nnf.pad(feat_t, (0, nt * tile - n), mode="replicate")
    t = feat_t.reshape(b, f, nt, tile)
    return t.amin(dim=3), t.amax(dim=3)


def skip_mask_t(feat_t: torch.Tensor, row_tile: int, col_tile: int,
                cutoff: float) -> torch.Tensor:
    """bool [B, n_row_tiles, n_col_tiles]: True where the two tiles'
    bounding boxes in feature space are at most ``cutoff`` apart in squared
    distance (the pair must be computed). feat_t [B, F, N]."""
    rmin, rmax = _tile_bbox(feat_t, row_tile)
    cmin, cmax = _tile_bbox(feat_t, col_tile)
    gap = torch.maximum(rmin[:, :, :, None] - cmax[:, :, None, :],
                        cmin[:, :, None, :] - rmax[:, :, :, None])
    d_lb = torch.sum(torch.square(torch.clamp_min(gap, 0.0)), dim=1)
    return d_lb <= cutoff


def tile_mask(feat_t: torch.Tensor,
              skip_cutoff: Optional[float] = SKIP_CUTOFF) -> torch.Tensor:
    """The kernel's tile mask of feat_t [B, F, N]: uint8 [B, n_tiles,
    n_tiles] of :func:`skip_mask_t` at its 128-point tile, all ones when
    ``skip_cutoff`` is None (every pair computed). A caller that applies W
    of the same features many times builds it once and passes it to the
    wrappers."""
    b, _, n = feat_t.shape
    nt = -(-n // TILE)
    if skip_cutoff is None:
        return torch.ones((b, nt, nt), dtype=torch.uint8, device=feat_t.device)
    return skip_mask_t(feat_t, TILE, TILE, float(skip_cutoff)).to(torch.uint8)


def affinity_matvec_ref(feat: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`affinity_matvec` (same contract),
    one row tile of affinities at a time, nothing skipped."""
    b, n, _ = feat.shape
    feat, u = feat.float(), u.float()
    sq = torch.sum(feat * feat, dim=-1)
    rows = max(1, min(n, _REF_ELEMS // max(1, b * n)))
    out = torch.empty((b, n, u.shape[-1]), dtype=torch.float32,
                      device=feat.device)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        inner = torch.bmm(feat[:, r0:r1], feat.transpose(1, 2))
        d = sq[:, r0:r1, None] - 2.0 * inner + sq[:, None, :]
        out[:, r0:r1] = torch.bmm(torch.exp(-torch.clamp_min(d, 0.0)), u)
    return out


def affinity_matvec_t_ref(feat_t: torch.Tensor, ut: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`affinity_matvec_t` (same contract)."""
    return affinity_matvec_ref(feat_t.transpose(1, 2),
                               ut.transpose(1, 2)).transpose(1, 2).contiguous()


def _launch(fn, feat: torch.Tensor, u: torch.Tensor,
            mask: Optional[torch.Tensor], transposed: bool) -> torch.Tensor:
    dev = feat.device
    if transposed:
        b, f, n = feat.shape
        k = u.shape[1]
        u_shape, feat_t = (b, k, n), feat
    else:
        b, n, f = feat.shape
        k = u.shape[-1]
        u_shape, feat_t = (b, n, k), feat.transpose(1, 2)
    _build.check_operand(feat, "feat", torch.float32, dev)
    _build.check_operand(u, "u", torch.float32, dev, u_shape)
    if not (k >= 1 and 1 <= f <= F_MAX):
        raise ValueError(f"{fn.__name__}: K={k} must be >= 1 and F={f} in "
                         f"[1, {F_MAX}]")
    if mask is None:
        mask = tile_mask(feat_t)
    nt = -(-n // TILE)
    _build.check_operand(mask, "mask", torch.uint8, dev, (b, nt, nt))
    if k > K_MAX:  # one launch per group of K_MAX classes
        dim = 1 if transposed else 2
        return torch.cat([
            _launch(fn, feat, u.narrow(dim, k0, min(K_MAX, k - k0)).contiguous(),
                    mask, transposed)
            for k0 in range(0, k, K_MAX)], dim=dim)
    out = torch.empty(u_shape, dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.affinity_matvec_launch(
            feat.data_ptr(), u.data_ptr(), mask.data_ptr(), b, n, f, k,
            int(transposed), out.data_ptr(), _build.stream_ptr(dev))
    _build.check(code, fn.__name__)
    fn.launches += 1
    return out


def affinity_matvec_t(feat_t: torch.Tensor, ut: torch.Tensor, *,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B10: out^T [B, K, N] = (exp(-clamped pdist2(feat)) @ u)^T.

    Args:
      feat_t: f32 [B, F, N] features, already scaled by the bandwidths.
      ut: f32 [B, K, N].
      mask: the tile pairs to compute, :func:`tile_mask` of feat_t; built
        here at ``SKIP_CUTOFF`` when None. The CPU's plain version
        computes every pair.

    On CUDA: 1 <= F <= 6, contiguous operands, any N and K (one launch
    per group of 16 classes).
    """
    if feat_t.device.type == "cpu":
        return affinity_matvec_t_ref(feat_t, ut)
    if feat_t.device.type != "cuda":
        raise ValueError(f"affinity_matvec_t: unsupported device {feat_t.device}")
    return _launch(affinity_matvec_t, feat_t, ut, mask, True)


def affinity_matvec(feat: torch.Tensor, u: torch.Tensor, *,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B17: out [B, N, K] = exp(-clamped pdist2(feat)) @ u for feat f32
    [B, N, F] and u f32 [B, N, K]; otherwise as :func:`affinity_matvec_t`
    (``mask`` is the tile mask of feat^T)."""
    if feat.device.type == "cpu":
        return affinity_matvec_ref(feat, u)
    if feat.device.type != "cuda":
        raise ValueError(f"affinity_matvec: unsupported device {feat.device}")
    return _launch(affinity_matvec, feat, u, mask, False)


affinity_matvec_t.launches = 0  # kernel launches since the last reset
affinity_matvec.launches = 0
