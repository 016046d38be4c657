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

Work plan: the kernel runs one block per work item of :func:`tile_plan`,
a (sample, row tile, segment of at most ``SEGMENT_TILES`` kept column
tiles), so a row tile that keeps many column tiles is spread over many
blocks; a row tile of several items sums their partials in item order.
Every sum's order is a function of the mask, ``SEGMENT_TILES`` and K's
route (below) alone.
A caller that applies W of the same features many times builds the mask
and the plan once and passes the plan to the wrappers.

The kernel keeps its rows' K sums in registers, up to ``K_MAX`` (16): a
wrapper given more classes (ShapeNet's 50 parts) launches it once per group
of at most 16. K = 1 (the degree pass) applies W on the FP32 pipe, K >= 2
on tensor cores in three TF32 products (ops/csrc/affinity.cu).

Each wrapper launches its CUDA kernel on CUDA tensors and takes its plain
version (``*_ref``: row tiles of an IEEE f32 ``bmm``, clamp, exp and a
second ``bmm``, nothing skipped) on CPU tensors; any other device raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as nnf

from weaksuppointcloudseg_tpu_torch.ops import _build

TILE = 128  # the kernel's row and column tile (ops/csrc/affinity.cu)
# kept column tiles of a work item: small enough that bench.py's room
# (131,072 points, 200 kept tiles in its heaviest row tile) spreads evenly
# over the card, large enough that the partials' round trip stays near 3%
# of the kernel (scripts/torch_affinity_sweep.py, PERF.md: 4 ties on that
# room, is slower on it with room_label_prop's pads and needs twice the
# workspace; 16 is slower on both)
SEGMENT_TILES = 8
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


class TilePlan(NamedTuple):
    """The kernel's work items (:func:`tile_plan`), int32 tensors on the
    mask's device, for ``n_tiles`` row tiles of each of ``batch`` samples.

    - ``cols`` [T]: the kept column tiles, row tile by row tile (row tile
      ``b * n_tiles + i``), ascending within each;
    - ``item_start`` [n_items + 1]: item q sums the column tiles
      ``cols[item_start[q]:item_start[q + 1]]``;
    - ``item_row`` [n_items]: the row tile of each item;
    - ``row_items`` [batch * n_tiles + 1]: the first item of each row tile
      (every row tile has one item or more; one with no kept tile has one
      empty item and writes zeros).
    """

    cols: torch.Tensor
    item_start: torch.Tensor
    item_row: torch.Tensor
    row_items: torch.Tensor
    n_items: int
    batch: int
    n_tiles: int


def tile_plan(mask: torch.Tensor) -> TilePlan:
    """The work plan of the tile mask ``mask`` [B, nt, nt] (any dtype, 0
    skips): each row tile's kept column tiles in ascending order, cut into
    items of at most ``SEGMENT_TILES``. Torch ops on the mask's device,
    with one host synchronisation (for the item count)."""
    b, nt, nt2 = mask.shape
    if nt != nt2:
        raise ValueError(f"tile_plan: mask of shape {tuple(mask.shape)} is not "
                         f"[B, nt, nt]")
    dev, seg = mask.device, SEGMENT_TILES
    keep = (mask != 0).reshape(b * nt, nt)
    counts = keep.sum(1)
    nseg = torch.clamp_min(torch.div(counts + seg - 1, seg, rounding_mode="floor"), 1)
    total, n_items = torch.stack([counts.sum(), nseg.sum()]).tolist()
    if total >= 2 ** 31:
        raise ValueError(f"tile_plan: {total} kept tile pairs overflow int32")
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    row_ptr = torch.cat([zero, torch.cumsum(counts, 0)])
    row_items = torch.cat([zero, torch.cumsum(nseg, 0)])
    item_row = torch.repeat_interleave(
        torch.arange(b * nt, device=dev), nseg, output_size=n_items)
    first = row_ptr[item_row] + (
        torch.arange(n_items, device=dev) - row_items[item_row]) * seg
    item_start = torch.cat([first, row_ptr[-1:]])
    # kept column indices in row-major order: each kept entry goes to its
    # rank; the skipped ones to a spare slot past the end
    flat = keep.reshape(-1)
    dst = torch.where(flat, torch.cumsum(flat, 0) - 1, total)
    jt = torch.arange(nt, dtype=torch.int32, device=dev).repeat(b * nt)
    cols = torch.zeros(total + 1, dtype=torch.int32, device=dev).scatter_(
        0, dst, jt)[:total]
    return TilePlan(cols, item_start.to(torch.int32), item_row.to(torch.int32),
                    row_items.to(torch.int32), n_items, b, nt)


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
            mask: Optional[torch.Tensor], plan: Optional[TilePlan],
            transposed: bool) -> torch.Tensor:
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
    nt = -(-n // TILE)
    if plan is None:
        if mask is None:
            mask = tile_mask(feat_t)
        _build.check_operand(mask, "mask", torch.uint8, dev, (b, nt, nt))
        plan = tile_plan(mask)
    if (plan.batch, plan.n_tiles) != (b, nt) or plan.cols.device != dev:
        raise ValueError(f"plan: of {plan.batch} samples x {plan.n_tiles} "
                         f"tiles on {plan.cols.device}, expected {b} x {nt} "
                         f"on {dev}")
    if k > K_MAX:  # one launch per group of K_MAX classes
        dim = 1 if transposed else 2
        return torch.cat([
            _launch(fn, feat, u.narrow(dim, k0, min(K_MAX, k - k0)).contiguous(),
                    None, plan, transposed)
            for k0 in range(0, k, K_MAX)], dim=dim)
    out = torch.empty(u_shape, dtype=torch.float32, device=dev)
    rec = torch.empty((b, n, 8), dtype=torch.float32, device=dev)
    ws = torch.empty((plan.n_items, k, TILE), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        code = lib.affinity_matvec_launch(
            feat.data_ptr(), u.data_ptr(), plan.cols.data_ptr(),
            plan.item_start.data_ptr(), plan.item_row.data_ptr(),
            plan.row_items.data_ptr(), plan.n_items, b, n, f, k,
            int(transposed), rec.data_ptr(), ws.data_ptr(), out.data_ptr(),
            _build.stream_ptr(dev))
    _build.check(code, fn.__name__)
    fn.launches += 1
    return out


def affinity_matvec_t(feat_t: torch.Tensor, ut: torch.Tensor, *,
                      mask: Optional[torch.Tensor] = None,
                      plan: Optional[TilePlan] = None) -> torch.Tensor:
    """B10: out^T [B, K, N] = (exp(-clamped pdist2(feat)) @ u)^T.

    Args:
      feat_t: f32 [B, F, N] features, already scaled by the bandwidths.
      ut: f32 [B, K, N].
      mask: the tile pairs to compute, :func:`tile_mask` of feat_t; built
        here at ``SKIP_CUTOFF`` when None and no plan is given.
      plan: :func:`tile_plan` of the mask (the mask is then not read);
        built here when None. The CPU's plain version computes every pair
        and reads neither.

    On CUDA: 1 <= F <= 6, contiguous operands, any N and K (one launch
    per group of 16 classes).
    """
    if feat_t.device.type == "cpu":
        return affinity_matvec_t_ref(feat_t, ut)
    if feat_t.device.type != "cuda":
        raise ValueError(f"affinity_matvec_t: unsupported device {feat_t.device}")
    return _launch(affinity_matvec_t, feat_t, ut, mask, plan, True)


def affinity_matvec(feat: torch.Tensor, u: torch.Tensor, *,
                    mask: Optional[torch.Tensor] = None,
                    plan: Optional[TilePlan] = None) -> torch.Tensor:
    """B17: out [B, N, K] = exp(-clamped pdist2(feat)) @ u for feat f32
    [B, N, F] and u f32 [B, N, K]; otherwise as :func:`affinity_matvec_t`
    (``mask`` is the tile mask of feat^T)."""
    if feat.device.type == "cpu":
        return affinity_matvec_ref(feat, u)
    if feat.device.type != "cuda":
        raise ValueError(f"affinity_matvec: unsupported device {feat.device}")
    return _launch(affinity_matvec, feat, u, mask, plan, False)


affinity_matvec_t.launches = 0  # kernel launches since the last reset
affinity_matvec.launches = 0
