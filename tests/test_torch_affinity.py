"""Kernels B10/B17 (ops/affinity.py), the Morton order, the skip mask, the
preconditioned CG and the matrix-free label propagation against the JAX
package on the CPU.

Tolerances: the plain B10/B17 against the Pallas kernels in interpret mode
1e-5 of max(1, max |out|), as tests/test_affinity_pallas.py holds the
kernels to its f64 oracle (both are f32 Gram + exp + apply, in other
summation orders); the Morton order and the skip mask bitwise (integer
keys and a stable sort; the same f32 min, max and compare). The
label-propagation tolerances are stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaksuppointcloudseg_tpu.ops import affinity_pallas as jap
from weaksuppointcloudseg_tpu.propagate import label_prop as jlp
from weaksuppointcloudseg_tpu_torch.ops import affinity
from weaksuppointcloudseg_tpu_torch.propagate import label_prop

torch.set_num_threads(1)


def rel_err(got, want):
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


@pytest.mark.parametrize("b,n,f,k,rt,ct", [
    (1, 640, 6, 14, 128, 256),   # room-LP shape family (Pallas pads 640)
    (2, 300, 3, 5, 128, 128),    # unaligned N, xyz only, small K
    (1, 256, 6, 50, 128, 128),   # ShapeNet-width K
])
def test_b17_plain_matches_pallas(b, n, f, k, rt, ct):
    rng = np.random.default_rng(0)
    feat = rng.uniform(0, 2, (b, n, f)).astype(np.float32)
    u = rng.standard_normal((b, n, k)).astype(np.float32)
    want = np.asarray(jap.affinity_matvec_pallas(
        feat, u, row_tile=rt, col_tile=ct, interpret=True))
    got = affinity.affinity_matvec(torch.tensor(feat), torch.tensor(u)).numpy()
    assert got.shape == (b, n, k)
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("b,n,k,tile,cutoff", [
    (2, 256, 13, 64, 30.0),   # the CG's K
    (1, 512, 1, 128, 30.0),   # the degree pass
    (2, 256, 13, 64, None),   # every tile computed
])
def test_b10_plain_matches_pallas(b, n, k, tile, cutoff):
    rng = np.random.default_rng(1)
    feat_t = rng.uniform(0, 2, (b, 6, n)).astype(np.float32)
    ut = rng.standard_normal((b, k, n)).astype(np.float32)
    want = np.asarray(jap.affinity_matvec_pallas_t(
        jnp.asarray(feat_t), jnp.asarray(ut), row_tile=tile, col_tile=tile,
        skip_cutoff=cutoff, interpret=True))
    got = affinity.affinity_matvec_t(torch.tensor(feat_t), torch.tensor(ut)).numpy()
    assert got.shape == (b, k, n)
    assert rel_err(got, want) < 1e-5


def test_wrappers_take_the_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    feat = torch.tensor(rng.uniform(0, 2, (1, 100, 6)).astype(np.float32))
    u = torch.tensor(rng.standard_normal((1, 100, 20)).astype(np.float32))
    before = (affinity.affinity_matvec.launches,
              affinity.affinity_matvec_t.launches)
    got = affinity.affinity_matvec(feat, u)  # K=20: the plain version has no cap
    torch.testing.assert_close(got, affinity.affinity_matvec_ref(feat, u),
                               rtol=0, atol=0)
    feat_t, ut = (t.transpose(1, 2).contiguous() for t in (feat, u))
    torch.testing.assert_close(affinity.affinity_matvec_t(feat_t, ut),
                               affinity.affinity_matvec_t_ref(feat_t, ut),
                               rtol=0, atol=0)
    assert (affinity.affinity_matvec.launches,
            affinity.affinity_matvec_t.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        affinity.affinity_matvec_t(feat.to("meta"), u.to("meta"))


def test_morton_order_matches_jax():
    """The same permutation, ties included (repeated points keep their
    index order: both sorts are stable)."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 8, (2, 2000, 3)).astype(np.float32)
    pts[0, 100:300] = pts[0, 0:200]
    pts[1, :, 2] = 1.5  # a flat axis
    got = affinity.morton_order(torch.tensor(pts)).numpy()
    want = np.asarray(jap.morton_order(jnp.asarray(pts)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def clustered_feat_t(rng, clusters=6, per=128):
    """Morton-sorted 6-channel features of far-apart clusters, scaled as
    the label propagation scales them (sqrt(1e3) xyz, sqrt(10) rgb)."""
    centers = rng.uniform(0, 4, (clusters, 3))
    xyz = (np.repeat(centers, per, 0)
           + rng.standard_normal((clusters * per, 3)) * 0.05).astype(np.float32)
    order = np.asarray(jap.morton_order(jnp.asarray(xyz[None])))[0]
    xyz = xyz[order]
    rgb = rng.uniform(0, 1, xyz.shape).astype(np.float32)
    feat = np.concatenate([xyz * np.sqrt(1e3), rgb * np.sqrt(10.0)], -1)
    return np.ascontiguousarray(feat.T[None]).astype(np.float32)


def test_skip_mask_matches_jax_on_a_clustered_scene():
    """ROADMAP C9: a scene where tiles are actually skipped."""
    feat_t = clustered_feat_t(np.random.default_rng(4))
    for tile in (64, 128):
        want = np.asarray(jap._skip_mask_t(jnp.asarray(feat_t), tile, tile, 30.0))
        got = affinity.skip_mask_t(torch.tensor(feat_t), tile, tile, 30.0).numpy()
        np.testing.assert_array_equal(got.astype(np.int32), want)
        assert 0.0 < 1.0 - got.mean() < 1.0, got.mean()


def test_skipped_pairs_are_below_the_cutoff():
    """The mask's bound is exact: with every skipped tile pair's
    affinities dropped, the matvec moves by at most exp(-30) sum |u|. A
    ragged last tile's box covers its real points only."""
    rng = np.random.default_rng(5)
    feat_t = torch.tensor(clustered_feat_t(rng)[:, :, :700])  # ragged
    ut = torch.tensor(rng.standard_normal((1, 3, 700)).astype(np.float32))
    tile = affinity.TILE
    mask = affinity.skip_mask_t(feat_t, tile, tile, 30.0)[0]
    assert mask.shape == (6, 6) and not bool(mask.all())
    keep = mask.repeat_interleave(tile, 0).repeat_interleave(tile, 1)[:700, :700]
    f = feat_t[0].T.double()
    sq = (f * f).sum(-1)
    w = torch.exp(-torch.clamp_min(sq[:, None] - 2 * f @ f.T + sq[None], 0))
    full = ut[0].double() @ w
    kept = ut[0].double() @ (w * keep)
    assert float((full - kept).abs().max()) <= np.exp(-30.0) * float(ut.abs().sum())
    assert float((w * ~keep).max()) <= np.exp(-30.0)
    last = feat_t[0, :, 640:]
    lo, hi = affinity._tile_bbox(feat_t, tile)
    torch.testing.assert_close(lo[0, :, -1], last.amin(1), rtol=0, atol=0)
    torch.testing.assert_close(hi[0, :, -1], last.amax(1), rtol=0, atol=0)


# ----------------------------------------------------------- work plan

def plan_items(plan):
    """[(row tile, [column tiles])] of every item, in item order."""
    cols = plan.cols.tolist()
    start = plan.item_start.tolist()
    return [(r, cols[start[q]:start[q + 1]])
            for q, r in enumerate(plan.item_row.tolist())]


def numpy_items(mask, seg):
    """The plan's items built in numpy: each row tile's kept column tiles,
    ascending, in runs of at most ``seg``; one empty item for a row tile
    that keeps none."""
    b, nt, _ = mask.shape
    items = []
    for r, row in enumerate(mask.reshape(b * nt, nt)):
        kept = np.flatnonzero(row).tolist()
        items += [(r, kept[s:s + seg]) for s in range(0, len(kept), seg)] or [(r, [])]
    return items


@pytest.mark.parametrize("seg", [1, 3, 8])
def test_tile_plan_matches_numpy(monkeypatch, seg):
    """tile_plan against a numpy construction on the tile mask of two
    samples of clustered features with a ragged last tile, one row tile
    keeping every tile and one keeping none: every kept (row tile, column
    tile) appears exactly once and no skipped one does, ascending, at most
    SEGMENT_TILES an item; row_items points at each row tile's first item."""
    monkeypatch.setattr(affinity, "SEGMENT_TILES", seg)
    rng = np.random.default_rng(11)
    feat_t = np.concatenate([clustered_feat_t(rng, clusters=8, per=160)[:, :, :1250]
                             for _ in range(2)])  # 10 tiles, the last of 98 points
    mask = affinity.tile_mask(torch.tensor(feat_t))
    mask[0, 3] = 1  # keeps every tile
    mask[1, 5] = 0  # keeps none
    m = mask.numpy()
    assert 0.2 < m.mean() < 0.9
    plan = affinity.tile_plan(mask)
    assert (plan.batch, plan.n_tiles) == (2, 10)
    items = plan_items(plan)
    assert items == numpy_items(m, seg)
    assert plan.n_items == len(items)
    assert all(c == sorted(c) and len(c) <= seg for _, c in items)
    kept = sorted((r, c) for r, cs in items for c in cs)
    want = sorted(zip(*np.nonzero(m.reshape(20, 10))))
    assert kept == [(int(r), int(c)) for r, c in want]
    rows = [r for r, _ in items]
    assert plan.row_items.tolist() == [rows.index(r) for r in range(20)] + [len(rows)]
    for t in plan[:4]:
        assert t.dtype == torch.int32


def plan_matvec_t(feat_t, ut, plan):
    """B10's sum over the plan, emulated in torch: each item's partial
    W[rows, its column tiles] @ u, then each row tile's partials added in
    item order (the kernel's segmented sum; the order inside an item is
    the bmm's)."""
    b, _, n = feat_t.shape
    tile, nt = affinity.TILE, plan.n_tiles
    f = feat_t.transpose(1, 2)
    sq = (f * f).sum(-1)
    out = torch.zeros_like(ut)
    done = set()
    for q, (rid, cs) in enumerate(plan_items(plan)):
        bi, i = divmod(rid, nt)
        rows = torch.arange(i * tile, min(n, (i + 1) * tile))
        cols = torch.cat([torch.arange(c * tile, min(n, (c + 1) * tile)) for c in cs]
                         or [torch.zeros(0, dtype=torch.long)])
        d = sq[bi, rows, None] - 2.0 * f[bi, rows] @ f[bi, cols].T + sq[bi, None, cols]
        part = ut[bi][:, cols] @ torch.exp(-torch.clamp_min(d, 0.0)).T
        first = rid not in done
        done.add(rid)
        out[bi][:, rows] = part if first else out[bi][:, rows] + part
    return out


def plan_errors(got, feat_t, ut):
    """max |got - plain| per element over the kernel's tolerance
    (tests/test_torch_cuda.py::affinity_errors, chip_smoke.py::
    check_affinity): twice the Gram's cancellation bound plus 1e-5 of
    sum_j W_ij |u_j|, plus exp(-30) sum |u| for the skipped pairs."""
    want = affinity.affinity_matvec_t_ref(feat_t, ut)
    mags = affinity.affinity_matvec_t_ref(feat_t, ut.abs())
    bound = label_prop.check_gram_cancellation(feat_t.transpose(1, 2))
    skipped = np.exp(-30.0) * ut.abs().sum((1, 2), keepdim=True)
    tol = (2 * bound + 1e-5) * mags + skipped + 1e-30
    return float(((got - want).abs() / tol).max())


@pytest.mark.parametrize("pads", [0, 1280])
def test_plan_segmented_sum_matches_the_plain_version(pads):
    """The plan's segmented sum against affinity_matvec_t_ref on a room's
    features as the LP makes them (matfree_features), alone and with a
    block of identical pad points 2 m outside it (room_label_prop's pads:
    ten tiles that keep each other at affinity 1, so their row tiles take
    two items or more)."""
    rng = np.random.default_rng(12)
    xyz, _, rgb = room_cloud(rng, 1000)
    if pads:
        xyz = np.concatenate([xyz, np.broadcast_to(xyz[0].max(0) + 2.0, (1, pads, 3))], 1)
        rgb = np.concatenate([rgb, np.zeros((1, pads, 3), np.float32)], 1)
    feat_t, _ = label_prop.matfree_features(torch.tensor(xyz), torch.tensor(rgb))
    ut = torch.tensor(rng.standard_normal((1, 13, feat_t.shape[2])).astype(np.float32))
    plan = affinity.tile_plan(affinity.tile_mask(feat_t))
    heavy = np.bincount(plan.item_row.numpy()).max()
    assert heavy >= (2 if pads else 1)
    assert plan_errors(plan_matvec_t(feat_t, ut, plan), feat_t, ut) <= 1.0


# ------------------------------------------------------------------- CG

def test_preconditioned_cg_matches_jax():
    """_cg with M against jax.scipy.sparse.linalg.cg with M on one SPD
    system over a [B, K, N] array (one vector): with a preconditioner
    whose r.M(r) is far below r.r, a stop test on gamma would end at once;
    JAX tests r.r, and so must the port. f32 in other summation orders:
    rtol 1e-4 of the largest entry."""
    rng = np.random.default_rng(6)
    b, k, n = 2, 3, 40
    q = rng.standard_normal((b, n, n)).astype(np.float32)
    a = (q @ q.transpose(0, 2, 1) / n + np.eye(n, dtype=np.float32) * 0.5)
    diag = np.einsum("bii->bi", a)[:, None, :] * 1e4  # M = v / (1e4 diag A)
    rhs = rng.standard_normal((b, k, n)).astype(np.float32)

    def jmv(v):
        return jnp.einsum("bnm,bkm->bkn", a, v)

    for iters in (3, 50):
        want, _ = jax.scipy.sparse.linalg.cg(
            jmv, jnp.asarray(rhs), maxiter=iters, tol=1e-5,
            M=lambda v: v / diag)
        got = label_prop._cg(
            lambda v: torch.einsum("bnm,bkm->bkn", torch.tensor(a), v),
            torch.tensor(rhs), iters, 1e-5,
            M=lambda v: v / torch.tensor(diag))
        want = np.asarray(want)
        assert np.abs(want).max() > 0.1  # it did not stop at x = 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


# ------------------------------------------------------- matrix-free LP

def room_cloud(rng, n, size=(3.0, 2.0, 2.5)):
    """Points on a floor, two walls and in the volume of a small room, rgb
    in [0, 1] varying smoothly over the room as a scan's colours do, and
    probabilities of a sharpness like a trained model's."""
    n_surf = int(n * 0.7)
    xy = rng.uniform(0, 1, (n_surf, 2)) * size[:2]
    which = rng.integers(0, 3, n_surf)
    z = np.where(which == 0, 0.0, rng.uniform(0, size[2], n_surf))
    x = np.where(which == 1, 0.0, xy[:, 0])
    surf = np.stack([x, xy[:, 1], z], -1)
    inner = rng.uniform(0, 1, (n - n_surf, 3)) * size
    xyz = np.concatenate([surf, inner]).astype(np.float32)[None]
    rgb = (0.5 + 0.2 * np.sin(2.0 * xyz)
           + rng.normal(0, 0.03, xyz.shape)).astype(np.float32)
    z = rng.standard_normal((1, n, 13)) * 3.0
    g = np.exp(z - z.max(-1, keepdims=True))
    return xyz, (g / g.sum(-1, keepdims=True)).astype(np.float32), rgb


@pytest.mark.parametrize("b,n", [(1, 1500), (2, 600)])
def test_matfree_lp_matches_jax(b, n):
    """label_propagation_matfree against JAX's (its XLA path on the CPU:
    unsorted, [B, N, K] state). The same Jacobi-preconditioned CG in f32,
    here in Morton order with the affinities summed in another order: the
    iterates drift apart by rounding that the CG's own error level
    (tol 1e-5 relative on the residual) bounds, so the probabilities are
    held to 2e-4 absolute and the argmax to >= 99.9% agreement. The cloud
    is dense (a 1 x 0.6 x 0.8 m corner) at the default bandwidths, so that
    the LP really couples points: it must change >= 5% of the argmaxes
    (7-11% at these seeds), or agreement would show nothing."""
    rng = np.random.default_rng(7 + b)
    clouds = [room_cloud(rng, n, size=(1.0, 0.6, 0.8)) for _ in range(b)]
    xyz, g, rgb = (np.concatenate(c) for c in zip(*clouds))
    want = np.asarray(jlp.label_propagation_matfree(
        jnp.asarray(xyz), jnp.asarray(g), jnp.asarray(rgb)))
    got = label_prop.propagate_batch(torch.tensor(xyz), torch.tensor(g),
                                     torch.tensor(rgb),
                                     solver="cg_matfree").numpy()
    err = np.abs(got - want).max()
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    changed = (got.argmax(-1) != g.argmax(-1)).mean()
    assert err <= 2e-4, err
    assert agree >= 0.999, agree
    assert changed >= 0.05, changed
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_matfree_lp_builds_the_tile_mask_once(monkeypatch):
    """The CG applies W of the same features in every matvec, so the LP
    builds B10's tile mask and its work plan once (matfree_features'
    sorted features) and hands the plan to every launch."""
    calls, plans = [], []
    mask_fn, plan_fn = affinity.skip_mask_t, affinity.tile_plan

    def counting(*a, **kw):
        calls.append(1)
        return mask_fn(*a, **kw)

    def counting_plan(*a, **kw):
        plans.append(1)
        return plan_fn(*a, **kw)
    monkeypatch.setattr(affinity, "skip_mask_t", counting)
    monkeypatch.setattr(affinity, "tile_plan", counting_plan)
    monkeypatch.setattr(label_prop, "tile_plan", counting_plan)
    xyz, g, rgb = room_cloud(np.random.default_rng(10), 700)
    y = label_prop.propagate_batch(torch.tensor(xyz), torch.tensor(g),
                                   torch.tensor(rgb), solver="cg_matfree")
    assert len(calls) == 1 and len(plans) == 1 and y.shape == (1, 700, 13)


def pad_room(xyz, g, rgb, offset, blocks=8):
    """room_label_prop's padding: the cloud as 5 blocks padded to 8 blocks
    of uniform probabilities at room_max + offset."""
    n = xyz.shape[1] // 5
    extra = (blocks - 5) * n
    pad = np.broadcast_to(xyz[0].max(0) + offset, (1, extra, 3))
    return (np.concatenate([xyz, pad], 1).astype(np.float32),
            np.concatenate([g, np.full((1, extra, 13), 1 / 13, np.float32)], 1),
            np.concatenate([rgb, np.zeros((1, extra, 3), np.float32)], 1))


def test_gram_cancellation_limit_accepts_rooms_and_near_pads():
    """ROADMAP C8, accepting side: a 60 m x 3 m hallway (points up to ~30 m
    from their centroid) and a room with room_label_prop's 2 m pads stay
    under the limit, and the padded room's LP leaves the real points as
    the unpadded one does (the pads' affinities underflow to 0)."""
    rng = np.random.default_rng(8)
    hall = rng.uniform(0, 1, (1, 4000, 6)).astype(np.float32) * [60, 3, 3, 1, 1, 1]
    feat = torch.tensor(hall) * torch.tensor([1e3 ** 0.5] * 3 + [10 ** 0.5] * 3)
    assert label_prop.check_gram_cancellation(feat - feat.mean(1, keepdim=True)) < 1.0
    xyz, g, rgb = room_cloud(rng, 500)
    base = label_prop.propagate_batch(torch.tensor(xyz), torch.tensor(g),
                                      torch.tensor(rgb), solver="cg_matfree")
    padded = label_prop.propagate_batch(
        *map(torch.tensor, pad_room(xyz, g, rgb, 2.0)), solver="cg_matfree")
    assert (padded[:, :500].argmax(-1) == base.argmax(-1)).float().mean() >= 0.99


def test_gram_cancellation_limit_rejects_far_pads():
    """ROADMAP C8, rejecting side: the old 1 km pad placement drags the
    centroid hundreds of metres from the pads and the room, and the
    centred Gram's cancellation bound goes far above the limit."""
    rng = np.random.default_rng(9)
    xyz, g, rgb = pad_room(*room_cloud(rng, 500), 1000.0)
    with pytest.raises(ValueError, match="exceeds the limit 1.0"):
        label_prop.propagate_batch(torch.tensor(xyz), torch.tensor(g),
                                   torch.tensor(rgb), solver="cg_matfree")
