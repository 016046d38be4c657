"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (a CUDA kernel
has no CPU or interpret mode). On the GPU machine, which has no JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Shapes are small and ragged (N not a multiple of any tile) to reach the
kernels' edge handling; chip_smoke.py checks the production shapes.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from sweep_rooms import (
    SWEEP_CASES,
    assert_sweep_equal,
    cases_in_turn,
    large_room,
    plain_sweep,
    sweep_on,
    sweep_room,
)
from weaksuppointcloudseg_tpu_torch import configs
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.ops import (
    affinity,
    conv_kmax,
    edgeconv,
    gather,
    knn,
    room_sweep,
    scatter,
    wgather,
)
from weaksuppointcloudseg_tpu_torch.propagate import label_prop

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def randn(gen, shape, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


@pytest.mark.parametrize("b,n,cg,fast,n_valid,c", [
    (3, 701, 3, False, None, 64), (3, 701, 3, True, 600, 64),
    (3, 701, 64, False, 650, 64), (3, 701, 64, True, None, 64),
    (3, 701, 16, False, 650, 37),
    (14, 4096, 3, False, 3001, 64), (14, 4096, 3, True, None, 64),
    (14, 4096, 64, False, None, 64), (14, 4096, 64, True, 3001, 64),
    (64, 2048, 3, False, None, 64), (64, 2048, 64, True, None, 64)])
def test_knn_edge_kernel(gen, b, n, cg, fast, n_valid, c):
    """Indices by agreement rate (f32 sums in another order than cuBLAS:
    exact >= 99.9%, fast >= 98%); y1, extrema and moments against the
    plain formulas at the kernel's own indices (bitwise; moments 1e-5 of
    the sum of magnitudes). Ragged 3 x 701 (C=37: one channel a lane, not
    a pair), and the benchmark cells' shapes: S3DIS blocks (14 x 4096,
    Cg=3 and 64) and ShapeNet training (64 x 2048), with n_valid < N in
    both modes."""
    k = 20
    g, v, u = randn(gen, (b, n, cg)), randn(gen, (b, n, c)), randn(gen, (b, n, c))
    before = edgeconv.knn_edge.launches
    got = edgeconv.knn_edge(g, v, u, k, fast=fast, with_minmax=True,
                            with_values=True, n_valid=n_valid)
    assert edgeconv.knn_edge.launches == before + 1
    want = edgeconv.knn_edge_ref(g, v, u, k, fast=fast, with_minmax=True,
                                 with_values=True, n_valid=n_valid)
    idx = got[0]
    agree = (idx == want[0]).float().mean().item()
    assert agree >= (0.98 if fast else 0.999)
    nv = n if n_valid is None else n_valid
    assert int(idx.max()) < nv
    bi = torch.arange(b, device="cuda")[:, None, None]
    y = (v.float()[bi, idx.long()] + u.float()[:, :, None, :]).to(torch.bfloat16)
    y[:, nv:] = 0
    assert torch.equal(got[1], y)
    y32 = y.float()
    assert torch.equal(got[4], y32.argmax(2).int())
    assert torch.equal(got[6], y32.argmin(2).int())
    assert torch.equal(got[3], y.gather(2, y32.argmax(2, keepdim=True))[:, :, 0])
    mom = torch.stack([y32[:, :nv].sum((0, 1, 2)), (y32[:, :nv] ** 2).sum((0, 1, 2))])
    mags = torch.stack([y32[:, :nv].abs().sum((0, 1, 2)), mom[1]])
    assert bool(((got[2] - mom).abs() <= 1e-5 * mags).all())


@pytest.mark.parametrize("n,cg", [(40, 3), (3000, 128)])
def test_knn_edge_moments_short_rows_and_cap(gen, n, cg):
    """N=40: fewer rows than one block of the tiles and a last group of
    rows cut short; Cg=128 at N=3000, past the old distance-rows cap of
    124, runs (the channels in chunks), and the limit is k: 65 raises
    before any launch. Moments within 1e-5 of the magnitudes at the
    kernel's own indices, two launches bit for bit equal."""
    b, k, c = 1, 20, 64
    g, v, u = randn(gen, (b, n, cg)), randn(gen, (b, n, c)), randn(gen, (b, n, c))
    got = edgeconv.knn_edge(g, v, u, k, fast=True)
    again = edgeconv.knn_edge(g, v, u, k, fast=True)
    assert all(same_bits(x, y) for x, y in zip(got, again))
    bi = torch.arange(b, device="cuda")[:, None, None]
    y = (v.float()[bi, got[0].long()] + u.float()[:, :, None, :]).to(
        torch.bfloat16).float()
    mom = torch.stack([y.sum((0, 1, 2)), (y ** 2).sum((0, 1, 2))])
    mags = torch.stack([y.abs().sum((0, 1, 2)), mom[1]])
    assert bool(((got[2] - mom).abs() <= 1e-5 * mags).all())
    if n == 3000:
        before = edgeconv.knn_edge.launches
        with pytest.raises(ValueError, match=r"k=65 must be in \[1, min\(64"):
            edgeconv.knn_edge(g, v, u, 65, fast=True)
        assert edgeconv.knn_edge.launches == before


def moments_in_kernel_order(y, n_valid):
    """B1's moments of y1 [B,N,k,C] in the kernel's order of f32 adds,
    written out in plain torch (each add one IEEE f32 rounding): each row
    sums its k values in slot order from 0; each group of 8 consecutive
    rows adds its rows in order from 0 (rows past n_valid, and past N,
    add 0) into partial b * ceil(N/8) + row / 8; det_sum.cuh's sum_cols
    then adds the R partials of an element: 8 warps of 32 lanes where
    R >= 2048, else one; lane l of warp w adds partials w*32 + l,
    w*32 + l + 32W, ... in order from 0, the lanes combine by the xor
    butterfly (offsets 16 to 1, lane 0's result) and the warps in order."""
    b, n, k, c = y.shape
    y = y.float()
    rows = []
    for sq in (False, True):
        s = torch.zeros((b, n, c), dtype=torch.float32, device=y.device)
        for j in range(k):
            s = s + (y[:, :, j] * y[:, :, j] if sq else y[:, :, j])
        s[:, n_valid:] = 0.0
        rows.append(s)
    groups = -(-n // 8)
    part = []
    for s in rows:
        s = torch.cat([s, s.new_zeros((b, groups * 8 - n, c))], dim=1)
        s = s.view(b, groups, 8, c)
        p = torch.zeros((b, groups, c), dtype=torch.float32, device=y.device)
        for r in range(8):
            p = p + s[:, :, r]
        part.append(p.reshape(b * groups, c).t())  # [C, R]
    part = torch.cat(part)  # [2C, R]: part[element][partial]
    width, nrows = part.shape
    warps = 8 if nrows >= 2048 else 1
    span = 32 * warps
    steps = -(-nrows // span)
    padded = torch.cat([part, part.new_zeros((width, steps * span - nrows))], 1)
    lanes = torch.zeros((width, span), dtype=torch.float32, device=y.device)
    for t in range(steps):
        lanes = lanes + padded[:, t * span:(t + 1) * span]
    lanes = lanes.view(width, warps, 32)
    ids = torch.arange(32, device=y.device)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, :, ids ^ off]
    total = lanes[:, 0, 0]
    for w in range(1, warps):
        total = total + lanes[:, w, 0]
    return total.view(2, c)


@pytest.mark.parametrize("b,n,cg,fast,n_valid,c", [
    (3, 701, 64, False, 650, 64), (1, 45, 3, True, None, 37),
    (14, 4096, 3, True, 3001, 64), (64, 2048, 64, False, None, 64)])
def test_knn_edge_moment_order(gen, b, n, cg, fast, n_valid, c):
    """B1's moments equal, bit for bit, the fixed order written out in
    plain torch (moments_in_kernel_order) at the kernel's own indices:
    per-row sums over the k slots in order, partials of 8 rows in order,
    then det_sum.cuh's sum_cols order, with one warp per element (3 x 701,
    1 x 45: the last group cut short, C=37 a channel a lane) and eight
    (14 x 4096, 64 x 2048)."""
    k = 20
    g, v, u = randn(gen, (b, n, cg)), randn(gen, (b, n, c)), randn(gen, (b, n, c))
    idx, y, mom = edgeconv.knn_edge(g, v, u, k, fast=fast, n_valid=n_valid)
    nv = n if n_valid is None else n_valid
    bi = torch.arange(b, device="cuda")[:, None, None]
    want_y = (v.float()[bi, idx.long()] + u.float()[:, :, None, :]).to(
        torch.bfloat16)
    want_y[:, nv:] = 0
    assert torch.equal(y, want_y)
    assert same_bits(mom, moments_in_kernel_order(want_y, nv))


@pytest.mark.parametrize("c1,c2,fold", [(64, 64, True), (64, 128, False),
                                        (128, 96, True)])
def test_conv_zmax_kernel(gen, c1, c2, fold):
    """One bf16 ulp of y before BN2 (another f32 summation order) bounds
    |out - ref| by 2^-6 |ref| + 2^-7 |t2|."""
    h1 = randn(gen, (2, 333, 20, c1))
    w2 = randn(gen, (c1, c2), scale=0.2)
    b2, s2, t2 = (randn(gen, (c2,), torch.float32) for _ in range(3))
    sc1, sh1 = ((randn(gen, (c1,), torch.float32),
                 randn(gen, (c1,), torch.float32)) if fold else (None, None))
    got = conv_kmax.conv_zmax(h1, w2, b2, s2, t2, sc1, sh1)
    want = conv_kmax.conv_zmax_ref(h1, w2, b2, s2, t2, sc1, sh1)
    tol = 2.0 ** -6 * want.float().abs() + 2.0 ** -7 * t2.abs()
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("c1,n_valid", [(192, None), (128, 1000), (40, 5)])
def test_conv_znmax_kernel(gen, c1, n_valid):
    """|out - ref| <= 2^-7 (|ref| + |t2|): one bf16 ulp of y through s2."""
    h = randn(gen, (3, 1111, c1))
    w = randn(gen, (c1, 1024), scale=0.1)
    b, s2, t2 = (randn(gen, (1024,), torch.float32) for _ in range(3))
    got = conv_kmax.conv_znmax(h, w, b, s2, t2, n_valid=n_valid)
    want = conv_kmax.conv_znmax_ref(h, w, b, s2, t2, n_valid=n_valid)
    assert bool(((got - want).abs() <= 2.0 ** -7 * (want.abs() + t2.abs()) + 1e-6).all())


def test_wrappers_raise_on_bad_operands(gen):
    g = randn(gen, (1, 64, 3))
    with pytest.raises(ValueError, match="dtype"):
        edgeconv.knn_edge(g.float(), g, g, 4, fast=False)
    with pytest.raises(ValueError, match="contiguous"):
        edgeconv.knn_edge(g.transpose(1, 2), g, g, 4, fast=False)
    h = randn(gen, (1, 8, 4, 32))
    w = randn(gen, (32, 64))
    v = torch.zeros(64, device="cuda")
    with pytest.raises(ValueError, match="C1=32"):
        conv_kmax.conv_zmax(h, w, v, v, v)


@pytest.mark.parametrize("c,k,fast", [(3, 20, False), (3, 20, True),
                                      (64, 20, False), (64, 10, True),
                                      (5, 7, False)])
def test_knn_kernel(gen, c, k, fast):
    """B12 against knn_ref on the same f32 points: index agreement >= 99.9%
    exact (the Gram sums in another order than cuBLAS's, which can reorder
    exact near-ties), >= 98% fast; the selected distances against the
    plain formula at the kernel's own indices (exact: 1e-5 of the
    distance scale; fast: the dropped idx_bits)."""
    b, n = 3, 701
    x = torch.randn((b, n, c), generator=gen, device="cuda")
    before = knn.knn.launches
    idx, sqd = knn.knn(x, k, fast=fast, with_values=True)
    assert knn.knn.launches == before + 1
    want = knn.knn_ref(x, k, fast=fast)
    agree = (idx == want).float().mean().item()
    assert agree >= (0.98 if fast else 0.999), agree
    d = knn.distances(x)
    d_sel = torch.gather(d, 2, idx.long())
    if fast:
        d_sel = d_sel.clamp_min(0.0)
    scale = d.abs().max().item()
    tol = scale * (2.0 ** (knn.idx_bits(n) - 23) if fast else 1e-5)
    assert (sqd - d_sel).abs().max().item() <= tol
    assert torch.equal(knn.knn(x, k, fast=fast), idx)


@pytest.mark.parametrize("fast", [False, True])
def test_knn_kernel_nan_point(gen, fast):
    """A point with NaN features, as after a diverged step: its distance
    row is all NaN and its column is NaN in every other row. The kernel
    puts NaN after every number, in column order, as knn_ref's stable
    sort does: every index stays in range, the NaN row selects 0..k-1
    with NaN values, and no other row selects the NaN point."""
    b, n, c, k = 2, 301, 8, 12
    x = torch.randn((b, n, c), generator=gen, device="cuda")
    x[1, 17] = float("nan")
    idx, sqd = knn.knn(x, k, fast=fast, with_values=True)
    want = knn.knn_ref(x, k, fast=fast)
    torch.cuda.synchronize()
    assert int(idx.min()) >= 0 and int(idx.max()) < n
    assert torch.equal(idx[1, 17], torch.arange(k, device="cuda", dtype=torch.int32))
    assert bool(sqd[1, 17].isnan().all())
    others = torch.ones((b, n), dtype=torch.bool, device="cuda")
    others[1, 17] = False
    assert not bool((idx[1][others[1]] == 17).any())
    assert bool(sqd[others].isfinite().all())
    agree = (idx == want).float().mean().item()
    assert agree >= (0.98 if fast else 0.999), agree


def b1_points(gen, b, n, c, case="random"):
    """(bf16 g, the same points widened to f32) for B12-vs-B1 checks:
    "duplicates" copies point 3 to n // 2 and n - 1 in every cloud (exact
    ties) and clumps points 100-139 of cloud 0 onto point 10; "nan" gives
    point 17 of cloud 1 NaN features."""
    g = randn(gen, (b, n, c))
    if case == "duplicates":
        g[:, n // 2] = g[:, 3]
        g[:, n - 1] = g[:, 3]
        g[0, 100:140] = g[0, 10]
    elif case == "nan":
        g[1, 17] = float("nan")
    return g, g.float()


def same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("case", ["random", "duplicates", "nan"])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("c", [3, 5, 64, 128, 130])
def test_knn_kernel_equals_b1s(gen, c, fast, case):
    """B12 on bf16-representable f32 points selects kernel B1's graph on
    the same bf16 g, bit for bit in idx and sqd (NaN bits included): the
    same norms, fmaf chains, combine and keys, and the k smallest of the
    same total order. N=999 is not a multiple of any tile; C=128 and 130
    walk the channels in chunks (16-byte and 4-byte copies); duplicated
    points tie exactly and come lowest index first."""
    b, n, k = 2, 999, 20
    g, x = b1_points(gen, b, n, c, case)
    v = u = randn(gen, (b, n, 8))
    idx, sqd = knn.knn(x, k, fast=fast, with_values=True)
    b1 = edgeconv.knn_edge(g, v, u, k, fast=fast, with_values=True)
    torch.cuda.synchronize()
    assert torch.equal(idx, b1[0])
    assert same_bits(sqd, b1[-1])
    if case == "duplicates":
        copies = torch.tensor([3, n // 2, n - 1], device="cuda",
                              dtype=torch.int32)
        assert torch.equal(idx[:, 3, :3], copies.expand(b, 3))
    if case == "nan":
        assert torch.equal(idx[1, 17], torch.arange(k, device="cuda",
                                                    dtype=torch.int32))


@pytest.mark.parametrize("n,k", [(999, 1), (999, 32), (999, 64), (50, 50)])
@pytest.mark.parametrize("fast", [False, True])
def test_knn_kernels_k_range(gen, n, k, fast):
    """k from 1 to B12's limit of 64, and k = N: B12 (and B15 up to its
    limit of 32) equal B1 bit for bit on the same bf16 g and agree with
    the plain version by the usual rates; at k = N every row lists every
    point once."""
    from weaksuppointcloudseg_tpu_torch.ops import knn_gather as kg

    b = 2
    g, x = b1_points(gen, b, n, 16)
    v = u = randn(gen, (b, n, 8))
    idx, sqd = knn.knn(x, k, fast=fast, with_values=True)
    b1 = edgeconv.knn_edge(g, v, u, k, fast=fast, with_values=True)
    torch.cuda.synchronize()
    assert torch.equal(idx, b1[0]) and same_bits(sqd, b1[-1])
    if k <= kg.K_MAX:
        i15, _, s15 = kg.knn_gather_with_sqdist(g, v, k, fast=fast)
        assert torch.equal(i15, idx) and same_bits(s15, sqd)
    want = knn.knn_ref(x, k, fast=fast)
    agree = (idx == want).float().mean().item()
    assert agree >= (0.98 if fast else 0.999), agree
    if k == n:
        assert torch.equal(idx.sort(-1).values, torch.arange(
            n, device="cuda", dtype=torch.int32).expand(b, n, n))


@pytest.mark.parametrize("fast", [False, True])
def test_knn_kernels_past_the_old_cap(gen, fast):
    """N=6000 at C=64, past the 4,851 points the distance-rows design fit
    in shared memory: B12 and B15 against their plain versions by the
    usual agreement rates, B15's rows bitwise at its own indices."""
    from weaksuppointcloudseg_tpu_torch.ops import knn_gather as kg

    b, n, c, k = 2, 6000, 64, 20
    x = torch.randn((b, n, c), generator=gen, device="cuda")
    idx = knn.knn(x, k, fast=fast)
    agree = (idx == knn.knn_ref(x, k, fast=fast)).float().mean().item()
    assert agree >= (0.98 if fast else 0.999), agree
    g, f = randn(gen, (b, n, c)), randn(gen, (b, n, c))
    idx, nbr = kg.knn_gather(g, f, k, fast=fast)
    want = kg.knn_gather_ref(g, f, k, fast=fast)[0]
    agree = (idx == want).float().mean().item()
    assert agree >= (0.98 if fast else 0.999), agree
    assert torch.equal(nbr, gather.gather_rows_ref(f, idx))


def test_knn_kernel_refuses(gen):
    """k above B12's limit of 64, or above N, raises before any launch."""
    x = torch.randn((1, 100, 3), generator=gen, device="cuda")
    before = knn.knn.launches
    with pytest.raises(ValueError, match=r"k=65 must be in \[1, min\(64"):
        knn.knn(x, 65)
    with pytest.raises(ValueError, match=r"k=101 .*N=100"):
        knn.knn(x[:, :100], 101)
    assert knn.knn.launches == before


@pytest.mark.parametrize("fast", [False, True])
def test_knn_edge_kernel_nan_point(gen, fast):
    """B1 with a NaN point in g: the same order as B12 (NaN after every
    number, in column order), so the y1 gather stays in range and equals
    v[idx] + u at the kernel's own indices."""
    b, n, k, c = 2, 301, 12, 64
    g, v, u = randn(gen, (b, n, 16)), randn(gen, (b, n, c)), randn(gen, (b, n, c))
    g[0, 5] = float("nan")
    idx, y = edgeconv.knn_edge(g, v, u, k, fast=fast)[:2]
    want = edgeconv.knn_edge_ref(g, v, u, k, fast=fast)[0]
    torch.cuda.synchronize()
    assert int(idx.min()) >= 0 and int(idx.max()) < n
    assert torch.equal(idx[0, 5], torch.arange(k, device="cuda", dtype=torch.int32))
    rows = torch.arange(n, device="cuda") != 5
    assert not bool((idx[0, rows] == 5).any())
    bi = torch.arange(b, device="cuda")[:, None, None]
    assert torch.equal(y, (v.float()[bi, idx.long()] + u.float()[:, :, None, :]).to(
        torch.bfloat16))
    agree = (idx == want).float().mean().item()
    assert agree >= (0.98 if fast else 0.999), agree


@pytest.mark.parametrize("c,n", [(64, 300), (3, 1000)])
def test_scatter_add_kernel(gen, c, n):
    """B13 against index_add_ within 1e-5 of the sum of magnitudes of each
    output element (ROADMAP C4's tolerance, kept; the kernel now equals
    the plain version bit for bit: test_scatter_add_kernel_bitwise)."""
    b, p, k = 2, 333, 20
    idx = torch.randint(0, n, (b, p, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    g = torch.randn((b, p, k, c), generator=gen, device="cuda")
    before = scatter.scatter_add.launches
    got = scatter.scatter_add(idx, g, n)
    assert scatter.scatter_add.launches == before + 1
    want = scatter.scatter_add_ref(idx, g, n)
    mags = scatter.scatter_add_ref(idx, g.abs(), n)
    assert bool(((got - want).abs() <= 1e-5 * mags + 1e-6).all())


def test_train_step_on_cuda_matches_cpu(gen):
    """One f32 Full-style training step of a narrow ShapeNet model on the
    card (B12, B13) against the same step over the plain versions on the
    CPU, same weights and batch: loss components rtol 1e-3; gradients
    within 1e-2 of each leaf's largest plus 1e-4 of the overall largest
    (cuBLAS and the kernels sum in other orders; the conv biases in front
    of a BN have zero true gradient and rounding-noise computed ones)."""
    from weaksuppointcloudseg_tpu_torch.train.steps import loss_fn

    cfg = configs.shapenet_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_classes=12, num_categories=4, k=8,
        edge_channels=((16, 16), (16, 16), (16,)), global_channels=64,
        category_embed_channels=8, head_channels=(32, 32, 16),
        head_keep_prob=(None, None, None)),
        weaksup=dataclasses.replace(cfg.weaksup, smooth_knn=4))
    g = torch.Generator().manual_seed(0)
    batch = {"data": torch.randn((4, 300, 3), generator=g) * 0.5,
             "seg_onehot": torch.eye(12)[torch.randint(0, 12, (4, 300), generator=g)],
             "mask": (torch.rand((4, 300), generator=g) < 0.3).float(),
             "cat_onehot": torch.eye(4)[[0, 0, 2, 2]]}
    outs = []
    for dev in ("cpu", "cuda"):
        model = DGCNNSeg(cfg.model, seed=1).to(dev)
        counts = (knn.knn.launches, scatter.scatter_add.launches)
        total, comps, _ = loss_fn(model, {k: v.to(dev) for k, v in batch.items()},
                                  cfg=cfg, style="Full", bn_decay=0.5, gate=1.0)
        total.backward()
        if dev == "cuda":
            # 5 graphs (transform, 3 stages, smooth loss); the backward of
            # the 3 stages' gathers and of the smooth loss's gather
            assert (knn.knn.launches - counts[0],
                    scatter.scatter_add.launches - counts[1]) == (5, 4)
        outs.append(({k: float(v.detach()) for k, v in comps.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (want_c, want_g), (got_c, got_g) = outs
    for k in want_c:
        assert got_c[k] == pytest.approx(want_c[k], rel=1e-3), k
    scale = max(v.abs().max().item() for v in want_g.values())
    for name, w in want_g.items():
        err = (got_g[name] - w).abs().max().item()
        assert err <= 1e-2 * w.abs().max().item() + 1e-4 * scale, name


def ints(gen, shape, lo=-3, hi=4, dtype=torch.bfloat16):
    """Small integers: every product and sum is exact in f32 whatever the
    order, so a kernel must equal its plain version bitwise, ties (many
    among small integers) included."""
    return torch.randint(lo, hi, shape, generator=gen, device="cuda").to(dtype)


def within_sums(got, want, mags, tol=1e-5, atol=1e-6):
    """f32 sums in another order: tol of the sum of magnitudes."""
    assert bool(((got - want).abs() <= tol * mags + atol).all())


@pytest.mark.parametrize("c2,exact", [(64, False), (128, False), (96, False),
                                      (128, True)])
def test_conv_minmax_kernel(gen, c2, exact):
    """B2: exact inputs bitwise; random ones: extrema within one bf16 ulp
    of y, the plain y at the kernel's slot equal to the kernel's extremum
    within an ulp, slots agreeing on >= 99%, moments 1e-5 of the sums of
    magnitudes."""
    c1 = 64
    shape = (2, 333, 20, c1)
    if exact:
        h1, w2, b2 = ints(gen, shape), ints(gen, (c1, c2), -1, 2), ints(
            gen, (c2,), dtype=torch.float32)
        sc1 = torch.tensor([-1.0, 0.5, 1.0, 2.0], device="cuda")[
            torch.randint(0, 4, (c1,), generator=gen, device="cuda")]
        sh1 = ints(gen, (c1,), -1, 2, torch.float32)
    else:
        h1, w2 = randn(gen, shape), randn(gen, (c1, c2), scale=0.2)
        b2 = randn(gen, (c2,), torch.float32)
        sc1, sh1 = randn(gen, (c1,), torch.float32), randn(gen, (c1,), torch.float32)
    before = conv_kmax.conv_minmax.launches
    got = conv_kmax.conv_minmax(h1, w2, b2, sc1, sh1)
    assert conv_kmax.conv_minmax.launches == before + 1
    want = conv_kmax.conv_minmax_ref(h1, w2, b2, sc1, sh1)
    y = (torch.matmul(conv_kmax._act(h1, sc1, sh1), w2.float()) + b2).to(
        torch.bfloat16).float()
    within_sums(got[4], want[4], torch.stack([y.abs().sum((0, 1, 2)),
                                              (y * y).sum((0, 1, 2))]))
    if exact:
        for g, w in zip(got[:4], want[:4]):
            assert torch.equal(g, w)
        return
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        assert torch.allclose(g.float(), w.float(), rtol=2.0 ** -7, atol=1e-6)
    for a, ext in ((got[1], got[0]), (got[3], got[2])):
        at = torch.gather(y, 2, a.long()[:, :, None])[:, :, 0]
        assert torch.allclose(at, ext.float(), rtol=2.0 ** -7, atol=1e-6)
    assert (got[1] == want[1]).float().mean().item() >= 0.99


@pytest.mark.parametrize("c1,n,exact", [(192, 1111, False), (128, 700, True),
                                         (64, 37, False)])
def test_conv_nmax_kernel(gen, c1, n, exact):
    """B5 forward, as B2's test: the lowest row wins ties across the
    kernel's row splits (exact inputs)."""
    if exact:
        h, w = ints(gen, (3, n, c1), 0, 2), ints(gen, (c1, 1024), -1, 2)
        b = ints(gen, (1024,), dtype=torch.float32)
    else:
        h, w = randn(gen, (3, n, c1)), randn(gen, (c1, 1024), scale=0.1)
        b = randn(gen, (1024,), torch.float32)
    before = conv_kmax.conv_nmax.launches
    got = conv_kmax.conv_nmax(h, w, b)
    assert conv_kmax.conv_nmax.launches == before + 1
    want = conv_kmax.conv_nmax_ref(h, w, b)
    y = (torch.matmul(h.float(), w.float()) + b).to(torch.bfloat16).float()
    within_sums(got[4], want[4], torch.stack([y.abs().sum((0, 1)),
                                              (y * y).sum((0, 1))]))
    if exact:
        assert bool(((y == y.amax(1, keepdim=True)).sum(1) > 1).any())
        for g, w_ in zip(got[:4], want[:4]):
            assert torch.equal(g, w_)
        return
    for g, w_ in ((got[0], want[0]), (got[2], want[2])):
        assert torch.allclose(g, w_, rtol=2.0 ** -7, atol=1e-6)
    for a, ext in ((got[1], got[0]), (got[3], got[2])):
        assert torch.allclose(torch.gather(y, 1, a.long()[:, None])[:, 0], ext,
                              rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("c2,exact", [(128, False), (64, False), (64, True),
                                      (128, True)])
def test_conv_kmax_bwd_kernel(gen, c2, exact):
    """B3 at an odd point count: exact inputs bitwise; random ones: dz
    within one bf16 ulp (f32 sums in another order, then one rounding),
    the reductions 1e-5 of the sums of magnitudes (f32 sums in another
    order)."""
    b, n, k, c1 = 2, 301, 20, 64
    if exact:
        y1, q = ints(gen, (b, n, k, c1)), ints(gen, (b, n, c2), dtype=torch.float32)
        w2t, m = ints(gen, (c2, c1), -1, 2), ints(gen, (c1, c1), -1, 2)
        row0 = ints(gen, (c1,), dtype=torch.float32)
        pick = lambda vals: torch.tensor(vals, device="cuda")[
            torch.randint(0, len(vals), (c1,), generator=gen, device="cuda")]
        consts = (pick([-1.0, 0.5, 1.0, 2.0]), ints(gen, (c1,), -1, 2, torch.float32),
                  ints(gen, (c1,), -1, 2, torch.float32), pick([0.5, 1.0, 2.0]))
    else:
        y1, q = randn(gen, (b, n, k, c1)), randn(gen, (b, n, c2), torch.float32)
        w2t, m = randn(gen, (c2, c1), scale=0.2), randn(gen, (c1, c1), scale=0.1)
        row0 = randn(gen, (c1,), torch.float32, 0.1)
        consts = tuple(randn(gen, (c1,), torch.float32) for _ in range(3)) + (
            torch.rand((c1,), generator=gen, device="cuda") + 0.5,)
    asel = torch.randint(0, k, (b, n, c2), generator=gen, device="cuda",
                         dtype=torch.int32)
    before = conv_kmax.conv_kmax_bwd.launches
    got = conv_kmax.conv_kmax_bwd(y1, q, asel, w2t, m, row0, *consts)
    assert conv_kmax.conv_kmax_bwd.launches == before + 1
    want = conv_kmax.conv_kmax_bwd_ref(y1, q, asel, w2t, m, row0, *consts)
    if exact:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        return
    scale = want[0].float().abs().max()
    assert torch.allclose(got[0].float(), want[0].float(), rtol=2.0 ** -7,
                          atol=1e-5 * scale.item())
    h = conv_kmax._act(y1, *consts[:2]).abs()
    dq = q.to(torch.bfloat16).float().abs()
    onek = asel[:, :, None, :] == torch.arange(k, device="cuda")[:, None]
    within_sums(got[1], want[1], torch.einsum("bnji,bnjc->ic", h, onek * dq[:, :, None]))
    within_sums(got[2], want[2], torch.einsum("bnji,bnjl->il", h, h))
    within_sums(got[3], want[3], h.sum((0, 1, 2)))
    dz = want[0].float().abs()
    xhat = (y1.float().abs() + consts[2].abs()) * consts[3]
    within_sums(got[4], want[4], torch.stack([dz.sum((0, 1, 2)),
                                              (dz * xhat).sum((0, 1, 2))]))


@pytest.mark.parametrize("c2", [64, 128])
def test_conv_kmax_bwd_same_bits_at_two_grids(gen, c2):
    """B3's sums do not depend on the grid (ROADMAP C17): a launch on 66
    persistent blocks gives the bits of a launch on one block per SM, at a
    shape of more tiles than partial rows (2 x 2048 points: 512 tiles,
    264 rows)."""
    b, n, k, c1 = 2, 2048, 20, 64
    vec = [randn(gen, (c1,), torch.float32) for _ in range(5)]
    vec[4] = vec[4].abs() + 0.5
    args = (randn(gen, (b, n, k, c1)), randn(gen, (b, n, c2), torch.float32),
            torch.randint(0, k, (b, n, c2), generator=gen, device="cuda",
                          dtype=torch.int32),
            randn(gen, (c2, c1), scale=0.2), randn(gen, (c1, c1), scale=0.05),
            *vec)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert conv_kmax.kmax_bwd_plan(b * n, sms) == (264, min(264, sms))
    got = conv_kmax.conv_kmax_bwd(*args)
    other = conv_kmax._kmax_bwd(*args, grid=66)
    assert len(got) == len(other)
    for a, o in zip(got, other):
        assert same_bits(a, o)  # (defined with the fixed-order tests below)


def on_grid(gen, shape, scale, step, lim, dtype=torch.float32):
    """Normal values rounded to multiples of ``step``, at most ``lim``
    steps from 0."""
    x = torch.randn(shape, generator=gen, device="cuda") * (scale / step)
    return (x.round().clamp(-lim, lim) * step).to(dtype)


@pytest.mark.parametrize("c1,n,inputs", [(192, 2048, "grid"), (128, 333, "grid"),
                                          (64, 129, "ints"), (192, 2048, "ints")])
def test_conv_nmax_bwd_kernel(gen, c1, n, inputs):
    """B5 backward on the tensor cores. Small integers: bitwise, which
    pins the rounding of dy to bf16 before the products. Grid inputs: h on
    a 2^-7 grid below 2, w on a 2^-6 grid, the bias on their products'
    2^-13 grid, so y = h @ W + b is exact in f32 in any order and the
    kernel rounds the same y (and dy) as the plain version; then dh is
    held to one bf16 ulp of its exact value plus 1e-5 of the sum of its
    terms' magnitudes, dW and db to 1e-5 of theirs, the magnitudes taken
    from the true cotangent (q at its row only)."""
    b, c2 = 2, 1024
    if inputs == "ints":
        h, w = ints(gen, (b, n, c1), 0, 2), ints(gen, (c1, c2), -1, 2)
        bias, q = ints(gen, (c2,), dtype=torch.float32), ints(gen, (b, c2), dtype=torch.float32)
        al = ints(gen, (c2,), dtype=torch.float32)
        be = torch.tensor([-0.5, 0.25, 1.0], device="cuda")[
            torch.randint(0, 3, (c2,), generator=gen, device="cuda")]
    else:
        h = on_grid(gen, (b, n, c1), 1.0, 2.0 ** -7, 255, torch.bfloat16)
        w = on_grid(gen, (c1, c2), 0.1, 2.0 ** -6, 127, torch.bfloat16)
        bias = on_grid(gen, (c2,), 0.1, 2.0 ** -13, 2 ** 13)
        q, al, be = (randn(gen, s, torch.float32, 0.1)
                     for s in ((b, c2), (c2,), (c2,)))
    asel = torch.randint(0, n, (b, c2), generator=gen, device="cuda",
                         dtype=torch.int32)
    before = conv_kmax.conv_nmax_bwd.launches
    got = conv_kmax.conv_nmax_bwd(h, q, asel, w, bias, al, be)
    assert conv_kmax.conv_nmax_bwd.launches == before + 1
    if inputs == "ints":
        for g, w_ in zip(got, conv_kmax.conv_nmax_bwd_ref(h, q, asel, w, bias,
                                                          al, be)):
            assert torch.equal(g, w_)
        return
    dy, dyc = conv_kmax.nmax_bwd_cotangent(h, q, asel, w, bias, al, be)
    h64, w64, d64 = h.double(), w.double(), dyc.double()
    dh = d64 @ w64.t()
    assert bool(((got[0].double() - dh).abs()
                 <= 2.0 ** -7 * dh.abs() + 1e-5 * (d64.abs() @ w64.abs().t())).all())
    dw = torch.einsum("bni,bno->io", h64, d64)
    within_sums(got[1].double(), dw, torch.einsum("bni,bno->io", h64.abs(), d64.abs()),
                atol=0.0)
    within_sums(got[2].double(), dy.double().sum((0, 1)),
                dy.double().abs().sum((0, 1)), atol=0.0)


@pytest.mark.parametrize("sparse", [False, True])
def test_scatter_bn_bwd_kernel(gen, sparse):
    """B4 against its plain version: du sums the same f32 dy in slot order
    (1e-6 of the magnitudes), dv within 1e-5 (ROADMAP C4's tolerances, kept;
    both are bit for bit the plain version's:
    test_scatter_bn_bwd_kernel_bitwise)."""
    b, p, k, n, c = 2, 333, 20, 300, 64
    idx = torch.randint(0, n, (b, p, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    y = randn(gen, (b, p, k, c))
    sv, al, be = (randn(gen, (c,), torch.float32) for _ in range(3))
    if sparse:
        q = randn(gen, (b, p, c), torch.float32)
        asel = torch.randint(0, k, (b, p, c), generator=gen, device="cuda",
                             dtype=torch.int32)
        big, first = (q, asel), torch.where(
            asel[:, :, None, :] == torch.arange(k, device="cuda")[:, None],
            q[:, :, None, :], 0.0)
    else:
        big = randn(gen, (b, p, k, c))
        first = sv * big.float()
    before = scatter.scatter_bn_bwd.launches
    dv, du = scatter.scatter_bn_bwd(idx, y, big, sv, al, be, n)
    assert scatter.scatter_bn_bwd.launches == before + 1
    want_dv, want_du = scatter.scatter_bn_bwd_ref(idx, y, big, sv, al, be, n)
    mag = first.abs() + al.abs() + (be * y.float()).abs()
    within_sums(du, want_du, mag.sum(2), tol=1e-6)
    within_sums(dv, want_dv, scatter.scatter_add_ref(idx, mag, n))


def test_fused_train_step_on_cuda_matches_cpu(gen):
    """One Plain-style bf16 step of a narrow ShapeNet model through the
    fused blocks on the card (B1-B5) against the same step over the plain
    versions on the CPU, the CPU replaying the card's kNN indices and BN
    moments (utils/replay.py: without it the moments, summed in another
    order than the CPU's, move later stages' neighbours among near-ties). Each fused block rerun on
    its own at the step's inputs and cotangents: output and every input
    gradient within 1e-2 (worst reading on the card 5.4e-4). The whole
    step, where one-ulp differences grow in the batch-moment BNs: loss
    rtol 2e-3, logits 0.1 relative RMS, every leaf within 0.6 of its norm
    (worst reading 0.18 at this narrow width, scripts/
    torch_step_agreement.py) and the null-gradient biases within 1e-2 of
    the largest leaf norm; agg_conv.beta, rounding noise at 2 clouds, at
    the block level only (chip_smoke.py phase 5)."""
    from weaksuppointcloudseg_tpu_torch.losses.weaksup import masked_softmax_ce
    from weaksuppointcloudseg_tpu_torch.utils import replay

    cfg = dataclasses.replace(
        configs.shapenet_config().model, num_classes=12, num_categories=4,
        global_channels=128, category_embed_channels=8,
        head_channels=(32, 32, 16), head_keep_prob=(None, None, None),
        compute_dtype="bfloat16", knn_fast=True)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 300, 3), generator=g) * 0.5
    onehot = torch.eye(12)[torch.randint(0, 12, (2, 300), generator=g)]
    mask = (torch.rand((2, 300), generator=g) < 0.3).float()
    cat = torch.eye(4)[[0, 2]]
    kernels = (edgeconv.knn_edge, conv_kmax.conv_minmax, conv_kmax.conv_nmax,
               conv_kmax.conv_kmax_bwd, conv_kmax.conv_nmax_bwd,
               scatter.scatter_bn_bwd)
    outs, tape, blocks = [], None, None
    for dev in ("cuda", "cpu"):
        model = DGCNNSeg(cfg, seed=1).to(dev)
        counts = [fn.launches for fn in kernels]
        cuda = dev == "cuda"
        with (replay.record() if cuda else replay.replay(tape)) as t, \
                (replay.record_blocks() if cuda else contextlib.nullcontext()) as b:
            logits = model(x.to(dev), cat.to(dev), training=True, bn_decay=0.5) \
                if cuda else model.forward_fused(x, cat, training=True,
                                                 bn_decay=0.5)
        tape, blocks = tape or t, blocks or b
        loss = masked_softmax_ce(logits, onehot.to(dev), mask.to(dev))
        loss.backward()
        if cuda:
            # transform stage + 3 EdgeConv stages; 3 two-conv stages; 2
            # N-max blocks; their backwards; 4 stage backward scatters
            assert [fn.launches - c for fn, c in zip(kernels, counts)] == [
                4, 3, 2, 3, 2, 4]
        outs.append((float(loss.detach()), logits.detach().float().cpu(),
                     {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (got_l, got_lg, got_g), (want_l, want_lg, want_g) = outs
    assert len(blocks) == 6
    for entry in blocks:
        errs = replay.block_errors(entry)
        assert max(errs.values()) <= 1e-2, (entry["block"].__name__, errs)
    errs, null = replay.grad_errors(model, got_g, want_g)
    assert abs(got_l - want_l) <= 2e-3 * abs(want_l)
    assert (got_lg - want_lg).norm() <= 0.1 * want_lg.norm()
    for name, e in errs.items():
        if name != "agg_conv.beta":
            assert e <= (1e-2 if name in null else 0.6), (name, e)


def test_model_gate_on_cuda(gen):
    """bf16 + fused kNN runs the fused kernels (counters grow) and agrees
    with the same composition over the plain versions on the CPU; its
    Full-style loss runs B6; f32 + use_fused_knn runs B12 at eval and
    agrees with the CPU; without the fused kNN bf16 gathers through B14
    and f32 by indexing, neither selecting with B1 or B12
    (test_unfused_forward_on_cuda holds them to the CPU)."""
    cfg = dataclasses.replace(configs.shapenet_config().model,
                              compute_dtype="bfloat16", knn_fast=True)
    model = DGCNNSeg(cfg).eval()
    x = torch.randn((2, 500, 3), generator=gen, device="cuda") * 0.4
    cat = torch.eye(16, device="cuda")[[2, 9]]
    counts = (edgeconv.knn_edge.launches, conv_kmax.conv_zmax.launches,
              conv_kmax.conv_znmax.launches)
    with torch.inference_mode():
        got = torch.softmax(model.cuda()(x, cat), -1)
        want = torch.softmax(model.cpu().forward_fused(x.cpu(), cat.cpu()), -1)
    assert (edgeconv.knn_edge.launches - counts[0],
            conv_kmax.conv_zmax.launches - counts[1],
            conv_kmax.conv_znmax.launches - counts[2]) == (4, 3, 2)
    agree = (got.argmax(-1).cpu() == want.argmax(-1)).float().mean().item()
    assert agree >= 0.99
    f32_cfg = dataclasses.replace(cfg, compute_dtype="float32", knn_fast=False)
    f32 = DGCNNSeg(f32_cfg)
    before = knn.knn.launches
    with torch.inference_mode():
        want = torch.softmax(f32(x.cpu(), cat.cpu()), -1)
        got = torch.softmax(f32.cuda()(x, cat), -1)
    assert knn.knn.launches - before == 4
    agree = (got.argmax(-1).cpu() == want.argmax(-1)).float().mean().item()
    assert agree >= 0.99 and (got.cpu() - want).abs().max().item() <= 1e-3
    from weaksuppointcloudseg_tpu_torch.train.steps import loss_fn

    full = configs.shapenet_config()
    full = dataclasses.replace(full, model=cfg)
    batch = {"data": x, "cat_onehot": cat, "seg_onehot": torch.zeros(
        (2, 500, 50), device="cuda"), "mask": torch.ones((2, 500), device="cuda")}
    # the bf16 Full-style loss runs the fused smoothness loss over the
    # transform stage's graph: B6's gather forward, its scatter backward
    before = (wgather.wgather_pre.launches, wgather.knn_wgather.launches,
              scatter.scatter_add_weighted.launches)
    total, comps, _ = loss_fn(model.cuda().train(), batch, cfg=full,
                              style="Full", bn_decay=0.5, gate=1.0)
    total.backward()
    assert (wgather.wgather_pre.launches - before[0],
            wgather.knn_wgather.launches - before[1],
            scatter.scatter_add_weighted.launches - before[2]) == (1, 0, 1)
    assert all(bool(torch.isfinite(v)) for v in comps.values())
    for c, b14 in ((cfg, 4), (f32_cfg, 0)):
        unfused = DGCNNSeg(dataclasses.replace(c, use_fused_knn=False)).cuda()
        before = (gather.gather_rows.launches, edgeconv.knn_edge.launches,
                  knn.knn.launches)
        with torch.inference_mode():
            out = unfused.eval()(x, cat)
        assert bool(torch.isfinite(out).all())
        assert (gather.gather_rows.launches - before[0],
                edgeconv.knn_edge.launches - before[1],
                knn.knn.launches - before[2]) == (b14, 0, 0)


def mag_sum_ok(got, want, mags, tol=1e-5):
    """|got - want| within ``tol`` of the sum of magnitudes of each element
    (f32 sums in another order, ROADMAP C4)."""
    return bool(((got - want).abs() <= tol * mags + 1e-7).all())


@pytest.mark.parametrize("c,n", [(51, 333), (14, 1001)])
def test_scatter_add_weighted_kernel(gen, c, n):
    """B6's scatter against its plain version (index_add_ of the expanded
    w * ct) within ROADMAP C4's tolerance, kept (bit for bit:
    test_scatter_add_weighted_kernel_bitwise): 1e-5 of the sum
    of magnitudes sum |w| |ct| of each output element."""
    b, p, k = 2, n, 10
    idx = torch.randint(0, n, (b, p, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    w = torch.rand((b, p, k), generator=gen, device="cuda")
    ct = torch.randn((b, p, c), generator=gen, device="cuda")
    before = scatter.scatter_add_weighted.launches
    got = scatter.scatter_add_weighted(idx, w, ct, n)
    assert scatter.scatter_add_weighted.launches == before + 1
    want = scatter.scatter_add_weighted_ref(idx, w, ct, n)
    mags = scatter.scatter_add_weighted_ref(idx, w, ct.abs(), n)
    assert mag_sum_ok(got, want, mags)


@pytest.mark.parametrize("c,n", [(51, 333), (14, 1001)])
def test_wgather_pre_kernel(gen, c, n):
    """B6's gather against its plain version: the k products summed in
    another order (and fused multiply-adds), 1e-5 of sum_j |w_j| |f_j|."""
    b, k = 2, 10
    idx = torch.randint(0, n, (b, n, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    w = torch.rand((b, n, k), generator=gen, device="cuda")
    f = randn(gen, (b, n, c))
    before = wgather.wgather_pre.launches
    got = wgather.wgather_pre(idx, w, f)
    assert wgather.wgather_pre.launches == before + 1
    want = wgather.wgather_pre_ref(idx, w, f)
    assert mag_sum_ok(got, want, wgather.wgather_pre_ref(idx, w, f.abs()))


@pytest.mark.parametrize("fast,ties,n", [(False, False, 701), (True, False, 701),
                                         (False, True, 333), (True, True, 333)])
def test_knn_wgather_kernel(gen, fast, ties, n):
    """B9 against its plain version on S3DIS-like points (xyzrgb in a
    unit block, gamma 0.1, k=10, 13+1 feature channels), N not a multiple
    of 8; with ``ties`` the second half of every block repeats the first,
    as S3DIS blocks of few points do, so exact distances tie at 0 and the
    lowest index must win. Indices by agreement rate (exact >= 99.9%,
    fast >= 98%, as B12); the weights against exp(-max(d, 0) / gamma) of
    the plain distances at the kernel's own indices, within what the
    distances' tolerance moves them (exact 1e-5 of the distance scale,
    fast the dropped idx_bits); s against the plain weighted sum at the
    kernel's own indices and weights, 1e-5 of the sum of magnitudes."""
    b, k, gamma = 3, 10, 0.1
    g = torch.rand((b, n, 6), generator=gen, device="cuda")
    if ties:
        g[:, n - n // 2:] = g[:, :n // 2]
    f = randn(gen, (b, n, 14)).abs()
    before = wgather.knn_wgather.launches
    idx, s, w = wgather.knn_wgather(g, f, k, gamma, fast=fast)
    assert wgather.knn_wgather.launches == before + 1
    want_idx = wgather.knn_wgather_ref(g, f, k, gamma, fast=fast)[0]
    agree = (idx == want_idx).float().mean().item()
    assert agree >= (0.98 if fast else 0.999), agree
    if ties and not fast:
        # each repeated point and its original are both at distance 0:
        # the lower index comes first
        first = idx[:, n - n // 2:, 0]
        assert torch.equal(first, torch.arange(n // 2, device="cuda",
                                               dtype=torch.int32).expand_as(first))
    d = knn.distances(g)
    d_sel = torch.gather(d, 2, idx.long()).clamp_min(0.0)
    scale = d.abs().max().item()
    tol_d = scale * (2.0 ** (knn.idx_bits(n) - 23) if fast else 1e-5)
    w_ref = torch.exp(-d_sel / gamma)
    assert bool(((w - w_ref).abs() <= w_ref * (tol_d / gamma) * 1.01 + 1e-6).all())
    assert mag_sum_ok(s, wgather.wgather_pre_ref(idx, w, f),
                      wgather.wgather_pre_ref(idx, w, f.abs()))


def test_weighted_gathers_never_reach_plain_versions(gen, monkeypatch):
    """The differentiable gathers on CUDA tensors launch their kernels
    forward (B6 gather, B9) and backward (B6 scatter), once each per call,
    and never call a plain version (patched to raise here)."""
    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((wgather, "wgather_pre_ref"), (wgather, "knn_wgather_ref"),
                      (scatter, "scatter_add_weighted_ref"),
                      (scatter, "scatter_add_ref")):
        monkeypatch.setattr(mod, name, refuse)
    b, n, k = 2, 257, 10
    g = torch.rand((b, n, 6), generator=gen, device="cuda")
    f = randn(gen, (b, n, 14)).requires_grad_()
    kernels = (wgather.wgather_pre, wgather.knn_wgather,
               scatter.scatter_add_weighted)
    before = [fn.launches for fn in kernels]
    idx, s, w = wgather.knn_weighted_gather(g, f, k, 0.1, fast=True)
    s.sum().backward()
    s2 = wgather.weighted_gather_pre(idx, w, f)
    (s2 * 2).sum().backward()
    torch.cuda.synchronize()
    assert [fn.launches - c for fn, c in zip(kernels, before)] == [1, 1, 2]
    assert f.grad.dtype == torch.bfloat16 and bool(f.grad.isfinite().all())


def affinity_errors(got, feat, u, transposed):
    """max |kernel - plain| per element over its tolerance: twice the
    Gram's f32 cancellation bound (label_prop.check_gram_cancellation;
    each side rounds its own Gram) plus 1e-5 of sum_j W_ij |u_j| (expf's
    2 ulp, another summation order), plus exp(-30) sum |u| for the skipped
    pairs."""
    ref = affinity.affinity_matvec_t_ref if transposed else affinity.affinity_matvec_ref
    want, mags = ref(feat, u), ref(feat, u.abs())
    bound = label_prop.check_gram_cancellation(
        feat.transpose(1, 2) if transposed else feat)
    skipped = torch.exp(torch.tensor(-30.0)) * u.abs().sum((1, 2), keepdim=True)
    tol = (2 * bound + 1e-5) * mags + skipped + 1e-30
    return ((got - want).abs() / tol).max().item()


@pytest.mark.parametrize("n,k,transposed", [
    (701, 13, True), (333, 1, True), (128, 16, True), (1000, 13, False),
    (129, 1, False), (500, 50, True), (300, 17, False)])
def test_affinity_kernel(gen, n, k, transposed):
    """B10 (transposed) and B17 against their plain versions at odd N, the
    CG's K=13 (S3DIS) and K=50 (ShapeNet: four launches of at most 16
    classes), the degree pass's K=1, F=6 and F=3."""
    for f in (6, 3):
        feat = torch.rand((2, n, f), generator=gen, device="cuda") * 2.0
        u = torch.randn((2, n, k), generator=gen, device="cuda")
        if transposed:
            feat, u = feat.transpose(1, 2).contiguous(), u.transpose(1, 2).contiguous()
        fn = affinity.affinity_matvec_t if transposed else affinity.affinity_matvec
        before = fn.launches
        got = fn(feat, u)
        torch.cuda.synchronize()
        assert fn.launches == before + -(-k // 16) and got.shape == u.shape
        assert affinity_errors(got, feat, u, transposed) <= 1.0


def test_affinity_kernel_skips_far_tiles(gen):
    """ROADMAP C9 on the card: a Morton-sorted scene of far-apart clusters
    with a ragged last tile, where most tile pairs are skipped; the kernel
    with skipping, without it and the plain version agree."""
    centers = torch.rand((12, 3), generator=gen, device="cuda") * 6.0
    xyz = (centers.repeat_interleave(100, 0)
           + torch.randn((1200, 3), generator=gen, device="cuda") * 0.03)[None]
    order = affinity.morton_order(xyz).long()[0]
    rgb = torch.rand((1, 1200, 3), generator=gen, device="cuda")
    feat = torch.cat([xyz * 1e3 ** 0.5, rgb * 10 ** 0.5], -1)[:, order]
    feat = feat - feat.mean(1, keepdim=True)
    feat_t = feat.transpose(1, 2).contiguous()
    ut = torch.randn((1, 13, 1200), generator=gen, device="cuda")
    mask = affinity.skip_mask_t(feat_t, affinity.TILE, affinity.TILE, 30.0)
    assert 0.3 < 1.0 - mask.float().mean().item() < 1.0
    got = affinity.affinity_matvec_t(feat_t, ut)
    full = affinity.affinity_matvec_t(feat_t, ut, mask=affinity.tile_mask(feat_t, None))
    given = affinity.affinity_matvec_t(feat_t, ut, mask=affinity.tile_mask(feat_t))
    torch.cuda.synchronize()
    assert torch.equal(given, got)
    assert affinity_errors(got, feat_t, ut, True) <= 1.0
    assert affinity_errors(full, feat_t, ut, True) <= 1.0
    assert (got - full).abs().max().item() <= 1e-12 * ut.abs().sum().item() + 1e-6 * (
        full.abs().max().item())


def test_affinity_kernel_refuses(gen):
    """No classes, F above 6, a tile mask of another shape, and operands
    on two devices raise (K above 16 runs in groups of 16,
    test_affinity_kernel)."""
    feat_t = torch.rand((1, 6, 300), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="K=0"):
        affinity.affinity_matvec_t(feat_t, torch.ones((1, 0, 300), device="cuda"))
    with pytest.raises(ValueError, match="F=7"):
        affinity.affinity_matvec(torch.rand((1, 300, 7), device="cuda"),
                                 torch.ones((1, 300, 2), device="cuda"))
    with pytest.raises(ValueError, match="mask: shape"):
        affinity.affinity_matvec_t(feat_t, torch.ones((1, 2, 300), device="cuda"),
                                   mask=affinity.tile_mask(feat_t[..., :200]))
    with pytest.raises(ValueError, match="expected cuda"):
        affinity.affinity_matvec_t(feat_t, torch.ones((1, 2, 300)))
    with pytest.raises(RuntimeError):
        affinity.affinity_matvec_t(feat_t.cpu(), torch.ones((1, 2, 300), device="cuda"))


def heavy_rows(gen, kind):
    """Centred, Morton-sorted LP features [1, 6, N] whose row tiles take
    several work items of the plan: "identical" a 1000-point room slab
    with 1600 copies of one point inside it (13 tiles at affinity 1 to
    each other and to their neighbours), "padded" a 1500-point room slab
    with room_label_prop's pads, 1792 identical points 2 m beyond the
    room's far corner (train/loop.py::room_label_prop)."""
    n = 1000 if kind == "identical" else 1500
    xyz = torch.rand((n, 3), generator=gen, device="cuda") * torch.tensor(
        [2.0, 1.0, 0.3], device="cuda")
    rgb = torch.rand((n, 3), generator=gen, device="cuda")
    if kind == "identical":
        copies, pt, col = 1600, xyz[0], rgb[0]
    else:
        copies, pt, col = 1792, xyz.amax(0) + 2.0, torch.zeros(3, device="cuda")
    xyz = torch.cat([xyz, pt.expand(copies, 3)])[None]
    rgb = torch.cat([rgb, col.expand(copies, 3)])[None]
    feat_t, _ = label_prop.matfree_features(xyz, rgb)
    return feat_t


@pytest.mark.parametrize("kind", ["identical", "padded"])
@pytest.mark.parametrize("k", [1, 13, 16, 50])
@pytest.mark.parametrize("transposed", [True, False])
def test_affinity_kernel_heavy_rows(gen, kind, k, transposed):
    """B10 and B17 on row tiles that the plan cuts into many items
    (tests/test_torch_affinity.py holds the plan itself on the CPU),
    against their plain versions under test_affinity_kernel's tolerance,
    at the degree pass's K=1, the CG's 13, one full group of 16 and
    ShapeNet's 50 (four launches): two launches give the same bits, and
    a given plan the bits of the wrapper's own."""
    feat_t = heavy_rows(gen, kind)
    n = feat_t.shape[2]
    plan = affinity.tile_plan(affinity.tile_mask(feat_t))
    items = torch.bincount(plan.item_row.long())
    assert items.max().item() >= 2 and plan.n_items > plan.n_tiles
    ut = torch.randn((1, k, n), generator=gen, device="cuda")
    if transposed:
        feat, u, fn = feat_t, ut, affinity.affinity_matvec_t
    else:
        feat, u = feat_t.transpose(1, 2).contiguous(), ut.transpose(1, 2).contiguous()
        fn = affinity.affinity_matvec
    before = fn.launches
    got = fn(feat, u, plan=plan)
    again = fn(feat, u, plan=plan)
    own = fn(feat, u)
    torch.cuda.synchronize()
    assert fn.launches == before + 3 * -(-k // 16) and got.shape == u.shape
    assert torch.equal(got, again) and torch.equal(got, own)
    assert affinity_errors(got, feat, u, transposed) <= 1.0


def test_matfree_lp_on_cuda_matches_cpu(gen, monkeypatch):
    """label_propagation_matfree on the card (B10, tile skipping) against
    the CPU's plain version on 3000 points of a dense 1 x 0.6 x 0.2 m slab
    with colours varying smoothly over it, where the LP couples points
    (it must change >= 3% of the argmaxes on both devices): probabilities
    within 1e-3 (the CG's f32 error level), argmax agreement >= 99.9%;
    B10 launches once for the degrees and once per CG iteration, and its
    tile mask is built once."""
    xyz = torch.rand((1, 3000, 3), generator=gen, device="cuda") * torch.tensor(
        [1.0, 0.6, 0.2], device="cuda")
    rgb = (0.5 + 0.2 * torch.sin(2.0 * xyz)
           + 0.03 * torch.randn((1, 3000, 3), generator=gen, device="cuda"))
    g = torch.softmax(torch.randn((1, 3000, 13), generator=gen, device="cuda")
                      * 3.0, -1)
    calls, masks, plans = [], [], []
    cg, mask_fn, plan_fn = label_prop._cg, affinity.skip_mask_t, affinity.tile_plan

    def counting_cg(matvec, *a, **kw):
        def mv(v):
            calls.append(1)
            return matvec(v)
        return cg(mv, *a, **kw)

    def counting_mask(*a, **kw):
        masks.append(1)
        return mask_fn(*a, **kw)
    def counting_plan(*a, **kw):
        plans.append(1)
        return plan_fn(*a, **kw)
    monkeypatch.setattr(label_prop, "_cg", counting_cg)
    monkeypatch.setattr(affinity, "skip_mask_t", counting_mask)
    monkeypatch.setattr(affinity, "tile_plan", counting_plan)
    monkeypatch.setattr(label_prop, "tile_plan", counting_plan)
    before = affinity.affinity_matvec_t.launches
    got = label_prop.propagate_batch(xyz, g, rgb, solver="cg_matfree")
    torch.cuda.synchronize()
    assert affinity.affinity_matvec_t.launches - before == 1 + len(calls) > 1
    assert len(masks) == 1 and len(plans) == 1
    want = label_prop.propagate_batch(xyz.cpu(), g.cpu(), rgb.cpu(),
                                      solver="cg_matfree")
    for y in (got.cpu(), want):
        assert (y.argmax(-1) != g.argmax(-1).cpu()).float().mean().item() >= 0.03
    assert (got.cpu() - want).abs().max().item() <= 1e-3
    assert (got.argmax(-1).cpu() == want.argmax(-1)).float().mean().item() >= 0.999


# ------------------------------------------------------ B11 (static graph)

def b11_check(got, want, nv):
    """y1 and the extrema bitwise, the moments within 1e-5 of the sum of
    magnitudes (f32 sums in another order, ROADMAP C4)."""
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)
    y32 = want[0][:, :nv].float()
    mags = torch.stack([y32.abs().sum((0, 1, 2)), (y32 * y32).sum((0, 1, 2))])
    assert mag_sum_ok(got[1], want[1], mags)


@pytest.mark.parametrize("c,minmax,n_valid", [
    (64, True, None), (64, False, 650), (33, True, 500), (128, True, None)])
def test_knn_edge_pre_kernel(gen, c, minmax, n_valid):
    """B11 against its plain version on a random graph (odd C takes the
    one-channel-per-lane instance); one launch per call."""
    b, n, k = 3, 701, 20
    v, u = randn(gen, (b, n, c)), randn(gen, (b, n, c))
    idx = torch.randint(0, n, (b, n, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    before = edgeconv.knn_edge_pre.launches
    got = edgeconv.knn_edge_pre(idx, v, u, k, with_minmax=minmax,
                                n_valid=n_valid)
    assert edgeconv.knn_edge_pre.launches == before + 1
    want = edgeconv.knn_edge_pre_ref(idx, v, u, k, with_minmax=minmax,
                                     n_valid=n_valid)
    assert len(got) == len(want) == (6 if minmax else 2)
    b11_check(got, want, n if n_valid is None else n_valid)


@pytest.mark.parametrize("fast,n_valid", [(True, None), (False, 600)])
def test_knn_edge_pre_matches_b1(gen, fast, n_valid):
    """Fed B1's own indices, B11 returns B1's y1 and extrema bit for bit
    (the same add and one bf16 rounding), rows past n_valid zero."""
    b, n, k, c = 2, 777, 20, 64
    g, v, u = randn(gen, (b, n, 3)), randn(gen, (b, n, c)), randn(gen, (b, n, c))
    idx, *b1 = edgeconv.knn_edge(g, v, u, k, fast=fast, with_minmax=True,
                                 n_valid=n_valid)
    assert 0 <= int(idx.min()) and int(idx.max()) < (n_valid or n)
    got = edgeconv.knn_edge_pre(idx, v, u, k, with_minmax=True,
                                n_valid=n_valid)
    b11_check(got, b1, n if n_valid is None else n_valid)


def test_knn_edge_pre_refuses(gen):
    v = randn(gen, (1, 64, 16))
    idx = torch.zeros((1, 64, 4), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        edgeconv.knn_edge_pre(idx.long(), v, v, 4)
    with pytest.raises(ValueError, match="shape"):
        edgeconv.knn_edge_pre(idx, v, v, 5)
    with pytest.raises(ValueError, match="contiguous"):
        edgeconv.knn_edge_pre(idx.transpose(1, 2).contiguous().transpose(1, 2),
                              v, v, 4)


def test_knn_edge_gather_pre_on_cuda_matches_cpu(gen):
    """B11's VJP: y1 bitwise, du within one bf16 ulp (f32 sums of the same
    bf16 dy_eff in another order), dv within 1e-5 of the scattered
    magnitudes before its bf16 rounding plus one ulp (B13 sums in another
    order than the CPU's plain composition)."""
    b, n, k, c = 2, 333, 20, 64
    v, u = randn(gen, (b, n, c)), randn(gen, (b, n, c))
    idx = torch.randint(0, n, (b, n, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    dy = randn(gen, (b, n, k, c))
    dmom = randn(gen, (2, c), torch.float32, 0.1)
    outs = []
    for dev in ("cuda", "cpu"):
        vv = v.to(dev, copy=True).requires_grad_()
        uu = u.to(dev, copy=True).requires_grad_()
        y, mom = edgeconv.knn_edge_gather_pre(idx.to(dev), vv, uu, k)
        torch.autograd.backward((y, mom), (dy.to(dev), dmom.to(dev)))
        outs.append((y.detach().cpu(), vv.grad.float().cpu(),
                     uu.grad.float().cpu()))
    (y_c, dv_c, du_c), (y_p, dv_p, du_p) = outs
    assert torch.equal(y_c, y_p)
    assert bool(((du_c - du_p).abs() <= 2.0 ** -7 * du_p.abs() + 1e-6).all())
    assert bool(((dv_c - dv_p).abs() <= 2.0 ** -7 * dv_p.abs() + 1e-4).all())


def static_cfg(preset, **kw):
    """A narrow static-graph model of ``preset`` (ShapeNet: transform net
    and category branch; S3DIS: 9 channels, kNN on 6:9)."""
    base = getattr(configs, f"{preset}_config")().model
    return dataclasses.replace(
        base, num_classes=12, num_categories=4 if preset == "shapenet" else 0,
        global_channels=128, category_embed_channels=8,
        head_channels=(32, 32, 16)[:len(base.head_channels)],
        head_keep_prob=(None,) * len(base.head_channels), static_graph=True,
        **kw)


@pytest.mark.parametrize("preset", ["shapenet", "s3dis"])
def test_static_fused_step_on_cuda_matches_cpu(gen, preset):
    """One static-graph bf16 step on the card: B1 once (the transform stage
    or stage 0) and B11 in every other EdgeConv stage, B12 never; against
    the same step over the plain versions on the CPU replaying the card's
    indices and moments, with test_fused_train_step_on_cuda_matches_cpu's
    limits (blocks 1e-2; the whole step loss 2e-3, logits 0.1, leaves
    0.6, null biases 1e-2), at the training path's N=2048. The replay
    leaves one difference: the card's rsqrt puts BN1's scale one f32 ulp
    off the CPU's, which can flip a bf16 rounding of h1 and with it one
    k-max slot of the next conv. At N=300 such a flip in the ShapeNet
    model's second stage moved its BN2 beta gradient, a sum over 600
    points, by 5% of its norm in 4 of 6 runs (the others: <= 2e-4); at
    N=2048 a flip is diluted over 4096 points."""
    from weaksuppointcloudseg_tpu_torch.losses.weaksup import masked_softmax_ce
    from weaksuppointcloudseg_tpu_torch.utils import replay

    cfg = static_cfg(preset, compute_dtype="bfloat16", knn_fast=True)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 2048, cfg.in_channels), generator=g) * 0.5
    onehot = torch.eye(12)[torch.randint(0, 12, (2, 2048), generator=g)]
    mask = (torch.rand((2, 2048), generator=g) < 0.3).float()
    cat = torch.eye(4)[[0, 2]] if cfg.num_categories else None
    kernels = (edgeconv.knn_edge, edgeconv.knn_edge_pre, knn.knn,
               conv_kmax.conv_minmax, conv_kmax.conv_nmax,
               conv_kmax.conv_kmax_bwd, conv_kmax.conv_nmax_bwd,
               scatter.scatter_bn_bwd)
    want_counts = {"shapenet": [1, 3, 0, 3, 2, 3, 2, 4],
                   "s3dis": [1, 2, 0, 2, 1, 2, 1, 3]}[preset]
    outs, tape, blocks = [], None, None
    for dev in ("cuda", "cpu"):
        model = DGCNNSeg(cfg, seed=1).to(dev)
        counts = [fn.launches for fn in kernels]
        cuda = dev == "cuda"
        c = None if cat is None else cat.to(dev)
        with (replay.record() if cuda else replay.replay(tape)) as t, \
                (replay.record_blocks() if cuda else contextlib.nullcontext()) as b:
            logits = model(x.to(dev), c, training=True, bn_decay=0.5) \
                if cuda else model.forward_fused(x, c, training=True,
                                                 bn_decay=0.5)
        tape, blocks = tape or t, blocks or b
        loss = masked_softmax_ce(logits, onehot.to(dev), mask.to(dev))
        loss.backward()
        if cuda:
            assert [fn.launches - c0 for fn, c0 in zip(kernels, counts)] == \
                want_counts
        outs.append((float(loss.detach()), logits.detach().float().cpu(),
                     {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (got_l, got_lg, got_g), (want_l, want_lg, want_g) = outs
    for entry in blocks:
        errs = replay.block_errors(entry)
        assert max(errs.values()) <= 1e-2, (entry["block"].__name__, errs)
    errs, null = replay.grad_errors(model, got_g, want_g)
    assert abs(got_l - want_l) <= 2e-3 * abs(want_l)
    assert (got_lg - want_lg).norm() <= 0.1 * want_lg.norm()
    for name, e in errs.items():
        if name != "agg_conv.beta":
            assert e <= (1e-2 if name in null else 0.6), (name, e)


def test_static_f32_on_cuda(gen):
    """f32 static graph on the card: one B12 kNN per forward (eval and
    training), the stages' gathers backward through B13, and the eval
    probabilities agree with the CPU's (test_model_gate_on_cuda's
    limits)."""
    cfg = static_cfg("shapenet")
    model = DGCNNSeg(cfg, seed=2).cuda()
    x = torch.randn((2, 500, 3), generator=gen, device="cuda") * 0.4
    cat = torch.eye(4, device="cuda")[[1, 3]]
    with torch.inference_mode():
        want = torch.softmax(DGCNNSeg(cfg, seed=2)(x.cpu(), cat.cpu()), -1)
        before = knn.knn.launches
        got = torch.softmax(model(x, cat), -1)
    assert knn.knn.launches - before == 1
    agree = (got.argmax(-1).cpu() == want.argmax(-1)).float().mean().item()
    assert agree >= 0.99 and (got.cpu() - want).abs().max().item() <= 1e-3
    before = (knn.knn.launches, scatter.scatter_add.launches)
    logits = model(x, cat, training=True, bn_decay=0.5)
    logits.square().mean().backward()
    assert (knn.knn.launches - before[0],
            scatter.scatter_add.launches - before[1]) == (1, 3)


# ---------------------------------------------------------------- B14

@pytest.mark.parametrize("b,n,k,c", [(2, 333, 20, 3), (1, 1001, 20, 9),
                                     (2, 517, 20, 64), (1, 64, 40, 5),
                                     (3, 200, 7, 12)])
def test_gather_rows_kernel(gen, b, n, k, c):
    """B14 against its plain version, bitwise, at the unfused route's
    widths (C=3: 6-byte rows, C=9: 18-byte rows, C=64: 128-byte rows) and
    at widths that take 2-, 8- and 4-byte chunks; duplicates, the first
    and the last row among the indices, k above the warp width."""
    f = randn(gen, (b, n, c))
    idx = torch.randint(0, n, (b, n, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    idx[:, 0] = n - 1
    idx[:, 1] = 0
    before = gather.gather_rows.launches
    got = gather.gather_rows(f, idx)
    assert gather.gather_rows.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16),
                       gather.gather_rows_ref(f, idx).view(torch.int16))


def test_gather_rows_unaligned_source(gen):
    """A source that starts 2 bytes past an aligned address (a view one
    element into a buffer) takes the 2-byte chunks: still bitwise."""
    buf = randn(gen, (2 * 300 * 64 + 1,))
    f = buf[1:].view(2, 300, 64)
    idx = torch.randint(0, 300, (2, 300, 20), generator=gen, device="cuda",
                        dtype=torch.int32)
    got = gather.gather_rows(f, idx)
    assert torch.equal(got, gather.gather_rows_ref(f, idx))


def test_gather_rows_refuses(gen):
    f = randn(gen, (1, 64, 8))
    idx = torch.zeros((1, 64, 4), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        gather.gather_rows(f.float(), idx)
    with pytest.raises(ValueError, match="dtype"):
        gather.gather_rows(f, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_rows(f.transpose(1, 2).contiguous().transpose(1, 2), idx)


_TRAP = """
import sys, torch
from weaksuppointcloudseg_tpu_torch.ops import gather
f = torch.zeros((2, 50, 9), dtype=torch.bfloat16, device="cuda")
idx = torch.zeros((2, 50, 4), dtype=torch.int32, device="cuda")
idx[1, 7, 2] = int(sys.argv[1])
gather.gather_rows(f, idx)
torch.cuda.synchronize()
print("completed")
"""


def test_gather_rows_traps_out_of_range_index(gen):
    """An index outside [0, N) stops the kernel with a device trap (no
    clamp): the process's CUDA context is lost, so it runs in its own."""
    import subprocess
    import sys

    gather.gather_rows(randn(gen, (1, 8, 9)),
                       torch.zeros((1, 8, 1), dtype=torch.int32,
                                   device="cuda"))  # built before the runs
    runs = {v: subprocess.run([sys.executable, "-c", _TRAP, str(v)],
                              capture_output=True, text=True, timeout=300)
            for v in (49, 50, -1)}
    assert runs[49].returncode == 0 and "completed" in runs[49].stdout
    for v in (50, -1):
        assert runs[v].returncode != 0 and "completed" not in runs[v].stdout


@pytest.mark.parametrize("preset", ["shapenet_config", "s3dis_config"])
def test_unfused_forward_on_cuda(gen, preset):
    """The bf16 eval forward without the fused kNN: B14 once per gather
    (ShapeNet: the transform net and three stages; S3DIS: three stages),
    no B1/B7/B8/B12; against the same forward on the CPU replaying the
    card's kNN graphs (exact bf16 distance ties may order differently on
    the two devices): argmax agreement >= 99%, |dprob| <= 2e-2 (bf16
    activations, another f32 summation order in every conv)."""
    from weaksuppointcloudseg_tpu_torch.utils import replay

    cfg = dataclasses.replace(getattr(configs, preset)().model,
                              compute_dtype="bfloat16", use_fused_knn=False)
    model = DGCNNSeg(cfg).eval()
    c_in = cfg.in_channels
    x = torch.rand((2, 700, c_in), generator=gen, device="cuda")
    cat = torch.eye(16, device="cuda")[[3, 11]] if cfg.num_categories else None
    kernels = (gather.gather_rows, edgeconv.knn_edge, conv_kmax.conv_zmax,
               conv_kmax.conv_znmax, knn.knn)
    before = [fn.launches for fn in kernels]
    with torch.inference_mode(), replay.record_plain() as tape:
        got = torch.softmax(model.cuda()(x, cat), -1)
    counts = [fn.launches - b for fn, b in zip(kernels, before)]
    assert counts == [4 if cfg.use_transform_net else 3, 0, 0, 0, 0]
    with torch.inference_mode(), replay.replay_plain(tape):
        want = torch.softmax(model.cpu()(x.cpu(), None if cat is None
                                         else cat.cpu()), -1)
    agree = (got.argmax(-1).cpu() == want.argmax(-1)).float().mean().item()
    assert agree >= 0.99
    assert (got.cpu() - want).abs().max().item() <= 2e-2


def test_unfused_bf16_step_on_cuda_matches_cpu(gen):
    """One bf16 Full-style step without the fused kNN (B14 forward, B13
    backward, B12 in the smoothness loss) on the card against the CPU
    replaying the card's kNN graphs and batch moments: the losses within
    2e-3 relative, every gradient leaf within 0.1 of its largest entry
    plus 1e-2 of the largest overall (tests/test_torch_fused_step.py's
    bf16 step tolerances; conv sums still run in other orders)."""
    from weaksuppointcloudseg_tpu_torch.train.steps import loss_fn
    from weaksuppointcloudseg_tpu_torch.utils import replay

    full = configs.shapenet_config()
    full = dataclasses.replace(full, model=dataclasses.replace(
        full.model, compute_dtype="bfloat16", use_fused_knn=False,
        head_keep_prob=(None, None, None)))
    x = torch.randn((4, 512, 3), generator=gen, device="cuda") * 0.4
    seg = torch.randint(0, 50, (4, 512), generator=gen, device="cuda")
    batch = {"data": x, "cat_onehot": torch.eye(16, device="cuda")[[1, 1, 5, 5]],
             "seg_onehot": torch.nn.functional.one_hot(seg, 50).float(),
             "mask": (torch.rand((4, 512), generator=gen, device="cuda")
                      < 0.3).float()}
    kernels = (gather.gather_rows, scatter.scatter_add, knn.knn,
               edgeconv.knn_edge)
    outs, tape = [], None
    for dev in ("cuda", "cpu"):
        model = DGCNNSeg(full.model, seed=1).to(dev)
        before = [fn.launches for fn in kernels]
        ctx = replay.record_plain() if dev == "cuda" else replay.replay_plain(tape)
        with ctx as t:
            total, comps, _ = loss_fn(
                model, {k: v.to(dev) for k, v in batch.items()}, cfg=full,
                style="Full", bn_decay=0.5, gate=1.0)
            total.backward()
        tape = tape or t
        if dev == "cuda":
            # B13: the 3 stages' gathers and the smoothness loss's gather
            assert [fn.launches - b for fn, b in zip(kernels, before)] == [
                4, 4, 1, 0]
        outs.append(({k: float(v.detach()) for k, v in comps.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (got_c, got_g), (want_c, want_g) = outs
    for k in want_c:
        assert abs(got_c[k] - want_c[k]) <= 2e-3 * abs(want_c[k]), k
    scale = max(w.abs().max().item() for w in want_g.values())
    for n, w in want_g.items():
        err = (got_g[n] - w).abs().max().item()
        assert err <= 0.1 * w.abs().max().item() + 1e-2 * scale, (n, err)


def test_solve_on_cuda_matches_f64(gen):
    """propagate_batch(solver="solve") on the card: the LU of the f32
    system against an f64 solve of the same system (ROADMAP C1: TF32 is
    off), normwise within kappa * sqrt(N) * 2^-24 (tests/test_torch_
    solve.py states the bound); and the card's Y_prob within 1e-4 of the
    CPU's."""
    from weaksuppointcloudseg_tpu_torch.propagate import laplacian

    n = 1000
    xyz = torch.randn((2, n, 3), generator=gen, device="cuda")
    xyz = xyz / xyz.norm(dim=-1).amax(1)[:, None, None]
    g = torch.softmax(torch.randn((2, n, 13), generator=gen, device="cuda")
                      * 3, -1)
    lap = laplacian.laplacian_xyz_rgb(xyz, xyz)
    y, y_prob, w = label_prop.label_propagation(lap, g)
    a = lap[0].double() + torch.diag(w[0].double() + 1e-5)
    y64 = torch.linalg.solve(a, (w[0, :, None] * g[0]).double())
    ev = torch.linalg.eigvalsh(a)
    kappa = (ev.max() / ev.min()).item()
    err = ((y[0].double() - y64).norm() / y64.norm()).item()
    assert 0 < kappa and err <= kappa * n ** 0.5 * 2.0 ** -24, (err, kappa)
    got = label_prop.propagate_batch(xyz, g, solver="solve").cpu()
    want = label_prop.propagate_batch(xyz.cpu(), g.cpu(), solver="solve")
    assert (got - want).abs().max().item() <= 1e-4


# ------------------------------------------------- B15, B16, classifier

@pytest.mark.parametrize("cg,cf,dtype,fast", [
    (3, 3, torch.bfloat16, False), (3, 9, torch.bfloat16, True),
    (64, 64, torch.bfloat16, False), (64, 64, torch.bfloat16, True),
    (3, 9, torch.float32, False), (64, 64, torch.float32, True)])
def test_knn_gather_kernel(gen, cg, cf, dtype, fast):
    """B15 against its plain version: indices by agreement rate (f32 sums
    in another order than cuBLAS: exact >= 99.9%, fast >= 98%); rows
    bitwise and the selected distances (1e-5 of the distance scale; fast:
    the dropped idx_bits) at the kernel's own indices."""
    from weaksuppointcloudseg_tpu_torch.ops import knn_gather as kg

    b, n, k = 3, 701, 20
    g, f = randn(gen, (b, n, cg)), randn(gen, (b, n, cf), dtype)
    before = kg.knn_gather.launches
    idx, nbr, sqd = kg.knn_gather_with_sqdist(g, f, k, fast=fast)
    assert kg.knn_gather.launches == before + 1
    i2, n2 = kg.knn_gather(g, f, k, fast=fast)
    torch.cuda.synchronize()
    assert torch.equal(i2, idx) and torch.equal(n2, nbr)
    want = kg.knn_gather_ref(g, f, k, fast=fast)[0]
    agree = (idx == want).float().mean().item()
    assert agree >= (0.98 if fast else 0.999), agree
    assert nbr.dtype == dtype
    assert torch.equal(nbr, gather.gather_rows_ref(f, idx))
    d = torch.gather(knn.distances(g), 2, idx.long())
    if fast:
        d = d.clamp_min(0.0)
    scale = knn.distances(g).abs().max().item()
    tol = scale * (2.0 ** (knn.idx_bits(n) - 23) if fast else 1e-5)
    assert (sqd - d).abs().max().item() <= tol


@pytest.mark.parametrize("cg,fast", [(3, False), (64, False), (64, True)])
def test_knn_gather_indices_equal_b1s(gen, cg, fast):
    """On the same bf16 g, B15's selection (B12's rows on g widened to f32)
    and B1's give the same indices and distances, bit for bit."""
    from weaksuppointcloudseg_tpu_torch.ops import knn_gather as kg

    b, n, k = 2, 999, 20
    g = randn(gen, (b, n, cg))
    v = u = randn(gen, (b, n, 8))
    idx, _, sqd = kg.knn_gather_with_sqdist(g, v, k, fast=fast)
    b1 = edgeconv.knn_edge(g, v, u, k, fast=fast, with_values=True)
    assert torch.equal(idx, b1[0]) and torch.equal(sqd, b1[-1])


def test_knn_gather_unaligned_rows(gen):
    """A source that starts 2 bytes past an aligned address takes 2-byte
    chunks; f32 rows of 3 values take 4-byte chunks: still bitwise."""
    from weaksuppointcloudseg_tpu_torch.ops import knn_gather as kg

    g = randn(gen, (2, 300, 3))
    buf = randn(gen, (2 * 300 * 64 + 1,))
    f = buf[1:].view(2, 300, 64)
    idx, nbr = kg.knn_gather(g, f, 20)
    assert torch.equal(nbr, gather.gather_rows_ref(f, idx))
    f3 = randn(gen, (2, 300, 3), torch.float32)
    idx, nbr = kg.knn_gather(g, f3, 20)
    assert torch.equal(nbr, gather.gather_rows_ref(f3, idx))


def test_knn_gather_refuses(gen):
    from weaksuppointcloudseg_tpu_torch.ops import knn_gather as kg

    g = randn(gen, (1, 64, 3))
    with pytest.raises(ValueError, match="k="):
        kg.knn_gather(g, g, 33)
    with pytest.raises(ValueError, match="dtype"):
        kg.knn_gather(g, g.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        kg.knn_gather(g, randn(gen, (1, 8, 64)).transpose(1, 2), 4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_knn_gather_vjp_on_cuda(gen, dtype):
    """B15's VJP: df is B13's scatter of the rows' cotangent along the
    kernel's indices, within 1e-5 of the scattered magnitudes (ROADMAP
    C4) plus, in bf16, one ulp of the rounded sum; g gets none."""
    from weaksuppointcloudseg_tpu_torch.ops import knn_gather as kg

    b, n, k, c = 2, 333, 20, 64
    g = randn(gen, (b, n, 16)).requires_grad_()
    f = randn(gen, (b, n, c), dtype).requires_grad_()
    ct = randn(gen, (b, n, k, c), dtype)
    before = scatter.scatter_add.launches
    idx, nbr = kg.knn_gather(g, f, k)
    nbr.backward(ct)
    assert scatter.scatter_add.launches == before + 1
    assert g.grad is None and f.grad.dtype == dtype
    want = scatter.scatter_add_ref(idx.cpu(), ct.float().cpu(), n)
    mags = scatter.scatter_add_ref(idx.cpu(), ct.float().abs().cpu(), n)
    ulp = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    err = (f.grad.float().cpu() - want).abs()
    assert bool((err <= 1e-5 * mags + ulp * want.abs() + 1e-6).all())


@pytest.mark.parametrize("fast", [False, True])
def test_knn_edge_gather_on_cuda_matches_cpu(gen, fast):
    """B16's VJP (B1 forward, B13 in the backward) on the card against the
    CPU's B11 VJP at the card's indices: the same y1 (bitwise) and
    cotangents (du within one bf16 ulp, dv within one ulp plus 1e-4)."""
    b, n, k, c = 2, 333, 20, 64
    g, v, u = randn(gen, (b, n, 16)), randn(gen, (b, n, c)), randn(gen, (b, n, c))
    dy = randn(gen, (b, n, k, c))
    dmom = randn(gen, (2, c), torch.float32, 0.1)
    vv, uu = v.clone().requires_grad_(), u.clone().requires_grad_()
    before = (edgeconv.knn_edge.launches, scatter.scatter_add.launches)
    idx, y, mom = edgeconv.knn_edge_gather(g, vv, uu, k, fast=fast)
    torch.autograd.backward((y, mom), (dy, dmom))
    assert (edgeconv.knn_edge.launches, scatter.scatter_add.launches) == (
        before[0] + 1, before[1] + 1)
    vp, up = v.cpu().requires_grad_(), u.cpu().requires_grad_()
    yp, mp = edgeconv.knn_edge_gather_pre(idx.cpu(), vp, up, k)
    torch.autograd.backward((yp, mp), (dy.cpu(), dmom.cpu()))
    assert torch.equal(y.cpu(), yp)
    du_c, du_p = uu.grad.float().cpu(), up.grad.float()
    dv_c, dv_p = vv.grad.float().cpu(), vp.grad.float()
    assert bool(((du_c - du_p).abs() <= 2.0 ** -7 * du_p.abs() + 1e-6).all())
    assert bool(((dv_c - dv_p).abs() <= 2.0 ** -7 * dv_p.abs() + 1e-4).all())


def test_knn_graph_fused_takes_bf16(gen):
    """bf16 points reach B12 widened exactly to f32 (they raised before)."""
    from weaksuppointcloudseg_tpu_torch.ops import neighbors

    g = randn(gen, (2, 500, 3))
    before = knn.knn.launches
    got = neighbors.knn_graph_fused(g, 20, fast=True)
    assert knn.knn.launches == before + 1
    assert torch.equal(got, knn.knn(g.float(), 20, fast=True))


def test_auto_routes_on_cuda(gen):
    """neighbor_features_auto with use_fused: bf16 features through B15
    (and B13 backward), nothing else selecting; f32 through B12."""
    from weaksuppointcloudseg_tpu_torch.ops import knn_gather as kg
    from weaksuppointcloudseg_tpu_torch.ops import neighbors

    kernels = (kg.knn_gather, knn.knn, gather.gather_rows, scatter.scatter_add)
    g = randn(gen, (2, 400, 64))
    for dtype, want in ((torch.bfloat16, [1, 0, 0, 1]),
                        (torch.float32, [0, 1, 0, 1])):
        f = randn(gen, (2, 400, 64), dtype).requires_grad_()
        before = [fn.launches for fn in kernels]
        ef = neighbors.edge_feature_auto(g, f, 20, use_fused=True)
        ef.float().sum().backward()
        assert [fn.launches - b for fn, b in zip(kernels, before)] == want
        assert ef.dtype == dtype and bool(torch.isfinite(f.grad).all())


def _cls_cfg(**kw):
    return dataclasses.replace(
        configs.ClsConfig(), k=20, edge_channels=(16, 16, 16, 16),
        global_channels=64, fc_channels=(32, 16), keep_prob=1.0, **kw)


_FUSED_STEP = {"knn_edge": 5, "conv_minmax": 1, "conv_nmax": 2,
               "conv_kmax_bwd": 1, "scatter_bn_bwd": 5, "conv_nmax_bwd": 2}
CLS_ROUTES = {  # (dtype, config) -> launches of one training step
    "fused": (torch.bfloat16, dict(knn_fast=True), _FUSED_STEP),
    "static": (torch.bfloat16, dict(static_graph=True),
               {**_FUSED_STEP, "knn_edge": 1, "knn_edge_pre": 4}),
    "f32": (torch.float32, {}, {"knn": 5, "scatter_add": 4}),
    "unfused": (torch.bfloat16, dict(use_fused_knn=False), {
        "gather_rows": 5, "scatter_add": 4}),
}


@pytest.mark.parametrize("route", list(CLS_ROUTES))
def test_classifier_step_on_cuda(gen, route):
    """One training step of the classifier on each route: the kernels'
    launch counts (every other kernel of the package idle), finite
    gradients on every leaf; and the fused eval forward (B1 5, B7 1,
    B8 2)."""
    from weaksuppointcloudseg_tpu_torch.models.dgcnn_cls import (
        DGCNNCls,
        classification_loss,
    )
    from weaksuppointcloudseg_tpu_torch.ops import knn_gather as kg

    dtype, kw, want = CLS_ROUTES[route]
    fns = {"knn_edge": edgeconv.knn_edge, "knn_edge_pre": edgeconv.knn_edge_pre,
           "conv_minmax": conv_kmax.conv_minmax, "conv_nmax": conv_kmax.conv_nmax,
           "conv_kmax_bwd": conv_kmax.conv_kmax_bwd,
           "scatter_bn_bwd": scatter.scatter_bn_bwd,
           "conv_nmax_bwd": conv_kmax.conv_nmax_bwd, "knn": knn.knn,
           "scatter_add": scatter.scatter_add, "gather_rows": gather.gather_rows,
           "knn_gather": kg.knn_gather, "conv_zmax": conv_kmax.conv_zmax,
           "conv_znmax": conv_kmax.conv_znmax}
    model = DGCNNCls(_cls_cfg(**kw), seed=2).cuda()
    x = (torch.randn((4, 512, 3), generator=gen, device="cuda") * 0.5).to(dtype)
    labels = torch.randint(0, 40, (4,), generator=gen, device="cuda")
    before = {n: f.launches for n, f in fns.items()}
    loss = classification_loss(model(x, training=True, bn_decay=0.5), labels)
    loss.backward()
    got = {n: f.launches - before[n] for n, f in fns.items()}
    assert got == {n: want.get(n, 0) for n in fns}, got
    assert bool(torch.isfinite(loss))
    for n, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), n
    if route == "fused":
        before = {n: f.launches for n, f in fns.items()}
        with torch.no_grad():
            logits = model(x)
        got = {n: f.launches - before[n] for n, f in fns.items()}
        assert got == {n: {"knn_edge": 5, "conv_zmax": 1, "conv_znmax": 2}.get(
            n, 0) for n in fns}, got
        assert logits.dtype == torch.bfloat16 and logits.shape == (4, 40)


def test_three_conv_stage_step_on_cuda_matches_cpu(gen):
    """A bf16 Plain-style step of an S3DIS-shaped model whose first
    EdgeConv stage has three convs (B1 in that stage, B13 in its backward)
    on the card against the CPU replaying the card's kNN indices,
    in-kernel moments and batch moments: each fused block on its own (the
    stage's first conv among them) within 1e-2, and the whole step within
    chip_smoke.py phase 5's limits (loss 2e-3 relative, every leaf but
    agg_conv.beta within 0.4 of its norm, the null-gradient biases 1.5e-2
    of the largest leaf norm: one-ulp differences grow through the
    batch-moment BNs and flip k-max slots). S3DIS has no transform net and
    no category branch, whose batch norms over 4 clouds would turn those
    one-ulp differences into gradients of their own."""
    from weaksuppointcloudseg_tpu_torch.losses.weaksup import masked_softmax_ce
    from weaksuppointcloudseg_tpu_torch.utils import replay

    cfg = dataclasses.replace(
        static_cfg("s3dis", compute_dtype="bfloat16", knn_fast=True),
        static_graph=False, edge_channels=((64, 64, 64), (64, 64), (64,)))
    x = torch.rand((4, 512, 9), generator=gen, device="cuda")
    seg = torch.randint(0, 12, (4, 512), generator=gen, device="cuda")
    onehot = torch.nn.functional.one_hot(seg, 12).float()
    mask = (torch.rand((4, 512), generator=gen, device="cuda") < 0.3).float()
    outs, tapes, blocks = [], None, None
    for dev in ("cuda", "cpu"):
        model = DGCNNSeg(cfg, seed=4).to(dev)
        before = (edgeconv.knn_edge.launches, scatter.scatter_add.launches)
        ctx = ((replay.record(), replay.record_plain(), replay.record_blocks())
               if dev == "cuda" else
               (replay.replay(tapes[0]), replay.replay_plain(tapes[1]),
                contextlib.nullcontext()))
        with ctx[0] as t0, ctx[1] as t1, ctx[2] as bl:
            logits = model.forward_fused(x.to(dev), None, training=True,
                                         bn_decay=0.5)
        loss = masked_softmax_ce(logits, onehot.to(dev), mask.to(dev))
        loss.backward()
        tapes, blocks = tapes or (t0, t1), blocks or bl
        if dev == "cuda":
            assert (edgeconv.knn_edge.launches - before[0],
                    scatter.scatter_add.launches - before[1]) == (3, 1)
        outs.append((float(loss.detach()),
                     {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (got_l, got_g), (want_l, want_g) = outs
    names = [e["block"].__name__ for e in blocks]
    assert names.count("_EdgeConvBnReluTrain") == 1, names
    for e in blocks:
        errs = replay.block_errors(e)
        assert max(errs.values()) <= 1e-2, (e["block"].__name__, errs)
    assert abs(got_l - want_l) <= 2e-3 * abs(want_l)
    errs, null = replay.grad_errors(model, got_g, want_g)
    # agg_conv.beta is held at the block level only (chip_smoke.py phase
    # 5): the head's batch norm makes the global feature's cotangent sum to
    # zero over the clouds, so its gradient cancels to rounding noise
    bad = {n: e for n, e in errs.items() if n != "agg_conv.beta"
           and e > (1.5e-2 if n in null else 0.4)}
    assert not bad, bad


# ------------------------------------------- fixed-order sums (ROADMAP C16)

def same_bits(a, b) -> bool:
    """Equal bit for bit, NaN payloads aside (a NaN's payload is the
    hardware's choice): the same NaN positions, every other element's bits
    equal (-0 and +0 differ)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        torch.where(na, 0, a).view(ints), torch.where(nb, 0, b).view(ints))


def scatter_graph(gen, case, b, p, k, n):
    """int32 [b, p, k] graphs: random targets, hubs (an all-equal cloud's
    graph: every point's neighbours are rows 0..k-1, each of in-degree p),
    or random targets with some outside [0, n)."""
    if case == "hubs":
        return torch.arange(k, dtype=torch.int32,
                            device="cuda").expand(b, p, k).contiguous()
    idx = torch.randint(0, n, (b, p, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    if case == "outside":
        drop = torch.rand((b, p, k), generator=gen, device="cuda") < 0.05
        idx = torch.where(drop, n + 3, idx).int()
    return idx


@pytest.mark.parametrize("route", [None, "cluster", "chunks"])
@pytest.mark.parametrize("case,b,p,k,n", [
    ("random", 2, 333, 20, 300), ("hubs", 2, 2048, 20, 2048),
    ("outside", 2, 500, 20, 777), ("random", 2, 1001, 20, 4096),
    ("random", 2, 40, 20, 25000), ("random", 2, 4096, 20, 4096),
    ("hubs", 2, 4096, 20, 4096), ("outside", 2, 3500, 20, 3000),
    ("hubs", 1, 2048, 20, 2048), ("outside", 1, 4096, 10, 4096),
    ("random", 1, 7616, 20, 7616), ("random", 1, 7617, 20, 7617),
    ("random", 2, 7, 3, 5)])
def test_inverse_graph_kernel(gen, case, b, p, k, n, route):
    """The inverse-graph build equals its plain version on the CPU (a
    stable sort): offsets and every segment's ascending sources; by the
    route the shape picks (None) and by each route forced, the cluster
    build where its shared memory fits (else its launcher refuses the
    shape) and the three-launch build at every shape. Hubs: an all-equal
    cloud's graph; outside: 5% of targets outside [0, N); P != N; B=1."""
    idx = scatter_graph(gen, case, b, p, k, n)
    if route == "cluster" and scatter.inverse_route(p, k, n)[0] != "cluster":
        with pytest.raises(RuntimeError, match="inverse_graph"):
            scatter._build_inverse(idx, n, route)
        return
    before = scatter.inverse_graph.launches
    got = scatter._build_inverse(idx, n, route)
    assert scatter.inverse_graph.launches == before + 1
    want = scatter.inverse_graph_ref(idx.cpu(), n)
    assert torch.equal(got.offsets.cpu(), want.offsets)
    assert torch.equal(got.src.cpu(), want.src)


def test_inverse_route_mirrors_the_launcher():
    """ops/scatter.py::inverse_route (which sizes the workspace) and the
    C launcher's rule pick the same route, shared memory and workspace."""
    import ctypes

    from weaksuppointcloudseg_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lib = _build.library()
    names = {0: None, 1: "cluster", 2: "chunks"}
    for p, k, n in [(2048, 20, 2048), (4096, 10, 4096), (4096, 20, 4096),
                    (1024, 20, 1024), (3000, 20, 3000), (7616, 20, 7616),
                    (7617, 20, 7617), (8192, 20, 8192), (40, 20, 25000),
                    (100000, 20, 1000), (1000, 20, 58112), (10, 20, 58113),
                    (333, 20, 300), (1, 1, 1), (0, 20, 10), (10, 20, 0)]:
        smem, work = ctypes.c_longlong(), ctypes.c_longlong()
        route = lib.inverse_graph_route(p, k, n, ctypes.byref(smem),
                                        ctypes.byref(work))
        assert (names[route], smem.value, work.value) == \
            scatter.inverse_route(p, k, n), (p, k, n)


@pytest.mark.parametrize("case", ["random", "hubs", "nan", "outside"])
@pytest.mark.parametrize("c", [1, 3, 5, 9, 14, 17, 31, 64, 130])
def test_scatter_add_kernel_bitwise(gen, c, case):
    """B13 equals its plain version run on the CPU bit for bit (both sum
    each row in ascending slot order), and two launches give the same
    bits; N != P; a NaN in g reaches its own row only."""
    b, p, k, n = 2, 333, 20, 300
    idx = scatter_graph(gen, case, b, p, k, n)
    g = torch.randn((b, p, k, c), generator=gen, device="cuda") * torch.exp(
        4 * torch.randn((b, p, k, 1), generator=gen, device="cuda"))
    if case == "nan":
        g[0, 5, 3, 0] = float("nan")
    got = scatter.scatter_add(idx, g, n)
    assert same_bits(got, scatter.scatter_add_ref(idx.cpu(), g.cpu(), n))
    assert same_bits(got, scatter.scatter_add(idx, g, n))


@pytest.mark.parametrize("case", ["random", "hubs"])
@pytest.mark.parametrize("c", [64, 9, 14])
@pytest.mark.parametrize("sparse", [False, True])
def test_scatter_bn_bwd_kernel_bitwise(gen, sparse, c, case):
    """B4's dv and du equal the plain version run on the CPU bit for bit;
    two launches give the same bits."""
    b, p, k, n = 2, 333, 20, 300
    idx = scatter_graph(gen, case, b, p, k, n)
    y = randn(gen, (b, p, k, c))
    sv, al, be = (randn(gen, (c,), torch.float32) for _ in range(3))
    if sparse:
        big = (randn(gen, (b, p, c), torch.float32),
               torch.randint(0, k, (b, p, c), generator=gen, device="cuda",
                             dtype=torch.int32))
        cpu_big = tuple(t.cpu() for t in big)
    else:
        big = randn(gen, (b, p, k, c))
        cpu_big = big.cpu()
    got = scatter.scatter_bn_bwd(idx, y, big, sv, al, be, n)
    want = scatter.scatter_bn_bwd_ref(idx.cpu(), y.cpu(), cpu_big, sv.cpu(),
                                      al.cpu(), be.cpu(), n)
    again = scatter.scatter_bn_bwd(idx, y, big, sv, al, be, n)
    for g_, w_, a_ in zip(got, want, again):
        assert same_bits(g_, w_) and same_bits(g_, a_)


@pytest.mark.parametrize("case", ["random", "hubs", "unaligned"])
@pytest.mark.parametrize("c", [51, 14, 3, 6, 9, 20, 31])
def test_scatter_add_weighted_kernel_bitwise(gen, c, case):
    """B6's scatter equals its plain version run on the CPU bit for bit,
    and two launches give the same bits, at every lane layout of the
    gather (a warp a row at 51; 1, 2, 4 and 8 lanes a row of 4 channels
    below 32); unaligned: ct starts 4 bytes past an 8-byte boundary (no
    float2 pairs)."""
    b, p, k, n = 2, 1001, 10, 1001
    idx = scatter_graph(gen, "random" if case == "unaligned" else case,
                        b, p, k, n)
    w = torch.rand((b, p, k), generator=gen, device="cuda")
    ct = torch.randn((b, p, c), generator=gen, device="cuda")
    if case == "unaligned":
        ct = torch.empty(ct.numel() + 1, device="cuda")[1:].view(b, p, c).copy_(ct)
        assert ct.is_contiguous() and ct.data_ptr() % 8 == 4
    got = scatter.scatter_add_weighted(idx, w, ct, n)
    want = scatter.scatter_add_weighted_ref(idx.cpu(), w.cpu(), ct.cpu(), n)
    assert same_bits(got, want)
    assert same_bits(got, scatter.scatter_add_weighted(idx, w, ct, n))


@pytest.mark.parametrize("case", ["random", "hubs"])
def test_scatters_bitwise_on_chunked_inverse(gen, case):
    """B13, B4 and B6's scatter over graphs of P*k >= 65536 slots (the
    inverse's chunked route, as S3DIS's B4 at 4096 x 20) equal their plain
    versions run on the CPU bit for bit."""
    b, p, k, n, c = 1, 3500, 20, 3000, 9
    idx = scatter_graph(gen, case, b, p, k, n)
    g = torch.randn((b, p, k, c), generator=gen, device="cuda")
    assert same_bits(scatter.scatter_add(idx, g, n),
                     scatter.scatter_add_ref(idx.cpu(), g.cpu(), n))
    y = randn(gen, (b, p, k, c))
    dz = randn(gen, (b, p, k, c))
    sv, al, be = (randn(gen, (c,), torch.float32) for _ in range(3))
    got = scatter.scatter_bn_bwd(idx, y, dz, sv, al, be, n)
    want = scatter.scatter_bn_bwd_ref(idx.cpu(), y.cpu(), dz.cpu(), sv.cpu(),
                                      al.cpu(), be.cpu(), n)
    assert all(same_bits(a, w) for a, w in zip(got, want))
    w = torch.rand((b, p, k), generator=gen, device="cuda")
    ct = torch.randn((b, p, c), generator=gen, device="cuda")
    assert same_bits(scatter.scatter_add_weighted(idx, w, ct, n),
                     scatter.scatter_add_weighted_ref(idx.cpu(), w.cpu(),
                                                      ct.cpu(), n))


def _fixed_order_outputs(gen, kernel):
    """One launch's outputs of a kernel with fixed-order sums, on seeded
    inputs (the generator is reseeded so two calls see the same inputs)."""
    gen.manual_seed(7)
    k = 20
    if kernel in ("B1", "B11"):
        g, v, u = (randn(gen, (3, 701, c)) for c in (3, 64, 64))
        if kernel == "B1":
            return edgeconv.knn_edge(g, v, u, k, fast=True, with_minmax=True,
                                     n_valid=650)
        idx = edgeconv.knn_edge(g, v, u, k, fast=True)[0]
        return edgeconv.knn_edge_pre(idx, v, u, k, with_minmax=True,
                                     n_valid=650)
    if kernel == "B2":
        sc, sh = randn(gen, (64,), torch.float32), randn(gen, (64,), torch.float32)
        return conv_kmax.conv_minmax(randn(gen, (2, 333, k, 64)),
                                     randn(gen, (64, 128), scale=0.2),
                                     randn(gen, (128,), torch.float32), sc, sh)
    if kernel == "B3":
        c2 = 128
        vec = [randn(gen, (64,), torch.float32) for _ in range(5)]
        vec[4] = vec[4].abs() + 0.5
        return conv_kmax.conv_kmax_bwd(
            randn(gen, (2, 333, k, 64)), randn(gen, (2, 333, c2), torch.float32),
            torch.randint(0, k, (2, 333, c2), generator=gen, device="cuda",
                          dtype=torch.int32),
            randn(gen, (c2, 64), scale=0.2), randn(gen, (64, 64), scale=0.05),
            *vec)
    h = randn(gen, (2, 1111, 192))
    w = randn(gen, (192, 1024), scale=0.1)
    bias = randn(gen, (1024,), torch.float32)
    if kernel == "B5 forward":
        return conv_kmax.conv_nmax(h, w, bias)
    asel = torch.randint(0, 1111, (2, 1024), generator=gen, device="cuda",
                         dtype=torch.int32)
    return conv_kmax.conv_nmax_bwd(
        h, randn(gen, (2, 1024), torch.float32), asel, w, bias,
        *(randn(gen, (1024,), torch.float32, 0.01) for _ in range(2)))


@pytest.mark.parametrize("kernel", ["B1", "B11", "B2", "B3", "B5 forward",
                                    "B5 backward"])
def test_fixed_order_kernels_repeat(gen, kernel):
    """Two launches of each kernel that sums across blocks (moments, T_sp,
    G, S1, a1/a2, db, dW) give the same bits: the partials sum in block
    order, with no float atomics."""
    first = _fixed_order_outputs(gen, kernel)
    second = _fixed_order_outputs(gen, kernel)
    assert len(first) == len(second)
    for a, b in zip(first, second):
        assert same_bits(a, b)


def test_bf16_full_step_repeats(gen):
    """A bf16 Full-style step of a narrow ShapeNet model on the fused route
    (B1-B6, the smoothness loss over the transform stage's graph, dropout
    from a seeded generator) repeated from the same state: the losses,
    every gradient and the BN running statistics bit for bit equal."""
    from weaksuppointcloudseg_tpu_torch.train.steps import loss_fn

    base = configs.shapenet_config()
    model_cfg = dataclasses.replace(
        base.model, num_classes=12, num_categories=4, global_channels=128,
        category_embed_channels=8, head_channels=(32, 32, 16),
        compute_dtype="bfloat16", knn_fast=True)
    cfg = dataclasses.replace(base, model=model_cfg)
    x = torch.rand((4, 512, 3), generator=gen, device="cuda")
    batch = {"data": x,
             "seg_onehot": torch.nn.functional.one_hot(torch.randint(
                 0, 12, (4, 512), generator=gen, device="cuda"), 12).float(),
             "mask": (torch.rand((4, 512), generator=gen, device="cuda")
                      < 0.3).float(),
             "cat_onehot": torch.eye(4, device="cuda")[[0, 0, 2, 2]]}
    runs = []
    for _ in range(2):
        model = DGCNNSeg(model_cfg, seed=1).cuda()
        drop = torch.Generator(device="cuda")
        drop.manual_seed(3)
        builds = scatter.inverse_graph.launches
        total, comps, _ = loss_fn(model, batch, cfg=cfg, style="Full",
                                  bn_decay=0.5, gate=1.0, generator=drop)
        total.backward()
        assert scatter.inverse_graph.launches - builds >= 1
        runs.append({**{k: v.detach() for k, v in comps.items()},
                     **{n: p.grad for n, p in model.named_parameters()},
                     **dict(model.named_buffers())})
    assert runs[0].keys() == runs[1].keys()
    for name in runs[0]:
        assert same_bits(runs[0][name], runs[1][name]), name


# ------------------------------------------------------ the room sweep

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", SWEEP_CASES)
def test_room_sweep_on_card_matches_sweep(card, case, dtype, tmp_path,
                                          monkeypatch):
    """load_room on the card: blocks, labels, room_max and the generator
    bitwise the sweep on the CPU over the plain versions, through both
    kernels (none when no block is kept)."""
    room, num_point, min_points = sweep_room(case, np.random.default_rng(5))
    before = (room_sweep.block_members.launches, room_sweep.gather_blocks.launches)
    (res,), same_rng = sweep_on("cuda", [(room.astype(dtype), num_point, min_points)],
                                tmp_path, monkeypatch, 9, plain_sweep)
    assert_sweep_equal(*res, "cuda")
    assert same_rng
    kept = len(res[1][0]) > 0
    assert (room_sweep.block_members.launches, room_sweep.gather_blocks.launches) \
        == (before[0] + 1, before[1] + kept)


def test_room_sweep_on_card_rooms_in_turn(card, tmp_path, monkeypatch):
    """Every case in turn (float64, then float32) on one generator."""
    res, same_rng = sweep_on("cuda", cases_in_turn(), tmp_path, monkeypatch, 11,
                             plain_sweep)
    for got, want in res:
        assert_sweep_equal(got, want, "cuda")
    assert same_rng


def test_room_sweep_on_card_large_room(card, tmp_path, monkeypatch):
    """A surface-sampled 8 x 6 x 3 m room of ~1.5 M float64 points (its far
    walls on block edges), at 4096 points a block: bitwise the sweep on
    the CPU, twice on one reader (the host buffer reused)."""
    room = large_room(np.random.default_rng(3))
    assert 1_400_000 < len(room) < 1_600_000
    res, same_rng = sweep_on("cuda", [(room, 4096, 100)] * 2, tmp_path,
                             monkeypatch, 2**31 + 12345, plain_sweep)
    for got, want in res:
        assert len(want[0]) == 48
        assert_sweep_equal(got, want, "cuda")
    assert same_rng


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", SWEEP_CASES + ["large"])
def test_room_sweep_members_on_card(card, case, dtype):
    """The bucketing kernels' members and counts bitwise their plain
    version's on the CPU (each block's rows in ascending index, edge copies
    merged)."""
    room = (large_room(np.random.default_rng(4)) if case == "large"
            else sweep_room(case, np.random.default_rng(5))[0]).astype(dtype)
    x, y = room[:, 0].astype(np.float64), room[:, 1].astype(np.float64)
    num_x, num_y = int(np.ceil(x.max() - 1)) + 1, int(np.ceil(y.max() - 1)) + 1
    members, counts = room_sweep.block_members_ref(torch.from_numpy(room),
                                                   num_x, num_y)
    got_m, got_c = room_sweep.block_members(torch.from_numpy(room).cuda(),
                                            num_x, num_y)
    assert torch.equal(got_c.cpu(), counts)
    assert torch.equal(got_m[:len(members)].cpu(), members)
