"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (a CUDA kernel
has no CPU or interpret mode). On the GPU machine, which has no JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Shapes are small and ragged (N not a multiple of any tile) to reach the
kernels' edge handling; chip_smoke.py checks the production shapes.
"""

import contextlib
import dataclasses

import pytest
import torch

from weaksuppointcloudseg_tpu_torch import configs
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.ops import (
    affinity,
    conv_kmax,
    edgeconv,
    knn,
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


@pytest.mark.parametrize("cg,fast,n_valid", [
    (3, False, None), (3, True, 600), (64, False, 650), (64, True, None)])
def test_knn_edge_kernel(gen, cg, fast, n_valid):
    """Indices by agreement rate (f32 sums in another order than cuBLAS:
    exact >= 99.9%, fast >= 98%); y1, extrema and moments against the
    plain formulas at the kernel's own indices (bitwise; moments 1e-5 of
    the sum of magnitudes)."""
    b, n, k, c = 3, 701, 20, 64
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
    """B13 against index_add_: f32 atomics sum in a run-dependent order,
    so 1e-5 of the sum of magnitudes of each output element."""
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
            # 5 graphs (transform, 3 stages, smooth loss); 3 gathers' backward
            assert (knn.knn.launches - counts[0],
                    scatter.scatter_add.launches - counts[1]) == (5, 3)
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
    """f32 sums in another order (atomics): tol of the sum of magnitudes."""
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
    the reductions 1e-5 of the sums of magnitudes (atomics)."""
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
    (1e-6 of the magnitudes), dv adds bf16(dy) with atomics (1e-5)."""
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
    moments (utils/replay.py: without it the moments' atomic sums move
    later stages' neighbours among near-ties). Each fused block rerun on
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
    agrees with the CPU; the configurations still unported raise and name
    their kernels."""
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
    unfused = DGCNNSeg(dataclasses.replace(cfg, use_fused_knn=False)).cuda()
    with pytest.raises(NotImplementedError, match="B14"):
        unfused(x, cat)
    f32_unfused = DGCNNSeg(dataclasses.replace(f32_cfg, use_fused_knn=False)).cuda()
    with pytest.raises(NotImplementedError, match="use_fused_knn"):
        f32_unfused(x, cat)


def mag_sum_ok(got, want, mags, tol=1e-5):
    """|got - want| within ``tol`` of the sum of magnitudes of each element
    (f32 sums in another order, ROADMAP C4)."""
    return bool(((got - want).abs() <= tol * mags + 1e-7).all())


@pytest.mark.parametrize("c,n", [(51, 333), (14, 1001)])
def test_scatter_add_weighted_kernel(gen, c, n):
    """B6's scatter against its plain version (index_add_ of the expanded
    w * ct): f32 atomics add in a run-dependent order, so 1e-5 of the sum
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
    (129, 1, False)])
def test_affinity_kernel(gen, n, k, transposed):
    """B10 (transposed) and B17 against their plain versions at odd N, the
    CG's K=13 and the degree pass's K=1, F=6 and F=3."""
    for f in (6, 3):
        feat = torch.rand((2, n, f), generator=gen, device="cuda") * 2.0
        u = torch.randn((2, n, k), generator=gen, device="cuda")
        if transposed:
            feat, u = feat.transpose(1, 2).contiguous(), u.transpose(1, 2).contiguous()
        fn = affinity.affinity_matvec_t if transposed else affinity.affinity_matvec
        before = fn.launches
        got = fn(feat, u)
        torch.cuda.synchronize()
        assert fn.launches == before + 1 and got.shape == u.shape
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
    """K above 16, F above 6, a tile mask of another shape, and operands
    on two devices raise."""
    feat_t = torch.rand((1, 6, 300), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="K=17"):
        affinity.affinity_matvec_t(feat_t, torch.ones((1, 17, 300), device="cuda"))
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
    calls, masks = [], []
    cg, mask_fn = label_prop._cg, affinity.skip_mask_t

    def counting_cg(matvec, *a, **kw):
        def mv(v):
            calls.append(1)
            return matvec(v)
        return cg(mv, *a, **kw)

    def counting_mask(*a, **kw):
        masks.append(1)
        return mask_fn(*a, **kw)
    monkeypatch.setattr(label_prop, "_cg", counting_cg)
    monkeypatch.setattr(affinity, "skip_mask_t", counting_mask)
    before = affinity.affinity_matvec_t.launches
    got = label_prop.propagate_batch(xyz, g, rgb, solver="cg_matfree")
    torch.cuda.synchronize()
    assert affinity.affinity_matvec_t.launches - before == 1 + len(calls) > 1
    assert len(masks) == 1
    want = label_prop.propagate_batch(xyz.cpu(), g.cpu(), rgb.cpu(),
                                      solver="cg_matfree")
    for y in (got.cpu(), want):
        assert (y.argmax(-1) != g.argmax(-1).cpu()).float().mean().item() >= 0.03
    assert (got.cpu() - want).abs().max().item() <= 1e-3
    assert (got.argmax(-1).cpu() == want.argmax(-1)).float().mean().item() >= 0.999


# ------------------------------------------------------ B11 (static graph)

def b11_check(got, want, nv):
    """y1 and the extrema bitwise, the moments within 1e-5 of the sum of
    magnitudes (f32 atomics in another order, ROADMAP C4)."""
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
    magnitudes before its bf16 rounding plus one ulp (B13's atomics)."""
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
