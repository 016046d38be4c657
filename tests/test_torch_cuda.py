"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present (a CUDA kernel
has no CPU or interpret mode). On the GPU machine, which has no JAX:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Shapes are small and ragged (N not a multiple of any tile) to reach the
kernels' edge handling; chip_smoke.py checks the production shapes.
"""

import dataclasses

import pytest
import torch

from weaksuppointcloudseg_tpu_torch import configs
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.ops import conv_kmax, edgeconv, knn, scatter

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


def test_model_gate_on_cuda(gen):
    """bf16 + fused kNN runs the fused kernels (counters grow) and agrees
    with the same composition over the plain versions on the CPU; f32 +
    use_fused_knn runs B12 at eval and agrees with the CPU; the
    configurations still unported raise and name their kernels."""
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
    with pytest.raises(NotImplementedError, match="B2-B6"):
        model.cuda()(x, cat, training=True, bn_decay=0.5)
    unfused = DGCNNSeg(dataclasses.replace(cfg, use_fused_knn=False)).cuda()
    with pytest.raises(NotImplementedError, match="B14"):
        unfused(x, cat)
    f32_unfused = DGCNNSeg(dataclasses.replace(f32_cfg, use_fused_knn=False)).cuda()
    with pytest.raises(NotImplementedError, match="use_fused_knn"):
        f32_unfused(x, cat)
