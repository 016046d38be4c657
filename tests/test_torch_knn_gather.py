"""Kernel B15 (``ops/knn_gather.py``: kNN + neighbour-row gather, its
plain version here) and its routes against the JAX package on the CPU.

- ``knn_gather`` / ``knn_gather_with_sqdist`` against
  ``edgeconv_pallas.knn_gather`` / ``knn_gather_with_sqdist`` in
  interpret mode: bf16 and f32 points and rows, Cf = 3, 9, 16, exact and
  fast selection; their VJPs (``df`` through kernel B13's plain version).
- ``edge_feature_fused`` against the JAX function.
- ``neighbors.neighbor_features_auto`` / ``edge_feature_auto`` with bf16
  features and ``use_fused``: B15's route, against the JAX functions on
  their fused branch (``neighbors``' backend gate patched to claim a TPU,
  the kernel in interpret mode); f32 features keep B12 + the gather.
- ``knn_graph_fused`` on bf16 points (widened exactly to f32).

Sizes: B=2, N=64, Cg=16, k=6 (N=48 at Cg=3).

Tolerances. Exact mode: indices equal on these tie-free inputs; rows
bitwise (a copy on both sides: the interpret-mode one-hot product has one
nonzero term); the selected squared distances within 4 f32 ulps of the
distance scale max |d| (another summation order of the Gram; measured
1.17 ulps). Fast mode: index agreement >= 0.99 (measured 1.0 here; the
packed keys drop the low idx_bits of the distances on both sides, so
only keys equal after the drop can order differently); rows and
distances checked at the port's own indices. ``df``: f32 within 1e-5 of
the sums of magnitudes that reach each row (ROADMAP C4; measured
bitwise); bf16: the JAX VJP scatter-adds into a bf16 buffer, rounding
after every add, the port sums in f32 and rounds once, so the two differ
by at most (m + 1) half-ulps of the scattered magnitudes, m the largest
number of contributions to one row (m = 26 here: 0.053 of the
magnitudes; measured 0.0076). The edge features' f gets k more
contributions per row through the central term (m + k + 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeTpuJax
from test_torch_fused_blocks import np32
from weaksuppointcloudseg_tpu.ops import edgeconv_pallas as jep
from weaksuppointcloudseg_tpu.ops import neighbors as jnb
from weaksuppointcloudseg_tpu_torch.ops import knn, neighbors
from weaksuppointcloudseg_tpu_torch.ops import knn_gather as kg

torch.set_num_threads(1)

B, N, CG, K = 2, 64, 16, 6
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float32": (torch.float32, jnp.float32)}


def inputs(seed, dtype, cf, cg=CG, n=N):
    """(g, f) as torch tensors of ``dtype`` and the same values in JAX."""
    rng = np.random.default_rng(seed)
    tdt, jdt = DTYPES[dtype]
    g = jnp.asarray(rng.standard_normal((B, n, cg)).astype(np.float32), jdt)
    f = jnp.asarray(rng.standard_normal((B, n, cf)).astype(np.float32), jdt)
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
    return to_t(g), to_t(f), g, f


def assert_sqd_close(got, want, g):
    """Within 4 f32 ulps of the distance scale."""
    scale = float(knn.distances(g).abs().max())
    np.testing.assert_allclose(np32(got), np32(want), rtol=0,
                               atol=4 * 2.0 ** -23 * scale)


def rows_at(f, idx):
    """f[b, idx[b, n, j]] in numpy f32."""
    return np32(f)[np.arange(B)[:, None, None], idx.numpy()]


@pytest.mark.parametrize("cf", [3, 9, 16])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_exact_matches_pallas(dtype, cf):
    """Exact mode: idx equal, rows bitwise, sqd within 4 ulps, against
    knn_gather_with_sqdist in interpret mode; knn_gather's outputs are its
    first two."""
    cg, n = (3, 48) if cf == 3 else (CG, N)
    gt, ft, gj, fj = inputs(cf, dtype, cf, cg, n)
    idx, nbr, sqd = kg.knn_gather_with_sqdist(gt, ft, K)
    wi, wn, ws = jep.knn_gather_with_sqdist(gj, fj, K, 256, True, False)
    assert idx.dtype == torch.int32 and nbr.dtype == ft.dtype
    assert nbr.shape == (B, n, K, cf) and sqd.dtype == torch.float32
    assert np.array_equal(idx.numpy(), np.asarray(wi))
    assert np.array_equal(np32(nbr), np32(wn))
    assert_sqd_close(sqd, ws, gt)
    assert torch.equal(idx[:, :, 0], torch.arange(n).expand(B, n))
    i2, n2 = kg.knn_gather(gt, ft, K)
    assert torch.equal(i2, idx) and torch.equal(n2, nbr)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fast_mode_agreement(dtype):
    """Fast mode against the Pallas kernel's fast mode: agreement rate;
    at the port's own indices, rows are f[idx] and sqd the clamped
    distances with the low idx_bits dropped."""
    gt, ft, gj, fj = inputs(7, dtype, 16)
    idx, nbr, sqd = kg.knn_gather_with_sqdist(gt, ft, K, fast=True)
    wi = np.asarray(jep.knn_gather(gj, fj, K, 256, True, True)[0])
    agree = float((idx.numpy() == wi).mean())
    assert agree >= 0.99, agree
    assert np.array_equal(np32(nbr), rows_at(ft, idx))
    d = torch.gather(knn.distances(gt), 2, idx.long()).clamp_min(0.0)
    keep = ~((1 << knn.idx_bits(N)) - 1)
    assert torch.equal(sqd, (d.view(torch.int32) & keep).view(torch.float32))


def scatter_bound(idx, ct, n):
    """(sums of |ct| reaching each row [B*n, C], the largest number of
    contributions to one row)."""
    flat = (idx.numpy() + np.arange(B)[:, None, None] * n).reshape(-1)
    mags = np.zeros((B * n, ct.shape[-1]))
    np.add.at(mags, flat, np.abs(np32(ct)).astype(np.float64).reshape(
        -1, ct.shape[-1]))
    return mags, np.bincount(flat, minlength=B * n).max()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_vjp_matches_jax(dtype):
    """df of knn_gather under a random cotangent of the rows against the
    JAX custom_vjp; g gets no gradient."""
    gt, ft, gj, fj = inputs(11, dtype, 16)
    rng = np.random.default_rng(12)
    tdt, jdt = DTYPES[dtype]
    ct = jnp.asarray(rng.standard_normal((B, N, K, 16)).astype(np.float32), jdt)
    _, vjp = jax.vjp(lambda a: jep.knn_gather(gj, a, K, 256, True, False)[1],
                     fj)
    (want,) = vjp(ct)
    ft.requires_grad_()
    gt.requires_grad_()
    idx, nbr = kg.knn_gather(gt, ft, K)
    nbr.backward(torch.from_numpy(np.array(ct.astype(jnp.float32))).to(tdt))
    assert gt.grad is None and ft.grad.dtype == tdt
    mags, m = scatter_bound(idx, ct, N)
    err = np.abs(np32(ft.grad) - np32(want)).reshape(B * N, -1)
    tol = 1e-5 * mags if dtype == "float32" else (m + 1) * 2.0 ** -9 * mags
    assert np.all(err <= tol + 1e-7)


def test_edge_feature_fused_matches_jax():
    gt, ft, gj, fj = inputs(13, "bfloat16", 16)
    got = kg.edge_feature_fused(gt, ft, K)
    want = jep.edge_feature_fused(gj, fj, K, interpret=True)
    assert got.shape == (B, N, K, 32) and got.dtype == torch.bfloat16
    assert np.array_equal(np32(got), np32(want))


@pytest.fixture
def fused_neighbors_jax(monkeypatch):
    """JAX's neighbors module on its fused branch: the backend gate claims
    a TPU and knn_gather runs in interpret mode. Counts its calls."""
    calls = []
    gather = jep.knn_gather

    def interpreted(g, f, k, row_tile, _interpret, fast):
        calls.append(f.dtype)
        return gather(g, f, k, row_tile, True, fast)

    monkeypatch.setattr(jnb, "jax", FakeTpuJax())
    monkeypatch.setattr(jep, "knn_gather", interpreted)
    return calls


@pytest.fixture
def b15_calls(monkeypatch):
    calls = []
    gather = kg.knn_gather

    def spy(*a, **kw):
        calls.append(a[1].dtype)
        return gather(*a, **kw)

    monkeypatch.setattr(neighbors, "knn_gather", spy)
    return calls


@pytest.mark.parametrize("edge", [False, True])
def test_auto_routes_bf16_through_b15(fused_neighbors_jax, b15_calls, edge):
    """neighbor_features_auto / edge_feature_auto, bf16 features,
    use_fused: both packages take their fused kernel; outputs bitwise,
    gradients to f as test_vjp_matches_jax holds them."""
    gt, ft, gj, fj = inputs(17, "bfloat16", 16)
    jfn = jnb.edge_feature_auto if edge else jnb.neighbor_features_auto
    pfn = neighbors.edge_feature_auto if edge else neighbors.neighbor_features_auto
    want, vjp = jax.vjp(lambda a: jfn(gj, a, K, use_fused=True), fj)
    ft.requires_grad_()
    got = pfn(gt, ft, K, use_fused=True)
    assert fused_neighbors_jax == [jnp.bfloat16]
    assert b15_calls == [torch.bfloat16]
    assert np.array_equal(np32(got), np32(want))
    rng = np.random.default_rng(18)
    ct = rng.standard_normal(got.shape).astype(np.float32)
    (want_df,) = vjp(jnp.asarray(ct, jnp.bfloat16))
    got.backward(torch.from_numpy(ct).bfloat16())
    ct_rows = ct[..., 16:] if edge else ct  # the rows' part of the cotangent
    idx = kg.knn_gather(gt, ft.detach(), K)[0]
    mags, m = scatter_bound(idx, torch.from_numpy(ct_rows).bfloat16(), N)
    if edge:  # the central rows' 2k cotangents (f_i and -f_i) reach f too
        a = np.abs(np32(torch.from_numpy(ct).bfloat16())).sum(2)
        mags += (a[..., :16] + a[..., 16:]).reshape(B * N, -1)
    err = np.abs(np32(ft.grad) - np32(want_df)).reshape(B * N, -1)
    assert np.all(err <= (m + K + 1) * 2.0 ** -9 * mags + 1e-7)


def test_auto_routes_f32_and_unfused_elsewhere(b15_calls):
    """f32 features with use_fused take B12 + the gather, and without
    use_fused the plain distance + sort: B15 is not called; the rows equal
    B15's plain version's on the same graph."""
    gt, ft, _, _ = inputs(19, "float32", 16)
    fused = neighbors.neighbor_features_auto(gt, ft, K, use_fused=True)
    plain = neighbors.neighbor_features_auto(gt, ft.bfloat16(), K,
                                             use_fused=False)
    assert b15_calls == []
    assert torch.equal(fused, kg.knn_gather_ref(gt, ft, K)[1])
    assert torch.equal(plain, kg.knn_gather_ref(gt, ft.bfloat16(), K)[1])


def test_knn_graph_fused_takes_bf16_points():
    """bf16 points are widened exactly: the graph of the f32 copy."""
    gt, _, _, _ = inputs(23, "bfloat16", 16)
    got = neighbors.knn_graph_fused(gt, K)
    assert got.dtype == torch.int32
    assert torch.equal(got, neighbors.knn_graph_fused(gt.float(), K))
    assert torch.equal(got, kg.knn_gather(gt, gt, K)[0])


def test_unsupported_device_raises():
    g = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kg.knn_gather(g, g, 2)
