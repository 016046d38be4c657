"""The inverse kNN graph and the fixed-order gather-sum that kernels B13,
B4 and B6 compute on the card (ops/scatter.py, ops/csrc/scatter_add.cu,
csr_gather.cuh), held on the CPU:

- ``inverse_graph_ref`` (the plain version the kernel is held to) against
  a numpy construction: offsets, and every destination's sources in
  ascending flat slot order, on ragged in-degrees, hubs, targets outside
  [0, N) and empty rows;
- the sum in CSR order (``gather_sum_ref``) against the plain scatters
  bit for bit, for B13, B4 (dense and sparse) and B6, on shapes drawn by
  hypothesis: the kernels sum in that order, so their equality with the
  plain versions rests on it;
- the port's route against the Pallas kernels in interpret mode, to the
  tolerance stated at each;
- the inverse's independence of the other clouds of the batch;
- the build's route rule (``inverse_route``, the mirror of
  ``scatter_add.cu::inverse_graph_route``): which shapes take the cluster
  build, with its shared memory, and which the three-launch build, up to
  the documented row limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from weaksuppointcloudseg_tpu.ops.scatter_pallas import (
    scatter_add_pallas,
    scatter_add_weighted_pallas,
    scatter_bn_bwd_pallas,
)
from weaksuppointcloudseg_tpu_torch.ops import scatter

torch.set_num_threads(1)


def same_bits(a, b) -> bool:
    """Equal bit for bit, NaN payloads aside (a NaN's payload is the
    hardware's choice): the same NaN positions, every other element's
    bits equal (so -0 and +0 differ)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    na, nb = np.isnan(a), np.isnan(b)
    zero = np.float32(0)
    return (a.shape == b.shape and np.array_equal(na, nb) and np.array_equal(
        np.where(na, zero, a).view(np.int32), np.where(nb, zero, b).view(np.int32)))


def numpy_inverse(idx, n):
    """(offsets [B, n+1], src [B, P*k]) by a loop over rows: each row's
    slots in ascending order, skipped slots' places -1."""
    b, p, k = idx.shape
    flat = idx.reshape(b, p * k)
    offsets = np.zeros((b, n + 1), np.int32)
    src = np.full((b, p * k), -1, np.int32)
    for bi in range(b):
        pos = 0
        for t in range(n):
            slots = np.nonzero(flat[bi] == t)[0]
            offsets[bi, t] = pos
            src[bi, pos:pos + len(slots)] = slots
            pos += len(slots)
        offsets[bi, n] = pos
    return offsets, src


def graphs():
    """(name, idx, n): the graph shapes the inverse must handle."""
    rng = np.random.default_rng(0)
    ragged = rng.integers(0, 30, (2, 30, 5)).astype(np.int32)
    ragged[:, :, 0] = np.arange(30) % 3  # rows 0-2 take many sources
    hubs = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 40, 6)).copy()
    outside = rng.integers(-3, 23, (2, 17, 4)).astype(np.int32)
    empty = rng.integers(0, 10, (3, 12, 3)).astype(np.int32)  # n = 50
    dupes = rng.integers(0, 4, (1, 9, 7)).astype(np.int32)  # repeats in a row
    return [("ragged", ragged, 30), ("hubs of in-degree P", hubs, 40),
            ("targets outside [0, N)", outside, 20), ("empty rows, N != P",
                                                      empty, 50),
            ("repeated targets in a row", dupes, 4),
            ("k = 1", rng.integers(0, 8, (2, 8, 1)).astype(np.int32), 8)]


@pytest.mark.parametrize("name,idx,n", graphs(), ids=[g[0] for g in graphs()])
def test_inverse_graph_matches_numpy(name, idx, n):
    inv = scatter.inverse_graph(torch.from_numpy(idx), n)
    offsets, src = numpy_inverse(idx, n)
    assert inv.k == idx.shape[2]
    assert inv.offsets.dtype == inv.src.dtype == torch.int32
    np.testing.assert_array_equal(inv.offsets.numpy(), offsets)
    np.testing.assert_array_equal(inv.src.numpy(), src)


def test_hub_segments_ascend():
    """An all-equal cloud (every point's k nearest are points 0..k-1, ties
    to the lowest index): rows 0..k-1 take all P points, in order."""
    p, k = 64, 5
    idx = torch.arange(k, dtype=torch.int32).expand(1, p, k).contiguous()
    inv = scatter.inverse_graph(idx, p)
    offs = inv.offsets[0].numpy()
    np.testing.assert_array_equal(np.diff(offs)[:k], p)
    np.testing.assert_array_equal(np.diff(offs)[k:], 0)
    for t in range(k):
        np.testing.assert_array_equal(
            inv.src[0, offs[t]:offs[t + 1]].numpy(), np.arange(p) * k + t)


def spread_values(rng, shape):
    """Normal values times magnitudes spread over 8 decades: sums in
    another order would differ in their last bits."""
    mags = 10.0 ** rng.uniform(-4, 4, shape[:-1] + (1,))
    return (rng.standard_normal(shape) * mags).astype(np.float32)


shapes = st.tuples(st.integers(1, 3), st.integers(1, 40), st.integers(1, 8),
                   st.integers(1, 50), st.integers(1, 9), st.integers(0, 2**31))


def draw_graph(rng, b, p, k, n):
    """Targets concentrated on a few rows (many adds each), with a few
    outside [0, n)."""
    idx = rng.integers(0, max(1, n // 3), (b, p, k))
    idx[rng.random((b, p, k)) < 0.05] = n + 1
    idx[rng.random((b, p, k)) < 0.05] = -1
    return idx.astype(np.int32)


@settings(max_examples=40, deadline=None, database=None)
@given(shapes)
def test_csr_order_sum_equals_scatter_add_bitwise(shape):
    """B13: the CSR-order sum is the plain index_add_ bit for bit, and so
    is numpy's unbuffered add in index order."""
    b, p, k, n, c, seed = shape
    rng = np.random.default_rng(seed)
    idx = draw_graph(rng, b, p, k, n)
    g = spread_values(rng, (b, p, k, c))
    ti, tg = torch.from_numpy(idx), torch.from_numpy(g)
    got = scatter.gather_sum_ref(scatter.inverse_graph(ti, n),
                                 tg.reshape(b, p * k, c))
    want = scatter.scatter_add(ti, tg, n)  # the CPU route: the plain version
    ok = (idx >= 0) & (idx < n)
    rows = (idx + np.arange(b)[:, None, None] * n)[ok]
    ref = np.zeros((b * n, c), np.float32)
    np.add.at(ref, rows, g[ok])
    assert same_bits(got, want)
    assert same_bits(want, ref.reshape(b, n, c))


def test_csr_order_sum_keeps_nan_and_signed_zero():
    """A NaN reaches only its own row; -0 contributions leave +0."""
    idx = torch.tensor([[[0, 1], [1, 2], [2, 0]]], dtype=torch.int32)
    g = torch.zeros((1, 3, 2, 2))
    g[0, 0, 0, 0] = float("nan")
    g[0, 1, :, 1] = -0.0
    g[0, 2, 0, 0] = 1.5
    got = scatter.gather_sum_ref(scatter.inverse_graph(idx, 4),
                                 g.reshape(1, 6, 2))
    want = scatter.scatter_add_ref(idx, g, 4)
    assert same_bits(got, want)
    assert torch.isnan(got[0, 0, 0]) and not torch.isnan(got[0, 1:]).any()


def bn_dy(y, big, sv, al, be, k):
    """B4's f32 dy = (first + alpha) + beta * y, as the plain version."""
    if isinstance(big, tuple):
        q, asel = big
        onek = asel[:, :, None, :] == torch.arange(k)[:, None]
        first = torch.where(onek, q[:, :, None, :], 0.0)
    else:
        first = sv * big.float()
    return (first + al) + be * y.float()


@settings(max_examples=30, deadline=None, database=None)
@given(shapes, st.booleans())
def test_csr_order_sum_equals_scatter_bn_bwd_bitwise(shape, sparse):
    """B4: dv is the CSR-order sum of bf16(dy), bit for bit the plain
    version's; du sums the f32 dy over the slots in order from zero, as
    the kernel does."""
    b, p, k, n, c, seed = shape
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(draw_graph(rng, b, p, k, n))
    y = torch.from_numpy(spread_values(rng, (b, p, k, c))).bfloat16()
    sv, al, be = (torch.from_numpy(rng.standard_normal(c).astype(np.float32))
                  for _ in range(3))
    if sparse:
        big = (torch.from_numpy(spread_values(rng, (b, p, c))),
               torch.from_numpy(rng.integers(0, k, (b, p, c)).astype(np.int32)))
    else:
        big = torch.from_numpy(spread_values(rng, (b, p, k, c))).bfloat16()
    dv, du = scatter.scatter_bn_bwd(idx, y, big, sv, al, be, n)
    dyb = bn_dy(y, big, sv, al, be, k).to(torch.bfloat16)
    got = scatter.gather_sum_ref(scatter.inverse_graph(idx, n),
                                 dyb.reshape(b, p * k, c))
    assert same_bits(got, dv)
    dy = bn_dy(y, big, sv, al, be, k)
    want_du = torch.zeros_like(dy[:, :, 0])
    for j in range(k):
        want_du = want_du + dy[:, :, j]
    assert same_bits(du, want_du)


@settings(max_examples=30, deadline=None, database=None)
@given(shapes)
def test_csr_order_sum_equals_scatter_add_weighted_bitwise(shape):
    """B6: the CSR-order sum of w * ct, each slot's product formed as the
    kernel forms it, is the plain version bit for bit."""
    b, p, k, n, c, seed = shape
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(draw_graph(rng, b, p, k, n))
    w = torch.from_numpy(rng.random((b, p, k)).astype(np.float32))
    ct = torch.from_numpy(spread_values(rng, (b, p, c)))
    want = scatter.scatter_add_weighted(idx, w, ct, n)
    assert same_bits(want, scatter.scatter_add_weighted_ref(idx, w, ct, n))
    vals = w[..., None] * ct[:, :, None, :]
    got = scatter.gather_sum_ref(scatter.inverse_graph(idx, n),
                                 vals.reshape(b, p * k, c))
    assert same_bits(got, want)


def test_port_route_matches_scatter_add_pallas():
    """B13 against the Pallas kernel in interpret mode: the Pallas kernel
    sums in one-hot-matmul order, so 1e-5 of the sum of magnitudes."""
    rng = np.random.default_rng(3)
    b, p, k, n, c = 2, 48, 6, 40, 9
    idx = rng.integers(0, 12, (b, p, k)).astype(np.int32)
    g = rng.standard_normal((b, p, k, c)).astype(np.float32)
    want = np.asarray(scatter_add_pallas(jnp.asarray(idx), jnp.asarray(g), n,
                                         tile_rows=16, interpret=True))
    ti = torch.from_numpy(idx)
    got = scatter.gather_sum_ref(scatter.inverse_graph(ti, n),
                                 torch.from_numpy(g).reshape(b, p * k, c))
    mags = scatter.scatter_add_ref(ti, torch.from_numpy(np.abs(g)), n)
    assert np.all(np.abs(got.numpy() - want) <= 1e-5 * mags.numpy() + 1e-30)


@pytest.mark.parametrize("sparse", [False, True])
def test_port_route_matches_scatter_bn_bwd_pallas(sparse):
    """B4 against the Pallas kernel in interpret mode: dv within 1e-5 of
    the sum of magnitudes (one-hot-matmul order), du within 1e-6."""
    rng = np.random.default_rng(4)
    b, p, k, n, c = 2, 24, 5, 30, 8
    idx = rng.integers(0, n, (b, p, k)).astype(np.int32)
    y = rng.standard_normal((b, p, k, c)).astype(np.float32)
    sv, al, be = (rng.standard_normal(c).astype(np.float32) * 0.1
                  for _ in range(3))
    tybf = torch.from_numpy(y).bfloat16()
    jy = jnp.asarray(tybf.float().numpy()).astype(jnp.bfloat16)
    if sparse:
        q = rng.standard_normal((b, p, c)).astype(np.float32)
        asel = rng.integers(0, k, (b, p, c)).astype(np.int32)
        jbig = (jnp.asarray(q), jnp.asarray(asel))
        tbig = (torch.from_numpy(q), torch.from_numpy(asel))
    else:
        dz = torch.from_numpy(rng.standard_normal((b, p, k, c)).astype(
            np.float32)).bfloat16()
        jbig = jnp.asarray(dz.float().numpy()).astype(jnp.bfloat16)
        tbig = dz
    want_dv, want_du = scatter_bn_bwd_pallas(
        jnp.asarray(idx), jy, jbig, jnp.asarray(sv), jnp.asarray(al),
        jnp.asarray(be), n, tile_rows=16, interpret=True)
    ti, tsv, tal, tbe = (torch.from_numpy(a) for a in (idx, sv, al, be))
    dy = bn_dy(tybf, tbig, tsv, tal, tbe, k)
    got_dv = scatter.gather_sum_ref(scatter.inverse_graph(ti, n),
                                    dy.to(torch.bfloat16).reshape(b, p * k, c))
    _, got_du = scatter.scatter_bn_bwd(ti, tybf, tbig, tsv, tal, tbe, n)
    mag = dy.abs()
    dv_mag = scatter.scatter_add_ref(ti, mag, n).numpy()
    assert np.all(np.abs(got_dv.numpy() - np.asarray(want_dv))
                  <= 1e-5 * dv_mag + 1e-30)
    assert np.all(np.abs(got_du.numpy() - np.asarray(want_du))
                  <= 1e-6 * mag.sum(2).numpy() + 1e-30)


def test_port_route_matches_scatter_add_weighted_pallas():
    """B6 against the Pallas kernel in interpret mode: 1e-6 of the sum of
    magnitudes (the plain version's bound against the same kernel)."""
    rng = np.random.default_rng(5)
    b, p, k, n, c = 2, 36, 4, 39, 14
    idx = rng.integers(0, n, (b, p, k)).astype(np.int32)
    w = rng.random((b, p, k)).astype(np.float32)
    ct = rng.standard_normal((b, p, c)).astype(np.float32)
    want = np.asarray(scatter_add_weighted_pallas(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(ct), n, interpret=True))
    tw, tct = torch.from_numpy(w), torch.from_numpy(ct)
    vals = tw[..., None] * tct[:, :, None, :]
    got = scatter.gather_sum_ref(scatter.inverse_graph(torch.from_numpy(idx), n),
                                 vals.reshape(b, p * k, c))
    mags = scatter.scatter_add_weighted_ref(torch.from_numpy(idx), tw,
                                            tct.abs(), n)
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 * mags.numpy() + 1e-30)


def test_scatters_skip_targets_outside():
    idx = torch.tensor([[[0, 5], [-1, 1]]], dtype=torch.int32)
    out = scatter.scatter_add(idx, torch.ones((1, 2, 2, 3)), 2)
    np.testing.assert_array_equal(out[0].numpy(), [[1, 1, 1], [1, 1, 1]])
    w = torch.ones((1, 2, 2))
    outw = scatter.scatter_add_weighted(idx, w, torch.full((1, 2, 3), 2.0), 2)
    np.testing.assert_array_equal(outw[0].numpy(), [[2, 2, 2], [2, 2, 2]])


def test_inverse_graph_clouds_are_independent():
    """The CSR is per cloud: each cloud's offsets and sources (slots
    counted from its own first point) are those of the cloud alone."""
    rng = np.random.default_rng(7)
    idx = torch.from_numpy(rng.integers(-2, 12, (3, 9, 4)).astype(np.int32))
    whole = scatter.inverse_graph(idx, 10)
    for b in range(3):
        one = scatter.inverse_graph(idx[b:b + 1], 10)
        np.testing.assert_array_equal(whole.offsets[b].numpy(),
                                      one.offsets[0].numpy())
        np.testing.assert_array_equal(whole.src[b].numpy(), one.src[0].numpy())


@pytest.mark.parametrize("what,p,k,n,smem", [
    ("ShapeNet training and eval", 2048, 20, 2048, 62_608),
    ("S3DIS, the smoothness loss (k=10)", 4096, 10, 4096, 104_592),
    ("S3DIS, B4's graph (k=20)", 4096, 20, 4096, 125_072),
    ("the classifier", 1024, 20, 1024, 31_376),
    ("ShapeNet test views", 3000, 20, 3000, 91_644),
    ("the largest square graph at k=20", 7616, 20, 7616, 232_432),
    ("P != N", 333, 20, 300, 4 * (5 * 300 + 833 + 38 + 36)),
    ("one slot", 1, 1, 1, 4 * (5 + 1 + 1 + 36)),
])
def test_inverse_route_cluster_shapes(what, p, k, n, smem):
    """The shapes that take the one-launch cluster build, each with its
    block's shared memory: 4 ((4 + 1) N + ceil(P k / 8) + ceil(N / 8) +
    36) bytes (eight warps' 16-bit cursors, two a word; the block's
    cursors; its places, its rows' offsets and the scan's sums), within
    the 227 KB a block can use, and no workspace."""
    assert scatter.inverse_route(p, k, n) == ("cluster", smem, 0)
    assert smem <= 227 * 1024


@pytest.mark.parametrize("p,k,n,warps", [
    (7617, 20, 7617, 7),        # just past the cluster build
    (8192, 20, 8192, 7),        # the place blocks' warps shrink with N
    (40, 20, 25_000, 2),
    (100_000, 20, 1000, 8),     # few rows, too many slots for a cluster
    (1000, 20, 58_112, 1),      # the documented row limit
])
def test_inverse_route_chunk_shapes(p, k, n, warps):
    """Past the cluster build's shared memory, and up to 58,112 rows, the
    three-launch build: its place blocks take as many warps' histograms
    as 227 KB holds, and its workspace is ceil(P k / 4096) N ints per
    cloud."""
    route, smem, work = scatter.inverse_route(p, k, n)
    assert route == "chunks"
    assert smem == 4 * warps * n <= 227 * 1024
    assert work == -(-(p * k) // 4096) * n


def test_inverse_route_limits():
    """No route past 58,112 rows or for an empty row count; the rule is
    monotone in N at the presets' k: once the cluster build stops fitting,
    no larger N takes it."""
    assert scatter.inverse_route(10, 20, 58_113) == (None, 0, 0)
    assert scatter.inverse_route(10, 20, 0) == (None, 0, 0)
    for k in (10, 20):
        routes = [scatter.inverse_route(n, k, n)[0] for n in range(6000, 10000, 7)]
        last = max(i for i, r in enumerate(routes) if r == "cluster")
        assert set(routes[last + 1:]) == {"chunks"}
