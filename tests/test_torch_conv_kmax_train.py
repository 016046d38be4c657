"""Training kernels B2, B3, B4 and B5's plain versions (ops/conv_kmax.py,
ops/scatter.py) against the JAX package's Pallas kernels in interpret
mode: conv_minmax_pallas (B2), conv_kmax_bwd_pallas (B3),
scatter_bn_bwd_pallas (B4, dense and sparse), conv_nmax_pallas and
conv_nmax_bwd_pallas (B5). The wrappers take the plain versions on CPU
tensors; the CUDA kernels are held to them on the card (chip_smoke.py,
tests/test_torch_cuda.py).

Two kinds of input. Random bf16 values: f32 sums run in another order, so
values are held to one bf16 ulp (2^-7 relative) where they are rounded and
to 1e-5 of the sum of magnitudes where they are not. Small integers
(``exact`` cases): every product and sum is exact in f32 whatever the
order, so both sides must agree bitwise, and the many ties among small
integers check the first-winner rule (lowest slot, lowest row). B2 and B3
always fold BN1 (the no-fold mode serves no preset and is not ported).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaksuppointcloudseg_tpu.ops.conv_kmax_pallas import (
    conv_kmax_bwd_pallas,
    conv_minmax_pallas,
    conv_nmax_bwd_pallas,
    conv_nmax_pallas,
)
from weaksuppointcloudseg_tpu.ops.scatter_pallas import scatter_bn_bwd_pallas
from weaksuppointcloudseg_tpu_torch.ops import conv_kmax, scatter

torch.set_num_threads(1)
ULP = 2.0 ** -7  # one bf16 ulp, relative


def values(rng, shape, exact, scale=1.0, lo=-3, hi=4):
    """bf16-exact f32 values: small integers (exact) or rounded normals."""
    if exact:
        return rng.integers(lo, hi, shape).astype(np.float32)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def fold_consts(rng, c, exact):
    """BN1 fold (scale, shift) with negative scales; powers of two and
    integers when exact."""
    if exact:
        return (rng.choice([-1.0, 0.5, 1.0, 2.0], c).astype(np.float32),
                rng.integers(-1, 2, c).astype(np.float32))
    s = f32(rng, (c,), 0.5) + 0.2
    s[::4] = -s[::4]
    return s, f32(rng, (c,), 0.1)


def jbf(x):
    return jnp.asarray(x, jnp.bfloat16)


def tbf(x):
    return torch.tensor(x).bfloat16()


def np32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def close_sums(got, want, mags, tol=1e-5):
    """f32 sums in another order: within ``tol`` of the sum of magnitudes."""
    got, want, mags = np32(got), np32(want), np32(mags)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol * (np.abs(mags) + 1e-6)), \
        np.max(np.abs(got - want))


# -------------------------------------------------------------------- B2

@pytest.mark.parametrize("exact", [False, True])
def test_conv_minmax_matches_pallas(exact):
    rng = np.random.default_rng(0)
    b, n, k, c1, c2 = 2, 37, 6, 16, 24
    h1 = values(rng, (b, n, k, c1), exact)
    w2 = values(rng, (c1, c2), exact, 0.2, -2, 3)
    b2 = values(rng, (c2,), exact)
    sc1, sh1 = fold_consts(rng, c1, exact)
    want = conv_minmax_pallas(jbf(h1), jbf(w2), jnp.asarray(b2),
                              jnp.asarray(sc1), jnp.asarray(sh1), row_tile=16,
                              interpret=True)
    got = conv_kmax.conv_minmax(tbf(h1), tbf(w2), torch.tensor(b2),
                                torch.tensor(sc1), torch.tensor(sh1))
    assert [t.dtype for t in got] == [torch.bfloat16, torch.int32,
                                      torch.bfloat16, torch.int32, torch.float32]
    act = conv_kmax._act(tbf(h1), torch.tensor(sc1), torch.tensor(sh1))
    y = (torch.matmul(act, torch.tensor(w2)) + torch.tensor(b2)).bfloat16().float()
    mags = torch.stack([y.abs().sum((0, 1, 2)), (y * y).sum((0, 1, 2))])
    close_sums(got[4], want[4], mags)
    if exact:
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(np32(g), np32(w))
        # the integers tie often: the first winning slot must be kept
        ties = (y == y.amax(2, keepdim=True)).sum(2) > 1
        assert ties.float().mean() > 0.05
        return
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(np32(g), np32(w), rtol=ULP, atol=1e-6)
    # each side's winning slot holds the extremum of the other's y to an ulp
    for a, ext in ((want[1], got[0]), (want[3], got[2])):
        at = torch.gather(y, 2, torch.tensor(np.asarray(a)).long()[:, :, None])[:, :, 0]
        np.testing.assert_allclose(at.numpy(), np32(ext), rtol=ULP, atol=1e-6)
    agree = np.mean(np32(got[1]) == np.asarray(want[1]))
    assert agree >= 0.99, agree


# -------------------------------------------------------------------- B3

def bwd_inputs(rng, exact, b=2, n=32, k=6, c1=16, c2=24):
    y1 = values(rng, (b, n, k, c1), exact)
    q = values(rng, (b, n, c2), exact)
    asel = rng.integers(0, k, (b, n, c2)).astype(np.int32)
    w2t = values(rng, (c2, c1), exact, 0.2, -2, 3)
    m = values(rng, (c1, c1), exact, 0.1, -2, 3)
    row0 = values(rng, (c1,), exact, 0.1)
    sc1, sh1 = fold_consts(rng, c1, exact)
    mean1 = values(rng, (c1,), exact, 0.1, -1, 2)
    inv1 = (rng.choice([0.5, 1.0, 2.0], c1).astype(np.float32) if exact
            else (rng.uniform(0.5, 2.0, c1)).astype(np.float32))
    return y1, q, asel, w2t, m, row0, (sc1, sh1, mean1, inv1)


@pytest.mark.parametrize("exact", [False, True])
def test_conv_kmax_bwd_matches_pallas(exact):
    """N = 32, two whole row tiles of 16: at an N the tile does not divide,
    the Pallas kernel pads y1 with zero rows, and with the BN1 fold those
    become relu(shift1) activations that enter its G, S1 and ab (its
    callers' N of 2048 is a whole number of tiles). The port's kernel and
    plain version have no padded rows."""
    rng = np.random.default_rng(1)
    y1, q, asel, w2t, m, row0, consts = bwd_inputs(rng, exact)
    want = conv_kmax_bwd_pallas(
        jbf(y1), jnp.asarray(q), jnp.asarray(asel), jbf(w2t), jbf(m),
        jnp.asarray(row0), *map(jnp.asarray, consts), row_tile=16,
        interpret=True)
    got = conv_kmax.conv_kmax_bwd(
        tbf(y1), torch.tensor(q), torch.tensor(asel), tbf(w2t), tbf(m),
        torch.tensor(row0), *map(torch.tensor, consts))
    assert got[0].dtype == torch.bfloat16 and got[0].shape == y1.shape
    if exact:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np32(g), np32(w))
        return
    # dz: f32 sums in another order, then one bf16 rounding
    scale = np.abs(np32(want[0])).max()
    np.testing.assert_allclose(np32(got[0]), np32(want[0]), rtol=ULP,
                               atol=1e-5 * scale)
    h = np32(conv_kmax._act(tbf(y1), *map(torch.tensor, consts[:2])))
    dq = np.abs(np32(torch.tensor(q).bfloat16()))
    onek = asel[:, :, None, :] == np.arange(y1.shape[2])[:, None]
    ah = np.abs(h)
    close_sums(got[1], want[1], np.einsum("bnji,bnjc->ic", ah, onek * dq[:, :, None]))
    close_sums(got[2], want[2], np.einsum("bnji,bnjl->il", ah, ah))
    close_sums(got[3], want[3], ah.sum((0, 1, 2)))
    dz = np.abs(np32(got[0]))
    xhat = (np.abs(y1) + np.abs(consts[2])) * consts[3]
    close_sums(got[4], want[4], np.stack([dz.sum((0, 1, 2)),
                                          (dz * xhat).sum((0, 1, 2))]))


# -------------------------------------------------------------------- B4

@pytest.mark.parametrize("sparse", [False, True])
def test_scatter_bn_bwd_matches_pallas(sparse):
    """du: f32 sums of the same f32 dy, rtol 1e-6 of the magnitudes. dv:
    the scatter of bf16(dy); the Pallas kernel sums in one-hot-matmul
    order, so 1e-5 of the sum of magnitudes."""
    rng = np.random.default_rng(2)
    b, p, k, n, c = 2, 33, 6, 41, 16
    idx = rng.integers(0, n, (b, p, k)).astype(np.int32)
    y = values(rng, (b, p, k, c), False)
    sv, al, be = f32(rng, (c,)), f32(rng, (c,), 0.1), f32(rng, (c,), 0.1)
    if sparse:
        q = f32(rng, (b, p, c))
        asel = rng.integers(0, k, (b, p, c)).astype(np.int32)
        jbig, tbig = ((jnp.asarray(q), jnp.asarray(asel)),
                      (torch.tensor(q), torch.tensor(asel)))
        first = np.where(asel[:, :, None, :] == np.arange(k)[:, None],
                         q[:, :, None, :], 0.0)
    else:
        dz = values(rng, (b, p, k, c), False)
        jbig, tbig = jbf(dz), tbf(dz)
        first = sv * dz
    want_dv, want_du = scatter_bn_bwd_pallas(
        jnp.asarray(idx), jbf(y), jbig, jnp.asarray(sv), jnp.asarray(al),
        jnp.asarray(be), n, tile_rows=16, interpret=True)
    got_dv, got_du = scatter.scatter_bn_bwd(
        torch.tensor(idx), tbf(y), tbig, torch.tensor(sv), torch.tensor(al),
        torch.tensor(be), n)
    assert got_dv.shape == (b, n, c) and got_du.shape == (b, p, c)
    mag = np.abs(first) + np.abs(al) + np.abs(be * y)
    close_sums(got_du, want_du, mag.sum(2), tol=1e-6)
    dv_mag = scatter.scatter_add_ref(torch.tensor(idx), torch.tensor(mag), n)
    close_sums(got_dv, want_dv, dv_mag)


# -------------------------------------------------------------------- B5

@pytest.mark.parametrize("exact", [False, True])
def test_conv_nmax_matches_pallas(exact):
    rng = np.random.default_rng(3)
    b, n, c1, c2 = 2, 50, 24, 40
    h = values(rng, (b, n, c1), exact, 1.0, 0, 2)
    w = values(rng, (c1, c2), exact, 0.2, -1, 2)
    bias = values(rng, (c2,), exact)
    want = conv_nmax_pallas(jbf(h), jbf(w), jnp.asarray(bias), row_tile=16,
                            interpret=True)
    got = conv_kmax.conv_nmax(tbf(h), tbf(w), torch.tensor(bias))
    assert [t.dtype for t in got] == [torch.float32, torch.int32,
                                      torch.float32, torch.int32, torch.float32]
    y = (torch.matmul(torch.tensor(h), torch.tensor(w))
         + torch.tensor(bias)).bfloat16().float()
    close_sums(got[4], want[4], torch.stack([y.abs().sum((0, 1)),
                                             (y * y).sum((0, 1))]))
    if exact:
        for g, w_ in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(np32(g), np32(w_))
        # ties across the Pallas row tiles of 16: the lowest row wins
        ties = (y == y.amax(1, keepdim=True)).sum(1) > 1
        assert ties.float().mean() > 0.2
        return
    for g, w_ in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(np32(g), np32(w_), rtol=ULP, atol=1e-6)
    for a, ext in ((want[1], got[0]), (want[3], got[2])):
        at = torch.gather(y, 1, torch.tensor(np.asarray(a)).long()[:, None])[:, 0]
        np.testing.assert_allclose(at.numpy(), np32(ext), rtol=ULP, atol=1e-6)


def on_grid(rng, shape, scale, step, lim):
    """Normal values rounded to multiples of ``step``, at most ``lim``
    steps from 0."""
    x = np.clip(np.round(rng.standard_normal(shape) * scale / step), -lim, lim)
    return (x * step).astype(np.float32)


def nmax_bwd_grid_inputs(rng, b, n, c1, c2):
    """B5 backward's inputs with y = h @ w + b exact in f32 in any order:
    h on a 2^-7 grid below 2 and w on a 2^-6 grid (both bf16-exact), the
    bias on their products' 2^-13 grid. Both sides then round the same y to
    bf16, and bf16(dy) is the same on both: what remains is the order of
    the sums that take it. q, alpha, beta are any f32."""
    return (on_grid(rng, (b, n, c1), 1.0, 2.0 ** -7, 255),
            on_grid(rng, (c1, c2), 0.2, 2.0 ** -6, 127),
            on_grid(rng, (c2,), 0.1, 2.0 ** -13, 2 ** 13),
            f32(rng, (b, c2)), rng.integers(0, n, (b, c2)).astype(np.int32),
            f32(rng, (c2,), 0.1), f32(rng, (c2,), 0.1))


def nmax_bwd_limits(h, q, asel, w, bias, al, be, fma=False):
    """The exact (f64) dh, dW, db at the plain version's bf16(dy), and how
    far sums in another order may move them: dh one bf16 ulp plus 1e-5 of
    the sum of its terms' magnitudes, dW and db 1e-5 of theirs. The
    magnitudes are those of the true cotangent: q sits at its row only.

    ``fma``: the other side may evaluate dy = (first + alpha) + beta * y
    with a fused multiply-add (XLA on the CPU contracts it), so a dy within
    2^-20 of its terms' magnitudes of a bf16 rounding boundary may round
    the other way: there bf16(dy) may move by an ulp (at most 2^-6 |dy|),
    and the limits of dh and dW grow by that times |w| or |h|."""
    th, tw = tbf(h), tbf(w)
    tq, ta, tb, tal, tbe = map(torch.tensor, (q, asel, bias, al, be))
    dy, dyc = conv_kmax.nmax_bwd_cotangent(th, tq, ta, tw, tb, tal, tbe)
    h64, w64, d64 = th.double(), tw.double(), dyc.double()
    slack = torch.zeros_like(d64)
    if fma:
        y = (h64 @ w64 + tb.double()).float().bfloat16().float()
        e = 2.0 ** -20 * (dy.abs() + tal.abs() + 2 * (tbe * y).abs()
                          + (tq.abs()[:, None] * (torch.arange(
                              h.shape[1])[None, :, None] == ta[:, None])))
        flip = (dy - e).bfloat16() != (dy + e).bfloat16()
        slack = (flip * 2.0 ** -6 * dy.abs()).double()
    dh = d64 @ w64.t()
    dh_lim = ULP * dh.abs() + (1e-5 * d64.abs() + slack) @ w64.abs().t()
    dw = torch.einsum("bni,bno->io", h64, d64)
    dw_lim = torch.einsum("bni,bno->io", h64.abs(), 1e-5 * d64.abs() + slack)
    db = dy.double().sum((0, 1))
    return (dh, dw, db), (dh_lim, dw_lim, 1e-5 * dy.double().abs().sum((0, 1)))


@pytest.mark.parametrize("exact", [False, True])
def test_conv_nmax_bwd_matches_pallas(exact):
    """Small integers: bitwise. Grid inputs (y exact in f32): the plain
    version and the Pallas kernel each within :func:`nmax_bwd_limits` of
    the exact values (the Pallas kernel's dy with XLA's contraction)."""
    rng = np.random.default_rng(4)
    b, n, c1, c2 = 2, 45, 16, 24
    if exact:
        h = values(rng, (b, n, c1), True)
        w = values(rng, (c1, c2), True, 0.2, -2, 3)
        bias, q = values(rng, (c2,), True), values(rng, (b, c2), True)
        asel = rng.integers(0, n, (b, c2)).astype(np.int32)
        al = values(rng, (c2,), True, 0.1)
        be = rng.choice([-0.5, 0.25, 1.0], c2).astype(np.float32)
    else:
        h, w, bias, q, asel, al, be = nmax_bwd_grid_inputs(rng, b, n, c1, c2)
    want = conv_nmax_bwd_pallas(jbf(h), jnp.asarray(q), jnp.asarray(asel),
                                jbf(w), jnp.asarray(bias), jnp.asarray(al),
                                jnp.asarray(be), row_tile=16, interpret=True)
    got = conv_kmax.conv_nmax_bwd(tbf(h), torch.tensor(q), torch.tensor(asel),
                                  tbf(w), torch.tensor(bias), torch.tensor(al),
                                  torch.tensor(be))
    assert got[0].dtype == torch.bfloat16 and got[0].shape == h.shape
    if exact:
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(np32(g), np32(w_))
        return
    for out, fma in ((got, False), (want, True)):
        for o, x, lim in zip(out, *nmax_bwd_limits(h, q, asel, w, bias, al,
                                                   be, fma)):
            assert np.all(np.abs(np32(o) - x.numpy()) <= lim.numpy())


def test_nmax_bwd_limits_reject_wrong_routing_and_rounding():
    """The limits B5 backward is held to (here, and on the card by
    tests/test_torch_cuda.py and chip_smoke.py) pass the plain version and
    reject, in both dh and dW, a backward that drops the routed q and one
    that multiplies by the f32 dy where the reference takes bf16(dy)."""
    rng = np.random.default_rng(5)
    h, w, bias, q, asel, al, be = nmax_bwd_grid_inputs(rng, 2, 300, 192, 256)
    exact, limits = nmax_bwd_limits(h, q, asel, w, bias, al, be)
    th, tw = tbf(h), tbf(w)
    tq, ta, tb, tal, tbe = map(torch.tensor, (q, asel, bias, al, be))

    def within(out):
        return [bool(((o.double() - x).abs() <= lim).all())
                for o, x, lim in zip(out, exact, limits)]

    assert within(conv_kmax.conv_nmax_bwd(th, tq, ta, tw, tb, tal, tbe)) == [True] * 3
    no_q = conv_kmax.conv_nmax_bwd(th, tq * 0, ta, tw, tb, tal, tbe)
    dy = conv_kmax.nmax_bwd_cotangent(th, tq, ta, tw, tb, tal, tbe)[0]
    f32_dy = (torch.matmul(dy, tw.float().t()).bfloat16(),
              torch.einsum("bni,bno->io", th.float(), dy), dy.sum((0, 1)))
    for out in (no_q, f32_dy):
        assert within(out)[:2] == [False, False]


def test_training_wrappers_reject_other_devices():
    meta = dict(device="meta")
    h1 = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16, **meta)
    w = torch.zeros((64, 64), dtype=torch.bfloat16, **meta)
    v = torch.zeros(64, **meta)
    q = torch.zeros((1, 4, 64), **meta)
    a = torch.zeros((1, 4, 64), dtype=torch.int32, **meta)
    idx = torch.zeros((1, 4, 2), dtype=torch.int32, **meta)
    for call in (lambda: conv_kmax.conv_minmax(h1, w, v, v, v),
                 lambda: conv_kmax.conv_nmax(h1[:, :, 0], w, v),
                 lambda: conv_kmax.conv_kmax_bwd(h1, q, a, w, w, v, v, v, v, v),
                 lambda: conv_kmax.conv_nmax_bwd(h1[:, :, 0], q[:, 0], a[:, 0],
                                                 w, v, v, v),
                 lambda: scatter.scatter_bn_bwd(idx, h1, (q, a), v, v, v, 4)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
