"""The dense-LU label propagation (solver "solve") and the Laplacian it is
built on (propagate/laplacian.py, propagate/label_prop.py) against the JAX
package on the CPU, and the solve against an f64 oracle (ROADMAP C1).

Tolerances. The Laplacian: the same f32 formula, with the Grams and the
degrees summed in another order; its diagonal D_ii - W_ii cancels terms
of the degree's size (W_ii is 1 up to the Gram's f32 rounding), so it is
held to 1e-6 of each sample's largest degree (1 after the symmetric
normalization; measured 1.8e-7). label_propagation on a
given Laplacian: the same system solved by another LAPACK LU (or the same
CG) in f32, whose rounding the condition number kappa (< 25 here) scales:
Y within 1e-5 of its largest entry. Against the f64 solve of the same f32
system the normwise error stays below kappa * sqrt(N) * 2^-24, the usual
estimate of an f32 LU's forward error (rounding errors that add like a
random walk); a TF32 product (10 mantissa bits) would miss it by ~100x.
Measured: 6.1e-8 against the bound 1.1e-5 at kappa 11.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_label_prop import cloud, probs
from weaksuppointcloudseg_tpu.propagate import label_prop as jlp
from weaksuppointcloudseg_tpu.propagate import laplacian as jlap
from weaksuppointcloudseg_tpu_torch.propagate import label_prop, laplacian

torch.set_num_threads(1)


def assert_close(got, want, scale):
    """Within 1e-6 of ``scale`` [B], each sample's largest degree (1 for
    the symmetric Laplacian): the diagonal D_ii - W_ii cancels terms of
    that size."""
    err = np.abs(got - want) / np.asarray(scale)[:, None, None]
    assert err.max() <= 1e-6, err.max()


@pytest.mark.parametrize("sym,eps_always", [(False, False), (False, True),
                                            (True, False)])
def test_laplacian_from_weights_matches_jax(sym, eps_always):
    """Both epsilon semantics (none on the generic unnormalized
    Laplacian, 1e-8 on the symmetric one and on the XYZRGB Laplacians) and
    the max(d, 1e-30) guard: one row with no affinities at all."""
    rng = np.random.default_rng(0)
    w = rng.random((2, 50, 50)).astype(np.float32)
    w = (w + w.transpose(0, 2, 1)) / 2
    w[1, 7, :] = w[1, :, 7] = 0.0
    want = np.asarray(jlap.laplacian_from_weights(
        jnp.asarray(w), sym=sym, eps_always=eps_always))
    wt = torch.from_numpy(w.copy())
    got = laplacian.laplacian_from_weights(wt, sym=sym, eps_always=eps_always)
    assert torch.equal(wt, torch.from_numpy(w))  # w is not changed
    assert_close(got.numpy(), want, np.ones(2) if sym else w.sum(-1).max(-1))


@pytest.mark.parametrize("rgb", [False, True])
def test_laplacian_xyz_rgb_matches_jax(rgb):
    """The symmetric Laplacian of the product kernel: ShapeNet's (xyz
    twice) and S3DIS's (xyz, rgb)."""
    rng = np.random.default_rng(1)
    xyz = cloud(rng, 2, 120)
    col = rng.random((2, 120, 3)).astype(np.float32) if rgb else xyz
    want = np.asarray(jlap.laplacian_xyz_rgb(jnp.asarray(xyz), jnp.asarray(col)))
    got = laplacian.laplacian_xyz_rgb(torch.from_numpy(xyz),
                                      torch.from_numpy(col))
    assert_close(got.numpy(), want, np.ones(2))


def lap_and_probs(seed, b=2, n=150, k=8):
    rng = np.random.default_rng(seed)
    xyz = cloud(rng, b, n)
    lap = np.array(jlap.laplacian_xyz_rgb(jnp.asarray(xyz), jnp.asarray(xyz)))
    return xyz, lap, probs(rng, b, n, k)


@pytest.mark.parametrize("solver", ["solve", "cg"])
def test_label_propagation_matches_jax(solver):
    """Y, Y_prob and the confidences w on one Laplacian."""
    _, lap, g = lap_and_probs(2)
    want = [np.asarray(a) for a in jlp.label_propagation(
        jnp.asarray(lap), jnp.asarray(g), solver=solver)]
    got = label_prop.label_propagation(torch.from_numpy(lap),
                                       torch.from_numpy(g), solver=solver)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
    with pytest.raises(ValueError, match="solver"):
        label_prop.label_propagation(torch.from_numpy(lap),
                                     torch.from_numpy(g), solver="lu")


def test_solve_matches_f64_oracle():
    """The f32 LU against an f64 solve of the same f32 system, within the
    bound the module docstring states."""
    _, lap, g = lap_and_probs(3, b=1, n=300)
    y, _, w = label_prop.label_propagation(torch.from_numpy(lap),
                                           torch.from_numpy(g))
    a = lap[0].astype(np.float64) + np.diag(w[0].numpy().astype(np.float64)
                                            + 1e-5)
    rhs = (w[0].numpy()[:, None] * g[0]).astype(np.float64)
    y64 = np.linalg.solve(a, rhs)
    ev = np.linalg.eigvalsh(a)
    kappa = ev.max() / ev.min()
    err = np.linalg.norm(y[0].numpy() - y64) / np.linalg.norm(y64)
    assert kappa < 25
    assert err <= kappa * np.sqrt(300) * 2.0 ** -24, (err, kappa)


@pytest.mark.parametrize("rgb", [False, True])
def test_propagate_batch_solve_matches_jax(rgb):
    """propagate_batch(solver="solve") end to end: Y_prob within 1e-5."""
    rng = np.random.default_rng(4)
    xyz = cloud(rng, 2, 140)
    col = rng.random((2, 140, 3)).astype(np.float32) if rgb else None
    g = probs(rng, 2, 140, 13)
    want = np.asarray(jlp.propagate_batch(
        jnp.asarray(xyz), jnp.asarray(g),
        None if col is None else jnp.asarray(col), solver="solve"))
    got = label_prop.propagate_batch(
        torch.from_numpy(xyz), torch.from_numpy(g),
        None if col is None else torch.from_numpy(col), solver="solve")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy().sum(-1), 1.0, rtol=1e-5)
