"""Label propagation (propagate/label_prop.py, solver "cg") against the
JAX package's propagate_batch, and the affinity against an f64 oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaksuppointcloudseg_tpu.propagate.label_prop import (
    propagate_batch as jax_propagate_batch,
)
from weaksuppointcloudseg_tpu_torch.propagate import label_prop
from weaksuppointcloudseg_tpu_torch.propagate.laplacian import (
    product_kernel_weights,
)

torch.set_num_threads(1)


def cloud(rng, b, n):
    """Unit-sphere-normalized clouds, as the ShapeNet test views are."""
    x = rng.standard_normal((b, n, 3)).astype(np.float32) * 0.3
    return x / np.linalg.norm(x, axis=-1).max(axis=1)[:, None, None]


def probs(rng, b, n, k, sharpness=3.0):
    z = rng.standard_normal((b, n, k)) * sharpness
    p = np.exp(z - z.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


def test_affinity_matches_f64_oracle():
    """ROADMAP C1: W = exp(-1e3 d^2) amplifies Gram error ~1e3-fold, so the
    f32 Gram must be IEEE (no TF32). The reference's formula
    |x|^2 - 2 x.y + |y|^2 cancels in f32 to a few ulps of |x|^2 (~2e-7
    here), which the bandwidth 1.01e3 turns into ~2e-4 on W <= 1: the f32
    W is within 5e-4 of an f64 oracle (measured 1.2e-4). A TF32 Gram
    (~1e-3 relative on x.y) would be off by O(1). Against the JAX
    package's W the same formula differs only in summation order: 1e-5."""
    from weaksuppointcloudseg_tpu.propagate.laplacian import (
        product_kernel_weights as jax_weights,
    )

    rng = np.random.default_rng(0)
    xyz = cloud(rng, 2, 200)
    w = product_kernel_weights(torch.tensor(xyz), torch.tensor(xyz)).numpy()
    assert w.dtype == np.float32
    x64 = xyz.astype(np.float64)
    d = np.sum((x64[:, :, None, :] - x64[:, None, :, :]) ** 2, axis=-1)
    w64 = np.exp(-d * 1e3) * np.exp(-d * 1e1)
    assert np.abs(w - w64).max() <= 5e-4, np.abs(w - w64).max()
    want = np.asarray(jax_weights(jnp.asarray(xyz), jnp.asarray(xyz)))
    assert np.abs(w - want).max() <= 1e-5, np.abs(w - want).max()


def run_both(xyz, g, **kw):
    want = np.asarray(jax_propagate_batch(jnp.asarray(xyz), jnp.asarray(g),
                                          solver="cg", **kw))
    got = label_prop.propagate_batch(torch.tensor(xyz), torch.tensor(g),
                                     solver="cg", **kw).numpy()
    return got, want


def test_cg_matches_jax():
    """The same CG on f32 sums in another order: rtol/atol 1e-4."""
    rng = np.random.default_rng(1)
    xyz, g = cloud(rng, 3, 160), probs(rng, 3, 160, 8)
    got, want = run_both(xyz, g)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_cg_norm_spans_the_batch():
    """jax.scipy cg treats the whole [B, N, K] array as one vector: with a
    near-uniform sample in the batch (confidence ~0, tiny residual) the
    stop test is global. The port matches JAX on that batch, and a
    per-sample solve of the same inputs gives a measurably different
    answer (measured 2.6e-4 on the near-uniform sample, against 4e-7
    between the port and JAX), so the test tells the two apart."""
    rng = np.random.default_rng(2)
    xyz, g = cloud(rng, 2, 160), probs(rng, 2, 160, 8)
    g[1] = probs(rng, 1, 160, 8, sharpness=1e-3)[0]  # near-uniform
    kw = dict(cg_iters=50, cg_tol=1e-3)
    got, want = run_both(xyz, g, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    alone = np.concatenate([
        label_prop.propagate_batch(torch.tensor(xyz[i:i + 1]),
                                   torch.tensor(g[i:i + 1]), **kw).numpy()
        for i in range(2)])
    assert np.abs(alone - got).max() > 1e-4


def test_other_solvers_name_their_roadmap_entry():
    """"cg_matfree" and "solve" are ported (tests/test_torch_affinity.py
    and tests/test_torch_solve.py hold them against JAX); "sharded" raises
    naming its entry."""
    x = torch.rand((1, 4, 3), generator=torch.Generator().manual_seed(0))
    g = torch.full((1, 4, 2), 0.5)
    for solver in ("cg_matfree", "solve"):
        y = label_prop.propagate_batch(x, g, solver=solver)
        assert y.shape == (1, 4, 2) and bool(torch.isfinite(y).all())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        label_prop.propagate_batch(x, g, solver="sharded")


def test_entropy_confidence_matches_jax():
    from weaksuppointcloudseg_tpu.propagate.label_prop import (
        entropy_confidence,
    )

    g = probs(np.random.default_rng(3), 2, 50, 13)
    np.testing.assert_allclose(
        label_prop.entropy_confidence(torch.tensor(g)).numpy(),
        np.asarray(entropy_confidence(jnp.asarray(g))), rtol=1e-6, atol=1e-6)
