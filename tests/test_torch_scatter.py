"""Kernel B13's plain version (ops/scatter.py::scatter_add_ref, what the
CUDA kernel is held to on the card) against the Pallas kernel it replaces,
scatter_add_pallas(..., interpret=True), and the port's gather_neighbors
backward against the JAX gather's VJP, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaksuppointcloudseg_tpu.ops import neighbors as jnbr
from weaksuppointcloudseg_tpu.ops.scatter_pallas import scatter_add_pallas
from weaksuppointcloudseg_tpu_torch.ops import neighbors, scatter

torch.set_num_threads(1)


@pytest.mark.parametrize("b,p,n,k,c", [(2, 96, 96, 20, 64), (1, 100, 40, 7, 3)])
def test_plain_matches_pallas_with_duplicate_targets(b, p, n, k, c):
    """Targets drawn from fewer rows than contributions, so most rows
    take many adds. Both sum in f32 in different orders (the Pallas kernel
    in one-hot-matmul order): rtol 1e-5, with an absolute floor of 1e-5 x
    the sum of magnitudes for rows whose sum cancels."""
    rng = np.random.default_rng(b + k)
    idx = rng.integers(0, n, (b, p, k)).astype(np.int32)
    g = rng.standard_normal((b, p, k, c)).astype(np.float32)
    want = np.asarray(scatter_add_pallas(jnp.asarray(idx), jnp.asarray(g), n,
                                         tile_rows=32, interpret=True))
    got = scatter.scatter_add(torch.from_numpy(idx), torch.from_numpy(g), n)
    assert got.shape == (b, n, c) and got.dtype == torch.float32
    mags = scatter.scatter_add_ref(torch.from_numpy(idx),
                                   torch.from_numpy(np.abs(g)), n).numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(mags.max()))


def test_all_to_one_row():
    idx = torch.zeros((1, 16, 4), dtype=torch.int32)
    out = scatter.scatter_add(idx, torch.ones((1, 16, 4, 8)), 16)
    np.testing.assert_array_equal(out[0, 0].numpy(), 64.0)
    np.testing.assert_array_equal(out[0, 1:].numpy(), 0.0)


def test_gather_backward_matches_jax_vjp():
    """gather_neighbors' backward (B13's route) against the VJP of the JAX
    gather_neighbors on the same cotangent: rtol 1e-5."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 50, 16)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 50, 8)).astype(np.int32)
    ct = rng.standard_normal((2, 50, 8, 16)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jnbr.gather_neighbors(a, jnp.asarray(idx)),
                       jnp.asarray(x))
    (want,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = neighbors.gather_neighbors(xt, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        scatter.scatter_add(torch.zeros((1, 4, 2), dtype=torch.int32),
                            torch.zeros((1, 4, 2, 3), device="meta"), 4)
