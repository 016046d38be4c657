"""Kernel B14's plain version (ops/gather.py::gather_rows_ref, what the CUDA
kernel is held to on the card) against the Pallas kernel it replaces,
gather_rows_pallas(..., interpret=True), the dtype routing of the port's
gather_neighbors, and its VJP against the JAX gather's, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaksuppointcloudseg_tpu.ops import neighbors as jnbr
from weaksuppointcloudseg_tpu.ops.gather_pallas import gather_rows_pallas
from weaksuppointcloudseg_tpu_torch.ops import gather, neighbors

torch.set_num_threads(1)


def bf16_rows(rng, shape):
    """Random bf16 values as an f32 numpy array (exactly representable)."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.bfloat16().float().numpy()


# (B, N, k, C): the Pallas tests' shape, a small one, and the C widths of
# the unfused route's stage-0 gathers (ShapeNet xyz 3, S3DIS 9 channels)
@pytest.mark.parametrize("b,n,k,c", [(2, 256, 20, 64), (1, 96, 5, 8),
                                     (2, 100, 20, 3), (1, 130, 20, 9)])
def test_plain_matches_pallas_bitwise(b, n, k, c):
    """A copy of rows: bitwise equal to the one-hot matmul (one nonzero
    product per output, exact in f32), duplicates and the last row
    included."""
    rng = np.random.default_rng(b * n + c)
    f = bf16_rows(rng, (b, n, c))
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    idx[:, 0, :] = n - 1
    want = np.asarray(gather_rows_pallas(jnp.asarray(f, jnp.bfloat16),
                                         jnp.asarray(idx), interpret=True)
                      .astype(jnp.float32))
    got = gather.gather_rows(torch.from_numpy(f).bfloat16(),
                             torch.from_numpy(idx))
    assert got.dtype == torch.bfloat16 and got.shape == (b, n, k, c)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_wrapper_takes_plain_version_only_on_the_cpu():
    f = torch.zeros((1, 8, 3), dtype=torch.bfloat16, device="meta")
    idx = torch.zeros((1, 8, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather.gather_rows(f, idx)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_neighbors_routes_bf16_to_b14(monkeypatch, dtype):
    """bf16 rows go through B14's wrapper, f32 rows through indexing (the
    reference leaves f32 to XLA's gather); both give the same exact rows."""
    calls = []
    real = gather.gather_rows

    def counted(f, idx):
        calls.append(f.dtype)
        return real(f, idx)

    monkeypatch.setattr(neighbors, "gather_rows", counted)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(bf16_rows(rng, (2, 40, 6))).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 40, (2, 40, 5)))
    got = neighbors.gather_neighbors(x, idx)
    assert calls == ([torch.bfloat16] if dtype == torch.bfloat16 else [])
    b = torch.arange(2)[:, None, None]
    assert torch.equal(got, x[b, idx])


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_gather_vjp_matches_jax(dtype):
    """The forward and the VJP of gather_neighbors against JAX's. The
    cotangent is on an integer grid in [-4, 4], so every partial sum of a
    row's (at most ~30) contributions is an integer below 256, exact in
    bf16 and f32 in any order: JAX's bf16 scatter-add and the port's f32
    B13 sum rounded once to bf16 must agree bitwise."""
    rng = np.random.default_rng(1)
    b, n, k, c = 2, 60, 8, 9
    x = bf16_rows(rng, (b, n, c))
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    ct = rng.integers(-4, 5, (b, n, k, c)).astype(np.float32)
    out, vjp = jax.vjp(lambda a: jnbr.gather_neighbors(a, jnp.asarray(idx)),
                       jnp.asarray(x, dtype))
    (want,) = vjp(jnp.asarray(ct, dtype))
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    got = neighbors.gather_neighbors(xt, torch.from_numpy(idx))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(out.astype(jnp.float32)))
    got.backward(torch.from_numpy(ct).to(tdt))
    assert xt.grad.dtype == tdt
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
