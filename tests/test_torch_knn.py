"""Kernel B12's plain version (ops/knn.py::knn_ref, what the CUDA kernel is
held to on the card) against the Pallas kernel it replaces,
knn_pallas(..., interpret=True), on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaksuppointcloudseg_tpu.ops.knn_pallas import knn_pallas
from weaksuppointcloudseg_tpu_torch.ops import knn, neighbors

torch.set_num_threads(1)


def points(seed, b, n, c):
    return np.random.default_rng(seed).standard_normal((b, n, c)).astype(np.float32)


@pytest.mark.parametrize("b,n,c,k", [(2, 96, 3, 20), (1, 100, 7, 10),
                                     (2, 64, 64, 20)])
def test_exact_matches_pallas(b, n, c, k):
    """Well-separated random points: the indices are equal; the selected
    squared distances agree to rtol 1e-5 (the Gram is summed in another
    order), with an absolute floor of 1e-5 x the largest distance for the
    self distances, which are rounding noise around 0."""
    x = points(b * n + c, b, n, c)
    want_idx, want_sqd = knn_pallas(jnp.asarray(x), k, interpret=True,
                                    with_values=True)
    got_idx, got_sqd = knn.knn(torch.from_numpy(x), k, with_values=True)
    assert got_idx.dtype == torch.int32 and got_sqd.dtype == torch.float32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_sqd.numpy(), np.asarray(want_sqd), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_sqd).max()))
    idx_only = knn.knn(torch.from_numpy(x), k)
    np.testing.assert_array_equal(idx_only.numpy(), got_idx.numpy())


def test_exact_ties_take_lowest_index():
    """Built ties: small-integer coordinates make every distance exact in
    f32, so whole shells of neighbors tie; both kernels order each shell
    by index, and duplicated points come lowest index first."""
    rng = np.random.default_rng(3)
    x = rng.integers(-2, 3, (2, 80, 3)).astype(np.float32)
    x[0, 50] = x[0, 7]  # an exact duplicate
    want_idx, want_sqd = knn_pallas(jnp.asarray(x), 12, interpret=True,
                                    with_values=True)
    got_idx, got_sqd = knn.knn(torch.from_numpy(x), 12, with_values=True)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_sqd.numpy(), np.asarray(want_sqd))
    d = got_sqd.numpy()
    i = got_idx.numpy()
    same = d[..., 1:] == d[..., :-1]
    assert same.sum() > 100  # the input really has ties
    assert (i[..., 1:][same] > i[..., :-1][same]).all()
    copies = np.flatnonzero((x[0] == x[0, 7]).all(-1))  # 7, 50 and others
    assert 50 in copies
    for row in copies:
        np.testing.assert_array_equal(i[0, row, :len(copies)], copies)


@pytest.mark.parametrize("c", [3, 16])
def test_fast_mode_agreement(c):
    """Packed-min selection drops the low idx_bits of each distance, so
    near-ties may reorder: index agreement >= 98% against the Pallas fast
    kernel (ROADMAP C5), the values within those dropped bits."""
    x = points(11 + c, 2, 96, c)
    want_idx, want_sqd = knn_pallas(jnp.asarray(x), 16, interpret=True,
                                    with_values=True, fast=True)
    got_idx, got_sqd = knn.knn(torch.from_numpy(x), 16, fast=True,
                               with_values=True)
    agree = np.mean(got_idx.numpy() == np.asarray(want_idx))
    assert agree >= 0.98, agree
    assert (got_sqd.numpy() >= 0).all()
    scale = float(np.abs(want_sqd).max())
    tol = scale * 2.0 ** (knn.idx_bits(96) - 23) + 1e-6 * scale
    np.testing.assert_allclose(np.sort(got_sqd.numpy(), -1),
                               np.sort(np.asarray(want_sqd), -1), atol=tol)


@pytest.mark.parametrize("fast", [False, True])
def test_nan_point_sorts_last(fast):
    """The order the CUDA kernels are held to for a point with NaN
    features: NaN distances come after every number, in column order, so
    the NaN point's row selects 0..k-1 with NaN values and no other row
    selects it."""
    x = torch.from_numpy(points(9, 2, 64, 3))
    x[1, 17] = float("nan")
    idx, sqd = knn.knn(x, 10, fast=fast, with_values=True)
    np.testing.assert_array_equal(idx[1, 17].numpy(), np.arange(10))
    assert bool(sqd[1, 17].isnan().all())
    rows = torch.arange(64) != 17
    assert not bool((idx[1, rows] == 17).any())
    assert bool(sqd[1, rows].isfinite().all() and sqd[0].isfinite().all())


def test_fused_graph_matches_plain_graph():
    """neighbors.knn_graph_fused (B12's route) and the plain distance +
    stable sort give the same exact graph."""
    x = torch.from_numpy(points(5, 2, 90, 3))
    np.testing.assert_array_equal(
        neighbors.knn_graph_fused(x, 10).numpy(),
        neighbors.knn_graph(x, 10).numpy())


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        knn.knn(torch.zeros((1, 8, 3), device="meta"), 4)


@pytest.mark.parametrize("b,n,c,k,k_max", [
    (64, 2048, 64, 20, knn.K_MAX),    # the training batch
    (64, 6000, 64, 20, knn.K_MAX),    # past the distance-rows cap (4,851)
    (2, 100_000, 1024, 64, knn.K_MAX),
    (65535, 50, 3, 50, knn.K_MAX),    # k = N, the grid's largest batch
    (1, 1, 1, 1, 32),
    (8, 9000, 9, 32, 32)])
def test_tiles_launch_accepts(b, n, c, k, k_max):
    """The tiled kernels' shared memory does not grow with N or C, so the
    check takes any N and C inside the k and batch limits."""
    knn.check_tiles_launch("knn", b, n, c, k, k_max)


@pytest.mark.parametrize("b,n,c,k,k_max,match", [
    (4, 2048, 64, 65, knn.K_MAX, r"k=65 must be in \[1, min\(64, N=2048\)\]"),
    (4, 2048, 64, 33, 32, r"k=33 must be in \[1, min\(32, N=2048\)\]"),
    (4, 10, 3, 11, knn.K_MAX, r"k=11 .*N=10"),
    (4, 10, 3, 0, knn.K_MAX, "k=0"),
    (65536, 64, 3, 20, knn.K_MAX, "batch 65536"),
    (0, 64, 3, 20, knn.K_MAX, "batch 0"),
    (4, 64, 0, 20, knn.K_MAX, "C=0")])
def test_tiles_launch_refuses(b, n, c, k, k_max, match):
    """k above the kernel's list (64 for B12, 32 for B15) or above N, and
    a batch the grid's y dimension cannot hold, raise with the limit."""
    with pytest.raises(ValueError, match=match):
        knn.check_tiles_launch("knn", b, n, c, k, k_max)


def test_b15_takes_the_tiled_check():
    """B15's wrapper holds k to 32 through the same check."""
    from weaksuppointcloudseg_tpu_torch.ops import knn_gather

    assert knn_gather.K_MAX == 32
    with pytest.raises(ValueError, match=r"min\(32"):
        knn.check_tiles_launch("knn_gather", 2, 64, 3, 33, knn_gather.K_MAX)
