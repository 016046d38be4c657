"""Port layers (models/layers.py, models/transform_net.py) against the JAX
package's layer functions at eval (training=False), with the same weights.

Fused blocks run the port's kernel wrappers on CPU tensors (their plain
versions) against the JAX blocks over the Pallas kernels in interpret
mode, in bf16. Plain layers are compared in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaksuppointcloudseg_tpu.models import layers as jlayers
from weaksuppointcloudseg_tpu.models import transform_net as jtnet
from weaksuppointcloudseg_tpu.ops import neighbors as jnbr
from weaksuppointcloudseg_tpu_torch.models import layers
from weaksuppointcloudseg_tpu_torch.models.transform_net import TransformNet
from weaksuppointcloudseg_tpu_torch.ops import neighbors

torch.set_num_threads(1)
EPS = 1e-3


@pytest.fixture(autouse=True)
def _eval_without_autograd():
    """The layers' parameters are trainable; these eval comparisons run
    without recording gradients."""
    with torch.no_grad():
        yield


def conv_values(rng, in_c, out_c, bn=True):
    """Random conv params + population stats (negative gammas included)."""
    p = {"w": rng.uniform(-1, 1, (in_c, out_c)) * np.sqrt(3.0 / in_c),
         "b": rng.standard_normal(out_c) * 0.1}
    s = {}
    if bn:
        p["gamma"] = rng.uniform(-1.5, 1.5, out_c)
        p["beta"] = rng.standard_normal(out_c) * 0.1
        s = {"mean": rng.standard_normal(out_c) * 0.1,
             "var": rng.uniform(0.5, 1.5, out_c)}
    f = lambda d: {k: v.astype(np.float32) for k, v in d.items()}
    return f(p), f(s)


def port_conv(p, s):
    conv = layers.Conv(*p["w"].shape, bn="gamma" in p)
    conv.load_state_dict({k: torch.tensor(v) for k, v in {**p, **s}.items()})
    return conv


def jax_conv(p, s):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in s.items()})


def bf16_exact(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_bf16_close(got, want):
    """u = f(W_top - W_bot) + b and v = f W_bot are f32 sums in another
    order than XLA's, so either can land one bf16 ulp away and carry that
    through the rest of the block: at most 2 bf16 ulps (2^-6 relative)
    anywhere, and >= 95% of the outputs bitwise equal."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2.0 ** -6, atol=2.0 ** -6)
    assert np.mean(got == want) >= 0.95, np.mean(got == want)


@pytest.mark.parametrize("fast", [False, True])
def test_two_conv_stage_matches_jax(fast):
    rng = np.random.default_rng(0)
    b, n, c, k = 2, 64, 16, 8
    p1, s1 = conv_values(rng, 2 * c, 16)
    p2, s2 = conv_values(rng, 16, 24)
    f = bf16_exact(rng, (b, n, c))
    want, _, _ = jlayers.apply_edge_conv_stage_fused(
        *jax_conv(p1, s1), *jax_conv(p2, s2), jnp.asarray(f, jnp.bfloat16),
        jnp.asarray(f, jnp.bfloat16), k, training=False, eps=EPS, fast=fast,
        interpret=True)
    ft = torch.tensor(f).bfloat16()
    got = layers.apply_edge_conv_stage_fused(
        port_conv(p1, s1), port_conv(p2, s2), ft, ft, k, eps=EPS, fast=fast)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, want)


def test_single_conv_stage_matches_jax():
    rng = np.random.default_rng(1)
    b, n, c, k = 2, 64, 16, 8
    p, s = conv_values(rng, 2 * c, 16)
    f = bf16_exact(rng, (b, n, c))
    fj = jnp.asarray(f, jnp.bfloat16)
    want, _ = jlayers.apply_edge_conv_stage1_fused(
        *jax_conv(p, s), fj, fj, k, training=False, eps=EPS, interpret=True,
        n_valid=60)
    ft = torch.tensor(f).bfloat16()
    got = layers.apply_edge_conv_stage1_fused(port_conv(p, s), ft, ft, k,
                                              eps=EPS, n_valid=60)
    assert_bf16_close(got, want)


def test_nmax_block_matches_jax():
    rng = np.random.default_rng(2)
    p, s = conv_values(rng, 48, 64)
    h = bf16_exact(rng, (2, 40, 48))
    want, _ = jlayers.apply_conv_bn_relu_nmax(
        *jax_conv(p, s), jnp.asarray(h, jnp.bfloat16), training=False,
        eps=EPS, interpret=True, n_valid=33)
    got = layers.apply_conv_bn_relu_nmax(port_conv(p, s),
                                         torch.tensor(h).bfloat16(), eps=EPS,
                                         n_valid=33)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, want)


def transform_values(rng, in_c, K):
    pj, sj, pt = {}, {}, TransformNet(in_c, K)
    state = {}
    for name, ci, co in (("tconv1", in_c, 64), ("tconv2", 64, 128),
                         ("tconv3", 128, 1024), ("tfc1", 1024, 512),
                         ("tfc2", 512, 256)):
        p, s = conv_values(rng, ci, co)
        pj[name], sj[name] = jax_conv(p, s)
        state.update({f"{name}.{k}": torch.tensor(v)
                      for k, v in {**p, **s}.items()})
    w = (rng.standard_normal((256, K * K)) * 0.02).astype(np.float32)
    bias = np.eye(K, dtype=np.float32).reshape(-1)
    pj["transform_out"] = {"w": jnp.asarray(w), "b": jnp.asarray(bias)}
    state["transform_out.w"] = torch.tensor(w)
    state["transform_out.b"] = torch.tensor(bias)
    pt.load_state_dict(state)
    return pj, sj, pt


def test_transform_net_fused_matches_jax():
    """The JAX fused branch composed from its layer functions with
    interpret=True (apply_transform_net's fused branch, transform_net.py:
    73-109), against TransformNet.forward_fused."""
    rng = np.random.default_rng(3)
    k, K = 8, 3
    pj, sj, pt = transform_values(rng, 2 * K, K)
    g = bf16_exact(rng, (2, 48, K))
    gj = jnp.asarray(g, jnp.bfloat16)
    net, _, _ = jlayers.apply_edge_conv_stage_fused(
        pj["tconv1"], sj["tconv1"], pj["tconv2"], sj["tconv2"], gj, gj, k,
        training=False, eps=EPS, interpret=True)
    net, _ = jlayers.apply_conv_bn_relu_nmax(
        pj["tconv3"], sj["tconv3"], net, training=False, eps=EPS,
        interpret=True)
    for name in ("tfc1", "tfc2"):
        net, _ = jlayers.apply_conv(pj[name], sj[name], net, training=False,
                                    eps=EPS)
    out = pj["transform_out"]
    want = (net.astype(jnp.float32) @ out["w"] + out["b"]).reshape(-1, K, K)
    with torch.inference_mode():
        got = pt.forward_fused(torch.tensor(g).bfloat16(), k, eps=EPS,
                               fast=False)
    # f32 head over bf16 features that may sit 2 bf16 ulps apart
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.02,
                               atol=0.02)


def test_transform_net_plain_matches_jax_f32():
    rng = np.random.default_rng(4)
    k, K = 8, 3
    pj, sj, pt = transform_values(rng, 2 * K, K)
    g = rng.standard_normal((2, 48, K)).astype(np.float32)
    ef = jnbr.edge_feature(jnp.asarray(g), jnbr.knn_graph(jnp.asarray(g), k))
    want, _ = jtnet.apply_transform_net(pj, sj, ef, K=K, training=False,
                                        bn_decay=None, bn_eps=EPS)
    gt = torch.tensor(g)
    with torch.inference_mode():
        got = pt.forward_plain(gt, gt, k, eps=EPS)
    # f32 sums in another order: rtol 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_plain_layers_match_jax_f32():
    """apply_conv / apply_conv_bcast / apply_edge_conv in f32: the same
    products summed in another order, rtol 1e-5."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, 12)).astype(np.float32)
    xb = rng.standard_normal((2, 20)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-5)

    p, s = conv_values(rng, 12, 16)
    want, _ = jlayers.apply_conv(*jax_conv(p, s), jnp.asarray(x),
                                 training=False, eps=EPS)
    got = layers.apply_conv(port_conv(p, s), torch.tensor(x), eps=EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)

    p, s = conv_values(rng, 12, 5, bn=False)
    want, _ = jlayers.apply_conv(*jax_conv(p, s), jnp.asarray(x),
                                 training=False, relu=False, bn=False)
    got = layers.apply_conv(port_conv(p, s), torch.tensor(x), relu=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)

    p, s = conv_values(rng, 32, 16)
    want, _ = jlayers.apply_conv_bcast(*jax_conv(p, s), jnp.asarray(xb),
                                       jnp.asarray(x), training=False, eps=EPS)
    got = layers.apply_conv_bcast(port_conv(p, s), torch.tensor(xb),
                                  torch.tensor(x), eps=EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)

    p, s = conv_values(rng, 24, 16)
    idx = np.asarray(jnbr.knn_graph(jnp.asarray(x), 6))
    nbr_j = jnbr.gather_neighbors(jnp.asarray(x), jnp.asarray(idx))
    want, _ = jlayers.apply_edge_conv(*jax_conv(p, s), jnp.asarray(x), nbr_j,
                                      training=False, eps=EPS)
    xt = torch.tensor(x)
    idx_t = neighbors.knn_graph(xt, 6)
    np.testing.assert_array_equal(idx_t.numpy(), idx)
    got = layers.apply_edge_conv(port_conv(p, s), xt,
                                 neighbors.gather_neighbors(xt, idx_t), eps=EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
