"""The port's fused training blocks against the JAX package on the CPU:
``layers.apply_edge_conv_stage_fused`` (two convs: the EdgeConv stage and
the transform net's tconv1+tconv2 stage), ``apply_edge_conv_stage1_fused``
and ``apply_conv_bn_relu_nmax`` with ``training=True``, over the kernels'
plain versions, against the same functions of the JAX package (their
``custom_vjp``s over the Pallas kernels in interpret mode): the output,
the new BN state and every gradient. tests/test_torch_fused_step.py holds
the whole bf16 Plain-style step and its routes.

Sizes: B=2, k=6, N a multiple of 8. At an N that 8 does not divide, the
Pallas conv2 backward (conv_kmax_bwd_pallas) pads y1 with zero rows that
the BN1 fold turns into relu(shift1) activations, and those enter its G,
S1 and BN1 reductions (see tests/test_torch_conv_kmax_train.py).

Tolerances. On the CPU the JAX blocks run B3 in interpret mode but take
XLA fallbacks for B4 and B5's backward (layers.py:741, 995, 1210), which
round the first conv's cotangent dy1 to bf16 before its sum over the k
slots; the port follows the Pallas kernels (f32 sum). That moves du by up
to 2^-9 of the sum of |dy1| per point, and with it the first conv's
gradients; everything else differs by f32 summation order (plus a bf16
ulp where a value is rounded). So: outputs within 2 bf16 ulps; new BN
state rtol 1e-4; every gradient leaf within 2e-2 of its largest entry
plus 2e-3 of the largest over all leaves (the conv biases in front of a
BN have zero true gradient and rounding-noise computed ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weaksuppointcloudseg_tpu.models import layers as jlayers
from weaksuppointcloudseg_tpu_torch.models import layers

torch.set_num_threads(1)
EPS, DECAY = 1e-3, 0.5
RTOL, ATOL_FRAC = 2e-2, 2e-3


def conv_values(rng, in_c, out_c):
    """Conv params (|gamma| in [0.5, 1.5], a fifth negative) and BN state."""
    sign = np.where(rng.random(out_c) < 0.2, -1.0, 1.0)
    p = {"w": rng.uniform(-1, 1, (in_c, out_c)) * np.sqrt(3.0 / in_c),
         "b": rng.standard_normal(out_c) * 0.1,
         "gamma": rng.uniform(0.5, 1.5, out_c) * sign,
         "beta": rng.standard_normal(out_c) * 0.1}
    s = {"mean": rng.standard_normal(out_c) * 0.1,
         "var": rng.uniform(0.5, 1.5, out_c)}
    f = lambda d: {k: v.astype(np.float32) for k, v in d.items()}
    return f(p), f(s)


def port_conv(p, s):
    conv = layers.Conv(*p["w"].shape)
    conv.load_state_dict({k: torch.tensor(v) for k, v in {**p, **s}.items()})
    return conv


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def bf16_exact(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def assert_out_close(got, want):
    got, want = np32(got), np32(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2.0 ** -6, atol=2.0 ** -6)


def assert_grads_close(got: dict, want: dict, rtol=RTOL, atol_frac=ATOL_FRAC):
    assert set(got) == set(want), (set(got), set(want))
    scale = max(np.abs(np32(v)).max() for v in want.values())
    for name, w in want.items():
        w, g = np32(w), np32(got[name])
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        assert err <= rtol * np.abs(w).max() + atol_frac * scale, (name, err)


def assert_state_close(convs, new_states):
    for conv, s in zip(convs, new_states):
        for key in ("mean", "var"):
            np.testing.assert_allclose(getattr(conv, key).numpy(),
                                       np32(s[key]), rtol=1e-4, atol=1e-6)


def param_grads(prefix, conv):
    return {f"{prefix}.{n}": p.grad for n, p in conv.named_parameters()}


def jax_param_grads(prefix, g):
    return {f"{prefix}.{n}": v for n, v in g.items()}


# ------------------------------------------------------------------ blocks

@pytest.mark.parametrize("fast,cin,c1,c2,f_grad", [
    (False, 16, 16, 24, True), (True, 16, 16, 24, True),
    (False, 3, 64, 128, False)])
def test_two_conv_stage_training_matches_jax(fast, cin, c1, c2, f_grad):
    """The EdgeConv stage (f gets a gradient) and the transform net's
    stage shape (6 -> 64 -> 128 on raw xyz, no gradient to f)."""
    rng = np.random.default_rng(0)
    b, n, k = 2, 48, 6
    p1, s1 = conv_values(rng, 2 * cin, c1)
    p2, s2 = conv_values(rng, c1, c2)
    f = bf16_exact(rng, (b, n, cin))
    ct = bf16_exact(rng, (b, n, c2))
    fj = jnp.asarray(f, jnp.bfloat16)

    def block(q1, q2, x):
        out, n1, n2 = jlayers.apply_edge_conv_stage_fused(
            q1, to_jax(s1), q2, to_jax(s2), x, fj, k, training=True,
            bn_decay=jnp.float32(DECAY), eps=EPS, fast=fast, interpret=True)
        return out, (n1, n2)

    want, vjp, new = jax.vjp(block, to_jax(p1), to_jax(p2), fj, has_aux=True)
    g1, g2, gf = vjp(jnp.asarray(ct, jnp.bfloat16))
    conv1, conv2 = port_conv(p1, s1), port_conv(p2, s2)
    ft = torch.tensor(f).bfloat16().requires_grad_(f_grad)
    got = layers.apply_edge_conv_stage_fused(
        conv1, conv2, ft, ft.detach(), k, eps=EPS, fast=fast, training=True,
        decay=DECAY)
    got.backward(torch.tensor(ct).bfloat16())
    assert got.dtype == torch.bfloat16
    assert_out_close(got, want)
    assert_state_close((conv1, conv2), new)
    grads = {**param_grads("c1", conv1), **param_grads("c2", conv2)}
    want_g = {**jax_param_grads("c1", g1), **jax_param_grads("c2", g2)}
    if f_grad:
        grads["f"], want_g["f"] = ft.grad, gf
        assert ft.grad.dtype == torch.bfloat16
    else:
        assert ft.grad is None
    assert_grads_close(grads, want_g)


def test_single_conv_stage_training_matches_jax():
    rng = np.random.default_rng(1)
    b, n, c, k = 2, 56, 16, 6
    p, s = conv_values(rng, 2 * c, 24)
    f = bf16_exact(rng, (b, n, c))
    ct = bf16_exact(rng, (b, n, 24))
    fj = jnp.asarray(f, jnp.bfloat16)

    def block(q, x):
        return jlayers.apply_edge_conv_stage1_fused(
            q, to_jax(s), x, fj, k, training=True,
            bn_decay=jnp.float32(DECAY), eps=EPS, interpret=True)

    want, vjp, new = jax.vjp(block, to_jax(p), fj, has_aux=True)
    gp, gf = vjp(jnp.asarray(ct, jnp.bfloat16))
    conv = port_conv(p, s)
    ft = torch.tensor(f).bfloat16().requires_grad_(True)
    got = layers.apply_edge_conv_stage1_fused(conv, ft, ft.detach(), k,
                                              eps=EPS, training=True,
                                              decay=DECAY)
    got.backward(torch.tensor(ct).bfloat16())
    assert_out_close(got, want)
    assert_state_close((conv,), (new,))
    assert_grads_close({**param_grads("c", conv), "f": ft.grad},
                       {**jax_param_grads("c", gp), "f": gf})


def test_nmax_block_training_matches_jax():
    rng = np.random.default_rng(2)
    p, s = conv_values(rng, 48, 64)
    h = bf16_exact(rng, (2, 40, 48))
    ct = bf16_exact(rng, (2, 64))
    hj = jnp.asarray(h, jnp.bfloat16)

    def block(q, x):
        return jlayers.apply_conv_bn_relu_nmax(
            q, to_jax(s), x, training=True, bn_decay=jnp.float32(DECAY),
            eps=EPS, interpret=True)

    want, vjp, new = jax.vjp(block, to_jax(p), hj, has_aux=True)
    gp, gh = vjp(jnp.asarray(ct, jnp.bfloat16))
    conv = port_conv(p, s)
    ht = torch.tensor(h).bfloat16().requires_grad_(True)
    got = layers.apply_conv_bn_relu_nmax(conv, ht, eps=EPS, training=True,
                                         decay=DECAY)
    got.backward(torch.tensor(ct).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (2, 64)
    assert_out_close(got, want)
    assert_state_close((conv,), (new,))
    assert_grads_close({**param_grads("c", conv), "h": ht.grad},
                       {**jax_param_grads("c", gp), "h": gh})
