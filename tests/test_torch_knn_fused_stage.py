"""The fused EdgeConv stage of three or more convs against the JAX package
on the CPU, over the kernels' plain versions:

- B16's VJP, ``ops/edgeconv.py::knn_edge_gather`` (B1 + the moments'
  cotangent folded into ``dy_eff``, ``dv`` through B13), against the JAX
  ``knn_edge_gather`` custom_vjp in interpret mode;
- ``layers.apply_edge_conv_knn_fused`` (the stage's first conv + BN +
  ReLU), training (the hand-written backward) and eval, against the JAX
  layer in interpret mode;
- a narrow ShapeNet model whose first EdgeConv stage has three convs:
  one bf16 Plain-style step and one eval forward of ``forward_fused``
  against the JAX fused branch, with and without a static graph, and the
  ``n_valid`` refusal.

Sizes: B=2 (the step: 4), N=64 (a multiple of 8, see
tests/test_torch_fused_blocks.py), k=6, 16 channels.

Tolerances. B16's VJP: as B11's (tests/test_torch_static_graph.py states
them): indices equal on these tie-free inputs, y1 bitwise, the moments
within 1e-5 of the sums of magnitudes, du within one bf16 ulp plus 1e-5
of the summed magnitudes, dv within (m + 1) half-ulps of the scattered
magnitudes (the JAX VJP adds into a bf16 buffer on the CPU). The layer:
the fused-block tolerances of tests/test_torch_fused_blocks.py (outputs
within 2 bf16 ulps, BN state rtol 1e-4, each gradient leaf within 2e-2 of
its largest entry plus 2e-3 of the largest over all leaves). The model
step: the whole-step limits of tests/test_torch_fused_step.py, the port
replaying the JAX step's kNN indices, in-kernel BN moments and the batch
moments of its plain BN layers (``utils/replay.py``): the stage's tail
convs normalize 1,536 rows per channel, whose moments the two packages
sum in other orders, and one flipped bf16 rounding there moved this
narrow step's gradients by up to half of a leaf without the replay.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeTpuJax
from test_torch_dgcnn_cls import record_jax_tape
from test_torch_fused_blocks import (
    DECAY,
    EPS,
    assert_grads_close,
    assert_out_close,
    assert_state_close,
    bf16_exact,
    conv_values,
    jax_param_grads,
    np32,
    param_grads,
    port_conv,
    to_jax,
)
from test_torch_fused_step import jax_cfg, make_batch
from test_torch_train import jax_weights, port_cfg
from test_torch_unfused import recording
from weaksuppointcloudseg_tpu.models import dgcnn as jdgcnn
from weaksuppointcloudseg_tpu.models import layers as jlayers
from weaksuppointcloudseg_tpu.ops import edgeconv_pallas as jep
from weaksuppointcloudseg_tpu.train.steps import _loss_fn
from weaksuppointcloudseg_tpu_torch.losses.weaksup import masked_softmax_ce
from weaksuppointcloudseg_tpu_torch.models import layers
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.ops import edgeconv
from weaksuppointcloudseg_tpu_torch.utils import replay
from weaksuppointcloudseg_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)

B, N, C, K = 2, 64, 16, 6


# ------------------------------------------------------------ B16's VJP

@pytest.mark.parametrize("fast", [False, True])
def test_knn_edge_gather_matches_jax(fast):
    rng = np.random.default_rng(0)
    g = bf16_exact(rng, (B, N, C))
    v = bf16_exact(rng, (B, N, C))
    u = bf16_exact(rng, (B, N, C))
    dy = bf16_exact(rng, (B, N, K, C))
    dmom = (rng.standard_normal((2, C)) * 0.1).astype(np.float32)
    gj = jnp.asarray(g, jnp.bfloat16)
    (ij, yj, mj), vjp = jax.vjp(
        lambda a, c: jep.knn_edge_gather(gj, a, c, K, 32, True, fast),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16))
    dvj, duj = vjp((np.zeros(ij.shape, jax.dtypes.float0),
                    jnp.asarray(dy, jnp.bfloat16), jnp.asarray(dmom)))
    gt = torch.from_numpy(g).bfloat16()
    vt = torch.from_numpy(v).bfloat16().requires_grad_()
    ut = torch.from_numpy(u).bfloat16().requires_grad_()
    idx, y, mom = edgeconv.knn_edge_gather(gt, vt, ut, K, fast=fast)
    torch.autograd.backward((y, mom), (torch.from_numpy(dy).bfloat16(),
                                       torch.from_numpy(dmom)))
    assert np.array_equal(idx.numpy(), np.asarray(ij))
    assert np.array_equal(np32(y), np32(yj))
    y64 = np32(yj).astype(np.float64)
    mags = np.stack([np.abs(y64).sum((0, 1, 2)), (y64 * y64).sum((0, 1, 2))])
    assert np.all(np.abs(np32(mom) - np32(mj)) <= 1e-5 * mags)
    assert vt.grad.dtype == ut.grad.dtype == torch.bfloat16
    dy_eff = np32(torch.from_numpy(
        dy + dmom[0] + 2.0 * np32(y) * dmom[1]).bfloat16()).astype(np.float64)
    du_want = np32(duj)
    assert np.all(np.abs(np32(ut.grad) - du_want) <=
                  2.0 ** -7 * np.abs(du_want) + 1e-5 * np.abs(dy_eff).sum(2))
    flat = (idx.numpy() + np.arange(B)[:, None, None] * N).reshape(-1)
    mags = np.zeros((B * N, C))
    np.add.at(mags, flat, np.abs(dy_eff).reshape(-1, C))
    m = np.bincount(flat, minlength=B * N).max()
    err = np.abs(np32(vt.grad) - np32(dvj)).reshape(B * N, -1)
    assert np.all(err <= (m + 1) * 2.0 ** -9 * mags + 1e-6)


# ------------------------------------------------------------ the layer

@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_knn_fused_layer_matches_jax(training, fast):
    """apply_edge_conv_knn_fused: output, new BN state and (training) the
    gradients of the conv's parameters and of f."""
    rng = np.random.default_rng(1)
    p, s = conv_values(rng, 2 * C, 24)
    f = bf16_exact(rng, (B, N, C))
    ct = bf16_exact(rng, (B, N, K, 24))
    fj = jnp.asarray(f, jnp.bfloat16)

    def block(q, x):
        return jlayers.apply_edge_conv_knn_fused(
            q, to_jax(s), x, fj, K, training=training,
            bn_decay=jnp.float32(DECAY), eps=EPS, fast=fast, interpret=True)

    conv = port_conv(p, s)
    ft = torch.tensor(f).bfloat16().requires_grad_(training)
    got = layers.apply_edge_conv_knn_fused(conv, ft, ft.detach(), K, eps=EPS,
                                           fast=fast, training=training,
                                           decay=DECAY)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, K, 24)
    if not training:
        want, _ = block(to_jax(p), fj)
        assert_out_close(got, want)
        return
    want, vjp, new = jax.vjp(block, to_jax(p), fj, has_aux=True)
    gp, gf = vjp(jnp.asarray(ct, jnp.bfloat16))
    got.backward(torch.tensor(ct).bfloat16())
    assert_out_close(got, want)
    assert_state_close((conv,), (new,))
    assert ft.grad.dtype == torch.bfloat16
    assert_grads_close({**param_grads("c", conv), "f": ft.grad},
                       {**jax_param_grads("c", gp), "f": gf})


# ------------------------------------------------------------ the model

def three_conv_cfg(fast, static=False):
    """tests/test_torch_fused_step.py's narrow ShapeNet config with a
    three-conv first EdgeConv stage."""
    cfg = jax_cfg(fast)
    # allow_known_bad_bf16: the JAX package refuses bf16 training with such
    # a stage on a TPU backend (its tail convs miscompile there), and its
    # backend gate is patched to claim one
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, edge_channels=((16, 16, 16), (16, 16), (16,)),
        static_graph=static, allow_known_bad_bf16=True))


@pytest.fixture
def fused_jax_knn(monkeypatch):
    """The JAX seg model on its fused branch, the fused blocks (the 3+-conv
    stage's first conv among them) in interpret mode."""
    monkeypatch.setattr(jdgcnn, "jax", FakeTpuJax())
    for name in ("apply_edge_conv_stage_fused", "apply_edge_conv_stage1_fused",
                 "apply_conv_bn_relu_nmax", "apply_edge_conv_knn_fused"):
        monkeypatch.setattr(jlayers, name, functools.partial(
            getattr(jlayers, name), interpret=True))


@pytest.mark.parametrize("fast,static", [(False, False), (True, False),
                                         (False, True)])
@pytest.mark.parametrize("training", [True, False])
def test_three_conv_stage_model_matches_jax(fused_jax_knn, monkeypatch, fast,
                                            static, training):
    """One Plain-style step (training) or eval forward of forward_fused with
    a three-conv first stage against the JAX fused branch: B1 selects in
    that stage (B11's reference gathers along the transform stage's graph
    with a static graph)."""
    cfg = three_conv_cfg(fast, static)
    params, state = jax_weights(cfg)
    batch = make_batch(5)
    tape = record_jax_tape(monkeypatch)
    plain_tape = recording(monkeypatch)

    def loss(p):
        return _loss_fn(p, to_jax(state), to_jax(batch), cfg=cfg,
                        style="Plain", bn_decay=jnp.float32(DECAY),
                        gate=jnp.float32(0.0), rng=jax.random.PRNGKey(0))

    with jax.disable_jit():
        if training:
            (want_loss, (_, want_state, want_logits)), want_g = \
                jax.value_and_grad(loss, has_aux=True)(to_jax(params))
        else:
            logits_j, _ = jdgcnn.apply_dgcnn_seg(
                to_jax(params), to_jax(state), jnp.asarray(batch["data"]),
                jnp.asarray(batch["cat_onehot"]), cfg=cfg.model,
                training=False, bn_decay=None)
    jax.effects_barrier()
    knn_calls = [n for n, _, _ in tape if n.startswith("knn")]
    assert knn_calls == (["knn_edge"] + ["knn_edge_pre"] * 2 if static
                         else ["knn_edge"] * 4)

    model = DGCNNSeg(port_cfg(cfg).model)
    model.load_state_dict(params_from_jax(params, state), strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with replay.replay(tape), replay.replay_plain(plain_tape), \
            torch.set_grad_enabled(training):
        logits = model.forward_fused(tb["data"], tb["cat_onehot"],
                                     training=training, bn_decay=DECAY)
    if not training:
        np.testing.assert_allclose(np32(logits), np32(logits_j), rtol=0,
                                   atol=2e-2 * np.abs(np32(logits_j)).max())
        return
    ce = masked_softmax_ce(logits, tb["seg_onehot"], tb["mask"])
    ce.backward()
    np.testing.assert_allclose(float(ce.detach()), float(want_loss), rtol=1e-3)
    np.testing.assert_allclose(np32(logits), np32(want_logits), rtol=0,
                               atol=2e-2 * np.abs(np32(want_logits)).max())
    want_g = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, want_g), {}).items()}
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for g in got_g.values())
    assert_grads_close(got_g, want_g, rtol=0.1, atol_frac=1e-2)
    want_s = params_from_jax({}, jax.tree.map(np.asarray, want_state))
    for name, v in want_s.items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(), v.numpy(),
                                   rtol=2.0 ** -6, atol=2.0 ** -7, err_msg=name)


def test_three_conv_stage_refuses_n_valid():
    """n_valid (pre-padded eval points) needs stages of 1 or 2 convs, as
    the reference asserts (dgcnn.py:180-184)."""
    model = DGCNNSeg(port_cfg(three_conv_cfg(False)).model)
    tb = {k: torch.from_numpy(v) for k, v in make_batch(6).items()}
    with pytest.raises(ValueError, match="n_valid"):
        model.forward_fused(tb["data"], tb["cat_onehot"], n_valid=N - 8)
    out = model.forward_fused(tb["data"], tb["cat_onehot"])
    assert out.shape == (4, N, 12) and bool(torch.isfinite(out).all())
