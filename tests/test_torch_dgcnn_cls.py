"""The port's DGCNN classifier (``models/dgcnn_cls.py``) against the JAX
package's ``apply_dgcnn_cls`` on the CPU, with JAX weights carried across
by ``params_from_jax``.

- f32, training and eval: the plain composition with ``use_fused_knn`` on
  and off and with a static graph, against the JAX CPU path (which is
  the same composition): logits, the label-smoothed loss, every gradient
  and the new BN state.
- bf16: ``forward_fused`` (the fused blocks' plain versions here) against
  the JAX fused branch (its backend gate patched to claim a TPU, the
  fused blocks in interpret mode), training and eval, exact and fast
  selection, and with a static graph.
- ``classification_loss`` against the reference's, smoothing 0 being the
  plain cross entropy; routes and names.

Sizes: B=4 clouds of N=48 points (a multiple of 8, see
tests/test_torch_fused_blocks.py), k=6, edges (8, 8, 8, 16), global 32,
fc (16, 8), 7 classes. Dropout is off (keep 1.0) where the two packages
are compared: their random streams cannot be matched.

Tolerances. f32: the same operations in other summation orders. Measured
(training): logits within 1.3e-5 of their largest, the loss within 3e-6
relative, each gradient leaf within 3.4e-5 of its own largest entry
(1.9e-4 for dgcnn1.w with a static graph); the biases in front of a BN
and agg.beta, whose gradients cancel (zero, and ~1e-7: the fc1 BN's
cotangent sums to zero over the batch), are rounding noise within
4.8e-5 of the largest gradient. Held to rtol/atol 1e-4 (leaves: 1e-4 of
their own largest plus 1e-4 of the largest over all leaves). bf16: the whole-step
limits of tests/test_torch_fused_step.py (loss rtol 1e-3, logits 2e-2 of
their largest, each gradient leaf 0.1 of its largest plus 1e-2 of the
largest over all leaves, BN state two bf16 ulps), which state their
reasons; the port replays the JAX step's kNN indices, in-kernel BN
moments and the batch moments of its plain BN layers (``utils/replay.py``;
tests/test_torch_static_graph.py and tests/test_torch_knn_fused_stage.py
say why).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeTpuJax
from test_torch_fused_blocks import DECAY, assert_grads_close, np32, to_jax
from test_torch_unfused import recording
from weaksuppointcloudseg_tpu.models import dgcnn_cls as jcls
from weaksuppointcloudseg_tpu.models import layers as jlayers
from weaksuppointcloudseg_tpu.ops import conv_kmax_pallas as jck
from weaksuppointcloudseg_tpu.ops import edgeconv_pallas as jep
from weaksuppointcloudseg_tpu_torch import configs
from weaksuppointcloudseg_tpu_torch.models.dgcnn_cls import (
    DGCNNCls,
    classification_loss,
)
from weaksuppointcloudseg_tpu_torch.utils import replay
from weaksuppointcloudseg_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)

B, N, NUM_CLASSES = 4, 48, 7


def jax_cfg(**kw):
    return jcls.ClsConfig(**{**dict(
        num_classes=NUM_CLASSES, k=6, edge_channels=(8, 8, 8, 16),
        global_channels=32, fc_channels=(16, 8), keep_prob=1.0), **kw})


def port_cfg(j):
    return configs.ClsConfig(**{f.name: getattr(j, f.name)
                                for f in dataclasses.fields(configs.ClsConfig)})


def jax_weights(cfg, seed=0, transform=False):
    """JAX init with non-trivial biases, BN affines (a fifth of the gammas
    negative) and population stats; with ``transform`` a non-identity
    input transform as well (its zero-initialized output layer stops every
    gradient into the transform net)."""
    params, state = jcls.init_dgcnn_cls(jax.random.PRNGKey(seed), cfg)
    params = jax.tree.map(np.array, params)
    state = jax.tree.map(np.array, state)
    rng = np.random.default_rng(seed)

    def walk(p, s):
        for name, sub in p.items():
            if "w" not in sub:
                walk(sub, s[name])
                continue
            c = sub["b"].shape[0]
            sub["b"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
            if "gamma" in sub:
                sign = np.where(rng.random(c) < 0.2, -1.0, 1.0)
                sub["gamma"] = (rng.uniform(0.5, 1.5, c) * sign).astype(np.float32)
                sub["beta"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
                s[name]["mean"] = (rng.standard_normal(c) * 0.1).astype(np.float32)
                s[name]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    walk(params, state)
    if transform:
        t = params["transform_net"]["transform_out"]
        t["w"] = (rng.standard_normal(t["w"].shape) * 0.05).astype(np.float32)
    return params, state


def port_model(cfg, params, state):
    model = DGCNNCls(port_cfg(cfg))
    model.load_state_dict(params_from_jax(params, state), strict=True)
    return model


def clouds(seed, b=B, n=N):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((b, n, 3)) * 0.5).astype(np.float32),
            rng.integers(0, NUM_CLASSES, b).astype(np.int32))


def jax_step(cfg, params, state, x, labels, training):
    """(loss, logits, new state, grads or None at eval) of apply_dgcnn_cls
    + the loss."""
    def loss(p):
        logits, new = jcls.apply_dgcnn_cls(
            p, to_jax(state), x, cfg=cfg, training=training,
            bn_decay=jnp.float32(DECAY))
        return jcls.classification_loss(logits, jnp.asarray(labels),
                                        cfg.label_smoothing), (logits, new)
    if training:
        (l, (logits, new)), g = jax.value_and_grad(loss, has_aux=True)(
            to_jax(params))
        g = jax.tree.map(np.asarray, g)
    else:
        (l, (logits, new)), g = loss(to_jax(params)), None
    return float(l), np32(logits), jax.tree.map(np.asarray, new), g


def port_step(model, x, labels, cfg, training, fused=False):
    fn = model.forward_fused if fused else model.forward
    logits = fn(x, training=training, bn_decay=DECAY)
    loss = classification_loss(logits, torch.from_numpy(labels),
                               cfg.label_smoothing)
    if training:
        loss.backward()
    return float(loss.detach()), logits


def assert_state_matches(model, want_state, rtol, atol):
    want = params_from_jax({}, want_state)
    got = model.state_dict()
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


def grads_of(model):
    return {n: p.grad for n, p in model.named_parameters()}


def jax_grads(g):
    return {k: v.numpy() for k, v in params_from_jax(g, {}).items()}


# ------------------------------------------------------------------- f32

@pytest.mark.parametrize("use_fused,static", [(True, False), (False, False),
                                              (True, True)])
@pytest.mark.parametrize("training", [True, False])
def test_f32_classifier_matches_jax(use_fused, static, training):
    cfg = jax_cfg(use_fused_knn=use_fused, static_graph=static)
    params, state = jax_weights(cfg)
    x, labels = clouds(0)
    want_l, want_lg, want_s, want_g = jax_step(cfg, params, state,
                                               jnp.asarray(x), labels, training)
    model = port_model(cfg, params, state)
    with torch.set_grad_enabled(training):
        loss, logits = port_step(model, torch.from_numpy(x), labels, cfg,
                                 training)
    assert logits.dtype == torch.float32 and logits.shape == (B, NUM_CLASSES)
    np.testing.assert_allclose(loss, want_l, rtol=1e-4)
    np.testing.assert_allclose(np32(logits), want_lg, rtol=1e-4,
                               atol=1e-4 * np.abs(want_lg).max())
    if training:
        assert_grads_close(grads_of(model), jax_grads(want_g), rtol=1e-4,
                           atol_frac=1e-4)
    assert_state_matches(model, want_s, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ bf16

@pytest.fixture
def fused_cls_jax(monkeypatch):
    """The JAX classifier on its fused branch: dgcnn_cls's backend gate
    claims a TPU and the fused blocks run their Pallas kernels in interpret
    mode. Nothing in the JAX package changes."""
    monkeypatch.setattr(jcls, "jax", FakeTpuJax())
    for name in ("apply_edge_conv_stage_fused", "apply_edge_conv_stage1_fused",
                 "apply_conv_bn_relu_nmax"):
        monkeypatch.setattr(jlayers, name, functools.partial(
            getattr(jlayers, name), interpret=True))


def record_jax_tape(monkeypatch):
    """Record the JAX kernels' kNN indices and BN moments in the form of
    the port's utils/replay.py tape (tests/test_torch_static_graph.py)."""
    tape = []
    for mod, name, port_name, at in (
            (jep, "_knn_edge_impl", "knn_edge", 2),
            (jep, "_knn_edge_pre_impl", "knn_edge_pre", 1),
            (jck, "conv_minmax_pallas", "conv_minmax", 4),
            (jck, "conv_nmax_pallas", "conv_nmax", 4)):
        def recorded(*a, _fn=getattr(mod, name), _name=port_name, _at=at,
                     **kw):
            out = _fn(*a, **kw)
            idx = torch.tensor(np.asarray(out[0])) if _at == 2 else None
            tape.append((_name, idx, torch.tensor(np.asarray(out[_at]))))
            return out
        monkeypatch.setattr(mod, name, recorded)
    return tape


@pytest.mark.parametrize("fast,static", [(False, False), (True, False),
                                         (True, True)])
@pytest.mark.parametrize("training", [True, False])
def test_bf16_fused_classifier_matches_jax(fused_cls_jax, monkeypatch, fast,
                                           static, training):
    cfg = jax_cfg(knn_fast=fast, static_graph=static)
    params, state = jax_weights(cfg, seed=1, transform=True)
    x, labels = clouds(1)
    xb = jnp.asarray(x, jnp.bfloat16)
    tape = record_jax_tape(monkeypatch)
    plain_tape = recording(monkeypatch)
    with jax.disable_jit():
        want_l, want_lg, want_s, want_g = jax_step(cfg, params, state, xb,
                                                   labels, training)
    jax.effects_barrier()
    knn_calls = [n for n, _, _ in tape if n.startswith("knn")]
    assert knn_calls == (["knn_edge"] + ["knn_edge_pre"] * 4 if static
                         else ["knn_edge"] * 5)
    model = port_model(cfg, params, state)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    with replay.replay(tape), replay.replay_plain(plain_tape), \
            torch.set_grad_enabled(training):
        loss, logits = port_step(model, xt, labels, cfg, training, fused=True)
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(loss, want_l, rtol=1e-3)
    np.testing.assert_allclose(np32(logits), want_lg, rtol=0,
                               atol=2e-2 * np.abs(want_lg).max())
    if training:
        got_g = grads_of(model)
        assert all(g is not None for g in got_g.values())
        assert_grads_close(got_g, jax_grads(want_g), rtol=0.1, atol_frac=1e-2)
    assert_state_matches(model, want_s, rtol=2.0 ** -6, atol=2.0 ** -7)


# ------------------------------------------------------------------ loss

@pytest.mark.parametrize("smoothing", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_classification_loss_matches_jax(smoothing, dtype):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((16, 40)) * 3).astype(np.float32)
    labels = rng.integers(0, 40, 16).astype(np.int32)
    lj = jnp.asarray(logits, dtype)
    want = float(jcls.classification_loss(lj, jnp.asarray(labels), smoothing))
    lt = torch.from_numpy(np.asarray(lj.astype(jnp.float32))).to(
        getattr(torch, dtype)).requires_grad_()
    got = classification_loss(lt, torch.from_numpy(labels), smoothing)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    want_g = jax.grad(lambda z: jcls.classification_loss(
        z, jnp.asarray(labels), smoothing))(lj)
    got.backward()
    np.testing.assert_allclose(np32(lt.grad), np32(want_g), rtol=0,
                               atol=2.0 ** -6 * np.abs(np32(want_g)).max())
    if smoothing == 0.0:  # the plain cross entropy
        ce = torch.nn.functional.cross_entropy(lt.detach().float(),
                                               torch.from_numpy(labels).long())
        np.testing.assert_allclose(float(got.detach()), float(ce),
                                   rtol=1e-5 if dtype == "float32" else 1e-2)


# ---------------------------------------------------------- routes, names

def test_parameter_names_follow_init_dgcnn_cls():
    """The module's state_dict is init_dgcnn_cls's pytree, leaf for leaf
    and shape for shape, at the published widths."""
    params, state = jcls.init_dgcnn_cls(jax.random.PRNGKey(0))
    want = params_from_jax(jax.tree.map(np.asarray, params),
                           jax.tree.map(np.asarray, state))
    got = DGCNNCls().state_dict()
    assert set(got) == set(want)
    assert all(got[k].shape == want[k].shape for k in want)


def test_cpu_takes_the_plain_route_and_dropout_draws_from_the_generator(
        monkeypatch):
    cfg = port_cfg(jax_cfg(keep_prob=0.5))
    model = DGCNNCls(cfg, seed=3)
    calls = []
    monkeypatch.setattr(model, "forward_fused",
                        lambda *a, **k: calls.append("fused"))
    x = torch.from_numpy(clouds(4)[0]).bfloat16()
    out = [model(x, training=True, bn_decay=DECAY,
                 generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    assert not calls
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])
    assert out[0].dtype == torch.bfloat16
    assert torch.equal(model(x), model(x))  # eval: no dropout
    with pytest.raises(ValueError, match="unsupported device"):
        model(x.to("meta"))
