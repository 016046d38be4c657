"""The port's f32 Full-style training against the JAX package's on the CPU:
schedules, batch-moment BN, the factored EdgeConv backward, each loss, one
whole train step (loss components, every gradient leaf, new BN state),
Adam, three steps, the trainer's epochs and evaluation, and the training
CLI. Tiny ShapeNet-shaped config as tests/test_train.py's, dropout off (the
two packages' random streams cannot be matched); weights move across with
utils/checkpoint.py::params_from_jax."""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from weaksuppointcloudseg_tpu import configs as jc
from weaksuppointcloudseg_tpu.data import sampling as jsampling
from weaksuppointcloudseg_tpu.data import shapenet as jshapenet
from weaksuppointcloudseg_tpu.losses import weaksup as jloss
from weaksuppointcloudseg_tpu.models import layers as jlayers
from weaksuppointcloudseg_tpu.models.dgcnn import init_dgcnn_seg
from weaksuppointcloudseg_tpu.ops import schedules as jsched
from weaksuppointcloudseg_tpu.train import loop as jloop
from weaksuppointcloudseg_tpu.train.state import TrainState, make_optimizer
from weaksuppointcloudseg_tpu.train.steps import _loss_fn, make_train_step as jax_train_step
from weaksuppointcloudseg_tpu_torch import configs as pc
from weaksuppointcloudseg_tpu_torch.cli import test_shapenet as test_cli
from weaksuppointcloudseg_tpu_torch.cli import train_shapenet as train_cli
from weaksuppointcloudseg_tpu_torch.data import sampling
from weaksuppointcloudseg_tpu_torch.data import shapenet
from weaksuppointcloudseg_tpu_torch.losses import weaksup as ploss
from weaksuppointcloudseg_tpu_torch.models import layers
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.ops import schedules
from weaksuppointcloudseg_tpu_torch.train.loop import ShapeNetTrainer
from weaksuppointcloudseg_tpu_torch.train.state import Adam
from weaksuppointcloudseg_tpu_torch.train.steps import loss_fn, make_train_step
from weaksuppointcloudseg_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)

NUM_CLASSES, NUM_CATS, N = 12, 4, 64


def jax_cfg(batch_size=2, rampup=101):
    """tests/test_train.py's tiny ShapeNet config with dropout off."""
    base = jc.shapenet_config()
    model = dataclasses.replace(
        base.model, num_points=N, num_classes=NUM_CLASSES,
        num_categories=NUM_CATS, k=8, global_channels=128,
        edge_channels=((16, 16), (16, 16), (16,)), category_embed_channels=8,
        head_channels=(32, 32, 16), head_keep_prob=(None, None, None))
    train = dataclasses.replace(base.train, batch_size=batch_size,
                                rampup=rampup)
    weaksup = dataclasses.replace(base.weaksup, smooth_knn=4, rampup=rampup)
    return dataclasses.replace(base, model=model, train=train, weaksup=weaksup)


def port_cfg(j):
    """The port's config with the JAX config's values, field for field."""
    def conv(cls, obj):
        return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})
    return pc.ExperimentConfig(
        dataset=j.dataset, model=conv(pc.ModelConfig, j.model),
        schedule=conv(pc.ScheduleConfig, j.schedule),
        weaksup=conv(pc.WeakSupConfig, j.weaksup),
        labelprop=conv(pc.LabelPropConfig, j.labelprop),
        train=conv(pc.TrainConfig, j.train))


def jax_weights(cfg, seed=0, transform=False):
    """JAX init with non-trivial biases, BN affines (|gamma| in [0.5, 1.5],
    a fifth of them negative) and population stats; with ``transform`` a
    non-identity input transform as well (its zero-initialized output layer
    stops every gradient into the transform net)."""
    params, state = init_dgcnn_seg(jax.random.PRNGKey(seed), cfg.model)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
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
    model = DGCNNSeg(port_cfg(cfg).model)
    model.load_state_dict(params_from_jax(params, state), strict=True)
    return model


def make_batch(seed, b=4):
    """A Full-style batch of b clouds (b/2 interleaved pairs)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, N, 3)) * 0.5).astype(np.float32)
    seg = rng.integers(0, NUM_CLASSES, (b, N))
    cat = np.eye(NUM_CATS, dtype=np.float32)[rng.integers(0, NUM_CATS, b)]
    return {"data": x, "seg": seg.astype(np.int32),
            "seg_onehot": np.eye(NUM_CLASSES, dtype=np.float32)[seg],
            "mask": (rng.random((b, N)) < 0.3).astype(np.float32),
            "cat_onehot": cat, "part_bias": cat @ rng.random((NUM_CATS, NUM_CLASSES)).round().astype(np.float32),
            "valid": np.ones(b, np.float32)}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# ------------------------------------------------------------- schedules

@pytest.mark.parametrize("step", [0, 14, 15, 28, 29, 42, 43, 57, 10_000])
def test_schedules_at_staircase_edges(step):
    """Decay steps of 100 and 200 samples at batch 7: the staircase edges
    fall between steps 14|15, 28|29, 42|43 and 57|58. Bitwise equal (both
    compute in f32)."""
    cfg = jc.ScheduleConfig(lr_decay_step=100, bn_decay_decay_step=200)
    port = pc.ScheduleConfig(lr_decay_step=100, bn_decay_decay_step=200)
    assert schedules.learning_rate_schedule(step, 7, port) == float(
        jsched.learning_rate_schedule(step, 7, cfg))
    assert schedules.bn_decay_schedule(step, 7, port) == float(
        jsched.bn_decay_schedule(step, 7, cfg))


def test_schedules_count_unique_samples():
    """The preset's first LR edge is 337,620 samples: at a unique batch of
    32 it falls between steps 10550 and 10551."""
    port, ref = pc.ScheduleConfig(), jc.ScheduleConfig()
    for step in (10550, 10551, 21101, 21102):
        assert schedules.learning_rate_schedule(step, 32, port) == float(
            jsched.learning_rate_schedule(step, 32, ref))
        assert schedules.bn_decay_schedule(step, 32, port) == float(
            jsched.bn_decay_schedule(step, 32, ref))
    assert schedules.learning_rate_schedule(10550, 32, port) == pytest.approx(1e-3)
    assert schedules.learning_rate_schedule(10551, 32, port) == pytest.approx(5e-4)


# ------------------------------------------------------------------ layers

def test_batch_norm_training_moments_and_update():
    """Batch moments (one pass, biased, clamped), the normalized output and
    the population update pop*decay + batch*(1-decay): rtol 1e-5 (another
    reduction order)."""
    rng = np.random.default_rng(0)
    y = (rng.standard_normal((3, 5, 7, 6)) * 2 + 1).astype(np.float32)
    p = {"gamma": rng.uniform(-1, 1, 6).astype(np.float32),
         "beta": rng.standard_normal(6).astype(np.float32)}
    s = {"mean": rng.standard_normal(6).astype(np.float32),
         "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    want, new = jlayers._batch_norm(jnp.asarray(y), to_jax(p), to_jax(s),
                                    training=True, decay=jnp.float32(0.7))
    conv = layers.Conv(4, 6)
    conv.load_state_dict({"w": conv.w.detach(), "b": conv.b.detach(),
                          **{k: torch.from_numpy(v) for k, v in {**p, **s}.items()}})
    got = layers.batch_norm(torch.from_numpy(y), conv, 1e-3, training=True,
                            decay=0.7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for key in ("mean", "var"):
        np.testing.assert_allclose(getattr(conv, key).numpy(),
                                   np.asarray(new[key]), rtol=1e-5, atol=1e-6)


def test_edge_conv_matmul_backward_matches_jax():
    """The factored backward (no 2C-wide cotangent) against jax.vjp of the
    JAX edge_conv_matmul's custom VJP: every input's cotangent to rtol
    1e-5 (f32 sums in another order)."""
    rng = np.random.default_rng(1)
    f = rng.standard_normal((2, 30, 5)).astype(np.float32)
    nbr = rng.standard_normal((2, 30, 6, 5)).astype(np.float32)
    w = rng.standard_normal((10, 7)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    dy = rng.standard_normal((2, 30, 6, 7)).astype(np.float32)
    out, vjp = jax.vjp(jlayers.edge_conv_matmul, *map(jnp.asarray, (f, nbr, w, b)))
    want = vjp(jnp.asarray(dy))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (f, nbr, w, b)]
    got = layers.edge_conv_matmul(*args)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    got.backward(torch.from_numpy(dy))
    for a, ref in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-4)


# ------------------------------------------------------------------ losses

def _loss_pair(name):
    return {
        "masked_ce": (lambda lg, bt: jloss.masked_softmax_ce(
            lg, bt["seg_onehot"], bt["mask"]),
            lambda lg, bt: ploss.masked_softmax_ce(lg, bt["seg_onehot"], bt["mask"])),
        "siamese": (lambda lg, bt: jloss.siamese_consistency(jax.nn.softmax(lg)),
                    lambda lg, bt: ploss.siamese_consistency(torch.softmax(lg, -1))),
        "mil": (lambda lg, bt: jloss.mil_inexact(lg, bt["seg_onehot"]),
                lambda lg, bt: ploss.mil_inexact(lg, bt["seg_onehot"])),
        "smooth": (lambda lg, bt: jloss.smooth_knn_laplacian(
            jax.nn.softmax(lg), bt["data"], gamma=0.1, k=4),
            lambda lg, bt: ploss.smooth_knn_laplacian(
                torch.softmax(lg, -1), bt["data"], gamma=0.1, k=4)),
    }[name]


@pytest.mark.parametrize("name", ["masked_ce", "siamese", "mil", "smooth"])
def test_each_loss_and_its_gradient(name):
    """Value and gradient with respect to the logits: rtol 1e-5."""
    batch = make_batch(2)
    logits = np.random.default_rng(3).standard_normal(
        (4, N, NUM_CLASSES)).astype(np.float32) * 2
    jfn, pfn = _loss_pair(name)
    jb = to_jax(batch)
    want, want_g = jax.value_and_grad(lambda lg: jfn(lg, jb))(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = pfn(lg, to_torch(batch))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_g).max()))


@pytest.mark.parametrize("gate,frozen", [(0.0, False), (1.0, False), (1.0, True)])
def test_total_loss_gate(gate, frozen):
    """seg + gate * (siamese + inexact + smooth); the frozen gate is 0."""
    batch = make_batch(4)
    logits = np.random.default_rng(5).standard_normal(
        (4, N, NUM_CLASSES)).astype(np.float32)
    jb, tb = to_jax(batch), to_torch(batch)
    want, wc = jloss.total_weaksup_loss(
        jnp.asarray(logits), jb["seg_onehot"], jb["mask"], jb["data"],
        gate=jnp.float32(gate), smooth_knn=4, compat_frozen_gate=frozen)
    got, gc = ploss.total_weaksup_loss(
        torch.from_numpy(logits), tb["seg_onehot"], tb["mask"], tb["data"],
        gate=gate, smooth_knn=4, compat_frozen_gate=frozen)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in wc:
        np.testing.assert_allclose(float(gc[k]), float(wc[k]), rtol=1e-5)
    if gate == 0.0 or frozen:
        assert float(got) == float(gc["seg"])


# --------------------------------------------------------------- the step

_jax_grad = jax.jit(jax.value_and_grad(_loss_fn, has_aux=True),
                    static_argnames=("cfg", "style"))

def _full_step(params, state, batch):
    """The port's loss components, gradients and new BN state for one
    Full-style step."""
    cfg = jax_cfg()
    model = port_model(cfg, params, state)
    total, comps, _ = loss_fn(model, to_torch(batch), cfg=port_cfg(cfg),
                              style="Full", bn_decay=0.5, gate=1.0)
    total.backward()
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    return ({k: float(v.detach()) for k, v in comps.items()}, grads,
            {k: v.numpy() for k, v in model.state_dict().items()})


def _jax_full_step(params, state, batch):
    (_, (comps, new_state, _)), grads = _jax_grad(
        to_jax(params), to_jax(state), to_jax(batch), cfg=jax_cfg(),
        style="Full", bn_decay=jnp.float32(0.5), gate=jnp.float32(1.0),
        rng=jax.random.PRNGKey(1))
    grads = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, grads), {}).items()}
    new_state = {k: v.numpy() for k, v in params_from_jax(
        {}, jax.tree.map(np.asarray, new_state)).items()}
    return {k: float(v) for k, v in comps.items()}, grads, new_state


def test_full_step_matches_jax_value_and_grad():
    """One Full-style training forward + backward against
    jax.value_and_grad of train/steps.py::_loss_fn with the same weights
    (the transform net at its identity init).

    Tolerances: loss components rtol 1e-4 (the Siamese and smoothness
    terms are small differences of probabilities, so the probabilities'
    f32 rounding shows in them more than in the seg loss). Every gradient
    leaf:
    |g - g_jax| <= 2e-4 max|g_jax of the leaf| + 1e-5 max|g_jax of all
    leaves|; the absolute term covers the conv biases in front of a BN,
    whose true gradient is 0 (BN subtracts the batch mean) and whose
    computed one is rounding noise in both packages. New BN state: rtol
    1e-4, atol 1e-5 (moments of activations ten f32 layers deep)."""
    params, state = jax_weights(jax_cfg())
    batch = make_batch(7)
    want_c, want_g, want_s = _jax_full_step(params, state, batch)
    got_c, got_g, got_s = _full_step(params, state, batch)
    assert set(got_c) == set(want_c) and set(got_g) == set(want_g)
    for k in want_c:
        np.testing.assert_allclose(got_c[k], want_c[k], rtol=1e-4, err_msg=k)
    scale = max(np.abs(v).max() for v in want_g.values())
    for name, w in want_g.items():
        err = np.abs(got_g[name] - w).max()
        assert err <= 2e-4 * np.abs(w).max() + 1e-5 * scale, (name, err)
    for name, v in want_s.items():
        np.testing.assert_allclose(got_s[name], v, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_transform_net_training_branch_matches_jax():
    """The transform net's non-fused training branch alone (edge features
    of data in, [B, K, K] transform out, batch-moment BN throughout) with
    a non-identity output layer: the transform and the gradient of
    sum(R * transform) for a fixed random R with respect to every
    transform-net leaf, against the JAX branch. rtol 1e-4 of each leaf's
    largest gradient plus 1e-5 of the largest overall; new BN state rtol
    1e-4, atol 1e-5."""
    from weaksuppointcloudseg_tpu.models import transform_net as jtn
    from weaksuppointcloudseg_tpu.ops import neighbors as jnbr

    cfg = jax_cfg()
    params, state = jax_weights(cfg, seed=3, transform=True)
    tp, ts = params["transform_net"], state["transform_net"]
    x = make_batch(9, b=8)["data"]
    r = np.random.default_rng(4).standard_normal((8, 3, 3)).astype(np.float32)

    def jax_obj(p):
        ef = jnbr.edge_feature_auto(jnp.asarray(x), jnp.asarray(x), 8)
        t, new = jtn.apply_transform_net(p, to_jax(ts), ef, K=3, training=True,
                                         bn_decay=jnp.float32(0.5))
        return jnp.sum(t * r), (t, new)

    (_, (want_t, want_s)), want_g = jax.value_and_grad(jax_obj, has_aux=True)(
        to_jax(tp))
    model = port_model(cfg, params, state).transform_net
    xt = torch.from_numpy(x)
    got_t = model.forward_plain(xt, xt, 8, eps=1e-3, training=True, decay=0.5)
    torch.sum(got_t * torch.from_numpy(r)).backward()
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(want_t),
                               rtol=1e-4, atol=1e-5)
    want_g = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, want_g), {}).items()}
    scale = max(np.abs(v).max() for v in want_g.values())
    assert np.abs(want_g["tconv1.w"]).max() > 1e-3 * scale
    named = dict(model.named_parameters())
    assert set(named) == set(want_g)
    for name, w in want_g.items():
        err = np.abs(named[name].grad.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-5 * scale, (name, err)
    for name, v in params_from_jax({}, jax.tree.map(np.asarray, want_s)).items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_adam_matches_optax():
    """Three updates with changing gradients and learning rates against
    optax.adam under inject_hyperparams (the JAX package's optimizer):
    rtol 1e-6 (bias corrections rounded in another order)."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    tx = make_optimizer()
    jp, opt_state = to_jax(p0), tx.init(to_jax(p0))
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    adam = Adam(tp.values())
    for t, lr in enumerate((1e-3, 1e-3, 5e-4)):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
        opt_state.hyperparams["learning_rate"] = lr
        upd, opt_state = tx.update(to_jax(g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        adam.apply_gradients(lr)
        assert adam.step == t + 1
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


def test_three_steps_match_jax_train_step():
    """Three steps of the port's make_train_step against the JAX jitted
    step on the same batches, from an identity input transform.

    Steps 1 and 2: every metric to rtol 1e-4. The first
    update moves the zero-initialized transform output layer, so step 3
    runs with an active input transform; with it this tiny step is
    ill-conditioned (scaling the input by 1 + 1e-7 moves the step's own
    gradients by up to 2.6e-1 of their largest entry on seeds 0-4,
    scripts/torch_step_sensitivity.py), so step 3's metrics are held to
    rtol 2e-2. Parameters after the third update: every element within 6
    lr of the JAX value (Adam moves an element by at most about lr per
    step) and at least 90% of the elements within 0.1 lr. The conv biases
    in front of a BN have zero true gradient; Adam turns their rounding
    noise into steps of about lr in either direction."""
    cfg = jax_cfg()
    params, state = jax_weights(cfg, seed=1)
    batches = [make_batch(20 + i) for i in range(3)]
    tx = make_optimizer()
    jstate = TrainState(params=to_jax(params), bn_state=to_jax(state),
                        opt_state=tx.init(to_jax(params)),
                        step=jnp.zeros((), jnp.int32), tx=tx)
    jstep = jax_train_step(cfg, style="Full")
    model = port_model(cfg, params, state)
    opt = Adam(model.parameters())
    step = make_train_step(port_cfg(cfg), model, opt, style="Full")
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, to_jax(batch), jnp.float32(1.0),
                           jax.random.PRNGKey(0))
        pm = step(to_torch(batch), 1.0)
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-4 if i < 2 else 2e-2,
                                       err_msg=f"step {i} {k}")
    assert opt.step == int(jstate.step) == 3
    lr = cfg.schedule.base_learning_rate
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), {})
    err = np.concatenate([np.abs(p.detach().numpy() - want[n].numpy()).ravel()
                          for n, p in model.named_parameters()])
    assert err.max() <= 6 * lr
    assert np.mean(err <= 0.1 * lr) >= 0.9


# ------------------------------------------------------ trainer and CLI

def _write(tmp_path_factory, name, train_samples):
    base = str(tmp_path_factory.mktemp(name))
    jshapenet.write_synthetic(base, num_categories=NUM_CATS, parts_per_category=3,
                              train_samples=train_samples, val_samples=3,
                              test_samples=2, num_points=N, seed=0)
    return base


@pytest.fixture(scope="module")
def one_batch_dataset(tmp_path_factory):
    return _write(tmp_path_factory, "shapenet_one_batch", 2)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return _write(tmp_path_factory, "shapenet_train", 8)


def test_trainer_epochs_and_eval_match_jax(one_batch_dataset):
    """The port's ShapeNetTrainer (device="cpu") against the JAX trainer on
    the same synthetic split, seed and weights; the shuffles, label masks
    and Siamese augmentation come from the shared numpy stream. One batch
    per epoch: epoch 0 runs with the gate off and duplicate pairs, epoch 1
    (rampup 1) with the gate on and augmented pairs. Epoch 0's metrics:
    rtol 1e-4, atol 1e-5. The first update makes the input transform
    active, the ill-conditioned regime of test_three_steps_match_jax_
    train_step, so epoch 1's metrics are held to rtol 2e-2 and the
    evaluation after it to: loss rtol 1e-3, accuracy and mIoU atol
    1e-2."""
    jcfg = jax_cfg(batch_size=2, rampup=1)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, num_classes=NUM_CATS * 3))
    jds = jshapenet.ShapeNetDataset(one_batch_dataset)
    pts_idx = jsampling.generate_sample_index(2, N, 0.2, seed=0)
    jtr = jloop.ShapeNetTrainer(jcfg, jds, pts_idx, seed=0)
    ds = shapenet.ShapeNetDataset(one_batch_dataset)
    ptr = ShapeNetTrainer(port_cfg(jcfg), ds,
                          sampling.generate_sample_index(2, N, 0.2, seed=0),
                          seed=0, device="cpu")
    np.testing.assert_array_equal(ptr.pts_idx, pts_idx)
    ptr.model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jtr.state.params),
        jax.tree.map(np.asarray, jtr.state.bn_state)))
    for epoch in range(2):
        want, got = jtr.train_epoch(), ptr.train_epoch()
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k],
                                       rtol=1e-4 if epoch == 0 else 2e-2,
                                       atol=1e-5, err_msg=f"epoch {epoch} {k}")
    assert ptr.epoch == jtr.epoch == 2 and ptr.opt.step == 2
    want, got = jtr.evaluate(), ptr.evaluate()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    np.testing.assert_allclose(got[1:3], want[1:3], atol=1e-2)
    np.testing.assert_allclose(got[3], want[3], atol=1e-2)


def test_train_cli_on_cpu_writes_what_the_test_cli_restores(dataset, tmp_path,
                                                            monkeypatch, capsys):
    """The training CLI with the JAX CLI's flags and --device cpu: two
    epochs, the reference's log lines, a metrics log and checkpoints; the
    test CLI then restores the best checkpoint."""
    monkeypatch.chdir(tmp_path)
    out = train_cli.main(["--DataPath", dataset, "-m", "0.1", "-sty", "Full",
                          "-bs", "2", "--Epoch", "2", "--Rampup", "1",
                          "--ExpRslt", "1", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "Epoch 0 Train loss" in text and "Epoch 0 Eval loss" in text
    assert "Epoch 1 Train loss" in text
    assert np.isfinite(out["train"]["total"])
    assert out["train"]["lr"] == pytest.approx(1e-3)
    assert 0.0 <= out["eval"]["acc"] <= 1.0
    (run,) = glob.glob(str(tmp_path / "Results/ShapeNet/DGCNN_sty-Full_m-0.1_*"))
    best = os.path.join(run, "Checkpoint", "Checkpoint_epoch-best.npz")
    assert os.path.exists(best)
    with open(os.path.join(run, "Summary", "metrics.jsonl")) as f:
        events = [line.split('"event": "')[1].split('"')[0] for line in f]
    assert events == ["train_epoch", "eval", "train_epoch"]
    res = test_cli.main(["--DataPath", dataset, "--Checkpoint", best,
                         "--batchsize", "2", "--num_points", "80",
                         "--device", "cpu"])
    assert np.isfinite(res["perdata_miou"])


def test_entry_points_need_a_card_unless_asked(dataset):
    """No silent CPU fallback: without a card the trainer and both CLIs
    raise unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = port_cfg(jax_cfg())
    ds = shapenet.ShapeNetDataset(dataset)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShapeNetTrainer(cfg, ds)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--DataPath", dataset, "--Epoch", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        test_cli.main(["--DataPath", dataset, "--Checkpoint", "none.npz"])
