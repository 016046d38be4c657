"""The port's bf16 Plain-style training step against the JAX package on
the CPU, the routes of bf16 training, and the training CLI in bf16.

The step: ``DGCNNSeg.forward_fused(training=True)`` + masked CE + backward
against ``train/steps.py::_loss_fn`` on the JAX model's fused branch (its
backend gate patched to claim a TPU, the fused blocks run with
``interpret=True``), with the same weights, in both ``knn_fast`` modes.
B=4, k=6, N=64 (a multiple of 8, see tests/test_torch_fused_blocks.py).

Tolerances. The blocks carry the tolerances tests/test_torch_fused_blocks.py
states. The whole step chains ten bf16 layers, and a one-ulp flip anywhere
(a y that rounds the other way, and with it a k-max slot) moves
everything behind it. Measured on seeds 0 and 1 at B=4: logits bitwise
equal on seed 0 and within 1.2e-2 of their largest on seed 1; the worst
gradient leaf 7.5e-2 of its own largest entry (adj_conv1.w) and 4.7e-2 for
the transform output layer, whose gradient sums over only four samples;
the biases in front of a BN within 6e-3 of the largest gradient. The step
is held to 0.1 of each leaf's largest entry plus 1e-2 of the largest over
all leaves, the loss to rtol 1e-3, the logits to 2e-2 of their largest
and the new BN state to two bf16 ulps (rtol 2^-6, atol 2^-7).
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
from test_torch_train import jax_weights, port_cfg
from weaksuppointcloudseg_tpu import configs as jc
from weaksuppointcloudseg_tpu.models import dgcnn as jdgcnn
from weaksuppointcloudseg_tpu.models import layers as jlayers
from weaksuppointcloudseg_tpu.train.steps import _loss_fn
from weaksuppointcloudseg_tpu_torch import configs as pc
from weaksuppointcloudseg_tpu_torch.losses.weaksup import masked_softmax_ce
from weaksuppointcloudseg_tpu_torch.models import layers
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.train.steps import (
    fused_route,
    smooth_graph_reusable,
)
from weaksuppointcloudseg_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)

# ---------------------------------------------------------------- the step

NUM_CLASSES, NUM_CATS, N = 12, 4, 64


def jax_cfg(fast):
    """A narrow ShapeNet-shaped config in bf16 with the fused kNN, dropout
    off (the two packages' random streams cannot be matched)."""
    base = jc.shapenet_config()
    model = dataclasses.replace(
        base.model, num_points=N, num_classes=NUM_CLASSES,
        num_categories=NUM_CATS, k=6, global_channels=128,
        edge_channels=((16, 16), (16, 16), (16,)), category_embed_channels=8,
        head_channels=(32, 32, 16), head_keep_prob=(None, None, None),
        compute_dtype="bfloat16", use_fused_knn=True, knn_fast=fast)
    return dataclasses.replace(base, model=model, train=dataclasses.replace(
        base.train, batch_size=2, style="Plain"))


def make_batch(seed, b=4):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, NUM_CLASSES, (b, N))
    return {"data": (rng.standard_normal((b, N, 3)) * 0.5).astype(np.float32),
            "seg": seg.astype(np.int32),
            "seg_onehot": np.eye(NUM_CLASSES, dtype=np.float32)[seg],
            "mask": (rng.random((b, N)) < 0.3).astype(np.float32),
            "cat_onehot": np.eye(NUM_CATS, dtype=np.float32)[
                rng.integers(0, NUM_CATS, b)]}


@pytest.fixture
def fused_jax(monkeypatch):
    """The JAX model on its fused branch: dgcnn's backend gate claims a
    TPU, and the three fused blocks run their Pallas kernels in interpret
    mode. Nothing in the JAX package changes."""
    monkeypatch.setattr(jdgcnn, "jax", FakeTpuJax())
    for name in ("apply_edge_conv_stage_fused", "apply_edge_conv_stage1_fused",
                 "apply_conv_bn_relu_nmax"):
        monkeypatch.setattr(jlayers, name, functools.partial(
            getattr(jlayers, name), interpret=True))
    calls = {"stage": 0}
    stage = jlayers.apply_edge_conv_stage_fused

    def counted(*a, **kw):
        calls["stage"] += 1
        return stage(*a, **kw)

    monkeypatch.setattr(jlayers, "apply_edge_conv_stage_fused", counted)
    return calls


@pytest.mark.parametrize("fast", [False, True])
def test_plain_bf16_step_matches_jax_fused(fused_jax, fast):
    """One Plain-style bf16 step: forward_fused(training=True), the masked
    CE and its backward, against jax.value_and_grad of _loss_fn on the
    fused branch, with the tolerances the module docstring states."""
    cfg = jax_cfg(fast)
    params, state = jax_weights(cfg)
    batch = make_batch(3)
    grad_fn = jax.jit(jax.value_and_grad(_loss_fn, has_aux=True),
                      static_argnames=("cfg", "style"))
    (want_loss, (_, want_state, want_logits)), want_g = grad_fn(
        to_jax(params), to_jax(state), to_jax(batch), cfg=cfg, style="Plain",
        bn_decay=jnp.float32(DECAY), gate=jnp.float32(0.0),
        rng=jax.random.PRNGKey(0))
    assert fused_jax["stage"] == 3  # the transform stage and two EdgeConv stages

    model = DGCNNSeg(port_cfg(cfg).model)
    model.load_state_dict(params_from_jax(params, state), strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model.forward_fused(tb["data"], tb["cat_onehot"], training=True,
                                 bn_decay=DECAY)
    loss = masked_softmax_ce(logits, tb["seg_onehot"], tb["mask"])
    loss.backward()

    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-3)
    np.testing.assert_allclose(np32(logits), np32(want_logits), rtol=0,
                               atol=2e-2 * np.abs(np32(want_logits)).max())
    want_g = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, want_g), {}).items()}
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is not None for g in got_g.values())
    assert_grads_close(got_g, want_g, rtol=0.1, atol_frac=1e-2)
    want_s = params_from_jax({}, jax.tree.map(np.asarray, want_state))
    for name, v in want_s.items():
        # the head's BN layers average 4 bf16 values: one that rounds the
        # other way moves their moments by up to a bf16 ulp
        np.testing.assert_allclose(model.state_dict()[name].numpy(), v.numpy(),
                                   rtol=2.0 ** -6, atol=2.0 ** -7, err_msg=name)


def test_replay_reproduces_a_step():
    """utils/replay.py: a step replaying another step's kNN indices and BN
    moments reproduces its logits and gradients bitwise, even where its own
    kNN would choose otherwise (its input moved); other call sequences
    raise; each recorded block rerun on its own at its recorded inputs and
    cotangent reproduces itself."""
    from weaksuppointcloudseg_tpu_torch.utils import replay

    cfg = port_cfg(jax_cfg(True)).model
    tb = {k: torch.from_numpy(v) for k, v in make_batch(5).items()}
    runs = []
    for moved in (False, True):
        model = DGCNNSeg(cfg, seed=1)
        x = tb["data"] * (1.0 + 1e-2 * moved)
        ctx = replay.replay(runs[0][2]) if moved else replay.record()
        with ctx as tape:
            logits = model.forward_fused(x, tb["cat_onehot"], training=True,
                                         bn_decay=DECAY)
        masked_softmax_ce(logits, tb["seg_onehot"], tb["mask"]).backward()
        runs.append((logits.detach(), {n: p.grad for n, p in
                                       model.named_parameters()}, tape))
    (l0, g0, tape), (l1, g1, _) = runs
    assert [name for name, _, _ in tape] == [
        "knn_edge", "conv_minmax", "conv_nmax", "knn_edge", "conv_minmax",
        "knn_edge", "conv_minmax", "knn_edge", "conv_nmax"]
    errs, null = replay.grad_errors(model, g1, g0)
    assert len(null) == 15 and set(errs) == set(g0)  # every conv with a BN
    # the moved input changes every value but no neighbour or moment
    assert 0 < max(errs.values()) and not torch.equal(l0, l1)
    with pytest.raises(RuntimeError, match="fewer calls"):
        with replay.replay(tape + tape[:1]):
            DGCNNSeg(cfg, seed=1).forward_fused(x, tb["cat_onehot"],
                                                training=True, bn_decay=DECAY)
    same = DGCNNSeg(cfg, seed=1)
    with replay.replay(tape), replay.record_blocks() as blocks:
        logits = same.forward_fused(tb["data"], tb["cat_onehot"], training=True,
                                    bn_decay=DECAY)
    masked_softmax_ce(logits, tb["seg_onehot"], tb["mask"]).backward()
    assert torch.equal(logits.detach(), l0)
    for n, p in same.named_parameters():
        assert torch.equal(p.grad, g0[n]), n
    assert [b["block"].__name__ for b in blocks] == [
        "_EdgeConvStageTrain", "_ConvBnNmaxTrain", "_EdgeConvStageTrain",
        "_EdgeConvStageTrain", "_EdgeConvStage1Train", "_ConvBnNmaxTrain"]
    for entry in blocks:
        errs = replay.block_errors(entry, "cpu")
        assert errs.keys() >= {"out", "w1" if "Edge" in entry["block"].__name__
                               else "w"} and not any(errs.values())


# ------------------------------------------------------------------ routes

def test_routes_of_bf16_training():
    """On CUDA a bf16 model with the fused kNN routes training and eval to
    the fused blocks; without the fused kNN to the plain composition (its
    gathers through B14), as f32 does with and without it. Its Full-style
    loss takes the fused smoothness loss on the card (B6, or B9 without a
    reusable graph) and reuses the transform stage's graph where the loss
    and the stage share coordinates and k covers the loss's; f32 and the
    CPU take the plain loss (the route needs no card)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def model_route(m, device):  # what DGCNNSeg.forward asks
        return layers.fused_route(m.compute_dtype, m.cfg.use_fused_knn, device)

    cfg = port_cfg(jax_cfg(True))
    model = DGCNNSeg(cfg.model)
    assert model_route(model, cuda) and not model_route(model, cpu)
    unfused = DGCNNSeg(dataclasses.replace(cfg.model, use_fused_knn=False))
    assert not model_route(unfused, cuda)
    f32 = DGCNNSeg(dataclasses.replace(cfg.model, compute_dtype="float32"))
    assert not model_route(f32, cuda)
    f32_unfused = DGCNNSeg(dataclasses.replace(f32.cfg, use_fused_knn=False))
    assert not model_route(f32_unfused, cuda)
    cfg = dataclasses.replace(cfg, weaksup=dataclasses.replace(
        cfg.weaksup, smooth_knn=cfg.model.k))
    assert fused_route(cfg, cuda) and smooth_graph_reusable(cfg, cuda)
    assert not fused_route(cfg, cpu) and not smooth_graph_reusable(cfg, cpu)
    f32_cfg = dataclasses.replace(cfg, model=f32.cfg)
    assert not fused_route(f32_cfg, cuda)
    assert not smooth_graph_reusable(f32_cfg, cuda)
    for change in (dict(smooth_knn=cfg.model.k + 1),
                   dict(smooth_channels=(0, 3))):
        other = dataclasses.replace(
            cfg, weaksup=dataclasses.replace(cfg.weaksup, **change))
        assert fused_route(other, cuda) and not smooth_graph_reusable(other, cuda)
    s3dis = pc.s3dis_config()
    s3dis = dataclasses.replace(s3dis, model=dataclasses.replace(
        s3dis.model, compute_dtype="bfloat16"))
    assert fused_route(s3dis, cuda) and not smooth_graph_reusable(s3dis, cuda)
    with pytest.raises(ValueError, match="fused-path"):
        model(torch.zeros(2, 16, 3), torch.zeros(2, NUM_CATS), training=True,
              bn_decay=DECAY, want_smooth_graph=True)


def test_train_cli_plain_bf16_on_cpu(tmp_path, monkeypatch, capsys):
    """The training CLI with -sty Plain --Precision bfloat16 --FastKNN and
    --device cpu trains two epochs (the plain composition in bf16 on the
    CPU) and writes the checkpoints the test CLI restores."""
    import glob
    import os

    from weaksuppointcloudseg_tpu.data import shapenet as jshapenet
    from weaksuppointcloudseg_tpu_torch.cli import train_shapenet as train_cli

    data = str(tmp_path / "shapenet")
    jshapenet.write_synthetic(data, num_categories=NUM_CATS, parts_per_category=3,
                              train_samples=4, val_samples=2, test_samples=2,
                              num_points=N, seed=0)
    monkeypatch.chdir(tmp_path)
    out = train_cli.main(["--DataPath", data, "-m", "0.1", "-sty", "Plain",
                          "--Precision", "bfloat16", "--FastKNN", "-bs", "2",
                          "--Epoch", "2", "--ExpRslt", "1", "--device", "cpu"])
    assert "Epoch 1 Train loss" in capsys.readouterr().out
    assert np.isfinite(out["train"]["seg"]) and set(out["train"]) >= {"seg", "acc"}
    (run,) = glob.glob(str(tmp_path / "Results/ShapeNet/DGCNN_sty-Plain_m-0.1_*"))
    assert os.path.exists(os.path.join(run, "Checkpoint", "Checkpoint_epoch-best.npz"))
