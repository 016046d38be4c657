"""S3DIS training in the port against the JAX package on the CPU: the
preset and CLI flags, the data copies (dataset, area split, batches,
weak_class_onehot, the one-point-per-class labels, s3dis_augment,
ConfusionAccumulator), params_from_jax on the S3DIS model, one f32
Full-style step on the plain composition, one bf16 Full-style step on the
fused branches (the smoothness loss over kernel B9, backward B6), and the
training CLI.

Tolerances: the data copies are bitwise; the f32 step those of
tests/test_torch_train.py (components rtol 1e-4, each gradient leaf 2e-4 of
its largest entry plus 1e-5 of the largest overall, new BN state rtol
1e-4); the bf16 step those of tests/test_torch_fused_step.py
(tests/test_torch_smooth_fused.py::assert_step_close).
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_blocks import DECAY, np32, to_jax
from test_torch_smooth_fused import (  # noqa: F401 (fixtures)
    assert_step_close,
    fused_full_jax,
    fused_jax,
    fused_loss_jax,
    run_full_step,
)
from test_torch_train import jax_weights, port_cfg
from weaksuppointcloudseg_tpu import configs as jc
from weaksuppointcloudseg_tpu.cli import common as jax_common
from weaksuppointcloudseg_tpu.data import augment as jaugment
from weaksuppointcloudseg_tpu.data import s3dis as js3dis
from weaksuppointcloudseg_tpu.data import sampling as jsampling
from weaksuppointcloudseg_tpu.metrics import iou as jiou
from weaksuppointcloudseg_tpu.models.dgcnn import init_dgcnn_seg
from weaksuppointcloudseg_tpu.train.steps import _loss_fn
from weaksuppointcloudseg_tpu_torch import configs
from weaksuppointcloudseg_tpu_torch.cli import common
from weaksuppointcloudseg_tpu_torch.cli import train_s3dis
from weaksuppointcloudseg_tpu_torch.data import augment, s3dis, sampling
from weaksuppointcloudseg_tpu_torch.losses import weaksup
from weaksuppointcloudseg_tpu_torch.metrics import iou
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.train.loop import S3DISTrainer
from weaksuppointcloudseg_tpu_torch.utils.checkpoint import params_from_jax

torch.set_num_threads(1)

N = 64


# ------------------------------------------------------- preset and flags

def _shared_fields(port_obj, jax_obj):
    names = [f.name for f in dataclasses.fields(port_obj)]
    return ({n: getattr(port_obj, n) for n in names},
            {n: getattr(jax_obj, n) for n in names})


@pytest.mark.parametrize("part", ["model", "labelprop", "train", "schedule",
                                  "weaksup"])
def test_s3dis_preset_matches_reference(part):
    got, want = _shared_fields(getattr(configs.s3dis_config(), part),
                               getattr(jc.s3dis_config(), part))
    assert got == want
    assert configs.s3dis_config().dataset == "S3DIS"


def test_train_s3dis_flags_match_reference():
    """The reference S3DIS training CLI's flags, plus the port's --device."""
    want = jax_common.base_parser("S3DIS", train=True)
    want.add_argument("--test_area", "-ta")
    want.add_argument("--device")
    got = train_s3dis.parser()
    assert ({s for a in got._actions for s in a.option_strings}
            == {s for a in want._actions for s in a.option_strings})
    assert got.parse_args([]).batchsize == 3


@pytest.mark.parametrize("argv", [
    [],
    ["-m", "0", "-sty", "Full", "-bs", "14", "--Precision", "bfloat16",
     "--FastKNN", "-ta", "3", "-rp", "0"],
])
def test_train_s3dis_config_matches_reference(argv):
    args = train_s3dis.parser().parse_args(argv)
    jparser = jax_common.base_parser("S3DIS", train=True)
    jparser.add_argument("--test_area", "-ta", type=int, default=5)
    got_cfg = common.build_config(args, "S3DIS")
    want_cfg = jax_common.build_config(jparser.parse_args(argv), "S3DIS")
    assert got_cfg.dataset == want_cfg.dataset == "S3DIS"
    for part in ("model", "labelprop", "train", "schedule", "weaksup"):
        got, want = _shared_fields(getattr(got_cfg, part), getattr(want_cfg, part))
        assert got == want, part


# ------------------------------------------------------------------ data

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("s3dis"))
    js3dis.write_synthetic(base, num_rooms_per_area=2, areas=(1, 3, 5),
                           blocks_per_room=3, num_points=N, seed=2)
    return base


def test_dataset_split_and_batches_match_reference(dataset):
    got, want = s3dis.S3DISDataset(dataset), js3dis.S3DISDataset(dataset)
    assert got.all_files == want.all_files
    assert got.room_filelist == want.room_filelist
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.label, want.label)
    assert got.data.dtype == np.float32 and got.label.dtype == np.int32
    for area in (1, 3, 5):
        for a, b in zip(got.split_indices(area), want.split_indices(area)):
            np.testing.assert_array_equal(a, b)
    train_idx, _ = got.split_indices(5)
    for kw in (dict(shuffle=True, drop_last=True), dict(shuffle=False)):
        gb = list(got.batches(train_idx, 5, rng=np.random.default_rng(3), **kw))
        wb = list(want.batches(train_idx, 5, rng=np.random.default_rng(3), **kw))
        assert len(gb) == len(wb) > 0
        for a, b in zip(gb, wb):
            for field in ("data", "seg", "sample_ids"):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
            assert a.valid == b.valid


def test_weak_class_onehot_matches_reference():
    seg = np.random.default_rng(0).integers(0, 13, (5, 200))
    seg[2] = 4  # a block of one class
    np.testing.assert_array_equal(s3dis.weak_class_onehot(seg),
                                  js3dis.weak_class_onehot(seg))


def test_one_point_per_class_matches_reference(dataset, tmp_path):
    labels = js3dis.S3DISDataset(dataset).label
    got = sampling.load_or_generate(str(tmp_path), 0, num_samples=len(labels),
                                    num_points=N, seg_labels=labels, seed=4)
    want = jsampling.load_or_generate(str(tmp_path), 0, num_samples=len(labels),
                                      num_points=N, seg_labels=labels, seed=4)
    assert len(got) == len(want) == len(labels)
    for a, b, seg in zip(got, want, labels):
        np.testing.assert_array_equal(a, b)
        # one point of each class present
        np.testing.assert_array_equal(np.sort(seg[a]), np.unique(seg))
    mask = sampling.indices_to_mask(got, [0, 3], N)
    np.testing.assert_array_equal(mask, jsampling.indices_to_mask(want, [0, 3], N))
    with pytest.raises(ValueError, match="seg labels"):
        sampling.load_or_generate(str(tmp_path), 0, num_samples=2, num_points=N)


def test_s3dis_augment_matches_reference():
    """All 8 dihedral choices are drawn, each the reference's."""
    block = np.random.default_rng(1).random((N, 9)).astype(np.float32)
    rg, rw = np.random.default_rng(5), np.random.default_rng(5)
    seen = set()
    for _ in range(40):
        a = augment.s3dis_augment(block, rg)
        np.testing.assert_array_equal(a, jaugment.s3dis_augment(block, rw))
        seen.add(a.tobytes())
    assert len(seen) == 8
    data = np.random.default_rng(2).random((3, N, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        augment.make_siamese_batch(data, np.random.default_rng(6),
                                   augment.s3dis_augment),
        jaugment.make_siamese_batch(data, np.random.default_rng(6),
                                    jaugment.s3dis_augment))


def test_confusion_accumulator_matches_reference():
    rng = np.random.default_rng(7)
    got, want = iou.ConfusionAccumulator(13), jiou.ConfusionAccumulator(13)
    for _ in range(3):
        pred, gt = rng.integers(0, 13, (4, 50)), rng.integers(0, 12, (4, 50))
        got.update(pred, gt)
        want.update(pred, gt)
    np.testing.assert_array_equal(got.iou, want.iou)  # class 12: no ground truth
    assert got.miou == want.miou and got.accuracy == want.accuracy


# ------------------------------------------------------------- the model

def narrow_jax_cfg(precision="float32", fast=False):
    """The S3DIS preset at narrow width, k=6, smoothness k=4, dropout off
    (the two packages' random streams cannot be matched)."""
    base = jc.s3dis_config()
    model = dataclasses.replace(
        base.model, num_points=N, k=6, global_channels=128,
        edge_channels=((16, 16), (16, 16), (16,)), head_channels=(32, 16),
        head_keep_prob=(None, None), compute_dtype=precision,
        knn_fast=fast)
    return dataclasses.replace(
        base, model=model,
        weaksup=dataclasses.replace(base.weaksup, smooth_knn=4),
        train=dataclasses.replace(base.train, batch_size=2, style="Full"))


def s3dis_batch(seed, b=4):
    """b blocks (b/2 interleaved pairs) of S3DIS-like channels: xyz with the
    block xy-centred, rgb in [0, 1], xyz normalized to [0, 1]."""
    rng = np.random.default_rng(seed)
    x = rng.random((b, N, 9)).astype(np.float32)
    x[..., :2] -= 0.5
    x[..., 2] *= 3.0
    seg = rng.integers(0, 13, (b, N))
    return {"data": x, "seg": seg.astype(np.int32),
            "seg_onehot": np.eye(13, dtype=np.float32)[seg],
            "mask": (rng.random((b, N)) < 0.3).astype(np.float32),
            "valid": np.ones(b, np.float32)}


def test_params_from_jax_maps_the_s3dis_model():
    """No transform net, no category branch, a two-conv head: the JAX
    pytree maps onto the port's module leaf for leaf."""
    cfg = narrow_jax_cfg()
    params, state = init_dgcnn_seg(jax.random.PRNGKey(0), cfg.model)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    assert "transform_net" not in params and "cat_embed" not in params
    assert {"seg_conv1", "seg_conv2", "seg_out"} <= set(params)
    assert "seg_conv3" not in params
    sd = params_from_jax(params, state)
    model = DGCNNSeg(port_cfg(cfg).model)
    model.load_state_dict(sd, strict=True)
    assert model.adj_conv1.w.shape == (18, 16)  # 2 x 9 input channels
    assert model.seg_conv1.w.shape == (128 + 48, 32)
    np.testing.assert_array_equal(model.seg_conv2.w.detach().numpy(),
                                  params["seg_conv2"]["w"])


def test_full_f32_s3dis_step_matches_jax():
    """One f32 Full-style step of the plain composition (the CPU route):
    kNN on channels 6:9, smoothness on 0:6, Siamese weight 10, and the
    head convs' BN stats at the fixed decay 0.9 while the stages take the
    scheduled one."""
    cfg = narrow_jax_cfg()
    params, state = jax_weights(cfg)
    batch = s3dis_batch(8)
    bn_decay = 0.6
    grad_fn = jax.jit(jax.value_and_grad(_loss_fn, has_aux=True),
                      static_argnames=("cfg", "style"))
    (_, (want_c, want_s, _)), want_g = grad_fn(
        to_jax(params), to_jax(state), to_jax(batch), cfg=cfg, style="Full",
        bn_decay=jnp.float32(bn_decay), gate=jnp.float32(1.0),
        rng=jax.random.PRNGKey(0))
    want_g = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, want_g), {}).items()}
    want_s = params_from_jax({}, jax.tree.map(np.asarray, want_s))

    pcfg = port_cfg(cfg)
    model = DGCNNSeg(pcfg.model)
    model.load_state_dict(params_from_jax(params, state), strict=True)
    from weaksuppointcloudseg_tpu_torch.train.steps import loss_fn

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, got_c, _ = loss_fn(model, tb, cfg=pcfg, style="Full",
                              bn_decay=bn_decay, gate=1.0)
    total.backward()
    for k in want_c:
        np.testing.assert_allclose(float(got_c[k].detach()), float(want_c[k]),
                                   rtol=1e-4, err_msg=k)
    scale = max(np.abs(v).max() for v in want_g.values())
    for name, p in model.named_parameters():
        w = want_g[name]
        err = np.abs(np32(p.grad) - w).max()
        assert err <= 2e-4 * np.abs(w).max() + 1e-5 * scale, (name, err)
    sd = model.state_dict()
    for name, v in want_s.items():
        np.testing.assert_allclose(sd[name].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # the head's population stats moved at 0.9, the stages' at bn_decay
    fresh = DGCNNSeg(pcfg.model)
    fresh.load_state_dict(params_from_jax(params, state), strict=True)
    for name, decay in (("seg_conv1", 0.9), ("seg_conv2", 0.9),
                        ("adj_conv1", bn_decay), ("agg_conv", bn_decay)):
        old = getattr(fresh, name).mean.numpy()
        new = sd[f"{name}.mean"].numpy()
        batch_mean = (new - decay * old) / (1 - decay)
        other = 0.9 if decay != 0.9 else bn_decay
        assert not np.allclose(new, other * old + (1 - other) * batch_mean,
                               rtol=1e-3, atol=1e-5), name


@pytest.mark.parametrize("fast", [False, True])
def test_full_bf16_s3dis_step_matches_jax(fused_full_jax, fast):
    """One bf16 Full-style S3DIS step through forward_fused (B1-B5; the
    first stage's kNN on channels 6:9, its features all 9) and the fused
    smoothness loss over kernel B9 on xyzrgb 0:6 (backward B6), against
    _loss_fn on the fake-TPU fused branches."""
    cfg = narrow_jax_cfg("bfloat16", fast)
    got, want, graph = run_full_step(cfg, s3dis_batch(9), False)
    assert graph is None
    assert fused_full_jax["stage"] == 2  # two two-conv EdgeConv stages
    assert_step_close(got, want)


# ------------------------------------------------------------------- CLI

@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_train_s3dis_cli_on_cpu(dataset, tmp_path, monkeypatch, capsys,
                                precision):
    """cli.train_s3dis --device cpu trains two epochs (gate on from epoch
    0, one labelled point per class), evaluates on Area 5 and writes the
    checkpoints; in bf16 the CPU takes the plain composition."""
    monkeypatch.chdir(tmp_path)
    out = train_s3dis.main([
        "--DataPath", dataset, "-m", "0", "-sty", "Full", "-bs", "2",
        "--Epoch", "2", "--Rampup", "0", "--Precision", precision,
        "--FastKNN", "-ta", "5", "--ExpRslt", "1", "--device", "cpu"])
    log = capsys.readouterr().out
    assert "Epoch 1 Train loss" in log and "Epoch 0 Eval loss" in log
    for key in ("seg", "siamese", "inexact", "smooth", "total", "acc"):
        assert np.isfinite(out["train"][key]), key
    assert 0.0 <= out["eval"]["miou"] <= 1.0
    (run,) = glob.glob(str(tmp_path / "Results/S3DIS/DGCNN_sty-Full_m-0.0_*"))
    assert os.path.exists(os.path.join(run, "Checkpoint",
                                       "Checkpoint_epoch-best.npz"))


def test_s3dis_trainer_assembles_pairs(dataset):
    """The trainer's host batch: interleaved (original, augmented) pairs
    after the rampup, the labelled-point mask duplicated, no category
    fields."""
    cfg = port_cfg(narrow_jax_cfg())
    ds = s3dis.S3DISDataset(dataset)
    pts = sampling.load_or_generate("/nonexistent", 0, num_samples=len(ds.label),
                                    num_points=N, seg_labels=ds.label)
    trainer = S3DISTrainer(cfg, ds, pts, test_area=5, device="cpu")
    b = next(ds.batches(trainer.train_idx, 2))
    batch = trainer._assemble(b, siamese=True, augment_pairs=True,
                              full_mask=False)
    assert set(batch) == {"data", "seg", "seg_onehot", "mask", "valid"}
    np.testing.assert_array_equal(batch["data"][0::2], b.data)
    np.testing.assert_array_equal(batch["mask"][0::2], batch["mask"][1::2])
    assert batch["mask"].sum() == sum(len(pts[i]) for i in b.sample_ids) * 2
    # the augmentation moves x/y and their normalized copies only
    np.testing.assert_array_equal(batch["data"][1::2, :, 2:6], b.data[:, :, 2:6])
    np.testing.assert_array_equal(batch["data"][1::2, :, 8], b.data[:, :, 8])
