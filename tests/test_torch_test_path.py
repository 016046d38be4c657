"""The ShapeNet test path end to end on the CPU: the port's trainer and CLI
against the JAX package's, on a synthetic dataset, with a checkpoint
written by the JAX package."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from weaksuppointcloudseg_tpu import configs
from weaksuppointcloudseg_tpu.data import shapenet
from weaksuppointcloudseg_tpu.train.loop import ShapeNetTrainer as JaxTrainer
from weaksuppointcloudseg_tpu.utils.checkpoint import save_checkpoint as jax_save
from weaksuppointcloudseg_tpu_torch import configs as port_configs
from weaksuppointcloudseg_tpu_torch.cli import test_shapenet as cli
from weaksuppointcloudseg_tpu_torch.data.shapenet import ShapeNetTestSet
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.train.loop import ShapeNetTrainer
from weaksuppointcloudseg_tpu_torch.utils import checkpoint

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("shapenet"))
    shapenet.write_synthetic(base, num_categories=4, parts_per_category=3,
                             train_samples=4, val_samples=2, test_samples=5,
                             num_points=128, seed=0)
    return base


def tiny_cfg(ds):
    cfg = configs.shapenet_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, k=8, edge_channels=((16, 16), (16, 16), (16,)),
        global_channels=64, category_embed_channels=8,
        head_channels=(32, 32, 16), num_classes=ds.meta.num_part_cats,
        num_categories=ds.meta.num_categories))


@pytest.fixture(scope="module")
def jax_checkpoint(dataset, tmp_path_factory):
    """A JAX trainer's state with non-trivial BN stats, saved in format v2."""
    ds = shapenet.ShapeNetDataset(dataset)
    cfg = tiny_cfg(ds)
    trainer = JaxTrainer(cfg, ds, None, seed=0)
    rng = np.random.default_rng(0)
    bn = jax.tree.map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.3, np.shape(a)).astype(
            np.float32), trainer.state.bn_state)
    trainer.state = trainer.state.replace(bn_state=bn)
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    jax_save(path, trainer._ckpt_tree())
    return cfg, trainer, path


def test_test_metrics_match_jax(dataset, jax_checkpoint):
    """Same views (same seed), same weights, f32, with label propagation:
    per-data mIoU, per-shape mIoU and accuracy within 1e-3. Each package
    reads the test set with its own reader."""
    cfg, jax_trainer, path = jax_checkpoint
    kw = dict(use_label_prop=True, num_points=100, batch_size=2)
    want = jax_trainer.test(shapenet.ShapeNetTestSet(dataset), **kw)
    testset = ShapeNetTestSet(dataset)
    port = ShapeNetTrainer(cfg, testset, seed=0, device="cpu")
    port.restore_checkpoint(path)
    got = port.test(testset, **kw)
    for key in ("perdata_miou", "pershape_miou", "accuracy"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    np.testing.assert_allclose(got["per_category_iou"],
                               want["per_category_iou"], atol=1e-3)


def test_checkpoint_rejects_renamed_leaf(jax_checkpoint, tmp_path):
    cfg, _, path = jax_checkpoint
    model = DGCNNSeg(cfg.model)
    assert checkpoint.load_jax_checkpoint(path, model) == 0
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    paths = [str(p) for p in arrays["__keypaths__"]]
    for old, new, msg in (
            ("['params']['agg_conv']['w']", "['params']['agg_conv']['wx']",
             "unexpected leaf"),
            ("['params']['agg_conv']['w']", "['params']['agg_conv9']['w']",
             "missing"),
            ("['bn_state']['seg_conv1']['var']",
             "['bn_state']['seg_conv1']['variance']", "unexpected leaf")):
        bad = dict(arrays)
        bad["__keypaths__"] = np.asarray([new if p == old else p for p in paths])
        bad_path = str(tmp_path / "bad.npz")
        np.savez(bad_path, **bad)
        with pytest.raises(ValueError, match=msg):
            checkpoint.load_jax_checkpoint(bad_path, DGCNNSeg(cfg.model))


def test_save_checkpoint_round_trips(jax_checkpoint, tmp_path):
    cfg, _, path = jax_checkpoint
    model = DGCNNSeg(cfg.model)
    checkpoint.load_jax_checkpoint(path, model)
    out = checkpoint.save_checkpoint(str(tmp_path / "port"), model, epoch=7)
    again = DGCNNSeg(cfg.model, seed=1)
    assert checkpoint.load_jax_checkpoint(out, again) == 7
    for k, v in model.state_dict().items():
        torch.testing.assert_close(again.state_dict()[k], v, rtol=0, atol=0)
    # the key paths are the JAX pytree's, in its flatten order
    with np.load(path) as a, np.load(out) as b:
        jax_paths = [p for p in a["__keypaths__"]
                     if p.startswith(("['params']", "['bn_state']"))]
        port_paths = [p for p in b["__keypaths__"]
                      if p.startswith(("['params']", "['bn_state']"))]
    assert port_paths == jax_paths


def test_cli_runs_full_width_on_cpu(dataset, tmp_path, capsys):
    """The port's CLI with the JAX CLI's flags, on a full-width ShapeNet
    model saved by save_checkpoint: the same metric lines as the JAX
    CLI, and the same numbers as the trainer called directly."""
    testset = ShapeNetTestSet(dataset)
    cfg = port_configs.shapenet_config()
    model_cfg = dataclasses.replace(cfg.model,
                                    num_classes=testset.meta.num_part_cats,
                                    num_categories=testset.meta.num_categories)
    ckpt = checkpoint.save_checkpoint(str(tmp_path / "full"),
                                      DGCNNSeg(model_cfg, seed=3))
    res = cli.main(["--DataPath", dataset, "--Checkpoint", ckpt,
                    "--batchsize", "2", "--num_points", "100",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("Test perdata mIoU ")
    assert "pershape mIoU" in out and "acc" in out
    assert np.isfinite(res["perdata_miou"]) and 0 <= res["accuracy"] <= 1
    trainer = ShapeNetTrainer(dataclasses.replace(
        cfg, model=model_cfg, train=dataclasses.replace(cfg.train,
                                                        batch_size=2)),
        testset, device="cpu")
    trainer.restore_checkpoint(ckpt)
    direct = trainer.test(testset, num_points=100)
    assert direct["perdata_miou"] == res["perdata_miou"]
