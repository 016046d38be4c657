"""The port's own configs, CLI flags, ShapeNet test-set reader and IoU
metrics against the JAX package's originals (the port copies them so that
it imports nothing of the JAX package)."""

import dataclasses

import numpy as np
import pytest
import torch

from weaksuppointcloudseg_tpu import configs as jax_configs
from weaksuppointcloudseg_tpu.cli import common as jax_common
from weaksuppointcloudseg_tpu.data import shapenet as jax_shapenet
from weaksuppointcloudseg_tpu.metrics import iou as jax_iou
from weaksuppointcloudseg_tpu_torch import configs
from weaksuppointcloudseg_tpu_torch.cli import test_shapenet as cli
from weaksuppointcloudseg_tpu_torch.data import shapenet
from weaksuppointcloudseg_tpu_torch.metrics import iou

torch.set_num_threads(1)


def _shared_fields(port_obj, jax_obj):
    """The port dataclass's fields with the reference's values for them."""
    names = [f.name for f in dataclasses.fields(port_obj)]
    return ({n: getattr(port_obj, n) for n in names},
            {n: getattr(jax_obj, n) for n in names})


@pytest.mark.parametrize("part", ["model", "labelprop", "train", "schedule",
                                  "weaksup"])
def test_shapenet_preset_matches_reference(part):
    got, want = _shared_fields(getattr(configs.shapenet_config(), part),
                               getattr(jax_configs.shapenet_config(), part))
    assert got == want


def _option_strings(p):
    return {s for a in p._actions for s in a.option_strings}


def test_cli_flags_match_reference():
    """The reference's flags, plus the port's --device."""
    want = jax_common.base_parser("ShapeNet", train=False)
    want.add_argument("--num_points", type=int, default=3000)
    want.add_argument("--device")
    assert _option_strings(cli.parser()) == _option_strings(want)


@pytest.mark.parametrize("argv", [
    [],
    ["--Precision", "bfloat16", "--FastKNN", "--batchsize", "32"],
    ["--Style", "Plain", "--LPSolver", "solve", "--seed", "3", "--m", "0.01"],
])
def test_cli_config_matches_reference(argv):
    args = cli.parser().parse_args(argv)
    jargs = jax_common.base_parser("ShapeNet", train=False).parse_args(argv)
    got_cfg = cli.build_config(args)
    want_cfg = jax_common.build_config(jargs, "ShapeNet")
    for part in ("model", "labelprop", "train", "schedule", "weaksup"):
        got, want = _shared_fields(getattr(got_cfg, part), getattr(want_cfg, part))
        assert got == want, part


def test_train_cli_flags_match_reference():
    """The reference training CLI's flags, plus the port's --device."""
    from weaksuppointcloudseg_tpu_torch.cli import train_shapenet

    want = jax_common.base_parser("ShapeNet", train=True)
    want.add_argument("--device")
    assert _option_strings(train_shapenet.parser()) == _option_strings(want)


@pytest.mark.parametrize("argv", [
    [],
    ["-m", "0.01", "-sty", "Plain", "-bs", "32", "-ep", "7", "-rp", "3",
     "--LearningRate", "0.01", "--CompatFrozenGate", "--FastKNN", "--seed", "2"],
])
def test_train_cli_config_matches_reference(argv):
    from weaksuppointcloudseg_tpu_torch.cli import common, train_shapenet

    args = train_shapenet.parser().parse_args(argv)
    jargs = jax_common.base_parser("ShapeNet", train=True).parse_args(argv)
    got_cfg = common.build_config(args)
    want_cfg = jax_common.build_config(jargs, "ShapeNet")
    assert got_cfg.dataset == want_cfg.dataset
    for part in ("model", "labelprop", "train", "schedule", "weaksup"):
        got, want = _shared_fields(getattr(got_cfg, part), getattr(want_cfg, part))
        assert got == want, part


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("shapenet"))
    jax_shapenet.write_synthetic(base, num_categories=3, parts_per_category=2,
                                 train_samples=2, val_samples=1,
                                 test_samples=4, num_points=64, seed=1)
    return base


def test_test_set_matches_reference(dataset):
    got, want = shapenet.ShapeNetTestSet(dataset), jax_shapenet.ShapeNetTestSet(dataset)
    assert len(got) == len(want) == 4
    for field in ("objnames", "objcats", "on2oid", "cpid2oid", "object2setofoid",
                  "num_categories", "num_part_cats"):
        assert getattr(got.meta, field) == getattr(want.meta, field), field
    for i in range(len(got)):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
        assert got.meta.iou_oids(i % 3) == want.meta.iou_oids(i % 3)


@pytest.mark.parametrize("n,target", [(100, 100), (70, 100), (250, 100), (301, 100)])
def test_cover_partition_matches_reference(n, target):
    got = shapenet.cover_partition(n, target, np.random.default_rng(5))
    want = jax_shapenet.cover_partition(n, target, np.random.default_rng(5))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_iou_metrics_match_reference():
    rng = np.random.default_rng(0)
    prob = rng.random((200, 8)).astype(np.float32)
    seg = rng.integers(2, 5, 200)
    oids = [2, 3, 4, 7]  # part 7 is absent from both: empty union counts 1
    pred = iou.category_biased_argmax(prob, oids)
    np.testing.assert_array_equal(pred, jax_iou.category_biased_argmax(prob, oids))
    assert iou.eval_iou(pred, seg, oids) == jax_iou.eval_iou(pred, seg, oids)
