"""The port's spans (utils/profiling.py::span) and ``--profile DIR`` on
the CPU: where each span sits and how many there are, that a span changes
no number, that an untraced run pays nothing but one shared no-op
context, and the CLIs' Chrome trace."""

import argparse
import contextlib
import dataclasses
import glob
import json
import math
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from weaksuppointcloudseg_tpu.data import s3dis as js3dis
from weaksuppointcloudseg_tpu.data import shapenet as jshapenet
from weaksuppointcloudseg_tpu_torch import configs
from weaksuppointcloudseg_tpu_torch.cli import common
from weaksuppointcloudseg_tpu_torch.cli import test_s3dis as test_s3dis_cli
from weaksuppointcloudseg_tpu_torch.cli import train_shapenet as train_cli
from weaksuppointcloudseg_tpu_torch.data import s3dis, sampling, shapenet
from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
from weaksuppointcloudseg_tpu_torch.propagate import label_prop
from weaksuppointcloudseg_tpu_torch.train.loop import S3DISTrainer, ShapeNetTrainer
from weaksuppointcloudseg_tpu_torch.utils import profiling
from weaksuppointcloudseg_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

N = 64
NUM_CATS = 4
TRAIN_SAMPLES, BS = 6, 2  # three steps an epoch (drop-last)
ROOM_BS = 3


def narrow(model, **kw):
    return dataclasses.replace(
        model, num_points=N, k=8, global_channels=128,
        edge_channels=((16, 16), (16, 16), (16,)), **kw)


def shapenet_cfg():
    base = configs.shapenet_config()
    model = narrow(base.model, num_classes=NUM_CATS * 3,
                   num_categories=NUM_CATS, category_embed_channels=8,
                   head_channels=(32, 32, 16))
    return dataclasses.replace(
        base, model=model,
        train=dataclasses.replace(base.train, batch_size=BS, rampup=0),
        weaksup=dataclasses.replace(base.weaksup, smooth_knn=4, rampup=0))


def s3dis_cfg():
    """The rooms hold 64 points per 1 m block: the LP's xyz bandwidth is
    lowered to 10 for the points to have neighbours, and its CG tolerance
    raised to 3e-2 for the CG to stop before its cap of 50 steps."""
    base = configs.s3dis_config()
    return dataclasses.replace(
        base, model=narrow(base.model, head_channels=(32, 16)),
        labelprop=dataclasses.replace(base.labelprop, xyz_bandwidth=10.0,
                                      cg_tol=3e-2),
        train=dataclasses.replace(base.train, batch_size=ROOM_BS,
                                  style="Full"))


@pytest.fixture(scope="module")
def shapenet_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("trace_shapenet"))
    jshapenet.write_synthetic(base, num_categories=NUM_CATS, parts_per_category=3,
                              train_samples=TRAIN_SAMPLES, val_samples=2,
                              test_samples=2, num_points=N, seed=0)
    return base


@pytest.fixture(scope="module")
def s3dis_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("trace_s3dis"))
    js3dis.write_synthetic(base, num_rooms_per_area=2, areas=(1, 5),
                           blocks_per_room=5, num_points=N, seed=3)
    return base


def shapenet_trainer(data_dir):
    ds = shapenet.ShapeNetDataset(data_dir)
    pts = sampling.generate_sample_index(TRAIN_SAMPLES, N, 0.2, seed=0)
    return ShapeNetTrainer(shapenet_cfg(), ds, pts, seed=0, device="cpu")


def s3dis_trainer(data_dir):
    return S3DISTrainer(s3dis_cfg(), s3dis.S3DISDataset(data_dir), None,
                        test_area=5, seed=0, device="cpu")


def traced(fn):
    """fn() under a CPU profiler: (its result, the host spans of the port
    as (start, end, name), in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = ("train.", "test.", "room.", "lp.")
    spans = sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.name().startswith(names))
    return out, spans


def within(spans, outer, name):
    return [s for s in spans if s[2] == name and outer[0] <= s[0]
            and s[1] <= outer[1]]


def test_span_without_a_profiler_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    first = profiling.span("train.step")
    assert profiling.span("lp.cg_step") is first
    with first:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("train.step") is not first


def test_train_epoch_spans(shapenet_dir):
    trainer = shapenet_trainer(shapenet_dir)
    _, spans = traced(trainer.train_epoch)
    (epoch,) = [s for s in spans if s[2] == "train.epoch"]
    steps = TRAIN_SAMPLES // BS
    for name, count in (("train.assemble", steps), ("train.upload", steps),
                        ("train.step", steps), ("train.fetch", 1)):
        assert len([s for s in spans if s[2] == name]) == count, name
        assert len(within(spans, epoch, name)) == count, name
    # per step: assemble, then upload, then the step
    order = [s[2] for s in spans if s[2] != "train.epoch"]
    assert order == ["train.assemble", "train.upload", "train.step"] * steps + [
        "train.fetch"]


def test_room_test_spans(s3dis_dir, monkeypatch):
    """Per room: one test.room holding room.read, room.sweep (with one
    room.upload: the room swept on the trainer's device), ceil(K / bs)
    room.forward and one lp.room; the lp.room holds lp.features, lp.plan
    and one lp.cg with one lp.cg_step per matvec the CG ran."""
    matvecs = []
    cg = label_prop._cg

    def counting_cg(matvec, rhs, maxiter, tol, M=None):
        count = [0]

        def counted(v):
            count[0] += 1
            return matvec(v)
        out = cg(counted, rhs, maxiter, tol, M)
        matvecs.append(count[0])
        return out
    monkeypatch.setattr(label_prop, "_cg", counting_cg)
    rooms = s3dis.S3DISTestRooms(s3dis_dir, "area5", num_point=N)
    ks = [len(rooms.load_room(r)[0]) for r in range(len(rooms))]
    trainer = s3dis_trainer(s3dis_dir)
    _, spans = traced(lambda: trainer.test(rooms, room_lp=True))
    room_spans = [s for s in spans if s[2] == "test.room"]
    assert len(room_spans) == len(rooms) == len(matvecs) == 2
    assert all(0 < m < trainer.cfg.labelprop.cg_iters for m in matvecs)
    for room, k, m in zip(room_spans, ks, matvecs):
        for name, count in (("room.read", 1), ("room.sweep", 1),
                            ("room.upload", 1),
                            ("room.forward", math.ceil(k / ROOM_BS)),
                            ("lp.room", 1)):
            assert len(within(spans, room, name)) == count, name
        (lp,) = within(spans, room, "lp.room")
        for name in ("lp.features", "lp.plan", "lp.cg"):
            assert len(within(spans, lp, name)) == 1, name
        (solve,) = within(spans, lp, "lp.cg")
        assert len(within(spans, solve, "lp.cg_step")) == m
    assert len([s for s in spans if s[2] == "lp.cg_step"]) == sum(matvecs)


def test_spans_change_no_number(shapenet_dir, s3dis_dir):
    """Two epochs' losses and weights, and the room labels of the room LP,
    are bitwise equal with and without a profiler."""
    runs = []
    for on in (False, True):
        trainer = shapenet_trainer(shapenet_dir)
        epochs = lambda: [trainer.train_epoch() for _ in range(2)]  # noqa: E731
        metrics = traced(epochs)[0] if on else epochs()
        runs.append((metrics, [p.detach().clone()
                               for p in trainer.model.parameters()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)

    labels = []
    for on in (False, True):
        trainer = s3dis_trainer(s3dis_dir)
        rooms = s3dis.S3DISTestRooms(s3dis_dir, "area5", num_point=N)
        seen = []
        lp = trainer.room_label_prop
        trainer.room_label_prop = lambda *a: seen.append(lp(*a)) or seen[-1]
        test = lambda: trainer.test(rooms, room_lp=True)  # noqa: E731
        res = traced(test)[0] if on else test()
        labels.append((seen, res))
    (a, ra), (b, rb) = labels
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert ra["miou"] == rb["miou"]


@pytest.mark.parametrize("epochs,traced_epoch", [(3, 1), (1, 0)])
def test_profile_epoch_context_picks_the_epoch_after_the_first(epochs,
                                                               traced_epoch):
    args = argparse.Namespace(profile="unused")
    picked = [e for e in range(epochs) if not isinstance(
        common.profile_epoch_context(args, e, 0, epochs - 1),
        contextlib.nullcontext)]
    assert picked == [traced_epoch]
    assert isinstance(common.profile_context(argparse.Namespace(profile=None)),
                      contextlib.nullcontext)


def trace_names(log_dir):
    (path,) = glob.glob(os.path.join(log_dir, "*.json"))
    with open(path) as f:
        return {ev.get("name") for ev in json.load(f)["traceEvents"]}


def test_train_cli_profile_writes_one_trace(shapenet_dir, tmp_path, monkeypatch):
    """--profile DIR on the training CLI: one Chrome trace of one epoch,
    naming the training spans; --debug_nans is still refused."""
    monkeypatch.chdir(tmp_path)
    log_dir = str(tmp_path / "prof")
    train_cli.main(["--DataPath", shapenet_dir, "-m", "0.1", "-sty", "Full",
                    "-bs", "2", "--Epoch", "2", "--Rampup", "1",
                    "--device", "cpu", "--profile", log_dir])
    names = trace_names(log_dir)
    assert {"train.epoch", "train.assemble", "train.upload", "train.step",
            "train.fetch"} <= names
    with pytest.raises(SystemExit):
        train_cli.main(["--DataPath", shapenet_dir, "--device", "cpu",
                        "--debug_nans"])


def test_test_cli_profile_writes_one_trace(s3dis_dir, tmp_path, monkeypatch):
    """--profile DIR on the S3DIS test CLI with --RoomLP: one Chrome trace
    of the whole test, naming the room and LP spans."""
    preset = configs.s3dis_config

    def small():
        cfg = preset()
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, num_points=N))
    monkeypatch.setattr(configs, "s3dis_config", small)
    ckpt_dir = tmp_path / "run" / "Checkpoint"
    ckpt_dir.mkdir(parents=True)
    ckpt = save_checkpoint(str(ckpt_dir / "best"), DGCNNSeg(small().model, seed=5))
    log_dir = str(tmp_path / "prof")
    test_s3dis_cli.main(["--DataPath", s3dis_dir, "--Checkpoint", ckpt,
                         "-sty", "Full", "--batchsize", "4", "--device", "cpu",
                         "--RoomLP", "--profile", log_dir])
    names = trace_names(log_dir)
    assert {"test.room", "room.read", "room.sweep", "room.forward", "lp.room",
            "lp.features", "lp.plan", "lp.cg", "lp.cg_step"} <= names
