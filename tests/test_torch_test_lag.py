"""The ShapeNet test loop's one-batch lag (train/loop.py::ShapeNetTrainer.
test): the same results as the synchronous loop it replaces, bit for bit,
and as the JAX package's test with the "cg" and "solve" LP solvers; batch
i is drained after batch i+1's forward and before its LP. On the tiny
dataset of tests/test_torch_test_path.py (5 shapes of 128 points, views of
100 points, batches of 2)."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_test_path import dataset, jax_checkpoint  # noqa: F401 (fixtures)
from weaksuppointcloudseg_tpu.data import shapenet
from weaksuppointcloudseg_tpu_torch.data.shapenet import (
    ShapeNetTestSet,
    cover_partition,
)
from weaksuppointcloudseg_tpu_torch.metrics.iou import (
    category_biased_argmax,
    eval_iou,
)
from weaksuppointcloudseg_tpu_torch.propagate.label_prop import propagate_batch
from weaksuppointcloudseg_tpu_torch.train import loop
from weaksuppointcloudseg_tpu_torch.train.loop import ShapeNetTrainer
from weaksuppointcloudseg_tpu_torch.train.steps import make_eval_logits_fn
from weaksuppointcloudseg_tpu_torch.utils.tools import onehot_encode

torch.set_num_threads(1)

KW = dict(use_label_prop=True, num_points=100, batch_size=2)


def port_trainer(cfg, testset, path, solver="cg"):
    cfg = dataclasses.replace(cfg, labelprop=dataclasses.replace(
        cfg.labelprop, solver=solver))
    trainer = ShapeNetTrainer(cfg, testset, seed=0, device="cpu")
    trainer.restore_checkpoint(path)
    return trainer


def synchronous_test(trainer, testset, *, use_label_prop, num_points,
                     batch_size):
    """The loop without the lag: every batch's probabilities are scattered
    back (and finished shapes scored) before the next batch is formed.
    Returns the per-shape IoUs in the order the shapes finish, and the
    per-shape accuracies."""
    lp = trainer.cfg.labelprop
    logits_fn = make_eval_logits_fn(trainer.model)
    shapes, queue, ious, accs = {}, [], [], []

    def run(views):
        xs = [shapes[s]["pts"][sel] for s, sel in views]
        cats = [shapes[s]["cat"] for s, _ in views]
        xs += [xs[0]] * (batch_size - len(xs))
        cats += [cats[0]] * (batch_size - len(cats))
        x = torch.from_numpy(np.stack(xs).astype(np.float32))
        with torch.inference_mode():
            prob = torch.softmax(logits_fn(x, torch.from_numpy(onehot_encode(
                np.asarray(cats), trainer.num_categories))), -1)
            if use_label_prop:
                prob = propagate_batch(
                    x, prob, alpha=lp.alpha, beta=lp.beta,
                    xyz_bandwidth=lp.xyz_bandwidth,
                    rgb_bandwidth=lp.rgb_bandwidth, ridge=lp.ridge,
                    solver=lp.solver, cg_iters=lp.cg_iters, cg_tol=lp.cg_tol)
        for (sid, sel), p in zip(views, prob.numpy()):
            e = shapes[sid]
            uniq, first = np.unique(sel, return_index=True)
            fresh = first[~e["written"][uniq]]
            e["prob"][sel[fresh]] = p[fresh]
            e["written"][sel[fresh]] = True
            e["left"] -= 1
            if e["left"] == 0:
                del shapes[sid]
                oids = trainer.meta.iou_oids(e["cat"])
                pred = category_biased_argmax(e["prob"], oids)
                ious.append(eval_iou(pred, e["seg"], oids))
                accs.append(float(np.mean(pred == e["seg"])))

    for i in range(len(testset)):
        pts, seg, cat = testset[i]
        sels = cover_partition(len(pts), num_points, trainer.np_rng)
        shapes[i] = {"pts": pts, "seg": seg, "cat": cat, "left": len(sels),
                     "prob": np.zeros((len(pts), trainer.num_classes),
                                      np.float32),
                     "written": np.zeros(len(pts), bool)}
        queue += [(i, sel) for sel in sels]
        while len(queue) >= batch_size:
            run(queue[:batch_size])
            del queue[:batch_size]
    if queue:
        run(queue)
    return ious, accs


@pytest.mark.parametrize("solver", ["cg", "solve"])
def test_lagged_test_equals_synchronous_loop(dataset, jax_checkpoint,
                                            monkeypatch, solver):
    """The same per-shape IoUs in the same order and the same accuracy,
    bit for bit: the lag moves no arithmetic."""
    cfg, _, path = jax_checkpoint
    testset = ShapeNetTestSet(dataset)
    ious, accs = synchronous_test(port_trainer(cfg, testset, path, solver),
                                  testset, **KW)
    got_ious = []
    real = loop.eval_iou

    def recorded(*a):
        got_ious.append(real(*a))
        return got_ious[-1]

    monkeypatch.setattr(loop, "eval_iou", recorded)
    res = port_trainer(cfg, testset, path, solver).test(testset, **KW)
    assert got_ious == ious and len(ious) == len(testset)
    assert res["perdata_miou"] == float(np.mean(ious))
    assert res["accuracy"] == float(np.mean(accs))


@pytest.mark.parametrize("solver", ["cg", "solve"])
def test_lagged_test_matches_jax(dataset, jax_checkpoint, solver):
    """Against the JAX package's test (its own one-batch lag) with the
    same views, weights and LP solver, f32: per-data mIoU, per-shape mIoU
    and accuracy within 1e-3, as tests/test_torch_test_path.py holds the
    "cg" run."""
    cfg, jax_trainer, path = jax_checkpoint
    jax_trainer = copy.copy(jax_trainer)  # same weights, its own views
    jax_trainer.cfg = dataclasses.replace(
        jax_trainer.cfg, labelprop=dataclasses.replace(
            jax_trainer.cfg.labelprop, solver=solver))
    jax_trainer.np_rng = np.random.default_rng(0)
    want = jax_trainer.test(shapenet.ShapeNetTestSet(dataset), **KW)
    testset = ShapeNetTestSet(dataset)
    got = port_trainer(cfg, testset, path, solver).test(testset, **KW)
    for key in ("perdata_miou", "pershape_miou", "accuracy"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])


def test_drain_comes_between_the_next_forward_and_its_lp(dataset,
                                                         jax_checkpoint,
                                                         monkeypatch):
    """The order of work: batch i's scatter-back (and the scoring of the
    shapes it finishes) runs after batch i+1's forward is launched and
    before its LP; the last batch drains after the loop."""
    cfg, _, path = jax_checkpoint
    testset = ShapeNetTestSet(dataset)
    trainer = port_trainer(cfg, testset, path)
    events = []
    make = loop.make_eval_logits_fn

    def logits_fn(model):
        fn = make(model)
        return lambda *a: (events.append("forward"), fn(*a))[1]

    lp, iou = loop.propagate_batch, loop.eval_iou
    monkeypatch.setattr(loop, "make_eval_logits_fn", logits_fn)
    monkeypatch.setattr(loop, "propagate_batch",
                        lambda *a, **k: (events.append("lp"), lp(*a, **k))[1])
    monkeypatch.setattr(loop, "eval_iou",
                        lambda *a: (events.append("score"), iou(*a))[1])
    trainer.test(testset, **KW)
    # 5 shapes of 2 views each in 5 batches of 2: batch i finishes shape i
    assert events == (["forward", "lp"] + ["forward", "score", "lp"] * 4
                      + ["score"])
