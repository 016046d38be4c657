"""Training cells: the program's trainer driven epoch after epoch.

Set-up makes the split and the labelled points from the seed, builds one
trainer with the benchmark's weights, opens the rampup gate, and drives
that trainer through ``check_steps`` one-step epochs on samples no other
step sees, through the window's own call (``train_epoch``). It reads
each step's loss and kNN graphs (harness/graphs.py), the first gradient
(Adam's first moment after one step over 1 - b1) and the parameters'
change after the last. The window then runs ``epoch_steps``-step epochs
over the rest of the split until ``seconds`` have passed; each epoch
ends in the trainer's one fetch of its metrics, so the clock stops at a
synchronise.

After the window the trainer is freed and the reference replays the
checked steps from the same weights and the same draws, each step's
forward along the program's graphs of that step (reference/dgcnn.py),
whose selection it checks on its own features: a kNN graph rebuilt from
features that differ by rounding picks other near-tied neighbours, and
the steps would then follow those picks more than the arithmetic.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from harness import graphs as graph_tap
from harness import manifest, traffic, weights
from harness.window import Check, Window, gap_of_norms
from reference import dgcnn
from reference import train as ref_train

ADAM_B1 = 0.9


class _Split:
    """The samples of one phase (a checked step, or the window)."""

    def __init__(self, data, label, seg, labelled):
        self.data, self.label, self.seg, self.labelled = data, label, seg, labelled


def make_data(cell, seed: int):
    mix = cell.mix
    b, n = mix["batch_size"], mix["points"]
    total = b * (mix["check_steps"] + mix["epoch_steps"])
    rng_data, rng_lab = traffic.split_seeds(seed, 2)
    if mix["dataset"] == "shapenet":
        data, label, seg = traffic.synthetic_split(total, n, rng_data)
    else:
        data, seg = traffic.s3dis_blocks(total, n, rng_data)
        label = None
    labelled = traffic.labelled_points(total, n, mix["label_fraction"], rng_lab)
    phases = []
    for p in range(mix["check_steps"] + 1):
        lo = p * b
        hi = lo + b if p < mix["check_steps"] else total
        phases.append(_Split(data[lo:hi], None if label is None else label[lo:hi],
                             seg[lo:hi], labelled[lo:hi]))
    return phases


def shapenet_meta():
    """The program's category/part maps of traffic.CATEGORIES."""
    from weaksuppointcloudseg_tpu_torch.data import shapenet

    offsets = traffic.part_offsets()
    cats = traffic.CATEGORIES
    return shapenet.ShapeNetMeta(
        objnames=[c[0] for c in cats], objcats=[c[1] for c in cats],
        on2oid={c[1]: i for i, c in enumerate(cats)},
        cpid2oid={f"{cid}_{p + 1}": int(offsets[i] + p)
                  for i, (_, cid, parts) in enumerate(cats) for p in range(parts)},
        object2setofoid={cid: list(range(offsets[i], offsets[i + 1]))
                         for i, (_, cid, _) in enumerate(cats)},
        num_categories=len(cats), num_part_cats=int(offsets[-1]))


def build_trainer(cell, exp, phases, seed, device):
    """The program's trainer over an in-memory dataset whose active phase
    the caller switches with the returned function."""
    from weaksuppointcloudseg_tpu_torch.data import s3dis, shapenet
    from weaksuppointcloudseg_tpu_torch.train.loop import S3DISTrainer, ShapeNetTrainer

    if cell.mix["dataset"] == "shapenet":
        meta = shapenet_meta()

        class Memory(shapenet.ShapeNetDataset):
            def __init__(self):
                self.meta = meta
                self._splits = {}

        ds = Memory()
        trainer = ShapeNetTrainer(exp, ds, phases[0].labelled, seed=seed,
                                  device=device)

        def activate(p):
            ds._splits["train"] = (p.data, p.label, p.seg)
            trainer.pts_idx = p.labelled
    else:
        data = np.concatenate([p.data for p in phases])
        seg = np.concatenate([p.seg for p in phases])
        ds = s3dis.S3DISDataset.from_arrays(
            data, seg, [f"Area_1_room_{i}" for i in range(len(data))])
        trainer = S3DISTrainer(exp, ds, np.concatenate([p.labelled for p in phases]),
                               test_area=5, seed=seed, device=device)
        starts = np.cumsum([0] + [len(p.data) for p in phases])
        ranges = {id(p): np.arange(starts[i], starts[i + 1])
                  for i, p in enumerate(phases)}

        def activate(p):
            trainer.train_idx = ranges[id(p)]
    return trainer, activate


def run(cell, seed: int, seconds: float, traced: bool, device, clock):
    import torch

    from harness.trace import WINDOW_SPAN, profiled, reduce, span

    mix = cell.mix
    exp = manifest.experiment(cell.config, mix)
    phases = make_data(cell, seed)
    trainer, activate = build_trainer(cell, exp, phases, seed, device)
    specs = dgcnn.param_specs(cell.config["model"])
    w0 = weights.make(specs, seed, device)
    weights.load(trainer.model, w0)
    trainer.epoch = exp.train.rampup  # the gate and the twins' augmentation on
    names = [n for n, _ in trainer.model.named_parameters()]

    # the checked steps: one-step epochs through the window's own call
    losses, grad_norms, step_graphs = [], None, []
    tap = graph_tap.GraphTap()
    tap.on = True
    try:
        for p in phases[:-1]:
            activate(p)
            losses.append(trainer.train_epoch()["total"])
            step_graphs.append(tap.take())
            if grad_norms is None:
                grad_norms = np.array([float(torch.linalg.vector_norm(m.double()))
                                       for m in trainer.opt.mu]) / (1 - ADAM_B1)
    finally:
        tap.close()
    params = dict(trainer.model.named_parameters())
    change_norms = np.array([float(torch.linalg.vector_norm(
        (params[n].detach() - w0[n]).double())) for n in names])

    activate(phases[-1])
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = clock() - clock.start
    steps = 0
    with profiled(traced) as prof:
        with span(WINDOW_SPAN):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                trainer.train_epoch()
                steps += mix["epoch_steps"]
            window_s = time.perf_counter() - t0
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    unique_points = steps * mix["batch_size"] * mix["points"]
    window = None
    if traced:
        window = Window(kind="train", config=cell.config, mix=mix,
                        trace=reduce(prof), steps=steps,
                        clouds_per_step=2 * mix["batch_size"],
                        points=mix["points"], device=device)
    del trainer, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = compare(cell, seed, device, w0, phases, losses, grad_norms,
                     change_norms, names, step_graphs)
    return {
        "setup_s": setup_s,
        "metrics": {"train_points_per_s": unique_points / window_s},
        "attempted": steps, "failed": 0, "memory_peak": memory_peak,
        "window": window, "checks": checks,
    }


def reference_steps(cell, seed, device, w0, phases, precision: str = "f32",
                    graphs=None):
    """The reference's losses, first gradient norms and change norms of the
    checked steps, leaf by leaf in ``param_specs`` order, then the names,
    each step's graphs (one per stage) and, where ``graphs`` gave each
    step's, each step's selection excess per stage."""
    from reference.precision import QUANT, matmul_precision

    cfg, mix = cell.config, cell.mix
    model = cfg["model"]
    ref = ref_train.Trainer(cfg, w0, seed, device, q=QUANT[precision])
    rng = np.random.default_rng(seed)
    losses, grads, used, excess = [], None, [], []
    for t, p in enumerate(phases[:-1]):
        batch = ref_train.assemble(mix["dataset"], p.data, p.seg, p.label,
                                   p.labelled, model["num_classes"],
                                   model["num_categories"], rng)
        with matmul_precision(False):
            out = ref.step(batch, 1.0, mix["batch_size"],
                           None if graphs is None else graphs[t])
        losses.append(out["loss"])
        used.append(out["graphs"])
        excess.append(out["excess"])
        if grads is None:
            grads = ref_train.leaf_norms(out["grads"], ref.names)
    change = {n: ref.p[n] - w0[n] for n in ref.names}
    return (np.array(losses), grads, ref_train.leaf_norms(change, ref.names),
            ref.names, used, excess if graphs is not None else None)


def compare(cell, seed, device, w0, phases, losses, grad_norms, change_norms,
            names, step_graphs):
    stages = graph_tap.stages(cell.config["model"])
    try:
        graphs = [graph_tap.by_stage(g, stages) for g in step_graphs]
        ref_loss, ref_grad, ref_change, ref_names, _, excess = reference_steps(
            cell, seed, device, w0, phases, graphs=graphs)
    except ValueError:  # the graphs do not cover the batch
        return [Check(k, float("inf"), v) for k, v in cell.limits.items()]
    order = [names.index(n) for n in ref_names]
    return readings(cell.limits, np.array(losses), grad_norms[order],
                    change_norms[order], ref_loss, ref_grad, ref_change, excess)


def readings(limits, loss, grad, change, ref_loss, ref_grad, ref_change,
             excess):
    """The numbers compared, those of them that the cell's limits name:

    - ``loss_gap``: the worst step's relative gap of the loss;
    - ``grad_gap_median``: the median moving leaf's gap of the first
      gradient's norms, over the larger of the reference leaf's norm and
      the median of all leaves' (the worst leaf's gap swings from seed to
      seed: PERF.md);
    - ``change_gap``: the worst moving leaf's gap of the norms of the
      change after the checked steps, over the larger of the reference
      leaf's norm and the median moving leaf's (window.gap_of_norms);
    - ``knn_excess_first``: the first step's worst stage's selection
      excess (reference/dgcnn.py::selection_excess), where both sides
      still hold the same weights.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's (a conv bias under batch norm) move under Adam by round-off
    alone: they are left out of the gradient and of the change."""
    moving = ref_grad >= 1e-3 * np.median(ref_grad)
    scale = np.maximum(ref_grad, np.median(ref_grad))
    values = {
        "loss_gap": float(np.max(np.abs(loss - ref_loss) / np.abs(ref_loss))),
        "grad_gap_median": float(np.median((np.abs(grad - ref_grad) / scale)[moving])),
        "change_gap": gap_of_norms(change, ref_change, moving),
        "knn_excess_first": float(max(excess[0])),
    }
    return [Check(k, values[k], limits[k]) for k in limits]
