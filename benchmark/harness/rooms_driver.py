"""Room cells: one client labels one S3DIS room a request through the
program's room-wise test (``S3DISTrainer.test``) with whole-room label
propagation.

Set-up writes the mix's rooms as ``.npy`` under a temporary directory of
``TMPDIR`` (one area listing per room), builds the trainer with the
benchmark's weights and sends every room once, which warms up every shape
the window will use. The window then sends the rooms in seeded passes
(each pass every room once, in its own order) until ``seconds`` have
passed. The call returns after the room's labels reach the host.

For the last request of each room the run keeps what the program's eval
forward selected (its kNN graphs, harness/graphs.py) and produced (the
probabilities that its room label propagation takes) and the labels that
propagation returns. After the window the last request of the largest
room and ``sample - 1`` more rooms' last requests, drawn from the seed,
are checked. The reference sweeps each room on the trainer's random
stream (replayed from the seed over every request sent, warm-up
included; its blocks must have the shape of the program's probabilities)
and runs its float32 forward over the blocks along the program's graphs,
checking each graph's selection on its own features; then it propagates
the program's probabilities. The numbers compared:

- ``knn_excess``: the worst stage's mean selection excess
  (reference/dgcnn.py::selection_excess) over the sampled rooms;
- ``prob_gap``: the mean over the sampled points of the largest gap
  between the program's probability of a class and the reference's;
- ``lp_label_share``: the share of the sampled points whose label lies
  below the best of the reference's propagation of the program's
  probabilities.
"""

from __future__ import annotations

import gc
import tempfile
import time
from typing import List, NamedTuple

import numpy as np

from harness import graphs as graph_tap
from harness import manifest, traffic, weights
from harness.window import Check, Window
from reference import dgcnn, rooms as ref_rooms


class Kept(NamedTuple):
    """A request as the program served it: its index among the requests
    sent, the forward's probabilities [K, N, C], the labels [K, N] and
    the graphs that its forward selected, in call order."""

    index: int
    prob: np.ndarray
    pred: np.ndarray
    graphs: list


class Judged(NamedTuple):
    """A room's blocks and what a program made of them, to be judged."""

    blocks: np.ndarray
    room_max: np.ndarray
    prob: np.ndarray
    pred: np.ndarray
    graphs: list


def recording_trainer(exp, seed, device):
    """An S3DISTrainer that keeps, for its last room, the forward's
    probabilities that its room label propagation takes (the array
    itself, no copy) and the labels it returns (as uint8)."""
    from weaksuppointcloudseg_tpu_torch.data.s3dis import S3DISDataset
    from weaksuppointcloudseg_tpu_torch.train.loop import S3DISTrainer

    class Recording(S3DISTrainer):
        def room_label_prop(self, blocks, prob, room_max):
            pred = super().room_label_prop(blocks, prob, room_max)
            self.last = (prob, pred.astype(np.uint8))
            return pred

    n = exp.model.num_points
    ds = S3DISDataset.from_arrays(np.zeros((1, n, 9), np.float32),
                                  np.zeros((1, n), np.int32), ["Area_1_room_0"])
    return Recording(exp, ds, None, test_area=5, seed=seed, device=device)


def served_weights(cell, room, seed, device, blocks: int = 4):
    """The weights from the seed, their BN moments calibrated on the first
    blocks of ``room`` swept on a stream of their own; the peak memory
    counts from here."""
    import torch

    w = weights.make(dgcnn.param_specs(cell.config["model"]), seed, device,
                     weights.SERVED_GAMMA)
    x, _ = ref_rooms.sweep(room, ref_rooms.columns(room), cell.mix["block_points"],
                           traffic.split_seeds(seed, 4)[3])
    weights.calibrate(cell.config["model"], w, torch.from_numpy(x[:blocks]).to(device),
                      None, seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    return w


def run(cell, seed: int, seconds: float, traced: bool, device, clock):
    import torch

    from weaksuppointcloudseg_tpu_torch.data.s3dis import S3DISTestRooms

    from harness.trace import WINDOW_SPAN, profiled, reduce, span

    mix = cell.mix
    exp = manifest.experiment(cell.config, mix)
    rng_rooms, rng_order, rng_sample = traffic.split_seeds(seed, 3)
    plans = mix["floor_plans"]
    tap = graph_tap.GraphTap()
    kept = {}

    def serve(trainer, area, r):
        trainer.test(area, room_lp=mix["room_lp"])
        kept[r] = Kept(len(sent), *trainer.last, tap.take())
        sent.append(int(r))

    try:
        with tempfile.TemporaryDirectory(prefix="bench_rooms_") as base:
            paths = traffic.write_rooms(base, plans, mix["height"], mix["per_m2"],
                                        rng_rooms)
            areas = [S3DISTestRooms(base, f"r{i}", num_point=mix["block_points"])
                     for i in range(len(paths))]
            w = served_weights(cell, np.load(paths[0]), seed, device)
            trainer = recording_trainer(exp, seed, device)
            weights.load(trainer.model, w)
            tap.on = True
            sent = []
            for r in range(len(paths)):  # warm-up: every room once
                serve(trainer, areas[r], r)
            if device.type == "cuda":
                torch.cuda.synchronize()
            setup_s = clock() - clock.start
            order = traffic.cycle_order(len(paths), 1000, rng_order)
            latencies, blocks = [], []
            with profiled(traced) as prof:
                with span(WINDOW_SPAN):
                    t0 = time.perf_counter()
                    for r in order:
                        if time.perf_counter() - t0 >= seconds:
                            break
                        with span("bench.request"):
                            s = time.perf_counter()
                            serve(trainer, areas[r], r)
                            latencies.append(time.perf_counter() - s)
                        blocks.append(len(kept[r].pred))
            memory_peak = (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else 0)
            del trainer
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            raw = {i: np.load(p) for i, p in enumerate(paths)}
    finally:
        tap.close()

    n_pts = mix["block_points"]
    window = None
    if traced:
        tr = reduce(prof)
        reqs = [{"span": sp, "room": r, "clouds": k, "points": n_pts}
                for sp, r, k in zip(tr.spans.get("bench.request", []),
                                    sent[len(plans):], blocks)]
        window = Window(kind="test", config=cell.config, mix=mix, trace=tr,
                        requests=reqs, rooms=raw, device=device)
    checks = compare(cell, seed, device, w, raw, sent, kept, rng_sample)
    lat_ms = np.array(latencies) * 1e3
    return {
        "setup_s": setup_s,
        "metrics": {"test_request_ms_p95": float(np.percentile(lat_ms, 95))},
        "attempted": len(latencies), "failed": 0, "memory_peak": memory_peak,
        "window": window, "checks": checks,
    }


def sample_rooms(kept: dict, n_warm: int, count: int, rng) -> List[int]:
    """The rooms whose last requests are checked: the largest room (most
    blocks) and ``count - 1`` more drawn from the seed, among the rooms
    that the window served (all of them where it served fewer than
    ``count``)."""
    rooms = sorted(r for r, k in kept.items() if k.index >= n_warm)
    if len(rooms) < count:
        rooms = sorted(kept)
    largest = max(rooms, key=lambda r: (len(kept[r].pred), kept[r].index))
    rest = [r for r in rooms if r != largest]
    more = rng.choice(rest, min(count - 1, len(rest)), replace=False)
    return sorted([largest, *map(int, more)])


def reference_probs(cell, w, blocks, device, precision: str = "f32",
                    graphs=None, chunk: int = 8):
    """The reference's eval-forward softmax [K, N, C] of a room's blocks,
    along ``graphs`` (per stage, [K, N, k] each) where given, with each
    stage's selection excess (mean over the blocks) and the graphs used."""
    import torch

    from reference.precision import QUANT, matmul_precision

    out, used, excess = [], [], []
    with torch.no_grad(), matmul_precision(False):
        for s in range(0, len(blocks), chunk):
            given = None if graphs is None else [g[s:s + chunk] for g in graphs]
            net = dgcnn.Net(cell.config["model"], w, QUANT[precision], given)
            x = torch.from_numpy(blocks[s:s + chunk]).to(device)
            out.append(torch.softmax(net.forward(x, None, training=False), -1).cpu())
            used.append(net.used)
            excess.append(np.array(net.excess) * len(x))
    per_stage = [torch.cat(g) for g in zip(*used)]
    excess = np.sum(excess, axis=0) / len(blocks) if graphs is not None else None
    return torch.cat(out).numpy(), excess, per_stage


def replay(cell, seed, raw, sent, wanted):
    """The blocks of the requests in ``wanted`` (indices into ``sent``),
    swept on the trainers' stream replayed over every request sent."""
    rng = np.random.default_rng(seed)
    cols = {}
    out = {}
    for i, r in enumerate(sent):
        if i > max(wanted):
            break
        if r not in cols:
            cols[r] = ref_rooms.columns(raw[r])
        res = ref_rooms.sweep(raw[r], cols[r], cell.mix["block_points"], rng,
                              build=i in wanted)
        if res is not None:
            out[i] = res[0]
    return out


def gaps(y, pred) -> np.ndarray:
    """Per point, by how much the reference's value of the program's label
    lies below the reference's best."""
    y = y.reshape(-1, y.shape[-1])
    chosen = np.take_along_axis(y, pred.reshape(-1, 1).astype(np.int64), 1)[:, 0]
    return y.max(-1) - chosen


def lp_gaps(blocks, room_max, prob, pred, device) -> np.ndarray:
    """Per point, by how much the reference's propagation of the forward's
    probabilities ``prob`` values the label ``pred`` below its best."""
    import torch

    from reference.precision import matmul_precision

    with matmul_precision(False):
        y = ref_rooms.room_label_prop(blocks, prob, room_max, device)
    out = gaps(y.cpu().numpy(), pred)
    del y
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def failed(limits: dict) -> List[Check]:
    return [Check(k, float("inf"), v) for k, v in limits.items()]


def compare(cell, seed, device, w, raw, sent, kept, rng_sample):
    rooms = sample_rooms(kept, len(cell.mix["floor_plans"]), cell.mix["sample"],
                         rng_sample)
    blocks = replay(cell, seed, raw, sent, [kept[r].index for r in rooms])
    judged = []
    for r in rooms:
        k = kept[r]
        b = blocks[k.index]
        if b.shape != k.prob.shape[:2] + (9,):
            return failed(cell.limits)
        judged.append(Judged(b, raw[r][:, 0:3].max(axis=0).astype(np.float32),
                             k.prob, k.pred, k.graphs))
    return judge(cell, device, w, judged)


def judge(cell, device, w, rooms: List[Judged]) -> List[Check]:
    """The numbers compared over the rooms, each with its limit."""
    stages = graph_tap.stages(cell.config["model"])
    excess, prob_gaps, label_gaps = [], [], []
    for j in rooms:
        try:
            per_stage = graph_tap.by_stage(j.graphs, stages)
            ref, ex, _ = reference_probs(cell, w, j.blocks, device, graphs=per_stage)
        except ValueError:
            return failed(cell.limits)
        excess.append(ex * len(j.blocks))
        prob_gaps.append(np.abs(j.prob - ref).max(-1).reshape(-1))
        label_gaps.append(lp_gaps(j.blocks, j.room_max, j.prob, j.pred, device))
    values = {
        "knn_excess": float(np.max(np.sum(excess, axis=0)
                                   / sum(len(j.blocks) for j in rooms))),
        "prob_gap": float(np.mean(np.concatenate(prob_gaps))),
        "lp_label_share": float(np.mean(np.concatenate(label_gaps) > 0)),
    }
    return [Check(k, values[k], cell.limits[k]) for k in cell.limits]
