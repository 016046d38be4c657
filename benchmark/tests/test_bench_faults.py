"""Faults planted under a run: the harness's checks must call it not
correct.

Each fault breaks the program underneath a whole run (the chip check
skipped, the window, the reference and the comparison as they run):

- ``frozen``: the optimizer's step returns the parameters unchanged;
- ``half_batch``: the training step sees the first half of its batch, its
  mean taken over that half (its kNN graphs then cover half the clouds
  that the reference steps over, and every number reads infinite);
- ``altered``: the room's predictions altered where the room label
  propagation returns them (a tenth of a percent of the points moved to
  the next class);
- ``half_rooms``: the room label propagation over the first half of the
  room's blocks, the rest left at the forward's argmax.

One chip holds every cell, so no exchange between chips can be left out.
On the CPU the tests run at a tiny size; ``python
benchmark/tests/test_bench_faults.py <cell> <fault> <seed>...`` prints
the readings of a fault at the cell's own size on the card.
"""

import contextlib
import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), os.path.dirname(HERE)]

import run as bench  # noqa: E402
from harness import manifest  # noqa: E402

SEED = 2**31 + 31337
FAULTS = {"train": ("frozen", "half_batch"), "rooms": ("altered", "half_rooms")}
TINY = {
    "train": dict(batch_size=2, points=64, epoch_steps=1),
    "rooms": dict(floor_plans=[[2, 2], [2, 3]], per_m2=120, block_points=128,
                  batch_size=3, sample=2),
}


@contextlib.contextmanager
def planted(fault: str):
    from weaksuppointcloudseg_tpu_torch.train import loop, state

    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "frozen":
        def frozen(self, learning_rate):
            self.step += 1
        patch(state.Adam, "apply_gradients", frozen)
    elif fault == "half_batch":
        make = loop.make_train_step

        def half_step(cfg, model, opt, style=None):
            step = make(cfg, model, opt, style)

            def run(batch, gate, generator=None):
                h = batch["data"].shape[0] // 2
                return step({k: v[:h] for k, v in batch.items()}, gate, generator)
            return run
        patch(loop, "make_train_step", half_step)
    elif fault == "altered":
        lp = loop.S3DISTrainer.room_label_prop

        def altered(self, blocks, prob, room_max):
            pred = lp(self, blocks, prob, room_max).copy()
            flat = pred.reshape(-1)
            flat[::1000] = (flat[::1000] + 1) % prob.shape[-1]
            return pred
        patch(loop.S3DISTrainer, "room_label_prop", altered)
    elif fault == "half_rooms":
        lp = loop.S3DISTrainer.room_label_prop

        def half_rooms(self, blocks, prob, room_max):
            h = max(1, len(blocks) // 2)
            return np.concatenate([lp(self, blocks[:h], prob[:h], room_max),
                                   prob[h:].argmax(-1)])
        patch(loop.S3DISTrainer, "room_label_prop", half_rooms)
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)


def readings(name, fault, seed, device, cell=None, seconds=1.0):
    with planted(fault):
        res = bench.execute(name, seed, seconds, False, device, cell)
    return res["correct"], {k: v["value"] for k, v in res["checks"].items()}


CASES = [(w["name"], f) for w in manifest.load_manifest()["workloads"]
         for f in FAULTS[manifest.resolve(w["name"]).mix["driver"]]]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    import torch

    cell = manifest.resolve(name)
    cell.mix.update(TINY[cell.mix["driver"]])
    correct, values = readings(name, fault, SEED, torch.device("cpu"), cell, 0.3)
    assert not correct, values


if __name__ == "__main__":
    import torch

    bench.fix_caches()
    name, fault, *seeds = sys.argv[1:]
    for s in seeds:
        ok, values = readings(name, fault, int(s), torch.device("cuda", 0))
        print(json.dumps({"cell": name, "fault": fault, "seed": int(s),
                          "correct": ok, "readings": values}), flush=True)
