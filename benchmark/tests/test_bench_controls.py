"""The controls: the reference put in the program's place at the next
precision below the configuration's must fail the checks, through the
harness's own comparison.

- ``fp8``: the model's forward with every matmul operand (weights,
  activations, kNN coordinates) rounded to float8 e4m3, the next precision
  below the bfloat16 that the configurations state; its own kNN graphs
  stand for the program's. Room cells propagate its probabilities in
  float32, so only the forward is lowered; training cells step with it.
- ``tf32_lp`` (room cells): the float32 forward, then the label
  propagation with TF32 on, the next precision below its float32.

The control's outputs and graphs go to the same judge as the program's
(``rooms_driver.judge``, ``train_driver.readings`` after the float32
reference replays the control's steps along its graphs). On the CPU the
controls run at a tiny size; they are judged on the card, where TF32
exists: ``python benchmark/tests/test_bench_controls.py <cell> <control>
<seed>...`` prints a control's readings at the cell's own size.
"""

import json
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), os.path.dirname(HERE)]

from harness import manifest, rooms_driver, traffic, train_driver, weights  # noqa: E402
from reference import dgcnn, rooms as ref_rooms  # noqa: E402
from reference.precision import matmul_precision  # noqa: E402

SEED = 2**31 + 2718
TINY = {
    "train": dict(batch_size=2, points=64, epoch_steps=1),
    "rooms": dict(floor_plans=[[2, 2], [2, 3]], per_m2=120, block_points=128,
                  batch_size=3, sample=2),
}


def train_control(cell, seed, device, control="fp8"):
    phases = train_driver.make_data(cell, seed)
    w0 = weights.make(dgcnn.param_specs(cell.config["model"]), seed, device)
    ctl = train_driver.reference_steps(cell, seed, device, w0, phases, control)
    ref = train_driver.reference_steps(cell, seed, device, w0, phases, "f32",
                                       graphs=ctl[4])
    return train_driver.readings(cell.limits, *ctl[:3], *ref[:3], ref[5])


def rooms_control(cell, seed, device, control="fp8"):
    """The control in the program's place on a sample of the rooms (the
    largest among them), judged as the program's requests are."""
    import torch

    forward, lp_tf32 = {"fp8": ("fp8", False), "tf32_lp": ("f32", True)}[control]
    mix = cell.mix
    rng_rooms, _, _ = traffic.split_seeds(seed, 3)
    plans = mix["floor_plans"]
    raw = [traffic.surface_room(rng_rooms, (x, y, mix["height"]), mix["per_m2"])
           for x, y in plans]
    w = rooms_driver.served_weights(cell, raw[0], seed, device)
    rng = np.random.default_rng(seed)
    largest = int(np.argmax([x * y for x, y in plans]))
    judged = []
    for r in sorted({largest, *range(mix["sample"] - 1)}):
        blocks, _ = ref_rooms.sweep(raw[r], ref_rooms.columns(raw[r]),
                                    mix["block_points"], rng)
        room_max = raw[r][:, 0:3].max(axis=0).astype(np.float32)
        prob, _, graphs = rooms_driver.reference_probs(cell, w, blocks, device,
                                                       forward)
        with matmul_precision(lp_tf32):
            y = ref_rooms.room_label_prop(blocks, prob, room_max, device)
        pred = y.argmax(-1).cpu().numpy()
        del y
        if device.type == "cuda":
            torch.cuda.empty_cache()
        judged.append(rooms_driver.Judged(blocks, room_max, prob, pred, graphs))
    return rooms_driver.judge(cell, device, w, judged)


CONTROLS = {"train": (train_control, ("fp8",)),
            "rooms": (rooms_control, ("fp8", "tf32_lp"))}
CASES = [(w["name"], c) for w in manifest.load_manifest()["workloads"]
         for c in CONTROLS[manifest.resolve(w["name"]).mix["driver"]][1]]


def control(name, kind, seed, device, cell=None):
    cell = cell or manifest.resolve(name)
    return CONTROLS[cell.mix["driver"]][0](cell, seed, device, kind)


@pytest.mark.parametrize("name,kind", CASES)
def test_control_runs_at_a_small_size(name, kind):
    """The control's path on the CPU at a tiny size, judged by the cell's
    own comparison; whether it fails is decided on the card only (TF32
    does not exist on the CPU)."""
    import torch

    cell = manifest.resolve(name)
    cell.mix.update(TINY[cell.mix["driver"]])
    checks = control(name, kind, SEED, torch.device("cpu"), cell)
    assert {c.name for c in checks} == set(cell.limits)
    assert all(np.isfinite(c.value) and c.value >= 0 for c in checks)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kind", CASES)
def test_control_fails_at_the_cells_size(name, kind, cuda_device):
    for seed in (SEED, SEED + 1, SEED + 2):
        checks = control(name, kind, seed, cuda_device)
        assert not all(c.ok for c in checks), checks


if __name__ == "__main__":
    import torch

    name, kind, *seeds = sys.argv[1:]
    for s in seeds:
        checks = control(name, kind, int(s), torch.device("cuda", 0))
        print(json.dumps({"cell": name, "control": kind, "seed": int(s),
                          "readings": {c.name: c.value for c in checks}}), flush=True)
