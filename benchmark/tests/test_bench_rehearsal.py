"""A rehearsal of every cell's measured path at a tiny size on the CPU:
the cell's loop, the window, the reference's replay and the result line (the
program runs its plain versions there). The run's own entry refuses the
CPU; these call its ``execute`` with the device given."""

import json
import subprocess
import sys

import pytest
import torch

import run as bench
from harness import manifest

SEED = 2**31 + 4242
TINY = {
    "train": dict(batch_size=2, points=64, epoch_steps=2),
    "rooms": dict(floor_plans=[[2, 2], [2, 3]], per_m2=120, block_points=128,
                  batch_size=3, sample=2),
}
CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


def tiny(name):
    cell = manifest.resolve(name)
    cell.mix.update(TINY[cell.mix["driver"]])
    return cell


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_rehearsal(name, traced):
    cell = tiny(name)
    res = bench.execute(name, SEED, 0.5, traced, torch.device("cpu"), cell)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    checks = res["checks"]
    assert set(checks) == set(cell.limits)
    for c in checks.values():
        assert c["value"] >= 0.0
    if traced:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        names = set(res["metrics"])
        assert names <= {m["name"] for m in cell.per_layer}
        assert any(n.startswith("mfu.") for n in names)
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in res["metrics"].values())
    json.dumps(res)


def test_entry_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, bench.__file__, "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
