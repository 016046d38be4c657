"""Time the ShapeNet test loop (``ShapeNetTrainer.test`` as
``cli.test_shapenet`` runs it) of two checkouts of the port on one card,
in turns A, B, B, A, each in its own process.

    python scripts/torch_test_loop_ab.py <checkout A> <checkout B> [--solver cg]

The test set and the checkpoint are chip_smoke.py's phase 3 ones (40
synthetic shapes of 2000-3500 points, full-width bf16 ShapeNet model with
seeded random weights, ``--FastKNN --batchsize 32``), written once by this
checkout. Each process imports the port from its checkout, runs the CLI
once to warm up, then times the loop alone (host clock around a
synchronise) over ``--reps`` runs and prints the median. Prints the card's
name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from weaksuppointcloudseg_tpu_torch.cli import test_shapenet
from weaksuppointcloudseg_tpu_torch.train.loop import ShapeNetTrainer
argv, reps = json.loads(sys.argv[2]), int(sys.argv[3])
real, loops = ShapeNetTrainer.test, []
def timed(self, *a, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = real(self, *a, **kw)
    torch.cuda.synchronize()
    loops.append((time.perf_counter() - t0) * 1e3)
    return out
ShapeNetTrainer.test = timed
res = [test_shapenet.main(argv) for _ in range(reps + 1)]
print("RESULT", json.dumps({"ms": float(np.median(loops[1:])),
                            "perdata_miou": res[-1]["perdata_miou"]}))
"""


def run(checkout: str, argv, reps: int) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", CHILD, checkout, json.dumps(argv), str(reps)],
        capture_output=True, text=True, check=True).stdout
    line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--solver", default="cg")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import B, card_line, full_width_model, write_raw_testset

    from weaksuppointcloudseg_tpu_torch.utils.checkpoint import save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        write_raw_testset(tmp)
        ckpt = save_checkpoint(f"{tmp}/ckpt.npz", full_width_model()[1])
        argv = ["--DataPath", tmp, "--Checkpoint", ckpt, "--Precision",
                "bfloat16", "--FastKNN", "--batchsize", str(B), "--LPSolver",
                args.solver]
        for name, checkout in (("A", args.a), ("B", args.b), ("B", args.b),
                               ("A", args.a)):
            r = run(str(pathlib.Path(checkout).resolve()), argv, args.reps)
            print(f"{name} {checkout}: ShapeNetTrainer.test {r['ms']:.1f} ms "
                  f"(median of {args.reps}), perdata mIoU "
                  f"{r['perdata_miou']:.6f}, --LPSolver {args.solver}")
    print(card_line())


if __name__ == "__main__":
    main()
