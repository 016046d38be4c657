"""Kernel B1 (``ops/edgeconv.py::knn_edge``) of two checkouts on the card:
every output compared bit for bit, and each side's time, at the serving
shape and the benchmark cells' shapes, exact and fast.

    python scripts/torch_b1_ab.py <checkout A> <checkout B>

Each checkout runs in a process of its own (its own nvcc build of
``ops/csrc``) on the same inputs, drawn on the card from fixed seeds, and
reports a digest of each output of the call with every output on (idx,
y1, mom, the four extrema, sqd) and the median time of 10 production
calls (no extrema, no distances) between CUDA events. Checkout B also
times the plain version. ``grid`` points are uniform in [0, 1) rounded
to bf16, as normalised block coordinates are, so many distances tie
exactly. The last line is JSON: {"same": bool, "cases": [...]}.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys

K, C = 20, 64
# name, clouds, points, graph channels, n_valid, points' distribution
CASES = [
    ("serving", 32, 3000, 64, None, "normal"),
    ("room.cg3", 14, 4096, 3, None, "grid"),
    ("room.cg64", 14, 4096, 64, None, "normal"),
    ("room.cg3.pad", 14, 4096, 3, 3001, "grid"),
    ("train.cg3", 64, 2048, 3, None, "grid"),
    ("train.cg64", 64, 2048, 64, None, "normal"),
]
NAMES = ("idx", "y1", "mom", "ymax", "amax", "ymin", "amin", "sqd")


def timed_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def digest(t) -> str:
    import torch

    raw = t.detach().contiguous().cpu().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


def worker(checkout: str, plain: bool) -> None:
    sys.path.insert(0, checkout)
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import edgeconv

    for seed, (name, b, n, cg, n_valid, dist) in enumerate(CASES):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1000 + seed)
        if dist == "grid":
            g = torch.rand((b, n, cg), generator=gen, device="cuda")
        else:
            g = torch.randn((b, n, cg), generator=gen, device="cuda")
        g = g.to(torch.bfloat16)
        v, u = (torch.randn((b, n, C), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        for fast in (False, True):
            outs = edgeconv.knn_edge(g, v, u, K, fast=fast, with_minmax=True,
                                     with_values=True, n_valid=n_valid)
            torch.cuda.synchronize()
            row = {"case": name, "fast": fast,
                   "digests": dict(zip(NAMES, map(digest, outs))),
                   "ms": timed_ms(lambda: edgeconv.knn_edge(
                       g, v, u, K, fast=fast, n_valid=n_valid))}
            if plain:
                row["plain_ms"] = timed_ms(lambda: edgeconv.knn_edge_ref(
                    g, v, u, K, fast=fast, n_valid=n_valid), 3)
            del outs
            print(json.dumps(row), flush=True)


def side(checkout: str, plain: bool) -> dict:
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--worker", checkout] +
        (["--plain"] if plain else []),
        capture_output=True, text=True, cwd=checkout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"{checkout}: exit {proc.returncode}")
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    return {(r["case"], r["fast"]): r for r in rows}


def main() -> None:
    if sys.argv[1] == "--worker":
        worker(sys.argv[2], "--plain" in sys.argv)
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    a, b = (side(os.path.abspath(sys.argv[1]), False),
            side(os.path.abspath(sys.argv[2]), True))
    cases, same = [], True
    for key in b:
        diff = [k for k in NAMES if a[key]["digests"][k] != b[key]["digests"][k]]
        same = same and not diff
        cases.append({"case": key[0], "fast": key[1], "differ": diff,
                      "a_ms": a[key]["ms"], "b_ms": b[key]["ms"],
                      "plain_ms": b[key]["plain_ms"]})
        print(f"{key[0]:>13} fast={key[1]!s:5}: A {a[key]['ms']:.3f} ms, "
              f"B {b[key]['ms']:.3f} ms, plain {b[key]['plain_ms']:.3f} ms, "
              f"{'bitwise equal' if not diff else 'DIFFER: ' + ','.join(diff)}")
    print(json.dumps({"same": same, "card": card, "cases": cases}))


if __name__ == "__main__":
    main()
