"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of BENCHMARK.json's ``workloads``) names a
configuration under ``benchmark/configs`` and a traffic mix under
``benchmark/mixes``; the mix's ``driver`` names the loop that drives the
program (``harness/<driver>_driver.py``). Set-up (imports, the CUDA context, data and weights from the
seed, the checked first steps or the warm-up requests) is timed from the
start of the process to the start of the window. With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from torch.profiler's trace of the window by the
readers under ``benchmark/metrics``.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device and, traced, breakdown, then the numbers
compared with their limits under ``checks``. The same numbers end
standard error. The run fails without a CUDA device, and when JAX or the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(ROOT, ".bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "weaksuppointcloudseg_tpu")


class Clock:
    start = _START

    def __call__(self) -> float:
        return time.perf_counter()


def fix_caches() -> None:
    """Every compiler cache the run may touch at a fixed path inside the
    checkout (the program's nvcc library already lives in its package)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "unknown"


def per_layer(cell, window) -> dict:
    from harness.manifest import metric_reader

    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(window)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(workload: str, seed: int, seconds: float, traced: bool, device,
            cell=None) -> dict:
    """Run the cell on ``device`` and return the result object."""
    import importlib

    import torch

    from harness import manifest

    cell = cell or manifest.resolve(workload, ROOT)
    driver = importlib.import_module(f"harness.{cell.mix['driver']}_driver")
    torch.set_num_threads(4)
    out = driver.run(cell, seed, seconds, traced, device, Clock())
    if traced:
        metrics = per_layer(cell, out["window"])
    else:
        metrics = dict(out["metrics"])
        metrics["setup_s"] = out["setup_s"]
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in metrics.items()
                   if k in units}
    checks = out["checks"]
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": out["attempted"], "failed": out["failed"],
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": out["memory_peak"],
        },
    }
    if traced:
        tr = out["window"].trace
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fix_caches()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, BENCH)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from harness import manifest

    cell = manifest.resolve(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"error: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                     device, cell)
    loaded = forbidden_modules()
    if loaded:
        print(f"error: loaded in this process: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    from weaksuppointcloudseg_tpu_torch.ops import _build

    print(f"card: {power_limit()}; nvcc build in this run: "
          f"{_build.build_seconds:.1f} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
