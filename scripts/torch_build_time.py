"""Wall time of building the port's CUDA kernels two ways: one ``nvcc``
command over all sources (how the library was first built), and
``ops/_build.compile_library`` (one ``nvcc`` per source, all started
together, then one link). Runs single, parallel, parallel, single into
fresh directories under the git-ignored ``_build/``, and prints the card.

    python scripts/torch_build_time.py

Needs ``nvcc``; no GPU work is done.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from weaksuppointcloudseg_tpu_torch.ops import _build  # noqa: E402


def single(out: pathlib.Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(out), *map(str, _build._sources())], check=True)


def main() -> None:
    root = _build.BUILD_ROOT / "build_timing"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    print(f"sources: {[s.name for s in _build._sources()]}")
    times = {"single": [], "parallel": []}
    for i, way in enumerate(("single", "parallel", "parallel", "single")):
        out = root / f"{i}" / "libwspc_kernels.so"
        t0 = time.perf_counter()
        (single if way == "single" else _build.compile_library)(out)
        times[way].append(time.perf_counter() - t0)
        print(f"build {i} {way}: {times[way][-1]:.3f} s")
    shutil.rmtree(root)
    for way, ts in times.items():
        print(f"{way}: mean {sum(ts) / len(ts):.3f} s over {len(ts)} builds")


if __name__ == "__main__":
    main()
