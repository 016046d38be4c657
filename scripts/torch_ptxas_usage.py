"""Registers, spills and shared memory of the port's CUDA kernels, as
``nvcc -Xptxas -v`` reports them with the build's own flags
(``ops/_build.NVCC_FLAGS``), one source at a time.

    python scripts/torch_ptxas_usage.py [source.cu ...]

With no arguments it reports ``knn_edge.cu``, ``knn.cu`` and
``knn_gather.cu`` (kernels B1, B12 and B15, on ``knn_tiles.cuh``). Needs ``nvcc``; nothing runs on a GPU. The object files go
to a temporary directory under the git-ignored ``_build/``.
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from weaksuppointcloudseg_tpu_torch.ops import _build  # noqa: E402


def report(src: pathlib.Path, out_dir: pathlib.Path) -> None:
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(out_dir / f"{src.stem}.o"), str(src)],
        capture_output=True, text=True, check=True)
    fn = None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                                text=True).stdout.strip() or m.group(1)
        elif fn and ("registers" in line or "spill" in line):
            print(f"{src.name}: {fn[:110]}\n    {line.split(': ', 1)[-1]}")


def main() -> None:
    names = sys.argv[1:] or ["knn_edge.cu", "knn.cu", "knn_gather.cu"]
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        for name in names:
            report(_build.CSRC / name, pathlib.Path(tmp))


if __name__ == "__main__":
    main()
