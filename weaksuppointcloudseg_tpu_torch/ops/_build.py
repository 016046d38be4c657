"""Build and load the package's CUDA kernels (``ops/csrc/*.cu``).

The sources are compiled at first use by ``nvcc``, one process per source,
all started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``. The library lives under
``weaksuppointcloudseg_tpu_torch/_build/<hash>/`` (git-ignored), keyed by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. Only the repository's sources are compiled.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :func:`check` raises on a non-zero code
(a launch refused for its configuration never runs, and a later
synchronise would not report it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
D = ctypes.c_double
# argument types of every C entry point (pointers and the stream as void*)
SIGNATURES = {
    "knn_edge_launch": [P, P, P, I, I, I, I, I, I, I, I, P, P, P, P, P, P, P,
                        P, P, P, P, LL, P],
    "knn_edge_pre_launch": [P, P, P, I, I, I, I, I, P, P, P, P, P, P, P, LL,
                            P],
    "conv_zmax_launch": [P, P, P, P, P, P, P, I, I, I, I, P, P],
    "conv_znmax_launch": [P, P, P, P, P, I, I, I, I, I, I, P, P, P],
    "knn_launch": [P, I, I, I, I, I, I, P, P, P, P],
    "inverse_graph_launch": [P, I, I, I, I, P, P, P, LL, P],
    "inverse_graph_cluster_launch": [P, I, I, I, I, P, P, P],
    "inverse_graph_chunks_launch": [P, I, I, I, I, P, P, P, LL, P],
    "inverse_graph_route": [I, I, I, P, P],
    "scatter_add_launch": [P, P, P, P, P, LL] + [I] * 5 + [P, P],
    "conv_minmax_launch": [P] * 5 + [I] * 3 + [P] * 6 + [LL, P],
    "conv_nmax_launch": [P, P, P] + [I] * 5 + [P] * 11,
    "conv_kmax_bwd_launch": [P] * 10 + [I] * 5 + [P] * 3 + [LL, P],
    "conv_nmax_bwd_launch": [P] * 7 + [I] * 5 + [P] * 5 + [LL, P],
    "scatter_bn_bwd_launch": [P, P, P, P, LL] + [P] * 7 + [I] * 5 + [P] * 4,
    "wgather_pre_launch": [P, P, P, I, I, I, I, P, P],
    "scatter_add_weighted_launch": [P] * 6 + [LL] + [I] * 5 + [P, P],
    "knn_wgather_launch": [P, P] + [I] * 7 + [F] + [P] * 5,
    "affinity_matvec_launch": [P] * 6 + [I] * 6 + [P] * 4,
    "gather_rows_launch": [P, P, I, I, I, I, I, P, P],
    "knn_gather_launch": [P, P] + [I] * 7 + [P] * 5,
    "room_sweep_members_launch": [P, I, LL, I, I, I, I, I, P, P, P, P, P],
    "room_sweep_gather_launch": [P, I, LL, I, P, LL, P, I, I, D, D, D, P, P,
                                 P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0  # wall time of the last compile (0 if cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libwspc_kernels.so"


def _run_all(cmds) -> None:
    """Run the commands concurrently; raise with the first failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        text = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                          f"{text}")
    if failed:
        raise RuntimeError("\n".join(failed))


def compile_library(out: Path) -> None:
    """Compile every source into the shared library ``out``: one ``nvcc``
    per source, all started together, then one link."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out.with_name(f".{src.stem}.{tag}.o") for src in _sources()]
    _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(_sources(), objs)])
    tmp = out.with_name(f".{out.name}.{tag}")
    _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    for obj in objs:
        obj.unlink()


def library() -> ctypes.CDLL:
    """The kernels' shared library, compiled on first use."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        t0 = time.perf_counter()
        compile_library(out)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError {code}")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor (None for an absent optional operand)."""
    return None if t is None else t.data_ptr()


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_operand(t, name: str, dtype, device, shape=None) -> None:
    """The wrapper-side contract of every kernel operand."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
