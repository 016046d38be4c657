"""Where a block of the cluster inverse build spends its time, on the card.

    python scripts/torch_inverse_phases.py    # needs a CUDA device and nvcc

Builds scatter_add.cu from copies of ops/csrc in which thread 0 of every
block of inverse_cluster_kernel records clock64() and %globaltimer at each
phase boundary (the patch inserts the stamps at the lines named in
STAMPS): the kernel as it is, and the variants in VARIANTS, each a few
text edits that show what a phase costs. For each it runs the build at
chip_smoke.py phase 2's shapes, checks the inverse bit for bit against the
plain version (where the variant keeps it), and prints how many clusters
run at once (cudaOccupancyMaxActiveClusters), the spread of the blocks'
start and end times (waves), and per phase the median and 90th-percentile
SM cycles over the blocks. The copies are built under
weaksuppointcloudseg_tpu_torch/_build/inverse_phases/ (git-ignored); the
repository's sources are not changed.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from weaksuppointcloudseg_tpu_torch.ops import _build, scatter  # noqa: E402

MAX_BLOCKS = 8 * 1024
# (the phase that ends at the stamp, the kernel line the stamp goes before
# or, after the statement that starts the line); "<" marks "before"
STAMPS = (
    ("<start", "for (int e = threadIdx.x; e < (WORDS + 1) * N; e += T) sh[e] = 0;"),
    ("count", "count_piece(ib, s0, s1, N, lane, mine);"),
    ("<block counts", "cluster.sync();  // every block's counts are in"),
    ("barrier 1", "cluster.sync();  // every block's counts are in"),
    ("<owner scan", "cluster.sync();  // every owner's total is in"),
    ("barrier 2", "cluster.sync();  // every owner's total is in"),
    ("<cursor write-back", "cluster.sync();  // every block's cursors are in"),
    ("barrier 3", "cluster.sync();  // every block's cursors are in"),
    ("<warp cursors", "place_piece(ib, s0, s1, N, lane, mine, [&]"),
    ("<place", "cluster.sync();  // every place is filled"),
    ("barrier 4", "cluster.sync();  // every place is filled"),
    ("output", "if (r == 0 && threadIdx.x == 0) ob[N] = total;"),
)

# (name, [(text in scatter_add.cu, its replacement)], output checked)
VARIANTS = (
    ("as in the repository", (), True),
    ("no place stores (timing only)",
     (("cluster.map_shared_rank(seg, o)[pos - o * seg_len] = sl;",
       "if (sl < -1) seg[o] = pos;"),), False),
    ("6 warps a block", (("constexpr int CLUSTER_WARPS = 8;",
                          "constexpr int CLUSTER_WARPS = 6;"),), True),
    ("4 warps a block", (("constexpr int CLUSTER_WARPS = 8;",
                          "constexpr int CLUSTER_WARPS = 4;"),), True),
    ("16 blocks a cluster (a non-portable size)",
     (("constexpr int CLUSTER = 8;", "constexpr int CLUSTER = 16;"),
      ("  cudaLaunchConfig_t cfg = {};\n  cfg.gridDim = dim3(CLUSTER, B, 1);",
       "  cudaFuncSetAttribute(inverse_cluster_kernel,\n"
       "                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
       "  cudaLaunchConfig_t cfg = {};\n  cfg.gridDim = dim3(CLUSTER, B, 1);")),
     True),
)

PRELUDE = f"""
__device__ long long inv_stamps[{MAX_BLOCKS}][{len(STAMPS)}][2];
__device__ __forceinline__ void inv_stamp(int k) {{
  if (threadIdx.x == 0) {{
    long long g;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    if (blk < {MAX_BLOCKS}) {{
      inv_stamps[blk][k][0] = clock64();
      inv_stamps[blk][k][1] = g;
    }}
  }}
}}
"""

EPILOGUE = f"""
extern "C" int inverse_phase_reset() {{
  static long long zero[{MAX_BLOCKS}][{len(STAMPS)}][2];
  return (int)cudaMemcpyToSymbol(inv_stamps, zero, sizeof(zero));
}}

extern "C" int inverse_phase_stamps(void* out) {{
  return (int)cudaMemcpyFromSymbol(
      out, inv_stamps, sizeof(long long) * {MAX_BLOCKS} * {len(STAMPS)} * 2);
}}

// clusters of the build that can run at once at a block's shared memory
extern "C" int inverse_active_clusters(long long smem, int* out) {{
  cudaError_t err = cudaFuncSetAttribute(
      inverse_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {{}};
  cfg.gridDim = dim3(CLUSTER, 1024, 1);
  cfg.blockDim = dim3(32 * CLUSTER_WARPS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, inverse_cluster_kernel, &cfg);
}}
"""


def patched_source(tag: str, edits):
    """(directory, path) of a copy of scatter_add.cu with the edits and the
    stamps."""
    d = _build.BUILD_ROOT / "inverse_phases" / tag
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(_build.CSRC, d / "src")
    path = d / "src" / "scatter_add.cu"
    text = path.read_text()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    head, kernel = text.split("inverse_cluster_kernel(const int32_t*", 1)
    kernel, tail = kernel.split("// ---------", 1)
    for k, (name, line) in enumerate(STAMPS):
        at = kernel.index(line)
        if name.startswith("<"):
            kernel = kernel[:at] + f"inv_stamp({k}); " + kernel[at:]
        else:
            end = kernel.index(";", at) + 1
            kernel = kernel[:end] + f" inv_stamp({k});" + kernel[end:]
    head = head.replace("namespace {", "namespace {\n" + PRELUDE, 1)
    path.write_text(head + "inverse_cluster_kernel(const int32_t*" + kernel
                    + "// ---------" + tail + EPILOGUE)
    return d, path


def build_variants():
    """The variants' libraries, compiled at once."""
    made = [patched_source(f"v{i}", edits)
            for i, (_, edits, _) in enumerate(VARIANTS)]
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                      str(d / "scatter_add.o"), str(path)] for d, path in made])
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                      str(d / "lib.so"), str(d / "scatter_add.o")]
                     for d, _ in made])
    libs = []
    for d, _ in made:
        lib = ctypes.CDLL(str(d / "lib.so"))
        for name in ("inverse_graph_cluster_launch", "inverse_graph_route"):
            getattr(lib, name).argtypes = _build.SIGNATURES[name]
            getattr(lib, name).restype = ctypes.c_int
        lib.inverse_phase_stamps.argtypes = [ctypes.c_void_p]
        lib.inverse_active_clusters.argtypes = [ctypes.c_longlong,
                                                ctypes.c_void_p]
        libs.append(lib)
    return libs


def report(lib, gen, b, p, k, n, checked) -> None:
    idx = torch.randint(0, n, (b, p, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    for _ in range(2):  # warm
        got = scatter._build_inverse(idx, n, "cluster")
    torch.cuda.synchronize()
    _build.check(lib.inverse_phase_reset(), "stamps")
    got = scatter._build_inverse(idx, n, "cluster")  # the stamps' launch
    torch.cuda.synchronize()
    same = "not checked"
    if checked:
        want = scatter.inverse_graph_ref(idx, n)
        same = torch.equal(got.offsets, want.offsets) and torch.equal(
            got.src, want.src)
    smem, work = ctypes.c_longlong(), ctypes.c_longlong()
    lib.inverse_graph_route(p, k, n, ctypes.byref(smem), ctypes.byref(work))
    clusters = ctypes.c_int()
    _build.check(lib.inverse_active_clusters(smem.value,
                                             ctypes.byref(clusters)),
                 "occupancy")
    raw = np.zeros((MAX_BLOCKS, len(STAMPS), 2), np.int64)
    _build.check(lib.inverse_phase_stamps(raw.ctypes.data), "stamps")
    st = raw[raw[:, -1, 1] != 0]  # the launch's blocks
    cyc = np.diff(st[:, :, 0], axis=1)
    ns = st[:, :, 1]
    print(f"B={b} P={p} k={k} N={n}: bit for bit the plain version: {same}; "
          f"{len(st)} blocks of {smem.value} B of shared memory, {clusters.value} "
          f"clusters at once; blocks start over "
          f"{(ns[:, 0].max() - ns[:, 0].min()) / 1e3:.2f} us, the last ends "
          f"{(ns[:, -1].max() - ns[:, 0].min()) / 1e3:.2f} us after the "
          f"first starts; a block takes median "
          f"{np.median(ns[:, -1] - ns[:, 0]) / 1e3:.2f} us; SM cycles per "
          "phase, median / 90th percentile over the blocks:")
    for j, (name, _) in enumerate(STAMPS[1:]):
        print(f"    {name.lstrip('<'):20s} {np.median(cyc[:, j]):9.0f} "
              f"{np.percentile(cyc[:, j], 90):9.0f}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_inverse_phases: needs a CUDA device")
    print(cs.card_line())
    repo = _build.library()
    libs = build_variants()
    shapes = ((cs.TB, cs.TN, cs.K, cs.TN), (cs.PB, cs.PN, cs.K, cs.PN),
              (cs.RB, cs.RN, cs.SK, cs.RN), (cs.RB, cs.RN, cs.K, cs.RN))
    try:
        for (what, _, checked), lib in zip(VARIANTS, libs):
            print(f"-- {what}")
            _build._lib = lib
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            for b, p, k, n in shapes:
                report(lib, gen, b, p, k, n, checked)
    finally:
        _build._lib = repo
    return 0


if __name__ == "__main__":
    sys.exit(main())
