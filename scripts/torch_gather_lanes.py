"""Lane layouts of the narrow gather-sum (ops/csrc/csr_gather.cuh), on the card.

    python scripts/torch_gather_lanes.py      # needs a CUDA device and nvcc

csr_gather.cuh gives rows of C < 32 channels lanes of NARROW_CPL contiguous
channels each. This script builds the three scatters that sum through it
(scatter_add.cu, scatter_bn.cu, scatter_w.cu) from copies of the sources
with NARROW_CPL patched to 1, 2, 4, 8 and 16 (at 14 channels: 16, 8, 4, 2
and 1 lanes a row; 1 is the layout before, one lane a channel) and, at 4,
B6's value type's slots in flight (WVal::kUnroll) raised from 4 to 8. For
each it checks B6's scatter and B13 bit for bit against the repository's
build and prints the device time of the gather kernel (torch.profiler)
and of one call with the host's launches hidden: B6's scatter at S3DIS's
shape (B=28, N=4096, k=10, C=14) and B13 at C=3 (B=64, N=2048, k=20), the
graphs drawn from a seed. The copies are built under
weaksuppointcloudseg_tpu_torch/_build/lane_sweep/ (git-ignored); the
repository's sources are not changed.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from weaksuppointcloudseg_tpu_torch.ops import _build, scatter  # noqa: E402

SOURCES = ("scatter_add.cu", "scatter_bn.cu", "scatter_w.cu")
VARIANTS = ((1, 4), (2, 4), (4, 4), (8, 4), (16, 4), (4, 8))  # (NARROW_CPL, WVal kUnroll)


def patched_sources(dst: pathlib.Path, cpl: int, unroll: int) -> None:
    """Copies of ops/csrc under dst with the variant's constants."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(_build.CSRC, dst)
    gather = dst / "csr_gather.cuh"
    text = gather.read_text()
    old = "constexpr int NARROW_CPL = 4;"
    assert old in text, "csr_gather.cuh: NARROW_CPL not found"
    gather.write_text(text.replace(old, f"constexpr int NARROW_CPL = {cpl};"))
    w = dst / "scatter_w.cu"
    text = w.read_text()
    old = "static constexpr int kUnroll = 4;"
    assert text.count(old) == 1, "scatter_w.cu: WVal::kUnroll not found"
    w.write_text(text.replace(old, f"static constexpr int kUnroll = {unroll};"))


def build_variants():
    """{(cpl, unroll): ctypes library}, every variant compiled at once."""
    base = _build.BUILD_ROOT / "lane_sweep"
    compiles, links, libs = [], [], {}
    for cpl, unroll in VARIANTS:
        d = base / f"cpl{cpl}_u{unroll}"
        patched_sources(d / "src", cpl, unroll)
        objs = [d / f"{s}.o" for s in SOURCES]
        compiles += [[_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(o),
                      str(d / "src" / s)] for s, o in zip(SOURCES, objs)]
        links.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                      str(d / "lib.so"), *map(str, objs)])
        libs[(cpl, unroll)] = d / "lib.so"
    _build._run_all(compiles)
    _build._run_all(links)
    out = {}
    for key, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _build.SIGNATURES.items():
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        out[key] = lib
    return out


def lanes_a_row(c: int, narrow_cpl: int) -> int:
    """csr_gather.cuh's lanes per row of c < 32 channels."""
    cpl = min(narrow_cpl, 1 << (c - 1).bit_length())
    return 1 << (-(-c // cpl) - 1).bit_length()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_gather_lanes: needs a CUDA device")
    print(cs.card_line())
    repo = _build.library()
    variants = build_variants()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b, n, k, c = cs.RB, cs.RN, cs.SK, 14
    idx = torch.randint(0, n, (b, n, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    w = torch.rand((b, n, k), generator=gen, device="cuda")
    ct = torch.randn((b, n, c), generator=gen, device="cuda")
    tidx = torch.randint(0, cs.TN, (cs.TB, cs.TN, cs.K), generator=gen,
                         device="cuda", dtype=torch.int32)
    g3 = torch.randn((cs.TB, cs.TN, cs.K, 3), generator=gen, device="cuda")
    cases = (
        (f"B6 scatter B={b} N={n} k={k} C={c}", c,
         lambda: scatter.scatter_add_weighted(idx, w, ct, n)),
        (f"B13 B={cs.TB} N={cs.TN} k={cs.K} C=3", 3,
         lambda: scatter.scatter_add(tidx, g3, cs.TN)),
    )
    want = [fn() for _, _, fn in cases]
    try:
        for (cpl, unroll), lib in variants.items():
            _build._lib = lib
            for (what, width, fn), ref in zip(cases, want):
                same = cs.same_bits(fn(), ref)
                gather, = cs.kernel_device_ms(fn, ("csr_gather",), reps=10)
                total = cs.device_ms(fn)
                lanes = lanes_a_row(width, cpl)
                print(f"NARROW_CPL={cpl} WVal kUnroll={unroll} ({lanes} lanes a "
                      f"row) {what}: bit for bit the repository's build: "
                      f"{same}; gather {gather:.4f} ms, one call {total:.4f} ms "
                      f"with the host's launches hidden")
    finally:
        _build._lib = repo
    return 0


if __name__ == "__main__":
    sys.exit(main())
