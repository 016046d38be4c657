"""Work-item size S, the apply's route and rows per thread of kernel B10
(ops/csrc/affinity.cu), on the card.

    python scripts/torch_affinity_sweep.py [--sass [OTHER.cu ...]] [--probe]

Needs a CUDA device and nvcc. B10's design has these constants: S
(``ops/affinity.py::SEGMENT_TILES``, the kept column tiles of a work item);
in affinity.cu ``TC_MIN_K`` (the K from which the apply runs on tensor
cores, 17 = never), ``TC_WARPS`` (warps of a tensor-core item: 16-row
m-tiles a warp = 8 / TC_WARPS) and ``ROWS`` (R, rows of a thread of the
FP32 apply). The script builds affinity.cu alone from copies with those
patched, under
weaksuppointcloudseg_tpu_torch/_build/affinity_sweep/ (git-ignored; the
repository's sources are not changed), and sets SEGMENT_TILES in memory for
each S. At two inputs, bench.py's 131,072-point room (chip_smoke.py::
bench_room) and the same room with room_label_prop's 7 pad blocks of 4096
identical points 2 m beyond it (chip_smoke.py::padded_bench_room), both
as label_propagation_matfree makes
its features, and K = 13 (the CG) and 1 (the degrees), it prints for each
variant the plan's items and workspace and the device time of one call
with the host's launches hidden, split by kernel (torch.profiler: the
records' prep, items, combine), the plan's build time per S, and the error against the
plain version over the tolerance of chip_smoke.py::check_affinity. Every
variant of one S and one route (FP32 or tensor-core apply) must give the
same bits: the order of each sum is a function of the mask, S and the
route alone.

``--probe`` adds a copy that issues two of the tensor-core apply's three
products (its values are wrong and not checked; only its time is
printed): if the kernel waits on the tensor pipe, a third fewer mma.sync
make it about a third faster.

``--sass`` also prints, for this affinity.cu and any other given (the
parent's, say), the instructions of the innermost loop of B10's K=13
kernel by opcode, from ``cuobjdump -sass``: what a column costs to issue.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from weaksuppointcloudseg_tpu_torch.ops import _build, affinity  # noqa: E402
from weaksuppointcloudseg_tpu_torch.propagate import label_prop  # noqa: E402

SEGMENTS = (4, 8, 16)
# (ROWS, TC_MIN_K, TC_WARPS); the first is the repository's
VARIANTS = ((2, 2, 2), (2, 2, 4), (2, 2, 8), (2, 1, 2), (1, 17, 2),
            (2, 17, 2), (4, 17, 2))
NAMES = ("ROWS", "TC_MIN_K", "TC_WARPS")
PROBE = "probe"  # two of three products
DROPPED = "          mma_tf32(acc[mi][nn], al[mi], bh0, bh1);\n"
KERNELS = ("affinity_prep", "affinity_items", "affinity_combine")


def patched_source(dst: pathlib.Path, variant) -> pathlib.Path:
    """A copy of affinity.cu under dst with the variant's constants (the
    probe: the repository's constants, one product fewer)."""
    dst.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / "affinity.cu").read_text()
    if variant == PROBE:
        assert text.count(DROPPED) == 1, "affinity.cu: lo.hi product not found"
        text = text.replace(DROPPED, "")
        variant = VARIANTS[0]
    for name, value in zip(NAMES, variant):
        text, hits = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {value};", text)
        assert hits == 1, f"affinity.cu: {name} not found"
    src = dst / "affinity.cu"
    src.write_text(text)
    return src


def build_variants(probe: bool):
    """{variant: ctypes library of affinity.cu alone}, compiled at once."""
    base = _build.BUILD_ROOT / "affinity_sweep"
    if base.exists():
        shutil.rmtree(base)
    cmds, libs = [], {}
    for variant in VARIANTS + ((PROBE,) if probe else ()):
        d = base / (variant if variant == PROBE else "_".join(map(str, variant)))
        src = patched_source(d, variant)
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                     str(d / "lib.so"), str(src)])
        libs[variant] = d / "lib.so"
    _build._run_all(cmds)
    out = {}
    for key, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.affinity_matvec_launch.argtypes = _build.SIGNATURES["affinity_matvec_launch"]
        lib.affinity_matvec_launch.restype = ctypes.c_int
        out[key] = lib
    return out


def call(lib, feat_t, ut, plan):
    """B10 through ``lib``, as ops/affinity.py::_launch calls it."""
    b, f, n = feat_t.shape
    k = ut.shape[1]
    out = torch.empty_like(ut)
    rec = torch.empty((b, n, 8), device="cuda")
    ws = torch.empty((plan.n_items, k, affinity.TILE), device="cuda")
    code = lib.affinity_matvec_launch(
        feat_t.data_ptr(), ut.data_ptr(), plan.cols.data_ptr(),
        plan.item_start.data_ptr(), plan.item_row.data_ptr(),
        plan.row_items.data_ptr(), plan.n_items, b, n, f, k, 1,
        rec.data_ptr(), ws.data_ptr(), out.data_ptr(), _build.stream_ptr(ut.device))
    _build.check(code, "affinity_matvec_launch")
    return out


def inputs():
    """{name: feat_t} of the bench room and the padded room, as
    label_propagation_matfree makes its features."""
    xyz, _, rgb = cs.bench_room(cs.LN)
    pxyz, prgb = cs.padded_bench_room(cs.LN)
    out = {}
    for name, (x, c) in (("bench room", (xyz, rgb)), ("padded room", (pxyz, prgb))):
        feat_t, _ = label_prop.matfree_features(
            torch.from_numpy(np.ascontiguousarray(x)).cuda(),
            torch.from_numpy(np.ascontiguousarray(c)).cuda())
        out[name] = feat_t
    return out


def sweep(libs) -> None:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    card = cs.card_line()
    for name, feat_t in inputs().items():
        n = feat_t.shape[2]
        mask = affinity.tile_mask(feat_t)
        kept = mask.sum(2).float()[0]
        print(f"{name}: N={n}, {mask.shape[1]} row tiles, kept tiles per row "
              f"mean {kept.mean().item():.1f} max {int(kept.max().item())}, "
              f"{int(kept.sum().item())} tile pairs [{card}]")
        bound_rel = label_prop.check_gram_cancellation(feat_t.transpose(1, 2))
        for k in (13, 1):
            ut = torch.randn((1, k, n), generator=gen, device="cuda")
            want = affinity.affinity_matvec_t_ref(feat_t, ut)
            mags = affinity.affinity_matvec_t_ref(feat_t, ut.abs())
            tol = ((2 * bound_rel + 1e-5) * mags
                   + float(np.exp(-30.0)) * ut.abs().sum().item())
            del mags
            for seg in SEGMENTS:
                affinity.SEGMENT_TILES = seg
                plan_ms = cs.timed_ms(lambda: affinity.tile_plan(mask), reps=5)
                plan = affinity.tile_plan(mask)
                first = {}  # route -> bits of its first variant
                for variant, lib in libs.items():
                    probe = variant == PROBE
                    tc_min_k = VARIANTS[0][1] if probe else variant[1]
                    route = "tc" if k >= tc_min_k else "fp32"
                    if probe and route != "tc":
                        continue
                    got = call(lib, feat_t, ut, plan)
                    torch.cuda.synchronize()
                    ms = cs.device_ms(lambda: call(lib, feat_t, ut, plan))
                    split = cs.kernel_device_ms(lambda: call(lib, feat_t, ut, plan),
                                                KERNELS)
                    if probe:
                        print(f"  K={k} S={seg:2d} probe, two of three products "
                              f"(values not checked): call {ms:.4f} ms = prep "
                              f"{split[0]:.4f} + items {split[1]:.4f} + combine "
                              f"{split[2]:.4f}")
                        continue
                    err = ((got - want).abs() / tol).max().item()
                    same = torch.equal(got, first.setdefault(route, got))
                    print(f"  K={k} S={seg:2d} {route:4s} "
                          + " ".join(f"{a}={v}" for a, v in zip(NAMES, variant))
                          + f": {plan.n_items} items, workspace "
                          f"{plan.n_items * k * affinity.TILE * 4 / 2**20:.1f} MiB, "
                          f"plan {plan_ms:.3f} ms; call {ms:.4f} ms = prep "
                          f"{split[0]:.4f} + items {split[1]:.4f} + combine "
                          f"{split[2]:.4f}; {err:.3f} of the tolerance; same "
                          f"bits as the route's first: {same}")
                    if not (same and err <= 1.0):
                        raise SystemExit(f"{variant} S={seg} K={k}: other bits "
                                         f"than its route's first, or {err:.3f} "
                                         f"of the tolerance")
            del want, tol
    affinity.SEGMENT_TILES = 8


def inner_loop(sass: str, fn_pattern: str) -> collections.Counter:
    """Opcodes of the innermost loop holding MUFU.EX2 of the first function
    matching fn_pattern in cuobjdump's SASS."""
    body, inside = [], False
    for line in sass.splitlines():
        if line.strip().startswith("Function :"):
            inside = re.search(fn_pattern, line) is not None
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if inside and m:
            body.append((int(m.group(1), 16), m.group(2).strip()))
    loops = []
    for addr, ins in body:
        m = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)", ins) or re.search(
            r"BRA.*0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            ops = [i for a, i in body if lo <= a <= addr]
            if any("MUFU.EX2" in i for i in ops):
                loops.append(ops)
    if not loops:
        return collections.Counter()
    ops = min(loops, key=len)
    return collections.Counter(
        re.sub(r"^@!?U?P\w+\s+", "", i).split()[0] for i in ops)


def sass_report(sources) -> None:
    out_dir = _build.BUILD_ROOT / "affinity_sweep" / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    for i, src in enumerate(sources):
        obj = out_dir / f"{i}.o"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(obj),
                        str(src)], check=True)
        sass = subprocess.run([str(cuobjdump), "-sass", str(obj)], check=True,
                              capture_output=True, text=True).stdout
        # B10 at K=13: the items kernel (or the one-block-per-row-tile
        # kernel before it)
        for what, pattern in (("K=13", r"affinity_(items_(tc_)?)?kernelILi13ELb1E"),
                              ("K=1", r"affinity_(items_)?kernelILi1ELb1E")):
            ops = inner_loop(sass, pattern)
            top = ", ".join(f"{op} {c}" for op, c in ops.most_common(14))
            print(f"SASS {src}: innermost loop of B10 {what}, "
                  f"{sum(ops.values())} instructions: {top}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", nargs="*", default=None,
                    help="other affinity.cu sources to disassemble beside this one")
    ap.add_argument("--probe", action="store_true",
                    help="also time a copy with two of three tensor-core products")
    ap.add_argument("--no-sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.sass is not None:
        sass_report([_build.CSRC / "affinity.cu", *map(pathlib.Path, args.sass)])
    if not args.no_sweep:
        sweep(build_variants(args.probe))


if __name__ == "__main__":
    main()
