"""Least H100 time of each TPU kernel's function, at the shapes its path
gives it: the larger of its operations over NVIDIA's peak for their type
and the bytes it must move (each input read once, each output written
once) over the memory rate (chip_smoke.py::bound, 700 W SXM peaks).

    python scripts/torch_kernel_bounds.py

Arithmetic on the shapes, no device: the numbers are the ``bound`` column
of PERF.md's kernel table. For the kernels chip_smoke.py measures, it
computes the same bound from the tensors it times. The room-LP rows count
the tile pairs that B10's skip mask keeps on bench.py's room, computed
here on the CPU (ops/affinity.py, the port's own mask).

Shapes: serving is the ShapeNet test batch (B=32 views x N=3000, k=20);
training the Full-style batch (B=64 clouds = 32 unique x 2, N=2048,
k=20, C=64 EdgeConv width, 50 classes, smooth k=10); the fused training
kernels B2-B5 the Plain-style bf16 batch of bench.py's
shapenet_plain_train_throughput (B=32 clouds, N=2048, k=20); S3DIS the Full-style
batch of bench.py (B=28 = 14 x 2, N=4096, xyzrgb, 13 classes, smooth
k=10); room LP one room of bench.py's s3dis_room_lp_131072 (N=131072
points of its 8 x 8 x 3 m room, Morton-sorted, 6 features, 13 classes),
with every tile pair and with the pairs the skip mask keeps.

A distance or affinity of a cloud with itself is symmetric, so it is
counted once per pair, diagonal included (chip_smoke.py::gram_pairs,
affinity_flops); the room-LP matvec's apply takes every ordered pair.
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from chip_smoke import (  # noqa: E402
    LK,
    LN,
    affinity_flops,
    bench_room,
    bound,
    gram_pairs,
)

BF16, F32, I32 = 2, 4, 4

# serving, training, S3DIS and room-LP shapes
SB, SN = 32, 3000
TB, TN, K, C = 64, 2048, 20, 64
PB = 32  # the Plain-style bf16 training batch
RB, RN, RC, RK = 28, 4096, 6, 10
LF = 6


def surviving_pairs() -> float:
    """Ordered (i, j) pairs B10 computes on bench.py's room: the tile pairs
    its skip mask keeps (128-point tiles, cutoff 30) times 128^2."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import affinity
    from weaksuppointcloudseg_tpu_torch.propagate import label_prop

    xyz, _, rgb = (torch.from_numpy(a) for a in bench_room(LN))
    feat_t, _ = label_prop.matfree_features(xyz, rgb)
    mask = affinity.tile_mask(feat_t)
    return float(mask.sum()) * affinity.TILE ** 2


def rows():
    """(id, pallas_call site, shape note, flops, type, bytes) per kernel."""
    tnk = TB * TN * K
    kept = surviving_pairs()
    room_io = LN * LF * F32 + 2 * LN * LK * F32
    room = [(kid, site, f"room LP N={LN}, one matvec, {what}",
             affinity_flops(1, LN, LF, LK, pairs), "f32", room_io)
            for kid, site in (("B10", "affinity_pallas.py:272"),
                              ("B17", "affinity_pallas.py:171"))
            for what, pairs in (("every pair", float(LN) ** 2),
                                (f"{100 * kept / LN ** 2:.2f}% of pairs kept",
                                 kept))]
    return [
        ("B1", "edgeconv_pallas.py:610", "serving Cg=C=64 fast",
         2.0 * gram_pairs(SB, SN) * C, "bf16",
         3 * SB * SN * C * BF16 + SB * SN * K * (I32 + C * BF16) + 2 * C * F32),
        ("B7", "conv_kmax_pallas.py:316", "serving 64->128",
         2.0 * SB * SN * K * 64 * 128, "bf16",
         SB * SN * K * 64 * BF16 + 64 * 128 * BF16 + 5 * 128 * F32
         + SB * SN * 128 * BF16),
        ("B8", "conv_kmax_pallas.py:411", "serving 128->1024",
         2.0 * SB * SN * 128 * 1024, "bf16",
         SB * SN * 128 * BF16 + 128 * 1024 * BF16 + 3 * 1024 * F32
         + SB * 1024 * F32),
        ("B12", "knn_pallas.py:192", "training C=64 k=20",
         2.0 * gram_pairs(TB, TN) * C, "f32", TB * TN * C * F32 + tnk * I32),
        ("B12", "knn_pallas.py:192", "training C=3 k=20",
         2.0 * gram_pairs(TB, TN) * 3, "f32", TB * TN * 3 * F32 + tnk * I32),
        ("B13", "scatter_pallas.py:358", "training C=64",
         float(tnk * C), "f32",
         tnk * I32 + tnk * C * F32 + TB * TN * C * F32),
        ("B13", "scatter_pallas.py:358", "training C=3",
         float(tnk * 3), "f32", tnk * I32 + tnk * 3 * F32 + TB * TN * 3 * F32),
        *slice3_rows(),
        ("B6", "edgeconv_pallas.py:1139", "training smooth k=10, 50+1 ch",
         2.0 * TB * TN * 10 * 51, "f32",
         TB * TN * 10 * (I32 + F32) + TB * TN * 51 * (BF16 + F32)),
        ("B6", "scatter_pallas.py:299", "training smooth k=10, 50+1 ch",
         2.0 * TB * TN * 10 * 51, "f32",
         TB * TN * 10 * (I32 + F32) + 2 * TB * TN * 51 * F32),
        ("B6", "scatter_pallas.py:299", "S3DIS smooth k=10, 13+1 ch",
         2.0 * RB * RN * RK * 14, "f32",
         RB * RN * RK * (I32 + F32) + 2 * RB * RN * 14 * F32),
        ("B9", "edgeconv_pallas.py:1010", "S3DIS xyzrgb k=10, 13+1 ch",
         2.0 * gram_pairs(RB, RN) * RC + 2.0 * RB * RN * RK * 14, "f32",
         RB * RN * RC * F32 + RB * RN * 14 * BF16
         + RB * RN * RK * (I32 + F32) + RB * RN * 14 * F32),
        *room[:2],
        ("B11", "edgeconv_pallas.py:862", "training C=64 (static graph)",
         2.0 * tnk * C, "bf16",
         tnk * I32 + 2 * TB * TN * C * BF16 + tnk * C * BF16),
        ("B14", "gather_pallas.py:64", "training C=64 bf16",
         0.0, "bf16", TB * TN * C * BF16 + tnk * (I32 + C * BF16)),
        ("B15", "edgeconv_pallas.py:286", "training Cg=C=64 bf16",
         2.0 * gram_pairs(TB, TN) * C, "bf16",
         2 * TB * TN * C * BF16 + tnk * (I32 + C * BF16)),
        *room[2:],
    ]


def slice3_rows():
    """B2-B5 at the Plain-style bf16 batch, counted as chip_smoke.py's
    checks count them: inputs read once, outputs written once; B3's
    routed products (one slot per point and channel) at the work they
    need; the bf16 operations at the bf16 tensor rate."""
    pn, pnk = PB * TN, PB * TN * K
    rows = []
    for c2 in (64, 128):
        rows.append((
            "B2", "conv_kmax_pallas.py:194", f"conv2 64->{c2} (B=32)",
            2.0 * pnk * C * c2, "bf16",
            pnk * C * BF16 + C * c2 * BF16 + c2 * F32 + 2 * C * F32
            + pn * c2 * 2 * (BF16 + I32) + 2 * c2 * F32))
    for c2 in (64, 128):
        rows.append((
            "B3", "conv_kmax_pallas.py:592", f"conv2 64x{c2} backward (B=32)",
            2.0 * pnk * C * C * 2 + 2.0 * pn * c2 * C * 2, "bf16",
            2 * pnk * C * BF16 + pn * c2 * (F32 + I32) + c2 * C * BF16
            + C * C * BF16 + 5 * C * F32 + (C * c2 + C * C + 3 * C) * F32))
    for mode, big in (("dense dz", pnk * C * BF16 + C * F32),
                      ("sparse q/asel", pn * C * (F32 + I32))):
        rows.append((
            "B4", "scatter_pallas.py:229", f"C=64, {mode} (B=32)",
            5.0 * pnk * C, "f32",
            pnk * I32 + pnk * C * BF16 + big + 2 * C * F32 + 2 * pn * C * F32))
    for c1 in (128, 192):
        rows.append((
            "B5", "conv_kmax_pallas.py:739", f"{c1}->1024 (B=32)",
            2.0 * pn * c1 * 1024, "bf16",
            pn * c1 * BF16 + c1 * 1024 * BF16 + 1024 * F32
            + PB * 1024 * 2 * (F32 + I32) + 2 * 1024 * F32))
        rows.append((
            "B5", "conv_kmax_pallas.py:847", f"{c1}->1024 backward (B=32)",
            3 * 2.0 * pn * c1 * 1024, "bf16",
            2 * pn * c1 * BF16 + PB * 1024 * (F32 + I32) + c1 * 1024 * BF16
            + 3 * 1024 * F32 + c1 * 1024 * F32 + 1024 * F32))
    return rows


def main() -> None:
    print("| # | pallas_call | shape | GFLOP | MB | bound ms | bound by |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for kid, site, note, flops, kind, nbytes in rows():
        ms, by = bound(flops, kind, nbytes)
        print(f"| {kid} | {site} | {note} | {flops / 1e9:.2f} | "
              f"{nbytes / 1e6:.1f} | {ms:.4f} | {by} |")


if __name__ == "__main__":
    main()
