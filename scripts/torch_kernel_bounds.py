"""Least H100 time of each TPU kernel's function, at the shapes its path
gives it: the larger of its operations over NVIDIA's peak for their type
and the bytes it must move (each input read once, each output written
once) over the memory rate (chip_smoke.py::bound, 700 W SXM peaks).

    python scripts/torch_kernel_bounds.py

Pure arithmetic on the shapes, no device: the numbers are the ``bound``
column of PERF.md's kernel table. For the kernels chip_smoke.py measures,
it computes the same bound from the tensors it times.

Shapes: serving is the ShapeNet test batch (B=32 views x N=3000, k=20);
training the Full-style batch (B=64 clouds = 32 unique x 2, N=2048,
k=20, C=64 EdgeConv width, 50 classes, smooth k=10); S3DIS the Full-style
batch of bench.py (B=28 = 14 x 2, N=4096, xyzrgb, 13 classes, smooth
k=10); room LP one room of N=32768 points, 6 features, 13 classes, every
tile computed (the kernel's bounding-box skip depends on the room).

A distance or affinity of a cloud with itself is symmetric, so it is
counted once per pair, diagonal included (chip_smoke.py::gram_pairs); the
room-LP matvec still takes every ordered pair.
"""

from __future__ import annotations

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from chip_smoke import bound, gram_pairs  # noqa: E402

BF16, F32, I32 = 2, 4, 4

# serving, training, S3DIS and room-LP shapes
SB, SN = 32, 3000
TB, TN, K, C = 64, 2048, 20, 64
RB, RN, RC, RK = 28, 4096, 6, 10
LN, LF, LK = 32768, 6, 13


def rows():
    """(id, pallas_call site, shape note, flops, type, bytes) per kernel."""
    tnk = TB * TN * K
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
        ("B2", "conv_kmax_pallas.py:194", "training conv2 64->64",
         2.0 * tnk * C * C, "bf16",
         tnk * C * BF16 + TB * TN * C * 2 * (BF16 + I32)),
        ("B3", "conv_kmax_pallas.py:592", "training conv2 backward",
         4 * 2.0 * tnk * C * C, "bf16",
         2 * tnk * C * BF16 + TB * TN * C * (F32 + I32)),
        ("B5", "conv_kmax_pallas.py:739", "training agg_conv 192->1024",
         2.0 * TB * TN * 192 * 1024, "bf16",
         TB * TN * 192 * BF16 + 192 * 1024 * BF16 + TB * 1024 * 2 * (F32 + I32)),
        ("B5", "conv_kmax_pallas.py:847", "training agg_conv backward",
         3 * 2.0 * TB * TN * 192 * 1024, "bf16",
         2 * TB * TN * 192 * BF16 + 192 * 1024 * (BF16 + F32)
         + TB * 1024 * (F32 + I32)),
        ("B4", "scatter_pallas.py:229", "training C=64, dense dz",
         4.0 * tnk * C, "f32",
         tnk * I32 + 2 * tnk * C * BF16 + 2 * TB * TN * C * F32),
        ("B6", "edgeconv_pallas.py:1139", "training smooth k=10, 50+1 ch",
         2.0 * TB * TN * 10 * 51, "f32",
         TB * TN * 10 * (I32 + F32) + TB * TN * 51 * (BF16 + F32)),
        ("B6", "scatter_pallas.py:299", "training smooth k=10, 50+1 ch",
         2.0 * TB * TN * 10 * 51, "f32",
         TB * TN * 10 * (I32 + F32) + 2 * TB * TN * 51 * F32),
        ("B9", "edgeconv_pallas.py:1010", "S3DIS xyzrgb k=10, 13+1 ch",
         2.0 * gram_pairs(RB, RN) * RC, "f32",
         RB * RN * RC * F32 + RB * RN * 14 * BF16
         + RB * RN * RK * (I32 + F32) + RB * RN * 14 * F32),
        ("B10", "affinity_pallas.py:272", "room LP, one matvec",
         gram_pairs(1, LN) * (3.0 * LF + 2) + LN * LN * 2.0 * LK, "f32",
         LN * LF * F32 + 2 * LN * LK * F32),
        ("B11", "edgeconv_pallas.py:862", "training C=64 (static graph)",
         2.0 * tnk * C, "bf16",
         tnk * I32 + 2 * TB * TN * C * BF16 + tnk * C * BF16),
        ("B14", "gather_pallas.py:64", "training C=64 bf16",
         0.0, "bf16", TB * TN * C * BF16 + tnk * (I32 + C * BF16)),
        ("B15", "edgeconv_pallas.py:286", "training Cg=C=64 bf16",
         2.0 * gram_pairs(TB, TN) * C, "bf16",
         2 * TB * TN * C * BF16 + tnk * (I32 + C * BF16)),
        ("B17", "affinity_pallas.py:171", "room LP, one matvec",
         gram_pairs(1, LN) * (3.0 * LF + 2) + LN * LN * 2.0 * LK, "f32",
         LN * LF * F32 + 2 * LN * LK * F32),
    ]


def main() -> None:
    print("| # | pallas_call | shape | GFLOP | MB | bound ms | bound by |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for kid, site, note, flops, kind, nbytes in rows():
        ms, by = bound(flops, kind, nbytes)
        print(f"| {kid} | {site} | {note} | {flops / 1e9:.2f} | "
              f"{nbytes / 1e6:.1f} | {ms:.4f} | {by} |")


if __name__ == "__main__":
    main()
