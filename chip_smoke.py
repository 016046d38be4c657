"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. device name and power limit; build the CUDA kernels from
     ``weaksuppointcloudseg_tpu_torch/ops/csrc`` (nvcc, one process per
     source, all started together);
  2. every kernel of the ported paths against its plain PyTorch version on
     the card, at the shapes the paths give it: kernel, plain and library
     times, and the least time the card could take (``bound_ms``);
  3. the test path end to end through ``cli.test_shapenet.main`` at full
     ShapeNet width with seeded random weights on a synthetic raw-format
     test set: launch counts of B1/B7/B8 during that run, finite metrics,
     and eval-forward / label-propagation times per batch;
  4. f32 Full-style training end to end through ``ShapeNetTrainer`` at full
     ShapeNet width (unique batch 32 -> 64 clouds x 2048 points, k=20,
     exact kNN, gate on) on a seeded in-memory synthetic split: launch
     counts of B12/B13 during ``train_epoch`` + ``evaluate``, finite
     losses, the seg loss falling on a fixed batch, CUDA against the CPU
     plain composition at a reduced batch, step time and peak memory.

Prints a JSON line of per-kernel results, then the card's
``name, power.limit`` line, and last ``{"ok": true, "device": ...}``.
Exits non-zero (and prints no result) when CUDA is unavailable or any
phase fails. Never imports JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

B, N, K = 32, 3000, 20  # the ShapeNet test batch (bench.py's eval shape)
TB, TN = 64, 2048  # the Full-style training batch: 32 unique clouds x 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# NVIDIA's published H100 SXM peaks at 700 W (dense): the least time a
# kernel could take is the larger of its operations over the peak for their
# type and the bytes it must move (inputs read once, outputs written once)
# over the memory rate.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12


def bound(flops: float, kind: str, nbytes: float):
    """(bound_ms, bound_by) of a kernel doing ``flops`` operations of type
    ``kind`` and moving ``nbytes`` bytes."""
    ops_ms = flops / PEAK_FLOPS[kind] * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def gram_pairs(b: int, n: int) -> float:
    """Dot products a self-distance kNN needs: the Gram x.x^T of each of
    b clouds of n points is symmetric, so n (n + 1) / 2 per cloud."""
    return b * n * (n + 1) / 2


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_row(name, source, replaces, max_abs_err, ms, plain_ms, bnd,
               library_ms=None):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=library_ms)


def bf16_randn(gen, shape, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(
        torch.bfloat16)


class Failure(AssertionError):
    pass


def require(cond, msg):
    if not cond:
        raise Failure(msg)


# ---------------------------------------------------------------- phase 2

def check_knn_edge(gen, report):
    """B1 against knn_edge_ref at the stage shapes (transform: Cg=3,
    stages: Cg=C=64), exact and fast, with and without minmax.

    Tolerances: the kernel's selection is held to the plain version's
    indices by agreement rate (>= 99.9% exact: f32 distance sums run in
    another order than cuBLAS's, which can reorder exact near-ties;
    >= 98% fast, ROADMAP C5). Everything downstream of the indices is
    checked against the plain formulas evaluated at the kernel's own
    indices: y1 and the k-extrema bitwise, the selected distances to
    1e-5 relative of the norm scale, the moments to 1e-5 of the sum of
    magnitudes (atomic f32 sums in another order).
    """
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import edgeconv, knn

    max_err = 0.0
    for cg, fast, minmax in ((3, False, False), (3, True, False),
                             (64, False, False), (64, True, False),
                             (64, False, True), (64, True, True)):
        g = bf16_randn(gen, (B, N, cg))
        v = bf16_randn(gen, (B, N, 64))
        u = bf16_randn(gen, (B, N, 64))
        outs = edgeconv.knn_edge(g, v, u, K, fast=fast, with_minmax=minmax,
                                 with_values=True)
        ref = edgeconv.knn_edge_ref(g, v, u, K, fast=fast,
                                    with_minmax=minmax, with_values=True)
        torch.cuda.synchronize()
        idx, y, mom = outs[:3]
        agree = (idx == ref[0]).float().mean().item()
        require(agree >= (0.98 if fast else 0.999),
                f"knn_edge cg={cg} fast={fast}: index agreement {agree}")
        bi = torch.arange(B, device="cuda")[:, None, None]
        y_want = (v.float()[bi, idx.long()] + u.float()[:, :, None, :]).to(
            torch.bfloat16)
        require(torch.equal(y, y_want), f"knn_edge cg={cg}: y1 != v[idx]+u")
        y32 = y.float()
        mom_want = torch.stack([y32.sum((0, 1, 2)), (y32 * y32).sum((0, 1, 2))])
        mags = torch.stack([y32.abs().sum((0, 1, 2)), mom_want[1]])
        mom_err = ((mom - mom_want).abs() / mags).max().item()
        require(mom_err <= 1e-5, f"knn_edge cg={cg}: moment error {mom_err}")
        d = knn.distances(g)
        d_sel = torch.gather(d, 2, idx.long())
        if fast:
            d_sel = torch.clamp_min(d_sel, 0.0)
        scale = d.abs().amax().item() + 1.0
        sqd_err = (outs[-1] - d_sel).abs().max().item()
        # fast mode drops the low idx_bits of the mantissa (by design)
        tol = scale * (2.0 ** (edgeconv.idx_bits(N) - 23) if fast else 1e-5)
        require(sqd_err <= tol, f"knn_edge cg={cg}: sqd error {sqd_err}")
        if minmax:
            want_mm = (torch.gather(y, 2, y32.argmax(2, keepdim=True))[:, :, 0],
                       y32.argmax(2).int(),
                       torch.gather(y, 2, y32.argmin(2, keepdim=True))[:, :, 0],
                       y32.argmin(2).int())
            for got, want in zip(outs[3:7], want_mm):
                require(torch.equal(got, want), f"knn_edge cg={cg}: minmax")
        max_err = max(max_err, sqd_err)
        print(f"  knn_edge Cg={cg} C=64 fast={fast} minmax={minmax}: "
              f"idx agreement {agree:.6f}, y1/minmax exact, "
              f"mom rel err {mom_err:.2e}, sqd abs err {sqd_err:.2e}")
    # the timed case: a 64-wide EdgeConv stage in the production fast mode
    g = bf16_randn(gen, (B, N, 64))
    v = bf16_randn(gen, (B, N, 64))
    u = bf16_randn(gen, (B, N, 64))
    ms = timed_ms(lambda: edgeconv.knn_edge(g, v, u, K, fast=True))
    plain_ms = timed_ms(lambda: edgeconv.knn_edge_ref(g, v, u, K, fast=True))
    idx, y, mom = edgeconv.knn_edge(g, v, u, K, fast=True)
    # half the bf16 Gram (symmetric), inputs g, v, u, outputs idx, y1, moments
    bnd = bound(2.0 * gram_pairs(B, N) * 64, "bf16",
                nbytes(g, v, u, idx, y, mom))
    print(f"  knn_edge B={B} N={N} k={K} Cg=C=64 fast: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}), "
          f"{100 * bnd[0] / ms:.1f}% of bound")
    report.append(kernel_row(
        "knn_edge (B1)", "weaksuppointcloudseg_tpu_torch/ops/csrc/knn_edge.cu",
        "weaksuppointcloudseg_tpu/ops/edgeconv_pallas.py:610", max_err, ms,
        plain_ms, bnd))


def _bn_fold(gen, c, dev="cuda"):
    """A BN affine with both signs of gamma (ROADMAP: negative gammas
    select the k-minimum)."""
    import torch

    s = torch.randn(c, generator=gen, device=dev) * 0.5
    t = torch.randn(c, generator=gen, device=dev) * 0.2
    return s, t


def check_conv_zmax(gen, report):
    """B7 against conv_zmax_ref at 64->64 and 64->128 with the BN1 fold.

    Tolerance: f32 accumulation in another order can put y one bf16 ulp
    (2^-7 relative) away before BN2; through z = s2*y + t2 and the bf16
    output rounding that bounds |out - ref| by 2^-6 |ref| + 2^-7 |t2|."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import conv_kmax

    max_err = 0.0
    for c2 in (64, 128):
        h1 = bf16_randn(gen, (B, N, K, 64))
        w2 = bf16_randn(gen, (64, c2), 0.2)
        b2 = torch.randn(c2, generator=gen, device="cuda") * 0.1
        s2, t2 = _bn_fold(gen, c2)
        sc1, sh1 = _bn_fold(gen, 64)
        got = conv_kmax.conv_zmax(h1, w2, b2, s2, t2, sc1, sh1)
        want = conv_kmax.conv_zmax_ref(h1, w2, b2, s2, t2, sc1, sh1)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = 2.0 ** -6 * want.float().abs() + 2.0 ** -7 * t2.abs()
        require(bool((err <= tol).all()), f"conv_zmax 64->{c2}: {err.max()}")
        exact = (got == want).float().mean().item()
        max_err = max(max_err, err.max().item())
        ms = timed_ms(lambda: conv_kmax.conv_zmax(h1, w2, b2, s2, t2, sc1, sh1))
        plain_ms = timed_ms(
            lambda: conv_kmax.conv_zmax_ref(h1, w2, b2, s2, t2, sc1, sh1))
        bnd = bound(2.0 * B * N * K * 64 * c2, "bf16",
                    nbytes(h1, w2, b2, s2, t2, sc1, sh1, got))
        print(f"  conv_zmax B={B} N={N} k={K} 64->{c2} fold: bitwise equal "
              f"{exact:.6f}, max abs err {err.max().item():.3e}; kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.3f} ms "
              f"({bnd[1]}), {100 * bnd[0] / ms:.1f}% of bound")
    report.append(kernel_row(
        "conv_zmax (B7)", "weaksuppointcloudseg_tpu_torch/ops/csrc/conv_kmax.cu",
        "weaksuppointcloudseg_tpu/ops/conv_kmax_pallas.py:316", max_err, ms,
        plain_ms, bnd))


def check_conv_znmax(gen, report):
    """B8 against conv_znmax_ref at 192->1024 (agg_conv) and 128->1024
    (tconv3) with n_valid. Tolerance as B7's before the output rounding:
    |out - ref| <= 2^-7 (|ref| + |t2|) (one bf16 ulp of y through s2)."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import conv_kmax

    max_err = 0.0
    for c1 in (192, 128):
        h = bf16_randn(gen, (B, N, c1))
        w = bf16_randn(gen, (c1, 1024), 0.1)
        b = torch.randn(1024, generator=gen, device="cuda") * 0.1
        s2, t2 = _bn_fold(gen, 1024)
        for nv in (N, N - 100):
            got = conv_kmax.conv_znmax(h, w, b, s2, t2, n_valid=nv)
            want = conv_kmax.conv_znmax_ref(h, w, b, s2, t2, n_valid=nv)
            torch.cuda.synchronize()
            err = (got - want).abs()
            tol = 2.0 ** -7 * (want.abs() + t2.abs()) + 1e-6
            require(bool((err <= tol).all()),
                    f"conv_znmax {c1}->1024 n_valid={nv}: {err.max()}")
            max_err = max(max_err, err.max().item())
        ms = timed_ms(lambda: conv_kmax.conv_znmax(h, w, b, s2, t2))
        plain_ms = timed_ms(lambda: conv_kmax.conv_znmax_ref(h, w, b, s2, t2))
        bnd = bound(2.0 * B * N * c1 * 1024, "bf16",
                    nbytes(h, w, b, s2, t2, got))
        print(f"  conv_znmax B={B} N={N} {c1}->1024: max abs err "
              f"{max_err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bnd[0]:.3f} ms ({bnd[1]}), "
              f"{100 * bnd[0] / ms:.1f}% of bound")
    report.append(kernel_row(
        "conv_znmax (B8)", "weaksuppointcloudseg_tpu_torch/ops/csrc/conv_kmax.cu",
        "weaksuppointcloudseg_tpu/ops/conv_kmax_pallas.py:411", max_err, ms,
        plain_ms, bnd))


def check_knn(gen, report):
    """B12 against knn_ref at the training path's shapes: B=64 clouds of
    N=2048 points; C=3 (transform branch, stage 0) and C=64 (stages 1-2)
    at k=20, exact and fast, and C=3 at k=10 with values (the smoothness
    loss).

    Tolerances: indices by agreement rate (>= 99.9% exact: the kernel's
    f32 Gram sums in another order than cuBLAS's, which can reorder exact
    near-ties; >= 98% fast, ROADMAP C5); the selected distances against
    the plain formula at the kernel's own indices, to 1e-5 of the distance
    scale (fast: the dropped idx_bits of the mantissa)."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import knn

    max_err, times = 0.0, {}
    for c, k, fast in ((3, K, False), (3, K, True), (64, K, False),
                       (64, K, True), (3, 10, False)):
        x = torch.randn((TB, TN, c), generator=gen, device="cuda")
        idx, sqd = knn.knn(x, k, fast=fast, with_values=True)
        want = knn.knn_ref(x, k, fast=fast)
        torch.cuda.synchronize()
        agree = (idx == want).float().mean().item()
        require(agree >= (0.98 if fast else 0.999),
                f"knn C={c} k={k} fast={fast}: index agreement {agree}")
        d = knn.distances(x)
        d_sel = torch.gather(d, 2, idx.long())
        if fast:
            d_sel = d_sel.clamp_min(0.0)
        scale = d.abs().amax().item()
        err = (sqd - d_sel).abs().max().item()
        tol = scale * (2.0 ** (knn.idx_bits(TN) - 23) if fast else 1e-5)
        require(err <= tol, f"knn C={c} k={k} fast={fast}: sqd error {err}")
        del d, d_sel
        max_err = max(max_err, err)
        with_values = k != K
        ms = timed_ms(lambda: knn.knn(x, k, fast=fast, with_values=with_values))
        plain_ms = timed_ms(lambda: knn.knn_ref(x, k, fast=fast,
                                                with_values=with_values))
        outs = (idx, sqd) if with_values else (idx,)
        bnd = bound(2.0 * gram_pairs(TB, TN) * c, "f32", nbytes(x, *outs))
        # orientation only: two library calls, and topk has no tie order
        pair_ms = timed_ms(lambda: torch.topk(torch.cdist(x, x), k, dim=-1,
                                              largest=False))
        times[(c, k, fast)] = (ms, plain_ms, bnd)
        print(f"  knn B={TB} N={TN} C={c} k={k} fast={fast}: index agreement "
              f"{agree:.6f}, sqd abs err {err:.2e}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, cdist+topk {pair_ms:.3f} ms, bound "
              f"{bnd[0]:.3f} ms ({bnd[1]}), {100 * bnd[0] / ms:.1f}% of bound")
    ms, plain_ms, bnd = times[(64, K, False)]
    report.append(kernel_row(
        "knn (B12)", "weaksuppointcloudseg_tpu_torch/ops/csrc/knn.cu",
        "weaksuppointcloudseg_tpu/ops/knn_pallas.py:192", max_err, ms,
        plain_ms, bnd))


def check_scatter_add(gen, report):
    """B13 against index_add_ at the training path's shapes (the backward
    of the stage gathers: B=64, P=N=2048, k=20, C=64 and C=3).

    Tolerance: f32 atomics add the k contributions to a row in an order
    that changes from run to run, so each output element is held to 1e-5
    of the sum of magnitudes that reach it (ROADMAP C4)."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import scatter

    max_err, times = 0.0, {}
    for c in (64, 3):
        idx = torch.randint(0, TN, (TB, TN, K), generator=gen, device="cuda",
                            dtype=torch.int32)
        g = torch.randn((TB, TN, K, c), generator=gen, device="cuda")
        got = scatter.scatter_add(idx, g, TN)
        want = scatter.scatter_add_ref(idx, g, TN)
        mags = scatter.scatter_add_ref(idx, g.abs(), TN)
        torch.cuda.synchronize()
        err = (got - want).abs()
        require(bool((err <= 1e-5 * mags + 1e-6).all()),
                f"scatter_add C={c}: {err.max().item()}")
        max_err = max(max_err, err.max().item())
        ms = timed_ms(lambda: scatter.scatter_add(idx, g, TN))
        plain_ms = timed_ms(lambda: scatter.scatter_add_ref(idx, g, TN))
        rows = scatter._flat_rows(idx, TN)
        flat = g.reshape(-1, c)
        out = torch.zeros((TB * TN, c), device="cuda")
        lib_ms = timed_ms(lambda: out.index_add_(0, rows, flat))
        bnd = bound(float(g.numel()), "f32", nbytes(idx, g, got))
        times[c] = (ms, plain_ms, bnd, lib_ms)
        print(f"  scatter_add B={TB} P=N={TN} k={K} C={c}: max abs err "
              f"{err.max().item():.2e}; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, index_add_ {lib_ms:.3f} ms, bound "
              f"{bnd[0]:.3f} ms ({bnd[1]}), {100 * bnd[0] / ms:.1f}% of bound")
    ms, plain_ms, bnd, lib_ms = times[64]
    report.append(kernel_row(
        "scatter_add (B13)", "weaksuppointcloudseg_tpu_torch/ops/csrc/scatter_add.cu",
        "weaksuppointcloudseg_tpu/ops/scatter_pallas.py:358", max_err, ms,
        plain_ms, bnd, library_ms=lib_ms))


def phase_kernels(report):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print("phase 2: kernels against their plain versions")
    check_knn_edge(gen, report)
    check_conv_zmax(gen, report)
    check_conv_znmax(gen, report)
    check_knn(gen, report)
    check_scatter_add(gen, report)


# ---------------------------------------------------------------- phase 3

# ShapeNet part segmentation's 16 categories with their real part counts
# (50 parts in all), as hdf5_data/all_object_categories.txt lists them.
CATEGORIES = (
    ("Airplane", "02691156", 4), ("Bag", "02773838", 2), ("Cap", "02954340", 2),
    ("Car", "02958343", 4), ("Chair", "03001627", 4),
    ("Earphone", "03261776", 3), ("Guitar", "03467517", 3),
    ("Knife", "03624134", 2), ("Lamp", "03636649", 4),
    ("Laptop", "03642806", 2), ("Motorbike", "03790512", 6),
    ("Mug", "03797390", 2), ("Pistol", "03948459", 3),
    ("Rocket", "04099429", 3), ("Skateboard", "04225987", 3),
    ("Table", "04379243", 3))


def write_meta(h5dir: str) -> None:
    """The category/part maps under hdf5_data/ (ShapeNetMeta.load reads them)."""
    import os

    os.makedirs(h5dir, exist_ok=True)
    with open(os.path.join(h5dir, "all_object_categories.txt"), "w") as f:
        f.write("".join(f"{name}\t{cid}\n" for name, cid, _ in CATEGORIES))
    oid2cpid, cpid2oid = [], {}
    for _, cid, parts in CATEGORIES:
        for p in range(1, parts + 1):
            cpid2oid[f"{cid}_{p}"] = len(oid2cpid)
            oid2cpid.append([cid, p])
    with open(os.path.join(h5dir, "overallid_to_catid_partid.json"), "w") as f:
        json.dump(oid2cpid, f)
    with open(os.path.join(h5dir, "catid_partid_to_overallid.json"), "w") as f:
        json.dump(cpid2oid, f)


def write_raw_testset(base: str, num_shapes: int = 40, seed: int = 0) -> None:
    """A ShapeNet-format raw test set (the layout data/shapenet.py::
    ShapeNetTestSet reads) with numpy and json only: per-category metadata
    under hdf5_data/, .pts/.seg files under PartAnnotation/, and
    testing_ply_file_list.txt. Shapes have 2000-3500 points, so shapes
    past 3000 points take two views. Parts are slabs along z."""
    import os

    rng = np.random.default_rng(seed)
    write_meta(os.path.join(base, "hdf5_data"))
    rows = []
    for i in range(num_shapes):
        _, cid, parts = CATEGORIES[i % len(CATEGORIES)]
        n = int(rng.integers(2000, 3501))
        pts = rng.standard_normal((n, 3)) * np.array([0.3, 0.2, 0.6])
        part = np.clip(((pts[:, 2] + 1.2) / 2.4 * parts).astype(int), 0, parts - 1)
        for sub in ("points", "points_label"):
            os.makedirs(os.path.join(base, "PartAnnotation", cid, sub),
                        exist_ok=True)
        np.savetxt(os.path.join(base, "PartAnnotation", cid, "points",
                                f"s{i}.pts"), pts, fmt="%.6f")
        np.savetxt(os.path.join(base, "PartAnnotation", cid, "points_label",
                                f"s{i}.seg"), part + 1, fmt="%d")
        rows.append(f"{cid}/points/s{i}.pts {cid}/points_label/s{i}.seg {cid}")
    with open(os.path.join(base, "testing_ply_file_list.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


def full_width_model(seed: int = 0):
    """The ShapeNet preset at full width with seeded random weights and
    non-trivial BN: gammas of both signs, shifted means, spread variances."""
    import dataclasses

    import torch

    from weaksuppointcloudseg_tpu_torch import configs
    from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg

    cfg = dataclasses.replace(configs.shapenet_config().model,
                              compute_dtype="bfloat16", knn_fast=True)
    model = DGCNNSeg(cfg, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            u = torch.rand(t.shape, generator=gen)
            if leaf == "gamma":
                t.copy_((0.5 + u) * torch.where(u < 0.15, -1.0, 1.0))
            elif leaf in ("beta", "mean"):
                t.copy_((u - 0.5) * 0.2)
            elif leaf == "var":
                t.copy_(0.5 + u)
            elif leaf == "b":
                t.copy_((u - 0.5) * 0.1)
    return cfg, model


def phase_end_to_end(report) -> None:
    import tempfile

    import torch

    from weaksuppointcloudseg_tpu_torch.cli import test_shapenet
    from weaksuppointcloudseg_tpu_torch.data.shapenet import ShapeNetTestSet
    from weaksuppointcloudseg_tpu_torch.ops import conv_kmax, edgeconv
    from weaksuppointcloudseg_tpu_torch.propagate.label_prop import (
        propagate_batch,
    )
    from weaksuppointcloudseg_tpu_torch.train.steps import make_eval_logits_fn
    from weaksuppointcloudseg_tpu_torch.utils.checkpoint import save_checkpoint
    from weaksuppointcloudseg_tpu_torch.utils.tools import onehot_encode

    print("phase 3: ShapeNet test path end to end (cli.test_shapenet.main)")
    kernels = {"knn_edge (B1)": edgeconv.knn_edge,
               "conv_zmax (B7)": conv_kmax.conv_zmax,
               "conv_znmax (B8)": conv_kmax.conv_znmax}
    with tempfile.TemporaryDirectory() as tmp:
        write_raw_testset(tmp)
        cfg, model = full_width_model()
        ckpt = save_checkpoint(f"{tmp}/ckpt.npz", model)
        argv = ["--DataPath", tmp, "--Checkpoint", ckpt, "--Precision",
                "bfloat16", "--FastKNN", "--batchsize", str(B)]
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = test_shapenet.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        testset = ShapeNetTestSet(tmp)
        views = [testset[i] for i in range(2)]
    print(f"  cli run: {wall:.2f} s wall for {len(testset)} shapes "
          f"(file parsing and first calls included); launches {launches}")
    for row in report:
        row["launches"] = launches.get(row["name"], row["launches"])
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched by the test path")
    for key in ("perdata_miou", "pershape_miou", "accuracy"):
        require(np.isfinite(res[key]) and 0.0 <= res[key] <= 1.0,
                f"metric {key} = {res[key]}")

    # the CUDA path against the same composition over the plain versions
    # on the CPU, on two real shapes (2000 points each): argmax >= 99%,
    # probabilities 2e-2 (bf16 activations; another f32 summation order in
    # every conv); LP on the same probabilities 1e-3
    dev = torch.device("cuda")
    model = model.to(dev).eval()
    x_small = np.stack([v[0][:2000] for v in views]).astype(np.float32)
    cat_small = onehot_encode(np.asarray([v[2] for v in views]), 16)
    with torch.inference_mode():
        got = torch.softmax(model(torch.from_numpy(x_small).to(dev),
                                  torch.from_numpy(cat_small).to(dev)), -1)
        lp_got = propagate_batch(torch.from_numpy(x_small).to(dev), got)
        cpu_model = full_width_model()[1].eval()
        want = torch.softmax(cpu_model.forward_fused(
            torch.from_numpy(x_small), torch.from_numpy(cat_small)), -1)
        lp_want = propagate_batch(torch.from_numpy(x_small), got.cpu())
    agree = (got.argmax(-1).cpu() == want.argmax(-1)).float().mean().item()
    dprob = (got.cpu() - want).abs().max().item()
    dlp = (lp_got.cpu() - lp_want).abs().max().item()
    print(f"  CUDA vs CPU plain composition, 2 x 2000 points: argmax "
          f"agreement {agree:.5f}, max |dprob| {dprob:.2e}; LP on the same "
          f"probabilities max |dy| {dlp:.2e}")
    require(agree >= 0.99 and dprob <= 2e-2, "CUDA forward disagrees")
    require(dlp <= 1e-3, "CUDA label propagation disagrees")

    # timing at bench.py's test shape: 32 views of 3000 normalized points
    rng = np.random.default_rng(0)
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True).max(1, keepdims=True)
    x = torch.from_numpy(xyz).to(dev)
    cat = torch.from_numpy(onehot_encode(rng.integers(0, 16, B), 16)).to(dev)
    # LP on trained-like (sharp) probabilities, as bench.py times it: the
    # random model's near-uniform softmax runs CG to its cap
    sharp = torch.from_numpy(rng.standard_normal((B, N, 50)).astype(
        np.float32) * 5.0).to(dev)
    logits_fn = make_eval_logits_fn(model)

    def forward():
        with torch.inference_mode():
            return torch.softmax(logits_fn(x, cat), -1)

    def e2e():
        with torch.inference_mode():
            prob = torch.softmax(torch.log(forward() + 1e-9) + sharp, -1)
            return propagate_batch(x, prob)

    with torch.inference_mode():
        prob_t = torch.softmax(torch.log(forward() + 1e-9) + sharp, -1)
    fwd_ms = timed_ms(forward)
    lp_ms = timed_ms(lambda: propagate_batch(x, prob_t))
    e2e_ms = timed_ms(e2e)
    card = card_line()
    for metric, ms in (("shapenet_eval_forward_throughput", fwd_ms),
                       ("label_propagation (cg)", lp_ms),
                       ("shapenet_test_e2e_throughput", e2e_ms)):
        print(f"  {metric}: {ms:.3f} ms per {B}x{N} batch, "
              f"{B * N / ms * 1e3:.0f} points/s [{card}]")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    device_breakdown(e2e, card)


# ---------------------------------------------------------------- phase 4

def synthetic_split(num: int, rng: np.random.Generator):
    """(data [S, 2048, 3] f32, label [S] i32, seg [S, 2048] i32): clouds of
    the 16 categories with their real part counts, parts as slabs along z,
    normalized to the unit sphere as the h5 splits are."""
    offsets = np.cumsum([0] + [p for _, _, p in CATEGORIES])
    label = rng.integers(0, len(CATEGORIES), num).astype(np.int32)
    data = rng.standard_normal((num, TN, 3)) * np.array([0.3, 0.2, 0.6])
    data += rng.standard_normal((num, 1, 3)) * 0.05 * label[:, None, None] / 16
    data /= np.linalg.norm(data, axis=-1).max(axis=1)[:, None, None]
    parts = np.array([p for _, _, p in CATEGORIES])[label][:, None]
    rank = np.argsort(np.argsort(data[..., 2], axis=1), axis=1)
    seg = offsets[label][:, None] + (rank * parts) // TN
    return data.astype(np.float32), label, seg.astype(np.int32)


def in_memory_dataset(base: str, splits):
    """A ShapeNetDataset whose train/val splits come from memory: the card's
    machine has no h5py, so only the h5 reader is replaced, here."""
    from weaksuppointcloudseg_tpu_torch.data import shapenet

    class InMemory(shapenet.ShapeNetDataset):
        def _load_split(self, list_name):
            return splits[list_name.split("_")[0]]

    write_meta(f"{base}/hdf5_data")
    return InMemory(base)


def phase_train(report) -> None:
    """f32 Full-style training through ShapeNetTrainer at full width."""
    import dataclasses
    import tempfile

    import torch

    from weaksuppointcloudseg_tpu_torch import configs
    from weaksuppointcloudseg_tpu_torch.data import sampling
    from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
    from weaksuppointcloudseg_tpu_torch.ops import knn, scatter
    from weaksuppointcloudseg_tpu_torch.train.loop import ShapeNetTrainer
    from weaksuppointcloudseg_tpu_torch.train.steps import loss_fn

    print(f"phase 4: f32 Full-style training end to end (ShapeNetTrainer), "
          f"{TB // 2} unique x 2 Siamese x {TN} points")
    rng = np.random.default_rng(0)
    splits = {"train": synthetic_split(3 * TB // 2, rng),
              "val": synthetic_split(24, rng)}
    base = configs.shapenet_config()
    # rampup 0: the gate is on and the pairs are augmented from epoch 0
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, batch_size=TB // 2, rampup=0))
    kernels = {"knn (B12)": knn.knn, "scatter_add (B13)": scatter.scatter_add}
    with tempfile.TemporaryDirectory() as tmp:
        ds = in_memory_dataset(tmp, splits)
        pts_idx = sampling.generate_sample_index(3 * TB // 2, TN, 0.1)
        trainer = ShapeNetTrainer(cfg, ds, pts_idx, seed=0, device="cuda")
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        m = trainer.train_epoch(0)
        val = trainer.evaluate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"  train_epoch (3 steps) + evaluate (24 val clouds): {wall:.2f} s "
          f"wall (first calls included); launches {launches}")
    print(f"  epoch metrics: " + ", ".join(f"{k} {v:.5g}" for k, v in m.items()))
    print(f"  eval: loss {val[0]:.4f} acc {val[1]:.4f} perdata mIoU "
          f"{val[2]:.4f} pershape mIoU {float(np.mean(val[3])):.4f}")
    for row in report:
        row["launches"] = launches.get(row["name"], row["launches"])
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched by the training path")
    for key in ("seg", "siamese", "inexact", "smooth", "total", "acc"):
        require(np.isfinite(m[key]), f"train metric {key} = {m[key]}")
    require(m["lr"] > 0 and 0 < m["bn_decay"] < 1, f"schedules {m}")
    require(np.isfinite(val[0]) and 0 <= val[1] <= 1, f"eval {val}")

    # a fixed batch: the seg loss must fall over the steps; step times
    b = next(ds.batches("train", TB // 2))
    batch = trainer._to_device(trainer._assemble(
        b, siamese=True, augment_pairs=True, full_mask=False))
    torch.cuda.reset_peak_memory_stats()
    seg, step_s = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.train_step(batch, 1.0, trainer.generator)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        seg.append(out["seg"])
    seg = torch.stack(seg).cpu().numpy()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  seg loss on a fixed batch over 6 steps: "
          + " ".join(f"{v:.4f}" for v in seg))
    require(np.isfinite(seg).all() and seg[-1] < seg[0],
            "the seg loss did not fall on a fixed batch")
    card = card_line()
    step = float(np.median(step_s[1:]))
    print(f"  shapenet_full_f32_train_throughput: {step * 1e3:.3f} ms per step "
          f"(median of 5), {TB // 2 * TN / step:.0f} unique points/s "
          f"({TB * TN / step:.0f} fed points/s) [{card}]")
    print(f"  peak device memory of a training step {peak:.2f} GiB [{card}]")
    device_breakdown(lambda: trainer.train_step(batch, 1.0, trainer.generator),
                     card, runs=1, top=12, what="train step", ops=14)

    # CUDA against the CPU plain composition at a reduced batch (2 unique x
    # 2 Siamese, N=2048, full widths, dropout off: the two devices' random
    # streams differ), same weights and batch. Tolerances: losses 1e-3
    # relative; every gradient leaf within 1e-2 of its largest entry plus
    # 1e-4 of the largest over all leaves (cuBLAS and the kernels sum in
    # other orders than the CPU; the conv biases in front of a BN have
    # zero true gradient and rounding-noise computed ones)
    small = dataclasses.replace(cfg.model, head_keep_prob=(None, None, None))
    sub = {k: v[:4] for k, v in batch.items()}
    outs = []
    for dev in ("cuda", "cpu"):
        model = DGCNNSeg(small, seed=1).to(dev)
        total, comps, _ = loss_fn(model, {k: v.to(dev) for k, v in sub.items()},
                                  cfg=cfg, style="Full", bn_decay=0.5, gate=1.0)
        total.backward()
        outs.append(({k: float(v.detach()) for k, v in comps.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (got_c, got_g), (want_c, want_g) = outs
    loss_err = max(abs(got_c[k] - want_c[k]) / abs(want_c[k]) for k in want_c)
    scale = max(v.abs().max().item() for v in want_g.values())
    grad_err = max(((got_g[n] - w).abs().max().item())
                   / (1e-2 * w.abs().max().item() + 1e-4 * scale)
                   for n, w in want_g.items())
    print(f"  CUDA vs CPU plain step, 2 x 2 x {TN} points: losses max rel err "
          f"{loss_err:.2e}; gradients at {grad_err:.3f} of the tolerance")
    require(loss_err <= 1e-3, "CUDA training losses disagree with the CPU")
    require(grad_err <= 1.0, "CUDA gradients disagree with the CPU")


def device_breakdown(fn, card: str, runs: int = 3, top: int = 8,
                     what: str = "e2e", ops: int = 0) -> None:
    """Device time by kernel over ``runs`` calls of ``fn`` (torch.profiler)
    and the device's busy share of the host wall time of those calls;
    with ``ops``, also the ``ops`` PyTorch operators whose kernels took the
    most device time (children included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.self_device_time_total / 1e3 / runs, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA), reverse=True)
    busy_ms = sum(ms for ms, _ in kernels)
    print(f"  {what} device time by kernel, ms per call (torch.profiler, {runs} "
          f"runs) [{card}]: busy {busy_ms:.3f} of {wall_ms / runs:.3f} ms wall "
          f"({100 * busy_ms * runs / wall_ms:.1f}% busy)")
    for ms, name in kernels[:top]:
        print(f"    {ms:9.3f}  {name[:90]}")
    groups = {}
    for ms, name in kernels:
        group = next((g for pattern, g in KERNEL_GROUPS if pattern in name),
                     "other")
        groups[group] = groups.get(group, 0.0) + ms
    print("    by group: " + ", ".join(
        f"{g} {ms:.3f}" for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    if ops:
        aten = sorted(((e.device_time_total / 1e3 / runs, e.count // runs, e.key)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU
                       and e.key.startswith("aten::")), reverse=True)
        print("    operators by device time (children included), ms per call "
              "and calls: " + ", ".join(f"{name} {ms:.3f} x{n}"
                                        for ms, n, name in aten[:ops]))


# device kernels by the kind of work (first match wins)
KERNEL_GROUPS = (
    ("knn_edge_kernel", "B1"), ("conv_zmax", "B7"), ("conv_znmax", "B8"),
    ("knn_kernel", "B12"), ("sqnorm_kernel", "B1/B12 norms"),
    ("scatter_add_kernel", "B13"), ("gemm", "cuBLAS GEMM"),
    ("reduce_kernel", "reductions"), ("elementwise", "elementwise"),
    ("index", "indexing"), ("sort", "sort"))


def phase_build():
    from weaksuppointcloudseg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s) -> {_build.library_path()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} ({card})")
    phase_build()
    report = []
    phase_kernels(report)
    phase_end_to_end(report)
    phase_train(report)
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
