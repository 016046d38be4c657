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
     plain composition at a reduced batch, step time and peak memory;
  5. bf16 Plain-style training through the fused blocks at bench.py's
     shape (32 clouds x 2048 points, k=20, ``knn_fast``): launch counts of
     B1-B5 during ``train_epoch`` + ``evaluate``, the seg loss falling on a
     fixed batch, one fused step CUDA against the CPU plain versions at 2
     clouds with the card's kNN indices and BN moments replayed on the CPU
     (``utils/replay.py``), ``shapenet_plain_train_throughput``, peak
     memory, the device time by kernel and the device's idle share;
  6. bf16 Full-style ShapeNet training through ``cli.train_shapenet`` at
     bench.py's shape (32 unique x 2 Siamese x 2048 points, gate on) on
     phase 5's split: launch counts of B1-B5, B6 (gather and scatter; B9
     must not run: the smoothness loss reuses the transform stage's
     graph) and B7/B8 during one epoch + evaluate, finite losses,
     ``shapenet_full_train_throughput``, peak memory, device time by kernel,
     idle share, and the smoothness-loss block's kernel route against its
     plain route on the CPU at one step's inputs;
  7. bf16 Full-style S3DIS training through ``cli.train_s3dis`` (14 unique
     x 2 x 4096 points) on an S3DIS-format block split the script writes
     (Area_5 for validation): launch counts of B1-B5, B9, B6's scatter and
     B7/B8, finite losses and mIoU, ``s3dis_full_train_throughput``, peak
     memory, device time by kernel, idle share;
  8. the S3DIS test path through ``cli.test_s3dis`` at full width (bf16,
     ``knn_fast``, -bs 14) on a raw test area the script writes (two
     surface-sampled rooms: 8 x 4 x 3 m, 32 blocks = 131,072 room-LP
     points, and 5 x 5 x 3 m, 25 blocks padded to 32), swept on the card
     (RS1 and RS2 launch once a room), per-block LP (B1, B7, B8 launch;
     B10 must not) and ``--RoomLP`` (B10 launches once for the degrees and
     once per CG iteration, per room): finite mIoU, the
     .mat files; then bench.py's ``s3dis_eval_forward_throughput``,
     ``s3dis_test_e2e_throughput`` (14 x 4096 points) and
     ``s3dis_room_lp_131072`` with its CG iterations, peak memory, device
     time by kernel, and the room LP against the CPU on 4096 points.

  9. static-graph mode (``--StaticGraph``): the bf16 Full-style training
     CLIs of ShapeNet (phase 6's shape and split) and S3DIS (phase 7's),
     with the launch counts of one graph per forward (B1 once, B11 in
     every other EdgeConv stage, no B12), ``shapenet_full_train_
     throughput_static_graph`` and ``s3dis_full_train_throughput_static_
     graph`` with peak memory, device time by kernel and idle share; one
     static bf16 step against the CPU replaying the card's graph and
     moments; one f32 static step (B12 once per forward, B13); the
     ShapeNet test CLI with ``--StaticGraph`` (B1 once and B11 three
     times per batch);
 10. convergence: the four synthetic recipes of
     ``utils/synth_convergence.py`` (ShapeNet f32 exact, bf16 fast, bf16
     fast static graph; S3DIS bf16 fast) at the reference's calibrated
     size, held to its bars;
 11. the unfused routes (``use_fused_knn=False``) at full width: the bf16
     eval forwards of ShapeNet (32 x 3000: B14 four times, no B1/B7/B8/B12)
     and S3DIS (14 x 4096: B14 three times); one bf16 Full-style ShapeNet
     step through ``ShapeNetTrainer`` (32 x 2 x 2048: B14 in the forward,
     B13 in the backward, B12 in the smoothness loss) with its time, peak
     memory, device time by kernel and idle share, and against the CPU
     replaying the card's kNN graphs and batch moments; bench.py's
     ``xla_everywhere_baseline`` (the f32 unfused step, exact kNN) and
     ``vs_xla_everywhere`` of the flagship step and both eval forwards;
     ``lp_dense_lu_3000``, ``lp_cg_factored_3000``, ``lp_cg_matfree_3000``
     and ``lp_cg_matfree_32768`` with bench.py's inputs, and the LU against
     an f64 solve; both test CLIs with ``--LPSolver solve`` (the ShapeNet
     loop's ms per batch and idle share with its one-batch lag).

 12. the DGCNN classifier at its published ModelNet40 width (32 clouds x
     1024 points, k=20, edges 64/64/64/128, global 1024, fc 512/256, 40
     classes, keep 0.5, label smoothing 0.2) on learnable synthetic
     clouds: 20 Adam steps on a fixed batch in the bf16 fused (knn_fast),
     bf16 fused static and f32 exact routes with their launch counts,
     falling loss, ms per step, clouds/s, peak memory, device time by
     kernel and idle share; the bf16 eval forward and one bf16 unfused
     step with their launch counts; one bf16 fused step against the CPU
     replaying the card's graphs and moments (8 clouds); B15 where the reference
     routes it (``neighbors.edge_feature_auto``, bf16, ``use_fused``, with
     its B13 backward); one bf16 fused ShapeNet step and eval forward at
     bench.py's shape with a three-conv first EdgeConv stage (B1 in that
     stage, B13 in its backward).

Phase 2 also holds B15 (kNN + row gather) to its plain version and to
B1's graph at the f32 training batch's shape, with B15's and B16's VJPs,
B13, B4 and B6's scatter bit for bit against their plain versions run on
the CPU (a slice of the batch) with the inverse graph they sum over
against its plain version (by both build routes, the cluster build and
the three-launch build, at every scatter's shape, on a hub graph, on
targets outside [0, N) and on S3DIS B4's k=20 graph; B13 at C=3 and 64
and B6's scatter at 51 and 14 channels print their build and gather
device times beside ``index_add_``), two launches of every kernel that
sums (B1-B6, B11, B13) bit for bit equal (ROADMAP C16), B3 on 66
persistent blocks bit for bit B3 on one block per SM (ROADMAP C17),
B14 (the bf16 row gather) to its plain version
bitwise at C=64, 3 and 9, and B10 and B17 (the Gaussian-affinity matvec) to their
plain versions at that room LP's shape, with the share of tile pairs
skipped and the work plan, and B10 on that room with room_label_prop's pad
blocks, B11 (the first conv on a given graph) to B1's output at
B1's own graph and to its plain version at the static stages' shapes,
and the room sweep's RS1 (the bucketing) and RS2 (the gather and
normalisation) to their plain versions bitwise at the room benchmark's
largest room (1,536,576 float64 rows, 8 x 6 blocks, 48 x 4096 picks).
Phases 4, 6, 7, 9 (static ShapeNet) and 12 (bf16 fused classifier) repeat
one training step from the same state and require the same bits in every
loss, gradient, BN statistic and weight (ROADMAP C16), with a diagnostic
step under PyTorch's deterministic mode that names any operator known to
sum in a run-dependent order. Each phase prints its wall seconds.

Prints a JSON line of per-kernel results, then the card's
``name, power.limit`` line, and last ``{"ok": true, "device": ...}``.
Exits non-zero (and prints no result) when CUDA is unavailable or any
phase fails. Never imports JAX.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

B, N, K = 32, 3000, 20  # the ShapeNet test batch (bench.py's eval shape)
TB, TN = 64, 2048  # the Full-style training batch: 32 unique clouds x 2
# ms of the measurements a later phase compares with, in this run
MEASURED = {}


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


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn()`` with the host's launch time
    hidden: ``reps`` calls queued behind a sleep kernel, CUDA events around
    the calls (what the call costs a busy card; ``timed_ms`` also counts
    the host's lead when the card waits for it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, patterns, reps: int = 5):
    """Device time per call of ``fn()`` of the kernels whose names hold
    each of ``patterns`` (torch.profiler over ``reps`` calls), a tuple."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return tuple(sum(e.self_device_time_total for e in events if p in e.key)
                 / 1e3 / reps for p in patterns)


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


def affinity_flops(b: int, n: int, f: int, k: int, ordered: float) -> float:
    """Operations of one Gaussian-affinity matvec (B10/B17) over ``ordered``
    computed (i, j) pairs of b samples of n points: the Gram (2f), the
    distance, clamp and exp (4) once per unordered pair, the diagonal
    included, and the apply (2k) over every ordered pair."""
    return (ordered + b * n) / 2 * (2.0 * f + 4) + ordered * 2.0 * k


def bench_room(n: int, seed: int = 0):
    """bench.py::time_room_lp's room: n points of an 8 x 8 x 3 m room, 70%
    on the floor, the ceiling and walls every 2 m, the rest in the volume;
    rgb uniform; probabilities a softmax of 3x standard-normal logits of 13
    classes. numpy (xyz [1, n, 3], g [1, n, 13], rgb [1, n, 3]) f32."""
    rng = np.random.default_rng(seed)
    room = np.array([8.0, 8.0, 3.0], np.float32)
    n_surf = int(n * 0.7)
    xy = rng.uniform(0, 1, (n_surf, 2)) * room[:2]
    which = rng.integers(0, 4, n_surf)
    z = np.where(which == 0, 0.0, np.where(which == 1, room[2],
                 rng.uniform(0, room[2], n_surf)))
    x = np.where(which == 2, np.round(xy[:, 0] / 2) * 2, xy[:, 0])
    surf = np.stack([x, xy[:, 1], z], -1)
    interior = rng.uniform(0, 1, (n - n_surf, 3)) * room
    xyz = np.concatenate([surf, interior]).astype(np.float32)[None]
    rgb = rng.uniform(0, 1, (1, n, 3)).astype(np.float32)
    logits = rng.standard_normal((1, n, 13)).astype(np.float32) * 3.0
    g = np.exp(logits - logits.max(-1, keepdims=True))
    return xyz, (g / g.sum(-1, keepdims=True)).astype(np.float32), rgb


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


def same_bits(a, b) -> bool:
    """Equal bit for bit on the CPU, NaN payloads aside (a NaN's payload is
    the hardware's choice): the same shape and dtype, the same NaN
    positions, every other element's bits equal (-0 and +0 differ)."""
    import torch

    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.float16: torch.int16, torch.float64: torch.int64}[a.dtype]
    return torch.equal(na, nb) and torch.equal(
        torch.where(na, 0, a).view(ints), torch.where(nb, 0, b).view(ints))


def all_same_bits(xs, ys) -> bool:
    return len(xs) == len(ys) and all(same_bits(x, y) for x, y in zip(xs, ys))


def repeats(fn, what) -> None:
    """Two launches of ``fn()`` (a tensor or a tuple of tensors) give the
    same bits (ROADMAP C16: no float atomics in the kernels)."""
    import torch

    first, second = fn(), fn()
    if torch.is_tensor(first):
        first, second = (first,), (second,)
    same = all_same_bits([t for t in first if t is not None],
                         [t for t in second if t is not None])
    print(f"  {what}: two launches bit for bit equal: {same}")
    require(same, f"{what}: two launches differ")


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
    magnitudes (f32 sums in another order than the plain version's). Two
    launches give the same bits (fixed-order moments, ROADMAP C16).
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
    repeats(lambda: edgeconv.knn_edge(g, v, u, K, fast=True, with_minmax=True),
            f"knn_edge (B1) B={B} N={N} Cg=C=64 fast")
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


def check_knn_edge_pre(gen, report):
    """B11 (the first conv on a given graph) at the static-graph stage
    shapes: ShapeNet training (B=64, N=2048) and S3DIS (B=28, N=4096),
    k=20, C=64, on the graph B1 selects on 3 coordinates (fast mode, as
    the static path's producer). Fed B1's own indices, y1 and the
    k-extrema must equal B1's bit for bit (the same add and one bf16
    rounding) and the plain version's; the moments within 1e-5 of the sum
    of magnitudes (f32 sums in another order); two launches bit for bit
    equal."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import edgeconv

    row, max_err = None, 0.0
    for b, n, what in ((TB, TN, "ShapeNet training"), (RB, RN, "S3DIS")):
        g = bf16_randn(gen, (b, n, 3))
        v = bf16_randn(gen, (b, n, 64))
        u = bf16_randn(gen, (b, n, 64))
        for minmax in (False, True):
            b1 = edgeconv.knn_edge(g, v, u, K, fast=True, with_minmax=minmax)
            idx = b1[0]
            got = edgeconv.knn_edge_pre(idx, v, u, K, with_minmax=minmax)
            ref = edgeconv.knn_edge_pre_ref(idx, v, u, K, with_minmax=minmax)
            torch.cuda.synchronize()
            require(0 <= int(idx.min()) and int(idx.max()) < n,
                    "B1's graph leaves [0, N)")
            y32 = ref[0].float()
            mags = torch.stack([y32.abs().sum((0, 1, 2)),
                                (y32 * y32).sum((0, 1, 2))])
            mom_err = ((got[1] - ref[1]).abs() / mags).max().item()
            max_err = max(max_err, (got[0].float() - y32).abs().max().item())
            same_b1 = torch.equal(got[0], b1[1]) and all(
                torch.equal(a, w) for a, w in zip(got[2:], b1[3:]))
            same_ref = torch.equal(got[0], ref[0]) and all(
                torch.equal(a, w) for a, w in zip(got[2:], ref[2:]))
            print(f"  knn_edge_pre {what} B={b} N={n} k={K} C=64 minmax="
                  f"{minmax}: y1/extrema equal to B1's {same_b1}, to the "
                  f"plain version's {same_ref}; mom rel err {mom_err:.2e}")
            require(same_b1 and same_ref, f"knn_edge_pre {what}: y1 differs")
            require(mom_err <= 1e-5, f"knn_edge_pre {what}: moment error")
        repeats(lambda: edgeconv.knn_edge_pre(idx, v, u, K, with_minmax=True),
                f"knn_edge_pre (B11) {what}")
        ms = timed_ms(lambda: edgeconv.knn_edge_pre(idx, v, u, K))
        plain_ms = timed_ms(lambda: edgeconv.knn_edge_pre_ref(idx, v, u, K),
                            reps=3)
        bi = torch.arange(b, device="cuda")[:, None, None]
        gather_ms = timed_ms(lambda: v[bi, idx.long()] + u[:, :, None, :])
        y, mom = edgeconv.knn_edge_pre(idx, v, u, K)
        # an add, a sum and a square-and-sum in f32 per y1 element; idx, v,
        # u read once, y1 and the moments written once
        bnd = bound(4.0 * y.numel(), "f32", nbytes(idx, v, u, y, mom))
        print(f"  knn_edge_pre {what}: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
              f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}), {100 * bnd[0] / ms:.1f}% "
              f"of bound; aside, not a port: v[bi, idx] + u in PyTorch (no "
              f"rounding, no moments) {gather_ms:.3f} ms")
        row = row or kernel_row(
            "knn_edge_pre (B11)",
            "weaksuppointcloudseg_tpu_torch/ops/csrc/knn_edge_pre.cu",
            "weaksuppointcloudseg_tpu/ops/edgeconv_pallas.py:862", 0.0, ms,
            plain_ms, bnd)
        del g, v, u, b1, got, ref, y32, y
        torch.cuda.empty_cache()
    row["max_abs_err"] = max_err  # y1 against the plain version's
    report.append(row)


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
    scale (fast: the dropped idx_bits of the mantissa). On bf16 points
    widened to f32, the indices and distances equal kernel B1's on the
    same bf16 g bit for bit (the same distance arithmetic and order).
    Besides the bound (the symmetric Gram), the time is set against the
    all-pairs f32 floor: every (i, j) of C FMAs at the f32 peak, the
    arithmetic this kernel does."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import edgeconv, knn

    max_err, times = 0.0, {}
    for c, k, fast in ((3, K, False), (3, K, True), (64, K, False),
                       (64, K, True), (3, 10, False)):
        g = bf16_randn(gen, (TB, TN, c))
        v = bf16_randn(gen, (TB, TN, 8))
        got = knn.knn(g.float(), k, fast=fast, with_values=True)
        b1 = edgeconv.knn_edge(g, v, v, k, fast=fast, with_values=True)
        torch.cuda.synchronize()
        require(torch.equal(got[0], b1[0]) and torch.equal(
            got[1].view(torch.int32), b1[-1].view(torch.int32)),
            f"knn C={c} k={k} fast={fast}: not B1's graph on bf16 points")
        del g, v, got, b1
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
        floor_ms = 2.0 * TB * TN * TN * c / PEAK_FLOPS["f32"] * 1e3
        print(f"  knn B={TB} N={TN} C={c} k={k} fast={fast}: B1's graph on "
              f"bf16 points, index agreement {agree:.6f}, sqd abs err "
              f"{err:.2e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"cdist+topk {pair_ms:.3f} ms, bound {bnd[0]:.3f} ms "
              f"({bnd[1]}), {100 * bnd[0] / ms:.1f}% of bound, "
              f"{100 * floor_ms / ms:.1f}% of the all-pairs f32 floor "
              f"({floor_ms:.3f} ms)")
    ms, plain_ms, bnd = times[(64, K, False)]
    report.append(kernel_row(
        "knn (B12)", "weaksuppointcloudseg_tpu_torch/ops/csrc/knn.cu",
        "weaksuppointcloudseg_tpu/ops/knn_pallas.py:192", max_err, ms,
        plain_ms, bnd))


def check_inverse_graph(idx, n, what):
    """The inverse-graph build against its plain version (a stable sort on
    the card): offsets and sources equal, by the route the shape picks and
    by each build route that takes the shape (the cluster build; the
    three-launch build, which takes every phase-2 shape). Returns (build
    ms, plain ms, bound) of the route the shape picks."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import scatter

    want = scatter.inverse_graph_ref(idx, n)
    b, p, k = idx.shape
    route = scatter.inverse_route(p, k, n)[0]
    times = {}
    for r in (None, "cluster", "chunks"):
        if r == "cluster" and route != "cluster":
            continue
        got = scatter._build_inverse(idx, n, r)
        torch.cuda.synchronize()
        same = torch.equal(got.offsets, want.offsets) and torch.equal(
            got.src, want.src)
        require(same, f"inverse_graph {what} route {r or route}: differs "
                "from its plain version")
        times[r or route] = device_ms(lambda: scatter._build_inverse(idx, n, r))
    ms = timed_ms(lambda: scatter.inverse_graph(idx, n))
    plain_ms = timed_ms(lambda: scatter.inverse_graph_ref(idx, n))
    # idx read once, offsets and src written once; integer work only
    bnd = bound(0.0, "f32", nbytes(idx, want.offsets, want.src))
    print(f"  inverse_graph B={b} P={p} k={k} N={n} ({what}): {route} route "
          f"picked; every route bit for bit the plain version; with the "
          f"host's launches hidden " + ", ".join(
              f"{r} {t:.4f} ms" for r, t in times.items())
          + f"; picked {ms:.4f} ms between events, plain {plain_ms:.3f} ms, "
          f"bound {bnd[0]:.4f} ms")
    return ms, plain_ms, bnd


def check_scatter_add(gen, report):
    """B13 at the training path's shapes (the backward of the stage
    gathers: B=64, P=N=2048, k=20, C=64 and C=3), with the inverse graph
    it sums over.

    Checks: the inverse equals its plain version, by each build route
    that takes the shape, here and on a hub graph, on targets outside
    [0, N) and on S3DIS B4's k=20 graph (B=28, N=4096); two launches give
    the same bits; on a slice of the batch (B=4) the kernel equals the plain
    version run on the CPU bit for bit (both sum each row in ascending
    slot order); at the full shape each element within 1e-5 of the sum of
    magnitudes that reach it (ROADMAP C4, kept). Times: the kernel with its
    inverse build (what a scatter costs), the build alone, and the device
    time of each of the two within the scatter (torch.profiler)."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import scatter

    max_err, times = 0.0, {}
    for c in (64, 3):
        idx = torch.randint(0, TN, (TB, TN, K), generator=gen, device="cuda",
                            dtype=torch.int32)
        g = torch.randn((TB, TN, K, c), generator=gen, device="cuda")
        inv_ms, inv_plain_ms, inv_bnd = check_inverse_graph(idx, TN, f"C={c}")
        got = scatter.scatter_add(idx, g, TN)
        want = scatter.scatter_add_ref(idx, g, TN)
        mags = scatter.scatter_add_ref(idx, g.abs(), TN)
        torch.cuda.synchronize()
        err = (got - want).abs()
        require(bool((err <= 1e-5 * mags + 1e-6).all()),
                f"scatter_add C={c}: {err.max().item()}")
        max_err = max(max_err, err.max().item())
        cpu = same_bits(scatter.scatter_add(idx[:4].contiguous(),
                                            g[:4].contiguous(), TN),
                        scatter.scatter_add_ref(idx[:4].cpu(), g[:4].cpu(), TN))
        print(f"  scatter_add (B13) C={c}: B=4 slice bit for bit the plain "
              f"version on the CPU: {cpu}")
        require(cpu, f"scatter_add C={c}: differs from the CPU plain version")
        repeats(lambda: scatter.scatter_add(idx, g, TN),
                f"scatter_add (B13) B={TB} C={c}")
        ms = timed_ms(lambda: scatter.scatter_add(idx, g, TN))
        dev_ms = device_ms(lambda: scatter.scatter_add(idx, g, TN))
        split = kernel_device_ms(lambda: scatter.scatter_add(idx, g, TN),
                                 ("inverse_", "csr_gather"))
        plain_ms = timed_ms(lambda: scatter.scatter_add_ref(idx, g, TN))
        rows = scatter._flat_rows(idx, TN)
        flat = g.reshape(-1, c)
        out = torch.zeros((TB * TN, c), device="cuda")
        lib_ms = timed_ms(lambda: out.index_add_(0, rows, flat))
        lib_dev_ms = device_ms(lambda: out.index_add_(0, rows, flat))
        bnd = bound(float(g.numel()), "f32", nbytes(idx, g, got))
        times[c] = (ms, plain_ms, bnd, lib_ms)
        MEASURED[f"scatter_add_c{c}"] = ms
        print(f"  scatter_add B={TB} P=N={TN} k={K} C={c}: max abs err "
              f"{err.max().item():.2e}; kernel {ms:.3f} ms with its inverse "
              f"build (on the device {split[1]:.4f} ms gather, "
              f"{split[0]:.4f} ms build; the build alone "
              f"{inv_ms:.3f} ms, its plain version "
              f"{inv_plain_ms:.3f} ms, its bound {inv_bnd[0]:.4f} ms), plain "
              f"{plain_ms:.3f} ms, index_add_ {lib_ms:.3f} ms, bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}), {100 * bnd[0] / ms:.1f}% of bound; "
              f"with the host's launches hidden (device_ms): kernel "
              f"{dev_ms:.4f} ms, index_add_ {lib_dev_ms:.4f} ms")
        times[f"inv{c}"] = (inv_ms, inv_plain_ms, inv_bnd)
    # the build on the graphs that stress it, at the training batch's shape,
    # and on S3DIS B4's k=20 graph (a generator of their own: the later
    # checks' inputs stay as they were)
    own = torch.Generator(device="cuda")
    own.manual_seed(1)
    hubs = torch.arange(K, dtype=torch.int32, device="cuda").expand(
        TB, TN, K).contiguous()
    check_inverse_graph(hubs, TN, "hubs: an all-equal cloud's graph")
    idx = torch.randint(0, TN, (TB, TN, K), generator=own, device="cuda",
                        dtype=torch.int32)
    drop = torch.rand((TB, TN, K), generator=own, device="cuda") < 0.05
    check_inverse_graph(torch.where(drop, TN + 3, idx).int(), TN,
                        "5% of targets outside [0, N)")
    check_inverse_graph(torch.randint(0, RN, (RB, RN, K), generator=own,
                                      device="cuda", dtype=torch.int32),
                        RN, "S3DIS B4's k=20 graph")
    ms, plain_ms, bnd, lib_ms = times[64]
    report.append(kernel_row(
        "scatter_add (B13)", "weaksuppointcloudseg_tpu_torch/ops/csrc/scatter_add.cu",
        "weaksuppointcloudseg_tpu/ops/scatter_pallas.py:358", max_err, ms,
        plain_ms, bnd, library_ms=lib_ms))
    report.append(kernel_row(
        "inverse_graph (B13/B4/B6)",
        "weaksuppointcloudseg_tpu_torch/ops/csrc/scatter_add.cu",
        "weaksuppointcloudseg_tpu/ops/scatter_pallas.py:358", 0.0,
        *times["inv64"]))


def check_gather_rows(gen, report):
    """B14 against its plain version (indexing), bitwise, at the unfused
    bf16 route's shapes: B=64 clouds of N=2048 points, k=20, with C=64
    (stages 1-2) and C=3 (the transform net and stage 0 of ShapeNet), and
    S3DIS's stage 0, B=28 blocks of N=4096 points with C=9. The library
    yardstick is ``f[bi, idx]`` with the int64 indices ready."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import gather

    times = {}
    for b, n, c in ((TB, TN, 64), (TB, TN, 3), (RB, RN, 9)):
        f = bf16_randn(gen, (b, n, c))
        idx = torch.randint(0, n, (b, n, K), generator=gen, device="cuda",
                            dtype=torch.int32)
        got = gather.gather_rows(f, idx)
        want = gather.gather_rows_ref(f, idx)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                f"gather_rows B={b} N={n} C={c}: not bitwise equal")
        ms = timed_ms(lambda: gather.gather_rows(f, idx))
        plain_ms = timed_ms(lambda: gather.gather_rows_ref(f, idx))
        bi = torch.arange(b, device="cuda")[:, None, None]
        idx64 = idx.long()
        lib_ms = timed_ms(lambda: f[bi, idx64])
        bnd = bound(0.0, "bf16", nbytes(f, idx, got))
        times[c] = (ms, plain_ms, bnd, lib_ms)
        print(f"  gather_rows B={b} N={n} k={K} C={c}: bitwise equal; kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, f[bi, idx] {lib_ms:.4f} "
              f"ms, bound {bnd[0]:.4f} ms ({bnd[1]}), {100 * bnd[0] / ms:.1f}% "
              f"of bound")
    ms, plain_ms, bnd, lib_ms = times[64]
    report.append(kernel_row(
        "gather_rows (B14)", "weaksuppointcloudseg_tpu_torch/ops/csrc/gather_rows.cu",
        "weaksuppointcloudseg_tpu/ops/gather_pallas.py:64", 0.0, ms, plain_ms,
        bnd, library_ms=lib_ms))


def check_knn_gather(gen, report):
    """B15 (kNN + neighbour-row gather) against its plain version at the
    f32 training batch's shape (B=64, N=2048, k=20) with Cg=Cf=64 and
    Cg=Cf=3, bf16, exact and fast, with and without the distances.

    Tolerances: indices by agreement rate (>= 99.9% exact, >= 98% fast,
    as B12: another summation order than cuBLAS's); the rows bitwise and
    the distances against the plain formula (1e-5 of the distance scale;
    fast: the dropped idx_bits) at the kernel's own indices; the indices
    and distances bitwise B1's on the same g (the same distance pass and
    selection). The library yardstick: cdist + topk + indexing, three
    calls with no tie order."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import edgeconv, gather, knn
    from weaksuppointcloudseg_tpu_torch.ops import knn_gather as kg

    max_err, times = 0.0, {}
    for c in (64, 3):
        g = bf16_randn(gen, (TB, TN, c))
        f = bf16_randn(gen, (TB, TN, c))
        for fast in (False, True):
            idx, nbr, sqd = kg.knn_gather_with_sqdist(g, f, K, fast=fast)
            i2, n2 = kg.knn_gather(g, f, K, fast=fast)
            b1 = edgeconv.knn_edge(g, f, f, K, fast=fast, with_values=True)
            want = kg.knn_gather_ref(g, f, K, fast=fast)[0]
            torch.cuda.synchronize()
            agree = (idx == want).float().mean().item()
            require(agree >= (0.98 if fast else 0.999),
                    f"knn_gather C={c} fast={fast}: index agreement {agree}")
            require(torch.equal(i2, idx) and torch.equal(n2, nbr),
                    f"knn_gather C={c} fast={fast}: with_values changes the "
                    "outputs")
            require(torch.equal(idx, b1[0]) and torch.equal(sqd, b1[-1]),
                    f"knn_gather C={c} fast={fast}: not B1's graph")
            require(torch.equal(nbr.view(torch.int16), gather.gather_rows_ref(
                f, idx).view(torch.int16)), f"knn_gather C={c}: rows differ")
            d = knn.distances(g)
            d_sel = torch.gather(d, 2, idx.long())
            if fast:
                d_sel = d_sel.clamp_min(0.0)
            scale = d.abs().amax().item()
            err = (sqd - d_sel).abs().max().item()
            tol = scale * (2.0 ** (knn.idx_bits(TN) - 23) if fast else 1e-5)
            require(err <= tol, f"knn_gather C={c} fast={fast}: sqd {err}")
            del d, d_sel, want, b1
            max_err = max(max_err, err)
            ms = timed_ms(lambda: kg.knn_gather(g, f, K, fast=fast))
            ms_v = timed_ms(lambda: kg.knn_gather_with_sqdist(g, f, K,
                                                              fast=fast))
            plain_ms = timed_ms(lambda: kg.knn_gather_ref(g, f, K, fast=fast),
                                reps=3)
            g32 = g.float()
            bi = torch.arange(TB, device="cuda")[:, None, None]
            lib_ms = timed_ms(lambda: f[bi, torch.topk(
                torch.cdist(g32, g32), K, dim=-1, largest=False).indices])
            del g32
            bnd = bound(2.0 * gram_pairs(TB, TN) * c, "bf16",
                        nbytes(g, f, idx, nbr))
            times[(c, fast)] = (ms, plain_ms, bnd, lib_ms)
            print(f"  knn_gather (B15) B={TB} N={TN} Cg=Cf={c} k={K} "
                  f"fast={fast}: index agreement {agree:.6f}, B1's graph, rows "
                  f"bitwise, sqd abs err {err:.2e}; kernel {ms:.3f} ms (with "
                  f"sqd {ms_v:.3f}), plain {plain_ms:.3f} ms, cdist+topk+"
                  f"indexing {lib_ms:.3f} ms, bound {bnd[0]:.4f} ms "
                  f"({bnd[1]}), {100 * bnd[0] / ms:.1f}% of bound")
    ms, plain_ms, bnd, lib_ms = times[(64, False)]
    report.append(kernel_row(
        "knn_gather (B15)", "weaksuppointcloudseg_tpu_torch/ops/csrc/knn_gather.cu",
        "weaksuppointcloudseg_tpu/ops/edgeconv_pallas.py:286", max_err, ms,
        plain_ms, bnd, library_ms=lib_ms))
    torch.cuda.empty_cache()


def check_vjps(gen):
    """B15's VJP (df: B13's scatter of the rows' cotangent) and B16's
    (knn_edge_gather: B1 forward; dy_eff, du and dv through B13) on the
    card against their plain versions on the CPU at the kernel's own
    indices, at the three-conv stage's shape (Cg=3, C=64, k=20) for 8
    clouds of 2048 points. Tolerances: df within 1e-5 of the scattered
    magnitudes plus one bf16 ulp of the rounded sum (ROADMAP C4); y1
    bitwise; du within one bf16 ulp; dv within one ulp plus 1e-4 (as
    tests/test_torch_cuda.py)."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import edgeconv, scatter
    from weaksuppointcloudseg_tpu_torch.ops import knn_gather as kg

    b, c = 8, 64
    g = bf16_randn(gen, (b, TN, 3))
    f = bf16_randn(gen, (b, TN, c)).requires_grad_()
    ct = bf16_randn(gen, (b, TN, K, c))
    idx, nbr = kg.knn_gather(g, f, K)
    nbr.backward(ct)
    want = scatter.scatter_add_ref(idx.cpu(), ct.float().cpu(), TN)
    mags = scatter.scatter_add_ref(idx.cpu(), ct.float().abs().cpu(), TN)
    df_err = ((f.grad.float().cpu() - want).abs()
              / (1e-5 * mags + 2.0 ** -8 * want.abs() + 1e-6)).max().item()
    require(df_err <= 1.0, f"B15's VJP: df {df_err:.3f} of its tolerance")
    v, u = bf16_randn(gen, (b, TN, c)), bf16_randn(gen, (b, TN, c))
    dmom = torch.randn((2, c), generator=gen, device="cuda") * 0.1
    vv, uu = v.clone().requires_grad_(), u.clone().requires_grad_()
    idx, y, mom = edgeconv.knn_edge_gather(g, vv, uu, K, fast=True)
    torch.autograd.backward((y, mom), (ct, dmom))
    vp, up = v.cpu().requires_grad_(), u.cpu().requires_grad_()
    yp, mp = edgeconv.knn_edge_gather_pre(idx.cpu(), vp, up, K)
    torch.autograd.backward((yp, mp), (ct.cpu(), dmom.cpu()))
    du_c, du_p = uu.grad.float().cpu(), up.grad.float()
    dv_c, dv_p = vv.grad.float().cpu(), vp.grad.float()
    du_err = ((du_c - du_p).abs() / (2.0 ** -7 * du_p.abs() + 1e-6)).max().item()
    dv_err = ((dv_c - dv_p).abs() / (2.0 ** -7 * dv_p.abs() + 1e-4)).max().item()
    require(torch.equal(y.cpu(), yp) and du_err <= 1.0 and dv_err <= 1.0,
            f"B16's VJP: du {du_err:.3f}, dv {dv_err:.3f} of the tolerance")
    print(f"  VJPs, {b} x {TN} points, Cg=3, C={c}, k={K}: B15's df "
          f"{df_err:.3f} of its tolerance; B16's (knn_edge_gather, fast) y1 "
          f"bitwise, du {du_err:.3f} and dv {dv_err:.3f} of theirs")


PB, PN = 32, 2048  # the Plain-style bf16 training batch (bench.py:443-452)


def sum_err(got, want, mags):
    """Largest |got - want| as a fraction of the sum of magnitudes that
    reaches each element (the tolerance of f32 sums in another order)."""
    return ((got.float() - want.float()).abs() / (mags + 1e-12)).max().item()


def bf16_err(got, want, rel=2.0 ** -7):
    """Largest |got - want| in units of ``rel`` * |want| (+1e-6): <= 1 is
    within one bf16 ulp of the reference value."""
    return ((got.float() - want.float()).abs()
            / (rel * want.float().abs() + 1e-6)).max().item()


def check_conv_minmax(gen, report):
    """B2 against conv_minmax_ref at the stage shapes (conv2 64->64 of the
    EdgeConv stages, 64->128 of the transform stage) with the BN1 fold.

    Tolerances: f32 sums in another order can put y one bf16 ulp away, so
    the extrema within one ulp (2^-7 relative), the plain y at the
    kernel's slot equal to the kernel's extremum within an ulp, slots
    agreeing on >= 99%; the moments (f32 sums in another order) within
    1e-5 of the sums of magnitudes (ROADMAP C4); two launches bit for bit
    equal."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import conv_kmax

    max_err, times = 0.0, {}
    for c2 in (64, 128):
        h1 = bf16_randn(gen, (PB, PN, K, 64))
        w2 = bf16_randn(gen, (64, c2), 0.2)
        b2 = torch.randn(c2, generator=gen, device="cuda") * 0.1
        sc1, sh1 = _bn_fold(gen, 64)
        got = conv_kmax.conv_minmax(h1, w2, b2, sc1, sh1)
        want = conv_kmax.conv_minmax_ref(h1, w2, b2, sc1, sh1)
        y = (torch.matmul(conv_kmax._act(h1, sc1, sh1), w2.float()) + b2).to(
            torch.bfloat16).float()
        mags = torch.stack([y.abs().sum((0, 1, 2)), (y * y).sum((0, 1, 2))])
        torch.cuda.synchronize()
        ext = max(bf16_err(got[0], want[0]), bf16_err(got[2], want[2]))
        slot = max(bf16_err(torch.gather(y, 2, a.long()[:, :, None])[:, :, 0], e)
                   for a, e in ((got[1], got[0]), (got[3], got[2])))
        agree = (got[1] == want[1]).float().mean().item()
        mom = sum_err(got[4], want[4], mags)
        del y
        require(ext <= 1 and slot <= 1 and agree >= 0.99 and mom <= 1e-5,
                f"conv_minmax 64->{c2}: extrema {ext}, slots {slot}/{agree}, "
                f"moments {mom}")
        max_err = max(max_err, (got[0].float() - want[0].float()).abs().max().item())
        repeats(lambda: conv_kmax.conv_minmax(h1, w2, b2, sc1, sh1),
                f"conv_minmax (B2) 64->{c2}")
        ms = timed_ms(lambda: conv_kmax.conv_minmax(h1, w2, b2, sc1, sh1))
        plain_ms = timed_ms(lambda: conv_kmax.conv_minmax_ref(h1, w2, b2, sc1, sh1))
        bnd = bound(2.0 * PB * PN * K * 64 * c2, "bf16",
                    nbytes(h1, w2, b2, sc1, sh1, *got))
        times[c2] = (ms, plain_ms, bnd)
        print(f"  conv_minmax B={PB} N={PN} k={K} 64->{c2} fold: extrema "
              f"{ext:.2f} ulp, slot agreement {agree:.6f}, moments "
              f"{mom:.2e} of the magnitudes; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}), "
              f"{100 * bnd[0] / ms:.1f}% of bound")
    ms, plain_ms, bnd = times[64]
    report.append(kernel_row(
        "conv_minmax (B2)", "weaksuppointcloudseg_tpu_torch/ops/csrc/conv_kmax.cu",
        "weaksuppointcloudseg_tpu/ops/conv_kmax_pallas.py:194", max_err, ms,
        plain_ms, bnd))


def check_conv_kmax_bwd(gen, report):
    """B3 against conv_kmax_bwd_ref at the stage shapes (C1=64, C2=64 and
    128, the BN1 fold on). Tolerances: dz within one bf16 ulp of the plain
    value (+1e-5 of the largest: f32 sums in another order, then one
    rounding); T_sp, G and S1 (sums of 1.3M terms, per partial row and
    then over the rows in index order) within 1e-5 of the sums of magnitudes of the
    exact (f64) sums, which the plain version's f32 einsum misses by more
    (1.5e-5 for G); (a1, a2) within 1e-5 of the sums of magnitudes of the
    plain ones; two launches bit for bit equal, and a launch on 66
    persistent blocks bit for bit the launch on one per SM (ROADMAP
    C17)."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import conv_kmax

    max_err, times = 0.0, {}
    for c2 in (64, 128):
        y1 = bf16_randn(gen, (PB, PN, K, 64))
        q = torch.randn((PB, PN, c2), generator=gen, device="cuda") * 0.1
        asel = torch.randint(0, K, (PB, PN, c2), generator=gen, device="cuda",
                             dtype=torch.int32)
        w2t = bf16_randn(gen, (c2, 64), 0.2)
        m = bf16_randn(gen, (64, 64), 0.05)
        row0 = torch.randn(64, generator=gen, device="cuda") * 0.01
        sc1, sh1 = _bn_fold(gen, 64)
        mean1 = torch.randn(64, generator=gen, device="cuda") * 0.1
        inv1 = torch.rand(64, generator=gen, device="cuda") + 0.5
        args = (y1, q, asel, w2t, m, row0, sc1, sh1, mean1, inv1)
        got = conv_kmax.conv_kmax_bwd(*args)
        want = conv_kmax.conv_kmax_bwd_ref(*args)
        torch.cuda.synchronize()
        scale = want[0].float().abs().max().item()
        dz_err = ((got[0].float() - want[0].float()).abs()
                  / (2.0 ** -7 * want[0].float().abs() + 1e-5 * scale)).max().item()
        h = conv_kmax._act(y1, sc1, sh1).double()
        onek = asel[:, :, None, :] == torch.arange(K, device="cuda")[:, None]
        dq = torch.where(onek, q.to(torch.bfloat16).double()[:, :, None, :], 0.0)
        exact = (torch.einsum("bnji,bnjc->ic", h, dq),
                 torch.einsum("bnji,bnjl->il", h, h), h.sum((0, 1, 2)))
        mags = (torch.einsum("bnji,bnjc->ic", h.abs(), dq.abs()),
                torch.einsum("bnji,bnjl->il", h.abs(), h.abs()),
                h.abs().sum((0, 1, 2)))
        del h, onek, dq
        dz = want[0].float().abs()
        xhat = (y1.float().abs() + mean1.abs()) * inv1
        sums = max(
            *(sum_err(g.double(), e, m) for g, e, m in zip(got[1:4], exact, mags)),
            sum_err(got[4], want[4], torch.stack([dz.sum((0, 1, 2)),
                                                  (dz * xhat).sum((0, 1, 2))])))
        del dz, xhat
        require(dz_err <= 1 and sums <= 1e-5,
                f"conv_kmax_bwd C2={c2}: dz {dz_err}, sums {sums}")
        max_err = max(max_err, (got[0].float() - want[0].float()).abs().max().item())
        repeats(lambda: conv_kmax.conv_kmax_bwd(*args),
                f"conv_kmax_bwd (B3) 64x{c2}")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        grids = all_same_bits(conv_kmax._kmax_bwd(*args, grid=66), got)
        print(f"  conv_kmax_bwd (B3) 64x{c2}: 66 blocks and {sms} (one per "
              f"SM) bit for bit equal: {grids}")
        require(grids, f"conv_kmax_bwd 64x{c2}: the sums depend on the grid")
        ms = timed_ms(lambda: conv_kmax.conv_kmax_bwd(*args))
        plain_ms = timed_ms(lambda: conv_kmax.conv_kmax_bwd_ref(*args), reps=3)
        r = PB * PN * K
        # dense: G and h @ M; routed: one slot per (point, channel) in
        # T_sp and in Dq @ W2^T
        flops = 2.0 * r * 64 * 64 * 2 + 2.0 * PB * PN * c2 * 64 * 2
        bnd = bound(flops, "bf16", nbytes(*args, *got))
        times[c2] = (ms, plain_ms, bnd)
        print(f"  conv_kmax_bwd B={PB} N={PN} k={K} 64x{c2} fold: dz "
              f"{dz_err:.2f} of its tolerance, sums {sums:.2e} of the "
              f"magnitudes; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
              f"{bnd[0]:.3f} ms ({bnd[1]}), {100 * bnd[0] / ms:.1f}% of bound")
    ms, plain_ms, bnd = times[64]
    report.append(kernel_row(
        "conv_kmax_bwd (B3)", "weaksuppointcloudseg_tpu_torch/ops/csrc/conv_kmax_bwd.cu",
        "weaksuppointcloudseg_tpu/ops/conv_kmax_pallas.py:592", max_err, ms,
        plain_ms, bnd))


def check_scatter_bn_bwd(gen, report):
    """B4 against scatter_bn_bwd_ref at the stage shape (B=32, P=N=2048,
    k=20, C=64), dense (the two-conv stages) and sparse (the single-conv
    stage). On a slice of the batch (B=4) dv and du equal the plain version
    run on the CPU bit for bit (dv sums each row over the inverse graph in
    ascending slot order, du each point's slots in order); two launches
    give the same bits; at the full shape the tolerances of ROADMAP C4,
    kept: du 1e-6 of the magnitudes, dv 1e-5 of the sums of magnitudes.
    The kernel's time includes its inverse build."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import scatter

    max_err, times = 0.0, {}
    idx = torch.randint(0, PN, (PB, PN, K), generator=gen, device="cuda",
                        dtype=torch.int32)
    y = bf16_randn(gen, (PB, PN, K, 64))
    sv, al, be = (torch.randn(64, generator=gen, device="cuda") * 0.1
                  for _ in range(3))
    inv_ms = check_inverse_graph(idx, PN, "B4's graph")[0]
    for sparse in (False, True):
        if sparse:
            q = torch.randn((PB, PN, 64), generator=gen, device="cuda") * 0.1
            asel = torch.randint(0, K, (PB, PN, 64), generator=gen,
                                 device="cuda", dtype=torch.int32)
            big = (q, asel)
            first = torch.where(asel[:, :, None, :] == torch.arange(
                K, device="cuda")[:, None], q[:, :, None, :], 0.0)
        else:
            big = bf16_randn(gen, (PB, PN, K, 64))
            first = sv * big.float()
        dv, du = scatter.scatter_bn_bwd(idx, y, big, sv, al, be, PN)
        want_dv, want_du = scatter.scatter_bn_bwd_ref(idx, y, big, sv, al, be, PN)
        mag = first.abs() + al.abs() + (be * y.float()).abs()
        torch.cuda.synchronize()
        du_err = sum_err(du, want_du, mag.sum(2))
        dv_err = sum_err(dv, want_dv, scatter.scatter_add_ref(idx, mag, PN))
        del mag, first
        require(du_err <= 1e-6 and dv_err <= 1e-5,
                f"scatter_bn_bwd sparse={sparse}: du {du_err}, dv {dv_err}")
        part = (big[0][:4].contiguous(), big[1][:4].contiguous()) if sparse \
            else big[:4].contiguous()
        cpu = all_same_bits(
            scatter.scatter_bn_bwd(idx[:4].contiguous(), y[:4].contiguous(),
                                   part, sv, al, be, PN),
            scatter.scatter_bn_bwd_ref(
                idx[:4].cpu(), y[:4].cpu(),
                tuple(t.cpu() for t in part) if sparse else part.cpu(),
                sv.cpu(), al.cpu(), be.cpu(), PN))
        print(f"  scatter_bn_bwd (B4) {'sparse' if sparse else 'dense'}: B=4 "
              f"slice bit for bit the plain version on the CPU: {cpu}")
        require(cpu, f"scatter_bn_bwd sparse={sparse}: differs from the CPU")
        repeats(lambda: scatter.scatter_bn_bwd(idx, y, big, sv, al, be, PN),
                f"scatter_bn_bwd (B4) B={PB} {'sparse' if sparse else 'dense'}")
        max_err = max(max_err, (dv - want_dv).abs().max().item(),
                      (du - want_du).abs().max().item())
        ms = timed_ms(lambda: scatter.scatter_bn_bwd(idx, y, big, sv, al, be, PN))
        plain_ms = timed_ms(lambda: scatter.scatter_bn_bwd_ref(
            idx, y, big, sv, al, be, PN))
        ins = (idx, y, *(big if sparse else (big, sv)), al, be)
        bnd = bound(5.0 * y.numel(), "f32", nbytes(*ins, dv, du))
        times[sparse] = (ms, plain_ms, bnd)
        dev_ms = device_ms(lambda: scatter.scatter_bn_bwd(
            idx, y, big, sv, al, be, PN))
        print(f"  scatter_bn_bwd B={PB} P=N={PN} k={K} C=64 "
              f"{'sparse' if sparse else 'dense'}: du {du_err:.2e}, dv "
              f"{dv_err:.2e} of the magnitudes; kernel {ms:.3f} ms ({dev_ms:.3f} "
              f"with the host's launches hidden; its inverse build alone "
              f"{inv_ms:.4f} ms), plain "
              f"{plain_ms:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}), "
              f"{100 * bnd[0] / ms:.1f}% of bound")
    ms, plain_ms, bnd = times[False]
    report.append(kernel_row(
        "scatter_bn_bwd (B4)", "weaksuppointcloudseg_tpu_torch/ops/csrc/scatter_bn.cu",
        "weaksuppointcloudseg_tpu/ops/scatter_pallas.py:229", max_err, ms,
        plain_ms, bnd))


def on_grid(gen, shape, scale, step, lim):
    """Normal values rounded to multiples of ``step``, at most ``lim``
    steps from 0 (f32)."""
    import torch

    x = torch.randn(shape, generator=gen, device="cuda") * (scale / step)
    return x.round().clamp(-lim, lim) * step


def ints(gen, shape, lo, hi):
    """Small integers as f32."""
    import torch

    return torch.randint(lo, hi, shape, generator=gen, device="cuda").float()


def nmax_bwd_errors(out, h, q, asel, w, b, al, be):
    """conv_nmax_bwd's (dh, dW, db) against their exact (f64) values at the
    plain version's bf16(dy), each as the largest fraction of its limit:
    dh one bf16 ulp plus 1e-5 of the sum of its terms' magnitudes, dW and
    db 1e-5 of theirs, the magnitudes those of the true cotangent (q at its
    row only). Valid where y = h @ W + b is exact in f32 in any order, so
    that the kernel rounds the same y, and bf16(dy), as the plain version."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import conv_kmax

    dy, dyc = conv_kmax.nmax_bwd_cotangent(h, q, asel, w, b, al, be)
    h64, w64, d64 = h.double(), w.double(), dyc.double()
    dh = d64 @ w64.t()
    lims = (2.0 ** -7 * dh.abs() + 1e-5 * (d64.abs() @ w64.abs().t()),
            1e-5 * torch.einsum("bni,bno->io", h64.abs(), d64.abs()),
            1e-5 * dy.double().abs().sum((0, 1)))
    exact = (dh, torch.einsum("bni,bno->io", h64, d64), dy.double().sum((0, 1)))
    return [((o.double() - x).abs() / (lim + 1e-300)).max().item()
            for o, x, lim in zip(out, exact, lims)]


def check_conv_nmax(gen, report):
    """B5 forward and backward against their plain versions at 128->1024
    (tconv3) and 192->1024 (agg_conv), B=32, N=2048.

    Forward tolerances as B2's (extrema one bf16 ulp, the plain y at the
    kernel's row equal to its extremum within an ulp, moments 1e-5 of the
    magnitudes). Backward on two inputs: small integers, where every sum
    is exact and the kernel must equal its plain version bitwise (which
    pins the rounding of dy to bf16 before the products); and grid inputs
    (h on a 2^-7 grid below 2, W on a 2^-6 grid, b on their products'
    2^-13 grid), where y is exact in f32 in any order and
    :func:`nmax_bwd_errors` holds every output to its exact value. Two
    launches of each give the same bits (fixed-order sums)."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import conv_kmax

    bf16 = torch.bfloat16
    errs, times = [0.0, 0.0], {}
    for c1 in (128, 192):
        h = bf16_randn(gen, (PB, PN, c1))
        w = bf16_randn(gen, (c1, 1024), 0.1)
        b = torch.randn(1024, generator=gen, device="cuda") * 0.1
        got = conv_kmax.conv_nmax(h, w, b)
        want = conv_kmax.conv_nmax_ref(h, w, b)
        y = (torch.matmul(h.float(), w.float()) + b).to(torch.bfloat16).float()
        torch.cuda.synchronize()
        ext = max(bf16_err(got[0], want[0]), bf16_err(got[2], want[2]))
        row = max(bf16_err(torch.gather(y, 1, a.long()[:, None])[:, 0], e)
                  for a, e in ((got[1], got[0]), (got[3], got[2])))
        mom = sum_err(got[4], want[4], torch.stack([y.abs().sum((0, 1)),
                                                    (y * y).sum((0, 1))]))
        require(ext <= 1 and row <= 1 and mom <= 1e-5,
                f"conv_nmax {c1}->1024: extrema {ext}, rows {row}, moments {mom}")
        errs[0] = max(errs[0], (got[0] - want[0]).abs().max().item())
        del y
        hi = ints(gen, (PB, PN, c1), 0, 2).to(bf16)
        wi = ints(gen, (c1, 1024), -1, 2).to(bf16)
        be = torch.tensor([-0.5, 0.25, 1.0], device="cuda")[
            torch.randint(0, 3, (1024,), generator=gen, device="cuda")]
        iargs = (hi, ints(gen, (PB, 1024), -3, 4), got[1], wi,
                 ints(gen, (1024,), -3, 4), ints(gen, (1024,), -3, 4), be)
        bitwise = all(torch.equal(g, w_) for g, w_ in zip(
            conv_kmax.conv_nmax_bwd(*iargs), conv_kmax.conv_nmax_bwd_ref(*iargs)))
        del hi, iargs
        bargs = (on_grid(gen, (PB, PN, c1), 1.0, 2.0 ** -7, 255).to(bf16),
                 torch.randn((PB, 1024), generator=gen, device="cuda") * 0.1,
                 got[1], on_grid(gen, (c1, 1024), 0.1, 2.0 ** -6, 127).to(bf16),
                 on_grid(gen, (1024,), 0.1, 2.0 ** -13, 2 ** 13),
                 *(torch.randn(1024, generator=gen, device="cuda") * 0.01
                   for _ in range(2)))
        gb = conv_kmax.conv_nmax_bwd(*bargs)
        wb = conv_kmax.conv_nmax_bwd_ref(*bargs)
        dh_err, dw_err, db_err = nmax_bwd_errors(gb, *bargs)
        require(bitwise, f"conv_nmax_bwd {c1}->1024: not bitwise on integers")
        require(max(dh_err, dw_err, db_err) <= 1,
                f"conv_nmax_bwd {c1}->1024: dh {dh_err}, dW {dw_err}, db {db_err}")
        errs[1] = max(errs[1], (gb[1] - wb[1]).abs().max().item())
        repeats(lambda: conv_kmax.conv_nmax(h, w, b),
                f"conv_nmax (B5) {c1}->1024")
        repeats(lambda: conv_kmax.conv_nmax_bwd(*bargs),
                f"conv_nmax_bwd (B5) {c1}->1024")
        fwd = (timed_ms(lambda: conv_kmax.conv_nmax(h, w, b)),
               timed_ms(lambda: conv_kmax.conv_nmax_ref(h, w, b)),
               bound(2.0 * PB * PN * c1 * 1024, "bf16", nbytes(h, w, b, *got)))
        bwd = (timed_ms(lambda: conv_kmax.conv_nmax_bwd(*bargs)),
               timed_ms(lambda: conv_kmax.conv_nmax_bwd_ref(*bargs)),
               bound(3 * 2.0 * PB * PN * c1 * 1024, "bf16", nbytes(*bargs, *gb)))
        times[c1] = (fwd, bwd)
        for what, (ms, plain_ms, bnd), note in (
                ("conv_nmax", fwd, f"extrema {ext:.2f} ulp, moments {mom:.2e}"),
                ("conv_nmax_bwd", bwd, f"integers bitwise; grid: dh {dh_err:.3f}, "
                 f"dW {dw_err:.3f}, db {db_err:.3f} of their limits")):
            print(f"  {what} B={PB} N={PN} {c1}->1024: {note}; kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.3f} ms "
                  f"({bnd[1]}), {100 * bnd[0] / ms:.1f}% of bound")
    fwd, bwd = times[192]
    report.append(kernel_row(
        "conv_nmax (B5)", "weaksuppointcloudseg_tpu_torch/ops/csrc/conv_kmax.cu",
        "weaksuppointcloudseg_tpu/ops/conv_kmax_pallas.py:739", errs[0], *fwd))
    report.append(kernel_row(
        "conv_nmax_bwd (B5)", "weaksuppointcloudseg_tpu_torch/ops/csrc/conv_nmax_bwd.cu",
        "weaksuppointcloudseg_tpu/ops/conv_kmax_pallas.py:847", errs[1], *bwd))


SB, SN, SK = 64, 2048, 10  # the ShapeNet Full smoothness loss (32 x 2 clouds)
RB, RN = 28, 4096  # the S3DIS Full-style batch (14 unique blocks x 2)


def smooth_features(gen, b, n, n_cls):
    """f = bf16([P, |P|^2]) of softmax probabilities P [b, n, n_cls], the
    smoothness loss's gathered features."""
    import torch

    prob = torch.softmax(torch.randn((b, n, n_cls), generator=gen,
                                     device="cuda") * 2, -1)
    q = prob.square().sum(-1, keepdim=True)
    return torch.cat([prob, q], -1).to(torch.bfloat16)


def s3dis_blocks(gen, b, n, dup_every=4):
    """xyzrgb of S3DIS-like blocks [b, n, 6] f32: xy in a 1 m block around
    0, z up to 3 m, rgb in [0, 1]; every ``dup_every``-th block holds 3/4 of
    n distinct points and repeats the rest, as the block sampler pads short
    blocks, so exact distances tie at 0."""
    import torch

    g = torch.rand((b, n, 6), generator=gen, device="cuda")
    g[..., :2] -= 0.5
    g[..., 2] *= 3.0
    m = 3 * n // 4
    rep = torch.randint(0, m, (n - m,), generator=gen, device="cuda")
    g[::dup_every, m:] = g[::dup_every][:, rep]
    return g


def check_wgather_pre(gen, report):
    """B6's gather against wgather_pre_ref at the ShapeNet smoothness
    shape (B=64, N=2048, k=10, 50 classes + |P|^2), on a kNN graph of
    random points with w = exp(-d / 0.1). Tolerance: the k products summed
    in another order (and fused multiply-adds), 1e-5 of sum_j |w_j| |f_j|
    (ROADMAP C4)."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import knn, wgather

    x = torch.randn((SB, SN, 3), generator=gen, device="cuda") * 0.3
    idx, sqd = knn.knn(x, SK, fast=True, with_values=True)
    w = torch.exp(-sqd.clamp_min(0.0) / 0.1)
    f = smooth_features(gen, SB, SN, 50)
    got = wgather.wgather_pre(idx, w, f)
    want = wgather.wgather_pre_ref(idx, w, f)
    mags = wgather.wgather_pre_ref(idx, w, f.abs())
    torch.cuda.synchronize()
    err = sum_err(got, want, mags)
    require(err <= 1e-5, f"wgather_pre: {err} of the magnitudes")
    ms = timed_ms(lambda: wgather.wgather_pre(idx, w, f))
    plain_ms = timed_ms(lambda: wgather.wgather_pre_ref(idx, w, f))
    bnd = bound(2.0 * idx.numel() * f.shape[-1], "f32", nbytes(idx, w, f, got))
    print(f"  wgather_pre (B6) B={SB} N={SN} k={SK} Cf=51: {err:.2e} of the "
          f"magnitudes; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}), {100 * bnd[0] / ms:.1f}% of bound")
    report.append(kernel_row(
        "wgather_pre (B6)", "weaksuppointcloudseg_tpu_torch/ops/csrc/wgather.cu",
        "weaksuppointcloudseg_tpu/ops/edgeconv_pallas.py:1139",
        (got - want).abs().max().item(), ms, plain_ms, bnd))


def check_scatter_add_weighted(gen, report):
    """B6's scatter against scatter_add_weighted_ref at both paths' shapes
    (ShapeNet B=64, N=2048, 51 channels; S3DIS B=28, N=4096, 14 channels;
    k=10). On a slice (B=4) bit for bit the plain version on the CPU; two launches give the same
    bits; at the full shape 1e-5 of the sum of magnitudes sum |w| |ct| per
    output element (ROADMAP C4, kept). The kernel's time includes its
    inverse build. The library time is one index_add_ of the expanded
    w * ct."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import scatter

    times = {}
    for b, n, c in ((SB, SN, 51), (RB, RN, 14)):
        idx = torch.randint(0, n, (b, n, SK), generator=gen, device="cuda",
                            dtype=torch.int32)
        w = torch.rand((b, n, SK), generator=gen, device="cuda")
        ct = torch.randn((b, n, c), generator=gen, device="cuda") * 1e-3
        got = scatter.scatter_add_weighted(idx, w, ct, n)
        want = scatter.scatter_add_weighted_ref(idx, w, ct, n)
        mags = scatter.scatter_add_weighted_ref(idx, w, ct.abs(), n)
        torch.cuda.synchronize()
        err = sum_err(got, want, mags)
        require(err <= 1e-5, f"scatter_add_weighted C={c}: {err}")
        sl = [t[:4].contiguous() for t in (idx, w, ct)]
        cpu = same_bits(scatter.scatter_add_weighted(*sl, n),
                        scatter.scatter_add_weighted_ref(
                            *[t.cpu() for t in sl], n))
        print(f"  scatter_add_weighted (B6) C={c}: B=4 slice bit for bit the "
              f"plain version on the CPU: {cpu}")
        require(cpu, f"scatter_add_weighted C={c}: differs from the CPU")
        repeats(lambda: scatter.scatter_add_weighted(idx, w, ct, n),
                f"scatter_add_weighted (B6) B={b} C={c}")
        ms = timed_ms(lambda: scatter.scatter_add_weighted(idx, w, ct, n))
        plain_ms = timed_ms(lambda: scatter.scatter_add_weighted_ref(idx, w, ct, n))
        rows = scatter._flat_rows(idx, n)
        contrib = (w[..., None] * ct[:, :, None, :]).reshape(-1, c)
        out = torch.zeros((b * n, c), device="cuda")
        lib_ms = timed_ms(lambda: out.index_add_(0, rows, contrib))
        lib_dev_ms = device_ms(lambda: out.index_add_(0, rows, contrib))
        del contrib, rows, out
        bnd = bound(2.0 * idx.numel() * c, "f32", nbytes(idx, w, ct, got))
        times[c] = ((got - want).abs().max().item(), ms, plain_ms, bnd, lib_ms)
        inv_ms = check_inverse_graph(idx, n, f"B6's graph, C={c}")[0]
        dev_ms = device_ms(lambda: scatter.scatter_add_weighted(idx, w, ct, n))
        split = kernel_device_ms(
            lambda: scatter.scatter_add_weighted(idx, w, ct, n),
            ("inverse_", "csr_gather"))
        print(f"  scatter_add_weighted (B6) B={b} P=N={n} k={SK} C={c}: "
              f"{err:.2e} of the magnitudes; kernel {ms:.3f} ms ({dev_ms:.4f} "
              f"with the host's launches hidden; on the device "
              f"{split[1]:.4f} ms gather, {split[0]:.4f} ms build; its "
              f"inverse build alone {inv_ms:.4f} ms), plain "
              f"{plain_ms:.3f} ms, index_add_ {lib_ms:.3f} ms ({lib_dev_ms:.4f} "
              f"with the host's launches hidden), bound "
              f"{bnd[0]:.4f} ms ({bnd[1]}), {100 * bnd[0] / ms:.1f}% of bound")
    max_err, ms, plain_ms, bnd, lib_ms = times[51]
    report.append(kernel_row(
        "scatter_add_weighted (B6)",
        "weaksuppointcloudseg_tpu_torch/ops/csrc/scatter_w.cu",
        "weaksuppointcloudseg_tpu/ops/scatter_pallas.py:299",
        max(max_err, times[14][0]), ms, plain_ms, bnd, library_ms=lib_ms))


def check_knn_wgather(gen, report):
    """B9 against knn_wgather_ref at the S3DIS smoothness shape (B=28,
    N=4096, xyzrgb, k=10, 13 classes + |P|^2, gamma 0.1), exact and fast,
    on blocks of which a quarter repeat points. Tolerances: indices by
    agreement rate (>= 99.9% exact, >= 98% fast, as B12); the weights
    against exp(-max(d, 0) / gamma) of the plain distances at the kernel's
    own indices, within what the distance tolerance (1e-5 of the distance
    scale; fast: the dropped idx_bits) moves them; s against the plain
    weighted sum at the kernel's own indices and weights, 1e-5 of the sum
    of magnitudes. A repeated point's first neighbour is the lowest index
    of its copies (exact)."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import knn, wgather

    gamma = 0.1
    g = s3dis_blocks(gen, RB, RN)
    f = smooth_features(gen, RB, RN, 13)
    times, max_err = {}, 0.0
    for fast in (False, True):
        idx, s, w = wgather.knn_wgather(g, f, SK, gamma, fast=fast)
        want_idx = wgather.knn_wgather_ref(g, f, SK, gamma, fast=fast)[0]
        torch.cuda.synchronize()
        agree = (idx == want_idx).float().mean().item()
        require(agree >= (0.98 if fast else 0.999),
                f"knn_wgather fast={fast}: index agreement {agree}")
        del want_idx
        if not fast:
            self_first = (idx[:, :, 0] <= torch.arange(RN, device="cuda")).all()
            require(bool(self_first), "knn_wgather: a copy before the lowest index")
        d_sel = torch.gather(knn.distances(g), 2, idx.long()).clamp_min(0.0)
        scale = (g.double() ** 2).sum(-1).max().item()
        tol_d = scale * (2.0 ** (knn.idx_bits(RN) - 23) if fast else 1e-5)
        w_ref = torch.exp(-d_sel / gamma)
        w_err = ((w - w_ref).abs() / (w_ref * tol_d / gamma + 1e-6)).max().item()
        s_err = sum_err(s, wgather.wgather_pre_ref(idx, w, f),
                        wgather.wgather_pre_ref(idx, w, f.abs()))
        require(w_err <= 1.0 and s_err <= 1e-5,
                f"knn_wgather fast={fast}: w {w_err}, s {s_err}")
        max_err = max(max_err, (w - w_ref).abs().max().item())
        ms = timed_ms(lambda: wgather.knn_wgather(g, f, SK, gamma, fast=fast))
        plain_ms = timed_ms(lambda: wgather.knn_wgather_ref(g, f, SK, gamma,
                                                            fast=fast), reps=3)
        flops = 2.0 * gram_pairs(RB, RN) * 6 + 2.0 * idx.numel() * f.shape[-1]
        bnd = bound(flops, "f32", nbytes(g, f, idx, s, w))
        times[fast] = (ms, plain_ms, bnd)
        print(f"  knn_wgather (B9) B={RB} N={RN} Cg=6 Cf=14 k={SK} fast={fast}: "
              f"index agreement {agree:.6f}, w {w_err:.2f} of its tolerance, s "
              f"{s_err:.2e} of the magnitudes; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
              f"{100 * bnd[0] / ms:.1f}% of bound")
    report.append(kernel_row(
        "knn_wgather (B9)", "weaksuppointcloudseg_tpu_torch/ops/csrc/knn_wgather.cu",
        "weaksuppointcloudseg_tpu/ops/edgeconv_pallas.py:1010", max_err,
        *times[True]))


LN, LK = 131072, 13  # one room of bench.py's s3dis_room_lp_131072, 13 classes


def padded_bench_room(n: int, blocks: int = 7, block: int = 4096):
    """bench_room(n) with train/loop.py::room_label_prop's padding appended:
    ``blocks`` blocks of ``block`` identical points 2 m beyond the room's
    far corner, rgb 0 (the 7 pad blocks that room_label_prop gives a
    25-block room such as phase 8's Area_5_office_2). numpy (xyz, rgb)
    [1, n + blocks * block, 3]."""
    xyz, _, rgb = bench_room(n)
    pad = blocks * block
    pxyz = np.concatenate([xyz, np.broadcast_to(xyz[0].max(0) + 2.0, (1, pad, 3))], 1)
    prgb = np.concatenate([rgb, np.zeros((1, pad, 3), np.float32)], 1)
    return pxyz.astype(np.float32), prgb.astype(np.float32)


def check_affinity(gen, report):
    """B10 and B17 against their plain versions (every pair, row tiles of
    cuBLAS f32) at one room of bench.py's s3dis_room_lp_131072 (B=1,
    N=131072, F=6, K=13), Morton-sorted as the room LP sorts it.
    Tolerance per element: twice the Gram's f32 cancellation bound
    (label_prop.check_gram_cancellation: 4 ulps of max |f|^2, which
    exp(-d^2) turns into that relative error on each affinity; kernel and
    plain version each round their own Gram) plus 1e-5 of sum_j W_ij |u_j|
    (the exponential's and the apply's rounding, another summation order),
    plus exp(-30) sum |u| for the skipped pairs. B10 is also held there at
    the degree pass's K=1 on u = ones, and at K=13 on the same room with
    room_label_prop's 7 pad blocks appended (heavy row tiles: every pad
    tile keeps every other). Prints the share of tile pairs skipped (must
    be > 0), the work plan (kept tiles per row tile, items, workspace,
    build time), the kernel without skipping, and each time between
    events (``timed_ms``) beside the device time with the host's launches
    hidden (``device_ms``) and its split by kernel. The kernel times take
    the mask and plan built once, as the room LP does (their builds are
    timed on their own)."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import affinity
    from weaksuppointcloudseg_tpu_torch.propagate import label_prop

    xyz, _, rgb = bench_room(LN)
    feat_t, _ = label_prop.matfree_features(torch.from_numpy(xyz).cuda(),
                                            torch.from_numpy(rgb).cuda())
    ut = torch.randn((1, LK, LN), generator=gen, device="cuda")
    bound_rel = label_prop.check_gram_cancellation(feat_t.transpose(1, 2))
    mask = affinity.tile_mask(feat_t)
    plan = affinity.tile_plan(mask)
    ordered = float(mask.sum().item()) * affinity.TILE ** 2
    skipped = 1.0 - mask.float().mean().item()
    require(skipped > 0, "room LP: no tile pair skipped")
    mask_ms = timed_ms(lambda: affinity.tile_mask(feat_t))
    plan_ms = timed_ms(lambda: affinity.tile_plan(mask))
    parts = ("affinity_prep", "affinity_items", "affinity_combine")

    def plan_line(mask, plan, k):
        kept = mask.sum(2).float()
        return (f"kept tiles per row tile mean {kept.mean().item():.1f} max "
                f"{int(kept.max().item())}; {plan.n_items} items of at most "
                f"{affinity.SEGMENT_TILES} tiles for {mask.shape[1]} row tiles, "
                f"workspace {plan.n_items * k * affinity.TILE * 4 / 2**20:.1f} MiB")

    def tolerance(ref, feat, u, bound_rel=bound_rel):
        want, mags = ref(feat, u), ref(feat, u.abs())
        tol = (2 * bound_rel + 1e-5) * mags + float(np.exp(-30.0)) * u.abs().sum().item()
        return want, mags, tol

    def times(fn):
        split = kernel_device_ms(fn, parts)
        return (timed_ms(fn), device_ms(fn), split)

    def time_text(t):
        return (f"kernel {t[0]:.3f} ms between events, {t[1]:.4f} ms on the "
                f"device (prep {t[2][0]:.4f} + items {t[2][1]:.4f} + combine "
                f"{t[2][2]:.4f})")

    print(f"  B10/B17 work plan of the bench room: {plan_line(mask, plan, LK)}; "
          f"tile mask build {mask_ms:.3f} ms, plan build {plan_ms:.3f} ms (one "
          f"host sync)")
    # the degree pass's launch, K=1 on u = ones, as label_propagation_matfree
    # makes it (the kernel's K=1 instance)
    ones = torch.ones((1, 1, LN), device="cuda")
    got = affinity.affinity_matvec_t(feat_t, ones)
    want, _, tol = tolerance(affinity.affinity_matvec_t_ref, feat_t, ones)
    err = ((got - want).abs() / tol).max().item()
    require(err <= 1.0, f"B10 degree pass (K=1): {err:.3f} of the tolerance")
    t_deg = times(lambda: affinity.affinity_matvec_t(feat_t, ones, plan=plan))
    print(f"  affinity_matvec_t (B10) degree pass B=1 N={LN} K=1 (u = ones): "
          f"max rel err {((got - want).abs() / want).max().item():.2e} "
          f"({err:.3f} of the tolerance), degrees {want.min().item():.3f}.."
          f"{want.max().item():.1f}; {time_text(t_deg)}")
    del got, want, tol
    for name, transposed in (("affinity_matvec_t (B10)", True),
                             ("affinity_matvec (B17)", False)):
        if transposed:
            feat, u = feat_t, ut
            fn, ref = affinity.affinity_matvec_t, affinity.affinity_matvec_t_ref
        else:
            feat, u = feat_t.transpose(1, 2).contiguous(), ut.transpose(1, 2).contiguous()
            fn, ref = affinity.affinity_matvec, affinity.affinity_matvec_ref
        got = fn(feat, u)
        again = fn(feat, u, plan=plan)
        every = affinity.tile_plan(affinity.tile_mask(feat_t, None))
        full = fn(feat, u, plan=every)
        want, mags, tol = tolerance(ref, feat, u)
        torch.cuda.synchronize()
        require(torch.equal(got, again), f"{name}: two launches differ")
        err = ((got - want).abs() / tol).max().item()
        err_full = ((full - want).abs() / tol).max().item()
        share = ((got - want).abs() / mags).max().item()
        max_err = (got - want).abs().max().item()
        del want, mags, full, again
        require(err <= 1.0 and err_full <= 1.0,
                f"{name}: {err:.3f} / {err_full:.3f} of the tolerance")
        t = times(lambda: fn(feat, u, plan=plan))
        ms_full = device_ms(lambda: fn(feat, u, plan=every), reps=3)
        del every
        plain_ms = timed_ms(lambda: ref(feat, u), reps=3, warmup=1)
        io = nbytes(feat, u, got)
        bnd = bound(affinity_flops(1, LN, 6, LK, ordered), "f32", io)
        bnd_full = bound(affinity_flops(1, LN, 6, LK, float(LN) ** 2), "f32", io)
        print(f"  {name} B=1 N={LN} F=6 K={LK} (bench room, Morton order): "
              f"max err {share:.2e} of sum |W||u| ({err:.3f} of the "
              f"tolerance, Gram bound {bound_rel:.2e}); two launches bit for "
              f"bit; tile pairs skipped {100 * skipped:.2f}%; {time_text(t)}; "
              f"without skipping {ms_full:.3f} ms on the device, plain "
              f"{plain_ms:.3f} ms; bound over the surviving pairs "
              f"{bnd[0]:.4f} ms ({bnd[1]}), every pair {bnd_full[0]:.4f} ms; "
              f"{100 * bnd[0] / t[0]:.1f}% of bound ({100 * bnd[0] / t[1]:.1f}% "
              f"on the device)")
        report.append(kernel_row(
            name, "weaksuppointcloudseg_tpu_torch/ops/csrc/affinity.cu",
            "weaksuppointcloudseg_tpu/ops/affinity_pallas.py:"
            + ("272" if transposed else "171"), max_err, t[0], plain_ms, bnd))
        del got

    # the bench room with room_label_prop's pad blocks, B10 at the CG's K
    pxyz, prgb = padded_bench_room(LN)
    pfeat, _ = label_prop.matfree_features(torch.from_numpy(pxyz).cuda(),
                                           torch.from_numpy(prgb).cuda())
    pn = pfeat.shape[2]
    pu = torch.randn((1, LK, pn), generator=gen, device="cuda")
    pmask = affinity.tile_mask(pfeat)
    pplan = affinity.tile_plan(pmask)
    got = affinity.affinity_matvec_t(pfeat, pu, plan=pplan)
    want, _, tol = tolerance(
        affinity.affinity_matvec_t_ref, pfeat, pu,
        label_prop.check_gram_cancellation(pfeat.transpose(1, 2)))
    err = ((got - want).abs() / tol).max().item()
    require(err <= 1.0, f"B10 padded room: {err:.3f} of the tolerance")
    del want, tol
    t = times(lambda: affinity.affinity_matvec_t(pfeat, pu, plan=pplan))
    pbnd = bound(affinity_flops(1, pn, 6, LK,
                                float(pmask.sum().item()) * affinity.TILE ** 2),
                 "f32", nbytes(pfeat, pu, got))
    print(f"  affinity_matvec_t (B10) bench room + 7 pad blocks B=1 N={pn} "
          f"K={LK}: {err:.3f} of the tolerance; {plan_line(pmask, pplan, LK)}; "
          f"{time_text(t)}; bound {pbnd[0]:.4f} ms ({pbnd[1]})")
    del got, pfeat, pu, pmask, pplan
    torch.cuda.empty_cache()


# the room benchmark's largest room: its conference room as its generator
# (benchmark/harness/traffic.py::surface_room, a copy of surface_room below)
# builds it, 1,536,576 float64 rows on an 8 x 6 grid of 1 m blocks
SWEEP_ROOM, SWEEP_PER_M2, SWEEP_POINTS = (8.0, 6.0, 3.0), 10600, 4096


def check_room_sweep(report):
    """RS1 (the bucketing: count, rows, starts, scatter) and RS2 (the
    gather and normalisation) against their plain versions, bitwise, on
    the same card tensors at the room benchmark's largest room: RS1's
    members and counts, then RS2's blocks and labels from the draws that
    data/s3dis.py's sweep makes (4096 of each of its 48 blocks). The bound
    is bytes read and written once: x and y of every row and the members
    for RS1; the picked rows, their picks and members, the blocks and the
    labels for RS2."""
    import torch

    from weaksuppointcloudseg_tpu_torch.data import s3dis
    from weaksuppointcloudseg_tpu_torch.ops import room_sweep

    room = surface_room(np.random.default_rng(0), SWEEP_ROOM, SWEEP_PER_M2)
    raw = torch.from_numpy(room).cuda()
    limit = room[:, 0:3].max(0)
    num_x, num_y = s3dis._grid(limit)
    members, counts = room_sweep.block_members(raw, num_x, num_y)
    want_m, want_c = room_sweep.block_members_ref(raw, num_x, num_y)
    m = len(want_m)
    require(torch.equal(counts, want_c) and torch.equal(members[:m], want_m),
            f"block_members (RS1) {len(room)} rows, {num_x} x {num_y} blocks: "
            f"not bitwise its plain version")
    picks_buf = s3dis._HostBuffer(raw.device)
    s3dis._draws(counts.cpu().numpy(), SWEEP_POINTS, s3dis.MIN_POINTS,
                 np.random.default_rng(1), picks_buf)
    picks = picks_buf.upload()
    members = members[:m]
    blocks, labels = room_sweep.gather_blocks(raw, members, picks, limit)
    want_b, want_l = room_sweep.gather_blocks_ref(raw, members, picks, limit)
    require(same_bits(blocks, want_b) and torch.equal(labels, want_l),
            f"gather_blocks (RS2) {tuple(picks.shape)} picks: not bitwise its "
            f"plain version")
    del want_m, want_c, want_b, want_l
    n, c = raw.shape
    k = picks.shape[0]
    rows = {
        "block_members (RS1)": (
            lambda: room_sweep.block_members(raw, num_x, num_y),
            lambda: room_sweep.block_members_ref(raw, num_x, num_y),
            16 * n + 4 * m, ("count_kernel", "rows_kernel", "starts_kernel",
                             "scatter_kernel")),
        "gather_blocks (RS2)": (
            lambda: room_sweep.gather_blocks(raw, members, picks, limit),
            lambda: room_sweep.gather_blocks_ref(raw, members, picks, limit),
            k * SWEEP_POINTS * (8 * c + 4 + 4 + 9 * 4 + 4), ("gather_kernel",)),
    }
    for name, (fn, ref, io, parts) in rows.items():
        ms = timed_ms(fn)
        plain_ms = timed_ms(ref, reps=3, warmup=1)
        split = kernel_device_ms(fn, parts)
        bnd = bound(0.0, "f32", io)
        print(f"  {name} {n} f64 rows, {num_x} x {num_y} blocks, {m} members, "
              f"{k} x {SWEEP_POINTS} picks: bitwise equal; kernel {ms:.4f} ms "
              f"between events (on the device: "
              + ", ".join(f"{p} {t:.4f}" for p, t in zip(parts, split))
              + f"), plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}, "
              f"{io / 1e6:.1f} MB), {100 * bnd[0] / ms:.1f}% of bound")
        report.append(kernel_row(
            name, "weaksuppointcloudseg_tpu_torch/ops/csrc/room_sweep.cu",
            "none (the JAX package sweeps a room with numpy on the host)", 0.0,
            ms, plain_ms, bnd))
    del raw, members, picks, blocks, labels
    torch.cuda.empty_cache()


def phase_kernels(report):
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print("phase 2: kernels against their plain versions")
    check_knn_edge(gen, report)
    check_knn_edge_pre(gen, report)
    check_conv_zmax(gen, report)
    check_conv_znmax(gen, report)
    check_knn(gen, report)
    check_scatter_add(gen, report)
    check_gather_rows(gen, report)
    check_knn_gather(gen, report)
    check_vjps(gen)
    check_conv_minmax(gen, report)
    check_conv_kmax_bwd(gen, report)
    check_scatter_bn_bwd(gen, report)
    check_conv_nmax(gen, report)
    check_wgather_pre(gen, report)
    check_scatter_add_weighted(gen, report)
    check_knn_wgather(gen, report)
    torch.cuda.empty_cache()
    check_affinity(gen, report)
    check_room_sweep(report)


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


def full_width_model(seed: int = 0, preset: str = "shapenet_config"):
    """A preset (``configs.<preset>``) at full width with seeded random
    weights and non-trivial BN: gammas of both signs, shifted means, spread
    variances."""
    import dataclasses

    import torch

    from weaksuppointcloudseg_tpu_torch import configs
    from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg

    cfg = dataclasses.replace(getattr(configs, preset)().model,
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
    MEASURED["shapenet_eval_forward_throughput"] = fwd_ms
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
    kernels = {"knn (B12)": knn.knn, "scatter_add (B13)": scatter.scatter_add,
               "inverse_graph (B13/B4/B6)": scatter.inverse_graph}
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
    repeat_step(trainer.model, trainer.opt, trainer.generator,
                lambda: trainer.train_step(batch, 1.0, trainer.generator),
                f"f32 Full ShapeNet step, {TB} x {TN}")

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


# ---------------------------------------------------------------- phase 5

def phase_plain_train(report) -> None:
    """bf16 Plain-style training through the fused blocks, ShapeNetTrainer
    at bench.py's shapenet_plain_train_throughput shape."""
    import dataclasses
    import tempfile

    import torch

    from weaksuppointcloudseg_tpu_torch import configs
    from weaksuppointcloudseg_tpu_torch.data import sampling
    from weaksuppointcloudseg_tpu_torch.ops import conv_kmax, edgeconv, scatter
    from weaksuppointcloudseg_tpu_torch.train.loop import ShapeNetTrainer

    print(f"phase 5: bf16 Plain-style training end to end (ShapeNetTrainer), "
          f"{PB} clouds x {PN} points, fused blocks, knn_fast")
    rng = np.random.default_rng(1)
    splits = {"train": synthetic_split(3 * PB, rng),
              "val": synthetic_split(24, rng)}
    base = configs.shapenet_config()
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, compute_dtype="bfloat16",
                                        knn_fast=True),
        train=dataclasses.replace(base.train, batch_size=PB, style="Plain"))
    kernels = {"knn_edge (B1)": edgeconv.knn_edge,
               "conv_minmax (B2)": conv_kmax.conv_minmax,
               "conv_kmax_bwd (B3)": conv_kmax.conv_kmax_bwd,
               "scatter_bn_bwd (B4)": scatter.scatter_bn_bwd,
               "conv_nmax (B5)": conv_kmax.conv_nmax,
               "conv_nmax_bwd (B5)": conv_kmax.conv_nmax_bwd}
    eval_kernels = {"conv_zmax (B7)": conv_kmax.conv_zmax,
                    "conv_znmax (B8)": conv_kmax.conv_znmax}
    with tempfile.TemporaryDirectory() as tmp:
        ds = in_memory_dataset(tmp, splits)
        pts_idx = sampling.generate_sample_index(3 * PB, PN, 0.1)
        trainer = ShapeNetTrainer(cfg, ds, pts_idx, seed=0, device="cuda")
        for fn in (*kernels.values(), *eval_kernels.values()):
            fn.launches = 0
        t0 = time.perf_counter()
        m = trainer.train_epoch(0)
        val = trainer.evaluate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        eval_launches = {name: fn.launches for name, fn in eval_kernels.items()}
    print(f"  train_epoch (3 steps) + evaluate (24 val clouds): {wall:.2f} s "
          f"wall (first calls included); launches {launches}, eval kernels "
          f"{eval_launches}")
    print(f"  epoch metrics: " + ", ".join(f"{k} {v:.5g}" for k, v in m.items()))
    print(f"  eval: loss {val[0]:.4f} acc {val[1]:.4f} perdata mIoU "
          f"{val[2]:.4f} pershape mIoU {float(np.mean(val[3])):.4f}")
    for row in report:
        if row["name"] in launches and row["name"] != "knn_edge (B1)":
            row["launches"] = launches[row["name"]]
    for name, n in {**launches, **eval_launches}.items():
        require(n > 0, f"{name} was not launched by the bf16 training path")
    for key in ("seg", "total", "acc"):
        require(np.isfinite(m[key]), f"train metric {key} = {m[key]}")
    require(np.isfinite(val[0]) and 0 <= val[1] <= 1, f"eval {val}")

    b = next(ds.batches("train", PB))
    batch = trainer._to_device(trainer._assemble(
        b, siamese=False, augment_pairs=False, full_mask=False))
    time_fixed_batch(trainer, batch, PB * PN, "shapenet_plain_train_throughput",
                     "bf16 train step", gate=0.0)

    # one fused step of 2 clouds of 2048 points, full widths, dropout off,
    # two seeds of random weights (fused_step_vs_cpu). Limits, at least
    # three times the worst readings of scripts/torch_step_agreement.py and
    # this phase over several chip runs (PERF.md, section 6):
    # each fused block on its own, its output and every input gradient
    # within 1e-2 (worst reading 1.0e-3); the whole step's loss within
    # 2e-3 relative (6.4e-4), logits within 0.1 relative RMS (2.4e-2),
    # every leaf within 0.4 of its norm (0.128) and the null-gradient
    # biases within 1.5e-2 of the largest leaf norm (3.5e-3): through the
    # whole step one-ulp differences grow in the batch-moment BNs.
    # agg_conv.beta is held at the block level only: at 2 clouds the
    # head's BN makes its cotangent sum to zero over the clouds, so its
    # gradient cancels on channels active in both and is rounding noise
    # (0.70-1.09 on the card, 0.80 for the CPU against itself at another
    # thread count)
    small = dataclasses.replace(cfg.model, head_keep_prob=(None, None, None))
    sub = {k: v[:2] for k, v in batch.items()}
    for seed in (1, 2):
        loss_err, lg_err, errs, null, block_errs = fused_step_vs_cpu(
            small, sub, seed)
        leaf = sorted((e, n) for n, e in errs.items()
                      if n not in null and n != "agg_conv.beta")
        null_err = max(e for n, e in errs.items() if n in null)
        block_worst = max((e, f"{name}.{k}") for name, be in block_errs
                          for k, e in be.items())
        print(f"  CUDA vs CPU replaying the card's kNN and moments, one fused "
              f"bf16 step, 2 x {PN} points, seed {seed}: each block on its "
              f"own, worst {block_worst[1]} {block_worst[0]:.2e}; the whole "
              f"step: loss rel err {loss_err:.2e}, logits rel RMS "
              f"{lg_err:.2e}, leaf gradients (relative norm of the "
              f"difference), worst: " + ", ".join(
                  f"{n} {e:.2e}" for e, n in leaf[-3:][::-1])
              + f"; median {leaf[len(leaf) // 2][0]:.2e}; null-gradient "
              f"biases {null_err:.2e} of the largest leaf norm; agg_conv.beta "
              f"{errs['agg_conv.beta']:.2e}")
        require(block_worst[0] <= 1e-2,
                f"CUDA fused block disagrees with the CPU: {block_errs}")
        require(loss_err <= 2e-3 and lg_err <= 0.1,
                "CUDA fused training forward disagrees with the CPU")
        require(leaf[-1][0] <= 0.4 and null_err <= 1.5e-2,
                "CUDA fused gradients disagree with the CPU")


# ---------------------------------------------------------------- phase 6

@contextlib.contextmanager
def patched(obj, name, value):
    """``obj.name = value`` for the duration."""
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def count_launches(kernels, run):
    """Reset every kernel's count, call ``run()`` and return (its result,
    {name: launches during the call})."""
    for fn in kernels.values():
        fn.launches = 0
    out = run()
    return out, {name: fn.launches for name, fn in kernels.items()}


def fused_train_kernels():
    """The kernels of the bf16 fused training path and its evaluate, with
    the two smoothness-loss routes (B6 gather on a reused graph, B9)."""
    from weaksuppointcloudseg_tpu_torch.ops import (
        conv_kmax,
        edgeconv,
        scatter,
        wgather,
    )

    return {"knn_edge (B1)": edgeconv.knn_edge,
            "conv_minmax (B2)": conv_kmax.conv_minmax,
            "conv_kmax_bwd (B3)": conv_kmax.conv_kmax_bwd,
            "scatter_bn_bwd (B4)": scatter.scatter_bn_bwd,
            "conv_nmax (B5)": conv_kmax.conv_nmax,
            "conv_nmax_bwd (B5)": conv_kmax.conv_nmax_bwd,
            "wgather_pre (B6)": wgather.wgather_pre,
            "scatter_add_weighted (B6)": scatter.scatter_add_weighted,
            "knn_wgather (B9)": wgather.knn_wgather,
            "conv_zmax (B7)": conv_kmax.conv_zmax,
            "conv_znmax (B8)": conv_kmax.conv_znmax}


def time_fixed_batch(trainer, batch, n_unique, metric, what, gate=1.0):
    """Six steps of ``trainer`` on one batch (rampup ``gate``): every loss
    finite, the seg loss falling; prints ``metric`` (unique points/s over
    the median of the last five steps, host clock around a synchronise),
    the peak memory, the device time by kernel and the idle share. Returns
    the median step's ms."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    seg, step_s = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trainer.train_step(batch, gate, trainer.generator)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        seg.append(out["seg"])
        require(all(bool(torch.isfinite(v)) for v in out.values()
                    if torch.is_tensor(v)), f"{what}: a loss is not finite: {out}")
    seg = torch.stack(seg).cpu().numpy()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  seg loss on a fixed batch over 6 steps: "
          + " ".join(f"{v:.4f}" for v in seg))
    require(np.isfinite(seg).all() and seg[-1] < seg[0],
            f"{what}: the seg loss did not fall on a fixed batch")
    card = card_line()
    step = float(np.median(step_s[1:]))
    print(f"  {metric}: {step * 1e3:.3f} ms per step (median of 5), "
          f"{n_unique / step:.0f} unique points/s [{card}]")
    print(f"  peak device memory of a training step {peak:.2f} GiB [{card}]")
    busy_ms, wall_ms = device_breakdown(
        lambda: trainer.train_step(batch, gate, trainer.generator), card,
        runs=3, top=16, what=what, ops=10)
    print(f"  idle share of the step, this run: 1 - busy {busy_ms:.3f} / "
          f"median step {step * 1e3:.3f} ms = {1 - busy_ms / (step * 1e3):.3f}; "
          f"the profiler's own cost: its wall {wall_ms:.3f} ms - median step "
          f"= {wall_ms - step * 1e3:.3f} ms")
    return step * 1e3


def repeat_step(model, opt, gen, step, what) -> None:
    """Two training steps from the same state (weights, BN statistics, Adam
    moments and count, the dropout generator) on the same batch: every
    loss ``step()`` returns (a dict of metrics or a loss), every gradient,
    the BN running statistics and the updated weights bit for bit equal
    (ROADMAP C16). A third step under ``torch.use_deterministic_algorithms(
    True, warn_only=True)`` names any PyTorch operator of the step that
    PyTorch knows to sum in a run-dependent order (cuBLAS's workspace note
    aside: one stream runs the step). The state is restored afterwards."""
    import warnings

    import torch

    from weaksuppointcloudseg_tpu_torch.ops import scatter

    state = {k: v.clone() for k, v in model.state_dict().items()}
    moments = [t.clone() for t in (*opt.mu, *opt.nu)]
    count = opt.step
    gstate = gen.get_state() if gen is not None else None

    def restore():
        model.load_state_dict(state)
        for t, m in zip((*opt.mu, *opt.nu), moments):
            t.copy_(m)
        opt.step = count
        if gen is not None:
            gen.set_state(gstate)

    def run():
        restore()
        out = step()
        metrics = out if isinstance(out, dict) else {"loss": out}
        res = {f"loss {k}": v.detach().clone() for k, v in metrics.items()
               if torch.is_tensor(v)}
        res.update({f"grad {n}": p.grad.clone()
                    for n, p in model.named_parameters() if p.grad is not None})
        res.update({f"state {n}": t.clone()
                    for n, t in model.state_dict().items()})
        return res

    builds = scatter.inverse_graph.launches
    first = run()
    builds = scatter.inverse_graph.launches - builds
    second = run()
    differ = [k for k in first if not same_bits(first[k], second[k])]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            run()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).split(" does not have a deterministic")[0]
                      for w in caught if "deterministic" in str(w.message)
                      and "CUBLAS_WORKSPACE_CONFIG" not in str(w.message)})
    restore()
    print(f"  reproducible: {what}: two steps from the same state, "
          f"{len(first) - len(differ)} of {len(first)} tensors (losses, "
          f"gradients, BN statistics, weights) bit for bit equal"
          + (f"; differ: {', '.join(differ[:6])}" if differ else "")
          + f"; inverse graphs built {builds} in a step; "
          f"operators flagged under deterministic mode: "
          f"{', '.join(flagged) if flagged else 'none'}")
    require(not differ, f"{what}: a step from the same state differs: "
            f"{differ[:6]}")


def check_full_epoch(res) -> None:
    """A training CLI's Full-style epoch (gate on) and evaluation: every
    loss finite, the smoothness loss positive, the eval metrics finite."""
    m = res["train"]
    print(f"  epoch metrics: " + ", ".join(f"{k} {v:.5g}" for k, v in m.items()))
    print(f"  eval: {res['eval']}")
    for key in ("seg", "siamese", "inexact", "smooth", "total", "acc"):
        require(np.isfinite(m[key]), f"train metric {key} = {m[key]}")
    require(m["smooth"] > 0, "the gate is on: the smoothness loss is positive")
    require(all(np.isfinite(v) for v in res["eval"].values()),
            f"eval {res['eval']}")


def check_path_launches(report, launches, absent, rows, what):
    """Every kernel of ``launches`` but ``absent`` launched during the run,
    ``absent`` never; the report rows named in ``rows`` take this run's
    counts."""
    for name, n in launches.items():
        require((n == 0) == (name == absent),
                f"{name} launched {n} times on {what}")
    for row in report:
        if row["name"] in rows:
            row["launches"] = launches[row["name"]]


def shapenet_full_cli(kernels, *flags):
    """One epoch (3 steps, gate on) + evaluate (24 val clouds) of
    ``cli.train_shapenet -sty Full --Precision bfloat16 --FastKNN`` at
    bench.py's shape on phase 5's split, with ``flags`` added. Returns (the
    CLI's result, the kernels' launches during the run, its wall s, the
    dataset with both splits loaded)."""
    import tempfile

    import torch

    from weaksuppointcloudseg_tpu_torch.cli import train_shapenet
    from weaksuppointcloudseg_tpu_torch.data import shapenet

    rng = np.random.default_rng(1)  # phase 5's split
    splits = {"train": synthetic_split(3 * PB, rng),
              "val": synthetic_split(24, rng)}
    argv = ["-m", "0.1", "-sty", "Full", "--Precision", "bfloat16",
            "--FastKNN", "-bs", str(PB), "--Epoch", "1", "--Rampup", "0",
            *flags]
    with tempfile.TemporaryDirectory() as tmp:
        write_meta(f"{tmp}/hdf5_data")
        # the script needs no h5py: only the h5 reader is replaced
        with patched(shapenet.ShapeNetDataset, "_load_split",
                     lambda self, name: splits[name.split("_")[0]]):
            t0 = time.perf_counter()
            res, launches = count_launches(
                kernels, lambda: train_shapenet.main(["--DataPath", tmp, *argv]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ds = shapenet.ShapeNetDataset(tmp)
            ds.split("train")
            ds.split("val")
    return res, launches, wall, ds


def full_trainer(ds, preset: str, **model):
    """A Full-style trainer of ``preset`` (rampup 0), bf16 and ``knn_fast``
    unless ``model`` replaces them or other fields, on ``ds`` at bench.py's
    unique batch (PB clouds or RB // 2 blocks), and one Siamese batch of
    its training split on the card."""
    import dataclasses

    from weaksuppointcloudseg_tpu_torch import configs
    from weaksuppointcloudseg_tpu_torch.data import sampling
    from weaksuppointcloudseg_tpu_torch.train.loop import (
        S3DISTrainer,
        ShapeNetTrainer,
    )

    base = getattr(configs, f"{preset}_config")()
    ub = PB if preset == "shapenet" else RB // 2
    model = {"compute_dtype": "bfloat16", "knn_fast": True, **model}
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, **model),
        train=dataclasses.replace(base.train, batch_size=ub, style="Full",
                                  rampup=0))
    if preset == "shapenet":
        trainer = ShapeNetTrainer(cfg, ds, sampling.generate_sample_index(
            3 * PB, PN, 0.1), seed=0, device="cuda")
        b = next(ds.batches("train", ub))
    else:
        trainer = S3DISTrainer(cfg, ds, sampling.generate_sample_index(
            len(ds.room_filelist), RN, 0.1), test_area=5, seed=0,
            device="cuda")
        b = next(ds.batches(trainer.train_idx, ub))
    return trainer, trainer._to_device(trainer._assemble(
        b, siamese=True, augment_pairs=True, full_mask=False))


def phase_full_train(report) -> None:
    """bf16 Full-style ShapeNet training through the training CLI at
    bench.py's shapenet_full_train_throughput shape: the fused blocks and
    the fused smoothness loss over the transform stage's reused graph."""
    import torch

    from weaksuppointcloudseg_tpu_torch.losses.weaksup import (
        smooth_knn_laplacian_fused,
    )

    print(f"phase 6: bf16 Full-style ShapeNet training end to end "
          f"(cli.train_shapenet), {PB} unique x 2 Siamese x {PN} points, "
          f"fused blocks, knn_fast, smoothness over the reused graph")
    res, launches, wall, ds = shapenet_full_cli(fused_train_kernels())
    print(f"  cli run (1 epoch: 3 steps + evaluate of 24 val clouds): "
          f"{wall:.2f} s wall (first calls included); launches {launches}")
    check_full_epoch(res)
    # the smoothness loss reuses the transform stage's graph: no B9
    check_path_launches(report, launches, "knn_wgather (B9)",
                        ("wgather_pre (B6)", "scatter_add_weighted (B6)"),
                        "the bf16 Full ShapeNet path")
    trainer, batch = full_trainer(ds, "shapenet")
    cfg = trainer.cfg
    MEASURED["shapenet_full_train_throughput"] = time_fixed_batch(
        trainer, batch, PB * PN, "shapenet_full_train_throughput",
        "bf16 Full train step")
    repeat_step(trainer.model, trainer.opt, trainer.generator,
                lambda: trainer.train_step(batch, 1.0, trainer.generator),
                f"bf16 Full ShapeNet step, {PB} x 2 x {PN}")

    # the smoothness-loss block on its own, at one step's probabilities and
    # reused graph: the kernel route (B6 gather, B6 scatter) against the
    # plain route on the CPU. Tolerances: s sums in another order (1e-5 of
    # its magnitudes) and |P|^2 may round to the other bf16 neighbour in
    # f: the loss rtol 1e-4, d loss / d P within 2^-7 of its largest entry
    logits, graph = trainer.model(batch["data"], batch["cat_onehot"],
                                  training=True, bn_decay=0.5,
                                  want_smooth_graph=True)
    prob = torch.softmax(logits.detach(), -1)
    outs = []
    for dev in ("cuda", "cpu"):
        p = prob.to(dev, copy=True).requires_grad_()
        loss = smooth_knn_laplacian_fused(
            p, batch["data"].to(dev), gamma=cfg.weaksup.smooth_gamma,
            k=cfg.weaksup.smooth_knn, fast=True,
            graph=tuple(t.to(dev) for t in graph))
        loss.backward()
        outs.append((float(loss.detach()), p.grad.cpu()))
    (lc, gc), (lp, gp) = outs
    loss_err = abs(lc - lp) / abs(lp)
    grad_err = ((gc - gp).abs().max() / gp.abs().max()).item()
    print(f"  smoothness loss block, kernel vs plain route at one step's "
          f"inputs ({logits.shape[0]} x {PN} points): loss {lc:.6e} vs "
          f"{lp:.6e}, rel err {loss_err:.2e}; d loss / d P max err "
          f"{grad_err:.2e} of its largest entry")
    require(loss_err <= 1e-4 and grad_err <= 2.0 ** -7,
            "the fused smoothness loss disagrees with its plain route")


# ---------------------------------------------------------------- phase 7

def write_s3dis_split(base: str, rng: np.random.Generator, train_blocks: int,
                      val_blocks: int) -> None:
    """An S3DIS-format block split with numpy only: 4096-point blocks of 9
    channels (xy centred in a 1 m block, z, rgb / 255, xyz normalized by
    a 6 x 6 x 3 m room) with 13 labels by height and by wall distance,
    shards listed in all_files.txt, one room name per block in
    room_filelist.txt (Area_1-4 for training, Area_5 for validation). A
    third of the blocks hold 2048-4095 distinct points padded with
    repeats, as the block sampler pads short blocks. The shards are .npz
    files (the script needs no h5py; phase 7 reads them with
    numpy)."""
    import os

    os.makedirs(base, exist_ok=True)
    rooms, files, total = [], [], train_blocks + val_blocks
    data = np.empty((total, RN, 9), np.float32)
    label = np.empty((total, RN), np.int32)
    for i in range(total):
        bx, by = rng.integers(0, 6, 2)
        m = int(rng.integers(RN // 2, RN)) if i % 3 == 0 else RN
        xyz = rng.random((m, 3)) * np.array([1.0, 1.0, 3.0]) + np.array([bx, by, 0])
        xyz = xyz[np.concatenate([np.arange(m), rng.integers(0, m, RN - m)])]
        wall = np.minimum.reduce([xyz[:, 0], xyz[:, 1], 6 - xyz[:, 0], 6 - xyz[:, 1]])
        lab = np.minimum((xyz[:, 2] / 3.0 * 10).astype(int), 9)
        lab = np.where(wall < 0.3, 10 + (xyz[:, 2] > 1.5), lab)
        lab[rng.random(RN) < 0.02] = 12
        rgb = np.clip(lab[:, None] / 12.0 + rng.random((RN, 3)) * 0.3, 0, 1)
        data[i] = np.concatenate([
            xyz - np.array([bx + 0.5, by + 0.5, 0]), rgb,
            xyz / np.array([6.0, 6.0, 3.0])], axis=1)
        label[i] = lab
        area = 5 if i >= train_blocks else 1 + i % 4
        rooms.append(f"Area_{area}_room_{i // 4}")
    for j, sl in enumerate((slice(0, total // 2), slice(total // 2, total))):
        name = f"ply_data_all_{j}.npz"
        np.savez(os.path.join(base, name), data=data[sl], label=label[sl])
        files.append(f"indoor3d_sem_seg_hdf5_data/{name}")
    with open(os.path.join(base, "all_files.txt"), "w") as f:
        f.write("\n".join(files) + "\n")
    with open(os.path.join(base, "room_filelist.txt"), "w") as f:
        f.write("\n".join(rooms) + "\n")


def load_npz_shard(path):
    with np.load(path) as z:
        return z["data"].astype(np.float32), z["label"].astype(np.int32)


def s3dis_full_cli(kernels, *flags):
    """One epoch (3 steps, gate on) + evaluate (the Area_5 blocks) of
    ``cli.train_s3dis -sty Full --Precision bfloat16 --FastKNN -ta 5`` at
    bench.py's shape on an S3DIS split the script writes, with ``flags``
    added. Returns (the CLI's result, the kernels' launches during the
    run, its wall s, the dataset loaded)."""
    import tempfile

    from weaksuppointcloudseg_tpu_torch.cli import train_s3dis
    from weaksuppointcloudseg_tpu_torch.data import s3dis

    ub = RB // 2
    argv = ["-m", "0.1", "-sty", "Full", "-bs", str(ub), "--Precision",
            "bfloat16", "--FastKNN", "-ta", "5", "--Epoch", "1", "--Rampup", "0",
            *flags]
    with tempfile.TemporaryDirectory() as tmp:
        data_path = f"{tmp}/indoor3d_sem_seg_hdf5_data"
        write_s3dis_split(data_path, np.random.default_rng(2), 3 * ub, ub)
        with patched(s3dis, "load_h5", load_npz_shard):
            t0 = time.perf_counter()
            res, launches = count_launches(
                kernels,
                lambda: train_s3dis.main(["--DataPath", data_path, *argv]))
            wall = time.perf_counter() - t0
            ds = s3dis.S3DISDataset(data_path)
            ds.load_all()
    return res, launches, wall, ds


def phase_s3dis_train(report) -> None:
    """bf16 Full-style S3DIS training through the training CLI at bench.py's
    s3dis_full_train_throughput shape: the fused blocks and the fused
    smoothness loss over kernel B9 (backward B6)."""
    ub = RB // 2
    print(f"phase 7: bf16 Full-style S3DIS training end to end "
          f"(cli.train_s3dis), {ub} unique x 2 Siamese x {RN} points, fused "
          f"blocks, knn_fast, smoothness by B9")
    res, launches, wall, ds = s3dis_full_cli(fused_train_kernels())
    print(f"  cli run (1 epoch: 3 steps + evaluate of {ub} Area_5 blocks): "
          f"{wall:.2f} s wall (first calls included); launches {launches}")
    check_full_epoch(res)
    # no transform stage, so no graph to reuse: B9 selects, no B6 gather
    check_path_launches(report, launches, "wgather_pre (B6)",
                        ("knn_wgather (B9)",), "the bf16 Full S3DIS path")
    trainer, batch = full_trainer(ds, "s3dis")
    time_fixed_batch(trainer, batch, ub * RN, "s3dis_full_train_throughput",
                     "bf16 Full S3DIS train step")
    repeat_step(trainer.model, trainer.opt, trainer.generator,
                lambda: trainer.train_step(batch, 1.0, trainer.generator),
                f"bf16 Full S3DIS step, {ub} x 2 x {RN}")


# ---------------------------------------------------------------- phase 8

# the raw test rooms of phase 8: name, size in metres (x, y, z)
TEST_ROOMS = (("Area_5_office_1", (8.0, 4.0, 3.0)),   # 32 blocks: 131,072 points
              ("Area_5_office_2", (5.0, 5.0, 3.0)))   # 25 blocks, padded to 32


def surface_room(rng: np.random.Generator, size, per_m2: int = 2000):
    """A raw S3DIS room [N_raw, 7] (xyz in metres from the min corner, rgb
    0-255, label) sampled on surfaces as scans are: floor (1), ceiling
    (0), four walls (2), a table top (7) and a bookcase face (10), with
    clutter (12) in the volume; colours by class with noise."""
    sx, sy, sz = size
    parts = []

    def plane(n, lab, x, y, z):
        parts.append((np.stack([x, y, z], 1), np.full(n, lab)))

    for lab, z in ((1, 0.0), (0, sz)):
        n = int(sx * sy * per_m2)
        plane(n, lab, rng.uniform(0, sx, n), rng.uniform(0, sy, n), np.full(n, z))
    for fixed, length, along_x in ((0.0, sx, True), (sy, sx, True),
                                   (0.0, sy, False), (sx, sy, False)):
        n = int(length * sz * per_m2 / 2)
        t, z = rng.uniform(0, length, n), rng.uniform(0, sz, n)
        c = np.full(n, fixed)
        plane(n, 2, *((t, c, z) if along_x else (c, t, z)))
    n = int(1.2 * 0.8 * per_m2)
    plane(n, 7, rng.uniform(1.0, 2.2, n), rng.uniform(1.0, 1.8, n), np.full(n, 0.75))
    n = int(2.0 * 1.8 * per_m2)
    plane(n, 10, rng.uniform(2.5, 4.5, n), np.full(n, 0.3), rng.uniform(0, 1.8, n))
    n = int(sx * sy * per_m2 * 0.05)
    plane(n, 12, *(rng.uniform(0, m, n) for m in size))
    xyz = np.concatenate([p[0] for p in parts])
    lab = np.concatenate([p[1] for p in parts])
    rgb = np.clip(lab[:, None] * 19.0 + rng.normal(0, 20, (len(lab), 3)), 0, 255)
    return np.concatenate([xyz, rgb, lab[:, None]], 1)


def write_raw_area(base: str, rng: np.random.Generator) -> None:
    """The raw test area the S3DIS test CLI reads (numpy only):
    meta/area5_data_label.txt listing one .npy per room of TEST_ROOMS."""
    import os

    os.makedirs(os.path.join(base, "meta"), exist_ok=True)
    os.makedirs(os.path.join(base, "rooms"), exist_ok=True)
    rows = []
    for name, size in TEST_ROOMS:
        np.save(os.path.join(base, "rooms", f"{name}.npy"), surface_room(rng, size))
        rows.append(f"rooms/{name}.npy")
    with open(os.path.join(base, "meta", "area5_data_label.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


def run_test_cli(argv, pred_dir, kernels):
    """cli.test_s3dis.main(argv) with every kernel's count reset and the
    room-LP CG's matvecs counted per call (propagate/label_prop.py::_cg);
    returns (result, launches, [matvecs per CG], wall s). The per-room
    .mat files and PerClassIoU.mat must be written, the mIoU finite."""
    import os
    import shutil

    import torch

    from weaksuppointcloudseg_tpu_torch.cli import test_s3dis
    from weaksuppointcloudseg_tpu_torch.propagate import label_prop

    shutil.rmtree(pred_dir, ignore_errors=True)
    cg, matvecs = label_prop._cg, []

    def counting_cg(matvec, *a, **kw):
        matvecs.append(0)

        def mv(v):
            matvecs[-1] += 1
            return matvec(v)
        return cg(mv, *a, **kw)

    with patched(label_prop, "_cg", counting_cg):
        t0 = time.perf_counter()
        res, launches = count_launches(kernels, lambda: test_s3dis.main(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    want = sorted([f"{name}_pred_gt.mat" for name, _ in TEST_ROOMS]
                  + ["PerClassIoU.mat"])
    got = sorted(os.listdir(pred_dir)) if os.path.isdir(pred_dir) else []
    require(got == want, f"test CLI wrote {got}, expected {want}")
    require(np.isfinite(res["miou"]) and 0.0 <= res["miou"] <= 1.0,
            f"test CLI mIoU {res['miou']}")
    return res, launches, matvecs, wall


def phase_s3dis_test(report) -> None:
    """The S3DIS test path through cli.test_s3dis at full width: per-block
    LP (B1/B7/B8, no B10) and --RoomLP (B10 once for the degrees and once
    per CG iteration, per room); then bench.py's S3DIS test metrics."""
    import os
    import tempfile

    import torch

    from weaksuppointcloudseg_tpu_torch.ops import (
        affinity,
        conv_kmax,
        edgeconv,
        room_sweep,
    )
    from weaksuppointcloudseg_tpu_torch.propagate import label_prop
    from weaksuppointcloudseg_tpu_torch.train.steps import make_eval_logits_fn
    from weaksuppointcloudseg_tpu_torch.utils.checkpoint import save_checkpoint

    print("phase 8: S3DIS test path end to end (cli.test_s3dis), full width, "
          "bf16, knn_fast, -bs 14: per-block LP, then --RoomLP")
    kernels = {"knn_edge (B1)": edgeconv.knn_edge,
               "conv_zmax (B7)": conv_kmax.conv_zmax,
               "conv_znmax (B8)": conv_kmax.conv_znmax,
               "affinity_matvec_t (B10)": affinity.affinity_matvec_t,
               "block_members (RS1)": room_sweep.block_members,
               "gather_blocks (RS2)": room_sweep.gather_blocks}
    _, model = full_width_model(seed=2, preset="s3dis_config")
    with tempfile.TemporaryDirectory() as tmp:
        data_path = f"{tmp}/indoor3d_sem_seg_hdf5_data"
        write_s3dis_split(data_path, np.random.default_rng(3), 2, 2)
        write_raw_area(tmp, np.random.default_rng(4))
        os.makedirs(f"{tmp}/run/Checkpoint")
        ckpt = save_checkpoint(f"{tmp}/run/Checkpoint/ckpt.npz", model)
        argv = ["--DataPath", data_path, "--RoomsPath", tmp, "--Checkpoint",
                ckpt, "-sty", "Full", "-bs", str(RB // 2), "--Precision",
                "bfloat16", "--FastKNN"]
        pred_dir = f"{tmp}/run/Prediction"
        res, launches, matvecs, wall = run_test_cli(argv, pred_dir, kernels)
        print(f"  per-block LP: {wall:.2f} s wall for {len(TEST_ROOMS)} rooms "
              f"(first calls included); mIoU {res['miou']:.4f}; launches "
              f"{launches}; CG matvecs {matvecs}")
        check_path_launches(report, launches, "affinity_matvec_t (B10)",
                            (), "the per-block test path")
        res, launches, matvecs, wall = run_test_cli(
            argv + ["--RoomLP"], pred_dir, kernels)
        print(f"  --RoomLP: {wall:.2f} s wall; mIoU {res['miou']:.4f}; launches "
              f"{launches}; CG matvecs per room {matvecs}")
    b10 = launches["affinity_matvec_t (B10)"]
    require(len(matvecs) == len(TEST_ROOMS) and b10 == sum(1 + m for m in matvecs),
            f"B10 launched {b10} times for CGs of {matvecs} matvecs")
    require(all(n > 0 for n in launches.values()),
            f"a kernel did not launch on the --RoomLP path: {launches}")
    require(launches["block_members (RS1)"] == launches["gather_blocks (RS2)"]
            == len(TEST_ROOMS), f"the room sweep's kernels: {launches}")
    for row in report:
        if row["name"] in ("affinity_matvec_t (B10)", "block_members (RS1)",
                           "gather_blocks (RS2)"):
            row["launches"] = launches[row["name"]]

    # bench.py's S3DIS test metrics: 14 blocks x 4096 points of surface-
    # sampled 1 m blocks, per-block LP on its sharpened trained_like
    # probabilities; one room LP of its 131,072-point room
    card = card_line()
    dev = torch.device("cuda")
    model = model.to(dev).eval()
    logits_fn = make_eval_logits_fn(model)
    bs, n = RB // 2, RN
    rng = np.random.default_rng(0)
    n_surf = int(n * 0.7)
    xy = rng.uniform(0, 1, (bs, n_surf, 2)).astype(np.float32)
    which = rng.integers(0, 4, (bs, n_surf))
    z = np.where(which == 0, 0.0, np.where(which == 1, 3.0,
                 rng.uniform(0, 3.0, (bs, n_surf))))
    x0 = np.where(which == 2, np.round(xy[..., 0]), xy[..., 0])
    surf = np.stack([x0, xy[..., 1], z], -1)
    interior = rng.uniform(0, 1, (bs, n - n_surf, 3)) * np.array([1.0, 1.0, 3.0])
    xyz = np.concatenate([surf, interior], 1).astype(np.float32)
    rgb = rng.uniform(0, 1, (bs, n, 3)).astype(np.float32)
    feat = np.concatenate([xyz - xyz.mean(1, keepdims=True), rgb,
                           xyz / np.array([1.0, 1.0, 3.0], np.float32)], -1)
    x = torch.from_numpy(feat.astype(np.float32)).to(dev)
    d_xyz, d_rgb = torch.from_numpy(xyz).to(dev), torch.from_numpy(rgb).to(dev)
    sharp = torch.from_numpy(rng.standard_normal((bs, n, 13)).astype(
        np.float32) * 5.0).to(dev)

    def forward():
        with torch.inference_mode():
            return torch.softmax(logits_fn(x), -1)

    def e2e():
        with torch.inference_mode():
            prob = torch.softmax(torch.log(forward() + 1e-9) + sharp, -1)
            return label_prop.propagate_batch(d_xyz, prob, d_rgb)

    torch.cuda.reset_peak_memory_stats()
    fwd_ms, e2e_ms = timed_ms(forward), timed_ms(e2e)
    MEASURED["s3dis_eval_forward_throughput"] = fwd_ms
    for metric, ms in (("s3dis_eval_forward_throughput", fwd_ms),
                       ("s3dis_test_e2e_throughput", e2e_ms)):
        print(f"  {metric}: {ms:.3f} ms per {bs}x{n} batch, "
              f"{bs * n / ms * 1e3:.0f} points/s [{card}]")
    print(f"  peak device memory of the block test path "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    device_breakdown(e2e, card, what="s3dis e2e")

    room = [torch.from_numpy(a).to(dev) for a in bench_room(LN)]
    before = affinity.affinity_matvec_t.launches
    y = label_prop.propagate_batch(*room, solver="cg_matfree")
    torch.cuda.synchronize()
    iters = affinity.affinity_matvec_t.launches - before - 1
    require(bool(torch.isfinite(y).all()) and y.shape == (1, LN, 13),
            "room LP output")
    torch.cuda.reset_peak_memory_stats()
    room_ms = timed_ms(lambda: label_prop.propagate_batch(*room, solver="cg_matfree"),
                       reps=5, warmup=1)
    print(f"  s3dis_room_lp_131072: {room_ms:.3f} ms per room of {LN} points, "
          f"{iters} CG iterations ({(room_ms) / (iters + 1):.3f} ms per B10 "
          f"launch with its CG step) [{card}]")
    print(f"  peak device memory of the room LP "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    device_breakdown(lambda: label_prop.propagate_batch(*room, solver="cg_matfree"),
                     card, runs=2, what="room LP")

    # the room LP on the card against the CPU's plain version on a compact
    # part of the room at its full density: 4096 consecutive points in
    # Morton order (about 4 x 2 x 0.75 m). Probabilities within 1e-3 (the
    # CG's f32 error level), argmax agreement >= 99.9%; and the LP must move
    # its input there (>= 1% of argmaxes changed on both devices; 1.95% on
    # the CPU), or agreement would not show that B10 coupled any points
    part = affinity.morton_order(room[0]).long()[0, :4096]
    small = [t[:, part] for t in room]
    got = label_prop.propagate_batch(*small, solver="cg_matfree").cpu()
    want = label_prop.propagate_batch(*[t.cpu() for t in small], solver="cg_matfree")
    dy = (got - want).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    g_arg = small[1].argmax(-1).cpu()
    changed = [(y.argmax(-1) != g_arg).float().mean().item() for y in (got, want)]
    moved = (got - small[1].cpu()).abs().max().item()
    print(f"  room LP on 4096 Morton-consecutive points, card vs CPU plain: "
          f"max |dy| {dy:.2e}, argmax agreement {agree:.5f}; argmaxes the LP "
          f"changed {changed[0]:.4f} (card) {changed[1]:.4f} (CPU), max "
          f"|y - g| {moved:.3f}")
    require(min(changed) >= 0.01, "the room LP barely moved its input")
    require(dy <= 1e-3 and agree >= 0.999, "the card's room LP disagrees")


def fused_step_vs_cpu(model_cfg, sub, seed):
    """One fused bf16 training step (forward_fused + masked CE + backward)
    of a model with seeded random weights on ``sub``, on the card and over
    the plain versions on the CPU, the CPU replaying the card's kNN indices
    and in-kernel BN moments (utils/replay.py; without the replay the
    moments, which the kernels sum in another fixed order than the CPU,
    move later features by an ulp and the last stage's kNN picks other
    near-tied neighbours, which moves gradients discretely): what differs
    is each kernel's summation order, the same on every run (ROADMAP C16). Each fused
    block of the card's step is also rerun on its own on both devices at
    its recorded inputs and output cotangent (utils/replay.py::
    block_errors). Returns (loss rel err, logits rel RMS, {leaf: error},
    the null-gradient leaves, [(block, {output or input: error})])."""
    import contextlib

    from weaksuppointcloudseg_tpu_torch.losses.weaksup import masked_softmax_ce
    from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
    from weaksuppointcloudseg_tpu_torch.utils import replay

    outs, tape, blocks = [], None, None
    for dev in ("cuda", "cpu"):
        model = DGCNNSeg(model_cfg, seed=seed).to(dev)
        x = sub["data"].to(dev)
        cat = sub["cat_onehot"].to(dev)
        with (replay.record() if dev == "cuda" else replay.replay(tape)) as t, \
                (replay.record_blocks() if dev == "cuda"
                 else contextlib.nullcontext()) as b:
            logits = model.forward_fused(x, cat, training=True, bn_decay=0.5)
        tape, blocks = tape or t, blocks or b
        loss = masked_softmax_ce(logits, sub["seg_onehot"].to(dev),
                                 sub["mask"].to(dev))
        loss.backward()
        outs.append((float(loss.detach()), logits.detach().float().cpu(),
                     {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (got_l, got_lg, got_g), (want_l, want_lg, want_g) = outs
    errs, null = replay.grad_errors(model, got_g, want_g)
    block_errs = [(e["block"].__name__.strip("_"), replay.block_errors(e))
                  for e in blocks]
    return (abs(got_l - want_l) / abs(want_l),
            ((got_lg - want_lg).norm() / want_lg.norm()).item(), errs, null,
            block_errs)


# ---------------------------------------------------------------- phase 9

def static_kernels():
    """The kernels of the static-graph paths: the fused training and eval
    kernels with B11, and B12/B13 of the f32 route."""
    from weaksuppointcloudseg_tpu_torch.ops import edgeconv, knn, scatter

    return {**fused_train_kernels(),
            "knn_edge_pre (B11)": edgeconv.knn_edge_pre,
            "knn (B12)": knn.knn, "scatter_add (B13)": scatter.scatter_add}


def check_launch_counts(launches, want, what) -> None:
    """Each kernel of ``want`` launched exactly that many times."""
    for name, n in want.items():
        require(launches[name] == n, f"{what}: {name} launched "
                f"{launches[name]} times, expected {n}")


def phase_static_graph(report) -> None:
    """Static-graph mode (--StaticGraph) end to end: the bf16 Full-style
    training CLIs of ShapeNet and S3DIS, the ShapeNet test CLI, one f32
    step, one bf16 step against the CPU; one graph per forward, B11 in
    every other EdgeConv stage."""
    import dataclasses
    import tempfile

    import torch

    from weaksuppointcloudseg_tpu_torch import configs
    from weaksuppointcloudseg_tpu_torch.cli import test_shapenet
    from weaksuppointcloudseg_tpu_torch.train.loop import ShapeNetTrainer
    from weaksuppointcloudseg_tpu_torch.utils.checkpoint import save_checkpoint

    print(f"phase 9: static-graph mode end to end (--StaticGraph): bf16 Full "
          f"training of ShapeNet ({PB} x 2 x {PN}) and S3DIS ({RB // 2} x 2 x "
          f"{RN}), the ShapeNet test CLI, an f32 step, a step against the CPU")
    kernels = static_kernels()
    main_path = 0  # B11's launches on this phase's CLI runs
    card = card_line()

    # ShapeNet: the graph is the transform stage's (B1 once per forward),
    # shared with the smoothness loss (B6 gather, no B9); B11 in the three
    # EdgeConv stages; no B12
    res, launches, wall, ds = shapenet_full_cli(kernels, "--StaticGraph")
    print(f"  ShapeNet cli run (1 epoch: 3 steps + evaluate of 24 val clouds): "
          f"{wall:.2f} s wall; launches {launches}")
    check_full_epoch(res)
    fwd = 3 + 1  # training forwards and evaluation batches
    check_launch_counts(launches, {
        "knn_edge (B1)": fwd, "knn_edge_pre (B11)": 3 * fwd,
        "knn_wgather (B9)": 0, "knn (B12)": 0, "wgather_pre (B6)": 3,
        "conv_minmax (B2)": 3 * 3, "conv_zmax (B7)": 3, "conv_znmax (B8)": 2},
        "static bf16 Full ShapeNet")
    main_path += launches["knn_edge_pre (B11)"]
    trainer, batch = full_trainer(ds, "shapenet", static_graph=True)
    time_fixed_batch(trainer, batch, PB * PN,
                     "shapenet_full_train_throughput_static_graph",
                     "static bf16 Full ShapeNet train step")
    repeat_step(trainer.model, trainer.opt, trainer.generator,
                lambda: trainer.train_step(batch, 1.0, trainer.generator),
                f"static bf16 Full ShapeNet step, {PB} x 2 x {PN}")

    # one static bf16 step of two distinct clouds on the card against the
    # plain versions on the CPU replaying the card's graph and moments,
    # with phase 5's limits
    small = dataclasses.replace(trainer.cfg.model,
                                head_keep_prob=(None, None, None))
    sub = {k: v[0:4:2] for k, v in batch.items()}
    loss_err, lg_err, errs, null, block_errs = fused_step_vs_cpu(small, sub, 1)
    leaf = max(e for n, e in errs.items()
               if n not in null and n != "agg_conv.beta")
    null_err = max(e for n, e in errs.items() if n in null)
    block_worst = max((e, f"{name}.{k}") for name, be in block_errs
                      for k, e in be.items())
    print(f"  CUDA vs CPU replaying the card's graph and moments, one static "
          f"bf16 step, 2 x {PN} points: blocks worst {block_worst[1]} "
          f"{block_worst[0]:.2e}; loss rel err {loss_err:.2e}, logits rel RMS "
          f"{lg_err:.2e}, worst leaf {leaf:.2e}, null-gradient biases "
          f"{null_err:.2e}")
    require(block_worst[0] <= 1e-2, f"CUDA static block disagrees: {block_errs}")
    require(loss_err <= 2e-3 and lg_err <= 0.1 and leaf <= 0.4
            and null_err <= 1.5e-2, "CUDA static step disagrees with the CPU")

    # f32 static: one B12 kNN per forward (the step adds the smoothness
    # loss's own kNN on xyz: the f32 route reuses no graph), the stages'
    # gathers and the smoothness loss's backward through B13; no fused
    # kernel
    base = configs.shapenet_config()
    f32 = dataclasses.replace(
        base, model=dataclasses.replace(base.model, static_graph=True),
        train=dataclasses.replace(base.train, batch_size=8, rampup=0))
    trainer = ShapeNetTrainer(f32, ds, trainer.pts_idx, seed=0, device="cuda")
    b = next(ds.batches("train", 8))
    batch = trainer._to_device(trainer._assemble(
        b, siamese=True, augment_pairs=True, full_mask=False))
    out, launches = count_launches(
        kernels, lambda: trainer.train_step(batch, 1.0, trainer.generator))
    _, eval_launches = count_launches(
        kernels, lambda: trainer.eval_step(batch))
    torch.cuda.synchronize()
    print(f"  f32 static step, 8 x 2 x {PN} points: launches {launches}; "
          f"an eval forward: B12 {eval_launches['knn (B12)']}")
    check_launch_counts(launches, {
        "knn (B12)": 2, "scatter_add (B13)": 4, "knn_edge (B1)": 0,
        "knn_edge_pre (B11)": 0}, "f32 static step")
    check_launch_counts(eval_launches, {"knn (B12)": 1}, "f32 static eval")
    require(all(bool(torch.isfinite(v)) for v in out.values()
                if torch.is_tensor(v)), f"f32 static step: {out}")
    del trainer, batch
    torch.cuda.empty_cache()

    # the ShapeNet test CLI on phase 3's test set: per batch B1 once, B11
    # three times, B7 and B8 as in the dynamic run
    with tempfile.TemporaryDirectory() as tmp:
        write_raw_testset(tmp)
        ckpt = save_checkpoint(f"{tmp}/ckpt.npz", full_width_model()[1])
        argv = ["--DataPath", tmp, "--Checkpoint", ckpt, "--Precision",
                "bfloat16", "--FastKNN", "--StaticGraph", "--batchsize", str(B)]
        t0 = time.perf_counter()
        res, launches = count_launches(kernels, lambda: test_shapenet.main(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    batches = launches["conv_znmax (B8)"] // 2
    print(f"  test cli run --StaticGraph: {wall:.2f} s wall, {batches} "
          f"batches; launches {launches}")
    check_launch_counts(launches, {
        "knn_edge (B1)": batches, "knn_edge_pre (B11)": 3 * batches,
        "conv_zmax (B7)": 3 * batches, "knn (B12)": 0}, "static test CLI")
    require(batches > 0, "the static test CLI ran no batch")
    for key in ("perdata_miou", "pershape_miou", "accuracy"):
        require(np.isfinite(res[key]) and 0.0 <= res[key] <= 1.0,
                f"static test metric {key} = {res[key]}")
    main_path += launches["knn_edge_pre (B11)"]

    # S3DIS: stage 0 produces the graph (B1 once per forward), stages 1 and
    # 2 reuse it (B11 twice); the smoothness loss selects on xyzrgb (B9)
    res, launches, wall, ds = s3dis_full_cli(kernels, "--StaticGraph")
    print(f"  S3DIS cli run (1 epoch: 3 steps + evaluate of {RB // 2} Area_5 "
          f"blocks): {wall:.2f} s wall; launches {launches}")
    check_full_epoch(res)
    check_launch_counts(launches, {
        "knn_edge (B1)": fwd, "knn_edge_pre (B11)": 2 * fwd,
        "knn_wgather (B9)": 3, "wgather_pre (B6)": 0, "knn (B12)": 0,
        "conv_zmax (B7)": 2, "conv_znmax (B8)": 1}, "static bf16 Full S3DIS")
    main_path += launches["knn_edge_pre (B11)"]
    trainer, batch = full_trainer(ds, "s3dis", static_graph=True)
    time_fixed_batch(trainer, batch, RB // 2 * RN,
                     "s3dis_full_train_throughput_static_graph",
                     "static bf16 Full S3DIS train step")
    for row in report:
        if row["name"] == "knn_edge_pre (B11)":
            row["launches"] = main_path
    print(f"  B11 launches on this phase's CLI runs: {main_path} [{card}]")


# --------------------------------------------------------------- phase 10

def phase_convergence(report) -> None:
    """The synthetic convergence recipes (utils/synth_convergence.py, 1024
    points, batch 8, 24 epochs) on the card, held to the reference's
    calibrated bars (tests/test_tpu_kernels.py:716-760, 918-931)."""
    from weaksuppointcloudseg_tpu_torch.utils import synth_convergence as sc

    print("phase 10: convergence on the learnable synthetic sets")
    card = card_line()

    def run(what, fn):
        t0 = time.perf_counter()
        out = fn()
        print(f"  {what}: {out} in {time.perf_counter() - t0:.1f} s [{card}]")
        return out

    f32 = run("ShapeNet f32 exact kNN (data_seed 0) mIoU", lambda:
              sc.shapenet_train_and_eval_miou("float32", False, data_seed=0))
    fast = run("ShapeNet bf16 knn_fast (data_seed 0) mIoU", lambda:
               sc.shapenet_train_and_eval_miou("bfloat16", True, data_seed=0))
    static = run("ShapeNet bf16 knn_fast static graph (data_seed 0) mIoU",
                 lambda: sc.shapenet_train_and_eval_miou(
                     "bfloat16", True, static_graph=True, data_seed=0))
    miou, acc = run("S3DIS bf16 knn_fast (seed 0) (mIoU, accuracy)", lambda:
                    sc.s3dis_train_and_eval_miou("bfloat16", True, seed=0))
    bars = {"ShapeNet f32 mIoU > 0.5": f32 > 0.5,
            "ShapeNet bf16 fast mIoU > 0.5": fast > 0.5,
            "ShapeNet bf16 fast within 0.11 of f32": fast > f32 - 0.11,
            "ShapeNet static graph mIoU > 0.5": static > 0.5,
            "S3DIS mIoU > 0.35": miou > 0.35, "S3DIS accuracy > 0.5": acc > 0.5}
    print("  bars: " + ", ".join(f"{k}: {'met' if ok else 'MISSED'}"
                                 for k, ok in bars.items()))
    require(all(bars.values()), "a convergence run is below its bar")


# --------------------------------------------------------------- phase 11

def unfused_kernels():
    """The kernels an unfused route (``use_fused_knn=False``) may reach,
    with those it must not: B14's gathers, B13's scatter, B12 (only in
    the smoothness loss), and the fused blocks' B1/B7/B8."""
    from weaksuppointcloudseg_tpu_torch.ops import (
        conv_kmax,
        edgeconv,
        gather,
        knn,
        scatter,
    )

    return {"gather_rows (B14)": gather.gather_rows,
            "scatter_add (B13)": scatter.scatter_add, "knn (B12)": knn.knn,
            "knn_edge (B1)": edgeconv.knn_edge,
            "conv_zmax (B7)": conv_kmax.conv_zmax,
            "conv_znmax (B8)": conv_kmax.conv_znmax}


def unfused_model(preset: str, dtype: str, seed: int):
    """``full_width_model``'s weights without the fused kNN, in ``dtype``
    (f32: exact kNN, bench.py's xla_everywhere configuration)."""
    import dataclasses

    from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg

    cfg, model = full_width_model(seed=seed, preset=preset)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, use_fused_knn=False,
                              knn_fast=dtype == "bfloat16")
    unfused = DGCNNSeg(cfg)
    unfused.load_state_dict(model.state_dict())
    return unfused.cuda().eval()


def eval_inputs(preset: str):
    """bench.py's eval batches: 32 unit-sphere ShapeNet views of 3000 points
    with categories, or 14 S3DIS blocks of 4096 points (phase 8's)."""
    import torch

    from weaksuppointcloudseg_tpu_torch.utils.tools import onehot_encode

    rng = np.random.default_rng(0)
    if preset == "shapenet_config":
        xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
        xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True).max(1, keepdims=True)
        cat = torch.from_numpy(onehot_encode(rng.integers(0, 16, B), 16))
        return torch.from_numpy(xyz).cuda(), cat.cuda()
    bs, n = RB // 2, RN
    xyz = rng.uniform(0, 1, (bs, n, 3)) * np.array([1.0, 1.0, 3.0])
    rgb = rng.uniform(0, 1, (bs, n, 3))
    feat = np.concatenate([xyz - xyz.mean(1, keepdims=True), rgb,
                           xyz / np.array([1.0, 1.0, 3.0])], -1)
    return torch.from_numpy(feat.astype(np.float32)).cuda(), None


def unfused_forward(preset, dtype, report_counts, card):
    """One eval forward of the unfused ``dtype`` model at bench.py's eval
    shape, with its launch counts, then its time (median of 10) and peak
    memory. Returns (ms, launches, the forward)."""
    import torch

    model = unfused_model(preset, dtype, seed=0 if preset == "shapenet_config"
                          else 2)
    x, cat = eval_inputs(preset)

    def forward():
        with torch.inference_mode():
            return model(x, cat)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, launches = count_launches(unfused_kernels(), forward)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out).all()) and out.shape[:2] == x.shape[:2],
            f"unfused {dtype} {preset} forward output")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = timed_ms(forward)
    print(f"  {preset.split('_')[0]} {dtype} eval forward, {x.shape[0]} x "
          f"{x.shape[1]}: {ms:.3f} ms, {x.shape[0] * x.shape[1] / ms * 1e3:.0f} "
          f"points/s; peak device memory {peak:.2f} GiB; launches {launches} "
          f"[{card}]")
    report_counts.append(launches["gather_rows (B14)"])
    return ms, launches, forward


def unfused_step_vs_cpu(cfg, sub):
    """One bf16 unfused Full-style step (forward, the four losses, backward)
    of full-width random weights on ``sub`` on the card and on the CPU, the
    CPU replaying the card's kNN graphs and batch moments
    (utils/replay.py::record_plain): exact ties of bf16 distances may be
    ordered differently by the two devices, and one ulp of a moment moves
    every later rounding. Returns (loss rel err, logits rel RMS, {leaf:
    error}, the null-gradient leaves)."""
    from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg
    from weaksuppointcloudseg_tpu_torch.train.steps import loss_fn
    from weaksuppointcloudseg_tpu_torch.utils import replay

    outs, tape = [], None
    for dev in ("cuda", "cpu"):
        model = DGCNNSeg(cfg.model, seed=1).to(dev)
        with (replay.record_plain() if dev == "cuda"
              else replay.replay_plain(tape)) as t:
            total, comps, logits = loss_fn(
                model, {k: v.to(dev) for k, v in sub.items()}, cfg=cfg,
                style="Full", bn_decay=0.5, gate=1.0)
            total.backward()
        tape = tape or t
        outs.append(({k: float(v.detach()) for k, v in comps.items()},
                     logits.detach().float().cpu(),
                     {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (got_c, got_l, got_g), (want_c, want_l, want_g) = outs
    errs, null = replay.grad_errors(model, got_g, want_g)
    # agg_conv.beta's true gradient cancels too: the global feature feeds
    # seg_conv1, whose batch-moment BN makes its cotangent sum to zero over
    # the clouds, so on every channel that is active in every cloud the
    # sum over clouds is rounding noise; it is held like the biases
    top = max(float(w.double().norm()) for w in want_g.values())
    errs["agg_conv.beta"] = float(
        (got_g["agg_conv.beta"] - want_g["agg_conv.beta"]).double().norm()) / top
    null = null | {"agg_conv.beta"}
    return (max(abs(got_c[k] - want_c[k]) / abs(want_c[k]) for k in want_c),
            ((got_l - want_l).norm() / want_l.norm()).item(), errs, null)


def lp_inputs(n: int, seed: int = 0):
    """bench.py::time_lp's inputs: one cloud of n standard-normal points
    scaled into the unit sphere, probabilities a softmax of standard-normal
    logits over 50 classes; rgb=None (ShapeNet's LP)."""
    import torch

    rng = np.random.default_rng(seed)
    xyz = rng.standard_normal((1, n, 3)).astype(np.float32)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True).max(1, keepdims=True)
    g = torch.softmax(torch.from_numpy(
        rng.standard_normal((1, n, 50)).astype(np.float32)), -1)
    return torch.from_numpy(xyz).cuda(), g.cuda()


def check_solve_f64(card):
    """The card's f32 LU (solver "solve") at lp_dense_lu_3000's inputs
    against an f64 solve of the same f32 system: the normwise error within
    kappa * sqrt(N) * 2^-24, the usual estimate of an f32 LU's forward
    error (ROADMAP C1: a TF32 product would miss it by ~100x)."""
    import torch

    from weaksuppointcloudseg_tpu_torch.propagate import label_prop, laplacian

    xyz, g = lp_inputs(N)
    lap = laplacian.laplacian_xyz_rgb(xyz, xyz)
    y, _, w = label_prop.label_propagation(lap, g)
    a = lap[0].double() + torch.diag(w[0].double() + 1e-5)
    y64 = torch.linalg.solve(a, (w[0, :, None] * g[0]).double())
    ev = torch.linalg.eigvalsh(a)
    kappa = (ev.max() / ev.min()).item()
    err = ((y[0].double() - y64).norm() / y64.norm()).item()
    limit = kappa * N ** 0.5 * 2.0 ** -24
    print(f"  solve vs f64 at lp_dense_lu_3000's inputs: normwise rel err "
          f"{err:.3e}, kappa {kappa:.2f}, bound kappa sqrt(N) 2^-24 = "
          f"{limit:.3e} [{card}]")
    require(kappa > 0 and err <= limit, "the card's LU misses its f64 bound")


def unfused_routes(card, lap):
    """Phase 11's model runs: the bf16 unfused eval forwards of both
    presets, a bf16 unfused Full-style ShapeNet step (and against the CPU),
    bench.py's f32 xla_everywhere_baseline and vs_xla_everywhere. Returns
    B14's launches on the counted runs."""
    import dataclasses
    import tempfile

    import torch

    main_path = []
    # bf16 eval forwards: B14 per gather, no selection kernel
    for preset, want in (("shapenet_config", 4), ("s3dis_config", 3)):
        _, launches, forward = unfused_forward(preset, "bfloat16", main_path,
                                               card)
        check_launch_counts(launches, {
            "gather_rows (B14)": want, "knn_edge (B1)": 0, "conv_zmax (B7)": 0,
            "conv_znmax (B8)": 0, "knn (B12)": 0, "scatter_add (B13)": 0},
            f"bf16 unfused {preset} eval forward")
        if preset == "shapenet_config":
            device_breakdown(forward, card, what="bf16 unfused eval forward")

    lap("eval forwards")
    # a bf16 Full-style ShapeNet step through ShapeNetTrainer at bench.py's
    # shape (knn_fast in the smoothness loss's B12)
    rng = np.random.default_rng(1)  # phase 5's split
    splits = {"train": synthetic_split(3 * PB, rng),
              "val": synthetic_split(24, rng)}
    with tempfile.TemporaryDirectory() as tmp:
        ds = in_memory_dataset(tmp, splits)
        ds.split("train")
        ds.split("val")
    trainer, batch = full_trainer(ds, "shapenet", use_fused_knn=False)
    _, launches = count_launches(
        unfused_kernels(),
        lambda: trainer.train_step(batch, 1.0, trainer.generator))
    torch.cuda.synchronize()
    print(f"  bf16 unfused Full step, {PB} x 2 x {PN}: launches {launches}")
    check_launch_counts(launches, {
        "gather_rows (B14)": 4, "scatter_add (B13)": 4, "knn (B12)": 1,
        "knn_edge (B1)": 0}, "bf16 unfused Full step")
    main_path.append(launches["gather_rows (B14)"])
    time_fixed_batch(trainer, batch, PB * PN,
                     "shapenet_full_train_throughput (bf16, use_fused_knn="
                     "False)", "bf16 unfused Full train step")
    # the step on the card against the CPU at 2 unique x 2 clouds, dropout
    # off, phase 5's limits: loss 2e-3 relative, logits 0.1 relative RMS,
    # every leaf 0.4 of its norm, the null-gradient leaves (the conv biases
    # in front of a BN, and agg_conv.beta) 1.5e-2 of the largest leaf norm
    # (what differs, with the graphs and moments replayed, is each conv's
    # f32 summation order before its bf16 rounding)
    small = dataclasses.replace(trainer.cfg, model=dataclasses.replace(
        trainer.cfg.model, head_keep_prob=(None, None, None)))
    sub = {k: v[:4] for k, v in batch.items()}
    loss_err, lg_err, errs, null = unfused_step_vs_cpu(small, sub)
    leaf = sorted((e, n) for n, e in errs.items() if n not in null)
    null_err = max(e for n, e in errs.items() if n in null)
    print(f"  CUDA vs CPU replaying the card's graphs and moments, one bf16 "
          f"unfused step, 2 x 2 x {PN} points: loss rel err {loss_err:.2e}, "
          f"logits rel RMS {lg_err:.2e}, leaf gradients (relative norm of "
          f"the difference), worst: " + ", ".join(
              f"{n} {e:.2e}" for e, n in leaf[-3:][::-1])
          + f"; median {leaf[len(leaf) // 2][0]:.2e}; null-gradient leaves "
          f"{null_err:.2e} of the largest leaf norm (agg_conv.beta "
          f"{errs['agg_conv.beta']:.2e})")
    require(loss_err <= 2e-3 and lg_err <= 0.1 and leaf[-1][0] <= 0.4
            and null_err <= 1.5e-2, "the bf16 unfused step disagrees with "
            "the CPU")
    del trainer, batch
    torch.cuda.empty_cache()
    lap("bf16 unfused step and its CPU check")

    # bench.py's anchor: f32, no fused kNN, exact selection (the plain
    # distance + stable sort on the card)
    trainer, batch = full_trainer(ds, "shapenet", compute_dtype="float32",
                                  use_fused_knn=False, knn_fast=False)
    _, launches = count_launches(
        unfused_kernels(),
        lambda: trainer.train_step(batch, 1.0, trainer.generator))
    check_launch_counts(launches, {
        "gather_rows (B14)": 0, "scatter_add (B13)": 4, "knn (B12)": 1,
        "knn_edge (B1)": 0}, "f32 unfused Full step")
    xla_ms = time_fixed_batch(trainer, batch, PB * PN,
                              "xla_everywhere_baseline", "f32 unfused Full step")
    del trainer, batch
    torch.cuda.empty_cache()
    ratios = {"shapenet_full_train_throughput":
              xla_ms / MEASURED["shapenet_full_train_throughput"]}
    for preset, metric in (("shapenet_config", "shapenet_eval_forward_throughput"),
                           ("s3dis_config", "s3dis_eval_forward_throughput")):
        ms, launches, _ = unfused_forward(preset, "float32", [], card)
        check_launch_counts(launches, {
            "gather_rows (B14)": 0, "knn_edge (B1)": 0, "knn (B12)": 0},
            f"f32 unfused {preset} eval forward")
        ratios[metric] = ms / MEASURED[metric]
    for metric, r in ratios.items():
        print(f"  {metric} vs_xla_everywhere: {r:.3f} (the f32 unfused time "
              f"over the metric's, both this run) [{card}]")

    return sum(main_path)


def lp_metrics(card, lap):
    """bench.py's LP metrics with its time_lp inputs, and the LU against
    f64."""
    import torch

    from weaksuppointcloudseg_tpu_torch.propagate import label_prop

    # bench.py's LP metrics: ms per sample, median of 10
    for solver, n, metric in (("solve", N, "lp_dense_lu_3000"),
                              ("cg", N, "lp_cg_factored_3000"),
                              ("cg_matfree", N, "lp_cg_matfree_3000"),
                              ("cg_matfree", 32768, "lp_cg_matfree_32768")):
        xyz, g = lp_inputs(n)
        torch.cuda.reset_peak_memory_stats()
        y = label_prop.propagate_batch(xyz, g, solver=solver)
        require(bool(torch.isfinite(y).all()) and y.shape == g.shape,
                f"{metric} output")
        ms = timed_ms(lambda: label_prop.propagate_batch(xyz, g, solver=solver))
        print(f"  {metric}: {ms:.3f} ms per sample; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        lap(metric)
    check_solve_f64(card)
    lap("the f64 check")



def solve_test_clis(card, lap):
    """Both test CLIs with --LPSolver solve: ShapeNet on phase 3's test set
    (the lagged loop's ms per batch and idle share), S3DIS on phase 8's
    area."""
    import os
    import tempfile

    import torch

    from weaksuppointcloudseg_tpu_torch.cli import test_shapenet
    from weaksuppointcloudseg_tpu_torch.train.loop import ShapeNetTrainer
    from weaksuppointcloudseg_tpu_torch.utils.checkpoint import save_checkpoint

    # the test CLIs with --LPSolver solve: ShapeNet on phase 3's test set
    # (the one-batch lag; its idle share), S3DIS on phase 8's area
    kernels = unfused_kernels()
    real_test, loops = ShapeNetTrainer.test, []

    def timed_test(self, *a, **kw):  # the trainer's loop alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_test(self, *a, **kw)
        torch.cuda.synchronize()
        loops.append((time.perf_counter() - t0) * 1e3)
        return out

    def profiled_test(self, *a, **kw):
        out = []
        loops.append(device_breakdown(
            lambda: out.append(real_test(self, *a, **kw)), card, runs=1,
            what="ShapeNetTrainer.test --LPSolver cg (lagged loop)"))
        return out[0]

    with tempfile.TemporaryDirectory() as tmp:
        write_raw_testset(tmp)
        ckpt = save_checkpoint(f"{tmp}/ckpt.npz", full_width_model()[1])
        argv = ["--DataPath", tmp, "--Checkpoint", ckpt, "--Precision",
                "bfloat16", "--FastKNN", "--batchsize", str(B), "--LPSolver",
                "solve"]
        test_shapenet.main(argv)  # first calls
        lap("the ShapeNet test CLI's first run")
        torch.cuda.reset_peak_memory_stats()
        with patched(ShapeNetTrainer, "test", timed_test):
            res, launches = count_launches(kernels,
                                           lambda: test_shapenet.main(argv))
        batches = launches["conv_znmax (B8)"] // 2
        print(f"  cli.test_shapenet --LPSolver solve: the test loop "
              f"{loops[-1]:.1f} ms for {batches} batches, "
              f"{loops[-1] / batches:.1f} ms per batch (test-set reads "
              f"included); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
              f"{launches} [{card}]")
        for key in ("perdata_miou", "pershape_miou", "accuracy"):
            require(np.isfinite(res[key]) and 0.0 <= res[key] <= 1.0,
                    f"test CLI --LPSolver solve: {key} = {res[key]}")
        lap("its timed run")
        # the idle share under the profiler with the default solver ("cg"):
        # MAGMA's batched LU launches kernels per column (pivot search, row
        # swaps), and one profiled run of this loop with it took ~7 minutes
        with patched(ShapeNetTrainer, "test", profiled_test):
            test_shapenet.main(argv[:-2])
        busy_ms, wall_ms = loops[-1]
        print(f"  idle share of the lagged test loop, --LPSolver cg (under "
              f"the profiler): 1 - busy {busy_ms:.3f} / wall {wall_ms:.3f} "
              f"ms = {1 - busy_ms / wall_ms:.3f}")
    lap("the ShapeNet test CLI")
    _, model = full_width_model(seed=2, preset="s3dis_config")
    with tempfile.TemporaryDirectory() as tmp:
        data_path = f"{tmp}/indoor3d_sem_seg_hdf5_data"
        write_s3dis_split(data_path, np.random.default_rng(3), 2, 2)
        write_raw_area(tmp, np.random.default_rng(4))
        os.makedirs(f"{tmp}/run/Checkpoint")
        ckpt = save_checkpoint(f"{tmp}/run/Checkpoint/ckpt.npz", model)
        argv = ["--DataPath", data_path, "--RoomsPath", tmp, "--Checkpoint",
                ckpt, "-sty", "Full", "-bs", str(RB // 2), "--Precision",
                "bfloat16", "--FastKNN", "--LPSolver", "solve"]
        res, launches, matvecs, wall = run_test_cli(
            argv, f"{tmp}/run/Prediction", kernels)
    print(f"  cli.test_s3dis --LPSolver solve: {wall:.2f} s wall for "
          f"{len(TEST_ROOMS)} rooms; mIoU {res['miou']:.4f}; CG runs "
          f"{len(matvecs)}; launches {launches} [{card}]")
    require(not matvecs, "the solve test path ran a CG")


def phase_unfused(report) -> None:
    """The unfused routes at full width (use_fused_knn=False): the bf16
    eval forwards of both presets and a bf16 Full-style ShapeNet step over
    B14 (backward B13, smoothness B12), against the CPU; bench.py's f32
    xla_everywhere_baseline and vs_xla_everywhere; the LP metrics with the
    dense LU; both test CLIs with --LPSolver solve."""
    print(f"phase 11: the unfused routes (use_fused_knn=False) at full width, "
          f"LP solve, the LP metrics")
    card = card_line()
    t_phase = time.perf_counter()

    def lap(what):
        print(f"  ({what}: {time.perf_counter() - t_phase:.1f} s into the "
              f"phase)")

    b14 = unfused_routes(card, lap)
    lap("xla_everywhere")
    lp_metrics(card, lap)
    solve_test_clis(card, lap)
    for row in report:
        if row["name"] == "gather_rows (B14)":
            row["launches"] = b14
    print(f"  B14 launches on this phase's counted runs: {b14}")


# --------------------------------------------------------------- phase 12

CB, CN, C_CLASSES = 32, 1024, 40  # the classifier's ModelNet40 batch


def class_clouds(labels, n, seed):
    """Learnable synthetic clouds: class c's points lie on an ellipsoid
    with axes from a fixed table (0.3-1.0 m), a fresh sample per cloud,
    plus 1 cm noise. numpy f32 [len(labels), n, 3]."""
    axes = np.random.default_rng(99).uniform(0.3, 1.0, (C_CLASSES, 3))
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((len(labels), n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = d * axes[labels][:, None, :] + 0.01 * rng.standard_normal(d.shape)
    return pts.astype(np.float32)


def cls_kernels():
    """Every kernel a classifier route can launch, and B15 (which none
    may)."""
    from weaksuppointcloudseg_tpu_torch.ops import edgeconv, gather, knn
    from weaksuppointcloudseg_tpu_torch.ops import knn_gather as kg
    from weaksuppointcloudseg_tpu_torch.ops import scatter

    return {**fused_train_kernels(),
            "knn_edge_pre (B11)": edgeconv.knn_edge_pre,
            "knn (B12)": knn.knn, "scatter_add (B13)": scatter.scatter_add,
            "gather_rows (B14)": gather.gather_rows,
            "knn_gather (B15)": kg.knn_gather}


# the launches of one classifier training step per route, and of the bf16
# fused eval forward: transform stage, four single-conv stages, aggregation
_CLS_FUSED = {"knn_edge (B1)": 5, "conv_minmax (B2)": 1, "conv_nmax (B5)": 2,
              "conv_kmax_bwd (B3)": 1, "scatter_bn_bwd (B4)": 5,
              "conv_nmax_bwd (B5)": 2}
CLS_ROUTES = (
    ("bf16 fused, knn_fast", "bfloat16", dict(knn_fast=True), _CLS_FUSED),
    ("bf16 fused static, knn_fast", "bfloat16",
     dict(knn_fast=True, static_graph=True),
     {**_CLS_FUSED, "knn_edge (B1)": 1, "knn_edge_pre (B11)": 4}),
    ("f32 exact", "float32", {}, {"knn (B12)": 5, "scatter_add (B13)": 4}),
)


def cls_step_fn(model, x, labels, opt, gen):
    """One classifier training step: forward (dropout from ``gen``),
    label-smoothed loss, backward, Adam at 1e-3. Returns the loss."""
    from weaksuppointcloudseg_tpu_torch.models.dgcnn_cls import (
        classification_loss,
    )

    def step():
        opt.zero_grad()
        logits = model(x, training=True, bn_decay=0.5, generator=gen)
        loss = classification_loss(logits, labels, model.cfg.label_smoothing)
        loss.backward()
        opt.apply_gradients(1e-3)
        return loss.detach()
    return step


def cls_step_vs_cpu(cfg, x, labels, seed):
    """One bf16 fused classifier training step (dropout off) on the card
    and over the plain versions on the CPU, the CPU replaying the card's
    kNN indices, in-kernel moments and batch moments (utils/replay.py);
    each fused block is also rerun alone on both devices. Returns (loss rel
    err, logits rel RMS, {leaf: error}, null-gradient leaves, [(block,
    {name: error})])."""
    import contextlib

    from weaksuppointcloudseg_tpu_torch.models.dgcnn_cls import (
        DGCNNCls,
        classification_loss,
    )
    from weaksuppointcloudseg_tpu_torch.utils import replay

    outs, tapes, blocks = [], None, None
    for dev in ("cuda", "cpu"):
        model = DGCNNCls(cfg, seed=seed).to(dev)
        ctx = ((replay.record(), replay.record_plain(), replay.record_blocks())
               if dev == "cuda" else
               (replay.replay(tapes[0]), replay.replay_plain(tapes[1]),
                contextlib.nullcontext()))
        with ctx[0] as t0, ctx[1] as t1, ctx[2] as bl:
            logits = model.forward_fused(x.to(dev), training=True, bn_decay=0.5)
        tapes, blocks = tapes or (t0, t1), blocks or bl
        loss = classification_loss(logits, labels.to(dev))
        loss.backward()
        outs.append((float(loss.detach()), logits.detach().float().cpu(),
                     {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (got_l, got_lg, got_g), (want_l, want_lg, want_g) = outs
    errs, null = replay.grad_errors(model, got_g, want_g)
    block_errs = [(e["block"].__name__.strip("_"), replay.block_errors(e))
                  for e in blocks]
    return (abs(got_l - want_l) / abs(want_l),
            ((got_lg - want_lg).norm() / want_lg.norm()).item(), errs, null,
            block_errs)


def b15_route(report, kernels, card):
    """B15 where the reference routes it: neighbors.edge_feature_auto with
    bf16 features and use_fused, forward and backward, at the ShapeNet
    stage shape (32 x 2048, C=64, k=20): B15 once, B13 once in the
    backward, no other selection; the edge features equal
    neighbors.edge_feature on B15's graph."""
    import torch

    from weaksuppointcloudseg_tpu_torch.ops import knn_gather as kg
    from weaksuppointcloudseg_tpu_torch.ops import neighbors

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    g = bf16_randn(gen, (PB, PN, 64))
    f = bf16_randn(gen, (PB, PN, 64)).requires_grad_()

    def run():
        ef = neighbors.edge_feature_auto(g, f, K, use_fused=True, fast=True)
        ef.float().square().sum().backward()
        return ef.detach()

    ef, launches = count_launches(kernels, run)
    want = {"knn_gather (B15)": 1, "scatter_add (B13)": 1}
    check_launch_counts(launches, {n: want.get(n, 0) for n in launches},
                        "edge_feature_auto (bf16, use_fused)")
    idx = kg.knn_gather(g, f.detach(), K, fast=True)[0]
    require(torch.equal(ef, neighbors.edge_feature(f.detach(), idx)),
            "edge_feature_auto: not the edge features of B15's graph")
    require(bool(torch.isfinite(f.grad).all()), "edge_feature_auto: df")
    for row in report:
        if row["name"] == "knn_gather (B15)":
            row["launches"] = launches["knn_gather (B15)"]
    print(f"  neighbors.edge_feature_auto (bf16, use_fused, knn_fast) at "
          f"{PB} x {PN}, C=64: launches " + ", ".join(
              f"{n} {v}" for n, v in launches.items() if v)
          + f"; the edge features of B15's graph [{card}]")


def three_conv_shapenet(kernels, card):
    """One bf16 fused Plain-style ShapeNet step and one eval forward at
    bench.py's shape (32 x 2048, k=20, knn_fast) with the first EdgeConv
    stage widened to three convs (64, 64, 64): B1 selects in that stage
    (train and eval), B13 runs its backward once."""
    import dataclasses

    import torch

    from weaksuppointcloudseg_tpu_torch import configs
    from weaksuppointcloudseg_tpu_torch.losses.weaksup import masked_softmax_ce
    from weaksuppointcloudseg_tpu_torch.models.dgcnn import DGCNNSeg

    base = configs.shapenet_config().model
    cfg = dataclasses.replace(base, compute_dtype="bfloat16", knn_fast=True,
                              edge_channels=((64, 64, 64), (64, 64), (64,)))
    model = DGCNNSeg(cfg, seed=0).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    x = torch.randn((PB, PN, 3), generator=gen, device="cuda") * 0.4
    cat = torch.eye(16, device="cuda")[torch.arange(PB, device="cuda") % 16]
    seg = torch.randint(0, 50, (PB, PN), generator=gen, device="cuda")
    onehot = torch.nn.functional.one_hot(seg, 50).float()
    mask = (torch.rand((PB, PN), generator=gen, device="cuda") < 0.1).float()

    def step():
        model.zero_grad()
        logits = model(x, cat, training=True, bn_decay=0.5, generator=gen)
        loss = masked_softmax_ce(logits, onehot, mask)
        loss.backward()
        return loss.detach()

    loss, launches = count_launches(kernels, step)
    torch.cuda.synchronize()
    grads_ok = all(bool(torch.isfinite(p.grad).all())
                   for p in model.parameters())
    require(bool(torch.isfinite(loss)) and grads_ok,
            "three-conv ShapeNet step: a loss or gradient is not finite")
    want = {"knn_edge (B1)": 4, "scatter_add (B13)": 1, "conv_minmax (B2)": 2,
            "conv_kmax_bwd (B3)": 2, "scatter_bn_bwd (B4)": 3,
            "conv_nmax (B5)": 2, "conv_nmax_bwd (B5)": 2}
    check_launch_counts(launches, {n: want.get(n, 0) for n in launches},
                        "three-conv ShapeNet step")
    ms = timed_ms(step, reps=3, warmup=1)
    with torch.no_grad():
        logits, eval_launches = count_launches(kernels, lambda: model(x, cat))
    want = {"knn_edge (B1)": 4, "conv_zmax (B7)": 2, "conv_znmax (B8)": 2}
    check_launch_counts(eval_launches,
                        {n: want.get(n, 0) for n in eval_launches},
                        "three-conv ShapeNet eval forward")
    require(bool(torch.isfinite(logits).all()), "three-conv eval: logits")
    eval_ms = timed_ms(lambda: model(x, cat), reps=3, warmup=1)
    print(f"  ShapeNet with a three-conv first stage (64, 64, 64), bf16 fused, "
          f"knn_fast, {PB} x {PN}: step loss {float(loss):.4f}, {ms:.3f} ms "
          f"per step, launches " + ", ".join(
              f"{n} {v}" for n, v in launches.items() if v)
          + f"; eval forward {eval_ms:.3f} ms, launches " + ", ".join(
              f"{n} {v}" for n, v in eval_launches.items() if v)
          + f" [{card}]")


def phase_classifier(report) -> None:
    """The DGCNN classifier at its published ModelNet40 width (32 clouds x
    1024 points, k=20, edges 64/64/64/128, global 1024, fc 512/256, 40
    classes, keep 0.5, label smoothing 0.2) on learnable synthetic clouds:
    20 Adam steps on a fixed batch per route, the bf16 eval forward and one
    bf16 unfused step with their launch counts; the bf16 fused step
    against the CPU; B15 on its route; the three-conv ShapeNet stage."""
    import dataclasses

    import torch

    from weaksuppointcloudseg_tpu_torch import configs
    from weaksuppointcloudseg_tpu_torch.models.dgcnn_cls import DGCNNCls
    from weaksuppointcloudseg_tpu_torch.train.state import Adam

    print(f"phase 12: the DGCNN classifier ({CB} x {CN} points, 40 classes), "
          f"B15 on its route, a three-conv ShapeNet stage")
    card = card_line()
    kernels = cls_kernels()
    labels = torch.arange(CB, device="cuda") % C_CLASSES
    xs = torch.from_numpy(class_clouds(labels.cpu().numpy(), CN, 0)).cuda()
    base = configs.ClsConfig()
    for what, dtype, kw, want in CLS_ROUTES:
        model = DGCNNCls(dataclasses.replace(base, **kw), seed=0).cuda()
        x = xs.to(getattr(torch, dtype))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        opt = Adam(model.parameters())
        step = cls_step_fn(model, x, labels, opt, gen)
        torch.cuda.reset_peak_memory_stats()
        loss0, launches = count_launches(kernels, step)
        check_launch_counts(launches, {n: want.get(n, 0) for n in launches},
                            f"classifier step, {what}")
        losses, step_s = [float(loss0)], []
        for _ in range(19):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = float(np.median(step_s[4:])) * 1e3
        require(np.isfinite(losses).all()
                and np.mean(losses[-3:]) < np.mean(losses[:3]),
                f"classifier, {what}: the loss did not fall: {losses}")
        print(f"  classifier train step, {what}: launches " + ", ".join(
            f"{n} {v}" for n, v in launches.items() if v)
            + f"; loss over 20 Adam steps on a fixed batch "
            + " ".join(f"{v:.3f}" for v in losses[::3]) + f" .. "
            f"{losses[-1]:.3f}; {ms:.3f} ms per step (median of 15), "
            f"{CB / ms * 1e3:.1f} clouds/s, peak {peak:.2f} GiB [{card}]")
        busy_ms, _ = device_breakdown(step, card, runs=3, top=8,
                                      what=f"classifier step, {what}")
        print(f"  idle share of the step: 1 - busy {busy_ms:.3f} / {ms:.3f} ms "
              f"= {1 - busy_ms / ms:.3f}")
        if dtype == "bfloat16" and not kw.get("static_graph"):
            repeat_step(model, opt, gen, step,
                        f"bf16 fused classifier step, {CB} x {CN}")
            with torch.no_grad():
                logits, ev = count_launches(kernels, lambda: model(x))
            want_ev = {"knn_edge (B1)": 5, "conv_zmax (B7)": 1,
                       "conv_znmax (B8)": 2}
            check_launch_counts(ev, {n: want_ev.get(n, 0) for n in ev},
                                "classifier eval forward")
            require(bool(torch.isfinite(logits).all())
                    and logits.dtype == torch.bfloat16,
                    "classifier eval forward: logits")
            ev_ms = timed_ms(lambda: model(x))
            acc = (logits.argmax(-1) == labels).float().mean().item()
            print(f"  classifier eval forward, bf16 fused: launches " + ", ".join(
                f"{n} {v}" for n, v in ev.items() if v)
                + f"; {ev_ms:.3f} ms per batch, {CB / ev_ms * 1e3:.1f} "
                f"clouds/s, train-batch accuracy {acc:.3f} [{card}]")
        del model
    # one bf16 step without the fused kNN: B14 gathers, B13 backward
    model = DGCNNCls(dataclasses.replace(base, use_fused_knn=False),
                     seed=0).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    step = cls_step_fn(model, xs.bfloat16(), labels, Adam(model.parameters()),
                       gen)
    loss, launches = count_launches(kernels, step)
    want = {"gather_rows (B14)": 5, "scatter_add (B13)": 4}
    check_launch_counts(launches, {n: want.get(n, 0) for n in launches},
                        "classifier step, bf16 unfused")
    require(bool(torch.isfinite(loss)), "classifier unfused step: loss")
    print(f"  classifier train step, bf16 unfused: loss {float(loss):.4f}, "
          f"launches " + ", ".join(f"{n} {v}" for n, v in launches.items() if v))
    del model, step
    torch.cuda.empty_cache()

    # the fused bf16 step against the CPU, dropout off, at 8 clouds: the fc
    # layers' batch norms over a handful of clouds are near-degenerate
    # (over 2 the gradient upstream is zero up to eps; over 4 they turned
    # one-ulp differences into leaf errors up to 0.30 and loss errors up
    # to 6.9e-3). Limits from two runs of scripts/torch_cls_step_agreement.py
    # (PERF.md, section 6), at least three times the worst of nine readings
    # at 8-32 clouds: each block on its own within 1e-2 (worst 3.7e-4); the
    # loss within 2^-6 relative, a few bf16 ulps of the log-probabilities,
    # which are bf16 as in the reference (1.1e-3); logits within 0.1
    # relative RMS (1.7e-2); every leaf within 0.65 of its norm (0.215) and
    # the null-gradient biases within 1.5e-2 of the largest leaf norm
    # (5.8e-5). agg.beta is held at the block level only: fc1's batch norm
    # makes its cotangent sum to zero over the clouds, so it cancels to
    # rounding noise (0.28-1.54), as agg_conv.beta does in phase 5
    small = dataclasses.replace(base, knn_fast=True, keep_prob=1.0)
    loss_err, lg_err, errs, null, block_errs = cls_step_vs_cpu(
        small, xs[:8].bfloat16(), labels[:8], seed=1)
    leaf = sorted((e, n) for n, e in errs.items()
                  if n not in null and n != "agg.beta")
    null_err = max(e for n, e in errs.items() if n in null)
    block_worst = max((e, f"{name}.{k}") for name, be in block_errs
                      for k, e in be.items())
    print(f"  CUDA vs CPU replaying the card's kNN and moments, one fused bf16 "
          f"classifier step, 8 x {CN} points: each block on its own, worst "
          f"{block_worst[1]} {block_worst[0]:.2e}; the whole step: loss rel "
          f"err {loss_err:.2e}, logits rel RMS {lg_err:.2e}, leaf gradients "
          f"worst: " + ", ".join(f"{n} {e:.2e}" for e, n in leaf[-3:][::-1])
          + f"; median {leaf[len(leaf) // 2][0]:.2e}; null-gradient biases "
          f"{null_err:.2e} of the largest leaf norm; agg.beta "
          f"{errs['agg.beta']:.2e}")
    require(block_worst[0] <= 1e-2,
            f"CUDA classifier block disagrees with the CPU: {block_errs}")
    require(loss_err <= 2.0 ** -6 and lg_err <= 0.1,
            "CUDA classifier forward disagrees with the CPU")
    require(leaf[-1][0] <= 0.65 and null_err <= 1.5e-2,
            "CUDA classifier gradients disagree with the CPU")
    b15_route(report, kernels, card)
    three_conv_shapenet(kernels, card)
    torch.cuda.empty_cache()


def device_breakdown(fn, card: str, runs: int = 3, top: int = 8,
                     what: str = "e2e", ops: int = 0):
    """Device time by kernel over ``runs`` calls of ``fn`` (torch.profiler)
    and the device's busy share of the host wall time of those calls;
    with ``ops``, also the ``ops`` PyTorch operators whose kernels took the
    most device time (children included). Returns (busy ms, wall ms) per
    call, both under the profiler."""
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
    return busy_ms, wall_ms / runs


# device kernels by the kind of work (first match wins)
KERNEL_GROUPS = (
    ("knn_edge_pre_kernel", "B11"), ("knn_edge_kernel", "B1"), ("conv_zmax", "B7"), ("conv_znmax", "B8"),
    ("KnnTileOut", "B12"), ("WGatherOut", "B9"), ("GatherTileOut", "B15"),
    ("affinity_", "B10"),
    ("gather_rows_kernel", "B14"),
    ("sqnorm_kernel", "B1/B9/B12/B15 norms"), ("wgather_pre", "B6 gather"),
    ("inverse_", "inverse graphs"), ("WVal", "B6 scatter"),
    ("F32Val", "B13"), ("Bf16Val", "B4"), ("scatter_bn_du", "B4"),
    ("sum_rows_kernel", "fixed-order sums"),
    ("sum_cols_kernel", "fixed-order sums"), ("conv_minmax", "B2"),
    ("conv_kmax_bwd", "B3"),
    ("conv_nmax", "B5 fwd"), ("nmax_bwd", "B5 bwd"), ("gemm", "cuBLAS GEMM"),
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
    t_start = time.perf_counter()
    phase_build()
    report = []
    for phase in (phase_kernels, phase_end_to_end, phase_train,
                  phase_plain_train, phase_full_train, phase_s3dis_train,
                  phase_s3dis_test, phase_static_graph, phase_convergence,
                  phase_unfused, phase_classifier):
        t0 = time.perf_counter()
        phase(report)
        print(f"  ({phase.__name__}: {time.perf_counter() - t0:.1f} s wall)")
    print(f"all phases: {time.perf_counter() - t_start:.1f} s wall")
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
