"""Where the time of the scatters over the inverse graph goes, on the card.

    python scripts/torch_scatter_profile.py      # needs a CUDA device

At chip_smoke.py phase 2's shapes (B13: B=64, P=N=2048, k=20, C=64 and
C=3; B4: B=32, C=64, dense and sparse; B6's scatter: B=64, N=2048, k=10,
C=51, its own graph and a k=20 graph whose last 10 weights are zero, the
work of summing over the transform stage's wider graph, and B=28, N=4096,
C=14) and for ``index_add_`` beside them: the device time of each
CUDA kernel a call launches (torch.profiler, summed per kernel name over
10 calls), the time of one call between CUDA events (host overhead
included, as chip_smoke.py's ``timed_ms``), and the device time of a call
with the host's launches hidden (10 calls queued behind a sleep kernel,
CUDA events around them). Each scatter builds its graph's inverse; the
per-kernel times split the build from the gather. The inverse alone is
shown by each of its two routes (the cluster build, which these shapes
take, and the three-launch build), at B13's shape and at S3DIS B4's
(B=28, N=4096, k=20).
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from weaksuppointcloudseg_tpu_torch.ops import scatter  # noqa: E402


def kernels_ms(fn, reps: int = 10):
    """{kernel name: device ms per call} over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def show(what, fn):
    ks = kernels_ms(fn)
    print(f"{what}: one call {cs.timed_ms(fn):.4f} ms between events, "
          f"{cs.device_ms(fn):.4f} ms with the launches hidden, kernels "
          f"{sum(ks.values()):.4f} ms:")
    for name, ms in sorted(ks.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:8.4f}  {name[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("torch_scatter_profile: needs a CUDA device")
    print(cs.card_line())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tb, tn, k = cs.TB, cs.TN, cs.K
    for c in (64, 3):
        idx = torch.randint(0, tn, (tb, tn, k), generator=gen, device="cuda",
                            dtype=torch.int32)
        g = torch.randn((tb, tn, k, c), generator=gen, device="cuda")
        for route in ("cluster", "chunks"):
            show(f"inverse_graph B={tb} P=N={tn} k={k}, {route} build",
                 lambda: scatter._build_inverse(idx, tn, route))
        show(f"scatter_add C={c} with its build",
             lambda: scatter.scatter_add(idx, g, tn))
        rows = scatter._flat_rows(idx, tn)
        flat = g.reshape(-1, c)
        out = torch.zeros((tb * tn, c), device="cuda")
        show(f"index_add_ C={c}", lambda: out.index_add_(0, rows, flat))
        del g, flat, out
    pb, pn = cs.PB, cs.PN
    idx = torch.randint(0, pn, (pb, pn, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    y = cs.bf16_randn(gen, (pb, pn, k, 64))
    sv, al, be = (torch.randn(64, generator=gen, device="cuda") * 0.1
                  for _ in range(3))
    dz = cs.bf16_randn(gen, (pb, pn, k, 64))
    q = torch.randn((pb, pn, 64), generator=gen, device="cuda")
    asel = torch.randint(0, k, (pb, pn, 64), generator=gen, device="cuda",
                         dtype=torch.int32)
    s3 = torch.randint(0, cs.RN, (cs.RB, cs.RN, k), generator=gen,
                       device="cuda", dtype=torch.int32)
    for route in ("cluster", "chunks"):
        show(f"inverse_graph B={cs.RB} P=N={cs.RN} k={k} (S3DIS B4's graph), "
             f"{route} build", lambda: scatter._build_inverse(s3, cs.RN, route))
    del s3
    for name, big in (("dense", dz), ("sparse", (q, asel))):
        show(f"scatter_bn_bwd B={pb} {name} with its build",
             lambda: scatter.scatter_bn_bwd(idx, y, big, sv, al, be, pn))
    del y, dz
    for b, n, c in ((cs.SB, cs.SN, 51), (cs.RB, cs.RN, 14)):
        idx = torch.randint(0, n, (b, n, 2 * cs.SK), generator=gen,
                            device="cuda", dtype=torch.int32)
        own = idx[..., :cs.SK].contiguous()
        w = torch.rand((b, n, cs.SK), generator=gen, device="cuda")
        ct = torch.randn((b, n, c), generator=gen, device="cuda")
        # the k=20 graph with zero weights past the first 10 columns: the
        # work of summing the loss's scatter over the transform stage's
        # k=20 inverse (twice the slots)
        w20 = torch.cat([w, torch.zeros_like(w)], dim=2)
        show(f"scatter_add_weighted B={b} N={n} C={c} with its build",
             lambda: scatter.scatter_add_weighted(own, w, ct, n))
        show(f"scatter_add_weighted C={c} over the k=20 graph (zero "
             "weights past 10) with its build",
             lambda: scatter.scatter_add_weighted(idx, w20, ct, n))
    return 0


if __name__ == "__main__":
    sys.exit(main())
