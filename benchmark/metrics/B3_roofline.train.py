"""B3_roofline.train: kernel B3 (the backward of a two-conv EdgeConv
stage's second conv, BN and k-max) in the training steps of the traced
window, as the least time of its calls over its kernels' device time, in
percent. One call per two-conv stage and step, at P = clouds x points
rows, k edges, first conv width C1 and second C2, counted as
scripts/torch_kernel_bounds.py counts it (frozen here): operations
2 (P k C1 C1 2 + P C2 C1 2) at the bf16 peak; bytes: y1 read twice (its
recompute and the cotangent), the routed gradient and its slots, the
weights and the per-channel vectors."""

from harness.counting import BF16, F32, I32, bound, edge_stages

KERNELS = ("conv_kmax_bwd",)


def call_ms(p, k, c1, c2):
    pk = p * k
    flops = 2.0 * pk * c1 * c1 * 2 + 2.0 * p * c2 * c1 * 2
    nbytes = (2 * pk * c1 * BF16 + p * c2 * (F32 + I32) + c2 * c1 * BF16
              + c1 * c1 * BF16 + 5 * c1 * F32 + (c1 * c2 + c1 * c1 + 3 * c1) * F32)
    return bound(flops, "bf16", nbytes)[0]


def read(w):
    if w.kind != "train" or w.steps == 0:
        return None
    seconds, launches = w.trace.kernel_s(lambda n: any(p in n for p in KERNELS))
    if not launches:
        return None
    p = w.clouds_per_step * w.points
    k = w.config["model"]["k"]
    per_step = sum(call_ms(p, k, widths[0], widths[1])
                   for _, _, _, widths in edge_stages(w.config["model"])
                   if len(widths) == 2)
    return 100.0 * w.steps * per_step / (seconds * 1e3)
