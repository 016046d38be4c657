"""B1_roofline.train: kernel B1 (kNN + the first EdgeConv conv) in the
training steps of the traced window, as the least time of its calls over
the device time of its kernels, in percent.

The calls of a step are the model's EdgeConv stages (the transform net's
first), each at B = the step's clouds, N points, graph width Cg and first
conv width C. A call's least time is the larger of its Gram's operations,
2 Cg n (n + 1) / 2 a cloud at the bf16 peak, and its bytes at the memory
rate: g, u and v read once, idx and y1 written once, the moments, plus
the squared distances where the smoothness loss reuses the transform
net's graph and the k-extrema where a stage has one conv."""

from harness.counting import BF16, F32, I32, bound, edge_stages, gram_pairs, smooth_graph_is_shared

KERNELS = ("knn_edge_kernel", "sqnorm_kernel")


def call_ms(b, n, k, cg, c, *, values=False, minmax=False):
    nbytes = (b * n * cg * BF16 + 2 * b * n * c * BF16 + b * n * k * (I32 + c * BF16)
              + 2 * c * F32)
    if values:
        nbytes += b * n * k * F32
    if minmax:
        nbytes += b * n * c * (2 * BF16 + 2 * I32)
    return bound(2.0 * gram_pairs(b, n) * cg, "bf16", nbytes)[0]


def step_ms(cfg, b, n, training):
    k = cfg["model"]["k"]
    total = 0.0
    for name, cg, c, widths in edge_stages(cfg["model"]):
        values = training and name == "transform" and smooth_graph_is_shared(cfg)
        total += call_ms(b, n, k, cg, widths[0], values=values,
                         minmax=len(widths) == 1)
    return total


def is_b1(name: str) -> bool:
    return any(p in name for p in KERNELS)


def read(w):
    if w.kind != "train" or w.steps == 0:
        return None
    seconds, launches = w.trace.kernel_s(is_b1)
    if not launches:
        return None
    need = w.steps * step_ms(w.config, w.clouds_per_step, w.points, True)
    return 100.0 * need / (seconds * 1e3)
