"""Peaks, roofline bounds and operation counts.

``PEAK_FLOPS``, ``PEAK_BYTES``, ``bound``, ``gram_pairs`` and
``affinity_flops`` are copied from chip_smoke.py (the arithmetic of
scripts/torch_kernel_bounds.py), frozen here. ``model_flops`` counts the
DGCNN's own arithmetic from a configuration's shapes.
"""

from __future__ import annotations

from typing import Iterator, Tuple

# NVIDIA's published H100 SXM peaks at 700 W (dense): the least time a
# kernel could take is the larger of its operations over the peak for their
# type and the bytes it must move (inputs read once, outputs written once)
# over the memory rate.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
BF16, F32, I32 = 2, 4, 4


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


def knn_width(model: dict) -> int:
    ch = model["knn_channels"]
    return ch[1] - ch[0] if ch else model["in_channels"]


def edge_stages(model: dict) -> Iterator[Tuple[str, int, int, Tuple[int, ...]]]:
    """(name, graph width Cg, feature width C, conv widths) of every
    EdgeConv stage in forward order, the transform net's first."""
    kc = knn_width(model)
    if model["use_transform_net"]:
        yield "transform", kc, kc, (64, 128)
    in_c = model["in_channels"]
    graph_c = in_c if model["use_transform_net"] else kc
    for s, widths in enumerate(model["edge_channels"]):
        yield f"stage{s}", (graph_c if s == 0 else in_c), in_c, tuple(widths)
        in_c = widths[-1]


def smooth_graph_is_shared(cfg: dict) -> bool:
    """True where the smoothness loss's kNN runs on the same coordinates as
    the transform net's (both the raw xyz), so the model needs that graph
    once."""
    m, w = cfg["model"], cfg["weaksup"]
    return bool(m["use_transform_net"] and m["knn_channels"] is None
                and w["smooth_channels"] is None)


def model_flops(cfg: dict, n: int, training: bool) -> float:
    """Operations of the model on one cloud of n points.

    Every conv and fc counts 2 in x out per row, the edge convs over all
    n k edges at their published input width 2C (the model's arithmetic,
    whatever factorisation an implementation uses), the first head conv
    over its whole input (the global feature broadcast to every point
    included). Training counts three times that (forward, and the
    gradients of the inputs and of the weights); recomputation is not
    counted. Every kNN graph the model needs adds its Gram once,
    symmetric: n (n + 1) / 2 dot products of the graph's width; training
    adds the smoothness loss's graph where it is not the transform
    net's."""
    m = cfg["model"]
    k = m["k"]
    conv = 0.0
    gram = 0.0
    outs = []
    for name, cg, c, widths in edge_stages(m):
        gram += 2.0 * gram_pairs(1, n) * cg
        ci = 2 * c
        for w in widths:
            conv += 2.0 * n * k * ci * w
            ci = w
        if name == "transform":
            conv += 2.0 * n * 128 * 1024 + 2.0 * (1024 * 512 + 512 * 256
                                                  + 256 * c * c)
        else:
            outs.append(widths[-1])
    conv += 2.0 * n * sum(outs) * m["global_channels"]
    g = m["global_channels"]
    if m["num_categories"] > 0:
        conv += 2.0 * m["num_categories"] * m["category_embed_channels"]
        g += m["category_embed_channels"]
    ci = g + sum(outs)
    for w in m["head_channels"]:
        conv += 2.0 * n * ci * w
        ci = w
    conv += 2.0 * n * ci * m["num_classes"]
    if not training:
        return conv + gram
    if not smooth_graph_is_shared(cfg):
        ch = cfg["weaksup"]["smooth_channels"]
        width = ch[1] - ch[0] if ch else m["in_channels"]
        gram += 2.0 * gram_pairs(1, n) * width
    return 3.0 * conv + gram
