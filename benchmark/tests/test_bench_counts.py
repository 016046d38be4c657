"""The operation and byte counts against hand counts at small shapes."""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from harness import counting
from harness.trace import Trace
from harness.window import Window

METRICS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "metrics")


def metric(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_config(transform=True):
    return {
        "model": {"in_channels": 3, "num_classes": 4, "k": 2,
                  "knn_channels": None, "use_transform_net": transform,
                  "num_categories": 2, "category_embed_channels": 3,
                  "edge_channels": [[4, 5], [6]], "global_channels": 7,
                  "head_channels": [8]},
        "weaksup": {"smooth_channels": None},
    }


def test_gram_and_bound():
    assert counting.gram_pairs(2, 3) == 12  # 2 clouds x (3 x 4 / 2)
    ms, by = counting.bound(67e9, "f32", 1.0)
    assert by == "operations" and math.isclose(ms, 1.0)
    ms, by = counting.bound(0.0, "bf16", 3.35e9)
    assert by == "bytes" and math.isclose(ms, 1.0)


def test_affinity_flops_by_hand():
    # 1 sample, n=2, f=1, k=1, every ordered pair (4): Gram and exp on the
    # 3 unordered pairs of the diagonal included, (2 f + 4) each, and the
    # apply 2 k on the 4 ordered pairs
    assert counting.affinity_flops(1, 2, 1, 1, 4.0) == 3 * 6 + 4 * 2


def test_model_flops_by_hand():
    cfg = tiny_config(transform=False)
    n, k = 5, 2
    convs = (2 * n * k * 6 * 4 + 2 * n * k * 4 * 5  # stage 0: 2x3 -> 4 -> 5
             + 2 * n * k * 10 * 6                 # stage 1: 2x5 -> 6
             + 2 * n * 11 * 7                     # aggregation 5 + 6 -> 7
             + 2 * 2 * 3                          # category embedding
             + 2 * n * (7 + 3 + 11) * 8           # head conv
             + 2 * n * 8 * 4)                     # logits
    grams = n * (n + 1) * 3 + n * (n + 1) * 5     # 2 n(n+1)/2 Cg per graph
    assert counting.model_flops(cfg, n, False) == convs + grams
    # training: three times the convs; the smoothness graph on all three
    # input channels is its own without a transform net
    assert counting.model_flops(cfg, n, True) == 3 * convs + grams + n * (n + 1) * 3


def test_model_flops_transform_shares_smooth_graph():
    cfg = tiny_config(transform=True)
    n = 5
    plain = counting.model_flops(tiny_config(False), n, False)
    transform = (2 * n * 2 * 6 * 64 + 2 * n * 2 * 64 * 128 + 2 * n * 128 * 1024
                 + 2 * (1024 * 512 + 512 * 256 + 256 * 9) + n * (n + 1) * 3)
    assert counting.model_flops(cfg, n, False) == plain + transform
    convs = counting.model_flops(cfg, n, False) - 2 * n * (n + 1) * 3 - n * (n + 1) * 5
    assert counting.model_flops(cfg, n, True) == 3 * convs + 2 * n * (n + 1) * 3 + n * (n + 1) * 5


def test_b1_call_bytes_by_hand():
    b1 = metric("B1_roofline.train")
    b, n, k, cg, c = 2, 8, 3, 3, 4
    nbytes = b * n * cg * 2 + 2 * b * n * c * 2 + b * n * k * 4 + b * n * k * c * 2 + 2 * c * 4
    assert math.isclose(b1.call_ms(b, n, k, cg, c), nbytes / 3.35e12 * 1e3)
    extra = b * n * k * 4 + b * n * c * 12
    assert math.isclose(b1.call_ms(b, n, k, cg, c, values=True, minmax=True),
                        (nbytes + extra) / 3.35e12 * 1e3)


def test_b3_call_by_hand():
    b3 = metric("B3_roofline.train")
    p, k, c1, c2 = 10, 2, 4, 8
    flops = 2.0 * p * k * c1 * c1 * 2 + 2.0 * p * c2 * c1 * 2
    nbytes = (2 * p * k * c1 * 2 + p * c2 * 8 + c2 * c1 * 2 + c1 * c1 * 2 + 5 * c1 * 4
              + (c1 * c2 + c1 * c1 + 3 * c1) * 4)
    assert math.isclose(b3.call_ms(p, k, c1, c2),
                        max(flops / 989e12, nbytes / 3.35e12) * 1e3)


def test_room_pairs_against_brute_force():
    from reference import rooms

    rng = np.random.default_rng(3)
    xyz = torch.from_numpy(rng.uniform(0, 1.5, (300, 3)).astype(np.float32))
    rgb = torch.from_numpy(rng.uniform(0, 1, (300, 3)).astype(np.float32))
    aff = rooms.Affinity(xyz, rgb, rows=64)
    e = (1e3 * ((xyz[:, None] - xyz[None]) ** 2).sum(-1)
         + 10 * ((rgb[:, None] - rgb[None]) ** 2).sum(-1))
    assert aff.pairs(30.0) == int((torch.exp(-e) >= math.exp(-30.0)).sum())
    u = torch.from_numpy(rng.standard_normal((300, 2)).astype(np.float32))
    want = torch.exp(-e) @ u
    got = torch.empty_like(u)
    got[aff.order] = aff.apply(u[aff.order])
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)


def test_b10_counts_the_room_points_and_no_pads():
    """B10's need: the ordered pairs of the swept room's own block points
    within the cutoff, by brute force; the LP's pad blocks are left out."""
    from harness import traffic
    from reference import rooms

    b10 = metric("B10_roofline.test")
    room = traffic.surface_room(np.random.default_rng(5), (2.0, 3.0, 1.0), 150)
    blocks, _ = rooms.sweep(room, rooms.columns(room), 64, np.random.default_rng(0))
    assert len(blocks) % 8  # the LP would pad this room
    room_max = room[:, 0:3].max(axis=0).astype(np.float32)
    xyz = torch.from_numpy((blocks[:, :, 6:9] * room_max).astype(np.float32).reshape(-1, 3))
    rgb = torch.from_numpy(blocks[:, :, 3:6].astype(np.float32).reshape(-1, 3))
    e = (1e3 * ((xyz[:, None] - xyz[None]) ** 2).sum(-1)
         + 10 * ((rgb[:, None] - rgb[None]) ** 2).sum(-1))
    want = int((torch.exp(-e) >= math.exp(-b10.CUTOFF)).sum())
    assert b10.room_pairs(room, 64, torch.device("cpu")) == (want, len(xyz))


def test_trace_reduction_by_hand():
    tr = Trace(window=(0, 100), kernels=[(10, 30, "a"), (20, 40, "b"), (60, 70, "a")],
               host=[(0, 100, "bench.request"), (40, 58, "cudaStreamSynchronize")])
    assert tr.busy_s() == 40e-9 and math.isclose(tr.idle_share(), 0.6)
    assert tr.top_ops() == [["a", 30e-9], ["b", 20e-9]]
    gaps = dict(tr.idle_gaps(short_ns=5))
    assert gaps == {"bench.request": 10e-9 + 30e-9, "cudaStreamSynchronize": 20e-9}
    w = Window(kind="train", config={}, mix={}, trace=tr, steps=2)
    ops = metric("torch_ops_ms.train")
    assert ops.read(w) is None  # no PyTorch kernel in the window
    assert metric("idle_share.train").read(w) == pytest.approx(0.6)
    assert metric("idle_share.test").read(w) is None
