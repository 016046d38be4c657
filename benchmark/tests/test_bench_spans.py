"""The per-layer metrics that read the program's own spans
(harness/spans.py): a traced rehearsal of each cell on the CPU reads each
of them finite, the room spans cover the requests, and a trace without
the spans (a program that has none) reads nothing."""

import math

import pytest
import torch

import run as bench
from harness import manifest, spans
from harness.trace import Trace
from harness.window import Window
from test_bench_rehearsal import CELLS, SEED, tiny


def span_metrics(cell):
    return [m["name"] for m in cell.per_layer if m["source"] == "program_span"]


def traced_window(name):
    import importlib

    cell = tiny(name)
    driver = importlib.import_module(f"harness.{cell.mix['driver']}_driver")
    out = driver.run(cell, SEED, 0.5, True, torch.device("cpu"), bench.Clock())
    return cell, out["window"]


@pytest.mark.parametrize("name", CELLS)
def test_span_metrics_read_finite_in_the_traced_rehearsal(name):
    cell, w = traced_window(name)
    names = span_metrics(cell)
    assert names
    got = bench.per_layer(cell, w)
    for n in names:
        assert n in got and math.isfinite(got[n]["value"]), n
    if w.kind == "train":
        steps = spans.named(w.trace, "train.step")
        assert len(steps) == w.steps
        assert len(spans.named(w.trace, "train.assemble")) == w.steps
        return
    # every request is one room, and its spans cover it
    assert w.requests
    for req in w.requests:
        s0, e0 = req["span"]
        (room,) = spans.inside(spans.named(w.trace, "test.room"), req["span"])
        assert (room[1] - room[0]) / (e0 - s0) >= 0.99
        parts = [s for n in ("room.read", "room.sweep", "room.forward", "lp.room")
                 for s in spans.inside(spans.named(w.trace, n), room)]
        assert spans.seconds(parts) / ((room[1] - room[0]) / 1e9) >= 0.95
    assert got["cg_steps.test"]["value"] >= 1


def bare_window(kind):
    """A traced window of a program without spans: one request, one kernel
    and host operators only."""
    tr = Trace(window=(0, 1000), kernels=[(100, 200, "k")],
               host=[(10, 900, "bench.request"), (20, 300, "aten::mm")],
               spans={"bench.request": [(10, 900)]})
    return Window(kind=kind, config={}, mix={}, trace=tr, steps=4,
                  requests=[{"span": (10, 900), "room": 0, "clouds": 1,
                             "points": 8}])


@pytest.mark.parametrize("name", CELLS)
def test_span_metrics_read_nothing_without_spans(name):
    cell = manifest.resolve(name)
    for n in span_metrics(cell):
        for kind in ("train", "test"):
            assert manifest.metric_reader(n)(bare_window(kind)) is None, (n, kind)


def test_busy_share_and_nesting():
    """busy_share clips the device's merged intervals to each span; inside
    keeps the spans that lie wholly within."""
    tr = Trace(window=(0, 1000),
               kernels=[(50, 150, "a"), (120, 180, "b"), (400, 700, "c")],
               host=[])
    assert spans.busy_share(tr, [(100, 200)]) == pytest.approx(0.8)
    assert spans.busy_share(tr, [(100, 200), (600, 800)]) == pytest.approx(0.6)
    assert spans.busy_share(tr, [(200, 300)]) == 0.0
    nested = [(5, 8), (10, 20), (12, 14), (15, 30), (40, 50)]
    assert spans.inside(nested, (10, 20)) == [(10, 20), (12, 14)]
