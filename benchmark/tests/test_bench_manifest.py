"""BENCHMARK.json against the benchmark's contract, and every cell
resolving to its files."""

import json
import os
import re

import pytest

from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")

M = manifest.load_manifest()


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    assert 1 <= len(M["command"]) <= 32
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    size = os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json"))
    assert size <= 64 * 1024


def test_names_units_and_text():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in M[k]]
    names += [w["config"] for w in M["workloads"]] + [w["traffic"] for w in M["workloads"]]
    names += [r for c in M["configs"] for r in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in M[k]}) == len(M[k])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [w["why"] for w in M["workloads"]] + [c["source"] for c in M["configs"]]
    texts += [c["why"] for c in M["configs"]] + [m["layer"] for m in M["per_layer"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


def test_bounds_and_budget():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    cells = 24  # the most a benchmark may grow to
    runs = 2 + 14 * cells
    assert runs * (M["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_resolves(cell):
    c = manifest.resolve(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(manifest.metric_reader(m["name"]))
    assert c.mix["driver"] in ("train", "rooms")
    assert c.limits and all(v > 0 for v in c.limits.values())


def test_configs_used_and_files_unique():
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    for f in files:
        assert f.startswith(M["paths"][0] + "/")
        with open(os.path.join(manifest.ROOT, f)) as fh:
            cfg = json.load(fh)
        assert "assumed" in cfg


def test_metric_workloads_exist():
    cells = {w["name"] for w in M["workloads"]}
    for m in M["end_to_end"] + M["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    quad = [w for w in M["workloads"] if w["chips"] == 4]
    assert len(quad) <= max(1, len(M["workloads"]) // 4)
