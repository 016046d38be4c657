"""``BENCHMARK.json`` and the files it names: a cell resolves to its
configuration (``configs/<config>.json``), its traffic mix
(``mixes/<traffic>.json``), its limits (``limits/<cell>.json``) and the
per-layer metrics that list it (``metrics/<metric>.py``)."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def applies(metric: dict, cell: str, manifest: dict) -> bool:
    """True where the cell reports the metric: its ``workloads`` list the
    cell, or it has none and the cell reports the end-to-end metric it
    moves (or, for an end-to-end metric, every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    e2e = next(m for m in manifest["end_to_end"] if m["name"] == moves)
    return applies(e2e, cell, manifest)


def resolve(name: str, root: str = ROOT) -> Cell:
    manifest = load_manifest(root)
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg = next(c for c in manifest["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    return Cell(
        name=name, config_name=w["config"], traffic=w["traffic"],
        chips=w["chips"], config=config, mix=_json("mixes", f"{w['traffic']}.json"),
        limits=_json("limits", f"{name}.json"),
        end_to_end=[m for m in manifest["end_to_end"] if applies(m, name, manifest)],
        per_layer=[m for m in manifest["per_layer"] if applies(m, name, manifest)])


def metric_reader(name: str) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def experiment(config: dict, mix: dict):
    """The program's ExperimentConfig of a configuration file under a mix
    (the mix sets the batch size and the style)."""
    import dataclasses

    from weaksuppointcloudseg_tpu_torch import configs

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    def group(cls, values: Dict):
        return cls(**{k: tup(v) for k, v in values.items()})

    exp = configs.ExperimentConfig(
        dataset=config["dataset"],
        model=group(configs.ModelConfig, config["model"]),
        schedule=group(configs.ScheduleConfig, config["schedule"]),
        weaksup=group(configs.WeakSupConfig, config["weaksup"]),
        labelprop=group(configs.LabelPropConfig, config["labelprop"]),
        train=group(configs.TrainConfig, config["train"]))
    return dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, batch_size=mix["batch_size"], style=mix["style"]))
