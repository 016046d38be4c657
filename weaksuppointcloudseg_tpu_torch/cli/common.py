"""Shared CLI plumbing of the port: the reference's flags and config
assembly for ShapeNet and S3DIS (counterpart of weaksuppointcloudseg_tpu/
cli/common.py), plus ``--device``. Every CLI runs on the card by default
(``cuda:<--GPU>``) and raises where there is none unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import os

import torch

from weaksuppointcloudseg_tpu_torch import configs
from weaksuppointcloudseg_tpu_torch.utils import profiling
from weaksuppointcloudseg_tpu_torch.utils.tools import resolve_device


def base_parser(dataset: str = "ShapeNet", *,
                train: bool) -> argparse.ArgumentParser:
    """The reference's flags of a ``dataset`` CLI (train or test) and
    ``--device``. Flags the port cannot honour yet are accepted and refused
    by :func:`refuse_unported`."""
    p = argparse.ArgumentParser(description="Take parameters")
    p.add_argument("--GPU", "-gpu", type=int, default=0, help="CUDA device index")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default; raises where there is "
                        "none) or on the CPU")
    p.add_argument("--m", "-m", type=float, default=0.1,
                   help="ratio of points labelled (0.01=1%%, 0.1=10%%, 1=100%%)")
    p.add_argument("--Network", "-net", type=str, default="DGCNN",
                   help="[options: DGCNN]")
    p.add_argument("--DataPath", type=str, default=None,
                   help=f"dataset root [default: ./Dataset/{dataset}]")
    p.add_argument("--num_devices", type=int, default=0,
                   help="data-parallel size (not ported: must be <= 1)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--Precision", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="compute dtype (default: the preset's float32, "
                        "kernels B12/B13 on the card); bfloat16 runs the "
                        "fused kernels (B1-B5 training, B1/B7/B8 eval; "
                        "the -sty Full smoothness loss B6, or B9 on S3DIS)")
    p.add_argument("--FastKNN", action="store_true",
                   help="packed-min top-k selection")
    p.add_argument("--StaticGraph", action="store_true",
                   help="opt-in static-graph EdgeConv: ONE input-coordinate "
                        "kNN graph reused by every stage (not reference "
                        "parity: a speed/accuracy trade; kernel B11 on the "
                        "bf16 fused route). Test with the same flag the "
                        "model trained with")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace (host, and the "
                        "card where there is one) into DIR: the whole test "
                        "run, or in training the epoch after the first "
                        "trained one; it holds the port's spans "
                        "(utils/profiling.py)")
    p.add_argument("--debug_nans", action="store_true",
                   help="not supported by the port")
    if train:
        p.add_argument("--batchsize", "-bs", type=int,
                       default=6 if dataset == "ShapeNet" else 3)
        p.add_argument("--ExpRslt", "-er",
                       type=lambda s: s not in ("0", "False", ""),
                       default=False, help="export results/checkpoints")
        p.add_argument("--LearningRate", type=float, default=1e-3)
        p.add_argument("--Epoch", "-ep", type=int, default=201)
        p.add_argument("--Rampup", "-rp", type=int, default=101)
        p.add_argument("--Style", "-sty", type=str, default="Full",
                       help="[options: Plain, Full]")
        p.add_argument("--CompatFrozenGate", action="store_true",
                       help="reproduce the released code's frozen rampup gate: "
                            "the weak losses never receive gradient")
        p.add_argument("--Resume", type=str, default=None,
                       help="not ported yet (Adam state across packages)")
    else:
        p.add_argument("--batchsize", type=int, default=1)
        p.add_argument("--Style", "-style", type=str, default="Full",
                       help="[options: Plain, Full]")
        p.add_argument("--Datetime", "-dt", type=str, default=None,
                       help="datetime stamp of the trained model to load")
        p.add_argument("--Checkpoint", type=str, default=None,
                       help="explicit checkpoint path (overrides --Datetime)")
        p.add_argument("--LPSolver", type=str, default=None,
                       choices=["solve", "cg", "cg_matfree", "sharded"],
                       help="label-propagation solver (ported: solve, cg, "
                            "cg_matfree; sharded is not yet)")
    return p


def refuse_unported(p: argparse.ArgumentParser, args) -> None:
    """Exit with a usage error for a flag the port does not honour yet."""
    if args.debug_nans:
        p.error("--debug_nans traces JAX and is not supported by the port")
    if getattr(args, "Resume", None):
        p.error("--Resume is not ported yet (ROADMAP)")
    if args.num_devices > 1:
        p.error("data parallelism is not ported yet (ROADMAP queue A)")


def profile_context(args):
    """Trace context for a whole test run (--profile DIR)."""
    if not args.profile:
        return contextlib.nullcontext()
    return profiling.trace(args.profile)


def profile_epoch_context(args, epoch: int, start_epoch: int, last_epoch: int):
    """Trace context for one training epoch (--profile DIR): the epoch
    after the first trained one, so first-call costs (kernel builds, the
    allocator's growth) are left out, or the first if it is the only
    one."""
    target = start_epoch + 1 if start_epoch + 1 <= last_epoch else start_epoch
    if not args.profile or epoch != target:
        return contextlib.nullcontext()
    return profiling.trace(args.profile)


def device(args) -> torch.device:
    """``cuda:<--GPU>`` unless ``--device cpu``; raises without a card."""
    return resolve_device(f"cuda:{args.GPU}" if args.device == "cuda" else "cpu")


def build_config(args, dataset: str = "ShapeNet") -> configs.ExperimentConfig:
    """The dataset's preset with the flags applied (cli/common.py::
    build_config)."""
    make = configs.shapenet_config if dataset == "ShapeNet" else configs.s3dis_config
    cfg = make()
    train = dataclasses.replace(
        cfg.train,
        batch_size=getattr(args, "batchsize", cfg.train.batch_size),
        epochs=getattr(args, "Epoch", cfg.train.epochs),
        rampup=getattr(args, "Rampup", cfg.train.rampup),
        style=args.Style, label_fraction=args.m, seed=args.seed)
    schedule = dataclasses.replace(
        cfg.schedule, base_learning_rate=getattr(
            args, "LearningRate", cfg.schedule.base_learning_rate))
    weaksup = dataclasses.replace(
        cfg.weaksup, rampup=getattr(args, "Rampup", cfg.weaksup.rampup),
        compat_frozen_gate=getattr(args, "CompatFrozenGate", False))
    labelprop = cfg.labelprop
    if getattr(args, "LPSolver", None):
        labelprop = dataclasses.replace(labelprop, solver=args.LPSolver)
    model = cfg.model
    if args.Precision:
        model = dataclasses.replace(model, compute_dtype=args.Precision)
    model = dataclasses.replace(model, knn_fast=model.knn_fast or args.FastKNN,
                                static_graph=args.StaticGraph)
    return dataclasses.replace(cfg, model=model, train=train, schedule=schedule,
                               weaksup=weaksup, labelprop=labelprop)


def result_base_path(args, dataset: str = "ShapeNet") -> str:
    """Results/<dataset>/<Net>_sty-<Style>_m-<m>_<datetime>
    (train_ShapeNet.py:59-62)."""
    dt = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    return os.path.expanduser(
        f"./Results/{dataset}/{args.Network}_sty-{args.Style}_m-{args.m}_{dt}")


def find_result_dir(dataset: str, args) -> str:
    """Locate a train run's result dir under ./Results/<dataset> by its
    --Datetime stamp."""
    root = os.path.expanduser(f"./Results/{dataset}")
    if args.Datetime is None:
        raise SystemExit("need --Datetime (or --Checkpoint) to locate the model")
    matches = [d for d in os.listdir(root) if d.endswith(args.Datetime)]
    if len(matches) != 1:
        raise SystemExit(f"{len(matches)} result dirs match '{args.Datetime}' in {root}")
    return os.path.join(root, matches[0])
