"""ShapeNet held-out evaluation CLI on the port (reference:
weaksuppointcloudseg_tpu/cli/test_shapenet.py, same flags and output).

    python -m weaksuppointcloudseg_tpu_torch.cli.test_shapenet \\
        --DataPath <ShapeNet root> --Checkpoint <v2 .npz> \\
        --Precision bfloat16 --FastKNN --batchsize 32 [--device cpu]

Restores a format-v2 checkpoint (written by either package), runs the
3000-point view inference and, for the Full style, label propagation.
Runs on CUDA device ``--GPU``; where there is no card it raises unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

from weaksuppointcloudseg_tpu_torch import configs
from weaksuppointcloudseg_tpu_torch.cli import common
from weaksuppointcloudseg_tpu_torch.data.shapenet import ShapeNetTestSet
from weaksuppointcloudseg_tpu_torch.train.loop import ShapeNetTrainer


def parser() -> argparse.ArgumentParser:
    """The reference test CLI's flags (cli/common.py::base_parser with
    train=False, plus --num_points) and ``--device``."""
    p = common.base_parser(train=False)
    p.add_argument("--num_points", type=int, default=3000,
                   help="fixed view size at test time "
                        "(ShapeNet_DGCNN_trainer.py:530-535)")
    return p


def build_config(args) -> configs.ExperimentConfig:
    """The ShapeNet preset with the flags applied."""
    return common.build_config(args)


def find_result_dir(args) -> str:
    """Locate a train run's result dir by its --Datetime stamp."""
    root = os.path.expanduser("./Results/ShapeNet")
    if args.Datetime is None:
        raise SystemExit("need --Datetime (or --Checkpoint) to locate the model")
    matches = [d for d in os.listdir(root) if d.endswith(args.Datetime)]
    if len(matches) != 1:
        raise SystemExit(f"{len(matches)} result dirs match '{args.Datetime}' in {root}")
    return os.path.join(root, matches[0])


def main(argv=None) -> dict:
    p = parser()
    args = p.parse_args(argv)
    common.refuse_unported(p, args)
    data_path = args.DataPath or "./Dataset/ShapeNet"
    testset = ShapeNetTestSet(data_path)
    cfg = build_config(args)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_classes=testset.meta.num_part_cats,
        num_categories=testset.meta.num_categories))
    trainer = ShapeNetTrainer(cfg, testset, seed=args.seed,
                              device=common.device(args))

    if args.Checkpoint:
        ckpt = args.Checkpoint
    else:
        ckpt = os.path.join(find_result_dir(args), "Checkpoint",
                            "Checkpoint_epoch-best.npz")
    trainer.restore_checkpoint(ckpt)

    res = trainer.test(testset, use_label_prop=args.Style == "Full",
                       num_points=args.num_points)
    print(
        f"Test perdata mIoU {100 * res['perdata_miou']:.2f}%  "
        f"pershape mIoU {100 * res['pershape_miou']:.2f}%  "
        f"acc {100 * res['accuracy']:.2f}%"
    )
    for name, iou in zip(testset.meta.objnames, res["per_category_iou"]):
        if not np.isnan(iou):
            print(f"  {name:12s} IoU {100 * iou:.2f}%")
    return res


if __name__ == "__main__":
    main()
