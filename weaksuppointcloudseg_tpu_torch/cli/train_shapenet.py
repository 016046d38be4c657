"""ShapeNet weak-supervision training CLI on the port (reference:
weaksuppointcloudseg_tpu/cli/train_shapenet.py, same flags and output).

    python -m weaksuppointcloudseg_tpu_torch.cli.train_shapenet \\
        -m 0.1 -sty Full -bs 32 --Epoch 201 --ExpRslt 1 [--device cpu]
    python -m weaksuppointcloudseg_tpu_torch.cli.train_shapenet \\
        -m 0.1 -sty Full --Precision bfloat16 --FastKNN -bs 32

Trains at the preset's float32 precision (kernels B12 and B13 on the card)
or, with ``--Precision bfloat16``, through the fused blocks (kernels B1-B5,
and in Full style the fused smoothness loss over the transform stage's
graph, kernels B6),
evaluates on the val split every ``eval_every`` epochs and, with
``--ExpRslt``, writes the summary, a metrics log and format-v2 checkpoints
that the test CLI restores. Runs on CUDA device ``--GPU``; where there is
no card it raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from weaksuppointcloudseg_tpu_torch.cli import common
from weaksuppointcloudseg_tpu_torch.data import sampling
from weaksuppointcloudseg_tpu_torch.data import shapenet as shapenet_data
from weaksuppointcloudseg_tpu_torch.train.loop import ShapeNetTrainer
from weaksuppointcloudseg_tpu_torch.utils.profiling import MetricsLogger, StepTimer
from weaksuppointcloudseg_tpu_torch.utils.tools import Summary


def parser():
    return common.base_parser(train=True)


def main(argv=None) -> dict:
    """Runs the epochs; returns the last epoch's train metrics under
    ``train`` and the last evaluation under ``eval``."""
    p = parser()
    args = p.parse_args(argv)
    common.refuse_unported(p, args)
    cfg = common.build_config(args)
    data_path = args.DataPath or "./Dataset/ShapeNet"

    ds = shapenet_data.ShapeNetDataset(data_path)
    num_train = ds.num_samples("train")
    num_points = ds.split("train")[0].shape[1]  # 2048 for real ShapeNet
    # class/category counts from the dataset (16/50 for real ShapeNet)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_classes=ds.meta.num_part_cats,
        num_categories=ds.meta.num_categories))

    # SampIndex: the reference's .mat if present, a seeded draw otherwise
    pts_idx = None
    if args.m < 1.0:
        pts_idx = sampling.load_or_generate(
            os.path.join(data_path, "Preprocess"), args.m,
            num_samples=num_train, num_points=num_points, seed=args.seed)

    base_path = common.result_base_path(args) if args.ExpRslt else None
    summary = Summary(base_path, enabled=args.ExpRslt)
    summary.log(f"{vars(args)}\n")
    trainer = ShapeNetTrainer(cfg, ds, pts_idx, seed=args.seed,
                              device=common.device(args),
                              ckpt_dir=summary.ckpt_dir)
    metrics_log = MetricsLogger(
        os.path.join(summary.summary_dir, "metrics.jsonl")
        if summary.enabled else None)
    timer = StepTimer()
    epoch_points = ((num_train // cfg.train.batch_size) * cfg.train.batch_size
                    * num_points)

    best_miou, out = -1.0, {}
    for epoch in range(trainer.epoch, args.Epoch):
        timer.start()
        m = trainer.train_epoch(epoch)  # ends in one device-to-host fetch
        epoch_s = timer.stop()
        out["train"] = m
        summary.log(
            f"Epoch {epoch} Train loss {m['total']:.4f} acc {100 * m['acc']:.2f}% "
            f"lr {m['lr']:.2e} ({epoch_points / epoch_s:,.0f} pts/s)\n")
        metrics_log.log("train_epoch", epoch=epoch,
                        points_per_sec=epoch_points / epoch_s, **m)
        if epoch % cfg.train.eval_every == 0:  # train_ShapeNet.py:121
            loss, acc, perdata, pershape = trainer.evaluate()
            miou = float(np.mean(pershape))
            out["eval"] = dict(loss=loss, acc=acc, perdata_miou=perdata,
                               pershape_miou=miou)
            summary.log(
                f"Epoch {epoch} Eval loss {loss:.4f} acc {100 * acc:.2f}% "
                f"perdata mIoU {100 * perdata:.2f}% pershape mIoU {100 * miou:.2f}%\n")
            metrics_log.log("eval", epoch=epoch, **out["eval"])
            if args.ExpRslt:
                trainer.save_checkpoint(metric=miou)
            if miou > best_miou:
                best_miou = miou
                summary.log(f"Epoch {epoch} new best pershape mIoU {100 * miou:.2f}%\n")
    return out


if __name__ == "__main__":
    main()
