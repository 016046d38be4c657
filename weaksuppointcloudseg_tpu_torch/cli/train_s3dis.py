"""S3DIS weak-supervision training CLI on the port (reference:
weaksuppointcloudseg_tpu/cli/train_s3dis.py, same flags and output).

    python -m weaksuppointcloudseg_tpu_torch.cli.train_s3dis \\
        -m 0.1 -sty Full -bs 14 --Epoch 201 -ta 5 --ExpRslt 1 [--device cpu]
    python -m weaksuppointcloudseg_tpu_torch.cli.train_s3dis \\
        -m 0.1 -sty Full -bs 14 --Precision bfloat16 --FastKNN -ta 5

``-m 0`` labels one point of each class present in a block
(train_S3DIS.py:96-99). Trains at the preset's float32 precision (kernel
B12 for the kNN graphs and B13 for their gathers' backward on the card)
or, with ``--Precision bfloat16``, through the fused blocks (kernels B1-B5)
with the Full-style smoothness loss over kernel B9 (backward B6); the
blocks of rooms in Area ``-ta`` are the validation split, evaluated every
``eval_every`` epochs with the confusion mIoU. With ``--ExpRslt`` it writes
the summary, a metrics log and format-v2 checkpoints. Runs on CUDA device
``--GPU``; where there is no card it raises unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import os

from weaksuppointcloudseg_tpu_torch.cli import common
from weaksuppointcloudseg_tpu_torch.data import s3dis as s3dis_data
from weaksuppointcloudseg_tpu_torch.data import sampling
from weaksuppointcloudseg_tpu_torch.train.loop import S3DISTrainer
from weaksuppointcloudseg_tpu_torch.utils.profiling import MetricsLogger, StepTimer
from weaksuppointcloudseg_tpu_torch.utils.tools import Summary


def parser():
    p = common.base_parser("S3DIS", train=True)
    p.add_argument("--test_area", "-ta", type=int, default=5,
                   help="Test area 1 to 6")
    return p


def main(argv=None) -> dict:
    """Runs the epochs; returns the last epoch's train metrics under
    ``train`` and the last evaluation under ``eval``."""
    p = parser()
    args = p.parse_args(argv)
    common.refuse_unported(p, args)
    cfg = common.build_config(args, "S3DIS")
    data_path = args.DataPath or "./Dataset/S3DIS/indoor3d_sem_seg_hdf5_data"

    ds = s3dis_data.S3DISDataset(data_path)
    pts_idx = None
    if args.m < 1.0:
        pts_idx = sampling.load_or_generate(
            os.path.join(os.path.dirname(data_path.rstrip("/")), "Preprocess"),
            args.m, num_samples=len(ds.room_filelist),
            num_points=ds.data.shape[1],  # 4096 for real S3DIS
            seg_labels=ds.label if args.m == 0 else None, seed=args.seed)

    base_path = common.result_base_path(args, "S3DIS") if args.ExpRslt else None
    summary = Summary(base_path, enabled=args.ExpRslt)
    summary.log(f"{vars(args)}\n")
    trainer = S3DISTrainer(cfg, ds, pts_idx, test_area=args.test_area,
                           seed=args.seed, device=common.device(args),
                           ckpt_dir=summary.ckpt_dir)
    metrics_log = MetricsLogger(
        os.path.join(summary.summary_dir, "metrics.jsonl")
        if summary.enabled else None)
    timer = StepTimer()
    epoch_points = ((len(trainer.train_idx) // cfg.train.batch_size)
                    * cfg.train.batch_size * ds.data.shape[1])

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
        if epoch % cfg.train.eval_every == 0:  # train_S3DIS.py
            loss, acc, miou, _ = trainer.evaluate()
            out["eval"] = dict(loss=loss, acc=acc, miou=miou)
            summary.log(f"Epoch {epoch} Eval loss {loss:.4f} acc "
                        f"{100 * acc:.2f}% mIoU {100 * miou:.2f}%\n")
            metrics_log.log("eval", epoch=epoch, **out["eval"])
            if args.ExpRslt:
                trainer.save_checkpoint(metric=miou)
            if miou > best_miou:
                best_miou = miou
                summary.log(f"Epoch {epoch} new best mIoU {100 * miou:.2f}%\n")
    return out


if __name__ == "__main__":
    main()
