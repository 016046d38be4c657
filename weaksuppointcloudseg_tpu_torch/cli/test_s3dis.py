"""S3DIS room-wise test CLI on the port (reference:
weaksuppointcloudseg_tpu/cli/test_s3dis.py, same flags and output).

    python -m weaksuppointcloudseg_tpu_torch.cli.test_s3dis \\
        --DataPath <blocks> --RoomsPath <rooms> --Checkpoint <v2 .npz> \\
        -sty Full -bs 14 --Precision bfloat16 --FastKNN [--RoomLP] \\
        [--device cpu]

Sweeps each raw room of Area ``-ta`` (``<RoomsPath>/meta/area<k>_data_
label.txt``) into 1 m blocks, runs the eval forward and, for the Full
style, label propagation: per block chunk (the reference's), or with
``--RoomLP`` one matrix-free LP over the whole room (kernel B10 on the
card). Prints the mIoU and the per-class IoU and writes a ``.mat`` per
room and ``PerClassIoU.mat`` under ``<run>/Prediction``. Runs on CUDA
device ``--GPU``; where there is no card it raises unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from weaksuppointcloudseg_tpu_torch.cli import common
from weaksuppointcloudseg_tpu_torch.data import s3dis as s3dis_data
from weaksuppointcloudseg_tpu_torch.train.loop import S3DISTrainer

S3DIS_CLASSES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "table", "chair", "sofa", "bookcase", "board", "clutter",
]


def parser():
    """The reference test CLI's flags, ``--device``, and ``-bs`` for
    ``--batchsize`` as the training CLIs spell it."""
    p = common.base_parser("S3DIS", train=False)
    p.add_argument("-bs", dest="batchsize", type=int, default=argparse.SUPPRESS,
                   help="blocks per forward chunk (same as --batchsize)")
    p.add_argument("--test_area", "-ta", type=int, default=5)
    p.add_argument("--RoomsPath", type=str, default=None,
                   help="base dir holding meta/<area>_data_label.txt and the "
                        "raw room files [default: --DataPath or ./Dataset/S3DIS]")
    p.add_argument("--RoomLP", action="store_true",
                   help="one matrix-free label propagation over all block "
                        "points of each room in room coordinates (kernel B10 "
                        "on the card) instead of the reference's per-block "
                        "refinement. Needs -sty Full (label propagation runs "
                        "only for the Full style); ignored with a warning "
                        "otherwise")
    return p


def main(argv=None) -> dict:
    p = parser()
    args = p.parse_args(argv)
    common.refuse_unported(p, args)
    cfg = common.build_config(args, "S3DIS")
    data_path = args.DataPath or "./Dataset/S3DIS/indoor3d_sem_seg_hdf5_data"
    rooms_base = args.RoomsPath or args.DataPath or "./Dataset/S3DIS"

    ds = s3dis_data.S3DISDataset(data_path)
    rooms = s3dis_data.S3DISTestRooms(rooms_base, f"area{args.test_area}",
                                      num_point=cfg.model.num_points)
    trainer = S3DISTrainer(cfg, ds, None, test_area=args.test_area,
                           seed=args.seed, device=common.device(args))
    if args.Checkpoint:
        ckpt = args.Checkpoint
        base = os.path.dirname(os.path.dirname(ckpt))
    else:
        base = common.find_result_dir("S3DIS", args)
        ckpt = os.path.join(base, "Checkpoint", "Checkpoint_epoch-best.npz")
    trainer.restore_checkpoint(ckpt)

    pred_dir = os.path.join(base, "Prediction") if base else None
    with common.profile_context(args):
        res = trainer.test(rooms, use_label_prop=args.Style == "Full",
                           pred_dir=pred_dir, room_lp=args.RoomLP)
    print(f"Test Area {args.test_area}  mIoU {100 * res['miou']:.2f}%  "
          f"acc {100 * res['accuracy']:.2f}%")
    for name, iou in zip(S3DIS_CLASSES, res["per_class_iou"]):
        print(f"  {name:10s} IoU {100 * iou:.2f}%")
    if pred_dir:
        import scipy.io

        os.makedirs(pred_dir, exist_ok=True)
        scipy.io.savemat(os.path.join(pred_dir, "PerClassIoU.mat"),
                         {"per_class_iou": np.asarray(res["per_class_iou"])})
    return res


if __name__ == "__main__":
    main()
