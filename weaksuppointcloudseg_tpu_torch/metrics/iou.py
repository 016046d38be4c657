"""Segmentation metrics (counterpart of weaksuppointcloudseg_tpu/metrics/
iou.py): the ShapeNet per-shape IoU and category-biased argmax, and the
S3DIS confusion counts behind its validation mIoU."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def eval_iou(pred: np.ndarray, seg_gt: np.ndarray, iou_oids: Sequence[int]) -> float:
    """Per-shape IoU averaged over the given part ids; an empty union counts
    1 (Util/Evaluation.py:13-36)."""
    pred = np.asarray(pred)
    seg_gt = np.asarray(seg_gt)
    total_iou = 0.0
    for oid in iou_oids:
        n_pred = np.sum(pred == oid)
        n_gt = np.sum(seg_gt == oid)
        n_intersect = np.sum((seg_gt == oid) & (pred == seg_gt))
        n_union = n_pred + n_gt - n_intersect
        total_iou += 1.0 if n_union == 0 else n_intersect / n_union
    return total_iou / len(iou_oids)


def category_biased_argmax(prob: np.ndarray, iou_oids: Sequence[int]) -> np.ndarray:
    """argmax over classes after boosting the shape's own part ids by +1
    (ShapeNet_DGCNN_trainer.py:199-201)."""
    biased = np.array(prob, copy=True)
    biased[..., list(iou_oids)] += 1.0
    return np.argmax(biased, axis=-1)


class ConfusionAccumulator:
    """Running per-class true positives, predictions and ground truth
    (S3DIS_DGCNN_trainer.py:412-481)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.true_positive = np.zeros(num_classes, dtype=np.float64)
        self.positive = np.zeros(num_classes, dtype=np.float64)
        self.gt = np.zeros(num_classes, dtype=np.float64)
        self.total_correct = 0.0
        self.total_seen = 0.0

    def update(self, pred: np.ndarray, gt: np.ndarray) -> None:
        pred = np.asarray(pred).reshape(-1)
        gt = np.asarray(gt).reshape(-1)
        k = self.num_classes
        self.total_correct += float(np.sum(pred == gt))
        self.total_seen += float(pred.size)
        self.positive += np.bincount(pred, minlength=k)[:k]
        self.gt += np.bincount(gt, minlength=k)[:k]
        self.true_positive += np.bincount(pred[pred == gt], minlength=k)[:k]

    @property
    def iou(self) -> np.ndarray:
        # the reference's 1e-5 in the denominator
        return self.true_positive / (self.gt + self.positive
                                     - self.true_positive + 1e-5)

    @property
    def miou(self) -> float:
        return float(np.mean(self.iou))

    @property
    def accuracy(self) -> float:
        return self.total_correct / max(self.total_seen, 1.0)
