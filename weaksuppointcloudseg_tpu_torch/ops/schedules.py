"""Staircase exponential-decay schedules of the reference trainers.

Counterpart of weaksuppointcloudseg_tpu/ops/schedules.py (reference:
ShapeNet/ShapeNet_DGCNN_trainer.py:36-54). Both schedules are driven by
the number of unique samples seen, ``step * batch_size``: the Full style's
Siamese pairs feed twice that many clouds, but the reference passes the
unique batch size (train/steps.py:176-179). The step counter lives on the
host, so the values are host floats, computed in float32 as the reference
computes them.
"""

from __future__ import annotations

import numpy as np

from weaksuppointcloudseg_tpu_torch.configs import ScheduleConfig


def _exponent(step: int, batch_size: int, decay_step: int) -> np.float32:
    samples = np.float32(step) * np.float32(batch_size)
    return np.floor(samples / np.float32(decay_step))


def learning_rate_schedule(step: int, batch_size: int,
                           cfg: ScheduleConfig) -> float:
    """lr = max(base * rate^floor(step*bs/decay_step), floor)."""
    e = _exponent(step, batch_size, cfg.lr_decay_step)
    lr = np.float32(cfg.base_learning_rate) * np.power(
        np.float32(cfg.lr_decay_rate), e)
    return float(np.maximum(lr, np.float32(cfg.lr_floor)))


def bn_decay_schedule(step: int, batch_size: int, cfg: ScheduleConfig) -> float:
    """bn_decay = min(clip, 1 - init*rate^floor(step*bs/bn_decay_step))."""
    e = _exponent(step, batch_size, cfg.bn_decay_decay_step)
    momentum = np.float32(cfg.bn_init_decay) * np.power(
        np.float32(cfg.bn_decay_decay_rate), e)
    return float(np.minimum(np.float32(cfg.bn_decay_clip),
                            np.float32(1.0) - momentum))
