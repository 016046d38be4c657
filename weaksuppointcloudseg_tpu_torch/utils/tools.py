"""Host-side helpers (counterpart of weaksuppointcloudseg_tpu/utils/tools.py).

``onehot_encode`` and ``Summary`` are copied rather than imported: the JAX
package's ``utils/__init__.py`` imports its checkpoint module, which imports
JAX.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def onehot_encode(y: np.ndarray, num_classes: int, dtype=np.float32) -> np.ndarray:
    """One-hot encode integer labels of any shape -> shape + [num_classes]."""
    return np.eye(num_classes, dtype=dtype)[np.asarray(y)]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is the default everywhere in
    the port; where there is no card it raises instead of falling back to
    the CPU, which a caller must ask for by name."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device 'cpu' (--device cpu on "
            "the command line) to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class Summary:
    """Append-mode experiment summary writer: the reference's layout
    ``Results/<ds>/<Net>_sty-<Style>_m-<m>_<datetime>/{Summary,Prediction,
    Checkpoint}`` (train_ShapeNet.py:56-78)."""

    def __init__(self, base_path: Optional[str], enabled: bool = True):
        self.enabled = enabled and base_path is not None
        self.base_path = base_path
        if self.enabled:
            self.summary_dir = os.path.join(base_path, "Summary")
            self.pred_dir = os.path.join(base_path, "Prediction")
            self.ckpt_dir = os.path.join(base_path, "Checkpoint")
            for d in (base_path, self.summary_dir, self.pred_dir, self.ckpt_dir):
                os.makedirs(d, exist_ok=True)
            self.summary_file = os.path.join(self.summary_dir, "Summary.txt")
            open(self.summary_file, "w").close()
        else:
            self.summary_dir = self.pred_dir = self.ckpt_dir = None
            self.summary_file = None

    def log(self, msg: str, end: str = "") -> None:
        print(msg, end=end)
        if self.enabled:
            with open(self.summary_file, "a") as fid:
                fid.write(msg + end)
