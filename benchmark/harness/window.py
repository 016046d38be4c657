"""What a run hands the per-layer metric readers, and the checks that
decide ``correct``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from harness.trace import Trace


@dataclass
class Window:
    """One traced window. ``kind`` is "train" or "test". Training: the
    steps completed in the window, clouds per step (Siamese twins
    included) and points per cloud. Test: one record per request
    completed in the window, with its host span in the trace's clock
    (``span``, ns), the clouds (blocks or views) its forward ran, their
    points (``points``) and, for rooms, the room's index (``room``);
    ``rooms`` maps a room's index to its raw points."""

    kind: str
    config: dict
    mix: dict
    trace: Trace
    steps: int = 0
    clouds_per_step: int = 0
    points: int = 0
    requests: List[dict] = field(default_factory=list)
    rooms: Dict[int, np.ndarray] = field(default_factory=dict)
    device: Optional[object] = None


@dataclass
class Check:
    """One number compared, with its limit: it passes at or below it."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value) and self.value <= self.limit)


def gap_of_norms(prog: np.ndarray, ref: np.ndarray,
                 keep: Optional[np.ndarray] = None) -> float:
    """The worst leaf's |prog norm - ref norm| over the larger of the
    reference leaf's norm and the median leaf's, over the leaves in
    ``keep``."""
    keep = np.ones(len(ref), bool) if keep is None else keep
    scale = np.maximum(ref, np.median(ref[keep]))
    return float(np.max(np.abs(prog - ref)[keep] / scale[keep]))
