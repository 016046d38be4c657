"""Step timer and metrics log of the training CLI (counterpart of the
``StepTimer`` and ``MetricsLogger`` of weaksuppointcloudseg_tpu/utils/
profiling.py; its JAX trace and NaN-debug contexts are not ported).

A wall-clock time is only a device time if the timed work ends in a
synchronise: the trainer's epoch ends with one transfer of its metrics.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class StepTimer:
    """Wall-clock seconds of a step or an epoch."""

    def __init__(self):
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        """Returns the seconds since ``start``."""
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return dt


class MetricsLogger:
    """Append-mode JSONL metrics, one object per event (no file: a no-op)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            open(path, "w").close()

    def log(self, event: str, **fields) -> None:
        if not self.path:
            return
        rec = {"event": event, "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "item") else v)
                    for k, v in fields.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
