"""Spans, traces, step timer and metrics log of the port (counterpart of
weaksuppointcloudseg_tpu/utils/profiling.py; its NaN-debug context is not
ported).

- ``span``: a named host span of the port's own work (batch assembly, the
  room sweep, the eval forward, the room LP and its CG steps). It is a
  ``torch.profiler.record_function`` while a profiler records, and a shared
  no-op context otherwise, so an untraced run pays ~1 us a span. The spans
  are profiler events: they share the device trace's clock, and a count is
  the number of spans of one kind.
- ``trace``: a ``torch.profiler`` over the enclosed block (CPU, plus CUDA
  where there is a card) that writes one Chrome trace into a directory on
  exit (the CLIs' ``--profile DIR``).
- ``StepTimer`` and ``MetricsLogger``: the training CLI's wall clock and
  JSONL log. A wall-clock time is only a device time if the timed work ends
  in a synchronise: the trainer's epoch ends with one transfer of its
  metrics.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A host span ``name`` in a running profiler's trace; without one the
    same shared no-op context every call. A span adds no synchronise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed block (host, and the card where there is one)
    and write one Chrome trace, ``trace_<time>_<pid>.json``, into
    ``log_dir`` on exit (view it in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    stamp = time.strftime("%Y%m%d-%H%M%S")
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{stamp}_{os.getpid()}.json"))


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
