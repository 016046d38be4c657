"""The device trace of a window: torch.profiler's events reduced to kernel
intervals, busy time, idle gaps and what the host was doing in each.

The idle share is 1 minus the union of the device's operation intervals
(kernels, copies, fills) over the traced window, the arithmetic of
chip_smoke.py::device_breakdown done on intervals instead of summed
durations, so that overlapping kernels are not counted twice.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW_SPAN = "bench.window"


def _ns(ev, what: str) -> int:
    if hasattr(ev, f"{what}_ns"):
        return int(getattr(ev, f"{what}_ns")())
    return int(getattr(ev, f"{what}_us")() * 1000)


@dataclass
class Trace:
    """Intervals in ns of one traced window."""

    window: Tuple[int, int]
    kernels: List[Tuple[int, int, str]]  # device operations (start, end, name)
    host: List[Tuple[int, int, str]]  # host events (start, end, name)
    spans: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        w0, w1 = self.window
        merged: List[List[int]] = []
        for s, e, _ in sorted(self.kernels):
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s

    def kernel_s(self, match) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name
        ``match(name)`` accepts."""
        sel = [e - s for s, e, n in self.kernels if match(n)]
        return sum(sel) / 1e9, len(sel)

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, int] = {}
        for s, e, name in self.kernels:
            total[name] = total.get(name, 0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10, short_ns: int = 20_000) -> List[List]:
        """Idle time of the device summed by what the host was doing in the
        middle of each gap: the innermost host event then running (an
        operator, a runtime call or a benchmark span), longest first.
        Gaps under ``short_ns`` are summed as one entry."""
        w0, w1 = self.window
        gaps, t = [], w0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < w1:
            gaps.append((t, w1))
        host = sorted(self.host)
        starts = [h[0] for h in host]
        short = f"gaps under {short_ns // 1000} us"
        total: Dict[str, int] = {}
        for g0, g1 in gaps:
            name = short
            if g1 - g0 >= short_ns:
                name = "host (no event)"
                mid = (g0 + g1) // 2
                i = bisect.bisect_right(starts, mid)
                # the latest-starting host event still running mid-gap
                for j in range(i - 1, max(i - 4000, 0) - 1, -1):
                    if host[j][1] > mid:
                        name = host[j][2]
                        break
            total[name] = total.get(name, 0) + (g1 - g0)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]


def reduce(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` whose
    window was marked with :func:`span` ``WINDOW_SPAN``."""
    from torch.autograd import DeviceType

    kernels, host, spans = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        s = _ns(ev, "start")
        e = s + _ns(ev, "duration")
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # the device's own operations; a host span's shadow on the
            # device timeline (a user annotation) is none
            if not ev.is_user_annotation() and not name.startswith("bench."):
                kernels.append((s, e, name))
        else:
            host.append((s, e, name))
            if name.startswith("bench."):
                spans.setdefault(name, []).append((s, e))
    if WINDOW_SPAN not in spans:
        raise RuntimeError("the trace holds no window span")
    window = spans[WINDOW_SPAN][0]
    host = [h for h in host if h[2] != WINDOW_SPAN]
    return Trace(window, kernels, host, spans)


@contextlib.contextmanager
def profiled(enabled: bool):
    """A torch.profiler over the block (CPU and CUDA activities), or
    nothing; yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def span(name: str):
    """A named host span in the trace (torch.profiler.record_function)."""
    from torch.profiler import record_function

    return record_function(name)
