"""The program's own spans in a traced window.

The port marks its work with named host spans (``utils/profiling.py::
span``: ``train.*``, ``test.room``, ``room.*``, ``lp.*``), which
torch.profiler records as host events on the device trace's clock; they
are in :attr:`Trace.host`. A program without them gives empty lists here,
and the metrics that read them then read nothing.
"""

from __future__ import annotations

import bisect
from typing import List, Tuple

Span = Tuple[int, int]


def named(trace, name: str) -> List[Span]:
    """The spans ``name`` that start inside the traced window, in order."""
    w0, w1 = trace.window
    return sorted((s, e) for s, e, n in trace.host if n == name and w0 <= s < w1)


def inside(spans: List[Span], outer: Span) -> List[Span]:
    """The spans of the sorted ``spans`` that lie within ``outer``."""
    s0, e0 = outer
    i = bisect.bisect_left(spans, (s0, s0))
    out = []
    for s, e in spans[i:]:
        if s > e0:
            break
        if e <= e0:
            out.append((s, e))
    return out


def rooms(w) -> List[Span]:
    """The ``test.room`` spans inside the window's request spans: one per
    room served."""
    room = named(w.trace, "test.room")
    return [r for req in w.requests for r in inside(room, req["span"])]


def per_room(w, name: str) -> List[List[Span]]:
    """For each room served in the window, its spans ``name``."""
    spans = named(w.trace, name)
    return [inside(spans, r) for r in rooms(w)]


def in_rooms(w, name: str) -> List[Span]:
    """The spans ``name`` of every room served in the window."""
    return [s for r in per_room(w, name) for s in r]


def seconds(spans: List[Span]) -> float:
    return sum(e - s for s, e in spans) / 1e9


def busy_share(trace, spans: List[Span]) -> float:
    """The union of the device's operation intervals inside ``spans`` over
    their summed length."""
    busy = trace.busy_intervals()
    starts = [s for s, _ in busy]
    covered = 0
    for s0, e0 in spans:
        i = max(bisect.bisect_right(starts, s0) - 1, 0)
        for s, e in busy[i:]:
            if s >= e0:
                break
            covered += max(0, min(e, e0) - max(s, s0))
    return covered / sum(e - s for s, e in spans)
