"""The traced child's program spans: the profiler ranges that the
program's span tracer opens (``erp:<name>``, one for each span while a
``torch.profiler`` records), cut to the traced window, and the seconds
their union covers.  The readers ``span_s`` and ``unspanned`` read them."""

from __future__ import annotations

import math

PREFIX = "erp:"


def clipped(tr, keep) -> list[tuple[float, float]]:
    """(start, end) in us of each host range of the trace ``tr`` whose
    name ``keep(name)`` accepts, cut to the window; a range wholly outside
    the window is left out."""
    w0, w1 = tr.window_us
    return [(max(a, w0), min(b, w1)) for name, a, b in tr.annotations if keep(name) and b >= w0 and a <= w1]


def union_s(intervals) -> float:
    """Seconds covered by the union of (start, end) intervals in us: a
    stretch that several cover counts once."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total * 1e-6
