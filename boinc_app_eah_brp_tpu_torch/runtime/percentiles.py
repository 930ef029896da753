"""Exact percentiles, shared by every latency consumer.

Three call sites used to compute percentiles three ways: the fleet
rollup (``tools/fleet_report.py``) hand-rolled the exact numpy-'linear'
definition, the serving scoreboard (``serving/server.py``) floor-indexed
a sorted list (``gaps[int(0.95 * (len - 1))]`` — biased LOW at small N:
for 10 gaps it returns the 9th-of-10 value where the exact p95 sits
between the 9th and 10th), and the histogram renderer reported bucket
upper bounds.  This module is the single definition the first two share
— plus the serving SLO monitor (``serving/slo.py``) and the measured
step-latency report (``runtime/steptime.py`` / ``tools/step_report.py``)
added with it.

The definition is numpy's 'linear' interpolation: ``rank = (pct/100) *
(n-1)``; the result interpolates between ``floor(rank)`` and
``ceil(rank)``.  Pinned by ``tests/test_percentiles.py`` on known
inputs so every consumer inherits the same p50/p95/p99 semantics.

No numpy, no torch: host-side control-plane tools import this freely.
"""

from __future__ import annotations

PCTS = (50, 95, 99)


def percentile(sorted_vals, pct: float) -> float:
    """Exact percentile of an ascending-sorted sequence (the numpy
    'linear' definition, hand-rolled so tools stay numpy-optional).
    Empty input yields 0.0."""
    if not sorted_vals:
        return 0.0
    n = len(sorted_vals)
    if n == 1:
        return float(sorted_vals[0])
    rank = (pct / 100.0) * (n - 1)
    lo = int(rank)
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    return float(sorted_vals[lo]) * (1.0 - frac) + float(sorted_vals[hi]) * frac


def latency_block(values, pcts=PCTS, digits: int = 6) -> dict:
    """The standard summary block every latency surface reports:
    ``{n, p50, p95, p99, mean, max}`` (None values are dropped before
    sorting; an empty input reports zeros)."""
    vals = sorted(v for v in values if v is not None)
    block = {"n": len(vals)}
    for pct in pcts:
        block[f"p{pct}"] = round(percentile(vals, pct), digits)
    block["mean"] = round(sum(vals) / len(vals), digits) if vals else 0.0
    block["max"] = round(float(vals[-1]), digits) if vals else 0.0
    return block
