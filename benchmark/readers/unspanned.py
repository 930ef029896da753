"""Seconds of the traced window that no program span names: the window
minus the union of every ``erp:`` range in it, on any thread the
profiler sees.  None where the trace holds no ``erp:`` range."""

from bmlib import spans


def read(obs):
    tr = obs.get("trace")
    if tr is None:
        return None
    found = spans.clipped(tr, lambda name: name.startswith(spans.PREFIX))
    return tr.window_s - spans.union_s(found) if found else None
