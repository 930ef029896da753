"""Seconds of the traced command-line child (one workunit) inside the
program spans ``names`` (profiler ranges such as ``erp:import``): the
union of those ranges, cut to the traced window, so nested or
overlapping ranges count once.  None where the trace holds no such
range: a program without those spans."""

from bmlib import spans


def read(obs, names):
    tr = obs.get("trace")
    if tr is None:
        return None
    want = set(names)
    found = spans.clipped(tr, lambda name: name in want)
    return spans.union_s(found) if found else None
