"""What a warm pass of the traced command-line task pays before its
search, in s: over the task's passes after the first (the profiler ranges
``erp:pass``, in order of start), the mean time from a pass's start to
the start of the first ``erp:template loop`` range inside it: the
workunit's read, whitening, the session's set-up and the checkpoint's
look-up.  None where the trace holds fewer than two passes."""

from bmlib import spans


def read(obs):
    tr = obs.get("trace")
    if tr is None:
        return None
    passes = sorted(spans.clipped(tr, lambda name: name == spans.PREFIX + "pass"))[1:]
    loops = sorted(a for a, _ in spans.clipped(tr, lambda name: name == spans.PREFIX + "template loop"))
    waits = []
    for a, b in passes:
        inside = [s for s in loops if a <= s <= b]
        if inside:
            waits.append((inside[0] - a) * 1e-6)
    return sum(waits) / len(waits) if waits else None
