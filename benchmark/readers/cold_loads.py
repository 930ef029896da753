"""Cold loads in the warm passes of the traced command-line task, per
pass: the profiler ranges ``names`` (such as ``erp:cuda-init``,
``erp:kernel-load``, ``erp:cufft-plan``) that start inside a pass after
the first (``erp:pass``), over those passes.  0 where every pass after
the first finds the context, the kernels and the plans made; None where
the trace holds fewer than two passes."""

from bmlib import spans


def read(obs, names):
    tr = obs.get("trace")
    if tr is None:
        return None
    passes = sorted(spans.clipped(tr, lambda name: name == spans.PREFIX + "pass"))[1:]
    if not passes:
        return None
    want = set(names)
    starts = [a for a, _ in spans.clipped(tr, lambda name: name in want)]
    return sum(1 for s in starts if any(a <= s <= b for a, b in passes)) / len(passes)
