"""A stage group's share of its roofline: its least time on the card
(``data/stage_bytes.json`` at ``data/peaks.json``'s rates) over the device
time the trace gives its kernels, in %."""

from bmlib import trace


def read(obs, stages):
    tr, env, peaks = obs.get("trace"), obs.get("shapes"), obs.get("peaks")
    if tr is None or env is None or peaks is None:
        return None
    spent = tr.stage_s(stages)
    if not spent:
        return None
    return 100.0 * trace.least_time_s(stages, env, peaks) / spent
