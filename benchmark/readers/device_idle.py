"""The share of the traced window in which no operation ran on the
device, in %."""


def read(obs):
    tr = obs.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
