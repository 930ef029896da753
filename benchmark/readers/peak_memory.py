"""The caching allocator's peak over the window, in GB."""


def read(obs):
    peak = obs.get("window_peak_bytes")
    return None if peak is None else peak / 1e9
