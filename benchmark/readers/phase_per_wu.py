"""A program phase's wall seconds per workunit, from the run reports'
phase brackets (``runtime/profiling.py::phase``) over the window's
workunits."""


def read(obs, phase):
    phases, n = obs.get("phases"), obs.get("workunits")
    if not phases or not n or phase not in phases:
        return None
    return phases[phase]["wall_s"] / n
