"""A run-report counter summed over the window's command-line children,
per workunit (child with a report); 0 where no child's report holds the
counter.  None where no child gave a report."""


def read(obs, counter):
    counters, n = obs.get("counters"), obs.get("workunits")
    if counters is None or not n:
        return None
    return counters.get(counter, 0) / n
