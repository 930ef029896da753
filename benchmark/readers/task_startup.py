"""What a command-line task of several workunits pays outside its passes'
work, in s per workunit: each task's wall on the harness's clock minus
the walls of its run report's phases (whitening, template loop, oracle
rescore, summed over its passes), summed over the window's tasks, over
the workunits they searched.  That holds the interpreter's start, the
imports, the CUDA context, the library loads and the cuFFT plans once a
task, and each pass's reads, set-up and writes.  None where no task gave
a report."""


def read(obs):
    gap, n = obs.get("task_gap_s"), obs.get("workunits")
    return gap / n if gap is not None and n else None
