"""BOINC tasks of several workunits through the command line, one fresh
process a task, one task at a time, closed loop: the reference's wrapper
runs a task's N ``-i``/``-o`` pairs in one process
(``erp_boinc_wrapper.cpp:430-474``).

Set-up first asks the program's command line (``runtime/cli.py::
parse_args``) whether it keeps every pair of a task, and ends the run
with no result where it keeps one (a program that would search one
workunit a task and leave the others' files unwritten); then it is the
command-line cell's (``drivers/cli.py::setup``: the pool of
``drivers/served.py::make_pool``, ``pool`` workunits, the kernels and the
native median built before the window; this process stays off the
card), and then it warms the children's bytecode (:func:`warm_bytecode`).
Each task is one child (``drivers/program_main.py``) whose argv
holds the configuration's ``pairs_per_task`` pairs, the pool in the
order the run's seed permutes, each pair with an output file of its own,
then one bank, one zaplist and one checkpoint, the configuration's flags
and ``--metrics-file`` for the task's run report.  A task starts while
``--seconds`` have not passed; the window ends at the last exit.
``cli_wu_per_hour`` counts the candidate files written whole (ending in
``%DONE%``) by tasks that exited 0 with no forbidden module, x 3,600,
over the time from the first start to the last exit; every other pair
of a task is a failed workunit.  A traced run reads the window's tasks'
run reports (``task_gap_s``: each task's wall less its phases, summed;
``phases``; ``workunits``: the passes they ran), then runs one more task
under the profiler.  The check: every file of the run whole and naming
only the bank's templates (``files_not_whole``), and ``judge_sample``
files drawn from the seed among passes 2 to N judged against the
reference (``bmlib/judge.py::judge_candidates``).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

from bmlib import harness, inputs, judge, reference, trace

IN_PROCESS = False
CLI = harness.load_module("drivers", "cli")
# a task under the profiler runs its passes several times slower
TASK_TIMEOUT_S = 1800


def keeps_every_pair() -> bool:
    """Whether the program's command line keeps both pairs of a
    two-pair argv."""
    from boinc_app_eah_brp_tpu_torch.runtime.cli import parse_args

    args = parse_args(["-i", "a.bin4", "-o", "a.cand", "-i", "b.bin4", "-o", "b.cand", "-t", "t"])
    task = getattr(args, "task", None)
    return callable(task) and len(task()) == 2


# every module of the program but its entry point, imported once
WARM = ("import importlib, pkgutil, boinc_app_eah_brp_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('.__main__'):\n"
        "        importlib.import_module(m.name)\n")


def warm_bytecode(run, env: dict) -> None:
    """Give the children a bytecode cache inside the checkout and fill it
    before the window, as an installed program has its modules compiled
    once.  Where the environment forbids writing bytecode
    (``PYTHONDONTWRITEBYTECODE``) and the installed torch ships none,
    every task would otherwise compile torch's sources anew: 7-10 s of
    host time a process, which swings with the host's load and would
    set the spread of a window of two or three tasks."""
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    env["PYTHONPYCACHEPREFIX"] = os.path.join(harness.ROOT, ".bench_cache", "pycache")
    subprocess.run([sys.executable, "-c", WARM], cwd=run.dir, env=env, check=True, timeout=600)


def setup(run) -> dict:
    if not keeps_every_pair():
        raise SystemExit("no result: the program's command line keeps one -i/-o pair a task")
    st = CLI.setup(run)
    st["n_pairs"] = int(run.config["pairs_per_task"])
    warm_bytecode(run, st["env"])
    return st


def _argv(run, st, j: int, traced: bool) -> tuple[list, list]:
    """Task ``j``'s argv and its pairs as (pass, pool index, output)."""
    argv = [sys.executable, CLI.MAIN] + (["--trace", os.path.join(run.dir, "trace.json")] if traced else [])
    pairs = []
    for k in range(st["n_pairs"]):
        idx = st["order"][k % len(st["order"])]
        out = os.path.join(run.dir, f"t{j}p{k}.cand")
        argv += ["-i", st["paths"][idx]["wu"], "-o", out]
        pairs.append((k, idx, out))
    files = st["paths"][0]
    argv += ["-t", files["bank"], "-l", files["zap"], "-c", os.path.join(run.dir, f"t{j}.cpt"), *run.config["argv"],
             "--metrics-file", os.path.join(run.dir, f"t{j}.metrics.jsonl")]
    if run.device != "cuda":
        argv += ["--device", run.device]
    return argv, pairs


def _whole(path: str) -> bool:
    try:
        with open(path) as f:
            return f.read().endswith("%DONE%\n")
    except OSError:
        return False


def _task(run, st, j: int, traced: bool) -> tuple[float, dict | None]:
    """Task ``j`` as one child process; returns its wall on this clock and
    its run report."""
    argv, pairs = _argv(run, st, j, traced)
    a = time.perf_counter()
    proc = subprocess.run(argv, cwd=run.dir, env=st["env"], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                          text=True, timeout=TASK_TIMEOUT_S)
    wall = time.perf_counter() - a
    report = CLI._report(os.path.join(run.dir, f"t{j}.metrics.jsonl.report.json"))
    found = [ln[len(CLI.FOUND):] for ln in proc.stderr.splitlines() if ln.startswith(CLI.FOUND)]
    if found:
        run.forbidden.extend(found[-1].split(", "))
    ok = proc.returncode == 0 and not found
    written = 0
    for k, idx, out in pairs:
        run.attempted += 1
        if ok and _whole(out):
            st["done"].append((idx, out, k))
            written += 1
        else:
            run.failed += 1
    if not ok:
        print(f"cli_pairs: task {j} exited {proc.returncode}: {proc.stderr[-2000:]}", file=sys.stderr)
    print(f"cli_pairs: task {j} exit {proc.returncode} wall {wall:.3f} s, {written} of {len(pairs)} files"
          + ("" if report is None else f", report {report['wall_s']} s, passes "
             + ", ".join(f"{p.get('wall_s')}" for p in report.get("passes", []))),
          file=sys.stderr)
    if report is not None:
        run.peak_bytes = max([run.peak_bytes] + [d.get("peak_bytes_in_use", 0) for d in report.get("devices", [])])
    return wall, report


def _passes_run(report: dict) -> int:
    """The passes a task's run report says it searched (1 where it lists
    none)."""
    return sum(1 for p in report.get("passes", []) if not p.get("skipped")) or 1


def window(run, st) -> None:
    gap, phases, n = 0.0, {}, 0
    j = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        wall, report = _task(run, st, j, traced=False)
        j += 1
        if report is not None:
            own = report.get("metrics", {}).get("phases", {})
            # the task's wall that no phase of any pass holds: interpreter,
            # imports, CUDA context, library loads, plans, reads and writes
            gap += wall - sum(v["wall_s"] for v in own.values())
            for k, v in own.items():
                phases[k] = {"wall_s": phases.get(k, {}).get("wall_s", 0.0) + v["wall_s"]}
            n += _passes_run(report)
    end = time.perf_counter()
    good = len(st["done"])
    run.metrics["cli_wu_per_hour"] = good * 3600.0 / (end - t0) if good else 0.0
    print(f"cli_pairs: {good} workunits in {j} tasks in {end - t0:.3f} s", file=sys.stderr)
    if run.traced:
        # one more task under the profiler, after the window
        _task(run, st, j, traced=True)
        run.obs.update(task_gap_s=gap, phases=phases, workunits=n)
        path = os.path.join(run.dir, "trace.json")
        if os.path.exists(path):
            run.obs["trace"] = trace.load(path)


def check(run, st) -> tuple[bool, list]:
    pool, done, tr = st["pool"], st["done"], run.traffic
    bank = judge._bank_keys(pool[0])
    not_whole = 0
    for _, path, _ in done:
        with open(path) as f:
            rows, keys = judge._parse(f.read(), pool[0].geom.t_obs)
        if rows is None or any(key not in bank for key in keys):
            not_whole += 1
    warm = [d for d in done if d[2] >= 1]
    numbers = dict(power_gap=float("inf"), top_gap=float("inf"))
    if not (run.failed or not_whole or not warm):
        numbers = dict(power_gap=0.0, top_gap=0.0)
        ref = reference.Reference(pool[0].geom, run.device)
        rng = inputs.rng_for(run.seed, 5)
        for i in sorted(rng.choice(len(warm), size=min(tr["judge_sample"], len(warm)), replace=False)):
            idx, path, k = warm[i]
            with open(path) as f:
                got = judge.judge_candidates(f.read(), pool[idx], ref, tr["reference_batch"])
            print(f"judge: {os.path.basename(path)} (pass {k}, pool {idx}) "
                  + " ".join(f"{n} {v!r}" for n, v in got.items()), file=sys.stderr)
            numbers = {n: max(numbers[n], got[n]) for n in numbers}
    numbers["files_not_whole"] = float(not_whole)
    return judge.verdict(numbers, tr["limits"])
