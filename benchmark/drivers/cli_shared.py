"""Workunits through the command line, ``tasks_per_card`` processes at
once on one card, closed loop, as the BOINC client runs a card whose GPU
utilization factor is below 1 (``gpu_usage`` 0.25: four tasks a card).

Set-up is the command-line cell's (``drivers/cli.py::setup``: the pool
of ``drivers/served.py::make_pool``, the kernels and the native median
built before the window; this process stays off the card), plus one slot
directory a task, each holding the ``init_data.xml`` the client writes
there: the card (``gpu_device_num`` 0) and the task's share of it
(``gpu_usage``, the configuration's).  Every child runs in a slot as its
working directory, so it reads its share there.  The window keeps
``tasks_per_card`` children running: child ``i`` takes the ``i``-th
workunit of the run's order, as the command-line cell's children do, and
a slot whose child exits takes the next child while ``--seconds`` have
not passed; after that none starts, and the window ends at the last
exit.  ``cli_wu_per_hour`` counts the children that exited 0 with a
candidate file and no forbidden module, over the time from the first
start to the last exit.  A traced run then runs one more round of
``tasks_per_card`` children at once, exactly one of them under the
profiler, so the trace holds one task's view of the card with its
neighbours on it.  The check is the served cell's
(``drivers/served.py::judge_files``).

Observations for the readers, from the window's children's run reports:
``startup_s``, ``phases`` and ``workunits`` as the command-line cell
gathers them, ``window_peak_bytes`` (the largest ``peak_bytes_in_use``),
``children_s`` and ``loop_s`` (the children's walls summed, and the
window's), and ``counters`` (each run-report counter summed).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from bmlib import harness, trace

IN_PROCESS = False
CLI = harness.load_module("drivers", "cli")
INIT_DATA = """<app_init_data>
<gpu_device_num>0</gpu_device_num>
<gpu_usage>{share}</gpu_usage>
</app_init_data>
"""
# how often the window looks for an exited child, and how long one may run
POLL_S = 0.02
CHILD_TIMEOUT_S = 900.0


def setup(run) -> dict:
    st = CLI.setup(run)
    st["slots"] = []
    for k in range(int(run.config["tasks_per_card"])):
        slot = os.path.join(run.dir, f"slot{k}")
        os.makedirs(slot)
        with open(os.path.join(slot, "init_data.xml"), "w") as f:
            f.write(INIT_DATA.format(share=run.config["gpu_usage"]))
        st["slots"].append(slot)
    st["reports"], st["ran"] = [], []
    return st


def _start(run, st, i: int, slot: str, traced: bool) -> dict:
    """Child ``i`` started in ``slot``; its standard error goes to a file,
    so that no child blocks on a full pipe while others run."""
    tag = f"w{i}"
    idx = st["order"][i % len(st["order"])]
    err = open(os.path.join(run.dir, f"{tag}.err"), "w+")
    proc = subprocess.Popen(CLI._argv(run, st, idx, tag, traced), cwd=slot, env=st["env"],
                            stdout=subprocess.DEVNULL, stderr=err, text=True)
    return dict(i=i, idx=idx, tag=tag, slot=slot, proc=proc, err=err, start=time.perf_counter())


def _finish(run, st, ch: dict, code: int, wall: float) -> dict | None:
    """What one exited child gave: its candidate file into ``done`` (or a
    failure), its forbidden modules, its peak; returns its run report."""
    ch["err"].seek(0)
    stderr = ch["err"].read()
    ch["err"].close()
    run.attempted += 1
    out = os.path.join(run.dir, f"{ch['tag']}.cand")
    report = CLI._report(os.path.join(run.dir, f"{ch['tag']}.metrics.jsonl.report.json"))
    found = [ln[len(CLI.FOUND):] for ln in stderr.splitlines() if ln.startswith(CLI.FOUND)]
    if found:
        run.forbidden.extend(found[-1].split(", "))
    st["ran"].append((ch["i"], ch["slot"], ch["start"], ch["start"] + wall))
    if code == 0 and os.path.exists(out) and not found:
        st["done"].append((ch["idx"], out, wall))
    else:
        run.failed += 1
        print(f"cli_shared: workunit {ch['i']} exited {code}: {stderr[-2000:]}", file=sys.stderr)
    reported = {} if report is None else report.get("metrics", {})
    seen = {k: reported.get(kind, {}).get(k, {}).get("value") for kind, k in (
        ("gauges", "card.gpu_usage"), ("gauges", "card.budget_bytes"), ("gauges", "autobatch.batch_size"),
        ("gauges", "rescore.workers"), ("counters", "resilience.batch_halved"))}
    print(f"cli_shared: workunit {ch['i']} (pool {ch['idx']}) in {os.path.basename(ch['slot'])} exit {code} "
          f"wall {wall:.3f} s " + json.dumps(seen)
          + ("" if report is None else " phases " + json.dumps(
              {k: round(v["wall_s"], 3) for k, v in report["metrics"].get("phases", {}).items()})),
          file=sys.stderr)
    if report is not None:
        run.peak_bytes = max([run.peak_bytes] + [d.get("peak_bytes_in_use", 0) for d in report.get("devices", [])])
    return report


def _reap(run, st, running: list) -> list:
    """Waits until at least one running child has exited; returns each
    exited child as (child, wall, report), and leaves the rest running."""
    while True:
        now = time.perf_counter()
        exited = []
        for ch in list(running):
            code = ch["proc"].poll()
            if code is None and now - ch["start"] > CHILD_TIMEOUT_S:
                ch["proc"].kill()
                code = ch["proc"].wait()
            if code is not None:
                running.remove(ch)
                wall = now - ch["start"]
                exited.append((ch, wall, _finish(run, st, ch, code, wall)))
        if exited:
            return exited
        time.sleep(POLL_S)


def window(run, st) -> None:
    slots = st["slots"]
    startup, phases, counters, walls, peaks = [], {}, {}, [], []
    running: list = []
    i = 0
    t0 = time.perf_counter()
    for slot in slots:
        running.append(_start(run, st, i, slot, traced=False))
        i += 1
    while running:
        for ch, wall, report in _reap(run, st, running):
            walls.append(wall)
            if report is not None:
                st["reports"].append(report)
                own = report.get("metrics", {}).get("phases", {})
                # the child's wall that no phase of its report holds
                startup.append(wall - sum(v["wall_s"] for v in own.values()))
                for k, v in own.items():
                    phases[k] = {"wall_s": phases.get(k, {}).get("wall_s", 0.0) + v["wall_s"]}
                for k, v in report.get("metrics", {}).get("counters", {}).items():
                    counters[k] = counters.get(k, 0) + v["value"]
                peaks += [d["peak_bytes_in_use"] for d in report.get("devices", []) if "peak_bytes_in_use" in d]
            if time.perf_counter() - t0 < run.seconds:
                running.append(_start(run, st, i, ch["slot"], traced=False))
                i += 1
    end = time.perf_counter()
    good = len(st["done"])
    run.metrics["cli_wu_per_hour"] = good * 3600.0 / (end - t0) if good else 0.0
    run.obs.update(startup_s=startup, phases=phases, workunits=len(startup), counters=counters,
                   children_s=sum(walls), loop_s=end - t0)
    if peaks:
        run.obs["window_peak_bytes"] = max(peaks)
    print(f"cli_shared: {good} workunits in {end - t0:.3f} s, {len(slots)} at once", file=sys.stderr)
    if run.traced:
        # one more round after the window, its first child under the profiler
        running = [_start(run, st, i + k, slot, traced=k == 0) for k, slot in enumerate(slots)]
        while running:
            _reap(run, st, running)
        path = os.path.join(run.dir, "trace.json")
        if os.path.exists(path):
            run.obs["trace"] = trace.load(path)


def check(run, st) -> tuple[bool, list]:
    served = harness.load_module("drivers", "served")
    return served.judge_files(run, st["pool"], st["done"])
