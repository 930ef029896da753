"""Workunits through the command line, one fresh process each, closed
loop, as the BOINC client runs one task after another on a card.

Set-up writes the served cell's pool of workunits
(``drivers/served.py::make_pool``) under the run's directory and makes
the program build its kernels and its native median into its checkout's
build directory, so that no child compiles inside the window; this
process stays off the card.  The window runs the command line with the
configuration's argv, plus ``--metrics-file`` for the child's run report
(its device peak and phase walls), one child after another while
``--seconds`` have not passed, and ends at the last child's exit.  Each
child is ``drivers/program_main.py``, which runs
``python -m boinc_app_eah_brp_tpu_torch`` in its process and then names
any JAX module it finds loaded there; the harness then prints no result.
``cli_wu_per_hour`` counts the children that exited 0 with a candidate
file, over the time from the first start to the last exit.  A traced run
reads the window's children's reports, then runs one more child under
the profiler.  The check is the served cell's
(``drivers/served.py::judge_files``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from bmlib import harness, inputs, trace

IN_PROCESS = False
MAIN = os.path.join(harness.HERE, "drivers", "program_main.py")
FOUND = harness.load_module("drivers", "program_main").FOUND


def setup(run) -> dict:
    from boinc_app_eah_brp_tpu_torch.ops import kernels, native_median

    pool, paths, order = harness.load_module("drivers", "served").make_pool(run)
    if run.device == "cuda":
        kernels.build()
    native_median.load()
    env = dict(os.environ)
    env["PYTHONPATH"] = harness.ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["ERP_METRICS_INTERVAL"] = "0"
    return dict(pool=pool, paths=paths, order=order, env=env, done=[])


def _argv(run, st, i: int, tag: str, traced: bool) -> list:
    p = st["paths"][i]
    head = [sys.executable, MAIN] + (["--trace", os.path.join(run.dir, "trace.json")] if traced else [])
    argv = head + ["-i", p["wu"], "-o", os.path.join(run.dir, f"{tag}.cand"), "-t", p["bank"], "-l", p["zap"],
                   "-c", os.path.join(run.dir, f"{tag}.cpt"), *run.config["argv"],
                   "--metrics-file", os.path.join(run.dir, f"{tag}.metrics.jsonl")]
    if run.device != "cuda":
        argv += ["--device", run.device]
    return argv


def _child(run, st, i: int, traced: bool) -> tuple[float, dict | None]:
    """The ``i``-th workunit of the run's order as one child process;
    returns its wall on this clock and its run report."""
    tag = f"w{i}"
    idx = st["order"][i % len(st["order"])]
    a = time.perf_counter()
    proc = subprocess.run(_argv(run, st, idx, tag, traced), cwd=run.dir, env=st["env"],
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True, timeout=900)
    wall = time.perf_counter() - a
    run.attempted += 1
    out = os.path.join(run.dir, f"{tag}.cand")
    report = _report(os.path.join(run.dir, f"{tag}.metrics.jsonl.report.json"))
    found = [ln[len(FOUND):] for ln in proc.stderr.splitlines() if ln.startswith(FOUND)]
    if found:
        run.forbidden.extend(found[-1].split(", "))
    if proc.returncode == 0 and os.path.exists(out) and not found:
        st["done"].append((idx, out, wall))
    else:
        run.failed += 1
        print(f"cli: workunit {i} exited {proc.returncode}: {proc.stderr[-2000:]}", file=sys.stderr)
    print(f"cli: workunit {i} exit {proc.returncode} wall {wall:.3f} s"
          + ("" if report is None else f", report {report['wall_s']} s (before it {wall - float(report['wall_s']):.3f}), phases "
             + json.dumps({k: round(v['wall_s'], 3) for k, v in report['metrics'].get('phases', {}).items()})),
          file=sys.stderr)
    if report is not None:
        run.peak_bytes = max([run.peak_bytes] + [d.get("peak_bytes_in_use", 0) for d in report.get("devices", [])])
    return wall, report


def window(run, st) -> None:
    startup, phases, n = [], {}, 0
    i = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        wall, report = _child(run, st, i, traced=False)
        i += 1
        if report is not None:
            own = report.get("metrics", {}).get("phases", {})
            # all of the child's wall that no phase of its report holds:
            # interpreter, imports, CUDA context, library loads, plans, writes
            startup.append(wall - sum(v["wall_s"] for v in own.values()))
            for k, v in own.items():
                phases[k] = {"wall_s": phases.get(k, {}).get("wall_s", 0.0) + v["wall_s"]}
            n += 1
    end = time.perf_counter()
    good = len(st["done"])
    run.metrics["cli_wu_per_hour"] = good * 3600.0 / (end - t0) if good else 0.0
    if run.traced:
        # one more child under the profiler, after the window
        _child(run, st, i, traced=True)
        run.obs.update(startup_s=startup, phases=phases, workunits=n)
        path = os.path.join(run.dir, "trace.json")
        if os.path.exists(path):
            run.obs["trace"] = trace.load(path)
    print(f"cli: {good} workunits in {end - t0:.3f} s", file=sys.stderr)


def _report(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def check(run, st) -> tuple[bool, list]:
    served = harness.load_module("drivers", "served")
    return served.judge_files(run, st["pool"], st["done"])
