"""Workunit files through one resident ``serving.FleetServer``, closed
loop.

Set-up writes a pool of distinct workunits (:func:`make_pool`; the seed
orders them) with the bank and the zaplist under the run's directory,
prepares one
session of the class to learn its geometry and the program's batch
choice, and starts a server warmed for that class.  The window keeps
``in_flight`` workunits submitted, so one is always queued behind the
one running and its prep overlaps the search; each completion submits
the next while ``--seconds`` have not passed, and then until the pool's
last pass is whole, so every run does whole passes over the same pool;
the window ends at the last completion.  ``wu_per_hour`` counts the
workunits whose candidate file was written over the time from the first
submit to the last completion.  A traced run profiles from its first completion to its
fourth (the profiler's start stalls the workunit in flight, so the
window covers about two whole ones) and reads the program's phase brackets over the window.  The check
judges a sample of the window's candidate files, drawn from the seed,
against the reference (``bmlib/judge.py::judge_candidates``).
"""

from __future__ import annotations

import gc
import os
import sys
import time

import torch

from bmlib import inputs, judge, reference, trace

IN_PROCESS = True


def make_pool(run) -> tuple[list, list, list]:
    """The pool's workunits, their files, and the order this run sends
    them in.  The pool is the same for every seed (``pool_seed`` of the
    traffic file): a workunit's host work follows the templates its
    candidates rescore, which its data decides, so the seed permutes the
    order and leaves the work alone."""
    tr = run.traffic
    pool = [inputs.make_problem(run.config, tr["pool_seed"], i) for i in range(tr["pool"])]
    paths = [inputs.write_inputs(p, run.dir, f"wu{i}") for i, p in enumerate(pool)]
    order = [int(i) for i in inputs.rng_for(run.seed, 4).permutation(len(pool))]
    return pool, paths, order


def _args(run, paths, i: int, tag: str):
    from boinc_app_eah_brp_tpu_torch.runtime.cli import parse_args

    p = paths[i]
    argv = ["-i", p["wu"], "-o", os.path.join(run.dir, f"{tag}.cand"), "-t", p["bank"], "-l", p["zap"],
            "-c", os.path.join(run.dir, f"{tag}.cpt"), *run.config["argv"]]
    if run.device != "cuda":
        argv += ["--device", run.device]
    args = parse_args(argv)
    if isinstance(args, int):
        raise RuntimeError(f"the command line refused {argv}: exit {args}")
    return args


def setup(run) -> dict:
    from boinc_app_eah_brp_tpu_torch.runtime.scheduler import WarmSpec
    from boinc_app_eah_brp_tpu_torch.runtime.session import Session
    from boinc_app_eah_brp_tpu_torch.serving import FleetServer

    pool, paths, order = make_pool(run)
    probe = Session(_args(run, paths, 0, "probe")).prepare()
    spec = WarmSpec(probe.geom, probe.batch_size)
    probe.release()
    del probe
    server = FleetServer(name="bench", warm_specs=[spec], device=run.device)
    print(f"served: pool of {len(pool)} workunits, batch {spec.batch_size}", file=sys.stderr)
    return dict(pool=pool, paths=paths, order=order, server=server, done=[])


def window(run, st) -> None:
    from boinc_app_eah_brp_tpu_torch.runtime import metrics

    server, paths, order, done = st["server"], st["paths"], st["order"], st["done"]
    if run.traced:
        metrics.configure(force=True)
    prof = None
    inflight = []
    n_sub = 0
    t0 = time.perf_counter()
    end = t0

    def submit():
        nonlocal n_sub
        tag = f"w{n_sub}"
        idx = order[n_sub % len(order)]
        inflight.append((idx, tag, server.submit(_args(run, paths, idx, tag), corr_id=tag)))
        n_sub += 1

    try:
        for _ in range(run.traffic["in_flight"]):
            submit()
        while inflight:
            idx, tag, ticket = inflight.pop(0)
            res = server.result(ticket, timeout=600)
            end = time.perf_counter()
            run.attempted += 1
            out = os.path.join(run.dir, f"{tag}.cand")
            if res.ok and os.path.exists(out):
                done.append((idx, out, end - t0))
            else:
                run.failed += 1
                print(f"served: workunit {idx} failed: {res.code} {res.error}", file=sys.stderr)
            if run.traced and len(done) == 1 and prof is None:
                prof = trace.Capture(os.path.join(run.dir, "trace.json"))
            elif prof is not None and len(done) == 4:
                _stop_profile(prof, run)
                prof = None
            if end - t0 < run.seconds or n_sub % len(order):
                submit()
    finally:
        if prof is not None:
            _stop_profile(prof, run)
        server.close()
    run.metrics["wu_per_hour"] = len(done) * 3600.0 / (end - t0) if done else 0.0
    if run.traced:
        snap = metrics.snapshot()
        run.obs["phases"] = snap.get("phases", {})
        run.obs["workunits"] = run.attempted
        metrics.finish(0)
    print("served: completions at " + ", ".join(f"{t:.3f}" for _, _, t in done) + " s", file=sys.stderr)


def _stop_profile(cap, run) -> None:
    cap.stop()
    run.obs["trace"] = trace.load(cap.path)


def check(run, st) -> tuple[bool, list]:
    pool, done = st["pool"], st["done"]
    st.clear()
    gc.collect()
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    return judge_files(run, pool, done)


def judge_files(run, pool, done) -> tuple[bool, list]:
    """The widest of each number over a sample of the window's candidate
    files (``done``: (pool index, path, completion s)), drawn from the
    seed; a run with a failed workunit, or none, is not correct."""
    tr = run.traffic
    worst = dict(power_gap=0.0, top_gap=0.0)
    if run.failed or not done:
        worst = {k: float("inf") for k in worst}
    else:
        rng = inputs.rng_for(run.seed, 3)
        picked = sorted(rng.choice(len(done), size=min(tr["judge_sample"], len(done)), replace=False))
        ref = reference.Reference(pool[0].geom, run.device)
        for i in picked:
            idx, path, _ = done[i]
            with open(path) as f:
                text = f.read()
            numbers = judge.judge_candidates(text, pool[idx], ref, tr["reference_batch"])
            print(f"judge: workunit {i} (pool {idx}) " + " ".join(f"{k} {v!r}" for k, v in numbers.items()),
                  file=sys.stderr)
            worst = {k: max(worst[k], numbers[k]) for k in worst}
    return judge.verdict(worst, tr["limits"])
