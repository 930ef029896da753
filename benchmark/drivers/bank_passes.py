"""Whole passes of the bank over one whitened workunit, closed loop.

Set-up makes the workunit from the seed, whitens it with the program's
whitening, takes the program's batch choice (``runtime/autobatch.py``)
and runs one whole pass, which builds the kernels and plans cuFFT for
every shape the window uses.  The window calls the program's
``models/search.py::run_bank`` over the whole bank again and again, each
pass from a zeroed state, until ``--seconds`` have passed at the end of
a pass; ``templates_per_s`` is the templates of all passes over the time
from the first dispatch to the synchronise that ends the last.  A traced
run profiles its second pass.  The check compares every pass's (M, T)
with the first's, and the first with the reference on a sample of
templates drawn from the seed (``bmlib/judge.py::judge_state``).
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time

import torch

from bmlib import inputs, judge, reference, trace

IN_PROCESS = True


def _sync(run) -> None:
    if torch.device(run.device).type == "cuda":
        torch.cuda.synchronize()


def setup(run) -> dict:
    from boinc_app_eah_brp_tpu_torch.models.search import (
        SearchGeometry, lut_step_for_bank, lut_tiles_for_bank, max_slope_for_bank, run_bank,
    )
    from boinc_app_eah_brp_tpu_torch.oracle.pipeline import DerivedParams, SearchConfig
    from boinc_app_eah_brp_tpu_torch.ops.whiten import whiten_and_zap
    from boinc_app_eah_brp_tpu_torch.runtime.autobatch import choose_batch

    p = inputs.make_problem(run.config, run.seed)
    s = run.config["search"]
    cfg = SearchConfig(f0=s["f0"], padding=s["padding"], fA=s["fA"], window=s["window"], white=s["white"])
    derived = DerivedParams.derive(len(p.samples), run.config["tsample_us"], cfg)
    geom = SearchGeometry.from_derived(
        derived,
        max_slope=max_slope_for_bank(p.P, p.tau),
        lut_step=lut_step_for_bank(p.P, derived.dt),
        lut_tiles=lut_tiles_for_bank(p.P, p.psi, derived.n_unpadded, derived.dt),
        exact_mean=not cfg.white,
    )
    dev = torch.device(run.device)
    ts = whiten_and_zap(p.samples, derived, cfg, p.zap_ranges, device=dev)
    batch = choose_batch(geom.nsamples, device=dev)
    st = dict(problem=p, ts=ts, geom=geom, batch=batch, run_bank=run_bank, states=[])
    _pass(st)
    _sync(run)
    print(f"bank_passes: {len(p.P)} templates a pass, batch {batch}", file=sys.stderr)
    return st


def _pass(st):
    p = st["problem"]
    return st["run_bank"](st["ts"], p.P, p.tau, p.psi, st["geom"], batch_size=st["batch"])


def window(run, st) -> None:
    p = st["problem"]
    cuda = torch.device(run.device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    states = st["states"]
    t0 = time.perf_counter()
    end = t0
    while end - t0 < run.seconds:
        run.attempted += 1
        try:
            if run.traced and len(states) == 1:
                path = os.path.join(run.dir, "trace.json")
                state = trace.capture(lambda: _pass(st), path)
                run.obs["trace_path"] = path
            else:
                state = _pass(st)
            _sync(run)
        except Exception as e:  # noqa: BLE001 - a failed pass is counted and ends the window
            run.failed += 1
            print(f"bank_passes: pass {run.attempted} failed: {e!r}", file=sys.stderr)
            break
        end = time.perf_counter()
        states.append(state)
    n = len(p.P)
    run.metrics["templates_per_s"] = len(states) * n / (end - t0) if states else 0.0
    if cuda:
        run.obs["window_peak_bytes"] = torch.cuda.max_memory_allocated()
    if "trace_path" in run.obs:
        run.obs["trace"] = trace.load(run.obs["trace_path"])
        g = p.geom
        run.obs["shapes"] = dict(
            T=n, launches=math.ceil(n / st["batch"]), n_unpadded=g.n_unpadded, nsamples=g.nsamples,
            L=g.nsamples // 2 + 1, fund_hi=g.fund_hi, harm_hi=g.harm_hi,
        )
    print(f"bank_passes: {len(states)} passes in {end - t0:.3f} s", file=sys.stderr)


def check(run, st) -> tuple[bool, list]:
    p = st["problem"]
    states = [(M.cpu().numpy(), T.cpu().numpy()) for M, T in st["states"]]
    st.clear()
    gc.collect()
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    tr = run.traffic
    if run.failed or not states:
        numbers = dict(own_gap=float("inf"), beat_gap=float("inf"))
    else:
        ref = reference.Reference(p.geom, run.device)
        rows = judge.sample_rows(len(p.P), tr["reference_templates"], inputs.rng_for(run.seed, 2), must=(0, p.inject))
        numbers = judge.judge_state(states, p, ref, rows, tr["reference_batch"])
    return judge.verdict(numbers, tr["limits"])
