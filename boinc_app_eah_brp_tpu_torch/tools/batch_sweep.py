"""Measured batch-size sweep of the port's search loop, on the bench's
production problem.

The port's twin of the repository's ``tools/batch_sweep.py``: the command
line over ``runtime/autobatch.py::sweep``, which times the search loop
(``models/search.py::run_bank`` over the bank) at each rung of a batch
ladder, after one warm-up run a rung, and records templates/s and slots/s
a rung with the allocator's peak.  A rung that fails (out of memory) is
recorded and ends the ladder: a larger batch would fail too.  Each run
ends with ``torch.cuda.synchronize``, which on a CUDA card waits for every
step queued before it.

The problem is ``tools/bench.py``'s (the shipped test workunit when
``$BENCH_TESTWU`` holds it, else the seeded synthetic 2^22-sample
workunit and 6,662-template bank), whitened.  A "step" here is one timed
run of the loop over the bank (``--steps``, the sweep's ``runs``); the
best rung is the one with the most batch slots a second.

The artifact goes where ``autobatch.choose_batch`` reads it
(``autobatch.default_sweep_path()``, or ``--json``), with the sweep's own
keys and those of the JAX tool's artifact: ``backend``,
``best_templates_per_sec``, and ``steps`` and ``wall_s`` (the best run)
a rung.

Usage: python -m boinc_app_eah_brp_tpu_torch.tools.batch_sweep
           [--batches 16,32,64,96,128] [--steps 2] [--json PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BATCHES = "16,32,64,96,128"


def sweep_problem(problem, device: str = "cuda", batches=(16, 32, 64, 96, 128), steps: int = 2,
                  path: str | None = None, log=print) -> dict:
    """Whiten ``problem`` (a ``tools/bench.py::Problem``) on ``device``,
    sweep the ladder and write the artifact to ``path`` (default: where
    the autobatch reads it); returns the artifact."""
    from ..device import resolve_device
    from ..models.search import SearchGeometry, lut_step_for_bank, lut_tiles_for_bank, max_slope_for_bank
    from ..ops.whiten import whiten_and_zap
    from ..runtime import autobatch

    dev = resolve_device(device)
    d = problem.derived
    ts = whiten_and_zap(problem.samples, d, problem.cfg, problem.zap_ranges, device=dev)
    geom = SearchGeometry.from_derived(
        d,
        max_slope=max_slope_for_bank(problem.P, problem.tau),
        lut_step=lut_step_for_bank(problem.P, d.dt),
        lut_tiles=lut_tiles_for_bank(problem.P, problem.psi, d.n_unpadded, d.dt),
    )
    ladder = [b for b in batches if b <= len(problem.P)]
    out = path or autobatch.default_sweep_path()
    art = autobatch.sweep(ts, problem.P, problem.tau, problem.psi, geom, batches=ladder, runs=steps, path=out)
    best = None
    for rung in art["rungs"]:
        if "error" in rung:
            log(f"batch_sweep: batch={rung['batch']} FAILED: {rung['error']}")
            continue
        rung["steps"] = steps
        rung["wall_s"] = min(rung["loop_s"])
        log(f"batch_sweep: batch={rung['batch']} -> {rung['templates_per_sec']:.3f} t/s, "
            f"{rung['slots_per_sec']:.3f} slots/s")
        if rung["batch"] == art["best_batch"]:
            best = rung
    art["backend"] = dev.type
    art["best_templates_per_sec"] = best["templates_per_sec"] if best else None
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(art, f, indent=1)
    os.replace(tmp, out)
    log(f"wrote {out}")
    return art


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default=BATCHES, help="comma-separated batch ladder (ascending)")
    ap.add_argument("--steps", type=int, default=2, help="timed runs of the loop a rung")
    ap.add_argument("--json", default=None, help="artifact path (default: where the autobatch reads it)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from .bench import load_problem

    art = sweep_problem(
        load_problem(), device=args.device, batches=[int(b) for b in args.batches.split(",")],
        steps=args.steps, path=args.json,
    )
    return 0 if art["best_batch"] else 1


if __name__ == "__main__":
    sys.exit(main())
