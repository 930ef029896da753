"""The control of a cell's comparison: the reference put in the program's
place and computed in bfloat16, the precision below the configuration's
float32, and held by the same check as the program.  Its numbers have to
fail the cell's limits; each limit lies between the program's readings
(from the benchmark's own runs, their ``checks``) and these.

    python3 benchmark/control.py --workload palfa6662.search --seeds 1 2 3 [--device cuda]

prints one JSON line per seed: the control's numbers, each beside its
limit, and whether the check passed them (it must not).  The benchmark's
runs never run this; ``tests/test_bm_control.py`` runs it at a small
size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bmlib import harness, inputs, judge, reference  # noqa: E402


def control_numbers(config: dict, traffic: dict, seed: int, device: str) -> dict:
    """The control's numbers for one seed: the bank-pass cell's state of
    the whole bank, or the workunit cells' candidate files of the first
    ``judge_sample`` workunits of the pool in the seed's order, judged by
    the float32 reference."""
    ctrl_geom = inputs.geometry(config)
    batch = traffic["reference_batch"]
    if traffic["driver"] == "bank_passes":
        p = inputs.make_problem(config, seed)
        ctrl = reference.Reference(ctrl_geom, device, lowp=True)
        ts = ctrl.whiten(p.samples, p.zap_ranges, config["search"]["padding"])
        params = reference.template_params(p.P, p.tau, p.psi, ctrl_geom.dt)
        M, T = ctrl.search(ts, params, range(len(p.P)), batch)
        del ctrl, ts
        M, T = M.cpu().numpy(), T.cpu().numpy()
        ref = reference.Reference(ctrl_geom, device)
        rows = judge.sample_rows(len(p.P), traffic["reference_templates"], inputs.rng_for(seed, 2), must=(0, p.inject))
        return judge.judge_maxima(M, T, p, ref, rows, batch)
    worst: dict = {}
    ctrl = reference.Reference(ctrl_geom, device, lowp=True)
    ref = reference.Reference(ctrl_geom, device)
    order = inputs.rng_for(seed, 4).permutation(traffic["pool"])
    for i in order[: traffic["judge_sample"]]:
        p = inputs.make_problem(config, traffic["pool_seed"], int(i))
        text = judge.reference_candidates(ctrl, p, batch)
        numbers = judge.judge_candidates(text, p, ref, batch)
        worst = {k: max(worst.get(k, 0.0), v) for k, v in numbers.items()}
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.Cell(harness.load_json(harness.ROOT, "BENCHMARK.json"), args.workload)
    for seed in args.seeds:
        numbers = control_numbers(cell.config, cell.traffic, seed, args.device)
        ok, rows = judge.verdict(numbers, cell.traffic["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed, "passed": ok,
                          "numbers": {n: {"value": v, "limit": lim} for n, v, lim in rows}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
