"""Model-vs-measured step-time reconciliation: ``erp-step-report/1``.

The port's twin of the JAX package's ``tools/step_report.py``:

1. **one measured run**: a workunit runs through one resident
   :class:`~boinc_app_eah_brp_tpu_torch.runtime.scheduler.Scheduler`, a
   warm-up session first (kernel builds, cuFFT plans), then the measured
   session with the ``runtime/steptime.py`` bracket force-armed, leaving
   an ``erp-steptime/1`` stream and per-window records.  The problem is
   an argument (:func:`run`); the command line runs the JAX tool's
   fixture (16 templates, 4096 samples, window 200, batch 2);
2. **the join** (:func:`build_report`): the measured windows against the
   port's own cost model, the H100 roofline (``runtime/roofline.py``):
   modeled per-stage times from ``devicecost.stage_time_model`` and
   per-stage bytes from ``roofline.pipeline_costs``, which take the place
   of the JAX tool's ``COST_LEDGER.json`` (an XLA artifact): the
   ``ledger_*`` fields hold the roofline's bytes and ``modeled.source``
   says so.  On a card the measured session runs inside
   ``steptime.capture_profile`` (``torch.profiler``), each stage's
   measured ms is the capture's, and the document says ``device_lane:
   "measured"``; it lists every kernel of the capture by stage (cuFFT's
   under ``rfft``, those of no stage under ``other``) with its launches
   and time.  A card run whose capture holds no
   device record fails.  On the CPU the measured window is split by the
   model's fractions (``"modeled-split"``), as the JAX tool does off the
   chip;
3. **the gates**: ``--check`` validates documents, ``--diff OLD NEW``
   exits non-zero when the measured step slowed past ``--threshold``, and
   ``--baseline STEPTIME_BASELINE.json`` holds a fresh run to committed
   ceilings; both gates are same-backend only (the backend is ``cpu`` or
   the card's name).

Usage (``T=boinc_app_eah_brp_tpu_torch.tools``):
    python -m $T.step_report [--device cpu]            # fresh run + join
    python -m $T.step_report --device cpu --baseline STEPTIME_BASELINE.json
    python -m $T.step_report --check REPORT.json ...
    python -m $T.step_report --diff OLD.json NEW.json [--threshold 50]

Importing this module loads no torch; a fresh run takes ``--device``
(``cuda`` by default; without a card it raises unless given ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from ..runtime.steptime import BASELINE_SCHEMA, REPORT_SCHEMA, validate_step_report
from . import _inputs

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the JAX tool's fixture: the soak class widened to a 16-template bank so
# one session yields 8 measured windows
N_TEMPLATES = 16
WINDOW = 200
BATCH = 2
F_SIGNAL = 31.0

# the roofline's stage (its scope) -> the capture's stage
# (``devicecost.stage_of_kernel``); the merge launches no kernel of its own
CAPTURE_STAGE = {"resample": "resample", "fftprep": "fftprep", "fft": "rfft", "sumspec": "fold"}
# the symbol of each kernel of ``csrc/`` -> its launch counts in ``ops/kernels.py``
COUNTED = {
    "stream_kernel": ("resample", "resample_t1", "resample_exact", "resample_t1_exact"),
    "fftprep_kernel": ("fftprep",),
    "fold_kernel": ("fold", "fold_spectrum"),
    "exact_mean_kernel": ("serial_mean", "serial_mean_exact"),
}


def fail(msg: str) -> int:
    print(f"step-report: FAIL: {msg}", file=sys.stderr)
    return 1


def fixture_args(work: str, prefix: str, device: str):
    """The JAX tool's fixture: the fixture class's four-template bank
    tiled to N_TEMPLATES with small period and phase offsets, and a
    4096-sample workunit with its pulse train at 31 Hz, as DriverArgs
    (``prefix`` separates the warm-up session's files from the measured
    one's)."""
    import numpy as np

    from ..io import TemplateBank, write_template_bank
    from ..runtime.driver import DriverArgs

    base = _inputs.small_bank()
    reps = -(-N_TEMPLATES // len(base.P))
    idx = np.arange(N_TEMPLATES)
    P = np.tile(base.P, reps)[:N_TEMPLATES] * (1.0 + 0.003 * idx)
    tau = np.tile(base.tau, reps)[:N_TEMPLATES]
    psi = np.tile(base.psi0, reps)[:N_TEMPLATES] + 0.01 * idx
    bank = os.path.join(work, "bank.dat")
    write_template_bank(bank, TemplateBank(P, tau, psi))
    wu = _inputs.fixture_workunit(os.path.join(work, f"{prefix}.bin4"), f_signal=F_SIGNAL, seed=0)
    return DriverArgs(
        inputfile=wu, outputfile=os.path.join(work, f"{prefix}.cand"), templatebank=bank,
        checkpointfile=os.path.join(work, f"{prefix}.cpt"), window=WINDOW, batch_size=BATCH, device=device,
    )


def measure(warm_args, args, work: str):
    """One measured run: ``warm_args`` pays the builds and plans, then
    ``args`` runs with the bracket force-armed, inside
    ``steptime.capture_profile`` on a card, without its rescoring (whose
    resample runs kernel A and the exact mean on the card after the
    loop: the capture holds the step's launches alone).  Returns
    (steptime summary, the capture or None, geometry, backend, the
    capture's launches against the wrappers' counts or None)."""
    import dataclasses

    from ..ops import kernels
    from ..runtime import steptime
    from ..runtime.scheduler import Scheduler
    from .fleet_bench import warm_spec_for

    os.environ.setdefault("ERP_RESULT_DATE", _inputs.RESULT_DATE)
    device = _inputs.require_device(args.device)
    on_card = device.startswith("cuda")
    geom = warm_spec_for(args).geom
    cap = launches = None
    sched = Scheduler(device=device)
    try:
        # the bracket arms (re-arming resets the ring) only for the
        # second session: the measured windows are the steady state
        res = sched.process(warm_args)
        if not res.ok:
            raise RuntimeError(f"warm-up session exited {res.code}: {res.error}")
        steptime.configure(steptime_file=os.path.join(work, "steptime.jsonl"), force=True)
        before = dict(kernels.launch_counts)
        args = dataclasses.replace(args, rescore=False)
        if on_card:
            with steptime.capture_profile(os.path.join(work, "profile")) as cap:
                res = sched.process(args)
        else:
            res = sched.process(args)
        counted = {k: kernels.launch_counts[k] - before[k] for k in before}
    finally:
        sched.close()
    if not res.ok:
        raise RuntimeError(f"measurement session exited {res.code}: {res.error}")
    summary = steptime.summary()
    steptime.finish(0)
    if summary["windows"] == 0:
        raise RuntimeError("bracket armed but no step windows recorded")
    if on_card:
        if not cap.records or not cap.stage_ms:
            raise RuntimeError(f"the card's capture holds no device records ({cap.warning})")
        # the capture against the wrappers' counts: on the card a capture
        # has held 6 of a session's 7 windows (A, B, C and cuFFT's kernels
        # alike, and not its exact mean), so the per-window times divide
        # by the windows it holds, B's share of the counted launches; the
        # loop's kernels must agree on that share (the exact mean runs
        # once, ahead of the loop)
        launches = {
            sym: {"counted": sum(counted[n] for n in names), "captured": sum(sym in r["name"] for r in cap.records)}
            for sym, names in COUNTED.items()
        }
        b = launches["fftprep_kernel"]
        share = b["captured"] / b["counted"] if b["counted"] else 0.0
        if not 0.0 < share <= 1.0 or any(
            c["captured"] != round(c["counted"] * share)
            for sym, c in launches.items() if sym != "exact_mean_kernel"
        ):
            raise RuntimeError(f"the capture holds an inconsistent share of the launches counted: {launches}")
        launches["windows_captured"] = round(summary["windows"] * share, 6)
        import torch

        backend = torch.cuda.get_device_name(sched.device)
    else:
        backend = "cpu"
    return summary, cap, geom, backend, launches


def _kernel_table(cap, windows: float) -> list[dict]:
    """Every kernel, copy and memset in the capture, by stage (``other``
    for those of no stage: the merge, copies): launches and ms, in total
    and a window."""
    from ..runtime.devicecost import stage_of_kernel

    rows: dict = {}
    for r in cap.records:
        key = (stage_of_kernel(r["name"]) or "other", r["name"])
        row = rows.setdefault(key, {"stage": key[0], "name": key[1], "launches": 0, "ms": 0.0})
        row["launches"] += 1
        row["ms"] += r["dur_us"] / 1e3
    out = sorted(rows.values(), key=lambda r: (r["stage"], -r["ms"]))
    for r in out:
        r["ms"] = round(r["ms"], 4)
        r["launches_per_window"] = round(r["launches"] / windows, 3)
        r["ms_per_window"] = round(r["ms"] / windows, 4)
    return out


def build_report(summary: dict, geom, backend: str, card: str, batch: int, templates: int, cap=None,
                 launches: dict | None = None) -> dict:
    """Join the measured windows against the roofline's stage model and
    bytes into one ``erp-step-report/1`` document; ``cap`` (a
    ``steptime.ProfileCapture``) gives the measured lane, ``launches``
    its kernels' launches against the wrappers' counts."""
    from ..runtime.devicecost import STAGES, stage_time_model
    from ..runtime.roofline import pipeline_costs

    model = stage_time_model(geom.nsamples, geom.n_unpadded, geom.fund_hi, geom.harm_hi, batch, card=card)
    stage_bytes = {
        c.scope: c.bytes for c in pipeline_costs(geom.nsamples, geom.n_unpadded, geom.fund_hi, geom.harm_hi, batch)
    }
    gb_per_template = sum(stage_bytes.values()) / batch / 1e9

    windows = summary["windows"]
    tpw = summary["templates"] / windows if windows else 0.0  # templates per window
    mean_window_ms = summary["step_ms"]["mean"]
    measured_tps = summary["templates_per_sec"]
    model_ms_per_template = sum(r["t_ms"] for r in model) / batch
    modeled_tps = round(1e3 / model_ms_per_template, 3) if model_ms_per_template > 0 else 0.0

    measured_lane = cap is not None
    # the windows the capture holds (``measure``: launches["windows_captured"])
    cap_windows = (launches or {}).get("windows_captured", windows)
    stages = []
    for row in model:
        modeled_ms = row["t_ms"] / batch * tpw
        if measured_lane:
            # per-window share of the profiler's per-stage totals
            measured_ms = cap.stage_ms.get(CAPTURE_STAGE.get(row["scope"]), 0.0) / cap_windows
        else:
            measured_ms = mean_window_ms * row["fraction"]
        gb = stage_bytes[row["scope"]] / batch / 1e9
        stages.append(
            {
                "stage": row["stage"],
                "scope": row["scope"],
                "bound": row["bound"],
                "modeled_fraction": round(row["fraction"], 4),
                "modeled_ms_per_window": round(modeled_ms, 4),
                "measured_ms_per_window": round(measured_ms, 4),
                "discrepancy": round(measured_ms / modeled_ms, 2) if modeled_ms > 0 else 0.0,
                "ledger_bucket": STAGES[row["scope"]],
                "ledger_gb_per_template": round(gb, 6),
                "measured_gb_per_sec": round(gb * tpw / (measured_ms / 1e3), 3) if measured_ms > 0 else None,
            }
        )
    stages.sort(key=lambda s: s["discrepancy"], reverse=True)

    def _gbs(tps):
        return round(gb_per_template * tps, 3) if tps else None

    doc = {
        "schema": REPORT_SCHEMA,
        "generated_unix": time.time(),
        "backend": backend,
        "chip_model": card,
        "geometry": {"nsamples": geom.nsamples, "n_unpadded": geom.n_unpadded, "batch": batch, "templates": templates},
        "measured": {
            "windows": windows,
            "templates": summary["templates"],
            "templates_per_sec": measured_tps,
            "gb_per_sec": _gbs(measured_tps),
            "step_ms": summary["step_ms"],
        },
        "modeled": {
            "templates_per_sec": modeled_tps,
            "ms_per_template": round(model_ms_per_template, 4),
            "gb_per_sec": _gbs(modeled_tps),
            "gb_per_template": round(gb_per_template, 6),
            "source": f"runtime/roofline.py pipeline_costs (bytes) + stage_time_model({card})",
        },
        "ratio_measured_to_modeled": round(modeled_tps / measured_tps, 2)
        if measured_tps > 0 and modeled_tps > 0 else None,
        "device_lane": "measured" if measured_lane else "modeled-split",
        "stages": stages,
    }
    if measured_lane:
        doc["device"] = {
            "stage_ms": cap.stage_ms,
            "other_ms_per_window": round(
                sum(r["dur_us"] for r in cap.records) / 1e3 / cap_windows
                - sum(cap.stage_ms.values()) / cap_windows, 4
            ),
            "idle_share": cap.idle.get("idle_share"),
            "launches": launches,
            "kernels": _kernel_table(cap, cap_windows),
            "trace": os.path.join(cap.logdir, "trace.json"),
        }
    return doc


def run(warm_args, args, work: str, card: str | None = None) -> dict:
    """Measure ``args`` (after ``warm_args``) and join: the document.
    Raises RuntimeError when the run or its capture fails."""
    summary, cap, geom, backend, launches = measure(warm_args, args, work)
    from ..io import read_template_bank
    from ..runtime.roofline import card_name

    card = card or card_name()
    templates = len(read_template_bank(args.templatebank).P)
    return build_report(summary, geom, backend, card, args.batch_size, templates, cap, launches)


def render(doc: dict) -> str:
    m, mo = doc["measured"], doc["modeled"]
    out = [
        f"== step report ({doc['backend']} measured vs "
        f"{doc['chip_model']} model, {doc['device_lane']}) ==",
        f"measured: {m['templates_per_sec']} t/s over {m['windows']} "
        f"windows (p50 {m['step_ms']['p50']} ms, p95 {m['step_ms']['p95']} "
        f"ms)",
        f"modeled:  {mo['templates_per_sec']} t/s "
        f"({mo['ms_per_template']} ms/template roofline; "
        f"{mo['gb_per_sec']} GB/s at roofline bytes)",
        f"model-over-measured: x{doc['ratio_measured_to_modeled']}",
        "",
        f"{'stage':<18} {'bound':<5} {'model ms/win':>12} "
        f"{'meas ms/win':>12} {'disc':>8} {'GB/s':>9}",
    ]
    for s in doc["stages"]:
        out.append(
            f"{s['stage']:<18} {s['bound']:<5} "
            f"{s['modeled_ms_per_window']:>12} "
            f"{s['measured_ms_per_window']:>12} "
            f"{'x' + str(s['discrepancy']):>8} {str(s.get('measured_gb_per_sec')):>9}"
        )
    dev = doc.get("device")
    if dev:
        out.append(f"other device work {dev['other_ms_per_window']} ms/win; idle share {dev['idle_share']}; "
                   f"{dev['launches']['windows_captured']} of {m['windows']} windows in the capture")
    return "\n".join(out)


def check_baseline(doc: dict, base_path: str) -> list[str]:
    """Ceiling violations versus STEPTIME_BASELINE.json (empty = green).
    Same-backend only: a CPU baseline says nothing about a card's run."""
    with open(base_path, encoding="utf-8") as f:
        base = json.load(f)
    if base.get("schema") != BASELINE_SCHEMA:
        return [f"{base_path} is not a {BASELINE_SCHEMA} document"]
    if base.get("backend") != doc.get("backend"):
        print(
            f"step-report: baseline backend {base.get('backend')!r} != "
            f"run backend {doc.get('backend')!r}; gate skipped"
        )
        return []
    bad = []
    m = doc["measured"]
    p50_max = base.get("p50_step_ms_max")
    if p50_max is not None and m["step_ms"]["p50"] > p50_max:
        bad.append(f"p50 step {m['step_ms']['p50']} ms over ceiling {p50_max} ms")
    p95_max = base.get("p95_step_ms_max")
    if p95_max is not None and m["step_ms"]["p95"] > p95_max:
        bad.append(f"p95 step {m['step_ms']['p95']} ms over ceiling {p95_max} ms")
    tps_min = base.get("templates_per_sec_min")
    if tps_min is not None and m["templates_per_sec"] < tps_min:
        bad.append(f"{m['templates_per_sec']} templates/s under floor {tps_min}")
    return bad


def diff(old_path: str, new_path: str, threshold_pct: float) -> int:
    """Regression diff: non-zero when NEW's measured step latency (p50)
    grew, or its throughput fell, past the threshold; same backend only."""
    docs = []
    for p in (old_path, new_path):
        try:
            with open(p, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            return fail(f"cannot read {p}: {e}")
        errs = validate_step_report(doc)
        if errs:
            return fail(f"{p}: invalid report: {'; '.join(errs)}")
        docs.append(doc)
    old, new = docs
    if old["backend"] != new["backend"]:
        print(
            f"step-report: diff across backends ({old['backend']} -> "
            f"{new['backend']}); regression gate skipped"
        )
        return 0
    bad = []
    p50_old = old["measured"]["step_ms"]["p50"]
    p50_new = new["measured"]["step_ms"]["p50"]
    if p50_old > 0 and p50_new > p50_old * (1.0 + threshold_pct / 100.0):
        bad.append(
            f"p50 step latency {p50_old} -> {p50_new} ms "
            f"(+{100.0 * (p50_new - p50_old) / p50_old:.1f}% > {threshold_pct}%)"
        )
    tps_old = old["measured"]["templates_per_sec"]
    tps_new = new["measured"]["templates_per_sec"]
    if tps_old > 0 and tps_new < tps_old * (1.0 - threshold_pct / 100.0):
        bad.append(
            f"throughput {tps_old} -> {tps_new} templates/s "
            f"({100.0 * (tps_new - tps_old) / tps_old:.1f}% < -{threshold_pct}%)"
        )
    if bad:
        return fail("measured-step regression: " + "; ".join(bad))
    print(f"step-report: no regression ({p50_old} -> {p50_new} ms p50, threshold {threshold_pct}%)")
    return 0


def write_json(path: str, doc: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Measured-vs-modeled step-time reconciliation.")
    ap.add_argument("--check", nargs="+", metavar="PATH",
                    help="validate existing erp-step-report/1 files and exit (no fresh run)")
    ap.add_argument("--diff", nargs=2, metavar=("OLD", "NEW"),
                    help="exit non-zero when NEW's measured step slowed past --threshold vs OLD (same backend only)")
    ap.add_argument("--threshold", type=float, default=50.0,
                    help="regression threshold for --diff, percent (default 50: step times are noisy)")
    ap.add_argument("--baseline", help="gate the fresh run against this STEPTIME_BASELINE.json (same backend only)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--card", default=None,
                    help="roofline card for the modeled column (default: this run's card, 'cpu' off the card)")
    ap.add_argument("--json", default=os.path.join(REPO, ".erp_cache", "step_report_torch.json"),
                    help="report cache path (empty string disables)")
    ap.add_argument("--workdir", help="reuse this dir instead of a tmp one")
    ap.add_argument("--keep", action="store_true", help="keep the workdir (default: removed when green)")
    args = ap.parse_args(argv)

    if args.check:
        bad = 0
        for p in args.check:
            try:
                with open(p, encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, ValueError) as e:
                print(f"{p}: INVALID\n  - unreadable: {e}")
                bad += 1
                continue
            errs = validate_step_report(doc)
            if errs:
                bad += 1
                print(f"{p}: INVALID")
                for e in errs:
                    print(f"  - {e}")
            else:
                print(f"{p}: OK ({REPORT_SCHEMA})")
        return 1 if bad else 0

    if args.diff:
        return diff(args.diff[0], args.diff[1], args.threshold)

    device = _inputs.require_device(args.device)
    work = args.workdir or tempfile.mkdtemp(prefix="erp-step-report-")
    os.makedirs(work, exist_ok=True)
    print(f"step-report: workdir {work}")
    try:
        doc = run(fixture_args(work, "warm", device), fixture_args(work, "wu", device), work, card=args.card)
    except RuntimeError as e:
        return fail(str(e))
    errs = validate_step_report(doc)
    if errs:  # a malformed fresh report is a bug in this tool
        return fail("self-check failed: " + "; ".join(errs))
    print(render(doc))

    if args.json:
        write_json(args.json, doc)
        print(f"step-report: cached at {args.json}")

    if args.baseline:
        try:
            violations = check_baseline(doc, args.baseline)
        except (OSError, ValueError) as e:
            return fail(f"cannot read baseline {args.baseline}: {e}")
        if violations:
            return fail("baseline violations: " + "; ".join(violations))
        print(f"step-report: within {os.path.basename(args.baseline)} ceilings")

    if not args.keep and not args.workdir:
        shutil.rmtree(work, ignore_errors=True)
    print(
        f"step-report: PASS ({doc['measured']['templates_per_sec']} "
        f"measured t/s vs {doc['modeled']['templates_per_sec']} modeled)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
