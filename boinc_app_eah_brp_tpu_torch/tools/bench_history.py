"""Performance-trajectory table over the round-numbered bench artifacts:
the port's twin of the JAX package's ``tools/bench_history.py``, with two
inputs of the port's own.

The JAX half, unchanged: each growth round of the JAX package left a
``BENCH_r<N>.json`` (``bench.py``'s driver record); this tool folds them
into one trajectory table with per-metric regression flags, beside run
reports (``--reports``) and the cached fleet, serving, step-latency and
precision rows under ``--dir`` (``.erp_cache/``) against their committed
baselines.  Its table and ``--json`` are the JAX tool's.

The port's half:

* ``--bench-lines FILE ...``: the one-line payloads of the port's bench
  (``tools/bench.py``, one JSON object a line), in file order;
* ``--step-reports FILE ...``: ``erp-step-report/1`` documents
  (``tools/step_report.py``).

A metric regresses when it moves more than ``--threshold`` (default 10%)
in its bad direction versus the most recent PRIOR row on the SAME
backend.  Backends never meet: a TPU or CPU round is never compared with
a card's line, and the port's rows stand in tables of their own, one per
backend (``cuda:<card name>`` for a card's bench line, the step report's
``backend``), never beside the JAX rounds.

Usage (``T=boinc_app_eah_brp_tpu_torch.tools``):
    python -m $T.bench_history                         # BENCH_r*.json in the repo
    python -m $T.bench_history --dir DIR --reports RUN.report.json
    python -m $T.bench_history --bench-lines bench.jsonl --step-reports step.json
    python -m $T.bench_history --json out.json --strict   # exit 1 on regression

Host code: imports no torch.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from ..runtime.artifacts import round_key
from .metrics_report import load_report

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# metric -> (label, higher_is_better)
METRICS = {
    "value": ("templates/s", True),
    "candidates_per_hr": ("cand/hr", True),
    "mfu": ("mfu", True),
    "whitening_s": ("whiten s", False),
    "compile_first_batch_s": ("compile s", False),
    # the compiler's own throughput ceiling (runtime/roofline.py from the
    # newest COST_LEDGER row): falls when fusion/layout work cuts HBM
    # traffic, so a drop here flags a ledger regression even when the
    # measured t/s is backend-noisy
    "compiler_bound_templates_per_sec": ("bound t/s", True),
}


def load_bench(path: str) -> dict:
    """One trajectory row from a BENCH_r*.json driver record."""
    row = {
        "artifact": os.path.basename(path),
        "round": round_key(path)[0],
        "rc": None,
        "backend": None,
        "metrics": {},
    }
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        row["error"] = f"unreadable: {e}"
        return row
    row["rc"] = doc.get("rc")
    parsed = doc.get("parsed")
    if not isinstance(parsed, dict):
        # bench died before its one-JSON-line output (rc!=0 or harness
        # failure); the row still shows up so the gap is visible
        row["error"] = "no parsed bench record"
        return row
    row["backend"] = parsed.get("backend")
    for key in METRICS:
        v = parsed.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            row["metrics"][key] = float(v)
    return row


# the port's bench line and step report: metric -> (label, higher_is_better)
LINE_METRICS = {
    "value": ("templates/s", True),
    "fraction_of_attainable": ("of roofline", True),
    "whitening_s": ("whiten s", False),
    "compile_first_batch_s": ("compile s", False),
}
STEP_METRICS = {
    "templates_per_sec": ("templates/s", True),
    "p50_step_ms": ("p50 ms", False),
    "p95_step_ms": ("p95 ms", False),
}


def _numeric(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def load_bench_lines(path: str) -> list[dict]:
    """One row per bench payload line of ``path`` (the port's
    ``tools/bench.py`` output), backend ``cuda:<card>`` on a card; a file
    with no readable line gives one row with its error."""
    base = os.path.basename(path)
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        return [{"artifact": base, "backend": None, "metrics": {}, "error": f"unreadable: {e}"}]
    rows = []
    for n, line in enumerate(text.splitlines(), start=1):
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if not isinstance(doc, dict) or "value" not in doc or "backend" not in doc:
            continue
        backend = doc.get("backend")
        if doc.get("card"):
            backend = f"{backend}:{doc['card']}"
        row = {"artifact": f"{base}:{n}", "backend": backend, "batch": doc.get("batch"),
               "power_limit": doc.get("power_limit"), "metrics": {}}
        if doc.get("error"):
            row["error"] = str(doc["error"])[:80]
        for key in LINE_METRICS:
            if _numeric(doc.get(key)):
                row["metrics"][key] = float(doc[key])
        rows.append(row)
    if not rows:
        rows.append({"artifact": base, "backend": None, "metrics": {}, "error": "no bench line"})
    return rows


def load_step_report_row(path: str) -> dict:
    """A row from an ``erp-step-report/1`` document: its backend, lane
    and measured step."""
    from ..runtime.steptime import REPORT_SCHEMA, validate_step_report

    row = {"artifact": os.path.basename(path), "backend": None, "metrics": {}}
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        row["error"] = f"unreadable: {e}"
        return row
    errs = validate_step_report(doc)
    if errs:
        row["error"] = f"not a valid {REPORT_SCHEMA}: {errs[0]}"
        return row
    m = doc["measured"]
    row["backend"] = doc["backend"]
    row["device_lane"] = doc["device_lane"]
    row["windows"] = m["windows"]
    row["metrics"] = {
        "templates_per_sec": float(m["templates_per_sec"]),
        "p50_step_ms": float(m["step_ms"]["p50"]),
        "p95_step_ms": float(m["step_ms"]["p95"]),
    }
    return row


def load_report_row(path: str) -> dict:
    """A trajectory row from a metrics run report (wall + key counters)."""
    row = {"artifact": os.path.basename(path), "metrics": {}}
    try:
        report, _ = load_report(path)
    except OSError as e:
        row["error"] = f"unreadable: {e}"
        return row
    if report is None:
        row["error"] = "no run report found"
        return row
    row["exit_status"] = report.get("exit_status")
    if isinstance(report.get("wall_s"), (int, float)):
        row["metrics"]["wall_s"] = float(report["wall_s"])
    m = report.get("metrics") or {}
    for name, c in (m.get("counters") or {}).items():
        if name in ("checkpoint.count", "health.violations"):
            row["metrics"][name] = c.get("value")
    return row


def load_fleet_row(dirpath: str) -> dict | None:
    """Re-issue overhead of the cached fleet rollup versus the committed
    baseline, or None when either file is absent (fabric soak not run /
    no baseline committed yet — the bench gate then stands alone)."""
    fleet_path = os.path.join(dirpath, ".erp_cache", "fleet_report_ci.json")
    base_path = os.path.join(dirpath, "FLEET_BASELINE.json")
    if not (os.path.exists(fleet_path) and os.path.exists(base_path)):
        return None
    row = {"artifact": os.path.basename(fleet_path), "flags": {}}
    try:
        with open(fleet_path) as f:
            fleet = json.load(f)
        with open(base_path) as f:
            base = json.load(f)
    except (OSError, ValueError) as e:
        row["error"] = f"unreadable: {e}"
        return row
    ratio = (fleet.get("reissue_overhead") or {}).get("ratio")
    ratio_max = (base.get("reissue_overhead") or {}).get("ratio_max")
    row["ratio"] = ratio
    row["ratio_max"] = ratio_max
    if ratio_max is not None and (ratio is None or ratio > ratio_max):
        row["flags"]["reissue_overhead"] = (
            f"ratio {ratio} exceeds baseline {ratio_max}"
        )
    return row


def load_serving_row(dirpath: str) -> dict | None:
    """Serving-tier scoreboard versus the committed floors, or None when
    either file is absent (fleet bench not run / no baseline committed).
    Same gate ``tools/fleet_bench.py --check`` applies inline."""
    bench_path = os.path.join(dirpath, ".erp_cache", "fleet_bench_ci.json")
    base_path = os.path.join(dirpath, "FLEET_SERVING_BASELINE.json")
    if not (os.path.exists(bench_path) and os.path.exists(base_path)):
        return None
    row = {"artifact": os.path.basename(bench_path), "flags": {}}
    try:
        with open(bench_path) as f:
            stats = (json.load(f) or {}).get("stats") or {}
        with open(base_path) as f:
            base = json.load(f)
    except (OSError, ValueError) as e:
        row["error"] = f"unreadable: {e}"
        return row
    row["wus_per_hour_per_chip"] = stats.get("wus_per_hour_per_chip")
    row["recompiles_after_warmup"] = stats.get("recompiles_after_warmup")
    row["p95_inter_wu_gap_s"] = stats.get("p95_inter_wu_gap_s")
    floor = base.get("wus_per_hour_per_chip_min")
    v = row["wus_per_hour_per_chip"]
    if floor is not None and (v is None or v < floor):
        row["flags"]["wus_per_hour_per_chip"] = (
            f"{v} below baseline floor {floor}"
        )
    rmax = base.get("recompiles_after_warmup_max")
    v = row["recompiles_after_warmup"]
    if rmax is not None and (v is None or v > rmax):
        row["flags"]["recompiles_after_warmup"] = (
            f"{v} exceeds baseline {rmax}"
        )
    gmax = base.get("p95_inter_wu_gap_s_max")
    v = row["p95_inter_wu_gap_s"]
    if gmax is not None and (v is None or v > gmax):
        row["flags"]["p95_inter_wu_gap_s"] = f"{v} exceeds baseline {gmax}"
    # durability counters: recorded on every row so the trajectory shows
    # replay/shed churn, but tolerated — they only flag when the
    # baseline commits an explicit ceiling (a CI fleet-bench run sheds
    # and resumes nothing; the chaos soak owns the non-zero cases)
    for key, bound in (("resumed_wus", "resumed_wus_max"),
                       ("shed_total", "shed_total_max")):
        v = stats.get(key)
        row[key] = v
        vmax = base.get(bound)
        if vmax is not None and (v is None or v > vmax):
            row["flags"][key] = f"{v} exceeds baseline {vmax}"
    return row


def load_steptime_row(dirpath: str) -> dict | None:
    """Measured step-latency percentiles from the fleet-bench scoreboard
    versus the committed STEPTIME_BASELINE.json ceilings, or None when
    either file is absent or carries no measured windows.  Same-backend
    regression flags only, like the serving row: the chip-free baseline
    never judges a TPU run."""
    bench_path = os.path.join(dirpath, ".erp_cache", "fleet_bench_ci.json")
    base_path = os.path.join(dirpath, "STEPTIME_BASELINE.json")
    if not (os.path.exists(bench_path) and os.path.exists(base_path)):
        return None
    row = {"artifact": os.path.basename(bench_path), "flags": {}}
    try:
        with open(bench_path) as f:
            bench = json.load(f) or {}
        with open(base_path) as f:
            base = json.load(f)
    except (OSError, ValueError) as e:
        row["error"] = f"unreadable: {e}"
        return row
    latency = bench.get("step_latency") or {}
    block = latency.get("step_ms") or {}
    row["backend"] = bench.get("backend")
    row["windows"] = latency.get("windows")
    row["p50_step_ms"] = block.get("p50")
    row["p95_step_ms"] = block.get("p95")
    if not row["windows"]:
        return None  # bench ran with --no-steptime: nothing to gate
    if base.get("backend") != row["backend"]:
        row["skipped"] = (
            f"baseline backend {base.get('backend')!r} != "
            f"{row['backend']!r}"
        )
        return row
    p50_max = base.get("p50_step_ms_max")
    v = row["p50_step_ms"]
    if p50_max is not None and (v is None or v > p50_max):
        row["flags"]["p50_step_ms"] = f"{v} over baseline ceiling {p50_max}"
    p95_max = base.get("p95_step_ms_max")
    v = row["p95_step_ms"]
    if p95_max is not None and (v is None or v > p95_max):
        row["flags"]["p95_step_ms"] = f"{v} over baseline ceiling {p95_max}"
    return row


def load_precision_row(dirpath: str) -> dict | None:
    """Precision-observatory summary (candidate recall + worst-stage
    error, tools/precision_audit.py) versus the committed
    PRECISION_BASELINE.json, or None when either file is absent.  The
    full gate (``runtime/precision.py::evaluate_baseline``) runs inline,
    so a recall drop or a stage-error ceiling breach trips --strict like
    a kernel slowdown; same-backend only, like every other row."""
    audit_path = os.path.join(dirpath, ".erp_cache", "precision_audit_ci.json")
    base_path = os.path.join(dirpath, "PRECISION_BASELINE.json")
    if not (os.path.exists(audit_path) and os.path.exists(base_path)):
        return None
    row = {"artifact": os.path.basename(audit_path), "flags": {}}
    try:
        with open(audit_path) as f:
            audit = json.load(f)
        with open(base_path) as f:
            base = json.load(f)
    except (OSError, ValueError) as e:
        row["error"] = f"unreadable: {e}"
        return row
    from ..runtime.precision import evaluate_baseline

    lane_name = base.get("lane", "f32") if isinstance(base, dict) else "f32"
    lane = (
        (audit.get("lanes") or {}).get(lane_name)
        if isinstance(audit, dict) else None
    ) or {}
    cand = lane.get("candidates") or {}
    row["lane"] = lane_name
    row["backend"] = audit.get("backend") if isinstance(audit, dict) else None
    row["recall"] = cand.get("recall_at_tol")
    row["jaccard"] = cand.get("jaccard")
    stages = [
        s for s in (lane.get("stages") or [])
        if isinstance(s, dict)
        and isinstance(s.get("max_rel_err"), (int, float))
    ]
    if stages:
        worst = max(stages, key=lambda s: s["max_rel_err"])
        row["worst_stage"] = worst.get("stage")
        row["worst_stage_rel_err"] = worst["max_rel_err"]
    if (
        isinstance(base, dict)
        and base.get("backend")
        and base["backend"] != row["backend"]
    ):
        row["skipped"] = (
            f"baseline backend {base.get('backend')!r} != "
            f"{row['backend']!r}"
        )
        return row
    problems = evaluate_baseline(audit, base)
    if problems:
        row["flags"]["precision"] = "; ".join(problems[:4])
    return row


def flag_regressions(rows: list[dict], threshold: float, metrics: dict = METRICS) -> list[dict]:
    """Per-metric regression flags versus the previous same-backend row.
    Mutates each row with ``flags: {metric: pct_change}`` (bad-direction
    moves beyond the threshold only) and returns the rows."""
    last_by_backend: dict = {}
    for row in rows:
        flags = {}
        prev = last_by_backend.get(row.get("backend"))
        if prev is not None:
            for key, (_, higher_better) in metrics.items():
                a = prev["metrics"].get(key)
                b = row["metrics"].get(key)
                if a is None or b is None or a == 0:
                    continue
                pct = 100.0 * (b - a) / abs(a)
                worse = -pct if higher_better else pct
                if worse > threshold:
                    flags[key] = round(pct, 1)
        row["flags"] = flags
        if row["metrics"] and row.get("backend") is not None:
            last_by_backend[row["backend"]] = row
    return rows


def _table(rows: list[tuple], header: tuple) -> str:
    rows = [tuple(str(c) for c in r) for r in rows]
    widths = [
        max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
        for i, h in enumerate(header)
    ]
    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()
    out = [line(header), line(tuple("-" * w for w in widths))]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


def _cell(row: dict, key: str) -> str:
    v = row["metrics"].get(key)
    if v is None:
        return "-"
    s = f"{v:g}"
    if key in row.get("flags", {}):
        s += f" !{row['flags'][key]:+g}%"
    return s


def render(
    rows: list[dict],
    report_rows: list[dict],
    fleet_row: dict | None = None,
    serving_row: dict | None = None,
    steptime_row: dict | None = None,
    precision_row: dict | None = None,
) -> str:
    out = ["== bench trajectory =="]
    if rows:
        out.append(
            _table(
                [
                    (
                        r["artifact"],
                        r.get("backend") or "-",
                        r.get("rc") if r.get("rc") is not None else "-",
                        *(_cell(r, k) for k in METRICS),
                        r.get("error", ""),
                    )
                    for r in rows
                ],
                ("artifact", "backend", "rc")
                + tuple(label for label, _ in METRICS.values())
                + ("note",),
            )
        )
    else:
        out.append("no BENCH_r*.json artifacts found")
    regressed = [r for r in rows if r.get("flags")]
    if regressed:
        out.append("\nRegressions (vs previous same-backend round):")
        for r in regressed:
            for key, pct in r["flags"].items():
                out.append(
                    f"  {r['artifact']}: {METRICS[key][0]} moved {pct:+g}%"
                )
    if report_rows:
        out.append("\nRun reports:")
        out.append(
            _table(
                [
                    (
                        r["artifact"],
                        r.get("exit_status", "-"),
                        r["metrics"].get("wall_s", "-"),
                        r["metrics"].get("checkpoint.count", "-"),
                        r["metrics"].get("health.violations", "-"),
                        r.get("error", ""),
                    )
                    for r in report_rows
                ],
                ("artifact", "exit", "wall_s", "checkpoints",
                 "health_violations", "note"),
            )
        )
    if fleet_row is not None:
        out.append("\nWork-fabric re-issue overhead (fleet rollup):")
        if fleet_row.get("error"):
            out.append(f"  {fleet_row['artifact']}: {fleet_row['error']}")
        else:
            verdict = "OK"
            if fleet_row.get("flags"):
                verdict = "! " + fleet_row["flags"]["reissue_overhead"]
            out.append(
                f"  {fleet_row['artifact']}: ratio "
                f"{fleet_row.get('ratio')} (baseline max "
                f"{fleet_row.get('ratio_max')}) {verdict}"
            )
    if serving_row is not None:
        out.append("\nFleet serving tier (fleet bench scoreboard):")
        if serving_row.get("error"):
            out.append(f"  {serving_row['artifact']}: {serving_row['error']}")
        else:
            verdict = "OK"
            if serving_row.get("flags"):
                verdict = "! " + "; ".join(serving_row["flags"].values())
            out.append(
                f"  {serving_row['artifact']}: "
                f"{serving_row.get('wus_per_hour_per_chip')} WUs/hour/chip, "
                f"{serving_row.get('recompiles_after_warmup')} recompiles "
                f"after warmup, p95 gap "
                f"{serving_row.get('p95_inter_wu_gap_s')}s, "
                f"resumed {serving_row.get('resumed_wus')}, "
                f"shed {serving_row.get('shed_total')} {verdict}"
            )
    if steptime_row is not None:
        out.append("\nMeasured step latency (fleet bench scoreboard):")
        if steptime_row.get("error"):
            out.append(
                f"  {steptime_row['artifact']}: {steptime_row['error']}"
            )
        elif steptime_row.get("skipped"):
            out.append(
                f"  {steptime_row['artifact']}: gate skipped "
                f"({steptime_row['skipped']})"
            )
        else:
            verdict = "OK"
            if steptime_row.get("flags"):
                verdict = "! " + "; ".join(steptime_row["flags"].values())
            out.append(
                f"  {steptime_row['artifact']}: p50 "
                f"{steptime_row.get('p50_step_ms')} ms / p95 "
                f"{steptime_row.get('p95_step_ms')} ms over "
                f"{steptime_row.get('windows')} windows "
                f"({steptime_row.get('backend')}) {verdict}"
            )
    if precision_row is not None:
        out.append("\nPrecision observatory (stage-error + recall audit):")
        if precision_row.get("error"):
            out.append(
                f"  {precision_row['artifact']}: {precision_row['error']}"
            )
        elif precision_row.get("skipped"):
            out.append(
                f"  {precision_row['artifact']}: gate skipped "
                f"({precision_row['skipped']})"
            )
        else:
            verdict = "OK"
            if precision_row.get("flags"):
                verdict = "! " + "; ".join(precision_row["flags"].values())
            out.append(
                f"  {precision_row['artifact']}: "
                f"{precision_row.get('lane')} lane recall "
                f"{precision_row.get('recall')} / jaccard "
                f"{precision_row.get('jaccard')}, worst stage "
                f"{precision_row.get('worst_stage')} "
                f"(max rel err {precision_row.get('worst_stage_rel_err')}) "
                f"{verdict}"
            )
    return "\n".join(out)


def render_port(line_rows: list[dict], step_rows: list[dict]) -> str:
    """The port's rows: one table per backend, each row flagged against
    the previous row of that backend only."""
    out = []
    for title, rows, metrics, extra in (
        ("Port bench lines (tools/bench.py)", line_rows, LINE_METRICS, ("batch", "power_limit")),
        ("Step reports (tools/step_report.py)", step_rows, STEP_METRICS, ("device_lane", "windows")),
    ):
        if not rows:
            continue
        out.append(f"\n{title}:")
        for backend in dict.fromkeys(r.get("backend") for r in rows):
            group = [r for r in rows if r.get("backend") == backend]
            out.append(f"backend {backend or '-'}:")
            out.append(
                _table(
                    [
                        (r["artifact"], *(r.get(k, "-") for k in extra),
                         *(_cell(r, k) for k in metrics), r.get("error", ""))
                        for r in group
                    ],
                    ("artifact", *extra) + tuple(label for label, _ in metrics.values()) + ("note",),
                )
            )
        for r in rows:
            for key, pct in (r.get("flags") or {}).items():
                out.append(f"  {r['artifact']}: {metrics[key][0]} moved {pct:+g}% (vs the previous {r['backend']} row)")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Aggregate BENCH_r*.json artifacts into a trajectory "
        "table with regression flags."
    )
    ap.add_argument(
        "--dir",
        default=REPO,
        help="directory holding BENCH_r*.json (default: repo root)",
    )
    ap.add_argument(
        "--bench-lines", nargs="*", default=[],
        help="files of the port's bench payload lines (tools/bench.py)",
    )
    ap.add_argument(
        "--step-reports", nargs="*", default=[],
        help="erp-step-report/1 documents (tools/step_report.py)",
    )
    ap.add_argument(
        "--reports", nargs="*", default=[],
        help="metrics run-report JSON / JSONL files to append",
    )
    ap.add_argument(
        "--threshold", type=float, default=10.0,
        help="regression flag threshold in percent (default 10)",
    )
    ap.add_argument("--json", help="also write the rows as JSON to this path")
    ap.add_argument(
        "--strict", action="store_true",
        help="exit 1 when any regression is flagged",
    )
    args = ap.parse_args(argv)

    paths = sorted(
        glob.glob(os.path.join(args.dir, "BENCH_r*.json")), key=round_key
    )
    rows = flag_regressions([load_bench(p) for p in paths], args.threshold)
    report_rows = [load_report_row(p) for p in args.reports]
    fleet_row = load_fleet_row(args.dir)
    serving_row = load_serving_row(args.dir)
    steptime_row = load_steptime_row(args.dir)
    precision_row = load_precision_row(args.dir)
    line_rows = flag_regressions(
        [r for p in args.bench_lines for r in load_bench_lines(p)], args.threshold, LINE_METRICS
    )
    step_rows = flag_regressions(
        [load_step_report_row(p) for p in args.step_reports], args.threshold, STEP_METRICS
    )
    print(
        render(
            rows, report_rows, fleet_row, serving_row, steptime_row,
            precision_row,
        )
    )
    if line_rows or step_rows:
        print(render_port(line_rows, step_rows))

    if args.json:
        with open(args.json, "w") as f:
            json.dump(
                {
                    "rounds": rows,
                    "reports": report_rows,
                    "fleet": fleet_row,
                    "serving": serving_row,
                    "steptime": steptime_row,
                    "precision": precision_row,
                    **({"bench_lines": line_rows} if line_rows else {}),
                    **({"step_reports": step_rows} if step_rows else {}),
                },
                f,
                indent=1,
            )
            f.write("\n")
    if args.strict and any(r.get("flags") for r in rows):
        return 1
    if args.strict and fleet_row is not None and fleet_row.get("flags"):
        return 1
    if args.strict and serving_row is not None and serving_row.get("flags"):
        return 1
    if args.strict and steptime_row is not None and steptime_row.get("flags"):
        return 1
    if args.strict and precision_row is not None and precision_row.get("flags"):
        return 1
    if args.strict and any(r.get("flags") for r in line_rows + step_rows):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
