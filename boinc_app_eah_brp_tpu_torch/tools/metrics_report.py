"""Render and diff the structured-metrics artifacts: the port's twin of
the JAX package's ``tools/metrics_report.py``.

A run with ``--metrics-file`` (or ``$ERP_METRICS_FILE``) leaves a JSONL
heartbeat stream and a run-report JSON (``runtime/metrics.py``); this tool
turns either into a human summary table, diffs two run reports, and
schema-checks any artifact.  Rendering or diffing a run report written by
either package gives the JAX tool's text.

Usage (``T=boinc_app_eah_brp_tpu_torch.tools``):
    python -m $T.metrics_report RUN.jsonl            # render stream
    python -m $T.metrics_report RUN.report.json      # render report
    python -m $T.metrics_report --diff OLD.json NEW.json
    python -m $T.metrics_report --check ARTIFACT ...

``--diff`` accepts either form: a JSONL stream is reduced to the
``run_report`` line it carries (the last one, if the file holds several
runs).  ``--check`` is ``tools/report_check.py``'s router, which knows
every schema the port writes.  Host code: imports no torch.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..runtime.metrics import REPORT_SCHEMA
from . import report_check


def load_report(path: str) -> tuple[dict | None, list[dict]]:
    """(run_report-or-None, heartbeat lines) from either artifact form.

    A run-report JSON file yields (report, []).  A JSONL stream yields
    the last ``run_report`` line's report (None when the run died before
    writing one) plus every heartbeat, so a crashed run still renders
    its final heartbeat snapshot.
    """
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None
    if isinstance(doc, dict) and doc.get("schema") == REPORT_SCHEMA:
        return doc, []
    report = None
    heartbeats = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        if not isinstance(rec, dict):
            continue
        if rec.get("kind") == "run_report" and isinstance(
            rec.get("report"), dict
        ):
            report = rec["report"]
        elif rec.get("kind") == "heartbeat":
            heartbeats.append(rec)
    return report, heartbeats


def _fmt(v) -> str:
    if v is None:
        return "n/a"
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float):
        return f"{v:,.3f}".rstrip("0").rstrip(".")
    if isinstance(v, int):
        return f"{v:,}"
    return str(v)


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


def _hist_summary(h: dict) -> str:
    if not h.get("count"):
        return "(empty)"
    mean = h["sum"] / h["count"]
    # coarse p50/p95 from the bucket counts (upper bound of the bucket
    # the quantile lands in; overflow reports the observed max)
    edges = list(h["buckets"]) + [None]
    def quantile(q: float):
        target = q * h["count"]
        acc = 0
        for edge, c in zip(edges, h["counts"]):
            acc += c
            if acc >= target:
                return edge if edge is not None else h["max"]
        return h["max"]
    return (
        f"n={h['count']} mean={_fmt(mean)} p50<={_fmt(quantile(0.5))} "
        f"p95<={_fmt(quantile(0.95))} max={_fmt(h['max'])}"
    )


def render(report: dict | None, heartbeats: list[dict], title: str) -> str:
    out = [f"== {title} =="]
    snap = None
    if report is not None:
        status = report.get("exit_status")
        out.append(
            f"exit_status={status} ok={report.get('ok')} "
            f"wall={_fmt(report.get('wall_s'))} s"
        )
        tracing = report.get("tracing") or {}
        if tracing.get("active"):
            out.append(f"profiler trace: {', '.join(tracing.get('dirs', []))}")
        for d in report.get("devices", []):
            out.append(
                f"device {d.get('device')}: peak "
                f"{_fmt(d.get('peak_bytes_in_use'))} / "
                f"{_fmt(d.get('bytes_limit'))} B"
            )
        snap = report.get("metrics")
    elif heartbeats:
        out.append(
            f"NO RUN REPORT (run still live or died hard); "
            f"showing last of {len(heartbeats)} heartbeats"
        )
        snap = heartbeats[-1].get("metrics")
    if not isinstance(snap, dict):
        out.append("no metrics payload found")
        return "\n".join(out)

    phases = snap.get("phases") or {}
    if phases:
        out.append("\nPhases:")
        out.append(
            _table(
                [
                    (name, _fmt(p.get("wall_s")), p.get("count"))
                    for name, p in phases.items()
                ],
                ("phase", "wall_s", "count"),
            )
        )
    counters = snap.get("counters") or {}
    gauges = snap.get("gauges") or {}
    scalars = [
        (name, c.get("value"), c.get("unit", ""), "counter")
        for name, c in sorted(counters.items())
    ] + [
        (name, g.get("value"), g.get("unit", ""), "gauge")
        for name, g in sorted(gauges.items())
    ]
    if scalars:
        out.append("\nCounters / gauges:")
        out.append(
            _table(
                [(n, _fmt(v), u, k) for n, v, u, k in scalars],
                ("name", "value", "unit", "kind"),
            )
        )
    hists = snap.get("histograms") or {}
    if hists:
        out.append("\nHistograms:")
        out.append(
            _table(
                [
                    (name, h.get("unit", ""), _hist_summary(h))
                    for name, h in sorted(hists.items())
                ],
                ("name", "unit", "summary"),
            )
        )
    return "\n".join(out)


def _flatten_scalars(report: dict) -> dict:
    """name -> numeric value across phases + counters (+ wall) for diffing."""
    out = {"wall_s": report.get("wall_s")}
    m = report.get("metrics") or {}
    for name, p in (m.get("phases") or {}).items():
        out[f"phase:{name}"] = p.get("wall_s")
    for name, c in (m.get("counters") or {}).items():
        out[name] = c.get("value")
    for name, g in (m.get("gauges") or {}).items():
        v = g.get("value")
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[name] = v
    return out


def diff(a: dict, b: dict, a_name: str, b_name: str) -> str:
    fa, fb = _flatten_scalars(a), _flatten_scalars(b)
    rows = []
    for name in sorted(set(fa) | set(fb)):
        va, vb = fa.get(name), fb.get(name)
        if va is None and vb is None:
            continue
        if (
            isinstance(va, (int, float))
            and isinstance(vb, (int, float))
            and va != 0
        ):
            pct = f"{100.0 * (vb - va) / va:+.1f}%"
            delta = _fmt(vb - va)
        else:
            pct = ""
            delta = "" if va == vb else "changed"
        rows.append((name, _fmt(va), _fmt(vb), delta, pct))
    head = [f"== diff: {a_name} -> {b_name} =="]
    head.append(_table(rows, ("metric", "a", "b", "delta", "delta%")))
    return "\n".join(head)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Render, diff or validate erp metrics artifacts."
    )
    ap.add_argument("paths", nargs="+", help="JSONL stream or run-report JSON")
    ap.add_argument(
        "--diff", action="store_true",
        help="diff two run reports (exactly two paths)",
    )
    ap.add_argument(
        "--check", action="store_true",
        help="validate each artifact against its schema; exit 1 on failure",
    )
    args = ap.parse_args(argv)

    if args.diff:
        if len(args.paths) != 2:
            ap.error("--diff needs exactly two paths")
        loaded = []
        for p in args.paths:
            report, _ = load_report(p)
            if report is None:
                print(f"{p}: no run report found", file=sys.stderr)
                return 1
            loaded.append(report)
        print(diff(loaded[0], loaded[1], *args.paths))
        return 0

    if args.check:
        return report_check.main(args.paths)

    for p in args.paths:
        report, heartbeats = load_report(p)
        print(render(report, heartbeats, p))
    return 0


if __name__ == "__main__":
    sys.exit(main())
