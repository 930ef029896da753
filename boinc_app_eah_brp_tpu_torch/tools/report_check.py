"""Schema checks of the artifacts the port writes: the ``--check`` half of
the JAX package's ``tools/metrics_report.py``.

Each path is routed by its ``schema`` to the port's own validator:

* ``erp-run-report/1`` — a run report, or a metrics JSONL stream that
  carries one (``runtime/metrics.py``);
* ``erp-blackbox/1`` — a flight-recorder dump (``runtime/flightrec.py``);
* ``erp-incident-log/1`` — the watchdog's incident sidecar
  (``runtime/watchdog.py``);
* ``erp-quorum/1`` — a signed quorum verdict, structure and HMAC
  signature (``fabric/validator.py``);
* ``erp-fleet-report/1`` — a fabric run's rollup (``tools/fleet_report.py``);
* ``erp-precision-audit/1`` and ``erp-precision-baseline/1``
  (``runtime/precision.py``);
* ``erp-trace/1`` JSONL streams and their Chrome exports
  (``runtime/tracing.py``);
* ``erp-steptime/1`` streams (``runtime/steptime.py``) and
  ``erp-step-report/1`` reconciliations (``tools/step_report.py``);
* ``erp-fleet-timeline/1`` merged-timeline sidecars
  (``tools/fleet_timeline.py``);
* ``erp-serving-slo/1`` heartbeat streams (``serving/slo.py``) and
  ``erp-serving-journal/1`` WU journals (``serving/journal.py``).

Usage:
    python -m boinc_app_eah_brp_tpu_torch.tools.report_check PATH [PATH ...]

Exit 0 when every path validates, 1 otherwise.  Host code: imports no
torch.  The JAX router's ``erp-hlo-attrib/1`` and ``erp-cost-ledger/1``
are XLA artifacts with no counterpart here.  ``tools/metrics_report.py
--check`` is this router.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..fabric.validator import QUORUM_SCHEMA, validate_quorum_verdict
from ..runtime import flightrec, metrics, precision, steptime, tracing, watchdog
from ..serving import journal, slo
from .fleet_report import FLEET_SCHEMA, validate_fleet_report
from .fleet_timeline import TIMELINE_SCHEMA, validate_fleet_timeline

# one-document artifacts, by schema
_DOCS = {
    flightrec.SCHEMA: flightrec.validate_dump,
    watchdog.INCIDENT_SCHEMA: watchdog.validate_incident_log,
    QUORUM_SCHEMA: validate_quorum_verdict,
    FLEET_SCHEMA: validate_fleet_report,
    precision.PRECISION_SCHEMA: precision.validate_precision_audit,
    precision.PRECISION_BASELINE_SCHEMA: precision.validate_precision_baseline,
    steptime.REPORT_SCHEMA: steptime.validate_step_report,
}


def _raw_json(path: str):
    """The file parsed as one JSON document, or None (JSONL streams and
    torn files)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _jsonl_dicts(path: str) -> list[dict]:
    """Every parseable JSON-object line of a JSONL file (the torn tail of
    a crashed run is skipped); [] on IO failure."""
    out: list[dict] = []
    try:
        with open(path) as f:
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    rec = json.loads(raw)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


def _run_report(doc, lines: list[dict]) -> dict | None:
    """The run report of a report file, or the last one a metrics stream
    carries."""
    if isinstance(doc, dict) and doc.get("schema") == metrics.REPORT_SCHEMA:
        return doc
    report = None
    for rec in lines:
        if rec.get("kind") == "run_report" and isinstance(rec.get("report"), dict):
            report = rec["report"]
    return report


def check_path(path: str) -> tuple[str, list[str]]:
    """(schema, problems) of one artifact; no problems means it validates."""
    doc = _raw_json(path)
    if isinstance(doc, dict):
        schema = doc.get("schema")
        if schema in _DOCS:
            return schema, _DOCS[schema](doc)
        if schema == TIMELINE_SCHEMA and "traceEvents" not in doc:
            return schema, validate_fleet_timeline(doc)
        if schema == journal.JOURNAL_SCHEMA:
            # a fully compacted journal is one close record
            return schema, journal.validate_journal(path)
        if isinstance(doc.get("traceEvents"), list):
            return "chrome-trace", tracing.validate_chrome(doc)
    # a stream of one line parses as one document too
    lines = _jsonl_dicts(path)
    head = lines[0] if lines else {}
    if head.get("kind") == "start" and head.get("schema") == tracing.TRACE_SCHEMA:
        return tracing.TRACE_SCHEMA, tracing.validate_stream(lines)
    if head.get("kind") == "start" and head.get("schema") == steptime.STEPTIME_SCHEMA:
        return steptime.STEPTIME_SCHEMA, steptime.validate_stream(lines)
    if head.get("schema") == slo.SLO_SCHEMA:
        return slo.SLO_SCHEMA, slo.validate_slo_stream(lines)
    if head.get("schema") == journal.JOURNAL_SCHEMA:
        return journal.JOURNAL_SCHEMA, journal.validate_journal(path)
    report = _run_report(doc, lines)
    if report is None:
        return metrics.REPORT_SCHEMA, ["no run report found"]
    return metrics.REPORT_SCHEMA, metrics.validate_report(report)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Validate the port's artifacts by their schema.")
    ap.add_argument("paths", nargs="+", help="artifact files (JSON documents or JSONL streams)")
    args = ap.parse_args(argv)
    bad = 0
    for p in args.paths:
        schema, errs = check_path(p)
        if errs:
            bad += 1
            print(f"{p}: INVALID ({schema})")
            for e in errs:
                print(f"  - {e}")
        else:
            print(f"{p}: OK ({schema})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
