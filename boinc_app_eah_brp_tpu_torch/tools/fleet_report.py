"""Fleet rollup: aggregate one fabric run into ``erp-fleet-report/1``.

BOINC's server side wins by *watching its fleet* — per-host error rates,
grant latency, replication overhead — not by trusting any single stream
(the scheduler/validator half of the arXiv 0904.1826 deployment).  This
tool joins the three artifact families one work-fabric run leaves behind

* the exact per-WU lifecycle export (``erp-wu-lifecycle/1``,
  ``fabric/workfabric.py::Fabric.export_lifecycle`` — correlation ids,
  issue→grant stamps, host reputation table),
* the signed quorum verdicts (``erp-quorum/1``, ``fabric/validator.py``
  — every signature is re-verified here, so the rollup's grant counts
  are sourced from artifacts a volunteer host cannot forge),
* optionally the metrics heartbeat stream (``erp-metrics/1``,
  ``runtime/metrics.py`` — fabric counters cross-checked against the
  lifecycle numbers),

into a single ``erp-fleet-report/1`` document: grant-latency and
validation-latency percentiles (p50/p95/p99, exact — computed from the
lifecycle records, not histogram buckets), re-issue overhead
(replicas issued over the ``wus x quorum`` floor), per-adversary
detection counts keyed by reject-reason tag, the host reputation table,
and verdict provenance (count / signature status / key id).  The
document and its checks are the JAX package's ``tools/fleet_report.py``'s,
and ``FLEET_BASELINE.json`` holds the SLO bounds of both.

``--check`` turns the tool into a gate: structural validation of an
existing report, plus — when ``--baseline`` names a committed
``erp-fleet-baseline/1`` file — SLO enforcement: latency percentiles
and re-issue overhead must stay under the baseline bounds, every
granted WU must trace to a signature-verified ``agree`` verdict, and
nothing may be left pending.

Usage:
    python -m boinc_app_eah_brp_tpu_torch.tools.fleet_report \\
        --lifecycle LIFE.json --verdict-dir DIR [--metrics RUN.jsonl] \\
        --out FLEET.json [--baseline FLEET_BASELINE.json]
    python -m boinc_app_eah_brp_tpu_torch.tools.fleet_report \\
        --check FLEET.json [--baseline FLEET_BASELINE.json]

Host code: imports no torch.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

from ..fabric.validator import validate_quorum_verdict
from ..fabric.workfabric import LIFECYCLE_SCHEMA
from ..runtime.percentiles import PCTS as _PCTS
from ..runtime.percentiles import latency_block as _latency_block

FLEET_SCHEMA = "erp-fleet-report/1"
BASELINE_SCHEMA = "erp-fleet-baseline/1"


def _load_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _metrics_counters(path: str) -> dict:
    """Final cumulative counter values from an ``erp-metrics/1`` JSONL
    stream (the last record wins — counters are monotone; the embedded
    run report supersedes any heartbeat)."""
    counters: dict = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("kind") == "heartbeat":
                m = rec.get("metrics") or {}
            elif rec.get("kind") == "run_report":
                m = (rec.get("report") or {}).get("metrics") or {}
            else:
                continue
            counters = m.get("counters") or counters
    return {
        k: (v.get("value") if isinstance(v, dict) else v)
        for k, v in counters.items()
    }


def _metrics_snapshot(path: str) -> dict:
    """Final full metric snapshot (counters + gauges + histograms) from
    an ``erp-metrics/1`` JSONL stream, last record wins."""
    snap: dict = {}
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("kind") == "heartbeat":
                    m = rec.get("metrics") or {}
                elif rec.get("kind") == "run_report":
                    m = (rec.get("report") or {}).get("metrics") or {}
                else:
                    continue
                snap = m or snap
    except OSError:
        return {}
    return snap


def _hist_pct_bound(hist: dict | None, q: float):
    """Upper-bound estimate of the q-quantile from a metrics histogram
    snapshot: the smallest bucket bound covering a q fraction of the
    observations, or the exact observed max for the overflow bucket.
    None when the histogram is absent or empty."""
    if not isinstance(hist, dict):
        return None
    counts = hist.get("counts") or []
    buckets = hist.get("buckets") or []
    total = hist.get("count") or 0
    if not total or len(counts) != len(buckets) + 1:
        return None
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= q * total:
            return buckets[i] if i < len(buckets) else hist.get("max")
    return hist.get("max")


def sentinel_drift_block(metrics_paths: list[str]) -> dict:
    """Per-host ``health.sentinel_*`` drift rollup from metrics streams
    (``runtime/health.py::SentinelProbe``): probe counts, running-max
    relative error, and p50/p95 upper bounds from the
    ``health.sentinel_rel_err`` histogram — so a numerically-sick host
    is visible in the fleet view, not just in its own run report."""
    hosts: dict = {}
    agg_probes = 0
    agg_max = None
    agg_p95 = None
    for path in metrics_paths:
        snap = _metrics_snapshot(path)
        counters = snap.get("counters") or {}
        gauges = snap.get("gauges") or {}
        hists = snap.get("histograms") or {}
        probes = (counters.get("health.sentinel_probes") or {}).get("value")
        probes = int(probes) if isinstance(probes, (int, float)) else 0
        mx = (gauges.get("health.sentinel_max_rel_err") or {}).get("value")
        mx = float(mx) if isinstance(mx, (int, float)) else None
        hist = hists.get("health.sentinel_rel_err")
        entry = {
            "probes": probes,
            "max_rel_err": mx,
            "rel_err_n": (hist or {}).get("count", 0) or 0,
            "rel_err_p50_bound": _hist_pct_bound(hist, 0.50),
            "rel_err_p95_bound": _hist_pct_bound(hist, 0.95),
        }
        hosts[os.path.basename(path)] = entry
        agg_probes += probes
        if mx is not None:
            agg_max = mx if agg_max is None else max(agg_max, mx)
        p95 = entry["rel_err_p95_bound"]
        if p95 is not None:
            agg_p95 = p95 if agg_p95 is None else max(agg_p95, p95)
    return {
        "probes": agg_probes,
        "max_rel_err": agg_max,
        "p95_rel_err_bound": agg_p95,
        "hosts": hosts,
    }


# ---------------------------------------------------------------------------
# build


def build_report(
    lifecycle_path: str,
    verdict_dir: str | None,
    metrics_path: str | None = None,
    host_metrics: list[str] | None = None,
) -> dict:
    life = _load_json(lifecycle_path)
    if life.get("schema") != LIFECYCLE_SCHEMA:
        raise SystemExit(
            f"{lifecycle_path}: schema {life.get('schema')!r}, "
            f"expected {LIFECYCLE_SCHEMA!r}"
        )
    wus = life.get("wus", [])
    summary = life.get("summary", {})
    hosts = life.get("hosts", [])
    quorum = int(life.get("config", {}).get("quorum", 2) or 2)

    granted = [w for w in wus if w.get("state") == "granted"]
    grant_latencies = [
        w["grant_latency_s"]
        for w in granted
        if w.get("grant_latency_s") is not None
    ]
    validation_latencies = [
        w["validation_s"] for w in wus if w.get("validation_s") is not None
    ]

    replicas_issued = sum(int(w.get("replicas", 0)) for w in wus)
    floor = max(1, len(wus) * quorum)
    overhead = {
        "replicas_issued": replicas_issued,
        "floor": floor,
        "ratio": round(replicas_issued / floor, 4),
        "reissues": sum(int(w.get("reissues", 0)) for w in wus),
        "timeouts": sum(int(w.get("timeouts", 0)) for w in wus),
    }

    # adversary detection, from the verdicts (authoritative: a detection
    # IS a rejected replica in a signed verdict) keyed by reason tag
    verdicts = {
        "count": 0,
        "signed_ok": 0,
        "signed_bad": 0,
        "key_ids": {},
        "agree": 0,
        "disagree": 0,
        "short": 0,
        "with_corr_id": 0,
    }
    by_reason: dict[str, int] = {}
    rejected_replicas = 0
    verdict_problems: list[str] = []
    if verdict_dir:
        for path in sorted(
            glob.glob(os.path.join(verdict_dir, "*.quorum.json"))
        ):
            try:
                doc = _load_json(path)
            except (OSError, ValueError) as exc:
                verdict_problems.append(f"{path}: unreadable ({exc})")
                continue
            verdicts["count"] += 1
            problems = validate_quorum_verdict(doc)
            if problems:
                verdicts["signed_bad"] += 1
                verdict_problems.append(
                    f"{os.path.basename(path)}: {problems[0]}"
                )
            else:
                verdicts["signed_ok"] += 1
            sig = doc.get("signature") or {}
            key_id = str(sig.get("key_id", "?"))
            verdicts["key_ids"][key_id] = (
                verdicts["key_ids"].get(key_id, 0) + 1
            )
            v = doc.get("verdict")
            if v in ("agree", "disagree", "short"):
                verdicts[v] += 1
            if doc.get("corr_id"):
                verdicts["with_corr_id"] += 1
            for rep in doc.get("replicas") or []:
                if rep.get("intrinsic_ok"):
                    continue
                rejected_replicas += 1
                for problem in rep.get("problems") or ["unknown"]:
                    tag = str(problem).split(":", 1)[0].strip()
                    by_reason[tag] = by_reason.get(tag, 0) + 1

    adversaries = {
        "detected_hosts": sum(
            1 for h in hosts if int(h.get("total_invalid", 0)) > 0
        ),
        "rejected_replicas": rejected_replicas,
        "by_reason": dict(sorted(by_reason.items())),
        "timeouts": overhead["timeouts"],
    }

    doc = {
        "schema": FLEET_SCHEMA,
        "t": time.time(),
        "run_token": life.get("run_token"),
        "sources": {
            "lifecycle": os.path.abspath(lifecycle_path),
            "verdict_dir": (
                os.path.abspath(verdict_dir) if verdict_dir else None
            ),
            "metrics": (
                os.path.abspath(metrics_path) if metrics_path else None
            ),
        },
        "streams": len(hosts),
        "wus": {
            "total": len(wus),
            "granted": len(granted),
            "failed": sum(1 for w in wus if w.get("state") == "failed"),
            "pending": sum(1 for w in wus if w.get("state") == "pending"),
            "quorum1_grants": int(summary.get("quorum1_grants", 0)),
            "with_corr_id": sum(1 for w in wus if w.get("corr_id")),
        },
        "grant_latency_s": _latency_block(grant_latencies),
        "validation_latency_s": _latency_block(validation_latencies),
        "reissue_overhead": overhead,
        "adversaries": adversaries,
        "hosts": hosts,
        "verdicts": verdicts,
        "verdict_problems": verdict_problems[:20],
    }
    if metrics_path:
        counters = _metrics_counters(metrics_path)
        doc["fabric_counters"] = {
            k: v for k, v in sorted(counters.items())
            if k.startswith("fabric.")
        }
    drift_paths = list(host_metrics or [])
    if metrics_path and metrics_path not in drift_paths:
        drift_paths.insert(0, metrics_path)
    doc["sentinel_drift"] = sentinel_drift_block(drift_paths)
    return doc


# ---------------------------------------------------------------------------
# validation + SLO gates


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_fleet_report(doc) -> list[str]:
    """Structural problems of an ``erp-fleet-report/1`` document (empty
    list = valid).  Hand-rolled like the other artifact checkers — the
    container has no jsonschema."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["not a JSON object"]
    if doc.get("schema") != FLEET_SCHEMA:
        errs.append(
            f"schema is {doc.get('schema')!r}, expected {FLEET_SCHEMA!r}"
        )
    if not _is_num(doc.get("t")):
        errs.append("t missing or not a number")
    wus = doc.get("wus")
    if not isinstance(wus, dict):
        errs.append("wus missing or not an object")
    else:
        for key in ("total", "granted", "failed", "pending"):
            if not isinstance(wus.get(key), int):
                errs.append(f"wus.{key} missing or not an int")
    for name in ("grant_latency_s", "validation_latency_s"):
        block = doc.get(name)
        if not isinstance(block, dict):
            errs.append(f"{name} missing or not an object")
            continue
        if not isinstance(block.get("n"), int):
            errs.append(f"{name}.n missing or not an int")
        last = None
        for pct in _PCTS:
            v = block.get(f"p{pct}")
            if not _is_num(v) or v < 0:
                errs.append(f"{name}.p{pct} missing or negative")
            elif last is not None and v < last:
                errs.append(
                    f"{name}: p{pct}={v} below a lower percentile ({last})"
                )
            else:
                last = v
    overhead = doc.get("reissue_overhead")
    if not isinstance(overhead, dict):
        errs.append("reissue_overhead missing or not an object")
    else:
        for key in ("replicas_issued", "floor"):
            if not isinstance(overhead.get(key), int):
                errs.append(f"reissue_overhead.{key} missing or not an int")
        if not _is_num(overhead.get("ratio")) or overhead.get("ratio", -1) < 0:
            errs.append("reissue_overhead.ratio missing or negative")
    adv = doc.get("adversaries")
    if not isinstance(adv, dict):
        errs.append("adversaries missing or not an object")
    elif not isinstance(adv.get("by_reason"), dict):
        errs.append("adversaries.by_reason missing or not an object")
    hosts = doc.get("hosts")
    if not isinstance(hosts, list):
        errs.append("hosts missing or not a list")
    else:
        for i, h in enumerate(hosts):
            if not isinstance(h, dict) or "host_id" not in h:
                errs.append(f"hosts[{i}]: needs host_id")
                break
    verdicts = doc.get("verdicts")
    if not isinstance(verdicts, dict):
        errs.append("verdicts missing or not an object")
    else:
        for key in ("count", "signed_ok", "signed_bad", "agree"):
            if not isinstance(verdicts.get(key), int):
                errs.append(f"verdicts.{key} missing or not an int")
    # optional (reports built before the precision observatory lack it),
    # but structurally checked when present
    drift = doc.get("sentinel_drift")
    if drift is not None:
        if not isinstance(drift, dict):
            errs.append("sentinel_drift not an object")
        else:
            if not isinstance(drift.get("probes"), int) or \
                    drift["probes"] < 0:
                errs.append("sentinel_drift.probes missing or negative")
            for key in ("max_rel_err", "p95_rel_err_bound"):
                v = drift.get(key)
                if v is not None and (not _is_num(v) or v < 0):
                    errs.append(f"sentinel_drift.{key} negative or non-num")
            if not isinstance(drift.get("hosts"), dict):
                errs.append("sentinel_drift.hosts missing or not an object")
    return errs


def evaluate_slo(doc: dict, baseline: dict) -> list[str]:
    """SLO violations of a fleet report against a committed baseline
    (empty list = all gates pass)."""
    errs: list[str] = []
    if baseline.get("schema") != BASELINE_SCHEMA:
        return [
            f"baseline schema is {baseline.get('schema')!r}, "
            f"expected {BASELINE_SCHEMA!r}"
        ]
    for name in ("grant_latency_s", "validation_latency_s"):
        bounds = baseline.get(name) or {}
        block = doc.get(name) or {}
        for pct in _PCTS:
            bound = bounds.get(f"p{pct}_max")
            if bound is None:
                continue
            got = block.get(f"p{pct}")
            if got is None or got > bound:
                errs.append(
                    f"SLO: {name}.p{pct} = {got} exceeds baseline "
                    f"{bound}"
                )
    ratio_max = (baseline.get("reissue_overhead") or {}).get("ratio_max")
    if ratio_max is not None:
        ratio = (doc.get("reissue_overhead") or {}).get("ratio")
        if ratio is None or ratio > ratio_max:
            errs.append(
                f"SLO: reissue_overhead.ratio = {ratio} exceeds baseline "
                f"{ratio_max}"
            )
    require = baseline.get("require") or {}
    wus = doc.get("wus") or {}
    verdicts = doc.get("verdicts") or {}
    if require.get("granted_all") and (
        wus.get("pending", 1) != 0 or wus.get("failed", 1) != 0
    ):
        errs.append(
            f"SLO: not all WUs granted "
            f"(pending={wus.get('pending')}, failed={wus.get('failed')})"
        )
    if require.get("signed_all") and verdicts.get("signed_bad", 1) != 0:
        errs.append(
            f"SLO: {verdicts.get('signed_bad')} verdict(s) failed "
            f"signature/structure verification"
        )
    if require.get("grants_verdict_sourced"):
        if verdicts.get("agree", 0) < wus.get("granted", 0):
            errs.append(
                f"SLO: {wus.get('granted')} grants but only "
                f"{verdicts.get('agree')} signed agree verdicts"
            )
    drift_bounds = baseline.get("sentinel_drift") or {}
    rel_max = drift_bounds.get("max_rel_err_max")
    if rel_max is not None:
        drift = doc.get("sentinel_drift") or {}
        got = drift.get("max_rel_err")
        if got is None or got > rel_max:
            errs.append(
                f"SLO: sentinel_drift.max_rel_err = {got} exceeds "
                f"baseline {rel_max}"
            )
    return errs


# ---------------------------------------------------------------------------
# rendering


def render(doc: dict) -> str:
    lines = []
    wus = doc.get("wus", {})
    lines.append(
        f"fleet report  run={doc.get('run_token')}  streams="
        f"{doc.get('streams')}  wus={wus.get('total')} "
        f"(granted {wus.get('granted')}, failed {wus.get('failed')}, "
        f"pending {wus.get('pending')}, quorum-1 "
        f"{wus.get('quorum1_grants')})"
    )
    for name, label in (
        ("grant_latency_s", "grant latency"),
        ("validation_latency_s", "validation latency"),
    ):
        b = doc.get(name, {})
        lines.append(
            f"  {label:<20} n={b.get('n'):<5} "
            f"p50={b.get('p50'):.4f}s p95={b.get('p95'):.4f}s "
            f"p99={b.get('p99'):.4f}s max={b.get('max'):.4f}s"
        )
    ov = doc.get("reissue_overhead", {})
    lines.append(
        f"  re-issue overhead    {ov.get('replicas_issued')} replicas / "
        f"floor {ov.get('floor')} = {ov.get('ratio')}x "
        f"(reissues {ov.get('reissues')}, timeouts {ov.get('timeouts')})"
    )
    adv = doc.get("adversaries", {})
    lines.append(
        f"  adversaries          {adv.get('detected_hosts')} hosts, "
        f"{adv.get('rejected_replicas')} replicas rejected"
    )
    for tag, n in (adv.get("by_reason") or {}).items():
        lines.append(f"    {tag:<28} {n}")
    v = doc.get("verdicts", {})
    lines.append(
        f"  verdicts             {v.get('count')} "
        f"({v.get('signed_ok')} verified, {v.get('signed_bad')} bad, "
        f"keys {v.get('key_ids')}); agree={v.get('agree')} "
        f"disagree={v.get('disagree')} short={v.get('short')}, "
        f"corr-tagged {v.get('with_corr_id')}"
    )
    trusted = sum(1 for h in doc.get("hosts", []) if h.get("trusted"))
    lines.append(
        f"  hosts                {len(doc.get('hosts', []))} seen, "
        f"{trusted} trusted"
    )
    drift = doc.get("sentinel_drift")
    if isinstance(drift, dict):
        mx = drift.get("max_rel_err")
        p95 = drift.get("p95_rel_err_bound")
        lines.append(
            f"  sentinel drift       {drift.get('probes')} probes across "
            f"{len(drift.get('hosts') or {})} stream(s), max rel err "
            f"{'n/a' if mx is None else format(mx, '.3g')}, p95 bound "
            f"{'n/a' if p95 is None else format(p95, '.3g')}"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# CLI


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lifecycle", help="erp-wu-lifecycle/1 export")
    ap.add_argument("--verdict-dir", help="directory of erp-quorum/1 docs")
    ap.add_argument("--metrics", help="erp-metrics/1 heartbeat stream")
    ap.add_argument(
        "--host-metrics", nargs="*", default=None, metavar="STREAM",
        help="additional per-host erp-metrics/1 streams for the "
             "sentinel-drift rollup",
    )
    ap.add_argument("--out", help="write the erp-fleet-report/1 here")
    ap.add_argument(
        "--check", metavar="FLEET.json",
        help="validate an existing report instead of building one",
    )
    ap.add_argument(
        "--baseline", metavar="BASELINE.json",
        help="erp-fleet-baseline/1 SLO bounds to enforce",
    )
    args = ap.parse_args(argv)

    if args.check:
        doc = _load_json(args.check)
        errs = validate_fleet_report(doc)
        if not errs and args.baseline:
            errs = evaluate_slo(doc, _load_json(args.baseline))
        if errs:
            print(f"{args.check}: INVALID")
            for e in errs:
                print(f"  - {e}")
            return 1
        print(f"{args.check}: OK ({FLEET_SCHEMA})")
        print(render(doc))
        return 0

    if not args.lifecycle:
        ap.error("--lifecycle is required when building (or use --check)")
    doc = build_report(
        args.lifecycle, args.verdict_dir, metrics_path=args.metrics,
        host_metrics=args.host_metrics,
    )
    errs = validate_fleet_report(doc)
    if errs:
        print("built report fails its own schema check:", file=sys.stderr)
        for e in errs:
            print(f"  - {e}", file=sys.stderr)
        return 1
    slo_errs = []
    if args.baseline:
        slo_errs = evaluate_slo(doc, _load_json(args.baseline))
    if args.out:
        tmp = f"{args.out}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, args.out)
        print(f"wrote {args.out}")
    print(render(doc))
    if slo_errs:
        for e in slo_errs:
            print(f"  - {e}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
