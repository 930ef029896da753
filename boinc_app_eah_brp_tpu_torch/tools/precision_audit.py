"""Stage-wise precision audit: ``erp-precision-audit/1``.

Runs the port's pipeline (its kernels as the taps on the card, their
plain versions on the CPU) and the f64 oracle over the CI workunit
(``runtime/precision.py::ci_fixture``: the JAX package's
``tools/precision_audit.py::build_fixture``), attributes error to the
stage that introduced it, and scores the final toplist's recall against
the oracle's, for the f32 lane and the bf16 shadow lane:

1. **fresh audit** (default): ``run_audit`` with the metrics layer armed
   (so the tap proof counts kernel builds and new cuFFT plans), the
   per-stage waterfall and candidate scores rendered;
2. ``--baseline PRECISION_BASELINE.json`` holds the fresh audit under the
   committed per-stage ceilings and recall/Jaccard/rank floors, and
   requires the tap proof (byte-identical ``run_bank`` outputs, zero
   builds and plans in the tapped window).  A baseline that names a
   backend gates only audits of that backend;
3. ``--check`` validates existing artifacts; ``--diff OLD NEW`` exits
   non-zero naming the stage whose error regressed (same backend only).

Usage:
    python -m boinc_app_eah_brp_tpu_torch.tools.precision_audit [--device cpu] [--json AUDIT.json]
    python -m boinc_app_eah_brp_tpu_torch.tools.precision_audit --baseline PRECISION_BASELINE.json
    python -m boinc_app_eah_brp_tpu_torch.tools.precision_audit --check AUDIT.json ...
    python -m boinc_app_eah_brp_tpu_torch.tools.precision_audit --diff OLD.json NEW.json
"""

from __future__ import annotations

import argparse
import json
import sys

from ..runtime.precision import (
    CI_BATCH,
    CI_SAMPLES,
    PRECISION_SCHEMA,
    diff_docs,
    evaluate_baseline,
    validate_precision_audit,
)


def fail(msg: str) -> int:
    print(f"precision-audit: FAIL: {msg}", file=sys.stderr)
    return 1


def fresh_audit(lanes: tuple[str, ...], device: str, n_samples: int = CI_SAMPLES) -> dict:
    """The audit of the CI fixture at ``n_samples`` samples on ``device``,
    with the metrics layer armed for its window."""
    from ..runtime import metrics, precision

    metrics.configure(force=True)
    try:
        return precision.run_audit(
            *precision.ci_fixture(n_samples), lanes=lanes, batch_size=CI_BATCH, device=device
        )
    finally:
        metrics.finish(0)


def render(doc: dict) -> str:
    out = [
        f"== precision audit ({doc['backend']}, {doc['geometry']['templates']} templates, f64 oracle with "
        f"{doc['oracle']['decision_pinning']} decision pinning) =="
    ]
    for lane, ld in sorted(doc["lanes"].items()):
        c = ld["candidates"]
        out.append(
            f"-- lane {lane}: recall@tol {c['recall_at_tol']:.4f} jaccard {c['jaccard']:.4f} "
            f"rank {c['rank_stability']:.4f} ({c['matched']}/{c['oracle_n']} oracle candidates matched, "
            f"{c['boundary']} boundary)"
        )
        out.append(f"{'stage':<14} {'cum max rel':>12} {'introduced':>12} {'share':>7} {'ulp>4':>7}")
        for s, w in zip(ld["stages"], ld["waterfall"]):
            beyond = sum(v for k, v in s["ulp_hist"].items() if k == "inf" or int(k) > 4)
            out.append(
                f"{s['stage']:<14} {s['max_rel_err']:>12.3e} {w['introduced_rel_err']:>12.3e} "
                f"{w['share']:>6.1%} {beyond:>7d}"
            )
        a = ld["attribution"]
        out.append(
            f"   worst stage: {a['worst_stage']} (introduced {a['worst_introduced_rel_err']:.3e}; final "
            f"candidate power rel err {a['final_candidate_power_rel_err']:.3e})"
        )
        tap = ld.get("tap")
        if tap:
            out.append(
                f"   tap: byte_identical={tap['byte_identical']} recompiles={tap['recompiles_in_window']} "
                f"merge-vs-production {tap['tap_vs_production_max_rel']:.3e}"
            )
    return "\n".join(out)


def _load(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Per-stage numerical-error audit of the port against the f64 oracle.")
    ap.add_argument("--check", nargs="+", metavar="PATH", help="validate existing audits and exit")
    ap.add_argument("--diff", nargs=2, metavar=("OLD", "NEW"),
                    help="exit non-zero naming the stage whose error regressed past --threshold")
    ap.add_argument("--threshold", type=float, default=25.0,
                    help="--diff threshold, percent growth of a stage's max rel err (default 25)")
    ap.add_argument("--baseline", help="gate the fresh audit against this PRECISION_BASELINE.json")
    ap.add_argument("--lanes", default="f32,bf16", help="comma-separated dtype lanes (default f32,bf16)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", default="", help="write the fresh audit here")
    args = ap.parse_args(argv)

    if args.check:
        bad = 0
        for p in args.check:
            try:
                errs = validate_precision_audit(_load(p))
            except (OSError, ValueError) as e:
                errs = [f"unreadable: {e}"]
            if errs:
                bad += 1
                print(f"{p}: INVALID")
                for e in errs:
                    print(f"  - {e}")
            else:
                print(f"{p}: OK ({PRECISION_SCHEMA})")
        return 1 if bad else 0

    if args.diff:
        try:
            old, new = (_load(p) for p in args.diff)
        except (OSError, ValueError) as e:
            return fail(f"cannot read {args.diff}: {e}")
        problems = diff_docs(old, new, threshold=args.threshold / 100.0)
        if problems:
            return fail("precision regression: " + "; ".join(problems))
        if old.get("backend") != new.get("backend"):
            print(f"precision-audit: diff across backends ({old.get('backend')} -> {new.get('backend')}); "
                  "regression gate skipped")
        else:
            print(f"precision-audit: no regression (threshold {args.threshold}%)")
        return 0

    from . import _inputs

    device = _inputs.require_device(args.device)
    doc = fresh_audit(tuple(s for s in args.lanes.split(",") if s), device)
    errs = validate_precision_audit(doc)
    if errs:
        return fail("self-check failed: " + "; ".join(errs))
    print(render(doc))
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"precision-audit: written to {args.json}")
    if args.baseline:
        try:
            base = _load(args.baseline)
        except (OSError, ValueError) as e:
            return fail(f"cannot read baseline {args.baseline}: {e}")
        problems = evaluate_baseline(doc, base)
        if problems:
            return fail("baseline violations: " + "; ".join(problems))
        gated = not base.get("backend") or base["backend"] == doc["backend"]
        print(f"precision-audit: {'within' if gated else 'not gated by'} the ceilings of {args.baseline}"
              + ("" if gated else f" (a {base['backend']} baseline)"))
    f32 = doc["lanes"].get("f32", {}).get("candidates", {})
    print(f"precision-audit: PASS (f32 recall {f32.get('recall_at_tol', 'n/a')}, oracle toplist "
          f"{f32.get('oracle_n', '?')} candidates)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
