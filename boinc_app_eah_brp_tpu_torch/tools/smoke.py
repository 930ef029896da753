"""Observability smoke: one small run with every telemetry layer on, then
a schema check of everything it leaves behind.  The port's twin of the
JAX package's ``tools/smoke.py`` (its ``make smoke`` gate), driving
``python -m boinc_app_eah_brp_tpu_torch``.

The default gate (:func:`gate`) runs the command line in a subprocess
with the health checks at every batch (``ERP_HEALTH_EVERY=1``,
``ERP_HEALTH_ACTION=abort``), the metrics stream (``--metrics-file``),
the host trace (``ERP_TRACE_FILE``) and the flight recorder armed, and
requires

* exit 0 and a parseable candidate file;
* ``tools/report_check.py`` passing on the metrics stream, the trace, its
  Chrome export and the run report;
* ``tools/trace_report.py`` attributing >= 95% of the run's wall to named
  spans;
* the checkpoint audit sidecar verifying against the checkpoint;
* ``health.checks > 0`` and no violation;
* no black-box dump (a dump on a clean run is itself a bug);
* the committed ``PRECISION_BASELINE.json`` (and a cached audit, where
  one exists) validating.

The workunit, bank, window, batch and device are arguments, so the gate
runs at any width; the command line builds the JAX smoke's fixture
(4096 samples, the four-template bank, window 200, batch 2).

``--hosts N`` runs the clean multi-host elastic gate instead: N command
lines over one shard board (on the CPU each with ``ERP_LOCAL_DEVICES=4``
logical shards, the JAX gate's four-device host); all exit 0, the merge
winner writes a result whose audit records N processes, every lease and
the merge are complete, and a clean run records no rebalance.
``--fabric`` runs the clean volunteer-fabric gate: one command line
builds the reference, 8 honest streams push 8 workunits through the
quorum scheduler, every workunit grants with the reference's candidate
rows, nothing is rejected or issued again, and every signed verdict
validates.

Usage (``T=boinc_app_eah_brp_tpu_torch.tools``):
    python -m $T.smoke [--device cpu] [--keep] [--workdir DIR] [--hosts N] [--fabric]

Exit 0 when green.  ``--device`` is ``cuda`` by default; without a card
the gate raises unless given ``cpu``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from . import _inputs
from .metrics_report import load_report

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
F_SIGNAL = 33.0
COVERAGE_MIN = 0.95
RUN_TIMEOUT_S = 600


class SmokeFailed(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailed(msg)


def fixture(work: str) -> tuple[str, str]:
    """The JAX smoke's workunit and bank: (workunit path, bank path)."""
    wu = _inputs.fixture_workunit(os.path.join(work, "smoke.bin4"), f_signal=F_SIGNAL)
    return wu, _inputs.fixture_bank(os.path.join(work, "bank.dat"))


def check_precision_artifacts() -> str:
    """The committed PRECISION_BASELINE.json must validate, and so must
    the cached audit (``.erp_cache/precision_audit_ci.json``) where one
    exists.  Returns what was checked."""
    from ..runtime.precision import validate_precision_audit, validate_precision_baseline

    base_path = os.path.join(REPO, "PRECISION_BASELINE.json")
    check(os.path.exists(base_path), "no committed PRECISION_BASELINE.json")
    try:
        with open(base_path, encoding="utf-8") as f:
            base = json.load(f)
    except (OSError, ValueError) as e:
        raise SmokeFailed(f"PRECISION_BASELINE.json unreadable: {e}") from None
    errs = validate_precision_baseline(base)
    check(not errs, f"PRECISION_BASELINE.json invalid: {'; '.join(errs)}")
    audit_cache = os.path.join(REPO, ".erp_cache", "precision_audit_ci.json")
    if not os.path.exists(audit_cache):
        return "baseline; no cached audit"
    try:
        with open(audit_cache, encoding="utf-8") as f:
            audit = json.load(f)
    except (OSError, ValueError) as e:
        raise SmokeFailed(f"{audit_cache} unreadable: {e}") from None
    errs = validate_precision_audit(audit)
    check(not errs, f"{audit_cache} invalid: {'; '.join(errs)}")
    return "baseline + cached audit"


def _counters(report: dict) -> dict:
    return {k: v.get("value", 0) for k, v in ((report.get("metrics") or {}).get("counters") or {}).items()}


def _launches(report: dict) -> dict:
    gauges = (report.get("metrics") or {}).get("gauges") or {}
    prefix = "torch.kernel_launches."
    return {k[len(prefix):]: int(v["value"]) for k, v in gauges.items() if k.startswith(prefix)}


def gate(work: str, wu: str, bank: str, *, window: int = _inputs.WINDOW, batch: int = _inputs.BATCH,
         device: str = "cuda", search_args: tuple = ()) -> dict:
    """The default gate on ``wu`` and ``bank`` (``search_args`` adds
    command-line flags such as ``-P 3``).  Raises SmokeFailed naming the
    first check that fails; returns the run's wall, trace coverage, health
    checks and kernel launches."""
    from ..io import parse_result_file
    from ..io.checkpoint import audit_path, read_checkpoint, verify_checkpoint_audit
    from . import report_check, trace_report

    _inputs.require_device(device)
    out = os.path.join(work, "results.cand")
    cp = os.path.join(work, "checkpoint.cpt")
    metrics_file = os.path.join(work, "metrics.jsonl")
    trace_file = os.path.join(work, "run.trace.jsonl")
    env = _inputs.child_env(
        ERP_HEALTH_EVERY="1",
        ERP_HEALTH_ACTION="abort",  # a violation must fail the smoke
        ERP_BLACKBOX_DIR=work,
        ERP_TRACE_FILE=trace_file,
    )
    cmd = _inputs.cli_cmd(
        wu, bank, out, cp, "-B", str(window), "--batch", str(batch), "--device", device,
        "--metrics-file", metrics_file, *search_args,
    )
    print(f"smoke: running {' '.join(cmd)}", flush=True)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"driver exited {r.returncode}: {r.stderr[-4000:]}")

    check(os.path.exists(out), "no candidate file written")
    try:
        parse_result_file(out)
    except Exception as e:
        raise SmokeFailed(f"malformed candidate file: {e}") from None
    chrome_file = trace_file + ".chrome.json"
    for p in (trace_file, chrome_file):
        check(os.path.exists(p), f"no trace artifact {p}")

    bad = []
    for p in [metrics_file, trace_file, chrome_file] + sorted(glob.glob(os.path.join(work, "*.report.json"))):
        schema, errs = report_check.check_path(p)
        print(f"{p}: {'INVALID' if errs else 'OK'} ({schema})")
        if errs:
            bad.append(f"{os.path.basename(p)}: {errs[:3]}")
    check(not bad, f"metrics/trace artifacts failed their checks: {bad}")

    # the stall table must account for (nearly) the whole run wall: an
    # unattributed gap means a pipeline stage lost its span
    stalls = trace_report.stall_table(trace_report.load_trace(trace_file))
    check(stalls["coverage"] >= COVERAGE_MIN,
          f"trace attributes only {stalls['coverage']:.1%} of the run wall (need >= 95%): {stalls['categories']}")
    top = sorted(stalls["categories"].items(), key=lambda kv: -kv[1]["self_s"])[:4]
    print(f"smoke: trace OK ({stalls['coverage']:.1%} of {stalls['wall_s']:.2f}s wall attributed; top: "
          + ", ".join(f"{c}={row['self_s']:.2f}s" for c, row in top))

    check(os.path.exists(audit_path(cp)), "no checkpoint audit sidecar")
    try:
        verify_checkpoint_audit(cp, read_checkpoint(cp))
    except Exception as e:
        raise SmokeFailed(f"checkpoint audit does not verify: {e}") from None
    print(f"smoke: checkpoint audit OK ({audit_path(cp)})")

    report = load_report(metrics_file)[0]
    check(report is not None, "no run_report in metrics stream")
    counters = _counters(report)
    checks = counters.get("health.checks", 0)
    violations = counters.get("health.violations", 0)
    check(checks > 0, "health watchdog never ran (health.checks == 0)")
    check(not violations, f"{violations} health violations on a clean run")
    print(f"smoke: watchdog OK ({checks} checks, 0 violations)")

    dumps = glob.glob(os.path.join(work, "erp-blackbox-*.json"))
    check(not dumps, f"black-box dump on a clean run: {dumps}")
    precision = check_precision_artifacts()
    print(f"smoke: precision artifacts OK ({precision})")
    return {
        "wall_s": wall,
        "coverage": stalls["coverage"],
        "health_checks": checks,
        "launches": _launches(report),
        "precision": precision,
    }


def hosts_gate(work: str, hosts: int, device: str = "cuda") -> dict:
    """The clean multi-host elastic gate: ``hosts`` uncoordinated command
    lines over one shard board, no kill.  Returns the shards run and the
    hosts' kernel launches summed (their run reports)."""
    from ..io import parse_result_file
    from ..io.checkpoint import audit_path
    from ..runtime.resilience import MERGE_SHARD, LeaseBoard

    _inputs.require_device(device)
    wu, bank = fixture(work)
    out = os.path.join(work, "results.cand")
    cp = os.path.join(work, "checkpoint.cpt")
    shard_dir = os.path.join(work, "shards")
    procs = []
    try:
        for i in range(hosts):
            metrics_file = os.path.join(work, f"metrics-host{i}.jsonl")
            env = _inputs.child_env(
                ERP_NUM_PROCESSES=str(hosts), ERP_PROCESS_ID=str(i), ERP_SHARD_DIR=shard_dir,
                ERP_METRICS_FILE=metrics_file, ERP_BLACKBOX_DIR=work,
            )
            if device == "cpu":
                env["ERP_LOCAL_DEVICES"] = "4"  # four logical shards a host
            cmd = _inputs.cli_cmd(wu, bank, out, cp, "-B", str(_inputs.WINDOW), "--batch", str(_inputs.BATCH),
                                  "--device", device, "--metrics-file", metrics_file)
            procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
        print(f"smoke: {hosts} elastic hosts launched on {device}", flush=True)
        for i, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=RUN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise SmokeFailed(f"host {i} did not finish within {RUN_TIMEOUT_S}s") from None
            check(p.returncode == 0, f"host {i} exited {p.returncode}: {(err or '')[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(f"smoke: all {hosts} hosts exited 0")

    check(os.path.exists(out), "no candidate file written by the merge winner")
    check(parse_result_file(out).done, "result file is not marked DONE")
    board = LeaseBoard(shard_dir, "smoke-checker")
    for shard in list(range(hosts)) + [MERGE_SHARD]:
        lease = board.read_lease(shard)
        check(lease is not None and lease.complete, f"lease {shard} incomplete after a clean run")
    print("smoke: every shard lease (and the merge) is complete")
    with open(audit_path(cp)) as f:
        topo = json.load(f).get("topology") or {}
    check(topo.get("process_count") == hosts,
          f"audit topology records process_count={topo.get('process_count')}, expected {hosts}")
    shards_run = rebalances = 0.0
    launches: dict = {}
    for i in range(hosts):
        report = load_report(os.path.join(work, f"metrics-host{i}.jsonl"))[0] or {}
        counters = _counters(report)
        shards_run += counters.get("elastic.shards_run", 0.0)
        rebalances += counters.get("resilience.rebalance", 0.0)
        for k, n in _launches(report).items():
            launches[k] = launches.get(k, 0) + n
    check(shards_run >= hosts, f"only {shards_run:.0f} shards ran across {hosts} hosts")
    check(not rebalances,
          f"{rebalances:.0f} rebalance(s) on a CLEAN run: a live host's heartbeat was mistaken for a dead one")
    check_precision_artifacts()
    return {"hosts": hosts, "shards_run": shards_run, "rebalances": rebalances, "launches": launches}


def fabric_gate(work: str, device: str = "cuda") -> dict:
    """The clean volunteer-fabric gate: 8 honest streams over one
    command-line reference.  Everything must grant and nothing may be
    flagged (a rejection or re-issue with no adversary is a validator or
    scheduler bug).  Returns the grants and the reference run's kernel
    launches (its run report)."""
    from .. import fabric as fb
    from ..io.results import split_result_sections
    from ..runtime import metrics
    from . import report_check

    _inputs.require_device(device)
    wu, bank = fixture(work)
    ref = os.path.join(work, "reference.cand")
    # sign verdicts with a real per-run key so the check below is
    # authoritative (development-key verdicts are forgeable)
    quorum_key = os.environ.get("ERP_QUORUM_KEY") or f"fabric-smoke-{os.urandom(8).hex()}"
    os.environ["ERP_QUORUM_KEY"] = quorum_key
    cmd = _inputs.cli_cmd(wu, bank, ref, os.path.join(work, "ref.cpt"), "-B", str(_inputs.WINDOW),
                          "--batch", str(_inputs.BATCH), "--device", device)
    ref_metrics = os.path.join(work, "reference.metrics.jsonl")
    r = subprocess.run(cmd, env=_inputs.child_env(ERP_QUORUM_KEY=quorum_key, ERP_METRICS_FILE=ref_metrics),
                       capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    check(r.returncode == 0, f"reference driver exited {r.returncode}: {r.stderr[-4000:]}")
    with open(ref, "rb") as f:
        ref_bytes = f.read()
    print(f"smoke: fabric reference built ({len(ref_bytes)} B)")

    os.environ["ERP_RESULT_DATE"] = _inputs.RESULT_DATE
    metrics.configure(force=True)
    cfg = fb.FabricConfig(t_obs=_inputs.T_OBS, seed=1, deadline_s=60.0, spool_dir="spool",
                          verdict_dir="verdicts", granted_dir="granted")
    wus = [fb.WorkUnit(wu_id=f"wu{i:02d}", payload="ref", epoch=cfg.bank_epoch, target=cfg.quorum) for i in range(8)]
    hosts = [fb.HostModel(host_id=i + 1, kind="honest", seed=1, date_iso=_inputs.RESULT_DATE) for i in range(8)]
    fabric = fb.Fabric(cfg, wus, {"ref": ref_bytes}, work)
    ok = fb.run_streams(fabric, hosts, timeout_s=300.0)
    summary = fabric.summary()
    report = metrics.finish("ok")
    print(f"smoke: fabric {summary}")
    check(ok and summary["granted"] == len(wus), f"fabric granted {summary['granted']}/{len(wus)}")
    flagged = float(_counters(report or {}).get("fabric.adversary_detected", 0.0))
    check(not flagged, f"{flagged:.0f} replicas rejected on an all-honest run: the validator flagged a clean result")
    check(not summary["reissues"], f"{summary['reissues']} spurious re-issue(s) on a clean run")
    _, ref_lines, _ = split_result_sections(ref_bytes.decode("utf-8"))
    for w in fabric.granted():
        with open(w.granted_path, "rb") as f:
            _, got, done = split_result_sections(f.read().decode("utf-8"))
        check(done and got == ref_lines, f"{w.wu_id}: granted bytes differ from reference")
    verdicts = sorted(glob.glob(os.path.join(work, "verdicts", "*.quorum.json")))
    bad = [p for p in verdicts if report_check.check_path(p)[1]]
    check(verdicts and not bad, f"fabric verdicts failed their check: {bad or 'none written'}")
    return {"wus": len(wus), "granted": summary["granted"], "verdicts": len(verdicts),
            "launches": _launches(load_report(ref_metrics)[0] or {})}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Observability smoke test of the port.")
    ap.add_argument("--workdir", help="reuse this dir instead of a tmp one")
    ap.add_argument("--keep", action="store_true", help="keep the workdir (default: removed when the run is green)")
    ap.add_argument("--hosts", type=int, default=0,
                    help="run the multi-host elastic gate with N hosts instead of the observability smoke")
    ap.add_argument("--fabric", action="store_true",
                    help="run the clean volunteer-fabric gate instead of the observability smoke")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = _inputs.require_device(args.device)
    work = args.workdir or tempfile.mkdtemp(prefix="erp-smoke-")
    os.makedirs(work, exist_ok=True)
    print(f"smoke: workdir {work}")
    try:
        if args.hosts:
            res = hosts_gate(work, args.hosts, device)
            print(f"smoke: PASS ({res['hosts']} hosts, {res['shards_run']:.0f} shards, topology audit OK, "
                  "0 spurious rebalances)")
        elif args.fabric:
            res = fabric_gate(work, device)
            print(f"smoke: PASS (fabric: {res['wus']} WUs granted by 8 honest streams, 0 rejections, "
                  f"0 re-issues, {res['verdicts']} verdicts OK)")
        else:
            gate(work, *fixture(work), device=device)
            print("smoke: PASS")
    except SmokeFailed as e:
        print(f"smoke: FAIL: {e}", file=sys.stderr)
        return 1
    if not args.keep and args.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
