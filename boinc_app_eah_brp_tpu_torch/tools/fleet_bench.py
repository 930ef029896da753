"""Fleet serving bench: WUs/hour/chip at zero recompiles after warm-up.

The serving tier's claim is that one resident ``FleetServer`` streams
same-geometry workunits through warmed kernels and cuFFT plans: after
warm-up no workunit builds a kernel or makes a plan (``recompiles``), and
the gap between workunits is host bookkeeping.  This bench, the twin of
the JAX package's ``tools/fleet_bench.py``:

* writes N same-geometry workunits of the fixture class (distinct
  signals), warms one server for their class (``Scheduler.warm`` on the
  geometry a session of the class builds) and streams them through it;
* gates ``recompiles_after_warmup == 0``;
* ``--verify`` re-runs every workunit through the one-process command
  line and requires byte-identical result files;
* scrapes ``/metrics`` and ``/healthz`` of the live introspection plane
  once while the queue drains, and checks the SLO heartbeat stream;
* ``--check`` holds the scoreboard to ``FLEET_SERVING_BASELINE.json``:
  its exact gates (recompiles, the p95 inter-WU gap) always, its
  throughput floor only on the CPU, where that floor was measured; on
  the card the throughput is recorded, not gated.

Usage:
    python -m boinc_app_eah_brp_tpu_torch.tools.fleet_bench [--device cpu]
    python -m boinc_app_eah_brp_tpu_torch.tools.fleet_bench --wus 2 --verify --check --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from . import _inputs

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCHEMA = "erp-fleet-bench/1"
BASELINE_SCHEMA = "erp-fleet-serving-baseline/1"


def fail(msg: str) -> int:
    print(f"fleet-bench: FAIL: {msg}", file=sys.stderr)
    return 1


def build_workunits(work: str, n: int, device: str):
    """N fixture-class workunits (distinct signals and noise seeds)
    sharing one bank, as DriverArgs on ``device``."""
    from ..runtime.driver import DriverArgs

    bank = _inputs.fixture_bank(os.path.join(work, "bank.dat"))
    out = []
    for i in range(n):
        wu = _inputs.fixture_workunit(os.path.join(work, f"wu{i:03d}.bin4"), f_signal=31.0 + 2.0 * i, seed=i)
        out.append(DriverArgs(
            inputfile=wu, outputfile=os.path.join(work, f"wu{i:03d}.cand"), templatebank=bank,
            checkpointfile=os.path.join(work, f"wu{i:03d}.cpt"), window=_inputs.WINDOW,
            batch_size=_inputs.BATCH, device=device,
        ))
    return out


def warm_spec_for(args0):
    """The WarmSpec of ``args0``'s class: the geometry a session of it
    prepares (so the warm step's cache key is the one its workunits look
    up) and its batch."""
    import dataclasses

    from ..runtime.scheduler import WarmSpec
    from ..runtime.session import Session

    probe = Session(dataclasses.replace(args0, checkpointfile=None)).prepare()
    try:
        return WarmSpec(probe.geom, args0.batch_size)
    finally:
        probe.release()


def run_reference(args) -> bytes:
    """The one-process path: the port's command line in a subprocess —
    the byte oracle of ``--verify``."""
    out = args.outputfile + ".ref"
    cmd = _inputs.cli_cmd(
        args.inputfile, args.templatebank, out, args.checkpointfile + ".ref",
        "-B", str(args.window), "--batch", str(args.batch_size), "--device", args.device,
    )
    r = subprocess.run(cmd, env=_inputs.child_env(), capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-4000:])
        raise RuntimeError(f"reference run exited {r.returncode}")
    with open(out, "rb") as f:
        return f.read()


def scrape_introspection(server) -> dict | None:
    """One scrape of ``/metrics`` (must parse as Prometheus text) and
    ``/healthz`` off the loopback endpoint; None when disarmed."""
    intro = getattr(server, "introspect", None)
    if intro is None or not getattr(intro, "armed", False):
        return None
    import urllib.error
    import urllib.request

    from ..serving.introspect import parse_prometheus

    t0 = time.monotonic()
    with urllib.request.urlopen(intro.url("/metrics"), timeout=10) as r:
        body = r.read().decode("utf-8")
    samples = parse_prometheus(body)
    try:
        with urllib.request.urlopen(intro.url("/healthz"), timeout=10) as r:
            healthz = r.status
    except urllib.error.HTTPError as e:
        healthz = e.code  # 503 = SLO burning; recorded, not fatal
    return {
        "port": intro.port,
        "scrape_ms": round((time.monotonic() - t0) * 1e3, 3),
        "metrics_samples": len(samples),
        "healthz_status": healthz,
    }


def check_baseline(stats: dict, base_path: str, *, on_cpu: bool) -> list[str]:
    """Violations of ``FLEET_SERVING_BASELINE.json`` (empty = green).  Its
    throughput floor was measured on a CPU with the fixture class, so it
    is applied only to a CPU run."""
    with open(base_path, encoding="utf-8") as f:
        base = json.load(f)
    if base.get("schema") != BASELINE_SCHEMA:
        return [f"{base_path} is not a {BASELINE_SCHEMA} document"]
    bad = []
    floor = base.get("wus_per_hour_per_chip_min")
    if on_cpu and floor is not None and stats["wus_per_hour_per_chip"] < floor:
        bad.append(f"wus_per_hour_per_chip {stats['wus_per_hour_per_chip']} below floor {floor}")
    rmax = base.get("recompiles_after_warmup_max")
    if rmax is not None and stats["recompiles_after_warmup"] > rmax:
        bad.append(f"recompiles_after_warmup {stats['recompiles_after_warmup']} exceeds {rmax}")
    gmax = base.get("p95_inter_wu_gap_s_max")
    if gmax is not None and stats["p95_inter_wu_gap_s"] > gmax:
        bad.append(f"p95_inter_wu_gap_s {stats['p95_inter_wu_gap_s']} exceeds {gmax}")
    return bad


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Fleet serving bench: WUs/hour/chip at zero recompiles after warm-up.")
    ap.add_argument("--wus", type=int, default=4, help="same-geometry workunits to stream (default 4)")
    ap.add_argument("--verify", action="store_true",
                    help="byte-compare every served result against the one-process command line")
    ap.add_argument("--check", action="store_true", help="gate the scoreboard against --baseline")
    ap.add_argument("--baseline", default=os.path.join(REPO, "FLEET_SERVING_BASELINE.json"))
    ap.add_argument("--json", default="", help="write the erp-fleet-bench/1 scoreboard here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--workdir", help="reuse this dir instead of a tmp one")
    ap.add_argument("--keep", action="store_true", help="keep the workdir (default: removed when green)")
    args = ap.parse_args(argv)

    if args.wus < 2:
        return fail("--wus must be >= 2 (a warmed stream of at least two workunits)")
    device = _inputs.require_device(args.device)
    work = args.workdir or tempfile.mkdtemp(prefix="erp-fleet-bench-")
    os.makedirs(work, exist_ok=True)
    # deterministic headers (byte comparison), the measured step bracket,
    # the SLO heartbeat and the introspection plane on: the byte and
    # recompile gates then also show that measuring changes nothing
    os.environ["ERP_RESULT_DATE"] = _inputs.RESULT_DATE
    os.environ.setdefault("ERP_STEPTIME", "1")
    slo_path = os.environ.setdefault("ERP_SLO_FILE", os.path.join(work, "serving_slo.jsonl"))
    os.environ.setdefault("ERP_SLO_INTERVAL", "0.5")
    os.environ.setdefault("ERP_STATUSZ_PORT", "0")
    print(f"fleet-bench: workdir {work}")

    from ..runtime import metrics, steptime
    from ..serving import FleetServer
    from . import report_check

    if not metrics.enabled():
        metrics.configure(force=True)
    wus = build_workunits(work, args.wus, device)
    t0 = time.monotonic()
    server = FleetServer(warm_specs=[warm_spec_for(wus[0])], name="bench", device=device)
    warm_s = time.monotonic() - t0
    print(f"fleet-bench: warm {server.warm_report} in {warm_s:.2f}s")
    try:
        tickets = [server.submit(a, corr_id=f"bench-{i}") for i, a in enumerate(wus)]
        introspection = scrape_introspection(server)
        results = [server.result(t, timeout=600) for t in tickets]
        stats = server.stats()
    finally:
        server.close()
    if introspection is not None and introspection["metrics_samples"] == 0:
        return fail("/metrics scrape parsed to zero samples")
    for i, r in enumerate(results):
        print(f"fleet-bench: wu{i:03d} code={r.code} recompiles={r.recompiles} wall={r.wall_s:.2f}s "
              f"prep={r.prepare_s:.2f}s")
    bad = [r for r in results if not r.ok]
    if bad:
        return fail(f"{len(bad)} session(s) failed: " + ", ".join(f"{r.name}:{r.code}" for r in bad))
    print(f"fleet-bench: {json.dumps(stats)}")

    verified = None
    if args.verify:
        for i, (a, r) in enumerate(zip(wus, results)):
            with open(r.outputfile, "rb") as f:
                got = f.read()
            ref = run_reference(a)
            if got != ref:
                return fail(f"wu{i:03d}: served result differs from the command line's "
                            f"(bytes {len(got)} vs {len(ref)})")
        verified = len(wus)
        print(f"fleet-bench: all {verified} served results byte-identical to the command line's")
    if stats["recompiles_after_warmup"] != 0:
        return fail(f"recompiles_after_warmup = {stats['recompiles_after_warmup']} (must be 0)")

    step_latency = steptime.summary()
    if step_latency["windows"] == 0:
        return fail("ERP_STEPTIME is on but no step windows were measured")
    if not os.path.exists(slo_path):
        return fail("no erp-serving-slo/1 heartbeat stream written")
    schema, problems = report_check.check_path(slo_path)
    if problems:
        return fail(f"the SLO stream fails its {schema} check: {problems[:3]}")
    on_cpu = device == "cpu"
    if on_cpu:
        backend = "cpu"
    else:
        import torch

        backend = torch.cuda.get_device_name(0)
    doc = {
        "schema": SCHEMA, "wus": args.wus, "warm_wall_s": round(warm_s, 3), "backend": backend,
        "verified_byte_identical": verified, "step_latency": step_latency,
        "introspection": introspection, "stats": stats,
    }
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    if args.check:
        violations = check_baseline(stats, args.baseline, on_cpu=on_cpu)
        if violations:
            return fail("baseline violations: " + "; ".join(violations))
        print(f"fleet-bench: within {os.path.basename(args.baseline)}"
              + ("" if on_cpu else " (its CPU throughput floor not applied on the card)"))
    if not args.keep and not args.workdir:
        shutil.rmtree(work, ignore_errors=True)
    print(f"fleet-bench: PASS ({args.wus} WUs on {backend}, {stats['wus_per_hour_per_chip']} WUs/hour/chip, "
          f"0 recompiles after warm-up)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
