"""Adversarial volunteer-fabric soak: the zero-false-grants gate.

Drives the port's work fabric (``fabric/workfabric.py``) with a fleet of
concurrent volunteer streams — honest hosts plus every adversary model
``fabric/hosts.py`` knows (bit-flipped powers, reordered rows, stale
template-bank epochs, echoed result files, deadline stalls, forged
quarantine gaps) — over references computed by the port's real search,
and holds the gates of the JAX package's ``tools/fabric_soak.py``:

* converged, with nothing FAILED or PENDING at exit;
* every granted workunit's candidate section byte-identical to the
  reference of its payload;
* no lied report credited valid, and every adversary that lied caught
  (rejected with a named reason, or timed out);
* replicas issued within ``--overhead`` x the ``wus x quorum`` floor;
* the ``erp-fleet-report/1`` rollup within ``FLEET_BASELINE.json``'s
  SLOs;
* every signed verdict, the run report and the rollup pass
  ``tools/report_check.py``.

``result_report:corrupt`` (honest payloads mutated in flight) and
``validate:exc`` (the validator crashing, recovered by the bounded retry
policy) are armed on top of the adversaries.

References: one ``python -m boinc_app_eah_brp_tpu_torch`` process per
payload (the default), or, with ``ERP_FABRIC_BACKEND=server``, one
resident ``FleetServer`` in this process (``fabric.ServerBackend``).
Both run on ``--device`` (``cuda`` by default: without a card the soak
raises; ``--device cpu`` runs the plain PyTorch versions on the host).

Usage:
    python -m boinc_app_eah_brp_tpu_torch.tools.fabric_soak [--device cpu]
    python -m boinc_app_eah_brp_tpu_torch.tools.fabric_soak --streams 16 --wus 8 --device cpu
    ERP_FABRIC_BACKEND=server python -m boinc_app_eah_brp_tpu_torch.tools.fabric_soak
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

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLEET_BASELINE = os.path.join(REPO, "FLEET_BASELINE.json")
FAULTS = "result_report:corrupt@p=0.02;validate:exc@n=3"


class SoakFailed(Exception):
    """A gate of the soak did not hold."""


def build_reference(work: str, name: str, *, f_signal: float, amp: float, device: str, server=None) -> bytes:
    """One payload class: a fixture workunit and bank, searched once by the
    port (unwhitened, with a checkpoint and rescoring: the defaults);
    returns the candidate-file bytes.  ``server`` (a
    ``fabric.ServerBackend``) runs it in this process, else a driver
    subprocess does, with the correlation id in ``ERP_CORR_ID``."""
    from ..runtime.driver import DriverArgs

    wu = _inputs.fixture_workunit(os.path.join(work, f"{name}.bin4"), f_signal=f_signal, amp=amp)
    bank = _inputs.fixture_bank(os.path.join(work, f"{name}.bank.dat"))
    out = os.path.join(work, f"{name}.ref.cand")
    cp = os.path.join(work, f"{name}.cpt")
    if server is not None:
        args = DriverArgs(
            inputfile=wu, outputfile=out, templatebank=bank, checkpointfile=cp,
            window=_inputs.WINDOW, batch_size=_inputs.BATCH, device=device,
        )
        return server.compute(args, corr_id=f"ref-{name}")
    cmd = _inputs.cli_cmd(
        wu, bank, out, cp, "-B", str(_inputs.WINDOW), "--batch", str(_inputs.BATCH), "--device", device
    )
    r = subprocess.run(cmd, env=_inputs.child_env(ERP_CORR_ID=f"ref-{name}"), capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-4000:])
        raise SoakFailed(f"reference search for {name} exited {r.returncode}")
    with open(out, "rb") as f:
        return f.read()


def build_fleet(streams: int, seed: int):
    """~2/3 honest hosts and the rest cycling every adversary kind (each
    kind at least once, twice from 36 streams).  The adversaries are
    spread evenly through the fleet, whose streams start in host order:
    placed last, they can find every replica of a small soak taken."""
    from .. import fabric as fb

    n_adv = max(len(fb.ADVERSARY_KINDS), streams // 3)
    kinds = ["honest"] * streams
    for j in range(n_adv):
        kinds[int((j + 0.5) * streams / n_adv)] = fb.ADVERSARY_KINDS[j % len(fb.ADVERSARY_KINDS)]
    return [
        fb.HostModel(host_id=i + 1, kind=k, seed=seed, date_iso=_inputs.RESULT_DATE)
        for i, k in enumerate(kinds)
    ]


def soak(
    work: str,
    refs: dict[str, bytes],
    *,
    t_obs: float,
    streams: int,
    n_wus: int,
    seed: int = 0,
    deadline_s: float = 3.0,
    overhead: float = 4.0,
    timeout_s: float = 600.0,
    baseline: str | None = FLEET_BASELINE,
    log=print,
) -> dict:
    """Run the fabric over ``refs`` (two payload classes, each the other's
    stale result) with the faults armed, then apply every gate; raises
    :class:`SoakFailed` on the first that fails.  Returns the fabric's
    summary, its wall, the fleet report and the counts the gates read.
    Verdicts are signed with ``ERP_QUORUM_KEY`` (a key for this run when
    unset, never the forgeable dev key)."""
    from .. import fabric as fb
    from ..io.results import split_result_sections
    from ..runtime import faultinject, metrics
    from . import fleet_report, report_check

    os.environ.setdefault("ERP_QUORUM_KEY", f"fabric-soak-{os.urandom(8).hex()}")
    payloads = sorted(refs)
    stale = {k: refs[payloads[(i + 1) % len(payloads)]] for i, k in enumerate(payloads)}
    metrics_file = os.path.join(work, "fabric-metrics.jsonl")
    metrics.configure(metrics_file=metrics_file, interval=0)
    faultinject.configure(f"{FAULTS};seed={seed + 7}")
    cfg = fb.FabricConfig(
        t_obs=t_obs, seed=seed, deadline_s=deadline_s, trust_after=3, spot_check_rate=0.1,
        spool_dir="spool", verdict_dir="verdicts", granted_dir="granted",
    )
    wus = [
        fb.WorkUnit(wu_id=f"wu{i:04d}", payload=payloads[i % len(payloads)], epoch=cfg.bank_epoch,
                    target=cfg.quorum)
        for i in range(n_wus)
    ]
    hosts = build_fleet(streams, seed)
    n_adv = sum(1 for h in hosts if h.kind != "honest")
    log(f"fabric-soak: {streams} streams ({n_adv} adversarial: {', '.join(fb.ADVERSARY_KINDS)}), "
        f"{n_wus} workunits, quorum {cfg.quorum}")
    fabric = fb.Fabric(cfg, wus, refs, work)
    t0 = time.perf_counter()
    try:
        converged = fb.run_streams(fabric, hosts, stale_references=stale, timeout_s=timeout_s)
    finally:
        wall = time.perf_counter() - t0
        report = metrics.finish("ok")
        faultinject.configure("")
    summary = fabric.summary()
    log(f"fabric-soak: {json.dumps(summary)} in {wall:.2f}s")

    if not converged:
        raise SoakFailed(f"fabric did not converge within {timeout_s}s")
    if summary["failed"] or summary["pending"] or summary["granted"] != n_wus:
        raise SoakFailed(
            f"starvation: {summary['granted']} granted, {summary['failed']} failed, "
            f"{summary['pending']} pending of {n_wus}"
        )
    ref_sections = {k: split_result_sections(v.decode("utf-8"))[1] for k, v in refs.items()}
    for wu in fabric.granted():
        with open(wu.granted_path, "rb") as f:
            _, got, done = split_result_sections(f.read().decode("utf-8"))
        if not done or got != ref_sections[wu.payload]:
            raise SoakFailed(f"{wu.wu_id}: granted candidates differ from the reference of payload {wu.payload}")
    lied_by_host = {h.host_id: h.lied_wus() for h in hosts}
    for wu in fabric.granted():
        for a in wu.assignments:
            if a.state == "valid" and wu.wu_id in lied_by_host.get(a.host_id, set()):
                raise SoakFailed(f"{wu.wu_id}: lying host {a.host_id} was credited valid")
    reps = fabric.reputation_snapshot()
    uncaught = [
        (h.host_id, h.kind) for h in hosts
        if h.kind != "honest" and h.lied_wus()
        and not (h.host_id in reps and (reps[h.host_id].total_invalid or reps[h.host_id].total_timeout))
    ]
    if uncaught:
        raise SoakFailed(f"adversaries never caught: {uncaught}")
    counters = {k: v.get("value", 0.0) for k, v in ((report or {}).get("metrics") or {}).get("counters", {}).items()}
    detected = counters.get("fabric.adversary_detected", 0.0)
    timeouts = counters.get("fabric.timeouts", 0.0)
    if n_adv and not (detected or timeouts):
        raise SoakFailed("adversaries present but nothing was ever rejected")
    reject_tags = sorted(k.split("fabric.reject.", 1)[1] for k in counters if k.startswith("fabric.reject."))
    log(f"fabric-soak: {detected:.0f} bad replicas rejected, {timeouts:.0f} timeouts; "
        f"reject reasons: {', '.join(reject_tags)}")
    ratio = summary["replicas_issued"] / max(1, n_wus * cfg.quorum)
    if ratio > overhead:
        raise SoakFailed(f"re-issue overhead {ratio:.2f}x exceeds {overhead:.1f}x")

    lifecycle = fabric.export_lifecycle(os.path.join(work, "fabric-lifecycle.json"))
    fleet = fleet_report.build_report(lifecycle, os.path.join(work, "verdicts"), metrics_path=metrics_file)
    errs = fleet_report.validate_fleet_report(fleet)
    if errs:
        raise SoakFailed(f"fleet report invalid: {errs[:3]}")
    fleet_path = os.path.join(work, "fabric-fleet.json")
    with open(fleet_path, "w", encoding="utf-8") as f:
        json.dump(fleet, f, indent=1, sort_keys=True)
        f.write("\n")
    if baseline:
        with open(baseline, encoding="utf-8") as f:
            slo_errs = fleet_report.evaluate_slo(fleet, json.load(f))
        if slo_errs:
            raise SoakFailed(f"fleet report violates {os.path.basename(baseline)}: {slo_errs}")
        log(f"fabric-soak: fleet report within {os.path.basename(baseline)} SLOs")
    log(fleet_report.render(fleet))
    verdicts = sorted(glob.glob(os.path.join(work, "verdicts", "*.quorum.json")))
    if not verdicts:
        raise SoakFailed("no erp-quorum/1 verdict artifacts written")
    for path in verdicts + [metrics_file, fleet_path]:
        schema, problems = report_check.check_path(path)
        if problems:
            raise SoakFailed(f"{os.path.basename(path)} fails its {schema} check: {problems[:3]}")
    log(f"fabric-soak: {len(verdicts)} signed verdicts, the run report and the rollup pass report_check")
    return dict(
        summary=summary, wall_s=wall, fleet=fleet, verdicts=len(verdicts), overhead=ratio,
        adversary_detected=detected, timeouts=timeouts, reject_tags=reject_tags,
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Adversarial volunteer-fabric soak over the port's search.")
    ap.add_argument("--streams", type=int, default=64, help="concurrent volunteer streams (default 64)")
    ap.add_argument("--wus", type=int, default=0, help="workunits (default: streams // 2, min 16)")
    ap.add_argument("--overhead", type=float, default=4.0, help="max replicas-issued / (wus * quorum)")
    ap.add_argument("--deadline", type=float, default=3.0, help="per-assignment report deadline (s)")
    ap.add_argument("--timeout", type=float, default=600.0, help="whole-soak convergence timeout (s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="where the references run: cuda (default) or cpu")
    ap.add_argument("--workdir", help="reuse this dir instead of a tmp one")
    ap.add_argument("--keep", action="store_true", help="keep the workdir (default: removed when green)")
    args = ap.parse_args(argv)

    from .. import fabric as fb

    device = _inputs.require_device(args.device)
    n_wus = args.wus or max(16, args.streams // 2)
    work = args.workdir or tempfile.mkdtemp(prefix="erp-fabric-")
    os.makedirs(work, exist_ok=True)
    print(f"fabric-soak: workdir {work}")
    os.environ["ERP_RESULT_DATE"] = _inputs.RESULT_DATE
    os.environ.setdefault("ERP_QUORUM_KEY", f"fabric-soak-{os.urandom(8).hex()}")

    server = None
    if fb.compute_backend() == "server":
        server = fb.ServerBackend(name="fabric-ref", device=device)
        print("fabric-soak: compute backend = server (in-process fleet tier)")
    t0 = time.monotonic()
    try:
        refs = {
            "A": build_reference(work, "payloadA", f_signal=33.0, amp=7.0, device=device, server=server),
            "B": build_reference(work, "payloadB", f_signal=41.0, amp=6.0, device=device, server=server),
        }
    except SoakFailed as e:
        print(f"fabric-soak: FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        if server is not None:
            print(f"fabric-soak: server backend {json.dumps(server.stats())}")
            server.close()
    print(f"fabric-soak: references built in {time.monotonic() - t0:.1f}s "
          f"({', '.join(f'{k}:{len(v)}B' for k, v in sorted(refs.items()))})")
    try:
        out = soak(
            work, refs, t_obs=_inputs.T_OBS, streams=args.streams, n_wus=n_wus, seed=args.seed,
            deadline_s=args.deadline, overhead=args.overhead, timeout_s=args.timeout,
        )
    except SoakFailed as e:
        print(f"fabric-soak: FAIL: {e}", file=sys.stderr)
        return 1
    s = out["summary"]
    print(f"fabric-soak: PASS ({args.streams} streams, {n_wus} WUs, {s['quorum1_grants']} quorum-1 grants, "
          f"{s['hosts_demoted']} hosts demoted, replica overhead {out['overhead']:.2f}x, 0 false grants)")
    if not args.keep and args.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
