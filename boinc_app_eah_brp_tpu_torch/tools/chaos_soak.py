"""Kill/resume chaos soak: the crash contract of the port's command line.

A volunteer host may kill the search at any template, and the resumed
run must write the same candidate file.  The twin of the JAX package's
``tools/chaos_soak.py``, in three modes, each against real
``python -m boinc_app_eah_brp_tpu_torch`` processes on ``--device``
(``cuda`` by default; ``cpu`` runs the plain PyTorch versions):

* **kill/resume** (default): an uninterrupted run gives the reference
  file; then the same workunit runs under a kill schedule — wait for a
  fresh checkpoint, SIGKILL or SIGTERM, resume, repeat — with
  ``ckpt_write:eio`` faults armed; once a backup generation exists the
  live checkpoint is corrupted in place and the next resume must fall
  back to ``<cp>.1``; a last clean run must write a file byte-identical
  to the reference;
* **host loss** (``--hosts N --kill-host k``): N processes of one elastic
  search (``parallel/elastic.py``, the lease board of
  ``runtime/resilience.py``), on the CPU each with ``ERP_LOCAL_DEVICES=2``
  logical shards, on a card all on ``cuda:0``; process k is SIGKILLed
  right after its first mid-shard commit; the survivors must adopt its
  shard (``resilience.rebalance`` >= 1) and exactly one writes a file
  byte-identical to a one-process run;
* **hangs** (``--hang``): wedges planted at dispatch (A), on a poison
  template (B) and at lease IO and the merge of a two-process elastic run
  (C) must end in supervised restarts (rc 99, ``runtime/supervise.py``)
  or a quarantine, with the reference's bytes (A, C) or a named gap (B).

The kernels build once into ``boinc_app_eah_brp_tpu_torch/build/`` and
every later process loads them.

Usage:
    python -m boinc_app_eah_brp_tpu_torch.tools.chaos_soak --quick [--device cpu]
    python -m boinc_app_eah_brp_tpu_torch.tools.chaos_soak --hosts 3 --kill-host 1 --device cpu
    python -m boinc_app_eah_brp_tpu_torch.tools.chaos_soak --hang --device cpu
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from ..io import TemplateBank, write_template_bank
from . import _inputs

FALLBACK_MARKER = "Resuming from previous checkpoint generation"
RESUME_RE = re.compile(r"Continuing work on .* at template no\. (\d+)")


class SoakFailed(Exception):
    """A gate of the soak did not hold."""


def log(msg: str) -> None:
    print(f"chaos: {msg}", flush=True)


def build_inputs(work: str, n_templates: int, seed: int) -> tuple[str, str]:
    """A fixture workunit and a bank of ``n_templates`` (the null template,
    the injected orbit, then random orbits from ``seed``): big enough that
    the kill schedule lands many checkpoints before a run can finish."""
    wu = _inputs.fixture_workunit(os.path.join(work, "chaos.bin4"), f_signal=33.0)
    rng = np.random.default_rng(seed)
    P = np.concatenate([[1000.0, 2.2], rng.uniform(1.5, 3.5, n_templates - 2)])
    tau = np.concatenate([[0.0, 0.04], rng.uniform(0.01, 0.08, n_templates - 2)])
    psi = np.concatenate([[0.0, 1.2], rng.uniform(0.0, 2 * np.pi, n_templates - 2)])
    bank = os.path.join(work, "bank.dat")
    write_template_bank(bank, TemplateBank(P, tau, psi))
    return wu, bank


def child_env(fault_spec: str | None = None, **extra: str) -> dict:
    """A search process's environment: a checkpoint after every batch, the
    result date pinned, a retry budget that outlasts the EIO faults."""
    env = _inputs.child_env(
        ERP_CHECKPOINT_PERIOD="0", ERP_RETRY_BUDGET="16", ERP_RETRY_BASE_S="0.01", ERP_RESIL_SNAPSHOT_S="0",
        **extra,
    )
    env.pop("ERP_FAULT_SPEC", None)
    if fault_spec:
        env["ERP_FAULT_SPEC"] = fault_spec
    return env


def search_cmd(wu: str, bank: str, device: str):
    """``make_cmd(out, cp)`` for the fixture workunit: one process, one
    shard (``--mesh 1``), batch 2."""
    def make(out: str, cp: str) -> list[str]:
        return _inputs.cli_cmd(wu, bank, out, cp, "-B", str(_inputs.WINDOW), "--batch", "2", "--mesh", "1",
                               "--device", device)
    return make


def launch(cmd: list[str], env: dict, log_path: str) -> subprocess.Popen:
    with open(log_path, "w") as logf:
        return subprocess.Popen(cmd, env=env, stdout=logf, stderr=subprocess.STDOUT, cwd=os.path.dirname(log_path))


def run_to_completion(cmd: list[str], env: dict, log_path: str, timeout_s: float) -> int:
    with open(log_path, "w") as logf:
        return subprocess.run(cmd, env=env, stdout=logf, stderr=subprocess.STDOUT, cwd=os.path.dirname(log_path),
                              timeout=timeout_s).returncode


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def describe_result_mismatch(ref_path: str, got_path: str) -> str:
    """Candidate-level context for a failed byte-identity gate."""
    from ..io.results import parse_result

    try:
        ref, got = parse_result(ref_path), parse_result(got_path)
    except (OSError, ValueError) as exc:
        return f"(result unparseable: {exc})"
    bits = [f"candidates {len(ref.candidates)} vs {len(got.candidates)}", f"done {ref.done} vs {got.done}"]
    rq = ref.header.quarantined if ref.header else []
    gq = got.header.quarantined if got.header else []
    if rq != gq:
        bits.append(f"quarantine gaps {rq} vs {gq}")
    for i in range(min(len(ref.candidates), len(got.candidates))):
        if ref.candidates[i] != got.candidates[i]:
            bits.append(f"first differing candidate: line {i}")
            break
    return "; ".join(bits)


def checkpoint_stamp(cp: str) -> int:
    try:
        return os.stat(cp).st_mtime_ns
    except OSError:
        return 0


def read_cp_n(cp: str) -> int | None:
    """n_template of the live checkpoint, or None while it is missing or
    torn (a read can race the writer's rename)."""
    from ..io.checkpoint import read_checkpoint

    try:
        return read_checkpoint(cp).n_template
    except Exception:  # noqa: BLE001 - any unreadable state means "not yet"
        return None


def wait_for_fresh_checkpoint(proc: subprocess.Popen, cp: str, stamp0: int, timeout_s: float) -> str:
    """Until the process writes a NEW readable checkpoint ("advanced"),
    exits ("exited"), or the time runs out ("timeout")."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if checkpoint_stamp(cp) != stamp0 and read_cp_n(cp) is not None:
            return "advanced"
        if proc.poll() is not None:
            return "exited"
        time.sleep(0.05)
    return "timeout"


def corrupt_checkpoint(cp: str) -> None:
    """Flip 64 bytes in the middle of the live generation: its audit digest
    must reject it and the resume fall back to ``<cp>.1``."""
    size = os.path.getsize(cp)
    with open(cp, "r+b") as f:
        f.seek(size // 2)
        chunk = bytearray(f.read(64))
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk))


def _resumed_at(log_path: str) -> int | None:
    m = RESUME_RE.search(_tail(log_path, 1 << 20))
    return int(m.group(1)) if m else None


def _reference(work: str, make_cmd, timeout_s: float) -> tuple[bytes, str, float]:
    ref_out, ref_cp = os.path.join(work, "ref.cand"), os.path.join(work, "ref.cpt")
    log_path = os.path.join(work, "run-ref.log")
    t0 = time.perf_counter()
    rc = run_to_completion(make_cmd(ref_out, ref_cp), child_env(), log_path, timeout_s)
    wall = time.perf_counter() - t0
    if rc != 0 or not os.path.exists(ref_out):
        sys.stderr.write(_tail(log_path))
        raise SoakFailed(f"reference run exited {rc}")
    with open(ref_out, "rb") as f:
        return f.read(), ref_out, wall


def kill_resume(work: str, make_cmd, *, cycles: int, seed: int, timeout_s: float) -> dict:
    """The kill/resume soak of ``make_cmd(out, cp)``'s search; raises
    :class:`SoakFailed` on a miss.  Returns the reference's wall, every
    run (its signal, wall, the template it resumed at and the checkpoint
    it was killed at), the final run, and whether the corrupt-generation
    fallback was exercised."""
    ref_bytes, ref_out, ref_wall = _reference(work, make_cmd, timeout_s * 2)
    log(f"reference run done in {ref_wall:.1f}s ({len(ref_bytes)} result bytes)")
    out, cp = os.path.join(work, "chaos.cand"), os.path.join(work, "chaos.cpt")
    runs: list[dict] = []
    corrupted = fallback_seen = False
    run_no = 0
    while len(runs) < cycles:
        run_no += 1
        log_path = os.path.join(work, f"run-{run_no:02d}.log")
        stamp0 = checkpoint_stamp(cp)
        t0 = time.perf_counter()
        proc = launch(make_cmd(out, cp), child_env(f"ckpt_write:eio@p=0.1;seed={seed + run_no}"), log_path)
        try:
            state = wait_for_fresh_checkpoint(proc, cp, stamp0, timeout_s)
            if state == "timeout":
                raise SoakFailed(f"run {run_no} never wrote a fresh checkpoint: {_tail(log_path)}")
            if state == "exited":
                if proc.returncode != 0:
                    raise SoakFailed(f"run {run_no} exited {proc.returncode} before the kill: {_tail(log_path)}")
                if os.path.exists(out):
                    # finished the whole workunit between kills: start over
                    log(f"run {run_no} completed early; resetting state")
                    for p in glob.glob(glob.escape(cp) + "*") + [out]:
                        os.remove(p)
                continue
            sig = signal.SIGKILL if len(runs) % 2 == 0 else signal.SIGTERM
            proc.send_signal(sig)
            try:
                proc.wait(timeout=120)
            except subprocess.TimeoutExpired as e:
                raise SoakFailed(f"run {run_no} ignored {sig.name} for 120s") from e
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        run = dict(run=run_no, signal=sig.name, wall_s=time.perf_counter() - t0,
                   resumed_at=_resumed_at(log_path), killed_at=read_cp_n(cp))
        runs.append(run)
        log(f"cycle {len(runs)}/{cycles}: run {run_no} (resumed at {run['resumed_at']}) killed with {sig.name} "
            f"at checkpoint n_template={run['killed_at']} after {run['wall_s']:.2f}s")
        if FALLBACK_MARKER in _tail(log_path, 1 << 20):
            fallback_seen = True
            log(f"generation fallback observed in run {run_no}")
        # once a backup generation exists, corrupt the live one once: the
        # next resume must come back through <cp>.1
        if not corrupted and len(runs) >= 2 and os.path.exists(cp + ".1"):
            corrupt_checkpoint(cp)
            corrupted = True
            log("corrupted the live checkpoint generation in place")

    log_path = os.path.join(work, "run-final.log")
    t0 = time.perf_counter()
    rc = run_to_completion(make_cmd(out, cp), child_env(), log_path, timeout_s * 2)
    final = dict(wall_s=time.perf_counter() - t0, resumed_at=_resumed_at(log_path))
    if rc != 0 or not os.path.exists(out):
        raise SoakFailed(f"final resumed run exited {rc}: {_tail(log_path)}")
    if FALLBACK_MARKER in _tail(log_path, 1 << 20):
        fallback_seen = True
        log("generation fallback observed in the final run")
    if corrupted and not fallback_seen:
        raise SoakFailed("the live checkpoint was corrupted but no resume fell back to the previous generation")
    with open(out, "rb") as f:
        got = f.read()
    if got != ref_bytes:
        raise SoakFailed(f"final result differs from the uninterrupted reference ({len(got)} vs {len(ref_bytes)} "
                         f"bytes): {describe_result_mismatch(ref_out, out)}")
    log(f"PASS: {len(runs)} kill/resume cycles, corrupt-generation fallback "
        f"{'exercised' if corrupted else 'not reached'}, result byte-identical")
    return dict(reference_wall_s=ref_wall, runs=runs, final=final, corrupted=corrupted,
                fallback_seen=fallback_seen, result_bytes=len(got))


# ---------------------------------------------------------------------------
# host loss


def _stream_docs(path: str) -> list[dict]:
    docs = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                try:
                    docs.append(json.loads(line))
                except ValueError:
                    pass
    except OSError:
        pass
    return [d for d in docs if isinstance(d, dict)]


def report_counter(metrics_path: str, name: str) -> float:
    """Counter ``name`` of the run report a metrics stream carries (0.0
    when absent)."""
    value = 0.0
    for doc in _stream_docs(metrics_path):
        if doc.get("kind") == "run_report" and isinstance(doc.get("report"), dict):
            c = (doc["report"].get("metrics") or {}).get("counters") or {}
            value = float((c.get(name) or {}).get("value", 0.0))
    return value


def stream_counter(metrics_path: str, name: str) -> float:
    """The largest value of counter ``name`` anywhere in the stream,
    heartbeats included: a watchdog's hard exit ships its counters in an
    emergency heartbeat, and the run report in the same file belongs to
    the final clean pass."""
    best = 0.0
    for doc in _stream_docs(metrics_path):
        m = doc.get("metrics") if doc.get("kind") == "heartbeat" else (doc.get("report") or {}).get("metrics")
        c = (m or {}).get("counters") or {}
        if name in c:
            best = max(best, float(c[name].get("value", 0.0)))
    return best


def host_env(work: str, hosts: int, host_id: int, shard_dir: str, device: str) -> dict:
    """One process of an elastic search: its identity, the board, leases
    that expire in 2 s, a commit at every batch; on the CPU two logical
    shards a process."""
    env = child_env(
        ERP_NUM_PROCESSES=str(hosts), ERP_PROCESS_ID=str(host_id), ERP_SHARD_DIR=shard_dir,
        ERP_LEASE_TIMEOUT_S="2", ERP_LEASE_GRACE_S="30", ERP_SHARD_COMMIT_S="0",
        ERP_METRICS_FILE=os.path.join(work, f"metrics-host{host_id}.jsonl"),
        ERP_TRACE_FILE=os.path.join(work, f"trace-host{host_id}.jsonl"),
    )
    if device == "cpu":
        env["ERP_LOCAL_DEVICES"] = "2"
    return env


def hosts_cmd(wu: str, bank: str, device: str):
    """No ``--mesh`` (each process takes its devices), batch 1: every shard
    spans many commits, so the kill lands on committed mid-shard progress."""
    def make(out: str, cp: str) -> list[str]:
        return _inputs.cli_cmd(wu, bank, out, cp, "-B", str(_inputs.WINDOW), "--batch", "1", "--device", device)
    return make


def wait_for_shard_commit(shard_dir: str, shard: int, proc: subprocess.Popen, timeout_s: float) -> str:
    """Until ``lease-<shard>.json`` records committed progress strictly
    inside its range ("committed"), its owner exits ("exited"), or the
    time runs out ("timeout")."""
    path = os.path.join(shard_dir, f"lease-{shard}.json")
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            if not doc.get("complete") and doc.get("state_path") and int(doc.get("n_done", 0)) > int(doc.get("start", 0)):
                return "committed"
        except (OSError, ValueError):
            pass
        if proc.poll() is not None:
            return "exited"
        time.sleep(0.01)
    return "timeout"


def _single_writer(work: str, prefix: str, hosts) -> str:
    written = [os.path.join(work, f"{prefix}{h}.cand") for h in hosts
               if os.path.exists(os.path.join(work, f"{prefix}{h}.cand"))]
    if len(written) != 1:
        raise SoakFailed(f"{len(written)} processes wrote a result file, not exactly one")
    return written[0]


def run_hosts(work: str, wu: str, bank: str, *, hosts: int, victim: int, device: str, timeout_s: float) -> dict:
    if not 0 <= victim < hosts:
        raise SoakFailed(f"--kill-host {victim} out of range for --hosts {hosts}")
    ref_bytes, ref_out, ref_wall = _reference(work, search_cmd(wu, bank, device), timeout_s * 2)
    log(f"reference run done in {ref_wall:.1f}s ({len(ref_bytes)} result bytes)")
    shard_dir = os.path.join(work, "shards")
    os.makedirs(shard_dir, exist_ok=True)
    make = hosts_cmd(wu, bank, device)
    procs: dict[int, subprocess.Popen] = {}
    try:
        for h in range(hosts):
            procs[h] = launch(make(os.path.join(work, f"elastic{h}.cand"), os.path.join(work, f"elastic{h}.cpt")),
                              host_env(work, hosts, h, shard_dir, device), os.path.join(work, f"run-host{h}.log"))
        state = wait_for_shard_commit(shard_dir, victim, procs[victim], timeout_s)
        if state != "committed":
            raise SoakFailed(f"host {victim} {state} before its first mid-shard commit "
                             f"(rc {procs[victim].returncode})")
        procs[victim].send_signal(signal.SIGKILL)
        procs[victim].wait()
        log(f"host {victim} SIGKILLed after its first mid-shard commit")
        deadline = time.monotonic() + timeout_s * 2
        for h in procs:
            if h == victim:
                continue
            try:
                rc = procs[h].wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired as e:
                raise SoakFailed(f"surviving host {h} still running at the deadline") from e
            if rc != 0:
                raise SoakFailed(f"surviving host {h} exited {rc}: {_tail(os.path.join(work, f'run-host{h}.log'))}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out = _single_writer(work, "elastic", [h for h in range(hosts) if h != victim])
    with open(out, "rb") as f:
        got = f.read()
    if got != ref_bytes:
        raise SoakFailed(f"elastic result differs from the one-process reference: "
                         f"{describe_result_mismatch(ref_out, out)}")
    metrics_files = [os.path.join(work, f"metrics-host{h}.jsonl") for h in range(hosts)]
    rebalances = sum(report_counter(m, "resilience.rebalance") for m in metrics_files)
    lost = sum(report_counter(m, "resilience.host_lost") for m in metrics_files)
    if rebalances < 1:
        raise SoakFailed("no surviving host recorded resilience.rebalance: the dead host's shard was never adopted")
    log(f"PASS: host {victim} of {hosts} killed mid-shard; {int(rebalances)} rebalance / {int(lost)} host-lost "
        "events; result byte-identical to the one-process reference")
    return dict(rebalances=rebalances, host_lost=lost, writer=os.path.basename(out))


# ---------------------------------------------------------------------------
# hangs


def hang_env(spec: str, *, watchdog_spec: str, fault_state: str | None = None, metrics_path: str | None = None,
             quarantine_k: int | None = None, base: dict | None = None) -> dict:
    """Short per-stage deadlines, a short grace before the hard exit (rc
    99), and a hang that only the watchdog ends."""
    env = dict(base) if base is not None else child_env()
    env.update(ERP_FAULT_SPEC=spec, ERP_FAULT_HANG_S="3600", ERP_WATCHDOG_SPEC=watchdog_spec,
               ERP_WATCHDOG_GRACE_S="2")
    env.pop("ERP_FAULT_STATE", None)
    if fault_state:
        env["ERP_FAULT_STATE"] = fault_state
    if metrics_path:
        env["ERP_METRICS_FILE"] = metrics_path
    if quarantine_k is not None:
        env["ERP_QUARANTINE_K"] = str(quarantine_k)
    return env


def supervised_run(cmd: list[str], env: dict, work: str, tag: str, max_restarts: int,
                   timeout_s: float) -> tuple[int, list[int]]:
    """``cmd`` under ``runtime/supervise.py``'s loop, one log a pass, no
    backoff; (final rc, each pass's rc).  A wedge the watchdog misses
    trips the pass's time limit and raises."""
    from ..runtime.supervise import run_supervised

    rcs: list[int] = []

    def runner(c, e):
        rc = run_to_completion(c, e, os.path.join(work, f"{tag}-pass{len(rcs):02d}.log"), timeout_s)
        rcs.append(rc)
        return rc

    return run_supervised(cmd, env=env, max_restarts=max_restarts, sleep=lambda s: None, runner=runner), rcs


def _pass_logs(work: str, tag: str) -> str:
    return "".join(f"--- {os.path.basename(p)} ---\n{_tail(p, 3000)}"
                   for p in sorted(glob.glob(os.path.join(work, f"{tag}-pass*.log"))))


def run_hang(work: str, wu: str, bank: str, *, templates: int, seed: int, device: str, timeout_s: float) -> dict:
    from ..io.results import parse_result
    from ..runtime.watchdog import validate_incident_log

    make = search_cmd(wu, bank, device)
    ref_bytes, _, ref_wall = _reference(work, make, timeout_s * 2)
    log(f"reference run done in {ref_wall:.1f}s")
    out = {}

    # A: a dispatch wedge, once across all passes (the state file), ends in
    # a supervised restart and the reference's bytes
    cand, cp = os.path.join(work, "hangA.cand"), os.path.join(work, "hangA.cpt")
    env = hang_env(f"dispatch:hang@n=4;seed={seed}", watchdog_spec="dispatch=6",
                   fault_state=os.path.join(work, "hangA-fault-state.json"),
                   metrics_path=os.path.join(work, "hangA-metrics.jsonl"))
    final, rcs = supervised_run(make(cand, cp), env, work, "hangA", 3, timeout_s)
    if final != 0 or not os.path.exists(cand):
        raise SoakFailed(f"phase A: supervised run ended rc={final} (passes {rcs})\n{_pass_logs(work, 'hangA')}")
    if rcs.count(99) < 1:
        raise SoakFailed(f"phase A: no watchdog temporary exit observed ({rcs})")
    with open(cand, "rb") as f:
        if f.read() != ref_bytes:
            raise SoakFailed("phase A: result differs from the reference after a dispatch wedge and a restart")
    with open(cp + ".incidents.json") as f:
        n_dispatch = sum(1 for r in json.load(f)["incidents"] if r["stage"] == "dispatch")
    if n_dispatch < 1:
        raise SoakFailed("phase A: no dispatch incident recorded")
    log(f"phase A PASS: dispatch wedge -> {rcs.count(99)} supervised restart(s), byte-identical result")
    out["A"] = dict(passes=rcs, incidents=n_dispatch)

    # B: a poison template wedges on every visit until K incidents
    # quarantine its window; the run then completes with the gap named
    poison = (templates // 2) & ~1  # even: batch windows stay aligned
    cand, cp = os.path.join(work, "hangB.cand"), os.path.join(work, "hangB.cpt")
    metrics_b = os.path.join(work, "hangB-metrics.jsonl")
    env = hang_env(f"dispatch:hang@tmpl={poison};seed={seed}", watchdog_spec="dispatch=6",
                   metrics_path=metrics_b, quarantine_k=2)
    final, rcs = supervised_run(make(cand, cp), env, work, "hangB", 4, timeout_s)
    if final != 0 or not os.path.exists(cand):
        raise SoakFailed(f"phase B: supervised run ended rc={final} (passes {rcs})\n{_pass_logs(work, 'hangB')}")
    if rcs.count(99) < 2:
        raise SoakFailed(f"phase B: expected >= 2 wedged passes before the quarantine ({rcs})")
    parsed = parse_result(cand)
    if parsed.header is None or not parsed.header.quarantined or not parsed.done:
        raise SoakFailed("phase B: the result does not name the quarantine gap, or lacks %DONE%")
    quarantined = report_counter(metrics_b, "resilience.quarantined")
    if quarantined < 1:
        raise SoakFailed("phase B: resilience.quarantined not recorded")
    with open(cp + ".incidents.json") as f:
        problems = validate_incident_log(json.load(f))
    if problems:
        raise SoakFailed(f"phase B: incident log invalid: {problems}")
    log(f"phase B PASS: template {poison} wedged {rcs.count(99)}x, quarantined, run completed with a named gap")
    out["B"] = dict(passes=rcs, poison=poison, gaps=parsed.header.quarantined)

    # C: two elastic processes: a lease-IO wedge on process 0 (self-fence,
    # restart) and a merge wedge on whichever wins the merge
    hosts = 2
    shard_dir = os.path.join(work, "hang-shards")
    os.makedirs(shard_dir, exist_ok=True)
    hmake = hosts_cmd(wu, bank, device)
    specs = [f"lease_io:hang@n=2;merge:hang@n=1;seed={seed}", f"merge:hang@n=1;seed={seed + 1}"]
    results: dict[int, tuple[int, list[int]]] = {}
    errors: list[str] = []

    def run_host(h: int) -> None:
        env = hang_env(specs[h], watchdog_spec="lease_io=3,merge=6",
                       fault_state=os.path.join(work, f"hangC-state-h{h}.json"),
                       metrics_path=os.path.join(work, f"hangC-metrics-h{h}.jsonl"),
                       base=host_env(work, hosts, h, shard_dir, device))
        try:
            results[h] = supervised_run(
                hmake(os.path.join(work, f"hangC{h}.cand"), os.path.join(work, f"hangC{h}.cpt")),
                env, work, f"hangC-h{h}", 4, timeout_s,
            )
        except Exception as e:  # noqa: BLE001 - a pass time-out means the watchdog missed a wedge
            errors.append(f"host {h}: {e!r}")

    threads = [threading.Thread(target=run_host, args=(h,)) for h in range(hosts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise SoakFailed(f"phase C: {'; '.join(errors)}")
    for h, (final, rcs) in sorted(results.items()):
        if final != 0:
            raise SoakFailed(f"phase C: host {h} ended rc={final} (passes {rcs})\n{_pass_logs(work, f'hangC-h{h}')}")
    cand = _single_writer(work, "hangC", range(hosts))
    with open(cand, "rb") as f:
        if f.read() != ref_bytes:
            raise SoakFailed("phase C: the elastic result differs from the reference after lease and merge wedges")
    restarts = sum(rcs.count(99) for _, rcs in results.values())
    if restarts < 2:
        raise SoakFailed(f"phase C: expected >= 2 watchdog restarts (lease wedge + merge wedge), saw {restarts}")
    fenced = sum(stream_counter(os.path.join(work, f"hangC-metrics-h{h}.jsonl"), "watchdog.self_fenced")
                 for h in range(hosts))
    if fenced < 1:
        raise SoakFailed("phase C: the lease wedge never triggered a self-fence")
    log(f"phase C PASS: {restarts} watchdog restarts across {hosts} processes ({int(fenced)} self-fence), "
        "result byte-identical")
    out["C"] = dict(passes={h: rcs for h, (_, rcs) in results.items()}, self_fenced=fenced)
    log("PASS: dispatch, poison-template, lease and merge wedges all ended in bounded-time recoveries")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Kill/resume, host-loss and hang soaks of the port's command line.")
    ap.add_argument("--cycles", type=int, default=8, help="kill/resume cycles to run (default 8)")
    ap.add_argument("--quick", action="store_true", help="5 cycles")
    ap.add_argument("--templates", type=int, default=40, help="template bank size (default 40)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--timeout", type=float, default=300.0, help="per-wait timeout in seconds")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--workdir", help="reuse this dir instead of a tmp one")
    ap.add_argument("--keep", action="store_true", help="keep the workdir (default: removed on PASS)")
    ap.add_argument("--hosts", type=int, default=0,
                    help="host-loss mode: N elastic processes, one killed mid-run (0 = kill/resume)")
    ap.add_argument("--kill-host", type=int, default=1, help="which process to SIGKILL (--hosts mode)")
    ap.add_argument("--hang", action="store_true",
                    help="hang mode: planted wedges must end in supervised restarts or a quarantine")
    args = ap.parse_args(argv)

    device = _inputs.require_device(args.device)
    work = args.workdir or tempfile.mkdtemp(prefix="erp-chaos-")
    os.makedirs(work, exist_ok=True)
    log(f"workdir {work}")
    n_templates = max(args.templates, 16 * args.hosts)
    wu, bank = build_inputs(work, n_templates, args.seed)
    try:
        if args.hang:
            run_hang(work, wu, bank, templates=n_templates, seed=args.seed, device=device, timeout_s=args.timeout)
        elif args.hosts:
            run_hosts(work, wu, bank, hosts=args.hosts, victim=args.kill_host, device=device,
                      timeout_s=args.timeout)
        else:
            kill_resume(work, search_cmd(wu, bank, device), cycles=5 if args.quick else args.cycles,
                        seed=args.seed, timeout_s=args.timeout)
    except SoakFailed as e:
        print(f"chaos: FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    if not args.keep and args.workdir is None:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
