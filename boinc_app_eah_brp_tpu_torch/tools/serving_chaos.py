"""Serving chaos soak: SIGKILL the resident server mid-queue and prove
nothing is lost.

The twin of the JAX package's ``tools/serving_chaos.py`` for the port's
``FleetServer`` (``serving/server.py``, ``serving/journal.py``).  One run
drives a real server subprocess (this module with ``--serve``) through
three injuries and four gates:

1. **Kill + journal EIO** (phase A): the server accepts every workunit
   into its journal while ``journal_write:eio`` faults hit the appends;
   it is SIGKILLed as soon as the first grant lands, work still queued.
2. **Wedge + supervised restart** (phase B): relaunched with
   ``--supervised``, it replays the journal; a planted
   ``serving_dispatch:hang`` wedges the dispatch thread, the watchdog's
   ``serving_dispatch`` deadline turns the stall into rc 99, and the
   supervisor restarts the server into another replay, which finishes
   every workunit.
3. **Gates**: every result file byte-identical to the one-process command
   line's; the final pass with 0 recompiles after its warm resume (no
   kernel build, no new cuFFT plan) and ``resumed_wus >= 1``; the
   journal snapshot taken after the kill and the final journal pass
   ``tools/report_check.py``.
4. **Overload** (:func:`shed_check`): a bounded queue, in-process over a
   stub scheduler, sheds with a retry-after, ``/healthz`` answers 503
   with a ``Retry-After`` header while it sheds, and every accepted
   workunit is granted.

Usage:
    python -m boinc_app_eah_brp_tpu_torch.tools.serving_chaos --quick [--device cpu]
    python -m boinc_app_eah_brp_tpu_torch.tools.serving_chaos --serve --workdir DIR --device cpu   # the server
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types

from . import _inputs

MODULE = "boinc_app_eah_brp_tpu_torch.tools.serving_chaos"
MANIFEST = "manifest.json"
STATS = "serving-stats.json"
SERVE_TIMEOUT_S = 600


def log(msg: str) -> None:
    print(f"serving-chaos: {msg}", flush=True)


def fail(msg: str) -> int:
    print(f"serving-chaos: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def serve_env(work: str, fault_spec: str | None, state_name: str, extra: dict | None = None) -> dict:
    """The server's environment: a checkpoint every batch, the result date
    pinned, a retry budget, the fault schedule with its state file."""
    env = _inputs.child_env(
        ERP_CHECKPOINT_PERIOD="0", ERP_RETRY_BUDGET="16", ERP_RETRY_BASE_S="0.01", ERP_RESIL_SNAPSHOT_S="0",
    )
    env.pop("ERP_FAULT_SPEC", None)
    env.pop("ERP_SLO_FILE", None)
    if fault_spec:
        env["ERP_FAULT_SPEC"] = fault_spec
        env["ERP_FAULT_STATE"] = os.path.join(work, state_name)
    env.update(extra or {})
    return env


def serve_cmd(work: str, device: str, supervised: int | None = None) -> list[str]:
    cmd = [sys.executable, "-m", MODULE, "--serve", "--workdir", work, "--device", device]
    if supervised is not None:
        cmd += ["--supervised", str(supervised)]
    return cmd


# ---------------------------------------------------------------------------
# the server process


def serve(work: str, device: str) -> int:
    """A durable FleetServer over the manifest: replay the journal, submit
    what was never accepted, wait for every ticket, write the scoreboard."""
    from ..runtime.driver import DriverArgs
    from ..serving import FleetServer, journal_path, replay
    from .fleet_bench import warm_spec_for

    with open(os.path.join(work, MANIFEST), encoding="utf-8") as f:
        manifest = json.load(f)
    known = {f.name for f in dataclasses.fields(DriverArgs)}
    args_list = [DriverArgs(**{k: v for k, v in m.items() if k in known}) for m in manifest]
    state = replay(journal_path(work))
    accepted = {(r.get("args") or {}).get("outputfile") for r in state.submits.values()}
    replayed = [r["ticket"] for r in state.pending]
    # warmed like fleet_bench: the first workunit of every pass, the
    # resume after the crash included, runs on a warmed step
    server = FleetServer(resume_dir=work, warm_specs=[warm_spec_for(args_list[0])], name="chaos", device=device)
    try:
        new = [server.submit(a, corr_id=f"chaos-{i}") for i, a in enumerate(args_list) if a.outputfile not in accepted]
        log(f"serve pid={os.getpid()}: replayed {len(replayed)}, submitted {len(new)} new")
        bad = [f"{t}:{r.code}" for t in replayed + new if not (r := server.result(t, timeout=SERVE_TIMEOUT_S)).ok]
        stats = server.stats()
    finally:
        server.close()
    tmp = os.path.join(work, f"{STATS}.tmp.{os.getpid()}")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(stats, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, os.path.join(work, STATS))
    if bad:
        print(f"serving-chaos: serve: failed sessions: {', '.join(bad)}", file=sys.stderr)
        return 1
    return 0


# ---------------------------------------------------------------------------
# injuries and gates


def wait_for_first_grant(jpath: str, proc: subprocess.Popen, timeout: float = 300.0):
    """Poll the journal until the first ``done`` record lands while work is
    still pending — the mid-queue moment to SIGKILL; (done, pending) or
    None when the server exits first or the time runs out."""
    from ..serving import replay

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return None
        st = replay(jpath)
        if st.done and st.pending:
            return len(st.done), len(st.pending)
        time.sleep(0.05)
    return None


class _StubCache:
    hits = misses = 0

    def __len__(self):
        return 0

    def keys(self):
        return []


class _StubScheduler:
    """A scheduler that runs no search: each execute blocks on ``gate``."""

    def __init__(self):
        self.step_cache = _StubCache()
        self.inter_wu_gaps_s = []
        self.warmed = False
        self.gate = threading.Event()
        self.entered = threading.Event()

    def n_devices(self):
        return 1

    def arm_slo(self, monitor):
        pass

    def warm(self, specs):
        return {}

    def build_session(self, args, corr_id=None, name=None):
        return types.SimpleNamespace(args=args, corr_id=corr_id, name=name)

    def prepare_async(self, session):
        return None

    def execute(self, session, prep_future=None):
        from ..runtime.scheduler import SessionResult

        self.entered.set()
        self.gate.wait(timeout=30)
        return SessionResult(name=session.name, code=0, corr_id=session.corr_id,
                             outputfile=session.args.outputfile, wall_s=0.01)

    def close(self):
        pass


def shed_check() -> str | None:
    """The admission contract of a bounded queue, in-process over a stub
    scheduler; an error string, or None when it holds."""
    import urllib.error
    import urllib.request

    from ..runtime.driver import DriverArgs
    from ..serving import FleetServer, ServerOverloaded
    from ..serving.introspect import Introspector

    sched = _StubScheduler()
    server = FleetServer(scheduler=sched, queue_max=2, name="shed")
    intro = Introspector(port=0, server=server, name="shed")
    try:
        def mk(i):
            return DriverArgs(inputfile=f"in{i}", outputfile=f"out{i}", templatebank="bank", device="cpu")

        tickets = [server.submit(mk(0))]
        if not sched.entered.wait(timeout=10):
            return "dispatch never started"
        tickets += [server.submit(mk(1)), server.submit(mk(2))]
        try:
            server.submit(mk(3))
            return "a full queue accepted a submit"
        except ServerOverloaded as e:
            if e.retry_after_s < 1.0:
                return f"shed without a usable retry-after ({e.retry_after_s})"
        try:
            with urllib.request.urlopen(intro.url("/healthz"), timeout=10):
                return "/healthz answered 200 while shedding"
        except urllib.error.HTTPError as e:
            if e.code != 503:
                return f"/healthz answered {e.code} while shedding, want 503"
            if not e.headers.get("Retry-After"):
                return "the 503 shed response carries no Retry-After header"
        sched.gate.set()
        for t in tickets:
            if not server.result(t, timeout=30).ok:
                return f"accepted WU {t} failed under shed load"
        code, _ = intro.healthz()
        if code != 200:
            return f"/healthz still {code} after the queue drained"
        if server.stats()["shed_total"] != 1:
            return f"shed_total {server.stats()['shed_total']}, want 1"
    finally:
        intro.close()
        server.close()
    return None


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    # --serve --supervised N: become the restart supervisor of the server
    # process and re-exec it (minus the flag) while it exits rc 99
    if "--serve" in argv and "--supervised" in argv:
        from ..runtime.supervise import run_supervised, strip_supervised_flag

        worker_argv, budget = strip_supervised_flag(argv)
        return run_supervised([sys.executable, "-m", MODULE, *worker_argv], max_restarts=max(0, budget or 0))

    ap = argparse.ArgumentParser(description="Serving chaos soak: SIGKILL, journal EIO and a dispatch wedge "
                                             "against a durable FleetServer.")
    ap.add_argument("--wus", type=int, default=5, help="workunits to stream (default 5)")
    ap.add_argument("--quick", action="store_true", help="the defaults")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--workdir", help="reuse this dir instead of a tmp one")
    ap.add_argument("--keep", action="store_true", help="keep the workdir (default: removed when green)")
    ap.add_argument("--serve", action="store_true", help="run the durable server over the workdir's manifest")
    ap.add_argument("--supervised", type=int, default=None, help="(with --serve) restart budget for rc 99")
    args = ap.parse_args(argv)

    device = _inputs.require_device(args.device)
    if args.serve:
        if not args.workdir:
            return fail("--serve needs --workdir")
        return serve(args.workdir, device)
    if args.wus < 3:
        return fail("--wus must be >= 3 (a kill mid-queue needs a backlog)")

    os.environ["ERP_RESULT_DATE"] = _inputs.RESULT_DATE
    os.environ.setdefault("ERP_SUPERVISE_BACKOFF_S", "0.1")
    work = args.workdir or tempfile.mkdtemp(prefix="erp-serving-chaos-")
    os.makedirs(work, exist_ok=True)
    log(f"workdir {work}")

    from ..serving import journal_path, replay
    from . import fleet_bench, report_check

    wus = fleet_bench.build_workunits(work, args.wus, device)
    with open(os.path.join(work, MANIFEST), "w", encoding="utf-8") as f:
        json.dump([dataclasses.asdict(a) for a in wus], f, indent=1)
        f.write("\n")
    t0 = time.monotonic()
    refs = {a.outputfile: fleet_bench.run_reference(a) for a in wus}
    log(f"{len(refs)} one-process references in {time.monotonic() - t0:.1f}s")
    jpath = journal_path(work)

    # -- phase A: journal EIO, SIGKILL mid-queue
    log_a = os.path.join(work, "serve-a.log")
    with open(log_a, "w") as logf:
        proc = subprocess.Popen(serve_cmd(work, device), env=serve_env(work, "seed=7;journal_write:eio@n=3",
                                                                       "fault-a.json"),
                                stdout=logf, stderr=subprocess.STDOUT)
        hit = wait_for_first_grant(jpath, proc)
        if hit is None:
            proc.kill()
            proc.wait()
            return fail(f"phase A: no mid-queue kill point (see {log_a})")
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    log(f"phase A: SIGKILL mid-queue after {hit[0]} grant(s), {hit[1]} pending (journal EIO injected and retried)")
    snap = os.path.join(work, "journal-after-kill.jsonl")
    shutil.copyfile(jpath, snap)
    schema, problems = report_check.check_path(snap)
    if problems:
        return fail(f"the journal snapshot after the kill fails its {schema} check: {problems[:3]}")
    st = replay(snap)
    if not st.pending:
        return fail("phase A: nothing pending in the journal after the kill")
    if any(not rec.get("digest") for rec in st.done.values()):
        return fail("phase A: a done record has no payload digest")

    # -- phase B: a dispatch wedge under supervision, then finish
    env_b = serve_env(work, "seed=7;serving_dispatch:hang@n=1", "fault-b.json", extra={
        "ERP_FAULT_HANG_S": "120", "ERP_WATCHDOG_SPEC": "serving_dispatch=2,serving_result=30",
        "ERP_WATCHDOG_GRACE_S": "2", "ERP_WATCHDOG_POLL_S": "0.25",
    })
    log_b = os.path.join(work, "serve-b.log")
    t0 = time.monotonic()
    with open(log_b, "w") as logf:
        rc = subprocess.call(serve_cmd(work, device, supervised=3), env=env_b, stdout=logf,
                             stderr=subprocess.STDOUT, timeout=SERVE_TIMEOUT_S)
    with open(log_b, errors="replace") as f:
        blog = f.read()
    if rc != 0:
        sys.stderr.write(blog[-4000:])
        return fail(f"phase B: the supervised server exited {rc}")
    if "restarting in" not in blog:
        return fail(f"phase B: the dispatch wedge never triggered a supervised restart (see {log_b})")
    log(f"phase B: wedge -> rc 99 -> supervised restart -> drained in {time.monotonic() - t0:.1f}s")

    # -- gates
    for a in wus:
        try:
            with open(a.outputfile, "rb") as f:
                got = f.read()
        except OSError as e:
            return fail(f"{os.path.basename(a.outputfile)}: not granted ({e})")
        if got != refs[a.outputfile]:
            return fail(f"{os.path.basename(a.outputfile)}: differs from the one-process reference")
    log(f"all {len(wus)} results byte-identical to the one-process references")
    schema, problems = report_check.check_path(jpath)
    if problems:
        return fail(f"the final journal fails its {schema} check: {problems[:3]}")
    with open(os.path.join(work, STATS), encoding="utf-8") as f:
        stats = json.load(f)
    if stats.get("recompiles_after_warmup", -1) != 0:
        return fail(f"recompiles_after_warmup = {stats.get('recompiles_after_warmup')} after the warm resume")
    if stats.get("resumed_wus", 0) < 1:
        return fail(f"the final pass replayed {stats.get('resumed_wus')} WUs, want >= 1")
    log(f"final pass: resumed_wus={stats['resumed_wus']}, 0 recompiles after the warm resume")
    err = shed_check()
    if err:
        return fail(f"shed check: {err}")
    log("overload: the bounded queue sheds with a retry-after, /healthz answers 503")
    if not args.keep and not args.workdir:
        shutil.rmtree(work, ignore_errors=True)
    log(f"PASS ({args.wus} WUs through SIGKILL + journal EIO + dispatch wedge; zero lost, zero drift)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
