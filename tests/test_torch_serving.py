"""PyTorch port, the serving tier on the CPU (``runtime/scheduler.py``,
``serving/``) against the JAX package's.

Same-geometry synthetic workunits (4096 samples, window 200, batch 2,
unwhitened, the JAX defaults otherwise), ``ERP_RESULT_DATE`` pinned.

Tolerances:
* candidate rows of the port's FleetServer equal the JAX FleetServer's
  (unwhitened: both pad with the reference's serial float32 mean and
  rescore through the same numpy oracle; the fixture bank has no
  contraction tie at this length, ``test_torch_session.py``);
* served result files are byte-identical to the port's ``run_search`` on
  the same workunit;
* journals, plan packing, SLO streams and Prometheus text are exact.
"""

import dataclasses
import json
import threading
import time
import types

import numpy as np
import pytest

from boinc_app_eah_brp_tpu.io import parse_result_file as jax_parse
from boinc_app_eah_brp_tpu.runtime.driver import DriverArgs as JaxArgs
from boinc_app_eah_brp_tpu.runtime.scheduler import plan_packing as jax_plan_packing
from boinc_app_eah_brp_tpu.serving import FleetServer as JaxFleetServer
from boinc_app_eah_brp_tpu.serving import introspect as jax_introspect
from boinc_app_eah_brp_tpu.serving import journal as jax_journal
from boinc_app_eah_brp_tpu.serving import slo as jax_slo
from boinc_app_eah_brp_tpu_torch.io import parse_result_file, write_template_bank, write_workunit
from boinc_app_eah_brp_tpu_torch.runtime import autobatch, metrics, resilience
from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs, run_search
from boinc_app_eah_brp_tpu_torch.runtime.errors import RADPUL_EIO
from boinc_app_eah_brp_tpu_torch.runtime.obs import ObsContext
from boinc_app_eah_brp_tpu_torch.runtime.scheduler import Scheduler, SessionResult, WarmSpec, plan_packing
from boinc_app_eah_brp_tpu_torch.runtime.session import Session, SessionEnv
from boinc_app_eah_brp_tpu_torch.serving import FleetServer, ServerOverloaded, journal, replay, validate_journal
from boinc_app_eah_brp_tpu_torch.serving import introspect, slo
from fixtures import small_bank, synthetic_timeseries

N = 4096
POISON = "nope.bin4"


@pytest.fixture(autouse=True)
def _pinned_result_date(monkeypatch):
    monkeypatch.setenv("ERP_RESULT_DATE", "2008-11-12T00:00:00+00:00")


@pytest.fixture
def fleet(tmp_path):
    """A shared bank and a factory of same-geometry workunits (distinct
    signals) as either package's DriverArgs, as the JAX package's fleet
    tests make them."""
    bank = str(tmp_path / "bank.dat")
    write_template_bank(bank, small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2))

    def make(i, prefix, pkg="port", **kw):
        wu = tmp_path / (f"wu{i}.bin4" if i >= 0 else POISON)
        if i >= 0 and not wu.exists():
            ts = synthetic_timeseries(N, f_signal=31.0 + 2.0 * i, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0, seed=i)
            write_workunit(str(wu), ts, tsample_us=500.0, scale=1.0, dm=55.5)
        common = dict(
            inputfile=str(wu),
            outputfile=str(tmp_path / f"{prefix}{i}.cand"),
            templatebank=bank,
            checkpointfile=str(tmp_path / f"{prefix}{i}.cpt"),
            window=200,
            batch_size=2,
        )
        common.update(kw)
        if pkg == "jax":
            return JaxArgs(mesh_devices=1, **common)
        return DriverArgs(device="cpu", **common)

    return types.SimpleNamespace(make=make, tmp=tmp_path, bank=bank)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _serve(server, args_list):
    tickets = [server.submit(a, corr_id=f"c-{k}") for k, a in enumerate(args_list)]
    return [server.result(t, timeout=300) for t in tickets]


# ---------------------------------------------------------------------------
# the port's FleetServer against the JAX one and run_search


def test_fleet_server_serves_like_run_search(fleet):
    """Three same-geometry workunits through one port FleetServer: each
    result file is byte-identical to the port's run_search on the same
    workunit, WUs 2-3 hit the step cache, no kernel build or new plan
    after warm-up, and the scoreboard has the erp-fleet-serving/1 shape."""
    refs = []
    for i in range(3):
        a = fleet.make(i, "ref")
        assert run_search(a) == 0
        refs.append(_bytes(a.outputfile))
    with FleetServer(name="t-ident", device="cpu") as server:
        results = _serve(server, [fleet.make(i, "srv") for i in range(3)])
        stats = server.stats()
    assert [r.code for r in results] == [0, 0, 0]
    for i, r in enumerate(results):
        assert r.corr_id == f"c-{i}" and r.name == f"t-ident-wu-{i + 1}"
        assert _bytes(r.outputfile) == refs[i], f"wu{i} differs from run_search"
    assert results[0].step_cache_misses >= 1
    for r in results[1:]:
        assert r.step_cache_hits >= 1 and r.step_cache_misses == 0
    assert stats["schema"] == "erp-fleet-serving/1"
    assert stats["served"] == stats["ok"] == 3 and stats["failed"] == 0
    assert stats["recompiles_after_warmup"] == 0
    assert stats["step_cache"]["entries"] == 1
    assert stats["wus_per_hour_per_chip"] > 0 and stats["n_chips"] == 1


def test_fleet_server_matches_jax_fleet_server(fleet):
    """Three workunits and a poisoned request (a missing input file)
    between them, through both packages' servers with a journal armed:
    the same codes, the same candidate rows, the same scoreboard keys,
    and each journal replays to the same state through either package's
    replay()."""
    order = [0, -1, 1, 2]
    states = {}
    out = {}
    for pkg, cls in (("port", FleetServer), ("jax", JaxFleetServer)):
        work = str(fleet.tmp / f"{pkg}-srv")
        kw = dict(device="cpu") if pkg == "port" else {}
        server = cls(name=f"t-{pkg}", resume_dir=work, **kw)
        try:
            results = _serve(server, [fleet.make(i, pkg, pkg) for i in order])
            stats = server.stats()
            # the journal as the server wrote it, before close compacts it
            path = journal.journal_path(work)
            states[pkg] = path + ".copy"
            with open(path, "rb") as src, open(states[pkg], "wb") as dst:
                dst.write(src.read())
        finally:
            server.close()
        out[pkg] = (results, stats)
    (port_res, port_stats), (jax_res, jax_stats) = out["port"], out["jax"]
    assert [r.code for r in port_res] == [r.code for r in jax_res] == [0, RADPUL_EIO, 0, 0]
    assert port_res[1].error and "No such file" in port_res[1].error
    for p, j in zip(port_res, jax_res):
        if p.ok:
            got = parse_result_file(p.outputfile).lines
            assert len(got) > 0
            np.testing.assert_array_equal(got, jax_parse(j.outputfile).lines)
    assert set(port_stats) == set(jax_stats)
    assert set(port_stats["step_cache"]) == set(jax_stats["step_cache"])
    assert port_stats["served"] == 4 and port_stats["ok"] == 3
    for path in states.values():
        s_port, s_jax = replay(path), jax_journal.replay(path)
        assert vars(s_port) == vars(s_jax)
        assert len(s_port.done) == 3 and len(s_port.failed) == 1 and s_port.pending == []
        assert validate_journal(path) == [] and jax_journal.validate_journal(path) == []


def test_journal_bytes_match_jax_writer(tmp_path, monkeypatch):
    """The same lifecycle written by each package's WUJournal gives the
    same bytes (erp-serving-journal/1), with a pending ticket and a torn
    tail that both replays fold alike."""
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    args = types.SimpleNamespace(inputfile="wu.bin4", outputfile="out.cand", batch_size=2)
    done = tmp_path / "done.cand"
    done.write_bytes(b"result\n")
    paths = {}
    for pkg, mod in (("port", journal), ("jax", jax_journal)):
        paths[pkg] = str(tmp_path / f"{pkg}.jsonl")
        j = mod.WUJournal(paths[pkg])
        for t in ("f-wu-1", "f-wu-2", "f-wu-3"):
            j.record_submit(t, args, corr_id=f"id-{t}")
        j.record_dispatch("f-wu-1")
        j.record_done("f-wu-1", str(done))
        j.record_dispatch("f-wu-2")
        j.record_failed("f-wu-2", RADPUL_EIO, "FileNotFoundError: gone")
        j.record_close("abort", pending=1, abandoned=["f-wu-3"])
        j.close()
        with open(paths[pkg], "a") as f:
            f.write('{"schema": "erp-serving-jou')  # the crash-torn tail
    assert _bytes(paths["port"]) == _bytes(paths["jax"])
    for path in paths.values():
        st = replay(path)
        assert vars(st) == vars(jax_journal.replay(path))
        assert [r["ticket"] for r in st.pending] == ["f-wu-3"] and st.torn == 1
        assert validate_journal(path) == jax_journal.validate_journal(path) == []


class _GatedScheduler(Scheduler):
    """A real CPU Scheduler whose first execution waits for a gate."""

    def __init__(self):
        super().__init__(device="cpu")
        self.entered, self.gate = threading.Event(), threading.Event()

    def execute(self, session, prep_future=None):
        self.entered.set()
        assert self.gate.wait(timeout=60), "test gate never opened"
        return super().execute(session, prep_future)


def test_abort_close_resumes_from_the_journal(fleet):
    """A port server closed with drain=False while its first workunit runs
    grants that one; the next server on the same resume dir replays the
    other two and gives the rows of an uninterrupted run."""
    refs = []
    for i in range(3):
        a = fleet.make(i, "ref")
        assert run_search(a) == 0
        refs.append(parse_result_file(a.outputfile).lines)
    work = str(fleet.tmp / "srv")
    sched = _GatedScheduler()
    server = FleetServer(scheduler=sched, resume_dir=work, name="ab")
    t1 = server.submit(fleet.make(0, "run"))
    assert sched.entered.wait(timeout=30)
    t2, t3 = (server.submit(fleet.make(i, "run")) for i in (1, 2))
    closer = threading.Thread(target=lambda: server.close(drain=False))
    closer.start()
    deadline = time.monotonic() + 30
    while not server._closed and time.monotonic() < deadline:
        time.sleep(0.005)
    sched.gate.set()
    closer.join(timeout=120)
    assert not closer.is_alive()
    assert server.result(t1, timeout=5).ok
    for t in (t2, t3):
        with pytest.raises(RuntimeError, match="journaled"):
            server.result(t, timeout=5)
    with FleetServer(resume_dir=work, name="ab", device="cpu") as s2:
        assert s2.replayed_wus == 2
        results = [s2.result(t, timeout=300) for t in (t2, t3)]
    assert all(r.ok for r in results)
    for i in range(3):
        np.testing.assert_array_equal(parse_result_file(str(fleet.tmp / f"run{i}.cand")).lines, refs[i])
    assert replay(journal.journal_path(work)).pending == []


# ---------------------------------------------------------------------------
# the Scheduler and the Session's serving surface


def test_prepared_on_the_prep_thread_gives_the_same_bytes(fleet):
    """A session prepared on the scheduler's prep thread writes the same
    result bytes as one prepared inline, and releases its tensors."""
    sched = Scheduler(device="cpu")
    try:
        inline = sched.build_session(fleet.make(0, "inline"))
        r_inline = sched.execute(inline)
        threaded = sched.build_session(fleet.make(0, "thread"))
        fut = sched.prepare_async(threaded)
        assert fut.result(timeout=120) is threaded and threaded.prepared
        r_thread = sched.execute(threaded, prep_future=fut)
    finally:
        sched.close()
    assert r_inline.ok and r_thread.ok
    assert _bytes(r_inline.outputfile) == _bytes(r_thread.outputfile)
    for s in (inline, threaded):
        assert not s.prepared and not hasattr(s, "ts") and not hasattr(s, "state")


def test_class_batch_is_held_while_the_budget_moves(fleet, monkeypatch):
    """Two sessions of one class without --batch get the class's batch,
    though the memory budget the autobatch model reads changes between
    them; a session outside the scheduler follows the budget."""
    monkeypatch.delenv("ERP_BATCH", raising=False)
    monkeypatch.setenv(autobatch.SWEEP_ENV, str(fleet.tmp / "no-sweep.json"))
    budget = {"bytes": 400_000}
    monkeypatch.setattr(autobatch, "device_memory_budget", lambda device=None: budget["bytes"])
    sched = Scheduler(device="cpu")
    try:
        s1 = sched.build_session(fleet.make(0, "b", batch_size=None)).prepare()
        budget["bytes"] = 1 << 30
        s2 = sched.build_session(fleet.make(1, "b", batch_size=None)).prepare()
        alone = Session(fleet.make(1, "alone", batch_size=None)).prepare()
        pinned = sched.build_session(fleet.make(1, "p", batch_size=4)).prepare()
    finally:
        sched.close()
    assert s1.geom == s2.geom
    assert s1.batch_size == s2.batch_size == 8
    assert alone.batch_size == 128
    assert pinned.batch_size == 4


def test_warm_spec_fixes_the_class_batch_and_fills_the_cache(fleet):
    """warm() puts one entry per spec in the step cache (an aot hit on the
    CPU: nothing to build or plan), fixes the class's batch, and the
    first session then hits the cache."""
    probe = Session(fleet.make(0, "probe", batch_size=None)).prepare()
    with FleetServer(name="t-warm", device="cpu", warm_specs=[WarmSpec(probe.geom, 2)]) as server:
        assert server.warm_report == {"aot_hit": 1, "aot_miss": 0, "steps": 1}
        res = server.process(fleet.make(0, "w", batch_size=None))
        stats = server.stats()
    assert res.ok and res.step_cache_hits >= 1 and res.step_cache_misses == 0
    assert res.recompiles == 0 and stats["step_cache"]["entries"] == 1
    assert stats["recompiles_after_warmup"] == 0


def test_scheduler_on_cuda_without_a_card_raises(monkeypatch):
    """No fallback: the default Scheduler (and so the default FleetServer)
    runs on the card and refuses to start without one."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetServer(name="t-nocard")


def test_poisoned_request_is_contained(fleet):
    sched = Scheduler(device="cpu")
    try:
        bad = sched.process(fleet.make(-1, "bad"), corr_id="bad")
        good = sched.process(fleet.make(0, "good"), corr_id="good")
    finally:
        sched.close()
    assert not bad.ok and bad.code == RADPUL_EIO and bad.error
    assert good.ok and good.corr_id == "good"


@pytest.mark.parametrize("seed", range(6))
def test_plan_packing_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 40))
    reqs = [(str(rng.integers(0, 5)), k) for k in range(n)]
    assert plan_packing(reqs) == jax_plan_packing(reqs)


def test_session_env_recaptured_per_session(monkeypatch, fleet):
    monkeypatch.setenv("ERP_CHECKPOINT_PERIOD", "11")
    monkeypatch.setenv("ERP_PROGRESS_MIN_DELTA", "0.25")
    env = SessionEnv.capture()
    assert (env.checkpoint_period_s, env.progress_min_delta) == (11.0, 0.25)
    assert not hasattr(env, "lookahead")  # ERP_LOOKAHEAD is not ported
    with pytest.raises(dataclasses.FrozenInstanceError):
        env.checkpoint_period_s = 1.0
    sched = Scheduler(device="cpu")
    try:
        monkeypatch.setenv("ERP_CHECKPOINT_PERIOD", "19")
        s1 = sched.build_session(fleet.make(0, "e"))
        monkeypatch.setenv("ERP_CHECKPOINT_PERIOD", "23")
        s2 = sched.build_session(fleet.make(1, "e"))
        assert s1.adapter.checkpoint_period_s == 19.0 and s1.env.checkpoint_period_s == 19.0
        assert s2.adapter.checkpoint_period_s == 23.0
        s1.obs.close(0)
        s2.obs.close(0)
    finally:
        sched.close()


def test_session_env_bad_values_fall_back(monkeypatch):
    monkeypatch.setenv("ERP_CHECKPOINT_PERIOD", "banana")
    monkeypatch.setenv("ERP_PROGRESS_MIN_DELTA", "")
    env = SessionEnv.capture()
    assert env == SessionEnv(checkpoint_period_s=60.0, progress_min_delta=0.001)
    assert env.make_adapter().checkpoint_period_s == 60.0


def test_scoped_obs_isolation(tmp_path, fleet, monkeypatch):
    """Scoped metrics and flight recorders never bleed into each other;
    a build on an uncharged thread while two sessions' windows are open
    reaches both, one on a thread charged to a window reaches that one."""
    a = ObsContext(name="iso-a").configure(force_metrics=True, dump_dir=str(tmp_path / "a"), context={"session": "a"})
    b = ObsContext(name="iso-b").configure(force_metrics=True, dump_dir=str(tmp_path / "b"), context={"session": "b"})
    try:
        a.metrics.counter("session.only_a").inc(3)
        b.metrics.counter("session.only_b").inc(1)
        snap_a, snap_b = a.metrics.registry().snapshot(), b.metrics.registry().snapshot()
        assert snap_a["counters"]["session.only_a"]["value"] == 3 and "session.only_b" not in snap_a["counters"]
        assert snap_b["counters"]["session.only_b"]["value"] == 1 and "session.only_a" not in snap_b["counters"]
        a.flightrec.record("only-a-event", session="a")
        assert any(e.get("kind") == "only-a-event" for e in a.flightrec.build_dump("t")["events"])
        assert not any(e.get("kind") == "only-a-event" for e in b.flightrec.build_dump("t")["events"])
        assert a.flightrec.build_dump("t")["context"]["session"] == "a"
        assert b.flightrec.build_dump("t")["context"]["session"] == "b"
        metrics._on_kernel_build(2, 0.5)
        assert a.metrics.registry().counter("torch.kernel_builds").value == 2
        assert b.metrics.registry().counter("torch.kernel_builds").value == 2
        with metrics.charged_to(a.metrics):
            metrics._on_kernel_build(1, 0.1)
            metrics._on_cufft_plans(1)
        assert a.metrics.registry().counter("torch.kernel_builds").value == 3 and a.metrics.cufft_plans() == 1
        assert b.metrics.registry().counter("torch.kernel_builds").value == 2 and b.metrics.cufft_plans() == 0
    finally:
        a.close(0)
        b.close(0)
    # the scheduler's sessions: their own contexts, their own breadcrumbs
    sched = Scheduler(device="cpu")
    try:
        s1 = sched.build_session(fleet.make(0, "o"), corr_id="one")
        s2 = sched.build_session(fleet.make(1, "o"), corr_id="two")
        assert s1.obs is not s2.obs and s1.obs.metrics is not s2.obs.metrics
        s1.prepare()
        ev1 = s1.obs.flightrec.build_dump("t")["events"]
        assert any(e["kind"] == "session-prepare" and e["corr_id"] == "one" for e in ev1)
        assert not any(e["kind"] == "session-prepare" for e in s2.obs.flightrec.build_dump("t")["events"])
        s1.obs.close(0)
        s2.obs.close(0)
    finally:
        sched.close()


class _FakePlanCache:
    """torch's cuFFT plan cache of card 0, on the CPU."""

    def __init__(self, size=0):
        self.size = size

    def clear(self):
        self.size = 0

    def plan(self, x, **kwargs):
        self.size += 1


def _on_card():
    """A stand-in operand whose device is card 0 (for ops/kernels.py::planned_fft,
    which keys its first-call span on the operand's shape and dtype)."""
    import torch

    return types.SimpleNamespace(device=torch.device("cuda", 0), shape=(8,), dtype=torch.float32)


def test_cufft_plan_count_survives_a_cache_clear(monkeypatch):
    """torch.cufft_plans counts the plans CREATED in a window: a plan
    rebuilt after release_device_memory cleared the cache counts again
    (the plan cache's size minus a fixed base counted it as nothing)."""
    import torch

    from boinc_app_eah_brp_tpu_torch.ops import kernels

    cache = _FakePlanCache(size=3)
    monkeypatch.setattr(torch.backends.cuda, "cufft_plan_cache", [cache])
    ctx = metrics.MetricsContext(name="plans")
    ctx.configure(force=True)
    try:
        for _ in range(2):
            kernels.planned_fft(cache.plan, _on_card())
        kernels.planned_fft(lambda x: None, _on_card())  # a cached plan
        assert cache.size == 5 and ctx.cufft_plans() == 2
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
        resilience.release_device_memory()
        assert cache.size == 0 and ctx.cufft_plans() == 2
        kernels.planned_fft(cache.plan, _on_card())  # the batch replans after the clear
        assert ctx.cufft_plans() == 3
        assert ctx.snapshot()["counters"]["torch.cufft_plans"]["value"] == 3
    finally:
        ctx.finish(0)


def test_overlapped_prep_charges_its_own_session(fleet, monkeypatch):
    """A kernel build and a cuFFT plan made by workunit 2's prep on the prep
    thread while workunit 1 executes count in workunit 2's recompiles; a
    plan of workunit 1's execution counts in its own; a third session,
    open all along, counts neither."""
    import torch

    from boinc_app_eah_brp_tpu_torch.ops import kernels

    cache = _FakePlanCache()
    monkeypatch.setattr(torch.backends.cuda, "cufft_plan_cache", [cache])
    executing, prepared = threading.Event(), threading.Event()
    real_prepare, real_execute = Session.prepare, Session.execute

    def prepare(self):
        out = real_prepare(self)
        if self.corr_id == "two":
            assert executing.wait(timeout=60)
            for fn in kernels.build_listeners:
                fn(1, 0.1)
            kernels.planned_fft(cache.plan, _on_card())
            prepared.set()
        return out

    def execute(self, step_cache=None):
        if self.corr_id == "one":
            executing.set()
            assert prepared.wait(timeout=60)
            kernels.planned_fft(cache.plan, _on_card())
        return real_execute(self, step_cache=step_cache)

    monkeypatch.setattr(Session, "prepare", prepare)
    monkeypatch.setattr(Session, "execute", execute)
    sched = Scheduler(device="cpu")
    try:
        s1, s2, s3 = (sched.build_session(fleet.make(i, "ov"), corr_id=c) for i, c in enumerate(("one", "two", "three")))
        f1, f2 = sched.prepare_async(s1), sched.prepare_async(s2)
        r1 = sched.execute(s1, prep_future=f1)
        r2 = sched.execute(s2, prep_future=f2)
        r3 = sched.execute(s3)
    finally:
        sched.close()
    assert r1.ok and r2.ok and r3.ok
    assert cache.size == 2
    assert (r1.recompiles, r2.recompiles, r3.recompiles) == (1, 2, 0)


def test_poisoned_request_leaves_the_trace_stream_valid(fleet, tmp_path):
    """A request whose prep fails (a missing input) closes its setup span
    with the error on the prep thread: the next workunit's setup does not
    nest under it, and the trace stream validates with no span left open."""
    from boinc_app_eah_brp_tpu_torch.runtime import tracing

    trace = tmp_path / "trace.jsonl"
    tracing.configure(trace_file=str(trace))
    try:
        with FleetServer(name="t-trace", device="cpu") as server:
            bad, good = _serve(server, [fleet.make(-1, "tr"), fleet.make(0, "tr")])
    finally:
        tracing.finish(0)
    assert bad.code == RADPUL_EIO and good.ok
    lines = [json.loads(ln) for ln in trace.read_text().splitlines()]
    assert tracing.validate_stream(lines) == []
    setups = [r for r in lines if r.get("kind") == "span" and r["name"] == "setup"]
    assert len(setups) == 2 and all(r["depth"] == 0 for r in setups)
    assert "error" in setups[0] and "error" not in setups[1]


# ---------------------------------------------------------------------------
# overload and telemetry: the server's policies on a duck-typed scheduler


class _FakeCache:
    hits = misses = 0

    def __len__(self):
        return 0

    def keys(self):
        return []


class _FakeScheduler:
    """Instant (or gated) sessions; no torch."""

    def __init__(self, gate=None, oom_above_batch=None):
        self.step_cache = _FakeCache()
        self.inter_wu_gaps_s = []
        self.warmed = False
        self.slo = None
        self.gate = gate
        self.oom_above_batch = oom_above_batch
        self.entered = threading.Event()
        self.executed = []

    def n_devices(self):
        return 1

    def arm_slo(self, monitor):
        self.slo = monitor

    def build_session(self, args, corr_id=None, name=None):
        return types.SimpleNamespace(args=args, corr_id=corr_id, name=name)

    def prepare_async(self, session):
        return None

    def execute(self, session, prep_future=None):
        self.entered.set()
        if self.gate is not None:
            assert self.gate.wait(timeout=30), "test gate never opened"
        self.executed.append((session.name, session.args.batch_size))
        if self.oom_above_batch is not None and (session.args.batch_size or 0) > self.oom_above_batch:
            return SessionResult(
                name=session.name, code=-1, corr_id=session.corr_id, outputfile=session.args.outputfile,
                error="OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB", wall_s=0.01,
            )
        return SessionResult(name=session.name, code=0, corr_id=session.corr_id,
                             outputfile=session.args.outputfile, wall_s=0.01)

    def close(self):
        pass


def test_bounded_queue_sheds_with_retry_after(fleet):
    gate = threading.Event()
    sched = _FakeScheduler(gate=gate)
    server = FleetServer(scheduler=sched, queue_max=2, name="shed")
    intro = introspect.Introspector(port=0, server=server, name="shed")
    try:
        tickets = [server.submit(fleet.make(0, "q"))]
        assert sched.entered.wait(timeout=10)
        tickets += [server.submit(fleet.make(i, "q")) for i in (1, 2)]
        assert server.shedding
        with pytest.raises(ServerOverloaded) as ei:
            server.submit(fleet.make(3, "q"))
        assert ei.value.retry_after_s >= 1.0
        code, doc = intro.healthz()
        assert code == 503 and doc["status"] == "shedding" and doc["retry_after_s"] >= 1.0
        sdoc = intro.statusz()
        assert sdoc["durability"]["shedding"] is True and sdoc["durability"]["shed_total"] == 1
        assert "device" in sdoc and "watchdog_beat_ages_s" in sdoc
        gate.set()
        for t in tickets:
            assert server.result(t, timeout=30).ok
        assert intro.healthz()[0] == 200
        assert server.stats()["shed_total"] == 1
    finally:
        intro.close()
        server.close()


def test_repeated_oom_walks_the_class_ladder(fleet):
    """Two out-of-memory failures of one class arm its degradation
    ladder; the class's next workunit runs at the halved batch."""
    sched = _FakeScheduler(oom_above_batch=2)
    server = FleetServer(scheduler=sched, name="oom")
    try:
        results = [server.process(fleet.make(i, "o", batch_size=4)) for i in range(3)]
    finally:
        server.close()
    assert [b for _, b in sched.executed] == [4, 4, 2]
    assert [r.ok for r in results] == [False, False, True]


def test_slo_stream_validates_under_jax_and_prometheus_matches(tmp_path):
    """The port monitor's heartbeat stream passes the JAX validator, and
    the port's Prometheus rendering of a snapshot equals the JAX one."""
    path = str(tmp_path / "slo.jsonl")
    mon = slo.SLOMonitor(
        path=path, interval_s=3600.0, n_chips=lambda: 1, name="t-slo",
        baseline={"p95_inter_wu_gap_s_max": 0.5, "recompiles_after_warmup_max": 0},
    )
    key = "bank.dat:b2:w200"
    mon.observe_session(key, types.SimpleNamespace(ok=True, recompiles=2, wall_s=1.0), step_ms=[1.0, 2.0])
    mon.observe_session(key, types.SimpleNamespace(ok=True, recompiles=0, wall_s=1.0), step_ms=[1.5], gap_s=0.1)
    mon.observe_queue_depth(3)
    doc = mon.heartbeat()
    assert doc["recompiles"] == {"total": 2, "after_warmup": 0} and not doc["slo"]["burning"]
    mon.observe_session(key, types.SimpleNamespace(ok=True, recompiles=0, wall_s=1.0), step_ms=[1.2], gap_s=2.0)
    assert mon.heartbeat()["slo"]["burning"]
    mon.close()
    lines = [json.loads(ln) for ln in open(path)]
    assert len(lines) == 3
    assert jax_slo.validate_slo_stream(lines) == [] and slo.validate_slo_stream(lines) == []

    ctx = metrics.MetricsContext(name="prom")
    ctx.configure(force=True)
    try:
        ctx.counter("fleet.sessions").inc(3)
        ctx.counter(metrics.labeled("fleet.shed", host_id="h1")).inc()
        ctx.gauge("fleet.queue_depth").set(2)
        ctx.gauge("autobatch.decision").set("memory-model")
        ctx.histogram("fleet.inter_wu_gap_ms", metrics.LATENCY_BUCKETS_MS, unit="ms").observe(12.5)
        ctx.record_phase("template loop", 0.25)
        snap = ctx.snapshot()
    finally:
        ctx.finish(0)
    text = introspect.render_prometheus(snap)
    assert text == jax_introspect.render_prometheus(snap)
    assert introspect.parse_prometheus(text)["fleet_sessions_total"] == 3.0


def test_fleet_server_slo_heartbeat_and_statusz(monkeypatch, fleet, tmp_path):
    """With $ERP_SLO_FILE and $ERP_STATUSZ_PORT set, a served port fleet
    leaves a validated heartbeat stream, and /statusz names no card on
    the CPU (CUDA is never initialised for it)."""
    import urllib.request

    path = str(tmp_path / "slo.jsonl")
    monkeypatch.setenv(slo.SLO_FILE_ENV, path)
    monkeypatch.setenv(slo.SLO_INTERVAL_ENV, "3600")
    monkeypatch.setenv(introspect.STATUSZ_PORT_ENV, "0")
    with FleetServer(name="t-slo-live", device="cpu") as server:
        assert server.slo is not None and server.scheduler.slo is server.slo
        results = [server.process(fleet.make(i, "slo"), corr_id=f"s-{i}") for i in range(2)]
        with urllib.request.urlopen(server.introspect.url("/statusz"), timeout=10) as resp:
            doc = json.loads(resp.read())
    assert all(r.ok for r in results)
    assert doc["schema"] == "erp-statusz/1" and doc["device"] is None
    assert doc["stats"]["served"] == 2 and len(doc["step_cache_keys"]) == 1
    lines = [json.loads(ln) for ln in open(path)]
    assert jax_slo.validate_slo_stream(lines) == []
    assert lines[-1]["sessions"] == 2 and lines[-1]["recompiles"]["after_warmup"] == 0
