"""PyTorch port, the span tracer as the one span system
(``runtime/tracing.py``): its spans reach a recording ``torch.profiler``
as ``erp:<name>`` ranges, its device records share its clock, every span
of a session carries the session's workunit, and the stages that the
command line's start-up and the rescoring hid are spanned.

On the CPU: a CPU ``torch.profiler`` stands in for the card's, a fake
plan cache for cuFFT's.  Tolerances: the clocks of a span and a profiler
range opened together agree within 1 ms; everything else is exact.
"""

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu_torch.io import empty_candidates, write_template_bank, write_workunit
from boinc_app_eah_brp_tpu_torch.models import search
from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig, rescore
from boinc_app_eah_brp_tpu_torch.oracle.stats import base_thresholds
from boinc_app_eah_brp_tpu_torch.oracle.toplist import finalize_candidates, update_toplist_from_maxima
from boinc_app_eah_brp_tpu_torch.runtime import metrics, profiling, resilience, steptime, tracing
from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs, run_search
from boinc_app_eah_brp_tpu_torch.serving import FleetServer
from boinc_app_eah_brp_tpu_torch.tools import trace_report
from fixtures import small_bank, synthetic_timeseries
from torch_parity import DT

N = 4096
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("ERP_TRACE_FILE", "ERP_CORR_ID", "ERP_METRICS_FILE", "ERP_STEPTIME_PROFILE", "ERP_PROFILE_DIR",
              "ERP_TRACE_LANE", "ERP_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("ERP_METRICS_INTERVAL", "0")
    monkeypatch.setenv("ERP_RESULT_DATE", "2008-11-12T00:00:00+00:00")


@pytest.fixture
def default_trace():
    """The default tracer armed in memory for one test, closed after it."""
    assert tracing.configure(force=True)
    yield tracing.default_context()
    tracing.finish(0)


def _profiled(fn, path):
    """``fn()`` under a CPU ``torch.profiler``; returns the exported Chrome
    trace."""
    prof = profiling.start_profiler(with_cuda=False)
    try:
        fn()
    finally:
        profiling.stop_profiler(prof, with_cuda=False)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)


def _ranges(doc, name):
    return [e for e in doc["traceEvents"] if e.get("ph") == "X" and e.get("name") == name]


@pytest.mark.parametrize("armed", [False, True])
def test_a_span_is_a_profiler_range_while_a_profiler_records(tmp_path, armed):
    ctx = tracing.TraceContext(name="t-range")
    if armed:
        assert ctx.configure(force=True)

    def body():
        with ctx.span("probe", n=1):
            with ctx.span("inner"):
                time.sleep(0.002)

    doc = _profiled(body, tmp_path / "p.json")
    (probe,), (inner,) = _ranges(doc, "erp:probe"), _ranges(doc, "erp:inner")
    assert probe["cat"] == "user_annotation"
    assert probe["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= probe["ts"] + probe["dur"]
    if armed:
        assert [r["name"] for r in ctx.events()] == ["inner", "probe"]
        ctx.finish(0)


def test_no_profiler_no_range():
    ctx = tracing.TraceContext(name="t-norange")
    assert ctx.span("probe") is tracing._NULL_SPAN
    ctx.configure(force=True)
    with ctx.span("probe") as sp:
        assert sp._rf is None
    ctx.finish(0)


def test_the_disabled_path_imports_no_torch():
    code = (
        "import sys\n"
        "from boinc_app_eah_brp_tpu_torch.runtime import tracing\n"
        "with tracing.span('x', n=1) as s:\n"
        "    s.set(m=2)\n"
        "assert tracing.span('y') is tracing._NULL_SPAN\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "ERP_TRACE_FILE"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_profiler_records_land_on_the_tracers_clock(tmp_path):
    """A span and a ``record_function`` opened together on one thread, and
    the span's own ``erp:`` range, moved onto the tracer's clock
    (``steptime.on_tracer_clock``, what ``capture_profile`` does with the
    card's records) and merged into its export, sit within 1 ms of the
    span."""
    ctx = tracing.TraceContext(name="t-clock")
    assert ctx.configure(force=True)
    time.sleep(0.05)  # the two bases must not agree by accident

    def body():
        # a process's first range pays torch's op lookup (~1.4 ms here)
        with torch.profiler.record_function("warm-up"):
            pass
        with ctx.span("probe"), torch.profiler.record_function("probe-rf"):
            time.sleep(0.02)

    doc = _profiled(body, tmp_path / "p.json")
    recs = [
        {"name": e["name"], "tid": "device:measured", "ts_us": e["ts"], "dur_us": e["dur"], "end_us": e["ts"] + e["dur"]}
        for name in ("probe-rf", "erp:probe") for e in _ranges(doc, name)
    ]
    assert len(recs) == 2
    assert ctx.add_device_records(steptime.on_tracer_clock(recs, doc, ctx.epoch_unix())) == 2
    events = ctx.chrome_trace()["traceEvents"]
    ctx.finish(0)
    begins = {e["name"]: e["ts"] for e in events if e.get("ph") == "B"}
    ends = {e["name"]: e["ts"] for e in events if e.get("ph") == "E"}
    for name in ("probe-rf", "erp:probe"):
        assert abs(begins[name] - begins["probe"]) < 1000.0, (name, begins)
        assert abs(ends[name] - ends["probe"]) < 1000.0, (name, ends)
    # unconverted, the profiler's clock is nowhere near the tracer's
    assert all(abs(r["ts_us"] - begins["probe"]) > 1e6 for r in recs)


def test_trace_report_names_each_idle_gap_by_the_innermost_span_on_any_thread():
    """The benchmark's rule: a device idle gap is put down to the innermost
    host span open at its middle, whichever thread opened it."""
    spans = [
        {"name": "template loop", "tid": "MainThread", "ts_us": 0.0, "end_us": 1000.0, "dur_us": 1000.0, "depth": 0},
        {"name": "drain", "tid": "MainThread", "ts_us": 100.0, "end_us": 300.0, "dur_us": 200.0, "depth": 1},
        {"name": "rescore.fft", "tid": "pool-1", "ts_us": 500.0, "end_us": 900.0, "dur_us": 400.0, "depth": 0},
        {"name": "erp.rfft", "tid": "device:measured", "ts_us": 0.0, "end_us": 100.0, "dur_us": 100.0},
        {"name": "erp.fold", "tid": "device:measured", "ts_us": 300.0, "end_us": 400.0, "dur_us": 100.0},
        {"name": "erp.merge", "tid": "device:measured", "ts_us": 350.0, "end_us": 420.0, "dur_us": 70.0},
        {"name": "erp.rfft", "tid": "device:measured", "ts_us": 900.0, "end_us": 950.0, "dur_us": 50.0},
        {"name": "erp.fold", "tid": "device:measured", "ts_us": 1500.0, "end_us": 1600.0, "dur_us": 100.0},
    ]
    gaps = trace_report.idle_gaps({"spans": spans})
    assert gaps == [
        {"s": 550e-6, "span": "host"},  # 950-1500: no span open at 1225
        {"s": 480e-6, "span": "rescore.fft"},  # 420-900: the pool's span, inside the loop
        {"s": 200e-6, "span": "drain"},  # 100-300
    ]


def _toplist():
    ts = synthetic_timeseries(N, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0).astype(np.float32)
    cfg = SearchConfig(window=200, padding=1.5)
    d = DerivedParams.derive(N, DT * 1e6, cfg)
    b = small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2)
    P, tau, psi0 = b.P, b.tau, search.normalize_psi0(b.psi0)
    geom = search.SearchGeometry.from_derived(
        d, max_slope=search.max_slope_for_bank(P, tau), lut_step=search.lut_step_for_bank(P, DT),
        lut_tiles=search.lut_tiles_for_bank(P, psi0, N, DT), exact_mean=True,
    )
    M, T = search.run_bank(torch.from_numpy(ts), P, tau, psi0, geom, batch_size=2)
    cands = update_toplist_from_maxima(
        empty_candidates(), search.state_to_natural(M, geom), search.state_to_natural(T, geom),
        P.astype(np.float32), tau.astype(np.float32), psi0.astype(np.float32),
        base_thresholds(cfg.fA, d.fft_size), geom.window_2,
    )
    return ts, d, cands, finalize_candidates(cands, d.t_obs)


@pytest.mark.parametrize("chunk", [1, 3])
def test_rescoring_spans_each_oracle_pass_and_counts_it(default_trace, monkeypatch, chunk):
    ts, d, cands, emitted = _toplist()
    monkeypatch.setattr(rescore, "DEVICE_CHUNK", chunk)
    assert metrics.configure(force=True)
    try:
        with tracing.for_workunit("wu-7"):
            _, n_eval = rescore.rescore_winners(torch.from_numpy(ts), cands, emitted, d)
        counted = metrics.snapshot()["counters"]["rescore.templates"]["value"]
    finally:
        metrics.finish(0)
    assert n_eval == rescore.unique_winner_count(emitted) > 1
    assert counted == n_eval
    spans = [r for r in tracing.events() if r["name"].startswith("rescore.")]
    for stage in ("rescore.fft", "rescore.harmonics"):
        mine = [r for r in spans if r["name"] == stage]
        assert len(mine) == n_eval, stage
        assert len({r["args"]["template"] for r in mine}) == n_eval
    assert sum(r["name"] == "rescore.device-resample" for r in spans) == -(-n_eval // chunk)
    assert not any(r["name"] == "rescore.resample" for r in spans)
    # the pass runs on the calling thread and carries its workunit
    assert {r.get("wu") for r in spans} == {"wu-7"}


def _fixture_files(tmp_path, n):
    bank = str(tmp_path / "bank.dat")
    write_template_bank(bank, small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2))
    wus = []
    for i in range(n):
        ts = synthetic_timeseries(N, f_signal=31.0 + 2.0 * i, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0, seed=i)
        path = str(tmp_path / f"wu{i}.bin4")
        write_workunit(path, ts, tsample_us=500.0, scale=1.0, dm=55.5)
        wus.append(path)
    return bank, wus


def test_two_served_workunits_give_two_ids_each_with_its_queue_wait(tmp_path, default_trace):
    bank, wus = _fixture_files(tmp_path, 2)
    args = [DriverArgs(inputfile=w, outputfile=str(tmp_path / f"o{i}.cand"), templatebank=bank,
                       checkpointfile=str(tmp_path / f"o{i}.cpt"), window=200, batch_size=2, device="cpu")
            for i, w in enumerate(wus)]
    with FleetServer(name="t-wu", device="cpu") as server:
        tickets = [server.submit(a) for a in args]
        assert all(server.result(t).ok for t in tickets)
    spans = [r for r in tracing.events() if r.get("kind") == "span"]
    ids = {r["wu"] for r in spans if "wu" in r}
    assert ids == set(tickets)
    for wu in ids:
        names = {r["name"] for r in spans if r.get("wu") == wu}
        assert {"exec-wait", "setup", "input-read", "template loop", "result-write"} <= names, (wu, names)
    # the prep thread's spans carry their workunit too
    assert {r["wu"] for r in spans if r["name"] == "setup"} == set(tickets)


def test_the_command_line_spans_its_start_and_its_files(tmp_path, monkeypatch):
    bank, (wu,) = _fixture_files(tmp_path, 1)
    trace = str(tmp_path / "run.trace.jsonl")
    monkeypatch.setenv("ERP_TRACE_FILE", trace)
    args = DriverArgs(inputfile=wu, outputfile=str(tmp_path / "out.cand"), templatebank=bank,
                      checkpointfile=str(tmp_path / "out.cpt"), window=200, batch_size=2, device="cpu",
                      metrics_file=str(tmp_path / "m.jsonl"))
    assert run_search(args) == 0
    with open(trace) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    assert tracing.validate_stream(lines) == []
    spans = [r for r in lines if r.get("kind") == "span"]
    names = {r["name"] for r in spans}
    assert {"startup", "import", "input-read", "ckpt-write", "result-write", "rescore.device-resample",
            "oracle rescore", "rescore.fft"} <= names
    assert "cuda-init" not in names  # a CPU run makes no CUDA context
    # the workunit file's name without ERP_CORR_ID, on the session's spans
    assert {r.get("wu") for r in spans if r["name"] in ("input-read", "result-write", "ckpt-write")} == {"wu0.bin4"}
    assert {r["args"]["what"] for r in spans if r["name"] == "input-read"} == {"bank", "checkpoint", "workunit"}
    with open(str(tmp_path / "m.jsonl") + ".report.json") as f:
        report = json.load(f)
    n_fft = sum(1 for r in spans if r["name"] == "rescore.fft")
    assert report["metrics"]["counters"]["rescore.templates"]["value"] == n_fft > 0


def test_a_cufft_plan_is_spanned_on_its_first_key_until_the_cache_is_cleared(default_trace, monkeypatch):
    from boinc_app_eah_brp_tpu_torch.ops import kernels

    cache = types.SimpleNamespace(size=0, clear=lambda: setattr(cache, "size", 0))

    def plan(x, **kw):
        cache.size += 1

    monkeypatch.setattr(torch.backends.cuda, "cufft_plan_cache", [cache])
    monkeypatch.setattr(kernels, "planned_keys", set())
    card = types.SimpleNamespace(device=torch.device("cuda", 0), shape=(8, 96), dtype=torch.float32)
    for _ in range(3):
        kernels.planned_fft(plan, card)
    kernels.planned_fft(plan, types.SimpleNamespace(device=card.device, shape=(4, 96), dtype=torch.float32))
    kernels.planned_fft(plan, card, n=96)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    resilience.release_device_memory()
    assert kernels.planned_keys == set()
    kernels.planned_fft(plan, card)
    shapes = [r["args"]["shape"] for r in tracing.events() if r["name"] == "cufft-plan"]
    assert shapes == ["(8, 96)", "(4, 96)", "(8, 96)", "(8, 96)"]


def test_spans_of_many_threads_stream_in_order_each_with_its_workunit(tmp_path):
    """More threads than cores close spans at once: the stream stays
    ordered by end_us (each record is written under the lock that stamps
    it) and every span carries its own thread's workunit."""
    import threading

    ctx = tracing.TraceContext(name="t-stress")
    path = str(tmp_path / "s.jsonl")
    assert ctx.configure(trace_file=path)
    n_threads, n_spans = 4 * (os.cpu_count() or 1), 100

    def work(i):
        with tracing.for_workunit(f"wu-{i}"):
            for _ in range(n_spans):
                with ctx.span("outer"):
                    with ctx.span("inner"):
                        pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    ctx.finish(0)
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    assert tracing.validate_stream(lines) == []
    spans = [r for r in lines if r.get("kind") == "span"]
    assert len(spans) == 2 * n_threads * n_spans
    by_tid = {}
    for r in spans:
        by_tid.setdefault(r["tid"], set()).add(r["wu"])
    assert all(len(ids) == 1 for ids in by_tid.values())
    assert len({next(iter(ids)) for ids in by_tid.values()}) == n_threads
