"""PyTorch port, observability layers against the JAX package's: metrics,
tracing, steptime, the flight recorder, ObsContext, percentiles and
profiling.

Each layer is driven through the same call sequence in both packages, on
scoped contexts (no process-global state), and the records must be equal
once the fields that hold a clock reading are set aside (``t``,
``ts_us``, ``end_us``, ``dur_us``, ``wall_s``, ...).  Every artifact one
package writes must pass the other package's validator.  A CPU CLI run of
the port with ``--metrics-file`` must register the counters the JAX
driver registers on the same synthetic workunit, with equal
``search.batches`` and ``search.templates`` (the ``jax.*`` counters, and
the port's ``torch.*`` build counters and its own ``rescore.templates``,
``rescore.device_resamples`` and ``rescore.device_ffts``, aside).  Tolerance: exact
(integers, strings and the values the test itself feeds in).
"""

import json
import os

import numpy as np
import pytest

from boinc_app_eah_brp_tpu.runtime import flightrec as jfr
from boinc_app_eah_brp_tpu.runtime import metrics as jm
from boinc_app_eah_brp_tpu.runtime import obs as jobs
from boinc_app_eah_brp_tpu.runtime import percentiles as jpct
from boinc_app_eah_brp_tpu.runtime import steptime as jst
from boinc_app_eah_brp_tpu.runtime import tracing as jtr
from boinc_app_eah_brp_tpu_torch.runtime import flightrec as pfr
from boinc_app_eah_brp_tpu_torch.runtime import metrics as pm
from boinc_app_eah_brp_tpu_torch.runtime import obs as pobs
from boinc_app_eah_brp_tpu_torch.runtime import percentiles as ppct
from boinc_app_eah_brp_tpu_torch.runtime import profiling as pprof
from boinc_app_eah_brp_tpu_torch.runtime import steptime as pst
from boinc_app_eah_brp_tpu_torch.runtime import tracing as ptr
from fixtures import small_bank, synthetic_timeseries
from torch_parity import DT

# fields that hold a clock reading (a histogram's bucket counts too, where
# it times spans; the fed ones are compared on their own), and the run
# report's device list (the JAX process lists its CPU devices, the port its
# cards: none here)
UNCOMPARED = {
    "t", "ts", "ts_us", "end_us", "dur_us", "wall_s", "wall_us", "uptime_s", "generated_unix",
    "epoch_unix", "ms", "sum", "min", "max", "counts", "argv", "pid", "devices",
}
ENV_KNOBS = (
    "ERP_METRICS_FILE", "ERP_RUN_REPORT", "ERP_CORR_ID", "ERP_TRACE_FILE", "ERP_STEPTIME",
    "ERP_STEPTIME_FILE", "ERP_STEPTIME_PROFILE", "ERP_PROFILE_DIR", "ERP_BLACKBOX_DIR",
    "ERP_FAULT_SPEC", "ERP_FAULT_STATE", "ERP_TRACE_LANE", "ERP_PROCESS_ID",
)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("ERP_METRICS_INTERVAL", "0")  # no heartbeat threads
    yield


def _strip(x):
    """``x`` without the UNCOMPARED fields."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in UNCOMPARED}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _jsonl(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _drive_metrics(mod, ctx):
    ctx.counter("search.batches").inc()
    ctx.counter("search.batches").inc(2)
    ctx.counter("checkpoint.bytes", unit="B").inc(4096)
    ctx.gauge("autobatch.decision").set("memory-model")
    ctx.gauge("driver.fraction_done").set(0.5)
    h = ctx.histogram("search.dispatch_ms", mod.LATENCY_BUCKETS_MS, unit="ms")
    for v in (0.5, 3.0, 40.0, 40000.0):
        h.observe(v)
    ctx.record_phase("template loop", 1.25)
    ctx.note_trace("prof")
    ctx.note_host_trace("trace.jsonl")


def test_metrics_same_calls_same_records(tmp_path):
    out = {}
    for name, mod in (("jax", jm), ("port", pm)):
        ctx = mod.MetricsContext(name=f"t-{name}")
        path = str(tmp_path / f"{name}.jsonl")
        assert ctx.configure(metrics_file=path, interval=0)
        _drive_metrics(mod, ctx)
        report = ctx.finish(0, context={"inputfile": "wu.bin4"})
        out[name] = (report, _jsonl(path), json.load(open(path + ".report.json")))
    (jrep, jlines, jfile), (prep, plines, pfile) = out["jax"], out["port"]
    assert _strip(prep) == _strip(jrep)
    assert _strip(pfile) == _strip(jfile)
    assert [_strip(r) for r in plines] == [_strip(r) for r in jlines]
    assert prep["metrics"]["histograms"]["search.dispatch_ms"]["counts"] == jrep["metrics"]["histograms"]["search.dispatch_ms"]["counts"]
    # each package's validator accepts the other's report
    assert pm.validate_report(jfile) == [] and jm.validate_report(pfile) == []
    assert _strip(pm.compact_report(pfile)) == _strip(jm.compact_report(jfile))


def _drive_tracing(ctx):
    c = ctx.new_context()
    with ctx.span("setup"):
        pass
    with ctx.span("dispatch", start=0, stop=2):
        ctx.instant("step-measured", start=0, stop=2, ms=1.5)
    ctx.set_context(c)
    with ctx.span("drain", stop=2):
        with ctx.span("ckpt-write", n_template=2):
            pass
    try:
        with ctx.span("result-write"):
            raise OSError("injected")
    except OSError:
        pass
    ctx.add_device_records([{"name": "erp.fold", "tid": "device:measured", "ts_us": 1.0, "dur_us": 2.0}])


def test_tracing_same_calls_same_records(tmp_path):
    out = {}
    for name, mod in (("jax", jtr), ("port", ptr)):
        ctx = mod.TraceContext(name=f"t-{name}")
        path = str(tmp_path / f"{name}.jsonl")
        assert ctx.configure(trace_file=path)
        _drive_tracing(ctx)
        summary = ctx.finish(0)
        out[name] = (summary, _jsonl(path), json.load(open(path + ".chrome.json")))
    (js, jlines, jchrome), (ps, plines, pchrome) = out["jax"], out["port"]
    assert [_strip(r) for r in plines] == [_strip(r) for r in jlines]
    strip_summary = lambda s: {k: v for k, v in _strip(s).items() if not k.endswith("_file")}  # noqa: E731
    assert strip_summary(ps) == strip_summary(js)
    assert _strip(pchrome) == _strip(jchrome)
    assert jtr.validate_stream(plines) == [] and ptr.validate_stream(jlines) == []
    assert jtr.validate_chrome(pchrome) == [] and ptr.validate_chrome(jchrome) == []


def test_steptime_same_records_and_stream(tmp_path):
    out = {}
    for name, mod in (("jax", jst), ("port", pst)):
        ctx = mod.StepTimeContext(name=f"t-{name}")
        path = str(tmp_path / f"{name}.jsonl")
        assert ctx.configure(steptime_file=path)
        for start, ms in ((0, 2.0), (4, 3.0), (8, 1.0)):
            ctx.record(start, start + 4, ms)
        records = ctx.records()
        summary = ctx.finish(0)
        out[name] = (records, summary, _jsonl(path))
    (jr, jsum, jlines), (pr, psum, plines) = out["jax"], out["port"]
    assert _strip(pr) == _strip(jr)
    assert psum == jsum  # from the fed ms values only
    assert [_strip(r) for r in plines] == [_strip(r) for r in jlines]
    assert jst.validate_stream(plines) == [] and pst.validate_stream(jlines) == []


def test_steptime_cpu_bracket_records_each_window():
    """On the CPU the bracket is the wall clock; ``flush`` has nothing to
    wait for; the disabled recorder is the shared no-op."""
    ctx = pst.StepTimeContext(name="cpu")
    assert ctx.recorder("cpu") is pst._NULL_RECORDER
    ctx.configure(force=True)
    rec = ctx.recorder("cpu")
    for start in (0, 2):
        rec.begin()
        rec.observe(None, start, start + 2)
    rec.flush()
    assert [(r["start"], r["stop"]) for r in ctx.records()] == [(0, 2), (2, 4)]
    assert all(r["ms"] >= 0 for r in ctx.records())
    ctx.finish(0)


def test_flightrec_same_events_and_dumps_validate(tmp_path):
    import torch  # the torch section reads torch only when the process has loaded it

    docs = {}
    for name, mod in (("jax", jfr), ("port", pfr)):
        rec = mod.Recorder(name=f"t-{name}")
        assert rec.arm(dump_dir=str(tmp_path / name), context={"inputfile": "wu.bin4"})
        os.makedirs(tmp_path / name, exist_ok=True)
        rec.record("autobatch", batch=32, decision="memory-model")
        rec.record("dispatch", start=0, stop=32, ms=1.0)
        rec.note_dispatch(loop="run_bank", start=0, stop=32, n_total=200, batch_size=32)
        try:
            raise RuntimeError("CUDA out of memory")
        except RuntimeError as e:
            path = rec.dump("exit-code-1", exc=e)
        rec.disarm()
        docs[name] = json.load(open(path))
    j, p = docs["jax"], docs["port"]
    for key in ("schema", "reason", "context", "dispatch"):
        assert _strip(p[key]) == _strip(j[key])
    assert _strip(p["events"]) == _strip(j["events"])
    assert p["exception"]["type"] == j["exception"]["type"] == "RuntimeError"
    assert jfr.validate_dump(p) == [] and pfr.validate_dump(j) == []
    # the port's torch section: the version, and no CUDA context made
    assert p["torch"] == {"version": torch.__version__, "cuda": None} and "jax" not in p


def test_flightrec_torch_section_survives_cuda_errors(monkeypatch):
    """After a sticky CUDA error every query raises; the dump still gets
    a torch section with the failures noted."""
    import torch

    def boom(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    for fn in ("current_device", "memory_allocated", "memory_reserved", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, fn, boom)
    info = pfr._torch_info()
    assert set(info["errors"]) == {"device", "memory_allocated", "memory_reserved", "max_memory_allocated"}


def test_obscontext_bundles_match(tmp_path):
    out = {}
    for name, mod in (("jax", jobs), ("port", pobs)):
        bundle = mod.ObsContext(name=f"t-{name}").configure(
            metrics_file=str(tmp_path / f"{name}.m.jsonl"), metrics_interval=0,
            trace_file=str(tmp_path / f"{name}.t.jsonl"), dump_dir=str(tmp_path),
        )
        with bundle.tracing.span("dispatch", start=0, stop=2):
            bundle.metrics.counter("search.batches").inc()
        bundle.flightrec.record("dispatch", start=0, stop=2)
        out[name] = bundle.close(0)
    assert _strip(out["port"]["run_report"]) == _strip(out["jax"]["run_report"])
    strip_summary = lambda s: {k: v for k, v in _strip(s).items() if not k.endswith("_file")}  # noqa: E731
    assert strip_summary(out["port"]["tracing"]) == strip_summary(out["jax"]["tracing"])


@pytest.mark.parametrize("values", [[], [3.0], [5.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.3, 5.8]])
def test_percentiles_match(values):
    assert ppct.latency_block(values) == jpct.latency_block(values)
    s = sorted(values)
    for q in (0.0, 50.0, 95.0, 99.0, 100.0):
        if s:
            assert ppct.percentile(s, q) == jpct.percentile(s, q)


def test_profiling_cpu_phase_and_memory(tmp_path):
    """On the CPU there is no card to walk; a phase lands in the metrics
    registry as the JAX package's does."""
    assert pprof.memory_stats() == []
    ctx = pm.default_context()
    assert ctx.configure(metrics_file=str(tmp_path / "m.jsonl"), interval=0)
    try:
        with pprof.phase("whitening"):
            pass
        assert pm.snapshot()["phases"]["whitening"]["count"] == 1
    finally:
        pm.finish(0)


def test_profile_dir_trace_and_idle_share(tmp_path):
    """``profiling.trace`` writes a Chrome trace; its device records (none
    on the CPU) give the card's idle share, and a synthetic record set
    gives the union of busy intervals."""
    with pprof.trace(str(tmp_path / "prof")) as prof:
        np.fft.rfft(np.ones(64))
    assert prof is not None
    doc = json.load(open(tmp_path / "prof" / pprof.TRACE_NAME))
    assert pst.device_records_from_chrome(doc) == []
    recs = [
        {"name": "stream_kernel", "ts_us": 0.0, "dur_us": 4.0, "end_us": 4.0},
        {"name": "regular_fft_c2r", "ts_us": 2.0, "dur_us": 4.0, "end_us": 6.0},
        {"name": "fold_kernel", "ts_us": 8.0, "dur_us": 2.0, "end_us": 10.0},
    ]
    idle = pst.device_idle_share(recs)
    assert idle["busy_us"] == 8.0 and idle["span_us"] == 10.0 and idle["idle_share"] == pytest.approx(0.2)
    assert idle["gaps"] == [{"us": 2.0, "after": "regular_fft_c2r", "before": "fold_kernel"}]
    assert [r["args"]["stage"] for r in pst.stage_records(recs)] == ["resample", "rfft", "fold"]
    assert pst.stage_of_kernel("fftprep_kernel") == "fftprep"
    assert pst.stage_of_kernel("exact_mean_kernel") == "serial_mean"
    assert pst.stage_of_kernel("elementwise_kernel") is None


def _workunit(tmp_path):
    from boinc_app_eah_brp_tpu_torch.io import write_template_bank, write_workunit

    ts = synthetic_timeseries(4096, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    write_workunit(str(tmp_path / "wu.bin4"), ts, tsample_us=DT * 1e6, scale=1.0)
    write_template_bank(str(tmp_path / "bank.dat"), small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2))


def test_cli_metrics_file_matches_jax_driver(tmp_path, monkeypatch):
    from boinc_app_eah_brp_tpu.runtime.cli import main as jax_main
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main as port_main

    _workunit(tmp_path)
    monkeypatch.chdir(tmp_path)
    common = "-i wu.bin4 -t bank.dat -B 200 --batch 2"
    assert port_main(f"{common} -o p.cand -c p.cpt --device cpu --metrics-file p.jsonl".split()) == 0
    assert jax_main(f"{common} -o j.cand -c j.cpt --mesh 1 --metrics-file j.jsonl".split()) == 0
    reports = {k: json.load(open(tmp_path / f"{k}.jsonl.report.json")) for k in ("p", "j")}
    assert pm.validate_report(reports["p"]) == [] and jm.validate_report(reports["p"]) == []
    counters = {k: r["metrics"]["counters"] for k, r in reports.items()}
    names = {k: {n for n in c if not n.startswith(("jax.", "torch."))} for k, c in counters.items()}
    # the port counts its oracle passes and those resampled and transformed
    # on its device; the JAX package has no such counters
    own = {"rescore.templates", "rescore.device_resamples", "rescore.device_ffts"}
    assert len({counters["p"][name]["value"] for name in own}) == 1 and counters["p"]["rescore.templates"]["value"] > 0
    assert names["p"] - own == names["j"]
    for name in ("search.batches", "search.templates", "checkpoint.count"):
        assert counters["p"][name]["value"] == counters["j"][name]["value"], name
    assert reports["p"]["metrics"]["phases"].keys() == reports["j"]["metrics"]["phases"].keys()
    lines = _jsonl(tmp_path / "p.jsonl")
    assert lines[0]["kind"] == "start" and lines[-1]["kind"] == "run_report"
