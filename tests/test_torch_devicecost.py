"""PyTorch port, the device-cost stage registry (``runtime/devicecost.py``)
and the candidate comparison (``io/validate.py``), against the JAX
package's.

Exact equality throughout: the registry, the scope parser, the estimated
device lane and the candidate comparison are plain Python on the same
inputs; the stage scopes must change no byte of (M, T) and add no kernel
build and no cuFFT plan."""

import json
import os
import re

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu.io import validate as jvalidate
from boinc_app_eah_brp_tpu.runtime import devicecost as jdc
from boinc_app_eah_brp_tpu_torch.io import validate
from boinc_app_eah_brp_tpu_torch.models import search
from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
from boinc_app_eah_brp_tpu_torch.runtime import devicecost, metrics, profiling, steptime, tracing
from fixtures import small_bank, synthetic_timeseries

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "boinc_app_eah_brp_tpu_torch", "csrc")


def _kernels_in_csrc() -> list[str]:
    names = []
    for f in sorted(os.listdir(CSRC)):
        if f.endswith((".cu", ".cuh")):
            src = open(os.path.join(CSRC, f)).read()
            names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    return names


def test_every_cuda_kernel_maps_to_a_registered_stage():
    names = _kernels_in_csrc()
    assert len(names) == 9, names
    for name in names:
        stage = devicecost.stage_of_kernel(name)
        assert stage in devicecost.STAGES, (name, stage)
    # the search's R2C (csrc/rfft.cu), by its names as the profiler shows them
    for name in ("r2c_fft_cols_kernel", "r2c_fft_rows_kernel"):
        assert name in names
        shown = f"void (anonymous namespace)::{name}<2048>((anonymous namespace)::c32 const*, int)"
        assert devicecost.stage_of_kernel(shown) == "rfft", shown
    # cuFFT's kernels land on the rfft stage
    assert devicecost.stage_of_kernel("regular_fft_c2r_kernel") == "rfft"
    # and so does an R2C's post-pass, the kernel of its that names no fft
    assert devicecost.stage_of_kernel("void postprocess_kernel<float, unsigned int, (loadstore_modifier_t)2>") == "rfft"


def test_registry_extends_the_jax_registry():
    for scope, bucket in jdc.STAGES.items():
        assert devicecost.STAGES[scope] == bucket
    assert set(devicecost.STAGES) - set(jdc.STAGES) == {"serial_mean", "fold", "rfft"}
    assert devicecost.scope_name("fft") == jdc.scope_name("fft") == "erp.fft"
    with pytest.raises(KeyError):
        devicecost.scope_name("nope")
    with pytest.raises(KeyError):
        devicecost.stage_scope("nope")


def test_steptime_reexports_the_kernel_map():
    assert steptime.stage_of_kernel is devicecost.stage_of_kernel
    assert steptime.SCOPE_PREFIX == devicecost.SCOPE_PREFIX


@pytest.mark.parametrize("stage", sorted(jdc.STAGES))
def test_scopes_and_ledger_buckets_match_jax(stage):
    assert devicecost.scope_name(stage) == jdc.scope_name(stage)
    assert devicecost.STAGES[stage] == jdc.ledger_stage(stage)


def _span(name, ctx, ts, end, tid="MainThread"):
    return {"kind": "span", "name": name, "tid": tid, "ctx": ctx, "ts_us": ts, "end_us": end, "dur_us": end - ts, "depth": 0}


SPAN_LISTS = {
    "empty": [],
    "lookahead-then-drain": [
        _span("dispatch", 1, 0.0, 10.0),
        _span("dispatch", 2, 200.0, 210.0),
        _span("drain", 2, 300.0, 350.0),
        _span("checkpoint", 2, 360.0, 400.0),
    ],
    "open-at-end": [_span("dispatch", 1, 0.0, 10.0), _span("dispatch", 2, 20.0, 45.0)],
    "drain-first": [_span("drain", 0, 0.0, 5.0), _span("dispatch", 1, 6.0, 9.0), _span("drain", 1, 9.0, 30.0)],
    "unsorted": [_span("drain", 1, 90.0, 120.0), _span("dispatch", 1, 10.0, 12.0), _span("dispatch", 2, 50.0, 51.0)],
}


@pytest.mark.parametrize("name", sorted(SPAN_LISTS))
def test_dispatch_windows_and_estimated_records_match_jax(name):
    spans = SPAN_LISTS[name]
    windows = devicecost.dispatch_windows(spans)
    assert windows == jdc.dispatch_windows(spans)
    model = [
        {"stage": "a", "scope": "resample", "fraction": 0.25, "bound": "bytes"},
        {"stage": "b", "scope": "fft", "fraction": 0.75, "bound": "bytes"},
        {"stage": "c", "scope": "merge", "fraction": 0.0, "bound": "bytes"},
    ]
    assert devicecost.estimate_device_records(windows, model) == jdc.estimate_device_records(windows, model)


def test_estimated_spans_stay_inside_their_window_where_jax_runs_over():
    """Two abutting windows of 1.3 us: the rounded widths of the JAX
    version's three spans sum to 1.4 us, so its last span ends after the
    next window's first begins and the Chrome export's nesting breaks.
    The port clamps that span to its window; every other span is the JAX
    version's (Queue 3, PR 12)."""
    windows = [(1, 0.0, 1.3), (2, 1.3, 2.6)]
    model = [
        {"stage": "a", "scope": "resample", "fraction": 0.37, "bound": "bytes"},
        {"stage": "b", "scope": "fft", "fraction": 0.28, "bound": "bytes"},
        {"stage": "c", "scope": "merge", "fraction": 0.35, "bound": "bytes"},
    ]
    jax_recs = jdc.estimate_device_records(windows, model)
    port_recs = devicecost.estimate_device_records(windows, model)
    assert jax_recs[2]["end_us"] > jax_recs[3]["ts_us"]  # the JAX overrun
    assert port_recs[2]["end_us"] == port_recs[3]["ts_us"] == 1.3
    assert port_recs[2]["dur_us"] == 0.4 and jax_recs[2]["dur_us"] == 0.5
    assert [r for i, r in enumerate(port_recs) if i not in (2, 5)] == [
        r for i, r in enumerate(jax_recs) if i not in (2, 5)]
    for a, b in zip(port_recs, port_recs[1:]):
        assert a["end_us"] <= b["ts_us"]
    ctx = tracing.TraceContext(name="clamp")
    for recs, ok in ((port_recs, True), (jax_recs, False)):
        doc = ctx.chrome_trace(records=[], device=[dict(r, kind="span") for r in recs])
        assert (tracing.validate_chrome(doc) == []) == ok


def test_stage_time_model_partitions_the_batch():
    model = devicecost.stage_time_model(12582912, 1 << 22, 329551, 5272824, batch=32, card="h100")
    assert [r["stage"] for r in model] == ["resample", "fftprep", "rfft", "fold_spectrum", "merge"]
    assert sum(r["fraction"] for r in model) == pytest.approx(1.0)
    assert all(r["scope"] in devicecost.STAGES for r in model)
    assert max(model, key=lambda r: r["fraction"])["scope"] == "fft"


def _setup():
    ts = synthetic_timeseries(4096, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    derived = DerivedParams.derive(len(ts), 500.0, SearchConfig(window=200, white=False))
    bank = small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2)
    geom = search.SearchGeometry.from_derived(
        derived,
        exact_mean=True,
        max_slope=search.max_slope_for_bank(bank.P, bank.tau),
        lut_step=search.lut_step_for_bank(bank.P, derived.dt),
        lut_tiles=search.lut_tiles_for_bank(bank.P, bank.psi0, derived.n_unpadded, derived.dt),
    )
    return torch.from_numpy(ts), bank, geom


def test_stage_scopes_change_no_byte_and_add_no_build(monkeypatch, tmp_path):
    from contextlib import nullcontext

    from boinc_app_eah_brp_tpu_torch.ops import resample

    ts, bank, geom = _setup()
    metrics.configure(force=True)
    try:
        with profiling.trace(str(tmp_path / "prof")):
            M, T = search.run_bank(ts, bank.P, bank.tau, bank.psi0, geom, batch_size=3)
            scoped = (M.numpy().copy(), T.numpy().copy())
        counters = metrics.snapshot()["counters"]
        assert counters.get("torch.kernel_builds", {}).get("value", 0) == 0
        assert counters.get("torch.cufft_plans", {}).get("value", 0) == 0
    finally:
        metrics.finish(0)
    # the profiler's trace carries the scopes as named ranges
    doc = json.load(open(tmp_path / "prof" / profiling.TRACE_NAME))
    names = {ev.get("name") for ev in doc["traceEvents"]}
    for stage in ("bank-slice", "resample", "serial_mean", "fftprep", "fft", "sumspec", "merge"):
        assert devicecost.scope_name(stage) in names, stage
    # the same search without any scope
    monkeypatch.setattr(search, "stage_scope", lambda stage: nullcontext())
    monkeypatch.setattr(resample, "stage_scope", lambda stage: nullcontext())
    M, T = search.run_bank(ts, bank.P, bank.tau, bank.psi0, geom, batch_size=3)
    assert scoped[0].tobytes() == M.numpy().tobytes() and scoped[1].tobytes() == T.numpy().tobytes()


def test_estimated_lane_on_a_cpu_run(tmp_path, monkeypatch):
    from boinc_app_eah_brp_tpu_torch.io import write_template_bank, write_workunit
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main

    ts = synthetic_timeseries(4096, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    write_workunit(str(tmp_path / "wu.bin4"), ts, tsample_us=500.0, scale=1.0)
    write_template_bank(str(tmp_path / "bank.dat"), small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv(tracing.TRACE_FILE_ENV, str(tmp_path / "tr.jsonl"))
    assert main("-i wu.bin4 -o o.cand -t bank.dat -B 200 --batch 2 --device cpu".split()) == 0
    chrome = json.load(open(str(tmp_path / "tr.jsonl") + ".chrome.json"))
    est = [e for e in chrome["traceEvents"] if isinstance(e.get("args"), dict) and e["args"].get("estimated")]
    assert est, "no estimated device lane in the Chrome export"
    assert {e["name"] for e in est} <= {devicecost.SCOPE_PREFIX + s for s in devicecost.STAGES}


# --- io/validate.py ---------------------------------------------------------


def _rows():
    rng = np.random.default_rng(5)
    t_obs = 2.048
    rows = []
    for i in range(40):
        f0 = 300 + 7 * i
        rows.append((f0 / t_obs, 2.2 + 0.001 * i, 0.04, 1.2, float(rng.uniform(20, 90)), float(60 - i), 1 << (i % 5)))
    return rows, t_obs


@pytest.mark.parametrize("perturb", ["same", "power", "param", "fa", "drop-top", "drop-tail", "extra", "empty"])
def test_compare_candidate_rows_matches_jax(perturb):
    rows, t_obs = _rows()
    other = [list(r) for r in rows]
    if perturb == "power":
        other[3][4] *= 1.02
    elif perturb == "param":
        other[5][1] += 1e-6
    elif perturb == "fa":
        other[7][5] += 0.2
    elif perturb == "drop-top":
        other = other[1:]
    elif perturb == "drop-tail":
        other = other[:-1]
    elif perturb == "extra":
        other.append([999 / t_obs, 2.0, 0.0, 0.0, 10.0, 60.5, 2])
    elif perturb == "empty":
        other = []
    got = validate.compare_candidate_rows(rows, other, t_obs)
    want = jvalidate.compare_candidate_rows(rows, other, t_obs)
    for f in ("matched", "missing", "extra", "boundary", "mismatches", "ok"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.report() == want.report()
    # a weak candidate missing at the threshold is tolerated
    assert got.ok == (perturb in ("same", "drop-tail"))


def test_compare_candidate_files_matches_jax(tmp_path):
    from boinc_app_eah_brp_tpu_torch.io import ResultFile, ResultHeader, empty_candidates, write_result_file

    cands = empty_candidates()[:6]
    cands["f0"] = [400, 500, 600, 700, 800, 900]
    cands["P_b"], cands["tau"], cands["Psi"] = 2.2, 0.04, 1.2
    cands["power"] = [50, 40, 30, 25, 22, 21]
    cands["fA"] = [60, 50, 40, 30, 20, 10]
    cands["n_harm"] = [1, 2, 4, 8, 16, 1]
    write_result_file(str(tmp_path / "a.cand"), ResultFile(candidates=cands, t_obs=2.048, header=ResultHeader()))
    h = ResultHeader()
    h.quarantined = [(3, 5)]
    write_result_file(str(tmp_path / "b.cand"), ResultFile(candidates=cands[:5], t_obs=2.048, header=h))
    for a, b in (("a", "a"), ("a", "b")):
        pa, pb = str(tmp_path / f"{a}.cand"), str(tmp_path / f"{b}.cand")
        got = validate.compare_candidate_files(pa, pb, 2.048)
        want = jvalidate.compare_candidate_files(pa, pb, 2.048)
        assert got.report() == want.report() and got.ok == want.ok
    assert validate.compare_candidate_files(str(tmp_path / "a.cand"), str(tmp_path / "b.cand"), 2.048).quarantine_mismatch
