"""The port's artifact readers and measurement tools against the JAX
package's tools of the same names, on the same inputs:
``metrics_report``, ``blackbox_report``, ``step_report`` (validation, the
CPU run and the gates), ``bench_history`` and ``golden_ref --stages``.

Tolerance: rendered text identical; JSON documents equal apart from
their generation time; the ``--stages`` arrays bitwise and their digests
equal; exit codes equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from boinc_app_eah_brp_tpu.runtime import steptime as jst
from boinc_app_eah_brp_tpu_torch.runtime import flightrec as pfr
from boinc_app_eah_brp_tpu_torch.runtime import steptime as pst
from boinc_app_eah_brp_tpu_torch.tools import _inputs
from boinc_app_eah_brp_tpu_torch.tools import bench_history as p_bench_history
from boinc_app_eah_brp_tpu_torch.tools import blackbox_report as p_blackbox_report
from boinc_app_eah_brp_tpu_torch.tools import golden_ref as p_golden_ref
from boinc_app_eah_brp_tpu_torch.tools import metrics_report as p_metrics_report
from boinc_app_eah_brp_tpu_torch.tools import report_check
from boinc_app_eah_brp_tpu_torch.tools import step_report as p_step_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import bench_history as j_bench_history  # noqa: E402
import blackbox_report as j_blackbox_report  # noqa: E402
import golden_ref as j_golden_ref  # noqa: E402
import metrics_report as j_metrics_report  # noqa: E402
import step_report as j_step_report  # noqa: E402


def _run_port_cli(work, name, *extra):
    """The port's command line on the fixture workunit, with its metrics
    stream: (stream path, run-report path)."""
    wu = _inputs.fixture_workunit(os.path.join(work, "wu.bin4"), f_signal=33.0)
    bank = _inputs.fixture_bank(os.path.join(work, "bank.dat"))
    mfile = os.path.join(work, f"{name}.jsonl")
    cmd = _inputs.cli_cmd(wu, bank, os.path.join(work, f"{name}.cand"), os.path.join(work, f"{name}.cpt"),
                          "-B", "200", "--batch", "2", "--device", "cpu", "--metrics-file", mfile, *extra)
    r = subprocess.run(cmd, env=_inputs.child_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return mfile, mfile + ".report.json"


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("port_runs"))
    zap = os.path.join(work, "zap.txt")
    with open(zap, "w") as f:
        f.write("50.0 51.0\n")
    return {"unwhitened": _run_port_cli(work, "unwhitened"), "whitened": _run_port_cli(work, "whitened", "-W", "-l", zap)}


# --- metrics_report ----------------------------------------------------------

@pytest.mark.parametrize("form", [0, 1], ids=["stream", "report"])
def test_metrics_report_renders_a_port_run_as_the_jax_tool(port_runs, form):
    path = port_runs["whitened"][form]
    jr, jh = j_metrics_report.load_report(path)
    pr, ph = p_metrics_report.load_report(path)
    assert pr == jr and ph == jh
    assert pr is not None
    text = p_metrics_report.render(pr, ph, path)
    assert text == j_metrics_report.render(jr, jh, path)
    assert "Phases:" in text and "Counters / gauges:" in text


def test_metrics_report_diff_and_main_match_the_jax_tool(port_runs, capsys):
    a, b = port_runs["unwhitened"][1], port_runs["whitened"][1]
    ra, rb = (p_metrics_report.load_report(p)[0] for p in (a, b))
    assert p_metrics_report.diff(ra, rb, a, b) == j_metrics_report.diff(ra, rb, a, b)
    for argv in (["--diff", a, b], [a, port_runs["whitened"][0]]):
        assert p_metrics_report.main(argv) == 0
        port_out = capsys.readouterr().out
        assert j_metrics_report.main(argv) == 0
        assert port_out == capsys.readouterr().out
    # a torn stream renders its heartbeats or nothing, in both
    torn = os.path.join(os.path.dirname(a), "torn.jsonl")
    with open(torn, "w") as f:
        f.write('{"kind": "heartbeat", "metrics": {"phases": {}}}\n{"kind": "run_rep')
    assert p_metrics_report.render(*p_metrics_report.load_report(torn), torn) == j_metrics_report.render(
        *j_metrics_report.load_report(torn), torn)
    assert p_metrics_report.main(["--diff", a, torn]) == j_metrics_report.main(["--diff", a, torn]) == 1


def test_metrics_report_renders_a_jax_report_as_the_jax_tool(tmp_path):
    """A run report written by the JAX package's metrics layer (a scoped
    window: phases, counters, gauges, a histogram), rendered and diffed
    by both tools."""
    from boinc_app_eah_brp_tpu.runtime import metrics as jmetrics

    reports = []
    for i in range(2):
        ctx = jmetrics.MetricsContext(name=f"jax-report-{i}")
        ctx.configure(metrics_file=str(tmp_path / f"jax{i}.jsonl"))
        ctx.record_phase("template loop", 1.5 + i)
        ctx.counter("health.checks").inc(7 + i)
        ctx.gauge("autobatch.batch_size").set(32)
        h = ctx.histogram("steptime.step_ms", jmetrics.LATENCY_BUCKETS_MS, unit="ms")
        for ms in (1.0, 2.5, 9.0 * (i + 1)):
            h.observe(ms)
        assert ctx.finish(0, context={"suite": "reports"}) is not None
        reports.append(str(tmp_path / f"jax{i}.jsonl.report.json"))
    for path in reports + [str(tmp_path / "jax0.jsonl")]:
        pr, ph = p_metrics_report.load_report(path)
        assert pr is not None and (pr, ph) == j_metrics_report.load_report(path)
        assert p_metrics_report.render(pr, ph, path) == j_metrics_report.render(pr, ph, path)
    ra, rb = (p_metrics_report.load_report(p)[0] for p in reports)
    text = p_metrics_report.diff(ra, rb, *reports)
    assert text == j_metrics_report.diff(ra, rb, *reports) and "phase:template loop" in text


def test_metrics_report_check_is_the_report_check_router(port_runs, tmp_path, capsys):
    paths = list(port_runs["whitened"])
    assert p_metrics_report.main(["--check", *paths]) == 0
    out = capsys.readouterr().out
    assert out.count("OK (erp-run-report/1)") == 2
    assert j_metrics_report.main(["--check", *paths]) == 0
    bad = tmp_path / "bad.report.json"
    doc = json.load(open(paths[1]))
    del doc["metrics"]
    bad.write_text(json.dumps(doc))
    assert p_metrics_report.main(["--check", str(bad)]) == j_metrics_report.main(["--check", str(bad)]) == 1


# --- blackbox_report ---------------------------------------------------------

@pytest.fixture
def port_dump(tmp_path, monkeypatch):
    """A dump written by the port's flight recorder."""
    monkeypatch.delenv(pfr.BLACKBOX_ENV, raising=False)
    monkeypatch.setenv(pfr.BLACKBOX_DIR_ENV, str(tmp_path))
    assert pfr.arm(context={"suite": "tools-test"})
    pfr.note_dispatch(loop="run_bank", start=8, stop=16, inflight=2)
    pfr.record("health-violation", where="batch", what="nonfinite-spectrum")
    try:
        raise RuntimeError("tool-test crash")
    except RuntimeError as e:
        path = pfr.dump("tool-test", exc=e)
    pfr.disarm()
    return path


@pytest.mark.parametrize("n_events", [1, 25])
def test_blackbox_report_renders_a_port_dump_as_the_jax_tool(port_dump, n_events):
    doc = json.load(open(port_dump))
    text = p_blackbox_report.render(doc, port_dump, n_events=n_events)
    assert text == j_blackbox_report.render(doc, port_dump, n_events=n_events)
    assert "tool-test crash" in text and "In-flight dispatch window" in text


def _corrupt_events(doc):
    del doc["events"]


def _corrupt_threads(doc):
    doc["threads"] = []


def _corrupt_schema(doc):
    doc["schema"] = "erp-blackbox/0"


@pytest.mark.parametrize("corrupt", [None, _corrupt_events, _corrupt_threads, _corrupt_schema, "torn"],
                         ids=["good", "no-events", "no-threads", "schema", "torn"])
def test_blackbox_report_check_agrees_with_the_jax_tool(port_dump, corrupt, capsys):
    if corrupt == "torn":
        open(port_dump, "w").write("{torn")
    elif corrupt is not None:
        doc = json.load(open(port_dump))
        corrupt(doc)
        json.dump(doc, open(port_dump, "w"))
    rc = p_blackbox_report.main(["--check", port_dump])
    port_out = capsys.readouterr()
    assert rc == j_blackbox_report.main(["--check", port_dump]) == (0 if corrupt is None else 1)
    jax_out = capsys.readouterr()
    assert port_out.out == jax_out.out
    if corrupt is None:
        assert f"OK ({pfr.SCHEMA})" in port_out.out


# --- step_report: validation ------------------------------------------------

def _good_report():
    """``tests/test_steptime.py::_good_report``."""
    block = {"n": 8, "p50": 1.0, "p95": 1.3, "p99": 1.5, "mean": 1.1, "max": 1.6}
    return {
        "schema": "erp-step-report/1",
        "generated_unix": 1.0,
        "backend": "cpu",
        "chip_model": "v5e",
        "measured": {"windows": 8, "templates": 128, "templates_per_sec": 2000.0, "gb_per_sec": 7.5,
                     "step_ms": block},
        "modeled": {"templates_per_sec": 9e5, "ms_per_template": 1e-3},
        "stages": [
            {"stage": "resample_split", "modeled_fraction": 0.7, "measured_ms_per_window": 0.7},
            {"stage": "rfft_packed+power", "modeled_fraction": 0.3, "measured_ms_per_window": 0.3},
        ],
        "device_lane": "modeled-split",
    }


def _broken(case):
    doc = _good_report()
    if case == "schema":
        doc["schema"] = "erp-step-report/0"
    elif case == "stages":
        doc["stages"] = []
    elif case == "fraction":
        doc["stages"][0]["modeled_fraction"] = 1.7
    elif case == "p95":
        del doc["measured"]["step_ms"]["p95"]
    elif case == "lane":
        doc["device_lane"] = "vibes"
    elif case == "not-an-object":
        doc = "nope"
    elif case == "no-backend":
        del doc["backend"]
    elif case == "stage-name":
        doc["stages"][1] = {"modeled_fraction": 0.3}
    return doc


@pytest.mark.parametrize(
    "case", ["good", "schema", "stages", "fraction", "p95", "lane", "not-an-object", "no-backend", "stage-name"]
)
def test_validate_step_report_matches_jax(case):
    doc = _broken(case)
    assert pst.validate_step_report(doc) == jst.validate_step_report(doc)
    assert (pst.validate_step_report(doc) == []) == (case == "good")
    assert (pst.REPORT_SCHEMA, pst.BASELINE_SCHEMA) == (jst.REPORT_SCHEMA, jst.BASELINE_SCHEMA)


def test_report_check_routes_step_reports(tmp_path):
    good, bad = tmp_path / "good.json", tmp_path / "bad.json"
    good.write_text(json.dumps(_good_report()))
    bad.write_text(json.dumps(_broken("lane")))
    assert report_check.check_path(str(good)) == ("erp-step-report/1", [])
    schema, errs = report_check.check_path(str(bad))
    assert schema == "erp-step-report/1" and errs == jst.validate_step_report(_broken("lane"))


# --- step_report: the CPU run ------------------------------------------------

def test_step_report_cpu_run_is_valid_for_the_jax_validator(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("ERP_RESULT_DATE", _inputs.RESULT_DATE)
    out = tmp_path / "step.json"
    rc = p_step_report.main(["--device", "cpu", "--json", str(out), "--workdir", str(tmp_path / "w")])
    assert rc == 0, capsys.readouterr()
    doc = json.load(open(out))
    assert jst.validate_step_report(doc) == [] and pst.validate_step_report(doc) == []
    assert doc["device_lane"] == "modeled-split" and doc["backend"] == "cpu"
    assert doc["measured"]["windows"] == p_step_report.N_TEMPLATES // p_step_report.BATCH
    assert doc["geometry"] == {"nsamples": 4096, "n_unpadded": 4096, "batch": 2, "templates": 16}
    total = sum(s["measured_ms_per_window"] for s in doc["stages"])
    assert total == pytest.approx(doc["measured"]["step_ms"]["mean"], abs=1e-3)
    assert sum(s["modeled_fraction"] for s in doc["stages"]) == pytest.approx(1.0, abs=1e-3)
    assert {s["stage"] for s in doc["stages"]} == {"resample", "fftprep", "rfft", "fold_spectrum", "merge"}
    assert "roofline" in doc["modeled"]["source"]
    assert report_check.check_path(str(out)) == ("erp-step-report/1", [])
    assert j_step_report.main(["--check", str(out)]) == 0


def test_step_report_refuses_the_card_it_does_not_have():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_step_report.main(["--json", ""])


# --- step_report: the gates --------------------------------------------------

def _doc(backend="cpu", p50=1.0, tps=2000.0):
    doc = _good_report()
    doc["backend"] = backend
    doc["measured"]["step_ms"]["p50"] = p50
    doc["measured"]["templates_per_sec"] = tps
    return doc


@pytest.mark.parametrize(
    "old,new,rc",
    [
        (_doc(), _doc(p50=1.2), 0),
        (_doc(), _doc(p50=2.0), 1),
        (_doc(), _doc(tps=900.0), 1),
        (_doc(), _doc(backend="NVIDIA H100 80GB HBM3", p50=9.0), 0),
        (_doc(backend="tpu"), _doc(backend="cpu", tps=10.0), 0),
        (_doc(), _broken("lane"), 1),
    ],
    ids=["within", "p50-regressed", "throughput-fell", "across-backends", "tpu-to-cpu", "invalid"],
)
def test_step_report_diff_exit_codes_match_jax(tmp_path, old, new, rc, capsys):
    a, b = tmp_path / "old.json", tmp_path / "new.json"
    a.write_text(json.dumps(old))
    b.write_text(json.dumps(new))
    assert p_step_report.main(["--diff", str(a), str(b)]) == rc
    assert j_step_report.main(["--diff", str(a), str(b)]) == rc
    for argv in (["--diff", str(a), str(b), "--threshold", "150"], ["--check", str(a), str(b)]):
        assert p_step_report.main(argv) == j_step_report.main(argv)


@pytest.mark.parametrize(
    "doc,base",
    [
        (_doc(), None),
        (_doc(p50=30.0), None),
        (_doc(tps=50.0), None),
        (_doc(backend="NVIDIA H100 80GB HBM3", p50=300.0), None),
        (_doc(), {"schema": "erp-steptime-baseline/0", "backend": "cpu"}),
    ],
    ids=["within", "p50-over", "tps-under", "card-skips-cpu-baseline", "wrong-schema"],
)
def test_step_report_baseline_matches_jax(tmp_path, doc, base, capsys):
    path = os.path.join(REPO, "STEPTIME_BASELINE.json")
    if base is not None:
        path = str(tmp_path / "base.json")
        open(path, "w").write(json.dumps(base))
    got = p_step_report.check_baseline(doc, path)
    port_out = capsys.readouterr().out
    assert got == j_step_report.check_baseline(doc, path)
    assert port_out == capsys.readouterr().out


# --- bench_history -----------------------------------------------------------

def _bench_file(dirpath, n, value, backend="cpu", rc=0, **extra):
    parsed = dict(value=value, backend=backend, **extra)
    doc = {"n": n, "cmd": ["bench"], "rc": rc, "tail": [], "parsed": parsed}
    with open(os.path.join(dirpath, f"BENCH_r{n:02d}.json"), "w") as f:
        json.dump(doc, f)


def _serving_scoreboard(dirpath, stats, baseline):
    os.makedirs(os.path.join(dirpath, ".erp_cache"), exist_ok=True)
    with open(os.path.join(dirpath, ".erp_cache", "fleet_bench_ci.json"), "w") as f:
        json.dump({"stats": stats}, f)
    with open(os.path.join(dirpath, "FLEET_SERVING_BASELINE.json"), "w") as f:
        json.dump(baseline, f)


def _case_ordering(d):
    _bench_file(d, 2, 110.0, mfu=0.02)
    _bench_file(d, 1, 100.0, mfu=0.02)
    _bench_file(d, 10, 130.0, mfu=0.03)


def _case_regression(d):
    _bench_file(d, 1, 100.0)
    _bench_file(d, 2, 50.0)


def _case_backends(d):
    _bench_file(d, 1, 2000.0, backend="tpu")
    _bench_file(d, 2, 100.0, backend="cpu")
    _bench_file(d, 3, 1900.0, backend="tpu")


def _case_improves(d):
    # compile time dropping is an improvement, never a flag
    _bench_file(d, 1, 100.0, compile_first_batch_s=20.0)
    _bench_file(d, 2, 100.0, compile_first_batch_s=5.0)


def _case_worsens(d):
    _case_improves(d)
    _bench_file(d, 3, 100.0, compile_first_batch_s=9.0)


def _case_torn(d):
    _bench_file(d, 1, 100.0)
    with open(os.path.join(d, "BENCH_r02.json"), "w") as f:
        f.write("{torn")
    _bench_file(d, 3, 101.0)


def _case_serving_tolerated(d):
    _bench_file(d, 1, 100.0)
    _serving_scoreboard(d, {"wus_per_hour_per_chip": 50.0, "recompiles_after_warmup": 0, "p95_inter_wu_gap_s": 0.5,
                            "resumed_wus": 3, "shed_total": 1}, {"wus_per_hour_per_chip_min": 10.0})


def _case_serving_ceiling(d):
    _bench_file(d, 1, 100.0)
    _serving_scoreboard(d, {"wus_per_hour_per_chip": 50.0, "resumed_wus": 0, "shed_total": 4}, {"shed_total_max": 0})


def _case_steptime(d):
    _bench_file(d, 1, 100.0)
    os.makedirs(os.path.join(d, ".erp_cache"), exist_ok=True)
    with open(os.path.join(d, ".erp_cache", "fleet_bench_ci.json"), "w") as f:
        json.dump({"backend": "cpu", "stats": {}, "step_latency": {"windows": 8, "step_ms": {"p50": 40.0, "p95": 2.0}}},
                  f)
    with open(os.path.join(d, "STEPTIME_BASELINE.json"), "w") as f:
        json.dump({"backend": "cpu", "p50_step_ms_max": 25.0, "p95_step_ms_max": 60.0}, f)


BENCH_CASES = {
    "ordering": _case_ordering,
    "regression": _case_regression,
    "backends": _case_backends,
    "improves": _case_improves,
    "worsens": _case_worsens,
    "torn": _case_torn,
    "serving-tolerated": _case_serving_tolerated,
    "serving-ceiling": _case_serving_ceiling,
    "steptime": _case_steptime,
}


@pytest.mark.parametrize("case", sorted(BENCH_CASES))
def test_bench_history_matches_the_jax_tool(tmp_path, case, capsys):
    """The JAX suite's bench_history cases: the same table, the same
    ``--json`` and the same ``--strict`` exit code."""
    d = str(tmp_path / "d")
    os.makedirs(d)
    BENCH_CASES[case](d)
    outs = {}
    for name, tool in (("port", p_bench_history), ("jax", j_bench_history)):
        out_json = str(tmp_path / f"{name}.json")
        rc = tool.main(["--dir", d, "--json", out_json])
        rc_strict = tool.main(["--dir", d, "--strict"])
        text = capsys.readouterr().out
        outs[name] = (rc, rc_strict, text, json.load(open(out_json)))
    assert outs["port"] == outs["jax"]
    rc, rc_strict, text, doc = outs["port"]
    assert rc == 0
    assert rc_strict == (1 if case in ("regression", "serving-ceiling", "steptime", "worsens") else 0)
    if case == "ordering":
        rows = [ln.split()[0] for ln in text.splitlines() if ln.startswith("BENCH_r")]
        assert rows[:3] == ["BENCH_r01.json", "BENCH_r02.json", "BENCH_r10.json"]
    if case == "torn":
        assert "unreadable" in text


def _line(value, backend="cuda", card="NVIDIA H100 80GB HBM3", **extra):
    return json.dumps(dict(metric="orbital templates/sec/chip", value=value, unit="templates/sec", backend=backend,
                           card=card if backend == "cuda" else None, batch=32, power_limit="700.00 W", **extra))


def test_bench_history_port_lines_never_meet_other_backends(tmp_path, capsys):
    lines = tmp_path / "bench.jsonl"
    lines.write_text("\n".join([
        "bench: a log line, not a payload",
        _line(3300.0, fraction_of_attainable=0.24),
        _line(40.0, backend="cpu"),
        _line(3200.0, fraction_of_attainable=0.23),  # -3% against the H100 line before it
        _line(3300.0, card="NVIDIA A100-SXM4-80GB"),
        "{torn",
    ]) + "\n")
    d = tmp_path / "d"
    d.mkdir()
    _bench_file(str(d), 1, 30.0, backend="tpu")
    out_json = str(tmp_path / "traj.json")
    assert p_bench_history.main(["--dir", str(d), "--bench-lines", str(lines), "--json", out_json, "--strict"]) == 0
    text = capsys.readouterr().out
    assert "backend cuda:NVIDIA H100 80GB HBM3:" in text and "backend cpu:" in text
    assert "backend cuda:NVIDIA A100-SXM4-80GB:" in text
    assert "moved" not in text  # no H100 row is compared with the CPU, A100 or TPU rows
    doc = json.load(open(out_json))
    assert [r["backend"] for r in doc["bench_lines"]] == [
        "cuda:NVIDIA H100 80GB HBM3", "cpu", "cuda:NVIDIA H100 80GB HBM3", "cuda:NVIDIA A100-SXM4-80GB"]
    assert doc["rounds"][0]["backend"] == "tpu"
    # the H100's rate halving is a regression of that card alone
    lines.write_text(_line(3300.0) + "\n" + _line(40.0, backend="cpu") + "\n" + _line(1600.0) + "\n")
    assert p_bench_history.main(["--dir", str(d), "--bench-lines", str(lines), "--strict"]) == 1
    assert "templates/s moved -51.5% (vs the previous cuda:NVIDIA H100 80GB HBM3 row)" in capsys.readouterr().out


def test_bench_history_reads_step_reports_by_backend(tmp_path, capsys):
    paths = []
    for i, doc in enumerate([_doc(), _doc(backend="NVIDIA H100 80GB HBM3", p50=9.6, tps=3300.0),
                             _doc(p50=3.0), _broken("lane")]):
        p = tmp_path / f"step{i}.json"
        p.write_text(json.dumps(doc))
        paths.append(str(p))
    missing = str(tmp_path / "missing.json")
    d = tmp_path / "d"
    d.mkdir()
    assert p_bench_history.main(["--dir", str(d), "--step-reports", *paths, missing]) == 0
    text = capsys.readouterr().out
    assert "backend cpu:" in text and "backend NVIDIA H100 80GB HBM3:" in text
    assert "p50 ms moved +200%" in text  # cpu against cpu only
    assert "not a valid erp-step-report/1" in text and "unreadable" in text
    assert p_bench_history.main(["--dir", str(d), "--step-reports", *paths, "--strict"]) == 1


# --- golden_ref --stages -----------------------------------------------------

def test_golden_ref_stages_bitwise_the_jax_dump(tmp_path):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert j_golden_ref.dump_stages(jdir) == 0
    assert p_golden_ref.main(["--stages", pdir]) == 0
    jz = np.load(os.path.join(jdir, "oracle_stages_ci.npz"))
    pz = np.load(os.path.join(pdir, "oracle_stages_ci.npz"))
    assert sorted(jz.files) == sorted(pz.files)
    for name in jz.files:
        assert jz[name].dtype == pz[name].dtype and jz[name].shape == pz[name].shape, name
        assert jz[name].tobytes() == pz[name].tobytes(), name
    js = json.load(open(os.path.join(jdir, "oracle_stages_ci.sha256.json")))
    ps = json.load(open(os.path.join(pdir, "oracle_stages_ci.sha256.json")))
    js.pop("generated_unix")
    ps.pop("generated_unix")
    assert ps == js
