"""PyTorch port, the bench and its measurement tools on the CPU: the
bench's problem against the JAX bench's, its body against ``run_bank``,
its payload's keys against the JAX bench's, its orchestrator without a
card, its provenance stamp; ``trace_report`` against the JAX tool on a
trace the port wrote; ``batch_sweep`` and ``stagebench`` artifacts against
the JAX tools' keys.

Tolerances: the problem and the (M, T) state are bitwise; the trace
tables and their rendering are equal.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu_torch.models.search import (
    SearchGeometry, lut_step_for_bank, lut_tiles_for_bank, max_slope_for_bank, run_bank,
)
from boinc_app_eah_brp_tpu_torch.ops.whiten import whiten_and_zap
from boinc_app_eah_brp_tpu_torch.runtime import artifacts
from boinc_app_eah_brp_tpu_torch.tools import _inputs, batch_sweep, stagebench, trace_report
from boinc_app_eah_brp_tpu_torch.tools import bench as port_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import bench as jax_bench  # noqa: E402
import trace_report as jax_trace_report  # noqa: E402

# the fixture size of the bench's problem: the same draws, fewer of them
N_SAMPLES, N_TEMPLATES, BATCH, N_TIMED = 4096, 8, 2, 6


def _keys_of_dicts(path: str, func: str, marker: str) -> set:
    """Every key of the dict literals in ``func`` of the file ``path`` that
    hold the key ``marker``, and of the subscripts assigned to the dict
    variables they are bound to."""
    tree = ast.parse(open(path).read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    keys, names = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            ks = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if marker in ks:
                keys |= ks
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            if marker in {k.value for k in node.value.keys if isinstance(k, ast.Constant)}:
                names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) and t.value.id in names
                        and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
    return keys


@pytest.fixture(scope="module")
def fixture_problem():
    return port_bench.synthetic_problem(N_SAMPLES, N_TEMPLATES)


@pytest.fixture(scope="module")
def bench_run(fixture_problem, tmp_path_factory):
    """One run of the bench body on the CPU at the fixture size, with the
    host trace armed (so the payload carries its stall table)."""
    trace = str(tmp_path_factory.mktemp("bench") / "bench.trace.jsonl")
    mp = pytest.MonkeyPatch()
    mp.setenv("ERP_TRACE_FILE", trace)
    try:
        return port_bench.run_bench(fixture_problem, device="cpu", batch=BATCH, n_timed=N_TIMED, log=lambda m: None)
    finally:
        mp.undo()


def _geometry(problem):
    d = problem.derived
    return SearchGeometry.from_derived(
        d,
        max_slope=max_slope_for_bank(problem.P, problem.tau),
        lut_step=lut_step_for_bank(problem.P, d.dt),
        lut_tiles=lut_tiles_for_bank(problem.P, problem.psi, d.n_unpadded, d.dt),
    )


def test_synthetic_problem_equals_the_jax_bench_problem(monkeypatch):
    monkeypatch.setenv("BENCH_SYNTH", "1")
    samples, (P, tau, psi), zap, cfg, derived, packed = jax_bench.load_problem()
    monkeypatch.delenv("BENCH_TESTWU", raising=False)
    port = port_bench.load_problem()
    assert port.samples.dtype == samples.dtype == np.float32
    np.testing.assert_array_equal(port.samples, samples)
    for a, b in ((port.P, P), (port.tau, tau), (port.psi, psi), (port.zap_ranges, zap)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert port.packed[0].tobytes() == packed[0].tobytes() and port.packed[1] == packed[1]
    assert port.tsample_us == 65.476 and len(port.P) == 6662 and len(port.samples) == 1 << 22
    assert dataclasses.asdict(port.derived) == dataclasses.asdict(derived)
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(cfg)


def test_write_problem_reads_back(fixture_problem, tmp_path):
    """The problem as the command line reads it: the same samples, the
    zap ranges, the bank to the written precision."""
    from boinc_app_eah_brp_tpu_torch.io import read_template_bank, read_workunit, read_zaplist

    files = port_bench.write_problem(fixture_problem, str(tmp_path))
    wu = read_workunit(files["wu"])
    np.testing.assert_array_equal(wu.samples, fixture_problem.samples)
    assert wu.raw.tobytes() == fixture_problem.packed[0].tobytes()
    np.testing.assert_array_equal(read_zaplist(files["zap"]), fixture_problem.zap_ranges)
    bank = read_template_bank(files["bank"])
    np.testing.assert_allclose(bank.P, fixture_problem.P, rtol=0, atol=1e-12)
    assert files["args"] == ["-A", "0.08", "-P", "3.0", "-f", "400.0", "-B", "1000", "-W"]


def test_load_problem_reads_the_test_workunit_directory(fixture_problem, tmp_path, monkeypatch):
    """A directory holding the shipped test workunit under the reference's
    file names (``$BENCH_TESTWU``) is the problem; without it, the
    synthetic one."""
    files = port_bench.write_problem(fixture_problem, str(tmp_path))
    for key, name in (("wu", port_bench.WU_NAME), ("bank", port_bench.BANK_NAME), ("zap", port_bench.ZAP_NAME)):
        os.rename(files[key], tmp_path / name)
    monkeypatch.setenv(port_bench.TESTWU_ENV, str(tmp_path))
    got = port_bench.load_problem()
    np.testing.assert_array_equal(got.samples, fixture_problem.samples)
    assert got.packed[0].tobytes() == fixture_problem.packed[0].tobytes() and got.packed[1] == 1.0
    np.testing.assert_allclose(got.psi, fixture_problem.psi, rtol=0, atol=1e-12)
    assert dataclasses.asdict(got.derived) == dataclasses.asdict(fixture_problem.derived)
    monkeypatch.setenv(port_bench.TESTWU_ENV, str(tmp_path / "absent"))
    monkeypatch.setattr(port_bench, "synthetic_problem", lambda: "synthetic")
    assert port_bench.load_problem() == "synthetic"


def test_bench_body_leaves_run_banks_state(fixture_problem, bench_run):
    """The timed loop covers templates [0, batch + n_timed) and the
    forced-sync loop [0, n_timed), each in bank order: their (M, T) are
    run_bank's over those templates, bitwise."""
    p = fixture_problem
    geom = _geometry(p)
    ts = whiten_and_zap(p.samples, p.derived, p.cfg, p.zap_ranges, device="cpu")
    M, T = run_bank(ts, p.P, p.tau, p.psi, geom, batch_size=BATCH)
    assert torch.equal(bench_run["state"][0], M) and torch.equal(bench_run["state"][1], T)
    k = N_TIMED
    Ms, Ts = run_bank(ts, p.P[:k], p.tau[:k], p.psi[:k], geom, batch_size=BATCH)
    assert torch.equal(bench_run["sync_state"][0], Ms) and torch.equal(bench_run["sync_state"][1], Ts)
    payload = bench_run["payload"]
    assert payload["batch"] == BATCH and payload["n_timed"] == N_TIMED and payload["n_batches"] == N_TIMED // BATCH
    assert payload["backend"] == "cpu" and payload["card"] is None


def test_bench_payload_has_the_jax_compact_keys(bench_run):
    jax_keys = _keys_of_dicts(os.path.join(REPO, "bench.py"), "run_bench", "metric")
    assert {"metric", "value", "unit", "vs_baseline", "feed_split", "mfu", "trace_stalls"} <= jax_keys
    payload = bench_run["payload"]
    missing = jax_keys - set(port_bench.DROPPED_FIELDS) - set(payload)
    assert not missing, missing
    for field in port_bench.DROPPED_FIELDS:
        assert f"``{field}``" in port_bench.__doc__, field
        assert field not in payload
    assert payload["metric"] == jax_bench.METRIC and payload["unit"] == "templates/sec"
    assert payload["vs_baseline"] == pytest.approx(payload["value"] / jax_bench.BASELINE_TEMPLATES_PER_SEC, abs=1e-3)
    assert set(payload["feed_split"]) == {
        "async_wall_per_batch_ms", "forced_sync_wall_per_batch_ms", "overhead_per_batch_ms", "feed_setup_s"
    }
    # the trace's stall table and the run report, as the JAX payload carries them
    assert {"dispatch", "drain-stall", "forced-sync-loop"} <= set(payload["trace_stalls"]["categories"])
    assert {"whitening", "timed async loop", "timed sync loop"} <= set(payload["run_report"]["phases"])
    assert bench_run["full"]["roofline"]["stages"]
    assert len(json.dumps(payload)) < 4000


def test_bench_without_a_card_prints_the_error_payload_and_exits_1(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, BENCH_RETRIES="2", ERP_BENCH_JSON_COPY=str(tmp_path / "copy.json"))
    r = subprocess.run([sys.executable, "-m", "boinc_app_eah_brp_tpu_torch.tools.bench"], env=env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 1, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    payload = json.loads(lines[0])
    assert payload["value"] is None and payload["vs_baseline"] is None
    assert payload["metric"] == jax_bench.METRIC and payload["unit"] == "templates/sec"
    assert "no CUDA device" in payload["error"]
    assert not (tmp_path / "copy.json").exists()
    # the body itself refuses the CPU: no number on stdout
    r = subprocess.run([sys.executable, "-m", "boinc_app_eah_brp_tpu_torch.tools.bench", "--run"], env=env,
                       cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_bench_git_head_dirty_stamp(tmp_path):
    """The twin of the JAX bench's test: uncommitted edits and untracked
    files under the measured surface (the port's package) stamp
    ``-dirty``; edits elsewhere do not."""
    repo = tmp_path / "fixture"
    pkg = repo / "boinc_app_eah_brp_tpu_torch"
    pkg.mkdir(parents=True)
    (pkg / "mod.py").write_text("y = 1\n")
    (repo / "bench.py").write_text("x = 1\n")
    (repo / "README").write_text("unmeasured surface\n")
    env = dict(os.environ, GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t", GIT_COMMITTER_NAME="t",
               GIT_COMMITTER_EMAIL="t@t", GIT_CONFIG_GLOBAL="/dev/null", GIT_CONFIG_SYSTEM="/dev/null")

    def git(*args):
        r = subprocess.run(["git", *args], cwd=repo, env=env, capture_output=True)
        assert r.returncode == 0, r.stderr
        return r.stdout.decode().strip()

    git("init", "-q")
    git("add", "-A")
    git("commit", "-qm", "fixture")
    head = git("rev-parse", "HEAD")
    assert port_bench._git_head(cwd=str(repo)) == head
    (repo / "README").write_text("doc edit\n")
    (repo / "bench.py").write_text("x = 2\n")  # the JAX bench is not the port's surface
    assert port_bench._git_head(cwd=str(repo)) == head
    extra = pkg / "newmod.py"
    extra.write_text("z = 1\n")
    assert port_bench._git_head(cwd=str(repo)) == head + "-dirty"
    extra.unlink()
    assert port_bench._git_head(cwd=str(repo)) == head
    (pkg / "mod.py").write_text("y = 2\n")
    assert port_bench._git_head(cwd=str(repo)) == head + "-dirty"
    git("add", "-A")
    git("commit", "-qm", "edit")
    assert port_bench._git_head(cwd=str(repo)) == git("rev-parse", "HEAD")
    assert port_bench._git_head(cwd=str(tmp_path)) is None  # not a checkout


@pytest.mark.parametrize(
    "paths,want",
    [
        (["BENCH_r9.json", "BENCH_r10.json", "BENCH_r2.json"], ["BENCH_r2.json", "BENCH_r9.json", "BENCH_r10.json"]),
        (["x/FULLWU_r03_cpu.json", "NOTES.md", "FULLWU_r03_a.json"],
         ["NOTES.md", "FULLWU_r03_a.json", "x/FULLWU_r03_cpu.json"]),
    ],
)
def test_round_key_matches_the_jax_package(paths, want):
    from boinc_app_eah_brp_tpu.runtime.artifacts import round_key as jax_round_key

    assert sorted(paths, key=artifacts.round_key) == want
    assert [artifacts.round_key(p) for p in paths] == [jax_round_key(p) for p in paths]


@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    """A trace the port's tracing wrote: a whitened command-line run on the
    fixture class, with a checkpoint and rescoring."""
    from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs, run_search

    d = tmp_path_factory.mktemp("trace")
    wu = _inputs.fixture_workunit(str(d / "wu.bin4"), f_signal=33.0)
    bank = _inputs.fixture_bank(str(d / "bank.txt"))
    (d / "zap.txt").write_text("50.0 51.0\n")
    trace = str(d / "run.trace.jsonl")
    mp = pytest.MonkeyPatch()
    mp.setenv("ERP_TRACE_FILE", trace)
    try:
        args = DriverArgs(inputfile=wu, outputfile=str(d / "out.cand"), templatebank=bank,
                          checkpointfile=str(d / "cp.cpt"), zaplistfile=str(d / "zap.txt"), window=200,
                          white=True, batch_size=1, device="cpu")
        assert run_search(args) == 0
    finally:
        mp.undo()
    return trace


@pytest.mark.parametrize("form", ["stream", "chrome"])
def test_trace_report_equals_the_jax_tool_on_a_port_trace(port_trace, form):
    path = port_trace if form == "stream" else port_trace + ".chrome.json"
    got, want = trace_report.load_trace(path), jax_trace_report.load_trace(path)
    assert got == want
    table = trace_report.stall_table(got)
    assert table == jax_trace_report.stall_table(want)
    assert {"dispatch", "checkpoint", "finalize"} <= set(table["categories"])
    assert trace_report.render(table, "t") == jax_trace_report.render(table, "t")
    assert trace_report.window_table(got, 3) == jax_trace_report.window_table(want, 3)
    assert trace_report.host_tables(got) == jax_trace_report.host_tables(want)
    slower = json.loads(json.dumps(table))
    slower["categories"]["dispatch"]["self_s"] += 1.0
    flags = trace_report.diff_tables(table, slower)
    assert flags == jax_trace_report.diff_tables(table, slower) and flags[0]["category"] == "dispatch"


def test_trace_report_cli_and_cuda_stream_lanes(port_trace, tmp_path, capsys):
    assert trace_report.main(["--json", "--windows", "2", port_trace]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[0])["main_lane"] == "MainThread"
    assert trace_report.main(["--diff", port_trace, port_trace]) == 0
    # a PyTorch profiler export's CUDA stream lane is a device lane, off
    # the host attribution, with the host's drain split against it
    doc = {"traceEvents": [
        {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name", "args": {"name": "MainThread"}},
        {"ph": "M", "pid": 1, "tid": 7, "name": "thread_name", "args": {"name": "stream 7"}},
        {"ph": "B", "pid": 1, "tid": 1, "ts": 0, "name": "drain"},
        {"ph": "E", "pid": 1, "tid": 1, "ts": 100},
        {"ph": "B", "pid": 1, "tid": 7, "ts": 10, "name": "erp.fft"},
        {"ph": "E", "pid": 1, "tid": 7, "ts": 70},
    ], "otherData": {"wall_us": 100}}
    path = tmp_path / "prof.chrome.json"
    path.write_text(json.dumps(doc))
    table = trace_report.stall_table(trace_report.load_trace(str(path)))
    assert table["background_busy_s"] == {}
    assert table["device"]["stages"] == {"fft": {"busy_s": 6e-05, "count": 1}}
    assert table["device"]["drain_device_bound_s"] == 6e-05
    assert "stream 7" in jax_trace_report.stall_table(jax_trace_report.load_trace(str(path)))["background_busy_s"]


def test_batch_sweep_writes_the_autobatch_artifact_with_the_jax_keys(fixture_problem, tmp_path, monkeypatch):
    from boinc_app_eah_brp_tpu_torch.runtime import autobatch

    path = str(tmp_path / "sweep.json")
    art = batch_sweep.sweep_problem(fixture_problem, device="cpu", batches=(2, 4, 16), steps=1, path=path,
                                    log=lambda m: None)
    on_disk = json.load(open(path))
    assert on_disk == json.loads(json.dumps(art))
    jax_keys = _keys_of_dicts(os.path.join(REPO, "tools", "batch_sweep.py"), "main", "what")
    assert {"rungs", "best_batch", "best_templates_per_sec", "backend", "nsamples"} <= jax_keys <= set(on_disk)
    assert [r["batch"] for r in on_disk["rungs"]] == [2, 4]  # 16 > the bank of 8
    for rung in on_disk["rungs"]:
        assert {"batch", "steps", "wall_s", "templates_per_sec"} <= set(rung)
    best = max(on_disk["rungs"], key=lambda r: r["slots_per_sec"])
    assert on_disk["best_batch"] == best["batch"] and on_disk["best_templates_per_sec"] == best["templates_per_sec"]
    assert on_disk["backend"] == "cpu" and on_disk["schema"] == autobatch.SWEEP_SCHEMA
    monkeypatch.setenv(autobatch.SWEEP_ENV, path)
    assert autobatch._sweep_best_batch() == (best["batch"], None, fixture_problem.derived.nsamples)


def test_stagebench_artifacts_have_the_jax_keys_and_the_smokes_stage_names(fixture_problem):
    import chip_smoke

    art = stagebench.stage_times(fixture_problem, device="cpu", batch=BATCH, repeat=1, median=True,
                                 log=lambda m: None)
    jax_keys = _keys_of_dicts(os.path.join(REPO, "tools", "stagebench.py"), "main", "what")
    assert {"resample_s", "rfft_power_s", "harmonic_sum_s", "total_s"} <= jax_keys <= set(art)
    smoke = open(chip_smoke.__file__).read()
    names = set(art["stages"])
    assert {"resample_ms", "fftprep_ms", "rfft_ms", "fold_spectrum_ms", "merge_ms", "batch_step_ms",
            "running_median_ms"} == names
    for name in names:
        assert name[:-3] in chip_smoke.KERNEL_ROWS or f'stages["{name}"]' in smoke or f"{name}=" in smoke, name
    assert all(v > 0 for v in art["stages"].values())
    assert art["total_s"] * 1e3 == pytest.approx(
        sum(art["stages"][k] for k in ("resample_ms", "fftprep_ms", "rfft_ms", "fold_spectrum_ms", "merge_ms")))
    white = stagebench.whiten_decompose(fixture_problem, device="cpu", repeat=1, log=lambda m: None)
    jax_white = _keys_of_dicts(os.path.join(REPO, "tools", "stagebench.py"), "whiten_decompose", "what")
    assert {"cold_s", "warm_avg_s", "warm_passes"} <= jax_white <= set(white)
    assert {"rfft", "median", "irfft", "TOTAL"} <= set(white["warm_avg_s"]) and white["warm_passes"] == 1


@pytest.mark.parametrize("tool", [stagebench, batch_sweep, port_bench])
def test_tools_default_to_the_card(tool, monkeypatch):
    """Without a card the tools' entry points raise (or, for the bench's
    body, refuse), never moving to the CPU by themselves."""
    monkeypatch.setattr(port_bench, "load_problem", lambda testwu=None: port_bench.synthetic_problem(4096, 4))
    if tool is port_bench:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_bench.run_bench(port_bench.load_problem(), log=lambda m: None)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--json", os.devnull])
