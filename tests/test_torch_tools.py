"""PyTorch port, the tools (``boinc_app_eah_brp_tpu_torch/tools/``) on the
CPU at the smallest sizes (``--device cpu``).

The fabric soak's fleet report and quorum verdicts must also pass the JAX
package's validators (``tools/fleet_report.py::validate_fleet_report``,
``fabric/validator.py::validate_quorum_verdict``).  The whole kill/resume,
host-loss, hang and serving chaos soaks carry ``slow`` and ``chaos``, as
the JAX package's own do; their building blocks (the checkpoint waits,
the corruption and its fallback, the lease-commit wait, the counter
readers, the journal snapshot check, the shed check) are tested here in
tier 1.

Tolerances: exact (gates pass or fail; artifacts validate or not).
"""

import glob
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from boinc_app_eah_brp_tpu.fabric.validator import validate_quorum_verdict as jax_validate_verdict
from boinc_app_eah_brp_tpu_torch import fabric as pfb
from boinc_app_eah_brp_tpu_torch.io import empty_candidates
from boinc_app_eah_brp_tpu_torch.io.checkpoint import Checkpoint, load_resumable_checkpoint, write_checkpoint
from boinc_app_eah_brp_tpu_torch.runtime import faultinject, metrics, watchdog
from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs
from boinc_app_eah_brp_tpu_torch.serving import WUJournal, replay
from boinc_app_eah_brp_tpu_torch.tools import (
    _inputs,
    chaos_soak,
    fabric_soak,
    fleet_report,
    precision_audit,
    report_check,
    serving_chaos,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import fleet_report as jax_fleet_report  # noqa: E402  (the JAX package's tool)

BASELINE = str(REPO / "PRECISION_BASELINE.json")


def _tool(name, *args, timeout=300):
    """``python -m boinc_app_eah_brp_tpu_torch.tools.<name> args`` with the
    repository on the path; the completed process."""
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", f"boinc_app_eah_brp_tpu_torch.tools.{name}", *args],
                          env=env, capture_output=True, text=True, timeout=timeout)


@pytest.fixture
def soak_env(monkeypatch):
    """The process env the soaks set, restored after the test."""
    monkeypatch.setenv("ERP_QUORUM_KEY", "tools-test-key")
    monkeypatch.setenv("ERP_RESULT_DATE", _inputs.RESULT_DATE)
    yield
    faultinject.configure("")


# ---------------------------------------------------------------------------
# fabric_soak, fleet_report, report_check


@pytest.mark.parametrize("backend", ["subprocess", "server"])
def test_fabric_soak_on_the_cpu(tmp_path, monkeypatch, soak_env, backend):
    monkeypatch.setenv("ERP_FABRIC_BACKEND", backend)
    rc = fabric_soak.main(["--streams", "16", "--wus", "8", "--device", "cpu", "--workdir", str(tmp_path)])
    assert rc == 0
    fleet = json.load(open(tmp_path / "fabric-fleet.json"))
    assert fleet["wus"]["granted"] == 8 and fleet["wus"]["pending"] == 0
    # the port's artifacts pass the JAX package's validators too
    assert jax_fleet_report.validate_fleet_report(fleet) == []
    assert jax_fleet_report.evaluate_slo(fleet, json.load(open(REPO / "FLEET_BASELINE.json"))) == []
    verdicts = sorted(glob.glob(str(tmp_path / "verdicts" / "*.quorum.json")))
    assert len(verdicts) >= 8
    for path in verdicts:
        doc = json.load(open(path))
        assert jax_validate_verdict(doc) == [], path
        assert pfb.validate_quorum_verdict(doc) == []
    assert report_check.main(verdicts + [str(tmp_path / "fabric-metrics.jsonl")]) == 0


def test_fabric_soak_gate_catches_a_false_grant(tmp_path, monkeypatch, soak_env):
    """Hosts served payload B's candidates under payload A's name agree
    with each other, so the fabric grants; the byte-identity gate against
    A's reference must fail the soak."""
    from test_torch_fabric import REFS

    class Swapped(pfb.Fabric):
        def __init__(self, config, workunits, references, workdir, obs=None):
            super().__init__(config, workunits, {k: references["B"] for k in references}, workdir, obs)

    monkeypatch.setattr(pfb, "Fabric", Swapped)
    with pytest.raises(fabric_soak.SoakFailed, match="granted candidates differ"):
        fabric_soak.soak(str(tmp_path), dict(REFS), t_obs=1.0, streams=8, n_wus=4, baseline=None,
                         log=lambda m: None)


def test_fabric_soak_holds_on_capped_references(tmp_path, soak_env):
    """References whose candidates all sit at the fA cap, as at the
    production width: a reorder host's swap passes the intrinsic checks,
    and the soak still grants only the references' bytes."""
    from test_torch_fabric import fa_of, ref_bytes

    assert fa_of(2500.0, 4) == 320.0
    refs = {
        "A": ref_bytes([(400 + i, 3000.0 - 10.0 * i, 4) for i in range(40)]),
        "B": ref_bytes([(300 + i, 2900.0 - 10.0 * i, 4) for i in range(40)]),
    }
    out = fabric_soak.soak(str(tmp_path), refs, t_obs=1.0, streams=32, n_wus=16, baseline=None, log=lambda m: None)
    assert out["summary"]["granted"] == 16


def test_fleet_report_cli_check(tmp_path, soak_env):
    """build_report over a lifecycle export and its verdicts; --check of
    the written report with the baseline; a broken report fails."""
    from test_torch_fabric import REFS

    cfg = pfb.FabricConfig(t_obs=1.0, deadline_s=5.0, seed=2)
    wus = [pfb.WorkUnit(wu_id=f"wu{i}", payload="AB"[i % 2], epoch=cfg.bank_epoch, target=2) for i in range(4)]
    fabric = pfb.Fabric(cfg, wus, REFS, str(tmp_path))
    hosts = [pfb.HostModel(host_id=i, date_iso=_inputs.RESULT_DATE) for i in range(1, 5)]
    assert pfb.run_streams(fabric, hosts, timeout_s=60)
    life = fabric.export_lifecycle(str(tmp_path / "life.json"))
    out = str(tmp_path / "fleet.json")
    base = str(REPO / "FLEET_BASELINE.json")
    assert fleet_report.main(["--lifecycle", life, "--verdict-dir", str(tmp_path / cfg.verdict_dir),
                              "--out", out, "--baseline", base]) == 0
    doc = json.load(open(out))
    assert doc["wus"]["granted"] == 4 and doc["verdicts"]["signed_ok"] == doc["verdicts"]["count"]
    assert jax_fleet_report.validate_fleet_report(doc) == []
    assert fleet_report.main(["--check", out, "--baseline", base]) == 0
    assert report_check.check_path(out) == (fleet_report.FLEET_SCHEMA, [])
    broken = dict(doc, reissue_overhead={"ratio": -1})
    json.dump(broken, open(out, "w"))
    assert fleet_report.main(["--check", out]) == 1


def _signed_verdict(tmp_path):
    out = pfb.validate_single("wuZ", pfb.Replica(host_id=0, path=str(tmp_path / "missing.cand")), 1.0,
                              outdir=str(tmp_path / "v"))
    return out.path


def test_report_check_routes_by_schema(tmp_path, monkeypatch, soak_env):
    """Each artifact family goes to its own validator; a tampered verdict,
    a report of a run that never finished and a journal with a bad record
    are INVALID."""
    verdict = _signed_verdict(tmp_path)
    mfile = str(tmp_path / "m.jsonl")
    metrics.configure(metrics_file=mfile, interval=0)
    metrics.counter("x").inc()
    metrics.finish("ok")
    jpath = str(tmp_path / "journal.jsonl")
    j = WUJournal(jpath)
    j.record_submit("t1", DriverArgs(inputfile="a", outputfile="b", templatebank="c"), corr_id="c1")
    j.record_dispatch("t1")
    j.close()
    inc = str(tmp_path / "cp.incidents.json")
    watchdog.IncidentLog(inc).append("dispatch", "deadline exceeded", window=(0, 2))
    expect = {
        verdict: "erp-quorum/1",
        mfile: "erp-run-report/1",
        mfile + ".report.json": "erp-run-report/1",
        jpath: "erp-serving-journal/1",
        BASELINE: "erp-precision-baseline/1",
        inc: "erp-incident-log/1",
    }
    for path, schema in expect.items():
        assert report_check.check_path(path) == (schema, []), path
    doc = json.load(open(verdict))
    doc["winner_host"] = 5
    json.dump(doc, open(verdict, "w"))
    assert report_check.check_path(verdict)[1]
    open(jpath, "a").write('{"schema": "erp-serving-journal/1", "seq": 1, "event": "done"}\n')
    assert report_check.check_path(jpath)[1]
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert report_check.check_path(str(empty)) == ("erp-run-report/1", ["no run report found"])
    assert report_check.main([verdict, mfile]) == 1


# ---------------------------------------------------------------------------
# fleet_bench, precision_audit


def test_fleet_bench_verify_on_the_cpu(tmp_path):
    out = str(tmp_path / "bench.json")
    r = _tool("fleet_bench", "--wus", "2", "--verify", "--check", "--device", "cpu", "--json", out,
              "--workdir", str(tmp_path / "w"))
    assert r.returncode == 0, r.stderr[-3000:]
    doc = json.load(open(out))
    assert doc["backend"] == "cpu" and doc["verified_byte_identical"] == 2
    assert doc["stats"]["recompiles_after_warmup"] == 0 and doc["stats"]["ok"] == 2
    assert doc["step_latency"]["windows"] >= 1 and doc["introspection"]["metrics_samples"] > 0


def test_fleet_bench_throughput_floor_is_the_cpus():
    stats = {"wus_per_hour_per_chip": 10.0, "recompiles_after_warmup": 0, "p95_inter_wu_gap_s": 0.1}
    base = str(REPO / "FLEET_SERVING_BASELINE.json")
    from boinc_app_eah_brp_tpu_torch.tools import fleet_bench

    assert fleet_bench.check_baseline(stats, base, on_cpu=True)
    assert fleet_bench.check_baseline(stats, base, on_cpu=False) == []
    assert fleet_bench.check_baseline(dict(stats, recompiles_after_warmup=1), base, on_cpu=False)


def test_precision_audit_on_the_cpu(tmp_path, capsys):
    audit = str(tmp_path / "audit.json")
    assert precision_audit.main(["--device", "cpu", "--json", audit]) == 0
    assert precision_audit.main(["--device", "cpu", "--lanes", "f32", "--baseline", BASELINE]) == 0
    assert "within the ceilings" in capsys.readouterr().out
    assert precision_audit.main(["--check", audit]) == 0
    assert precision_audit.main(["--diff", audit, audit]) == 0
    doc = json.load(open(audit))
    worse = json.loads(json.dumps(doc))
    for s in worse["lanes"]["f32"]["stages"]:
        s["max_rel_err"] = s["max_rel_err"] * 2 + 1e-6
    worse_path = str(tmp_path / "worse.json")
    json.dump(worse, open(worse_path, "w"))
    assert precision_audit.main(["--diff", audit, worse_path]) == 1
    del doc["lanes"]
    json.dump(doc, open(worse_path, "w"))
    assert precision_audit.main(["--check", worse_path]) == 1


def test_tools_default_to_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    for tool in (fabric_soak, chaos_soak, precision_audit):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(["--workdir", str(tmp_path)] if tool is not precision_audit else [])


def test_median_study_on_the_cpu(tmp_path):
    """The median study at a fixture size on the CPU (the device median's
    plain version): both paths, bitwise equal, the default recorded."""
    path = tmp_path / "median.json"
    r = _tool("median_study", "--device", "cpu", "--n", "6000", "--repeat", "1", "--json", str(path))
    assert r.returncode == 0, r.stderr
    doc = json.loads(path.read_text())
    assert doc["default"] == "native" and doc["backend"] == "cpu"
    assert doc["native_cpp_s"] > 0 and doc["device_s"] > 0 and doc["device_cold_s"] > 0
    assert doc["paths_agree_bitwise"] and doc["differing"] == 0 and doc["max_ulp"] == 0
    r = _tool("median_study", "--skip-device", "--n", "3000", "--json", str(path))
    assert r.returncode == 0, r.stderr
    assert "device_s" not in json.loads(path.read_text())


def test_median_study_counts_ulps():
    from boinc_app_eah_brp_tpu_torch.tools.median_study import chi2_spectrum, ulp_diff

    a = chi2_spectrum(100)
    b = a.copy()
    b[[3, 50]] = np.nextafter(b[[3, 50]], np.float32(np.inf))
    b[50] = np.nextafter(b[50], np.float32(np.inf))
    assert ulp_diff(a, a) == (0, 0) and ulp_diff(a, b) == (2, 2)


def test_stagebench_median_times_the_device_median(monkeypatch):
    """``--median`` times the device median (``ops/median.py``), as the
    JAX tool's does, and the host median once beside it."""
    from boinc_app_eah_brp_tpu_torch.ops import median, native_median
    from boinc_app_eah_brp_tpu_torch.tools import bench, stagebench

    calls = {"device": 0, "native": 0}
    real_device, real_native = median.running_median, native_median.running_median

    def device(*a, **k):
        calls["device"] += 1
        return real_device(*a, **k)

    def native(*a, **k):
        calls["native"] += 1
        return real_native(*a, **k)

    monkeypatch.setattr(median, "running_median", device)
    monkeypatch.setattr(native_median, "running_median", native)
    problem = bench.synthetic_problem(4096, 4)
    calls.update(device=0, native=0)
    art = stagebench.stage_times(problem, device="cpu", batch=2, repeat=2, median=True, log=lambda m: None)
    assert calls["device"] == 3  # one warm-up and two timed
    assert art["stages"]["running_median_ms"] > 0 and art["stages"]["running_median_native_ms"] > 0


def test_bench_guard_times_the_native_median_only(tmp_path, monkeypatch):
    """The port's bench guard (``tools/bench.py::ensure_native``): the
    native median by default; ``ERP_MEDIAN=device`` exits and a library
    that does not load is ``RADPUL_EVAL``, with no override."""
    from boinc_app_eah_brp_tpu_torch.ops import native_median
    from boinc_app_eah_brp_tpu_torch.runtime.errors import RADPUL_EVAL, RadpulError
    from boinc_app_eah_brp_tpu_torch.tools import bench

    quiet = lambda m: None  # noqa: E731
    monkeypatch.delenv("ERP_MEDIAN", raising=False)
    assert bench.ensure_native(quiet) == native_median.load()
    monkeypatch.setenv("ERP_MEDIAN", "device")
    with pytest.raises(SystemExit, match="ERP_MEDIAN=device"):
        bench.ensure_native(quiet)
    monkeypatch.delenv("ERP_MEDIAN")
    monkeypatch.setenv("ERP_RNGMED_LIB", str(tmp_path / "absent.so"))
    monkeypatch.setattr(native_median, "_lib", None)
    with pytest.raises(RadpulError) as e:
        bench.ensure_native(quiet)
    assert e.value.code == RADPUL_EVAL


def test_make_bundle_ships_the_median_kernel(tmp_path):
    """The bundle takes every source's library, the median's among them;
    a kernel directory without it is refused, naming the file."""
    from boinc_app_eah_brp_tpu_torch.ops import kernels
    from boinc_app_eah_brp_tpu_torch.tools import make_bundle

    for n in kernels.SOURCES:
        (tmp_path / kernels.library_name(n)).write_bytes(b"placeholder")
    libs = make_bundle.kernel_libraries(str(tmp_path))
    assert str(tmp_path / kernels.library_name("median")) in libs and len(libs) == len(kernels.SOURCES)
    (tmp_path / kernels.library_name("median")).unlink()
    with pytest.raises(RuntimeError, match=kernels.library_name("median")):
        make_bundle.kernel_libraries(str(tmp_path))


# ---------------------------------------------------------------------------
# chaos_soak building blocks


class _Proc:
    def __init__(self, rc=None):
        self.returncode = rc

    def poll(self):
        return self.returncode


def _write_cp(path, n):
    write_checkpoint(path, Checkpoint(n_template=n, originalfile="wu.bin4", candidates=empty_candidates()),
                     bank=("bank.dat", 40))


def test_wait_for_fresh_checkpoint_states(tmp_path):
    cp = str(tmp_path / "c.cpt")
    stamp0 = chaos_soak.checkpoint_stamp(cp)
    assert stamp0 == 0 and chaos_soak.read_cp_n(cp) is None
    assert chaos_soak.wait_for_fresh_checkpoint(_Proc(), cp, stamp0, 0.2) == "timeout"
    assert chaos_soak.wait_for_fresh_checkpoint(_Proc(0), cp, stamp0, 5) == "exited"
    _write_cp(cp, 6)
    assert chaos_soak.wait_for_fresh_checkpoint(_Proc(), cp, stamp0, 5) == "advanced"
    assert chaos_soak.read_cp_n(cp) == 6
    stamp1 = chaos_soak.checkpoint_stamp(cp)
    assert chaos_soak.wait_for_fresh_checkpoint(_Proc(), cp, stamp1, 0.2) == "timeout"


def test_corrupt_checkpoint_falls_back_a_generation(tmp_path):
    cp = str(tmp_path / "c.cpt")
    _write_cp(cp, 4)
    _write_cp(cp, 8)
    assert os.path.exists(cp + ".1")
    chaos_soak.corrupt_checkpoint(cp)
    got, used, gen = load_resumable_checkpoint(cp, 40, "wu.bin4")
    assert (got.n_template, used, gen) == (4, cp + ".1", 1)


def test_resume_marker_and_counters(tmp_path):
    log_path = tmp_path / "run.log"
    log_path.write_text("[x][1][INFO ] Continuing work on wu.bin4 at template no. 12\n")
    assert chaos_soak._resumed_at(str(log_path)) == 12
    assert chaos_soak._resumed_at(str(tmp_path / "none.log")) is None
    stream = tmp_path / "m.jsonl"
    stream.write_text(
        json.dumps({"kind": "heartbeat", "metrics": {"counters": {"watchdog.self_fenced": {"value": 1}}}}) + "\n"
        + json.dumps({"kind": "run_report", "report": {"metrics": {"counters": {"resilience.rebalance": {"value": 2}}}}})
        + "\n{torn"
    )
    assert chaos_soak.report_counter(str(stream), "resilience.rebalance") == 2.0
    assert chaos_soak.report_counter(str(stream), "watchdog.self_fenced") == 0.0
    assert chaos_soak.stream_counter(str(stream), "watchdog.self_fenced") == 1.0


def test_wait_for_shard_commit_states(tmp_path):
    lease = tmp_path / "lease-1.json"
    assert chaos_soak.wait_for_shard_commit(str(tmp_path), 1, _Proc(), 0.1) == "timeout"
    lease.write_text(json.dumps({"start": 4, "n_done": 4, "complete": False, "state_path": "s"}))
    assert chaos_soak.wait_for_shard_commit(str(tmp_path), 1, _Proc(3), 1) == "exited"
    lease.write_text(json.dumps({"start": 4, "n_done": 6, "complete": False, "state_path": "s"}))
    assert chaos_soak.wait_for_shard_commit(str(tmp_path), 1, _Proc(), 1) == "committed"


def test_search_commands_and_envs(tmp_path):
    wu, bank = chaos_soak.build_inputs(str(tmp_path), 16, 7)
    cmd = chaos_soak.search_cmd(wu, bank, "cpu")("o.cand", "c.cpt")
    assert cmd[1:3] == ["-m", "boinc_app_eah_brp_tpu_torch"] and cmd[-2:] == ["--device", "cpu"]
    assert "--mesh" in cmd and "--mesh" not in chaos_soak.hosts_cmd(wu, bank, "cuda")("o", "c")
    env = chaos_soak.host_env(str(tmp_path), 3, 1, "sd", "cpu")
    assert (env["ERP_PROCESS_ID"], env["ERP_LOCAL_DEVICES"], env["ERP_CHECKPOINT_PERIOD"]) == ("1", "2", "0")
    assert "ERP_LOCAL_DEVICES" not in chaos_soak.host_env(str(tmp_path), 3, 1, "sd", "cuda")
    henv = chaos_soak.hang_env("dispatch:hang@n=4", watchdog_spec="dispatch=6", quarantine_k=2)
    assert (henv["ERP_FAULT_SPEC"], henv["ERP_QUARANTINE_K"], henv["ERP_FAULT_HANG_S"]) == (
        "dispatch:hang@n=4", "2", "3600")
    assert "ERP_FAULT_SPEC" not in chaos_soak.child_env()


# ---------------------------------------------------------------------------
# serving_chaos building blocks


def test_serving_chaos_shed_check():
    assert serving_chaos.shed_check() is None


def test_journal_snapshot_after_a_kill_validates(tmp_path):
    """A journal whose writer died mid-append (a torn last line) still
    validates, and replays its accepted-but-ungranted work."""
    jpath = str(tmp_path / "journal.jsonl")
    j = WUJournal(jpath)
    for t in ("t1", "t2"):
        j.record_submit(t, DriverArgs(inputfile=f"{t}.bin4", outputfile=f"{t}.cand", templatebank="b"))
    j.record_dispatch("t1")
    (tmp_path / "t1.cand").write_text("x")
    j.record_done("t1", str(tmp_path / "t1.cand"))
    with open(jpath, "a") as f:
        f.write('{"schema": "erp-serving-journal/1", "seq": 9, "ev')
    assert report_check.check_path(jpath) == ("erp-serving-journal/1", [])
    st = replay(jpath)
    assert [r["ticket"] for r in st.pending] == ["t2"] and st.done["t1"]["digest"]


def test_wait_for_first_grant(tmp_path):
    jpath = str(tmp_path / "journal.jsonl")
    assert serving_chaos.wait_for_first_grant(jpath, _Proc(1), timeout=1) is None
    j = WUJournal(jpath)
    for t in ("t1", "t2"):
        j.record_submit(t, DriverArgs(inputfile="a", outputfile=str(tmp_path / f"{t}.cand"), templatebank="b"))
    assert serving_chaos.wait_for_first_grant(jpath, _Proc(), timeout=0.2) is None
    (tmp_path / "t1.cand").write_text("x")
    j.record_done("t1", str(tmp_path / "t1.cand"))
    assert serving_chaos.wait_for_first_grant(jpath, _Proc(), timeout=5) == (1, 1)


def test_serve_commands(tmp_path):
    cmd = serving_chaos.serve_cmd(str(tmp_path), "cpu", supervised=3)
    assert cmd[1:3] == ["-m", serving_chaos.MODULE] and cmd[-2:] == ["--supervised", "3"]
    env = serving_chaos.serve_env(str(tmp_path), "journal_write:eio@n=3", "f.json")
    assert env["ERP_FAULT_STATE"] == str(tmp_path / "f.json") and "ERP_SLO_FILE" not in env


def test_inputs_match_the_test_fixtures(tmp_path):
    from fixtures import small_bank, synthetic_timeseries

    a = _inputs.pulsed_series(4096, 500.0, _inputs.ORBIT, 41.0, 6.0, 3)
    b = synthetic_timeseries(4096, f_signal=41.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=6.0, seed=3)
    assert np.array_equal(a, b)
    sb, jb = _inputs.small_bank(), small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2)
    assert all(np.array_equal(getattr(sb, k), getattr(jb, k)) for k in ("P", "tau", "psi0"))


# ---------------------------------------------------------------------------
# the whole soaks (slow; run them with -m chaos)


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("mode", [["--quick"], ["--hosts", "3", "--kill-host", "1"], ["--hang", "--timeout", "120"]],
                         ids=["kill-resume", "hosts", "hang"])
def test_chaos_soak_on_the_cpu(tmp_path, mode):
    r = _tool("chaos_soak", *mode, "--device", "cpu", "--workdir", str(tmp_path), timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "PASS" in r.stdout


@pytest.mark.slow
@pytest.mark.chaos
def test_serving_chaos_on_the_cpu(tmp_path):
    r = _tool("serving_chaos", "--quick", "--device", "cpu", "--workdir", str(tmp_path), timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "PASS" in r.stdout
