"""PyTorch port, the numerical-health watchdog (``runtime/health.py``) and
its hooks, on the CPU, against the JAX package.

Tolerances:
* ``batch_health_vec`` is bitwise against the JAX package's on the same
  sums, mask and state (counts and maxima are exact);
* ``Watchdog.check`` gives the same violations, counters and gauges on the
  same vectors;
* ``run_bank`` with health on gives (M, T) byte-identical to health off;
* the sentinel probe agrees with the oracle and with the JAX package's
  probe: the same (k, f0) and powers within ``ERP_HEALTH_TOL`` (1e-2; the
  two FFT libraries differ by ~1e-6 relative).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu.models import search as jax_search
from boinc_app_eah_brp_tpu.oracle.pipeline import DerivedParams as JaxDerived
from boinc_app_eah_brp_tpu.oracle.pipeline import SearchConfig as JaxConfig
from boinc_app_eah_brp_tpu.runtime import health as jhealth
from boinc_app_eah_brp_tpu.runtime import metrics as jmetrics
from boinc_app_eah_brp_tpu_torch.io import parse_result_file, write_template_bank, write_workunit
from boinc_app_eah_brp_tpu_torch.models import search
from boinc_app_eah_brp_tpu_torch.ops import harmonic
from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
from boinc_app_eah_brp_tpu_torch.runtime import flightrec, health, metrics, precision
from boinc_app_eah_brp_tpu_torch.runtime.errors import RADPUL_EVAL, exit_code_for
from boinc_app_eah_brp_tpu_torch.runtime.health import HealthError
from fixtures import small_bank, synthetic_timeseries

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT_US = 500.0
CFG = dict(f0=250.0, padding=1.0, fA=0.04, window=200, white=False)


@pytest.fixture(autouse=True)
def _health_env(monkeypatch):
    for name in (health.HEALTH_EVERY_ENV, health.HEALTH_ACTION_ENV, health.HEALTH_SENTINELS_ENV, health.HEALTH_TOL_ENV):
        monkeypatch.delenv(name, raising=False)
    yield
    metrics.finish(0)
    jmetrics.finish(0)


def _setup():
    ts = synthetic_timeseries(4096, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    derived = DerivedParams.derive(len(ts), DT_US, SearchConfig(**CFG))
    bank = small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2)
    bounds = dict(
        max_slope=search.max_slope_for_bank(bank.P, bank.tau),
        lut_step=search.lut_step_for_bank(bank.P, derived.dt),
        lut_tiles=search.lut_tiles_for_bank(bank.P, bank.psi0, derived.n_unpadded, derived.dt),
    )
    geom = search.SearchGeometry.from_derived(derived, exact_mean=True, **bounds)
    return ts, bank, geom, derived, bounds


# --- knobs -----------------------------------------------------------------


@pytest.mark.parametrize(
    "env",
    [
        {},
        {"ERP_HEALTH_EVERY": "32", "ERP_HEALTH_ACTION": "abort", "ERP_HEALTH_SENTINELS": "3", "ERP_HEALTH_TOL": "1e-3"},
        {"ERP_HEALTH_EVERY": "-4", "ERP_HEALTH_ACTION": "bogus", "ERP_HEALTH_SENTINELS": "x", "ERP_HEALTH_TOL": "y"},
    ],
)
def test_knobs_match_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for fn in ("every", "action", "tolerance", "sentinel_count"):
        assert getattr(health, fn)() == getattr(jhealth, fn)(), fn
    assert (health.watchdog() is None) == (jhealth.watchdog() is None)


def test_disabled_path_imports_no_torch():
    probe = (
        "import sys\n"
        "from boinc_app_eah_brp_tpu_torch.runtime import health\n"
        "assert health.watchdog() is None\n"
        "bad = [m for m in sys.modules if m in ('torch', 'jax') or m.startswith('boinc_app_eah_brp_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("ERP_HEALTH")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


# --- the batch health vector ------------------------------------------------


def _health_case(case):
    rng = np.random.default_rng(7)
    B, W = 4, 96
    sums = rng.exponential(3.0, (B, 5, W)).astype(np.float32)
    valid = np.array([True, True, True, False])
    M = rng.exponential(5.0, (5, W)).astype(np.float32)
    if case == "nan":
        sums[1, 2, 7] = np.nan
        sums[2, 0, 3] = np.nan
    elif case == "inf":
        sums[0, 4, 11] = np.inf
        sums[2, 1, 5] = -np.inf
    elif case == "padded-poison":
        sums[3] = np.nan  # a padded slot: excluded
    elif case == "all-invalid":
        valid[:] = False
    elif case == "all-nonfinite":
        sums[:] = np.nan
    elif case == "state":
        M[3, 17] = np.nan
        M[0, 0] = np.inf
    elif case == "negative":
        sums[1, 1, 1] = -2.5
    elif case == "extreme":  # finite values beyond the sentinels, and no padding
        sums[0, 0, 0], sums[1, 1, 1] = -3.2e38, 3.3e38
        valid[:] = True
    elif case == "extreme-padded":
        sums[0, 0, 0], sums[1, 1, 1] = -3.2e38, 3.3e38
    return sums, valid, M


@pytest.mark.parametrize(
    "case",
    ["clean", "nan", "inf", "padded-poison", "all-invalid", "all-nonfinite", "state", "negative", "extreme",
     "extreme-padded"],
)
def test_batch_health_vec_matches_jax_bitwise(case):
    import jax.numpy as jnp

    sums, valid, M = _health_case(case)
    want = np.asarray(jax_search.batch_health_vec(jnp.asarray(sums), jnp.asarray(valid), jnp.asarray(M)))
    got = search.batch_health_vec(torch.from_numpy(sums), torch.from_numpy(valid), torch.from_numpy(M))
    assert got.dtype == torch.float32 and got.shape == (4,)
    assert got.numpy().tobytes() == want.astype(np.float32).tobytes(), (got, want)


def test_batch_health_vec_refuses_rows_past_the_exact_float32_count():
    """Its finite count is a float32 sum of ones: a row of 2**24 slots or
    more would round, so it raises before any pass (a stride-0 view here,
    no memory)."""
    W = (1 << 24) // 5 + 1
    sums = torch.zeros(()).expand(1, 5, W)
    with pytest.raises(ValueError, match="float32"):
        search.batch_health_vec(sums, torch.ones(1, dtype=torch.bool), torch.zeros(5, 4))


def _run_watchdog(pkg_health, pkg_metrics, vecs, act):
    pkg_metrics.configure(force=True)
    try:
        wd = pkg_health.Watchdog(4, act)
        raised = None
        for i, v in enumerate(vecs):
            wd.push(2 * i, 2 * i + 2, v)
            try:
                wd.maybe_check("run_bank")
            except pkg_health.HealthError as e:
                raised = str(e)
                break
        snap = pkg_metrics.snapshot()
    finally:
        pkg_metrics.finish(0)
    counters = {k: v["value"] for k, v in snap["counters"].items() if k.startswith("health.")}
    gauges = {k: v["value"] for k, v in snap["gauges"].items() if k.startswith("health.")}
    return wd.violations, counters, gauges, raised


@pytest.mark.parametrize("act", ["warn", "abort"])
@pytest.mark.parametrize("case", ["clean", "nan", "state", "negative", "mixed"])
def test_watchdog_check_matches_jax(case, act):
    import jax.numpy as jnp

    if case == "mixed":
        cases = ["clean", "nan", "inf", "state", "padded-poison", "negative"]
    else:
        cases = [case, "clean", case, "clean"]
    vecs = []
    for c in cases:
        sums, valid, M = _health_case(c)
        vecs.append(np.asarray(jax_search.batch_health_vec(jnp.asarray(sums), jnp.asarray(valid), jnp.asarray(M))))
    port = _run_watchdog(health, metrics, [torch.from_numpy(v.copy()) for v in vecs], act)
    jax_side = _run_watchdog(jhealth, jmetrics, [jnp.asarray(v) for v in vecs], act)
    assert port[:3] == jax_side[:3]
    assert (port[3] is None) == (jax_side[3] is None)
    if case != "clean":
        assert port[0] >= 1


# --- the dispatch loop ------------------------------------------------------


def _run(ts, bank, geom, batch=2):
    M, T = search.run_bank(torch.from_numpy(ts), bank.P, bank.tau, bank.psi0, geom, batch_size=batch)
    return M.numpy().copy(), T.numpy().copy()


def _poison_fold(monkeypatch):
    """Every batch's folded sums NaN: the corruption the merge would drop
    silently (NaN > M is false)."""
    real = search.sumspec_spectrum

    def poisoned(*a, **k):
        return real(*a, **k) * float("nan")

    monkeypatch.setattr(search, "sumspec_spectrum", poisoned)


def test_health_on_is_byte_identical_and_checks(monkeypatch):
    ts, bank, geom, _, _ = _setup()
    off = _run(ts, bank, geom)
    monkeypatch.setenv(health.HEALTH_EVERY_ENV, "1")
    metrics.configure(force=True)
    on = _run(ts, bank, geom)
    snap = metrics.snapshot()
    assert off[0].tobytes() == on[0].tobytes() and off[1].tobytes() == on[1].tobytes()
    assert snap["counters"]["health.checks"]["value"] >= 1
    assert snap["counters"].get("health.violations", {}).get("value", 0) == 0
    assert snap["gauges"]["health.spectrum_max"]["value"] > 0


def test_step_health_vector_only_when_asked():
    ts, bank, geom, _, _ = _setup()
    dev_bank = search.upload_bank(search.bank_params_host(bank.P, bank.tau, bank.psi0, geom.dt), 2, "cpu")
    tts = torch.from_numpy(ts)
    assert len(search.BankStep(geom, dev_bank, 2)(tts, 0, len(bank.P))) == 2
    out = search.BankStep(geom, dev_bank, 2, with_health=True)(tts, 0, len(bank.P))
    assert len(out) == 3 and out[2].shape == (4,) and out[2][0] == 0


def test_nan_fold_caught_in_warn_mode(monkeypatch):
    ts, bank, geom, _, _ = _setup()
    monkeypatch.setenv(health.HEALTH_EVERY_ENV, "2")
    _poison_fold(monkeypatch)
    metrics.configure(force=True)
    _run(ts, bank, geom)  # warns, finishes
    snap = metrics.snapshot()
    assert snap["counters"]["health.violations"]["value"] >= 1
    assert snap["counters"]["health.nonfinite"]["value"] > 0


def test_nan_fold_raises_in_abort_mode(monkeypatch):
    ts, bank, geom, _, _ = _setup()
    monkeypatch.setenv(health.HEALTH_EVERY_ENV, "1")
    monkeypatch.setenv(health.HEALTH_ACTION_ENV, "abort")
    _poison_fold(monkeypatch)
    with pytest.raises(HealthError, match="non-finite"):
        _run(ts, bank, geom)
    assert exit_code_for(HealthError("x")) == RADPUL_EVAL


# --- the sentinel probe -----------------------------------------------------


def test_sentinel_probe_matches_oracle_and_jax(monkeypatch):
    monkeypatch.setenv(health.HEALTH_EVERY_ENV, "1")
    ts, bank, geom, derived, bounds = _setup()
    metrics.configure(force=True)
    wd = health.watchdog()
    probe = health.SentinelProbe(lambda: ts, bank.P, bank.tau, bank.psi0, geom, derived, wd, k=2, device="cpu")
    results = probe.probe("test")
    assert len(results) == 2 and wd.violations == 0
    for rec in results:
        assert rec["rel_err"] < health.tolerance(), rec
    # the same probe in the JAX package
    jderived = JaxDerived.derive(len(ts), DT_US, JaxConfig(**CFG))
    jgeom = jax_search.SearchGeometry.from_derived(jderived, exact_mean=True, **bounds)
    jprobe = jhealth.SentinelProbe(lambda: ts, bank.P, bank.tau, bank.psi0, jgeom, jderived, jhealth.watchdog(), k=2)
    jresults = jprobe.probe("test")
    for rec, jrec in zip(results, jresults):
        assert (rec["template"], rec["harmonics"], rec["f0"]) == (jrec["template"], jrec["harmonics"], jrec["f0"])
        assert abs(rec["device"] - jrec["device"]) <= health.tolerance() * abs(jrec["device"])
        assert rec["oracle"] == jrec["oracle"]  # the same host oracle, bitwise
    # later probes reuse the cached goldens: the oracle is not consulted
    monkeypatch.setattr(probe, "_oracle_power", lambda *a: pytest.fail("golden cache was bypassed"))
    assert all(r["rel_err"] < health.tolerance() for r in probe.probe("test"))
    assert metrics.snapshot()["counters"]["health.sentinel_probes"]["value"] == 2


def test_sentinel_probe_detects_drift_and_names_a_stage(monkeypatch):
    monkeypatch.setenv(health.HEALTH_EVERY_ENV, "1")
    monkeypatch.setenv(health.HEALTH_ACTION_ENV, "warn")
    ts, bank, geom, derived, _ = _setup()
    metrics.configure(force=True)
    wd = health.watchdog()
    probe = health.SentinelProbe(lambda: ts, bank.P, bank.tau, bank.psi0, geom, derived, wd, k=1, device="cpu")
    probe.probe("test")
    assert wd.violations == 0
    real_peak = probe._device_peak

    def drifted(t):
        k_h, f0, p = real_peak(t)
        return k_h, f0, p * 2.0

    monkeypatch.setattr(probe, "_device_peak", drifted)
    results = probe.probe("test")
    assert wd.violations == 1
    assert results[0]["worst_stage"] in precision.STAGE_NAMES
    assert set(results[0]["stage_rel_err"]) <= set(precision.STAGE_NAMES)
    snap = metrics.snapshot()
    assert snap["gauges"]["health.sentinel_max_rel_err"]["value"] > 0.5
    assert snap["histograms"]["health.sentinel_rel_err"]["count"] == 2


def test_sentinel_drift_aborts_in_abort_mode(monkeypatch):
    monkeypatch.setenv(health.HEALTH_EVERY_ENV, "1")
    monkeypatch.setenv(health.HEALTH_ACTION_ENV, "abort")
    ts, bank, geom, derived, _ = _setup()
    wd = health.watchdog()
    probe = health.SentinelProbe(lambda: ts, bank.P, bank.tau, bank.psi0, geom, derived, wd, k=1, device="cpu")
    monkeypatch.setattr(probe, "_device_peak", lambda t: (0, 300, 1e9))
    with pytest.raises(HealthError, match="sentinel"):
        probe.probe("test")


def test_template_sumspec_is_a_batch_row():
    """The probe's one-template search is the batch step's row for that
    template (T = 1 through the same operations)."""
    ts, bank, geom, _, _ = _setup()
    tts = torch.from_numpy(ts)
    dev_bank = search.upload_bank(search.bank_params_host(bank.P, bank.tau, bank.psi0, geom.dt), 4, "cpu")
    step = search.BankStep(geom, dev_bank, 4)
    step(tts, 0, 1)  # template 0 alone: M is its sums
    one = search.template_sumspec(tts, bank.P[0], bank.tau[0], bank.psi0[0], geom)
    assert one.shape == (5, harmonic.state_width(geom.fund_hi))
    assert torch.equal(one, step.M)


# --- the command line -------------------------------------------------------


def _write_inputs(tmp_path):
    ts = synthetic_timeseries(4096, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    wu = str(tmp_path / "wu.bin4")
    write_workunit(wu, ts, tsample_us=DT_US, scale=1.0)
    bankfile = str(tmp_path / "bank.dat")
    write_template_bank(bankfile, small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2))
    return wu, bankfile


def test_cli_health_probes_at_checkpoints_rows_unchanged(tmp_path, monkeypatch):
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main

    wu, bankfile = _write_inputs(tmp_path)
    monkeypatch.chdir(tmp_path)
    common = f"-i {wu} -t {bankfile} -B 200 --batch 2 --device cpu"
    assert main(f"{common} -o off.cand -c off.cpt".split()) == 0
    monkeypatch.setenv(health.HEALTH_EVERY_ENV, "2")
    monkeypatch.setenv("ERP_CHECKPOINT_PERIOD", "0")
    assert main(f"{common} -o on.cand -c on.cpt --metrics-file m.jsonl".split()) == 0
    assert np.array_equal(parse_result_file("on.cand").lines, parse_result_file("off.cand").lines)
    counters = json.load(open("m.jsonl.report.json"))["metrics"]["counters"]
    # 2 batches: a checkpoint after each and the final one, each probing
    assert counters["health.sentinel_probes"]["value"] == 3
    assert counters["health.checks"]["value"] >= 1
    assert counters.get("health.violations", {}).get("value", 0) == 0


def test_driver_abort_exits_radpul_eval_with_dump(tmp_path, monkeypatch):
    from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs, run_search

    monkeypatch.setenv(health.HEALTH_EVERY_ENV, "1")
    monkeypatch.setenv(health.HEALTH_ACTION_ENV, "abort")
    monkeypatch.delenv("ERP_BLACKBOX", raising=False)
    monkeypatch.setenv("ERP_BLACKBOX_DIR", str(tmp_path))
    _poison_fold(monkeypatch)
    wu, bankfile = _write_inputs(tmp_path)
    args = DriverArgs(
        inputfile=wu, outputfile=str(tmp_path / "out.cand"), templatebank=bankfile,
        checkpointfile=str(tmp_path / "cp.cpt"), window=200, batch_size=2, device="cpu",
    )
    try:
        assert run_search(args) == RADPUL_EVAL
    finally:
        flightrec.disarm()
    assert not (tmp_path / "out.cand").exists()
    dumps = list(tmp_path.glob("erp-blackbox-*.json"))
    assert dumps, "the health abort left no black-box dump"
    doc = json.load(open(dumps[0]))
    assert flightrec.validate_dump(doc) == []
    kinds = [e.get("kind") for e in flightrec.events_from_dump(doc)]
    assert "health-violation" in kinds


def test_health_on_search_hits_a_step_cache_warmed_without_it(monkeypatch):
    """The health vector is eager reductions with no build and no plan, so
    a health-on search of a warmed class is a step-cache hit."""
    from boinc_app_eah_brp_tpu_torch.runtime.scheduler import Scheduler, WarmSpec

    ts, bank, geom, _, _ = _setup()
    sched = Scheduler(device="cpu")
    try:
        assert sched.warm([WarmSpec(geom, 2)])["steps"] == 1
        monkeypatch.setenv(health.HEALTH_EVERY_ENV, "1")
        search.run_bank(
            torch.from_numpy(ts), bank.P, bank.tau, bank.psi0, geom, batch_size=2, step_cache=sched.step_cache
        )
    finally:
        sched.close()
    assert (sched.step_cache.hits, sched.step_cache.misses) == (1, 0)
    assert len(sched.step_cache) == 1


@pytest.mark.parametrize("act", ["warn", "abort"])
def test_fleet_server_sessions_run_health(tmp_path, monkeypatch, act):
    """A served workunit honours the health knobs: a healthy one probes at
    its checkpoint and gives the health-off rows; a poisoned fold under
    abort fails its own result with RADPUL_EVAL."""
    from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs, run_search
    from boinc_app_eah_brp_tpu_torch.serving import FleetServer

    wu, bankfile = _write_inputs(tmp_path)

    def args(name):
        return DriverArgs(
            inputfile=wu, outputfile=str(tmp_path / f"{name}.cand"), templatebank=bankfile,
            checkpointfile=str(tmp_path / f"{name}.cpt"), window=200, batch_size=2, device="cpu",
        )

    assert run_search(args("off")) == 0
    monkeypatch.setenv(health.HEALTH_EVERY_ENV, "2")
    monkeypatch.setenv(health.HEALTH_ACTION_ENV, act)
    probes = []
    real_probe = health.SentinelProbe.probe
    monkeypatch.setattr(health.SentinelProbe, "probe", lambda self, where="checkpoint": probes.append(where) or real_probe(self, where))
    if act == "abort":
        _poison_fold(monkeypatch)
    with FleetServer(name="health", device="cpu") as server:
        res = server.process(args("served"))
    if act == "abort":
        assert res.code == RADPUL_EVAL and not (tmp_path / "served.cand").exists()
        return
    assert res.ok and probes == ["checkpoint"]
    assert np.array_equal(parse_result_file(str(tmp_path / "served.cand")).lines,
                          parse_result_file(str(tmp_path / "off.cand")).lines)
