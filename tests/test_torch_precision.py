"""PyTorch port, the precision observatory (``runtime/precision.py``) on
the CPU, against the JAX package's.

Tolerances:
* the torch-free functions (dtype grids, ULP histograms, error
  statistics, the f64 oracle chain with its blocked running median, the
  toplist rows and candidate scores, the validators) are bitwise or
  exactly equal to the JAX package's on the same arrays;
* ``run_audit(device="cpu")`` on the CI fixture passes the committed
  ``PRECISION_BASELINE.json`` (its per-stage ceilings, recall 1.0), and
  its tap proof is exact: (M, T) byte-identical, 0 kernel builds and new
  cuFFT plans, and the per-template tap sums merge to exactly the
  production (M, T).
"""

import copy
import json
import os
import sys

import numpy as np
import pytest

from boinc_app_eah_brp_tpu.runtime import precision as jprec
from boinc_app_eah_brp_tpu_torch.runtime import metrics, precision

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))


def _arrays(seed=3, n=4096):
    rng = np.random.default_rng(seed)
    lane = rng.exponential(2.0, n).astype(np.float32)
    ref = lane.astype(np.float64) * (1.0 + rng.normal(0.0, 1e-6, n))
    lane[[5, 17]] = [np.nan, np.inf]
    lane[33] = -lane[33]
    return lane, ref


def test_stage_registry_agrees():
    assert precision.stage_registry_problems() == []
    assert precision.AUDIT_STAGES == jprec.AUDIT_STAGES
    assert precision.STAGE_NAMES == jprec.STAGE_NAMES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_grid_matches_jax(seed):
    lane, _ = _arrays(seed)
    lane = np.concatenate([lane, np.array([0.0, -0.0, 1.0 + 2.0**-8, 3.4e38, 1e-40], dtype=np.float32)])
    assert precision.quantize_bf16(lane).tobytes() == jprec.quantize_bf16(lane).tobytes()
    assert np.array_equal(precision._bf16_bits(lane), jprec._bf16_bits(lane))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ulp_histogram_and_error_stats_match_jax(dtype):
    lane, ref = _arrays()
    lane = np.nan_to_num(lane, nan=1.0, posinf=2.0)
    if dtype == "bf16":
        lane = precision.quantize_bf16(lane)
    assert precision.ulp_histogram(lane, ref, dtype) == jprec.ulp_histogram(lane, ref, dtype)
    assert precision.error_stats(lane, ref, dtype) == jprec.error_stats(lane, ref, dtype)


@pytest.mark.parametrize("window", [7, 8, 200, 201])
@pytest.mark.parametrize("block_bytes", [64, 4096, 64 << 20])
def test_blocked_running_median_matches_jax(monkeypatch, window, block_bytes):
    """The blocked f64 median gives JAX's unblocked values bit for bit,
    whatever the block (down to one window a block)."""
    x = np.random.default_rng(window).exponential(1.0, 3001)
    monkeypatch.setattr(precision, "_MEDIAN_BLOCK_BYTES", block_bytes)
    got = precision._running_median_f64(x, window)
    assert got.tobytes() == jprec._running_median_f64(x, window).tobytes()


def test_running_median_rejects_a_short_input():
    with pytest.raises(ValueError):
        precision._running_median_f64(np.zeros(3), 5)


@pytest.fixture(scope="module")
def fixtures():
    import precision_audit

    return precision.ci_fixture(), precision_audit.build_fixture()


def test_ci_fixture_equals_jax_build_fixture(fixtures):
    port, jax_fx = fixtures
    for a, b in zip(port[:4], jax_fx[:4]):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    pd, jd = port[5], jax_fx[5]
    for f in ("nsamples", "n_unpadded", "fft_size", "window_2", "fundamental_idx_hi", "harmonic_idx_hi", "dt", "t_obs"):
        assert getattr(pd, f) == getattr(jd, f), f
    pg, jg = port[6], jax_fx[6]
    for f in ("nsamples", "n_unpadded", "fft_size", "window_2", "fund_hi", "harm_hi", "dt", "max_slope", "lut_step"):
        assert getattr(pg, f) == getattr(jg, f), f


@pytest.fixture(scope="module")
def oracle_chains(fixtures):
    """The f64 oracle chain of both packages on the CI fixture."""
    from boinc_app_eah_brp_tpu.oracle.stats import base_thresholds as jax_thresholds
    from boinc_app_eah_brp_tpu_torch.oracle.stats import base_thresholds

    out = {}
    for name, mod, fx, thr in (
        ("port", precision, fixtures[0], base_thresholds),
        ("jax", jprec, fixtures[1], jax_thresholds),
    ):
        ts, P, tau, psi0, cfg, derived, geom = fx
        inter = mod.oracle_stage_intermediates(ts, P, tau, psi0, cfg, derived)
        rows = mod.toplist_rows(
            inter["maxima_M"], inter["maxima_T"], P, tau, psi0,
            thr(cfg.fA, derived.fft_size), geom.window_2, derived.t_obs,
        )
        out[name] = (inter, rows)
    return out


@pytest.mark.parametrize("stage", ["whitened", "resampled", "power", "sumspec", "maxima_M", "maxima_T"])
def test_f64_oracle_stages_equal_jax(oracle_chains, stage):
    assert oracle_chains["port"][0][stage].tobytes() == oracle_chains["jax"][0][stage].tobytes()


def test_f64_oracle_rows_equal_jax(oracle_chains):
    rows, jrows = oracle_chains["port"][1], oracle_chains["jax"][1]
    assert len(rows) >= 16 and rows == jrows


@pytest.mark.parametrize("perturb", ["same", "power", "drop", "reorder"])
def test_candidate_scores_match_jax(oracle_chains, fixtures, perturb):
    rows = list(oracle_chains["port"][1])
    lane = [list(r) for r in rows]
    if perturb == "power":
        lane[0][4] *= 1.03
        lane[3][4] *= 0.999
    elif perturb == "drop":
        lane = lane[1:-2]
    elif perturb == "reorder":
        lane[1][4], lane[2][4] = lane[2][4], lane[1][4]
    lane = [tuple(r) for r in lane]
    t_obs = fixtures[0][5].t_obs
    assert precision.candidate_scores(rows, lane, t_obs) == jprec.candidate_scores(rows, lane, t_obs)


# --- the audit --------------------------------------------------------------


@pytest.fixture(scope="module")
def audit(fixtures):
    metrics.configure(force=True)
    try:
        doc = precision.run_audit(*fixtures[0], lanes=("f32", "bf16"), batch_size=3, device="cpu")
        snap = metrics.snapshot()
    finally:
        metrics.finish(0)
    return doc, snap


def test_audit_document_validates_in_both_packages(audit):
    doc, _ = audit
    assert precision.validate_precision_audit(doc) == []
    assert jprec.validate_precision_audit(doc) == []
    assert doc["backend"] == "cpu" and set(doc["lanes"]) == {"f32", "bf16"}
    for lane in doc["lanes"].values():
        assert [s["stage"] for s in lane["stages"]] == list(precision.STAGE_NAMES)


def test_audit_passes_the_committed_baseline(audit):
    doc, _ = audit
    with open(os.path.join(REPO, "PRECISION_BASELINE.json")) as f:
        baseline = json.load(f)
    assert precision.validate_precision_baseline(baseline) == []
    assert precision.evaluate_baseline(doc, baseline) == []
    assert jprec.evaluate_baseline(doc, baseline) == []


def test_f32_lane_recall_and_tap_proof(audit, oracle_chains):
    doc, snap = audit
    f32 = doc["lanes"]["f32"]
    cand = f32["candidates"]
    assert cand["recall_at_tol"] == 1.0 and cand["jaccard"] == 1.0
    assert cand["oracle_n"] == len(oracle_chains["port"][1]) >= 16
    tap = f32["tap"]
    assert tap["byte_identical"] is True
    assert tap["recompiles_in_window"] == 0
    assert tap["tap_vs_production_max_rel"] == 0.0
    assert metrics.labeled("precision.stage_rel_err", lane="f32", stage="whiten") in snap["gauges"]
    assert metrics.labeled("precision.recall", lane="f32") in snap["gauges"]


def test_bf16_shadow_lane_quantifies_error(audit):
    doc, _ = audit
    f32 = {s["stage"]: s for s in doc["lanes"]["f32"]["stages"]}
    bf16 = {s["stage"]: s for s in doc["lanes"]["bf16"]["stages"]}
    for stage in ("resample", "fft+power", "harmonic-sum"):
        assert bf16[stage]["max_rel_err"] > f32[stage]["max_rel_err"]
    assert doc["lanes"]["bf16"]["attribution"]["worst_stage"] in precision.STAGE_NAMES


def test_gate_and_diff_name_the_stage(audit):
    doc, _ = audit
    with open(os.path.join(REPO, "PRECISION_BASELINE.json")) as f:
        baseline = json.load(f)
    worse = copy.deepcopy(doc)
    worse["lanes"]["f32"]["stages"][3]["max_rel_err"] = 1.0
    worse["lanes"]["f32"]["candidates"]["recall_at_tol"] = 0.5
    problems = precision.evaluate_baseline(worse, baseline)
    assert any("fft+power" in p for p in problems) and any("recall" in p for p in problems)
    assert problems == jprec.evaluate_baseline(worse, baseline)
    diff = precision.diff_docs(doc, worse)
    assert any("fft+power" in p for p in diff) and diff == jprec.diff_docs(doc, worse)
    assert precision.diff_docs(doc, doc) == []
    broken = copy.deepcopy(doc)
    broken["lanes"]["f32"]["tap"]["byte_identical"] = False
    assert any("tap proof" in p for p in precision.evaluate_baseline(broken, baseline))


def test_attribute_template_names_a_stage(fixtures):
    ts, P, tau, psi0, _, derived, geom = fixtures[0]
    rec = precision.attribute_template(ts, geom, derived, float(P[1]), float(tau[1]), float(psi0[1]), device="cpu")
    assert rec["worst_stage"] in precision.STAGE_NAMES
    assert set(rec["stage_rel_err"]) == {"resample", "fft+power", "harmonic-sum"}
    assert all(0.0 <= v < 1e-3 for v in rec["stage_rel_err"].values())
