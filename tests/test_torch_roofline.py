"""PyTorch port, the H100 roofline model (``runtime/roofline.py``).

The production geometry (2^22 samples at 65.476 us, padding 3, f0 400 Hz,
window 1000) at T = 32 must reproduce the bounds ``chip_smoke.py``
printed before the model moved into the package (its ``bounds`` line,
rounded there to 3 decimals): A 0.165, B 0.641, C 0.466, the rfft's one
pass 0.962 ms, and for bank200's exact means the chain 8.473 ms and the
float32 bound 0.602 ms.  bank200's n_steps come from the tail of each
template's float32 del_t chain (the shrink loop only reads the tail),
computed exactly as the oracle computes it."""

import os
import subprocess
import sys

import numpy as np
import pytest

from boinc_app_eah_brp_tpu_torch.io import read_template_bank
from boinc_app_eah_brp_tpu_torch.models import search
from boinc_app_eah_brp_tpu_torch.ops import harmonic
from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
from boinc_app_eah_brp_tpu_torch.oracle.resample import ResampleParams
from boinc_app_eah_brp_tpu_torch.oracle.sincos import sincos_lut_lookup
from boinc_app_eah_brp_tpu_torch.runtime import devicecost, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANK200 = os.path.join(REPO, "tests", "golden", "bank200.txt")
N_UNPADDED = 1 << 22


@pytest.fixture(scope="module")
def production():
    cfg = SearchConfig(f0=400.0, padding=3.0, fA=0.08, window=1000, white=True)
    return DerivedParams.derive(N_UNPADDED, 65.476, cfg)


def _n_steps_tail(rp: ResampleParams, tail: int = 8192) -> int:
    """The oracle's ``compute_n_steps(compute_del_t(rp))`` from the last
    ``tail`` samples of del_t (each sample's float32 chain is its own)."""
    n = rp.nsamples_unpadded
    i_f = np.arange(n - tail, n, dtype=np.int64).astype(np.float32)
    t = (i_f * rp.dt).astype(np.float32)
    phase = (rp.omega * t + rp.psi0).astype(np.float32)
    del_t = (rp.tau * sincos_lut_lookup(phase)[0] * rp.step_inv - rp.s0).astype(np.float32)
    limit = np.float32(n - 1)
    k = n - 1
    while k >= n - tail and np.float32(k) - del_t[k - (n - tail)] >= limit:
        k -= 1
    assert k >= n - tail, "the trailing run is longer than the tail"
    return k


@pytest.fixture(scope="module")
def bank200_n_steps(production):
    d = production
    bank = read_template_bank(BANK200)
    return [
        _n_steps_tail(ResampleParams.from_template(P, tau, psi, d.dt, d.nsamples, d.n_unpadded))
        for P, tau, psi in zip(bank.P, bank.tau, bank.psi0)
    ]


def test_n_steps_tail_is_the_oracles():
    from boinc_app_eah_brp_tpu_torch.oracle.resample import compute_del_t, compute_n_steps

    rp = ResampleParams.from_template(2.2, 0.04, 1.2, 500e-6, 1 << 15, 1 << 15)
    assert _n_steps_tail(rp, 4096) == compute_n_steps(compute_del_t(rp), 1 << 15)


def test_production_bounds_reproduce_chip_smoke(production, bank200_n_steps):
    d = production
    costs = {
        c.name: c.bound()
        for c in roofline.pipeline_costs(
            d.nsamples, d.n_unpadded, d.fundamental_idx_hi, d.harmonic_idx_hi, 32, n_steps=bank200_n_steps
        )
    }
    assert [round(costs[k]["bound_ms"], 3) for k in ("resample", "fftprep", "fold_spectrum", "rfft")] == [
        0.165, 0.641, 0.466, 0.962,
    ]
    assert all(costs[k]["bound_by"] == "bytes" for k in ("resample", "fftprep", "fold_spectrum", "rfft", "merge"))
    mean = costs["serial_mean"]
    assert round(mean["chain_ms"], 3) == 8.473 and mean["limit"] == "chain"
    assert round(mean["bound_ms"], 3) == 0.602 and mean["bound_by"] == "operations"


def test_off_path_entries(production):
    d = production
    assert round(roofline.resample_cost(1, d.n_unpadded).bound()["bound_ms"], 4) == 0.0100
    fold = roofline.fold_cost(32, d.nsamples, d.fundamental_idx_hi, complex_input=False)
    assert fold.name == "fold" and round(fold.bound()["bound_ms"], 3) == 0.264


@pytest.mark.parametrize("fund_hi", [1, 7, 16, 329551, 1 << 20])
def test_state_width_is_the_folds(fund_hi):
    assert roofline.state_width(fund_hi) == harmonic.state_width(fund_hi)


def test_report_fields_and_attainable(production):
    d = production
    rep = roofline.roofline_report(
        d.nsamples, d.n_unpadded, d.fundamental_idx_hi, d.harmonic_idx_hi, batch=32,
        measured_templates_per_sec=2930.0, card="NVIDIA H100 80GB HBM3",
    )
    assert rep["peaks"] == "h100" and rep["model_bound"] == "rfft"
    assert [s["stage"] for s in rep["stages"]] == ["resample", "fftprep", "rfft", "fold_spectrum", "merge"]
    t_batch = sum(s["t_ms"] for s in rep["stages"]) / 1e3
    assert rep["attainable_templates_per_sec"] == pytest.approx(32 / t_batch)
    assert rep["fraction_of_attainable"] == pytest.approx(2930.0 / rep["attainable_templates_per_sec"])
    # every stage of a batch is bound by its bytes: the two shares agree
    assert rep["hbm_utilization"] == pytest.approx(rep["fraction_of_attainable"])
    assert 0.0 < rep["fraction_of_attainable"] <= 1.0
    assert rep["bound"].startswith("overhead")
    assert "mfu" not in rep and "projection" not in rep


def test_exact_mean_spreads_over_the_run(production, bank200_n_steps):
    d = production
    args = (d.nsamples, d.n_unpadded, d.fundamental_idx_hi, d.harmonic_idx_hi)
    plain = roofline.roofline_report(*args, batch=32, card="h100")
    with_mean = roofline.roofline_report(*args, batch=32, n_steps=bank200_n_steps, card="h100")
    per_tpl = 1 / with_mean["attainable_templates_per_sec"] - 1 / plain["attainable_templates_per_sec"]
    assert per_tpl == pytest.approx(8.473e-3 / 200, rel=1e-3)
    assert with_mean["model_bound"] == "rfft"


def test_off_the_card_the_model_is_labelled_cpu(production):
    d = production
    rep = roofline.roofline_report(d.nsamples, d.n_unpadded, d.fundamental_idx_hi, d.harmonic_idx_hi)
    assert rep["card"] == "cpu" and rep["peaks"] == "cpu"


@pytest.mark.parametrize("name", ["Tesla V100-SXM2-16GB", "NVIDIA A100-SXM4-80GB", "NVIDIA L40S"])
def test_another_card_is_unmodelled_not_given_cpu_rates(production, name):
    d = production
    assert roofline.peaks_key(name) is None
    rep = roofline.roofline_report(
        d.nsamples, d.n_unpadded, d.fundamental_idx_hi, d.harmonic_idx_hi,
        measured_templates_per_sec=2930.0, card=name,
    )
    assert rep["card"] == name and rep["peaks"] is None and rep["stages"] == []
    assert rep["attainable_templates_per_sec"] is None and rep["model_bound"] == "unmodelled"
    assert "fraction_of_attainable" not in rep and "hbm_utilization" not in rep
    with pytest.raises(ValueError, match="no roofline rates"):
        devicecost.stage_time_model(d.nsamples, d.n_unpadded, d.fundamental_idx_hi, d.harmonic_idx_hi, card=name)
    assert roofline.peaks_key("NVIDIA H100 80GB HBM3") == "h100"


def test_rejects_a_harmonic_range_beyond_the_spectrum():
    with pytest.raises(ValueError):
        roofline.pipeline_costs(4096, 4096, 100, 4096, 2)


def test_module_imports_no_torch():
    probe = (
        "import sys\n"
        "from boinc_app_eah_brp_tpu_torch.runtime import roofline\n"
        "roofline.roofline_report(12582912, 4194304, 329551, 5272824)\n"
        "assert 'torch' not in sys.modules\nprint('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_takes_its_bounds_from_the_model():
    """One model, not two: the script names no peak of its own."""
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert "roofline" in src
    for name in ("PEAK_BYTES_S", "PEAK_F32_INSTR_S", "ADD_LATENCY_S", "def bound(", "def chain_bound("):
        assert name not in src, name


def test_geometry_widths_match_the_state(production):
    d = production
    geom = search.SearchGeometry.from_derived(d)
    assert roofline.state_width(geom.fund_hi) == 329552
