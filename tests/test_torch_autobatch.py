"""PyTorch port, batch auto-selection against the JAX package's: the same
decision for the same ``ERP_BATCH``, memory budget and sweep artifact.

The budget and the card kind are monkeypatched on both sides.  The two
packages anchor their working-set factor on different devices (the JAX
package on a TPU compile, the port on the card's measured peak), so the
JAX side runs with the port's factor: what is compared is the selection
order and the clamps.  The port reads only its own artifact (schema
``erp-torch-batchsweep/1``); a JAX ``BATCHSWEEP_r*.json`` is ignored even
when pointed at.  Tolerance: exact (integers and decision strings).
"""

import json

import pytest

from boinc_app_eah_brp_tpu.runtime import autobatch as jab
from boinc_app_eah_brp_tpu_torch.runtime import autobatch as pab

N = 12_582_912  # the production nsamples (2^22 samples padded 3x)
KIND = "NVIDIA H100 80GB HBM3"
GB = 10**9


@pytest.fixture
def both(monkeypatch, tmp_path):
    """Both packages with the budget and card kind of each case, the
    port's factor, and no sweep artifact unless a case writes one."""
    monkeypatch.delenv("ERP_BATCH", raising=False)
    monkeypatch.setattr(jab, "_WORKING_SET_FACTOR", pab._WORKING_SET_FACTOR)
    monkeypatch.setenv("ERP_BATCH_SWEEP", str(tmp_path / "BATCHSWEEP_r99.json"))
    monkeypatch.setenv(pab.SWEEP_ENV, str(tmp_path / "TORCH_BATCHSWEEP.json"))

    def setup(budget, kind=KIND, sweep=None):
        monkeypatch.setattr(jab, "device_memory_budget", lambda: budget)
        monkeypatch.setattr(pab, "device_memory_budget", lambda device=None: budget)
        monkeypatch.setattr(jab, "_current_device_kind", lambda: kind)
        monkeypatch.setattr(pab, "_current_device_kind", lambda device=None: kind)
        if sweep is not None:
            with open(tmp_path / "BATCHSWEEP_r99.json", "w") as f:
                json.dump(sweep, f)
            with open(tmp_path / "TORCH_BATCHSWEEP.json", "w") as f:
                json.dump({"schema": pab.SWEEP_SCHEMA, **sweep}, f)

    return setup


def _decide(mod, n=N):
    lines = []
    b = mod.choose_batch(n, log=lines.append)
    return b, lines


@pytest.mark.parametrize("budget", [None, 1 * GB, 3 * GB, 10 * GB, 30 * GB, 79 * GB, 400 * GB])
def test_memory_model_matches(both, budget):
    both(budget)
    (jb, jl), (pb, pl) = _decide(jab), _decide(pab)
    assert pb == jb and pl == jl
    assert pab.model_batch(N, budget) == jab.model_batch(N, budget)
    assert pb in (8, 16, 32, 64, 128)


@pytest.mark.parametrize(
    "sweep,budget",
    [
        ({"best_batch": 64, "device_kind": KIND, "nsamples": N}, 79 * GB),  # proven
        ({"best_batch": 64, "device_kind": KIND, "nsamples": N}, 1 * GB),  # proven beats the model
        ({"best_batch": 64, "device_kind": KIND, "nsamples": N // 2}, 79 * GB),  # other size: model-gated
        ({"best_batch": 128, "device_kind": KIND, "nsamples": N // 2}, 5 * GB),  # gated and refused
        ({"best_batch": 32, "device_kind": "TPU v5 lite", "nsamples": N}, 79 * GB),  # other kind
        ({"best_batch": 32, "device_kind": None, "nsamples": None}, 79 * GB),  # kind unknown
        ({"best_batch": 32, "device_kind": KIND, "nsamples": N}, None),
    ],
)
def test_sweep_decision_matches(both, sweep, budget):
    both(budget, sweep=sweep)
    (jb, jl), (pb, pl) = _decide(jab), _decide(pab)
    assert (pb, pl) == (jb, jl)


def test_env_override_matches(both, monkeypatch):
    both(79 * GB)
    monkeypatch.setenv("ERP_BATCH", "24")
    assert _decide(pab) == _decide(jab) == (24, ["Batch size 24 (ERP_BATCH override).\n"])


def test_ignores_a_jax_sweep_artifact(both, tmp_path, monkeypatch):
    """A TPU sweep carries no schema the port accepts: pointed at it, the
    port falls back to its memory model, where the JAX package takes it."""
    both(79 * GB, kind=KIND)
    jax_art = tmp_path / "BATCHSWEEP_r07.json"
    jax_art.write_text(json.dumps({"best_batch": 8, "rungs": [], "backend": "tpu"}))
    monkeypatch.setenv("ERP_BATCH_SWEEP", str(jax_art))
    monkeypatch.setenv(pab.SWEEP_ENV, str(jax_art))
    assert _decide(jab)[0] == 8
    pb, pl = _decide(pab)
    assert pb == 128 and pl == ["Batch size 128 (memory model, HBM budget 79.0 GB).\n"]


def test_default_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(pab.SWEEP_ENV, raising=False)
    assert pab.default_sweep_path().endswith("boinc_app_eah_brp_tpu_torch/build/TORCH_BATCHSWEEP.json")


def test_cpu_budget_is_unknown():
    assert pab.device_memory_budget("cpu") is None
    assert pab.model_batch(N, None) == 16


def test_sweep_writes_the_artifact_choose_batch_reads(tmp_path, monkeypatch):
    """``sweep`` at a tiny size on the CPU: one rung per batch, the
    artifact's schema, nsamples and best batch, read back by
    ``choose_batch`` (no card kind and no budget: model-gated)."""
    import numpy as np
    import torch

    from boinc_app_eah_brp_tpu_torch.models import search
    from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
    from fixtures import small_bank, synthetic_timeseries
    from torch_parity import DT

    monkeypatch.delenv("ERP_BATCH", raising=False)
    n = 4096
    bank = small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2)
    derived = DerivedParams.derive(n, DT * 1e6, SearchConfig(window=200))
    geom = search.SearchGeometry.from_derived(
        derived,
        max_slope=search.max_slope_for_bank(bank.P, bank.tau),
        lut_step=search.lut_step_for_bank(bank.P, derived.dt),
        lut_tiles=search.lut_tiles_for_bank(bank.P, bank.psi0, n, derived.dt),
    )
    ts = torch.from_numpy(synthetic_timeseries(n, f_signal=33.0).astype(np.float32))
    path = str(tmp_path / "sweep.json")
    art = pab.sweep(ts, bank.P, bank.tau, bank.psi0, geom, batches=(1, 2, 4), runs=1, path=path)
    assert art["schema"] == pab.SWEEP_SCHEMA and art["nsamples"] == geom.nsamples
    assert [r["batch"] for r in art["rungs"]] == [1, 2, 4]
    assert art["best_batch"] in (1, 2, 4) and art["device_kind"] is None
    monkeypatch.setenv(pab.SWEEP_ENV, path)
    lines = []
    assert pab.choose_batch(geom.nsamples, log=lines.append, device="cpu") == art["best_batch"]
    assert lines == [f"Batch size {art['best_batch']} (measured sweep).\n"]
