"""PyTorch port, whitening on the CPU against the JAX package's.

Tolerances: the zap-noise stream and the native running median are
bitwise (the same host code on the same input).  The whitened series
passes through two FFT libraries (PyTorch's and XLA's), whose float32
rounding differs by a few ulps per bin: it is held to an absolute error of
1e-4 of the series' RMS (the largest seen is ~2e-6).
"""

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu.ops.whiten import whiten_and_zap as jax_whiten
from boinc_app_eah_brp_tpu.oracle.median import running_median as oracle_median
from boinc_app_eah_brp_tpu.oracle.pipeline import DerivedParams as JaxDerived
from boinc_app_eah_brp_tpu.oracle.pipeline import SearchConfig as JaxConfig
from boinc_app_eah_brp_tpu.oracle.whiten import seed_from_samples as jax_seed
from boinc_app_eah_brp_tpu.oracle.whiten import zap_noise as jax_zap_noise
from boinc_app_eah_brp_tpu_torch.ops.native_median import running_median
from boinc_app_eah_brp_tpu_torch.ops.whiten import whiten_and_zap
from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
from boinc_app_eah_brp_tpu_torch.oracle.whiten import seed_from_samples, zap_noise
from fixtures import synthetic_timeseries

WHITEN_RMS_TOL = 1e-4
ZAPS = np.array([[50.0, 51.5], [120.0, 120.2], [300.0, 310.0]])


def test_zap_noise_bitwise():
    ts = synthetic_timeseries(4096, seed=3)
    seed = seed_from_samples(ts)
    assert seed == jax_seed(ts)
    ranges = (ZAPS * 6.0 + 0.5).astype(np.uint32)
    idx, vals = zap_noise(seed, ranges, 1.2, 2049)
    w_idx, w_vals = jax_zap_noise(seed, ranges, 1.2, 2049)
    np.testing.assert_array_equal(idx, w_idx)
    np.testing.assert_array_equal(vals.view(np.float32), w_vals.view(np.float32))


@pytest.mark.parametrize("window", [200, 201])
def test_native_median_bitwise(window):
    x = np.random.default_rng(window).exponential(1.0, 20000).astype(np.float32)
    np.testing.assert_array_equal(running_median(x, window), oracle_median(x, window))


@pytest.mark.parametrize("padding", [1.0, 3.0])
def test_whiten_matches_jax(padding):
    n = 4096
    ts = synthetic_timeseries(n, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    kw = dict(padding=padding, window=200, white=True)
    derived = DerivedParams.derive(n, 500.0, SearchConfig(**kw))
    got = whiten_and_zap(ts, derived, SearchConfig(**kw), ZAPS, device="cpu")
    want = jax_whiten(ts, JaxDerived.derive(n, 500.0, JaxConfig(**kw)), JaxConfig(**kw), ZAPS)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    assert float(np.max(np.abs(got.numpy() - want))) <= WHITEN_RMS_TOL * rms


def test_whiten_defaults_to_cuda(monkeypatch):
    """The entry point runs on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ts = synthetic_timeseries(1024)
    cfg = SearchConfig(window=100, white=True)
    derived = DerivedParams.derive(1024, 500.0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        whiten_and_zap(ts, derived, cfg, ZAPS)
