"""PyTorch port, the host oracle and its rescoring against the JAX
package's.  Both are numpy on the same inputs, so every comparison is
bitwise."""

import importlib

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu_torch.io import empty_candidates
from boinc_app_eah_brp_tpu_torch.models import search
from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
from boinc_app_eah_brp_tpu_torch.oracle import harmonic, rescore, resample, spectrum
from boinc_app_eah_brp_tpu_torch.oracle.stats import base_thresholds
from boinc_app_eah_brp_tpu_torch.oracle.toplist import finalize_candidates, update_toplist_from_maxima
from fixtures import small_bank, synthetic_timeseries
from torch_parity import DT

# the JAX package's oracle/__init__ re-exports functions named like its
# modules, so the modules are fetched by name
jax_harmonic, jax_rescore, jax_resample, jax_spectrum = (
    importlib.import_module(f"boinc_app_eah_brp_tpu.oracle.{m}") for m in ("harmonic", "rescore", "resample", "spectrum")
)
N = 4096


@pytest.fixture(scope="module")
def toplist():
    """A series, its geometry and the toplist of a CPU search of a small
    bank over it (the injected orbit and its neighbours)."""
    ts = synthetic_timeseries(N, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0).astype(np.float32)
    cfg = SearchConfig(window=200, padding=1.5)
    d = DerivedParams.derive(N, DT * 1e6, cfg)
    b = small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2)
    P, tau, psi0 = b.P, b.tau, search.normalize_psi0(b.psi0)
    geom = search.SearchGeometry.from_derived(
        d,
        max_slope=search.max_slope_for_bank(P, tau),
        lut_step=search.lut_step_for_bank(P, DT),
        lut_tiles=search.lut_tiles_for_bank(P, psi0, N, DT),
        exact_mean=True,
    )
    M, T = search.run_bank(torch.from_numpy(ts), P, tau, psi0, geom, batch_size=2)
    cands = update_toplist_from_maxima(
        empty_candidates(),
        search.state_to_natural(M, geom),
        search.state_to_natural(T, geom),
        P.astype(np.float32), tau.astype(np.float32), psi0.astype(np.float32),
        base_thresholds(cfg.fA, d.fft_size), geom.window_2,
    )
    emitted = finalize_candidates(cands, d.t_obs)
    assert len(emitted) > 10
    return ts, d, cands, emitted


@pytest.mark.parametrize("tpl", [(2.2, 0.04, 1.2), (1.7, 0.09, 5.9), (1000.0, 0.0, 0.0)])
def test_oracle_copies_match(toplist, tpl):
    ts, d, _, _ = toplist
    args = (*tpl, d.dt, d.nsamples, d.n_unpadded)
    out, n_steps, mean = resample.resample(ts, resample.ResampleParams.from_template(*args))
    j_out, j_n, j_mean = jax_resample.resample(ts, jax_resample.ResampleParams.from_template(*args))
    assert n_steps == j_n and mean.tobytes() == j_mean.tobytes()
    assert out.tobytes() == j_out.tobytes()
    ps = spectrum.power_spectrum(out, 1.0 / d.nsamples)
    assert ps.tobytes() == jax_spectrum.power_spectrum(out, 1.0 / d.nsamples).tobytes()
    geo = (d.window_2, d.fundamental_idx_hi, d.harmonic_idx_hi)
    for k in range(5):
        for j in (0, d.window_2 // 16, 97, d.fundamental_idx_hi - 1, d.fundamental_idx_hi):
            assert harmonic.harmonic_power_at(ps, j, k, *geo) == jax_harmonic.harmonic_power_at(ps, j, k, *geo)


def test_rescore_winners_matches_jax(toplist):
    ts, d, cands, emitted = toplist
    got, n_got = rescore.rescore_winners(ts, cands, emitted, d)
    want, n_want = jax_rescore.rescore_winners(ts, cands, emitted, d)
    assert n_got == n_want == rescore.unique_winner_count(emitted) == jax_rescore.unique_winner_count(emitted)
    assert got.tobytes() == want.tobytes()
    assert not np.array_equal(got["power"], cands["power"])  # the device powers were replaced


def test_incremental_cache_gives_the_cold_rescore(toplist):
    ts, d, cands, emitted = toplist
    cold, _ = rescore.rescore_winners(ts, cands, emitted, d)
    r = rescore.IncrementalRescorer(lambda: ts, d, d.t_obs, max_workers=2)
    r.observe_async(lambda: cands.copy())
    r.observe_async(lambda: cands)  # the same winners again: nothing new to submit
    cache = r.finalize()
    assert r.observed == 2 and r.failed == 0 and r.series_if_fetched() is not None
    warm, n_eval = rescore.rescore_winners(ts, cands, emitted, d, cache=cache)
    assert n_eval == 0
    assert warm.tobytes() == cold.tobytes()
    r.abort()  # safe after finalize
