"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, at small shapes with ragged edges.
Skips without a CUDA card; run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest.py imports jax, which the card's
machine need not have).

Tolerance: bitwise (kernel and plain version run the same float32
operations; the fold's adds are in one fixed order).
"""

import os

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu_torch.models import search
from boinc_app_eah_brp_tpu_torch.ops import harmonic, kernels, resample

pytestmark = pytest.mark.cuda

BANK200 = os.path.join(os.path.dirname(__file__), "golden", "bank200.txt")
DT = 65.476e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _params(rows, dev):
    b = np.loadtxt(BANK200)[rows]
    return resample.stream_params(*search.bank_params_host(b[:, 0], b[:, 1], b[:, 2], DT), device=dev)


@pytest.mark.parametrize("n,renorm", [(1 << 16, None), (70002, 3.25)])
def test_resample_and_fftprep_match_plain(dev, n, renorm):
    ts = torch.from_numpy(np.random.default_rng(n).normal(0, 1, n).astype(np.float32)).to(dev)
    ev, od = ts[0::2].contiguous(), ts[1::2].contiguous()
    params = _params([0, 5, 17, 57, 199], dev)
    before = kernels.launch_counts["resample"]
    raw, lf = resample.resample_stream(ev, od, params, n_unpadded=n, dt=DT, renorm=renorm)
    assert kernels.launch_counts["resample"] == before + 1
    raw_p, lf_p = resample.resample_stream_plain(ev, od, params, n_unpadded=n, dt=DT, renorm=renorm)
    assert torch.equal(raw, raw_p) and torch.equal(lf, lf_p)
    n_steps, mean = resample.batch_stats(raw, lf, n_unpadded=n)
    nsamples = 3 * n
    x = resample.fftprep(raw, n_steps, mean, nsamples=nsamples)
    assert torch.equal(x, resample.fftprep_plain(raw, n_steps, mean, nsamples=nsamples))


@pytest.mark.parametrize("L,fund_hi,harm_hi", [(98305, 5149, 82388), (5001, 301, 4817)])
def test_fold_matches_plain(dev, L, fund_hi, harm_hi):
    g = torch.Generator(device="cpu").manual_seed(L)
    ps = torch.empty((3, L)).exponential_(generator=g).to(dev)
    got = harmonic.sumspec_batch(ps, fund_hi=fund_hi, harm_hi=harm_hi)
    assert torch.equal(got, harmonic.sumspec_batch_plain(ps, fund_hi=fund_hi, harm_hi=harm_hi))


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize(
    "L,fund_hi,harm_hi",
    # the last geometry's fold reads past the spectrum: 16W + 16 = 2064 > L
    [(98305, 5149, 82388), (5001, 301, 4817), (2049, 127, 1949)],
)
def test_fold_spectrum_matches_plain(dev, T, L, fund_hi, harm_hi):
    rng = np.random.default_rng(L + T)
    F = (rng.normal(size=(T, L)) + 1j * rng.normal(size=(T, L))).astype(np.complex64)
    F = torch.from_numpy(F).to(dev)
    n = 2 * (L - 1)
    before = kernels.launch_counts["fold_spectrum"]
    got = harmonic.sumspec_spectrum(F, nsamples=n, fund_hi=fund_hi, harm_hi=harm_hi)
    assert kernels.launch_counts["fold_spectrum"] == before + 1
    want = harmonic.sumspec_spectrum_plain(F, nsamples=n, fund_hi=fund_hi, harm_hi=harm_hi)
    assert torch.equal(got, want)


def test_bank_step_card_matches_cpu(dev):
    """One search batch on the card against the same batch on the CPU:
    spectra from cuFFT and PyTorch's CPU FFT, so M to rtol 1e-4."""
    n = 1 << 16
    b = np.loadtxt(BANK200)[:6]
    P, tau, psi0 = b[:, 0], b[:, 1], b[:, 2]
    from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig

    d = DerivedParams.derive(n, DT * 1e6, SearchConfig(padding=3.0, f0=400.0, window=1000))
    geom = search.SearchGeometry.from_derived(
        d,
        max_slope=search.max_slope_for_bank(P, tau),
        lut_step=search.lut_step_for_bank(P, DT),
        lut_tiles=search.lut_tiles_for_bank(P, psi0, n, DT),
    )
    ts = np.random.default_rng(1).normal(0, 1, n).astype(np.float32)
    out = {}
    for device in ("cpu", dev):
        M, T = search.run_bank(torch.from_numpy(ts).to(device), P, tau, psi0, geom, batch_size=4)
        out[str(device)] = (M.cpu().numpy(), T.cpu().numpy())
    (Mc, Tc), (Mg, Tg) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(Mg, Mc, rtol=1e-4, atol=1e-6)
    assert (Tg == Tc).mean() > 0.99
