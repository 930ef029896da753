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


def _edge_rows(n, dev):
    """Null templates (tau 0) whose integer S0 = K puts n_steps = n-2-K just
    below, on and just above the start of a unit, in both parities (so the
    cut crosses a unit, or falls on its edge)."""
    e = 2 * (n // 2 // resample.UNIT // 2) * resample.UNIT
    K = np.array([n - 2 - c for c in (e - 2, e - 1, e, e + 1, e + 2)], dtype=np.float32)
    return resample.stream_params(np.zeros(5), np.ones(5), np.zeros(5), K, device=dev)


def _off_table_rows(dev):
    """Templates whose LUT argument leaves [0, 2^23): a negative phase at
    the start, and a phase past 2^23 / 64 LUT periods at the end (the
    kernel's conversion path)."""
    return resample.stream_params([0.2, 0.1], [1e-3, 3e5], [-3.0, 0.5], [0.0, 0.0], device=dev)


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("renorm", [None, 3.25])
# past 2^23 samples the kernel takes its wide path (conversions, no 2^23
# add); past 2^24 the interleaved index is no longer exact in float32 and
# both sides round it the same way
@pytest.mark.parametrize("n", [1 << 16, 70002, (1 << 23) + 2, (1 << 24) + 6])
def test_resample_and_fftprep_match_plain(dev, n, renorm, T):
    """Kernel A's raw, n_steps and mean bitwise against the plain version,
    for bank templates (whose cut lies inside a unit), for cuts placed
    around a unit edge and for LUT arguments outside [0, 2^23); then
    kernel B on its outputs."""
    ts = torch.from_numpy(np.random.default_rng(n).normal(0, 1, n).astype(np.float32)).to(dev)
    rows = [_params([0, 5, 17, 57, 199], dev), _edge_rows(n, dev), _off_table_rows(dev)]
    for params in rows:
        params = params[:T].contiguous()
        key = "resample_t1" if T == 1 else "resample"
        before = kernels.launch_counts[key]
        raw, n_steps, mean = resample.resample_stream(ts, params, n_unpadded=n, dt=DT, renorm=renorm)
        assert kernels.launch_counts[key] == before + 1
        raw_p, n_steps_p, mean_p = resample.resample_stream_plain(ts, params, n_unpadded=n, dt=DT, renorm=renorm)
        assert torch.equal(raw, raw_p)
        assert torch.equal(n_steps, n_steps_p)
        assert torch.equal(mean, mean_p)
        nsamples = 3 * n
        x = resample.fftprep(raw, n_steps, mean, nsamples=nsamples)
        assert torch.equal(x, resample.fftprep_plain(raw, n_steps, mean, nsamples=nsamples))


@pytest.mark.parametrize("T", [1, 32, 33])
@pytest.mark.parametrize("n", [1 << 16, 70002])
def test_serial_mean_matches_plain(dev, n, T):
    """The serial-mean kernel over kernel A's outputs of an unwhitened
    (positive) series, bitwise against the host float32 chain."""
    ts = torch.from_numpy(np.random.default_rng(n + T).normal(5.0, 1.0, n).astype(np.float32)).to(dev)
    raw, n_steps, _ = resample.resample_stream(ts, _params(list(range(T)), dev), n_unpadded=n, dt=DT)
    before = kernels.launch_counts["serial_mean"]
    got = resample.serial_mean(raw, n_steps)
    assert kernels.launch_counts["serial_mean"] == before + 1
    assert torch.equal(got.view(torch.int32), resample.serial_mean_plain(raw, n_steps).view(torch.int32))


def test_serial_mean_edges_match_plain(dev):
    """Counts around the kernel's 4096-sample chunks, odd counts, one
    sample, n_steps <= 0 and a count past the samples."""
    half = 5001
    n_steps = [4095, 4096, 4097, 8193, 7, 1, 0, -1, 2 * half - 1, 2 * half + 5]
    raw = torch.from_numpy(
        np.random.default_rng(half).normal(5.0, 1.0, (len(n_steps), 2, half)).astype(np.float32)
    ).to(dev)
    ns = torch.tensor(n_steps, dtype=torch.int32, device=dev)
    got = resample.serial_mean(raw, ns)
    assert torch.equal(got.view(torch.int32), resample.serial_mean_plain(raw, ns).view(torch.int32))


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
