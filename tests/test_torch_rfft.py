"""PyTorch port, the search's real-to-complex transform
(``ops/spectrum.py``): the four-step split of ``csrc/rfft.cu``, its twiddle
tables and its plain version against numpy's float64 ``rfft``, the power
form's plain version (``search_power``), and the batch step's routing on
the CPU.  The kernel itself runs in
``tests/test_torch_rfft_emulated.py`` (on the host) and
``tests/test_torch_cuda.py`` (on the card).

Tolerance: max |dF| <= 1e-5 max |F|, the rule the kernel is held to
against cuFFT (float32 sums in another order than either transform's).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu_torch.models import search
from boinc_app_eah_brp_tpu_torch.ops import harmonic, kernels, spectrum
from boinc_app_eah_brp_tpu_torch.runtime import metrics


def r2c_input(T: int, nsamples: int, seed: int) -> np.ndarray:
    """Noise with a pulse train and a constant pad past four fifths, as
    kernel B writes a template's series."""
    x = np.random.default_rng(seed).normal(0.0, 1.0, (T, nsamples)).astype(np.float32)
    x[:, ::97] += 6.0
    x[:, 4 * nsamples // 5 :] = 0.25
    return x


def gap(F: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(F - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize(
    "nsamples,split",
    [
        (3 << 22, (2048, 3072)),  # the palfa geometry, M = 3 * 2^21
        (1 << 23, (2048, 2048)),
        (3 << 16, (32, 3072)),
        (1 << 16, (16, 2048)),
        (3 << 15, (16, 3072)),
        (10 << 10, None),  # M = 5 * 2^10
        (1 << 15, None),  # N1 = 8
        (3 << 23, None),  # N1 = 4096
        (9 << 16, None),  # M = 9 * 2^15
        ((3 << 16) + 2, None),
        ((3 << 16) + 1, None),
    ],
)
def test_r2c_split(nsamples, split):
    assert spectrum.r2c_split(nsamples) == split


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("M", [1 << 15, 3 << 14, 1 << 16, 3 << 15, 1 << 17, 3 << 17, 1 << 18])
def test_fourstep_plain_matches_numpy(M, T):
    """The plain version against numpy's float64 transform at M = 2^a 3^b,
    the whole spectrum of M + 1 bins."""
    x = r2c_input(T, 2 * M, M + T)
    F = spectrum.rfft_fourstep_plain(torch.from_numpy(x))
    assert F.dtype == torch.complex64 and F.shape == (T, M + 1)
    assert gap(F.numpy(), np.fft.rfft(x.astype(np.float64), axis=1)) <= 1e-5


@pytest.mark.parametrize("n1,n2", [(16, 2048), (32, 3072), (2048, 3072)])
def test_r2c_tables_are_rounded_once(n1, n2):
    """The FFTs' float tables are the float64 roots rounded once; the
    kernel's product of two double entries is the root of its exponent to
    within a few units of double precision, so its float32 rounding is the
    rounded root's."""
    tab = spectrum.r2c_tables(n1, n2)
    for name, L in (("tw1", n1), ("tw2", n2)):
        assert tab[name].dtype == np.complex64 and tab[name].shape == (L,)
        exact = np.exp(-2j * np.pi * np.arange(L) / L)
        assert np.array_equal(tab[name], exact.astype(np.complex64))
    two_m = 2 * n1 * n2
    assert tab["th"].shape == (two_m >> 11,) and tab["tl"].shape == (2048,)
    e = np.random.default_rng(n1).integers(0, two_m, 4096)
    prod = tab["th"][e >> 11] * tab["tl"][e & 2047]
    exact = np.exp(-2j * np.pi * (e / two_m))
    assert np.abs(prod - exact).max() < 1e-14


def test_rfft_r2c_on_the_cpu_is_the_plain_version():
    x = torch.from_numpy(r2c_input(2, 3 << 15, 3))
    assert torch.equal(spectrum.rfft_r2c(x), spectrum.rfft_fourstep_plain(x))


@pytest.mark.parametrize("nsamples", [3 << 15, 10 << 10])
def test_search_rfft_on_the_cpu_is_torchs_transform(nsamples):
    """On the CPU the batch step's transform is PyTorch's FFT, whatever
    the length: the kernel's plain version serves its tests only."""
    x = torch.from_numpy(r2c_input(2, nsamples, 4))
    assert torch.equal(spectrum.search_rfft(x), torch.fft.rfft(x))


def test_plain_version_refuses_a_length_without_a_split():
    with pytest.raises(ValueError, match="split"):
        spectrum.rfft_fourstep_plain(torch.zeros((1, 10 << 10)))


@pytest.mark.parametrize("read", [(3 << 14) + 1, 4880, 1])
def test_search_power_on_the_cpu_is_the_power_of_the_plain_version(read):
    """float32[T, read], the plain transform's power bin for bin (DC 0),
    with no kernel launched and nothing counted."""
    x = torch.from_numpy(r2c_input(2, 3 << 15, 6))
    launches = dict(kernels.launch_counts)
    p = spectrum.search_power(x, read=read)
    want = spectrum.power_from_rfft(spectrum.rfft_fourstep_plain(x), nsamples=3 << 15)[:, :read]
    assert p.dtype == torch.float32 and p.shape == (2, read)
    assert torch.equal(p, want) and (p[:, 0] == 0).all()
    assert kernels.launch_counts == launches


@pytest.mark.parametrize("read", [0, (3 << 14) + 2])
def test_search_power_refuses_a_read_outside_the_spectrum(read):
    with pytest.raises(ValueError, match="read"):
        spectrum.search_power(torch.zeros((1, 3 << 15)), read=read)


# read = 16W + 16 below M + 1 at both; the second folds 16 harmonics of
# bins near the top of what is read
@pytest.mark.parametrize("fund_hi,harm_hi", [(300, 4000), (2000, 32000)])
def test_cpu_step_folds_the_complex_spectrum_and_power_folds_to_the_same_sums(fund_hi, harm_hi):
    """On the CPU the step's fold input is the complex spectrum (PyTorch's
    FFT; no power pass counted), folded by C's complex entry; its power cut
    to the bins the fold reads, folded by C's float entry, gives the same
    sums bit for bit: the card's route differs only in where the power is
    formed."""
    nsamples = 3 << 15
    geom = SimpleNamespace(nsamples=nsamples, fund_hi=fund_hi, harm_hi=harm_hi)
    x = torch.from_numpy(r2c_input(2, nsamples, 7))
    assert metrics.configure(force=True)
    try:
        F = search.fold_input(x, geom)
        counters = metrics.snapshot()["counters"]
    finally:
        metrics.finish(0)
    assert F.is_complex() and torch.equal(F, torch.fft.rfft(x))
    assert counters.get("fft.r2c_power_batches", {}).get("value", 0) == 0
    read = harmonic.fold_read(nsamples // 2 + 1, harmonic.state_width(fund_hi))
    assert read < nsamples // 2 + 1
    ps = spectrum.power_from_rfft(F, nsamples=nsamples)[:, :read].contiguous()
    assert torch.equal(search.fold_batch(ps, geom), search.fold_batch(F, geom))
