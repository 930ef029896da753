"""PyTorch port, harmonic fold (kernel C, plain version on the CPU)
against the JAX package's Pallas fold in interpret mode and its XLA
``harmonic_sumspec``, on the same numpy spectra; and the fold of complex
spectra (kernel C with the power epilogue) against the same folds fed the
power of those spectra.

Tolerance: bitwise.  The fold is adds in one fixed order and maxima, the
same float32 operations on both sides; the power is separate multiplies
and adds on both sides.  The one exception is stated at its test: the
JAX package's own epilogue, which XLA on the CPU may contract.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu.ops import harmonic as jax_harmonic
from boinc_app_eah_brp_tpu.ops.pallas_sumspec import sumspec_pallas_batch
from boinc_app_eah_brp_tpu.ops.spectrum import power_spectrum_split
from boinc_app_eah_brp_tpu_torch.ops import harmonic as port
from boinc_app_eah_brp_tpu_torch.ops.spectrum import power_from_rfft


def _spectra(T, L, seed):
    """Power-like spectra: exponential noise with a few strong lines."""
    rng = np.random.default_rng(seed)
    ps = rng.exponential(1.0, size=(T, L)).astype(np.float32)
    ps[:, rng.integers(1, L, 12)] += np.float32(40.0)
    ps[:, 0] = 0.0
    return ps


def _complex_spectra(T, L, seed):
    """rfft-like complex64 spectra: complex normal noise with a few
    strong lines."""
    rng = np.random.default_rng(seed)
    F = (rng.normal(size=(T, L)) + 1j * rng.normal(size=(T, L))).astype(np.complex64)
    F[:, rng.integers(1, L, 12)] *= np.complex64(8.0)
    return F


def _numpy_power(F, nsamples):
    """(re*re + im*im) / nsamples in numpy float32, one rounding per
    multiply and add, DC bin zeroed."""
    re, im = F.real.astype(np.float32), F.imag.astype(np.float32)
    ps = (re * re + im * im) * np.float32(1.0 / nsamples)
    ps[:, 0] = 0.0
    return ps


# (fft length, fund_hi, harm_hi): fund_hi and harm_hi off multiples of 16,
# harm_hi both below 16*fund_hi and against the spectrum's end
GEOMS = [(5001, 301, 4817), (4097, 250, 4000), (2049, 127, 2049 - 100)]


@pytest.mark.parametrize("L,fund_hi,harm_hi", GEOMS)
def test_fold_matches_pallas(L, fund_hi, harm_hi):
    ps = _spectra(3, L, seed=L)
    got = port.sumspec_batch(torch.from_numpy(ps), fund_hi=fund_hi, harm_hi=harm_hi)
    want = sumspec_pallas_batch(
        jnp.asarray(ps), window_2=50, fund_hi=fund_hi, harm_hi=harm_hi, interpret=True
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("L,fund_hi,harm_hi", GEOMS)
def test_fold_matches_xla_sumspec(L, fund_hi, harm_hi):
    ps = _spectra(2, L, seed=L + 1)
    got = port.sumspec_batch_plain(torch.from_numpy(ps), fund_hi=fund_hi, harm_hi=harm_hi)
    want = jax.vmap(
        lambda p: jax_harmonic.harmonic_sumspec(
            p, window_2=50, fund_hi=fund_hi, harm_hi=harm_hi, natural=False
        )
    )(jnp.asarray(ps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("L,fund_hi,harm_hi", GEOMS)
def test_spectrum_fold_plain_is_power_then_fold(L, fund_hi, harm_hi):
    F = torch.from_numpy(_complex_spectra(3, L, seed=L + 2))
    n = 2 * (L - 1)
    want = port.sumspec_batch_plain(power_from_rfft(F, nsamples=n), fund_hi=fund_hi, harm_hi=harm_hi)
    plain = port.sumspec_spectrum_plain(F, nsamples=n, fund_hi=fund_hi, harm_hi=harm_hi)
    got = port.sumspec_spectrum(F, nsamples=n, fund_hi=fund_hi, harm_hi=harm_hi)
    assert torch.equal(plain, want) and torch.equal(got, want)


@pytest.mark.parametrize("L,fund_hi,harm_hi", GEOMS)
def test_spectrum_fold_matches_pallas(L, fund_hi, harm_hi):
    F = _complex_spectra(3, L, seed=L + 3)
    n = 2 * (L - 1)
    got = port.sumspec_spectrum(torch.from_numpy(F), nsamples=n, fund_hi=fund_hi, harm_hi=harm_hi)
    want = sumspec_pallas_batch(
        jnp.asarray(_numpy_power(F, n)), window_2=50, fund_hi=fund_hi, harm_hi=harm_hi,
        interpret=True,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("L,fund_hi,harm_hi", GEOMS)
def test_spectrum_fold_matches_jax_epilogue(L, fund_hi, harm_hi):
    """The JAX package's whole spectrum stage (rfft + epilogue) and Pallas
    fold on a real series, against the port's fold of the same rfft
    output.  Within rtol 2e-6, not bitwise: XLA on the CPU may contract
    ``re**2 + im**2`` into a multiply-add (one rounding fewer per bin, see
    ROADMAP Queue 3), and the summed levels carry that difference of up to
    an ulp or so per term."""
    n = 2 * (L - 1)
    x = np.fft.irfft(_complex_spectra(2, L, seed=L + 4), n=n).astype(np.float32)
    F = np.asarray(jax.jit(jnp.fft.rfft)(jnp.asarray(x))).astype(np.complex64)
    got = port.sumspec_spectrum(torch.from_numpy(F), nsamples=n, fund_hi=fund_hi, harm_hi=harm_hi)
    ps = power_spectrum_split(jnp.asarray(x[:, 0::2]), jnp.asarray(x[:, 1::2]), nsamples=n)
    want = sumspec_pallas_batch(ps, window_2=50, fund_hi=fund_hi, harm_hi=harm_hi, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=0)


@pytest.mark.parametrize("fund_hi", [1, 15, 16, 301, 329551])
def test_layout_helpers_match(fund_hi):
    assert port.level_layout(fund_hi) == jax_harmonic.level_layout(fund_hi)
    assert port.state_width(fund_hi) == jax_harmonic.state_width(fund_hi)
    rng = np.random.default_rng(fund_hi)
    nat = rng.random((5, fund_hi)).astype(np.float32)
    pm = port.from_natural_order(nat, fund_hi)
    np.testing.assert_array_equal(pm, jax_harmonic.from_natural_order(nat, fund_hi))
    np.testing.assert_array_equal(port.to_natural_order(pm, fund_hi), nat)
    np.testing.assert_array_equal(
        port.to_natural_order(pm, fund_hi), jax_harmonic.to_natural_order(pm, fund_hi)
    )


def _smem_wavefronts(skew):
    """Shared-memory wavefronts of kernel C's reads over one tile, summed
    over the 8 sector shifts of a range: per warp and distinct offset
    ``c`` of multiplier ``l``, lane j reads word ``skew(l*(32w + j) + c + d)``
    of its slot (csrc/fold.cu ``add_terms``)."""
    total = worst = 0
    for d in range(8):
        for l in range(1, 17):
            for c in {(l * r + 8) >> 4 for r in range(16)}:
                for w in range(8):
                    banks = {}
                    for j in range(32):
                        word = skew(l * (32 * w + j) + c + d)
                        banks.setdefault(word % 32, set()).add(word)
                    n = max(len(v) for v in banks.values())
                    total, worst = total + n, max(worst, n)
    return total / 8, worst


def test_fold_smem_skew_halves_bank_conflicts():
    """Kernel C's slot layout (one pad word per 32) against the unskewed
    one: at most 2-way conflicts, 1.9x the conflict-free wavefronts instead
    of 3.7x."""
    skewed, worst = _smem_wavefronts(lambda e: e + (e >> 5))
    plain, plain_worst = _smem_wavefronts(lambda e: e)
    ideal = 8 * sum(len({(l * r + 8) >> 4 for r in range(16)}) for l in range(1, 17))
    assert (worst, plain_worst) == (2, 16)
    assert round(skewed / ideal, 1) == 1.9 and round(plain / ideal, 1) == 3.7


def test_accumulation_order_is_the_reference():
    assert port._ACCUM_ORDER == jax_harmonic._ACCUM_ORDER
