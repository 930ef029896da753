"""PyTorch port, harmonic fold (kernel C, plain version on the CPU)
against the JAX package's Pallas fold in interpret mode and its XLA
``harmonic_sumspec``, on the same numpy spectra.

Tolerance: bitwise.  The fold is adds in one fixed order and maxima, the
same float32 operations on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu.ops import harmonic as jax_harmonic
from boinc_app_eah_brp_tpu.ops.pallas_sumspec import sumspec_pallas_batch
from boinc_app_eah_brp_tpu_torch.ops import harmonic as port


def _spectra(T, L, seed):
    """Power-like spectra: exponential noise with a few strong lines."""
    rng = np.random.default_rng(seed)
    ps = rng.exponential(1.0, size=(T, L)).astype(np.float32)
    ps[:, rng.integers(1, L, 12)] += np.float32(40.0)
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


def test_accumulation_order_is_the_reference():
    assert port._ACCUM_ORDER == jax_harmonic._ACCUM_ORDER
