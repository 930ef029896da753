"""Power-spectrum oracle (``demod_binary_fft_fftw.c:88-113``): ``rfft`` of
the resampled series, ``power[i] = norm * (re^2 + im^2)`` with the DC bin
forced to zero, ``norm = 1/nsamples`` (``demod_binary.c:1255``)."""

from __future__ import annotations

import numpy as np


def power_spectrum(resampled: np.ndarray, norm_factor: float) -> np.ndarray:
    """float32 power spectrum of length nsamples//2+1 with zeroed DC."""
    fft = np.fft.rfft(resampled.astype(np.float32))
    ps = (fft.real.astype(np.float32) ** 2 + fft.imag.astype(np.float32) ** 2) * np.float32(norm_factor)
    ps = ps.astype(np.float32)
    ps[0] = 0.0
    return ps
