"""Power-spectrum oracle (``demod_binary_fft_fftw.c:88-113``): ``rfft`` of
the resampled series, ``power[i] = norm * (re^2 + im^2)`` with the DC bin
forced to zero, ``norm = 1/nsamples`` (``demod_binary.c:1255``).

:func:`power_at` takes the same ``rfft`` and the same float32 epilogue at
the requested bins only, elementwise the values :func:`power_spectrum`
has there: the rescoring reads a few thousand of its millions of bins."""

from __future__ import annotations

import numpy as np


def power_spectrum(resampled: np.ndarray, norm_factor: float) -> np.ndarray:
    """float32 power spectrum of length nsamples//2+1 with zeroed DC."""
    fft = np.fft.rfft(resampled.astype(np.float32))
    ps = (fft.real.astype(np.float32) ** 2 + fft.imag.astype(np.float32) ** 2) * np.float32(norm_factor)
    ps = ps.astype(np.float32)
    ps[0] = 0.0
    return ps


def power_at(resampled: np.ndarray, bins: np.ndarray, norm_factor: float) -> np.ndarray:
    """float32 spectrum of length nsamples//2+1 holding :func:`power_spectrum`'s
    values at ``bins`` (DC zero) and 0 at every other bin."""
    fft = np.fft.rfft(np.asarray(resampled, dtype=np.float32))
    at = fft[bins]
    ps = np.zeros(len(fft), dtype=np.float32)
    ps[bins] = (at.real.astype(np.float32) ** 2 + at.imag.astype(np.float32) ** 2) * np.float32(norm_factor)
    ps[0] = 0.0
    return ps
