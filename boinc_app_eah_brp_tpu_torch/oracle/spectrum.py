"""Power-spectrum oracle (``demod_binary_fft_fftw.c:88-113``): ``rfft`` of
the resampled series, ``power[i] = norm * (re^2 + im^2)`` with the DC bin
forced to zero, ``norm = 1/nsamples`` (``demod_binary.c:1255``).

:func:`power_at` takes the same ``rfft`` and the same float32 epilogue at
the requested bins only, elementwise the values :func:`power_spectrum`
has there: the rescoring reads a few thousand of its millions of bins.
:func:`power_at_on_device` gives the same values from a torch series on
its device.

numpy's ``rfft`` of a float32 series (numpy 2.0 and 2.3 alike) is the
float64 transform rounded once to complex64, so the device takes the
transform in float64 too: a float32 transform would move nearly every
power."""

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


def power_at_on_device(resampled, bins: np.ndarray, norm_factor: float) -> np.ndarray:
    """:func:`power_at` of the float32 torch series ``resampled``, taken on
    its device: one float64 ``torch.fft.rfft`` (cuFFT on a card), the bins
    gathered and rounded to complex64 there, the float32 epilogue there,
    and only the powers at ``bins`` copied to the host."""
    import torch

    from ..ops.kernels import planned_fft

    F = planned_fft(torch.fft.rfft, resampled.double())
    at = F[torch.from_numpy(bins).to(F.device)].to(torch.complex64)
    p = (at.real * at.real + at.imag * at.imag) * float(np.float32(norm_factor))
    ps = np.zeros(F.shape[0], dtype=np.float32)
    ps[bins] = p.cpu().numpy()
    ps[0] = 0.0
    return ps
