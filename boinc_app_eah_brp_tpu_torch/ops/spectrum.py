"""Power spectrum: ``rfft`` + ``|X|^2 / nsamples`` with the DC bin zeroed
(``demod_binary_fft_fftw.c:88-113``), the native-FFT branch of the
reference package's ``ops/spectrum.py``.  The FFT is ``torch.fft`` (cuFFT
on the card); the reference package's TPU matmul-cascade FFT has no
counterpart here."""

from __future__ import annotations

import numpy as np
import torch


def power_spectrum(x: torch.Tensor, *, nsamples: int) -> torch.Tensor:
    """float32[..., nsamples//2 + 1] of the real series ``x[..., nsamples]``,
    DC bin zeroed per spectrum."""
    F = torch.fft.rfft(x)
    ps = (F.real * F.real + F.imag * F.imag) * float(np.float32(1.0 / nsamples))
    ps[..., 0] = 0.0
    return ps


def power_spectrum_split(
    even: torch.Tensor, odd: torch.Tensor, *, nsamples: int
) -> torch.Tensor:
    """:func:`power_spectrum` of the interleaved series given as its
    (even, odd) parity streams."""
    x = torch.stack([even, odd], dim=-1).reshape(*even.shape[:-1], -1)
    return power_spectrum(x, nsamples=nsamples)
