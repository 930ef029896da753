"""Power spectrum: ``rfft`` + ``|X|^2 / nsamples`` with the DC bin zeroed
(``demod_binary_fft_fftw.c:88-113``), the native-FFT branch of the
reference package's ``ops/spectrum.py``.  The FFT is ``torch.fft`` (cuFFT
on the card); the reference package's TPU matmul-cascade FFT has no
counterpart here."""

from __future__ import annotations

import numpy as np
import torch

from .kernels import planned_fft


def power_from_rfft(F: torch.Tensor, *, nsamples: int) -> torch.Tensor:
    """``(re*re + im*im) * float32(1/nsamples)`` of the complex spectra
    ``F[..., L]``, each multiply and add rounded on its own, DC bin zeroed
    per spectrum: the plain version of the power epilogue that kernel C
    forms from the complex spectrum (``ops/harmonic.py::sumspec_spectrum``)."""
    ps = (F.real * F.real + F.imag * F.imag) * float(np.float32(1.0 / nsamples))
    ps[..., 0] = 0.0
    return ps


def power_spectrum(x: torch.Tensor, *, nsamples: int) -> torch.Tensor:
    """float32[..., nsamples//2 + 1] of the real series ``x[..., nsamples]``,
    DC bin zeroed per spectrum."""
    return power_from_rfft(planned_fft(torch.fft.rfft, x), nsamples=nsamples)

