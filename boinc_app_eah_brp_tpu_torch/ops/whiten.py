"""Whitening + RFI zapping (``demod_binary.c:856-1079``), along the
native-FFT branch of the reference package's ``ops/whiten.py``.

The FFTs run on the device (cuFFT through ``torch.fft``); the sliding
median and the zap-noise stream (a serial taus2 RNG) stay on the host, as
in the reference.  The median is the native ``rngmed`` alone: the
reference package's blocked-sort device median is not ported, so
``ERP_MEDIAN=device`` is refused with ``RADPUL_EVAL``
(:func:`check_median`), as is a native library that does not load.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..oracle.pipeline import DerivedParams, SearchConfig
from ..oracle.whiten import seed_from_samples, zap_noise
from .kernels import planned_fft
from .native_median import load, running_median


def check_median() -> None:
    """Honour ``ERP_MEDIAN`` before any whitening work: ``device`` (the
    reference package's blocked-sort median, which can differ by an ulp
    on even windows) raises ``RadpulError(RADPUL_EVAL)``, since the port
    has only the native median.  Any other value loads the native median
    now, whose load failure is ``RADPUL_EVAL`` too
    (``ops/native_median.py``)."""
    if os.environ.get("ERP_MEDIAN", "") == "device":
        from ..runtime.errors import RADPUL_EVAL, RadpulError

        raise RadpulError(
            RADPUL_EVAL,
            "ERP_MEDIAN=device requested but the device running median is not part of the PyTorch port "
            "(its median is the native rngmed); unset ERP_MEDIAN or set it to native",
        )
    load()


def whiten_and_zap(
    samples: np.ndarray,  # float32[n_unpadded]
    derived: DerivedParams,
    cfg: SearchConfig,
    zap_ranges: np.ndarray,  # float64[nz, 2] (fmin, fmax) Hz
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The whitened, zapped series float32[n_unpadded] on ``device``:
    rfft of the zero-padded series, power with DC 0, host running median,
    ``sqrt(ln 2 / median)`` scale, zap-noise scatter, edge bins zeroed,
    ``irfft * sqrt(nsamples)``.  ``ERP_MEDIAN`` is checked first
    (:func:`check_median`)."""
    check_median()
    dev = resolve_device(device)
    n_unpadded = derived.n_unpadded
    nsamples = derived.nsamples
    fft_size = derived.fft_size
    window = cfg.window
    window_2 = int(0.5 * window + 0.5)
    if fft_size < window:
        raise ValueError(
            f"Running median window ({window} bins) is too wide for data set ({fft_size} bins)!"
        )
    samples = np.asarray(samples, dtype=np.float32)
    seed = seed_from_samples(samples)

    padded = torch.zeros(nsamples, dtype=torch.float32, device=dev)
    padded[:n_unpadded] = torch.from_numpy(samples).to(dev)
    F = _forward(padded)
    re, im = F.real, F.imag

    ps = re * re + im * im
    ps[0] = 0.0
    rm = running_median(ps.cpu().numpy(), window)

    white_size = fft_size - window + 1
    # tensor / tensor: a Python scalar numerator would go through
    # reciprocal-then-multiply, which rounds differently
    ln2 = torch.tensor(np.float32(np.log(2.0)), device=dev)
    factor = torch.sqrt(ln2 / torch.from_numpy(rm).to(dev))
    scale = torch.ones(fft_size, dtype=torch.float32, device=dev)
    scale[window_2 : window_2 + white_size] = factor
    re = re * scale
    im = im * scale

    bin_ranges = (np.asarray(zap_ranges) * derived.t_obs + 0.5).astype(np.uint32)
    sigma = float(np.sqrt(0.5) * np.sqrt(cfg.padding))
    idx, vals = zap_noise(seed, bin_ranges, sigma, fft_size)
    if len(idx):
        idx_d = torch.from_numpy(idx).to(dev)
        re[idx_d] = torch.from_numpy(np.real(vals).astype(np.float32)).to(dev)
        im[idx_d] = torch.from_numpy(np.imag(vals).astype(np.float32)).to(dev)

    re[:window_2] = 0.0
    re[fft_size - window_2 :] = 0.0
    im[:window_2] = 0.0
    im[fft_size - window_2 :] = 0.0

    back = _inverse(re, im, nsamples)
    back = back * float(np.sqrt(np.float32(nsamples)))
    return back[:n_unpadded].contiguous()


def _forward(padded: torch.Tensor) -> torch.Tensor:
    return planned_fft(torch.fft.rfft, padded)


def _inverse(re: torch.Tensor, im: torch.Tensor, nsamples: int) -> torch.Tensor:
    return planned_fft(torch.fft.irfft, torch.complex(re, im), n=nsamples)


def warm(nsamples: int, device: str | torch.device = "cuda") -> None:
    """Make what :func:`whiten_and_zap` of a series padded to ``nsamples``
    needs before its first workunit: its two transforms' cuFFT plans, on
    zeros, and the host median's library."""
    dev = resolve_device(device)
    F = _forward(torch.zeros(nsamples, dtype=torch.float32, device=dev))
    _inverse(F.real, F.imag, nsamples)
    running_median(np.zeros(3, dtype=np.float32), 3)
