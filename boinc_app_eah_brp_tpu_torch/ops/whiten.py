"""Whitening + RFI zapping (``demod_binary.c:856-1079``), along the
native-FFT branch of the reference package's ``ops/whiten.py``.

The FFTs run on the device (cuFFT through ``torch.fft``); the zap-noise
stream (a serial taus2 RNG) stays on the host, as in the reference.  The
sliding median is the native ``rngmed`` on the host, or the device median
(``ops/median.py``) where ``ERP_MEDIAN=device`` asks for it or the native
library does not load, as in the reference package (:func:`check_median`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..oracle.pipeline import DerivedParams, SearchConfig
from ..oracle.whiten import seed_from_samples, zap_noise
from ..runtime import logging as erplog
from . import native_median
from .kernels import planned_fft
from .median import running_median


def check_median() -> str:
    """The running median the whitening takes, resolved before any
    whitening work, as the reference package resolves it: ``"native"``
    (the host ``rngmed``) where its library loads and ``ERP_MEDIAN`` is
    not ``device``, else ``"device"`` (``ops/median.py``).  The value is
    compared as given.  ``ERP_MEDIAN=native`` with a library that does not
    load raises ``RadpulError(RADPUL_EVAL)``: an explicit request never
    degrades.  Logs the choice."""
    requested = os.environ.get("ERP_MEDIAN", "")
    if requested == "native":
        native_median.load()  # raises RADPUL_EVAL when it does not load
    path = "native" if requested != "device" and native_median.available() else "device"
    erplog.info("Running median path: %s\n", "native C++" if path == "native" else "device")
    return path


def whiten_and_zap(
    samples: np.ndarray,  # float32[n_unpadded]
    derived: DerivedParams,
    cfg: SearchConfig,
    zap_ranges: np.ndarray,  # float64[nz, 2] (fmin, fmax) Hz
    median_block: int = 4096,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """The whitened, zapped series float32[n_unpadded] on ``device``:
    rfft of the zero-padded series, power with DC 0, running median (the
    path :func:`check_median` resolves first; the device median on a CPU
    tensor runs its plain version ``median_block`` outputs at a time),
    ``sqrt(ln 2 / median)`` scale, zap-noise scatter, edge bins zeroed,
    ``irfft * sqrt(nsamples)``."""
    path = check_median()
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
    if path == "native":
        rm = torch.from_numpy(native_median.running_median(ps.cpu().numpy(), window)).to(dev)
    else:
        rm = running_median(ps, bsize=window, block=median_block)

    white_size = fft_size - window + 1
    # tensor / tensor: a Python scalar numerator would go through
    # reciprocal-then-multiply, which rounds differently
    ln2 = torch.tensor(np.float32(np.log(2.0)), device=dev)
    factor = torch.sqrt(ln2 / rm)
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
    zeros, and the median of the path it will take (:func:`check_median`):
    the host median's library, or the device median's kernel."""
    dev = resolve_device(device)
    F = _forward(torch.zeros(nsamples, dtype=torch.float32, device=dev))
    _inverse(F.real, F.imag, nsamples)
    if check_median() == "native":
        native_median.running_median(np.zeros(3, dtype=np.float32), 3)
    else:
        running_median(torch.zeros(3, dtype=torch.float32, device=dev), bsize=3)
