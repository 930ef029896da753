"""Whitening + RFI zapping (``demod_binary.c:856-1079``), along the
native-FFT branch of the reference package's ``ops/whiten.py``.

The FFTs run on the device (cuFFT through ``torch.fft``); the zap-noise
stream (a serial taus2 RNG) stays on the host, as in the reference.  The
sliding median follows the device of the series (:func:`check_median`): on
a card the device median (``ops/median.py``, the kernel ``csrc/median.cu``)
runs on the spectrum where it is, so the spectrum never leaves the card; on
the CPU it is the native ``rngmed``, or the device median's plain version
where the native library does not load, as in the reference package.
``ERP_MEDIAN`` picks either path on either device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..oracle.pipeline import DerivedParams, SearchConfig
from ..oracle.whiten import seed_from_samples, zap_noise
from ..runtime import logging as erplog
from ..runtime import metrics
from . import native_median
from .kernels import planned_fft
from .median import running_median


def default_median(device: str | torch.device) -> str:
    """The running median a whitening on ``device`` takes when
    ``ERP_MEDIAN`` names neither path: ``"device"`` (``ops/median.py``)
    on a CUDA device, where the spectrum already is; on the CPU
    ``"native"`` (the host ``rngmed``) where its library loads, else
    ``"device"``, as the reference package resolves it."""
    if torch.device(device).type == "cuda":
        return "device"
    return "native" if native_median.available() else "device"


def check_median(device: str | torch.device = "cpu") -> str:
    """The running median a whitening on ``device`` takes, resolved before
    any whitening work: ``"native"`` (the host ``rngmed``) or ``"device"``
    (``ops/median.py``).  ``ERP_MEDIAN=native`` and ``ERP_MEDIAN=device``
    take their path on either device; the value is compared as given.  Any
    other value, or none, takes :func:`default_median`.
    ``ERP_MEDIAN=native`` with a library that does not load raises
    ``RadpulError(RADPUL_EVAL)``: an explicit request never degrades.
    Logs the choice.  The default ``device``, the CPU, gives the reference
    package's answer for every value."""
    requested = os.environ.get("ERP_MEDIAN", "")
    on_card = torch.device(device).type == "cuda"
    if requested == "native":
        native_median.load()  # raises RADPUL_EVAL when it does not load
        path = "native"
    elif requested == "device":
        path = "device"
    else:
        path = default_median(device)
    erplog.info(
        "Running median path: %s\n",
        "native C++ on the host" if path == "native" else "device, on the card" if on_card else "device, on the CPU",
    )
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
    dev = resolve_device(device)
    path = check_median(dev)
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
        if dev.type == "cuda":
            metrics.counter("whiten.device_medians").inc()

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
    zeros, and the median of the path it will take on ``device``
    (:func:`check_median`): the host median's library, or the device
    median's kernel."""
    dev = resolve_device(device)
    F = _forward(torch.zeros(nsamples, dtype=torch.float32, device=dev))
    _inverse(F.real, F.imag, nsamples)
    if check_median(dev) == "native":
        native_median.running_median(np.zeros(3, dtype=np.float32), 3)
    else:
        running_median(torch.zeros(3, dtype=torch.float32, device=dev), bsize=3)
