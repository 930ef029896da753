"""Power spectrum: ``rfft`` + ``|X|^2 / nsamples`` with the DC bin zeroed
(``demod_binary_fft_fftw.c:88-113``), the native-FFT branch of the
reference package's ``ops/spectrum.py``, and the search's real-to-complex
transform.

:func:`search_rfft` is the batch step's complex transform: on a card, for a
float32 series whose half length ``M = nsamples / 2`` has a split
(:func:`r2c_split`), the kernel pair of ``csrc/rfft.cu`` (:func:`rfft_r2c`:
the packed half-length FFT of the upstream OpenCL backend, four-step in two
passes, and its untangle; its first pass works in place, so the series is
overwritten; launch count ``fft_r2c``, run-report counter
``fft.r2c_kernel_batches``); any other shape, and every CPU tensor, takes
``torch.fft.rfft`` (cuFFT on the card).  :func:`search_power` is the same
kernel pair with the power epilogue in its second pass, which the step
takes in its place on a card at a split length, handing kernel C its float
power (``models/search.py::fold_input``).  :func:`rfft_fourstep_plain` is the kernel's
plain version: the same split, twiddles and untangle in PyTorch ops.  The
whitening's transforms and the rescoring's float64 one stay on
``torch.fft``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from . import kernels
from .kernels import planned_fft

# the rows of the second pass (N2); N1 = M / N2 is a power of two in this range
R2C_ROWS = (2048, 3072)
R2C_COLS_RANGE = (16, 2048)
# the kernel's double tables of W_2M^e: TL[j] for j < 2^11, TH[h] = W_2M^(2^11 h)
_LO_BITS = 11

_tables: dict = {}
_tables_lock = threading.Lock()


def r2c_split(nsamples: int) -> tuple[int, int] | None:
    """``(N1, N2)`` of the kernel's four-step split of an
    ``nsamples``-point R2C, ``M = nsamples / 2 = N1 * N2``: N2 = 3072 where
    M has the factor 3, else 2048, and N1 a power of two in [16, 2048].
    None where M has another form (``M = 2^a 3^b``, b <= 1, 2^15 <= M <=
    3 * 2^21 holds it), which then keeps cuFFT."""
    if nsamples % 2:
        return None
    M = nsamples // 2
    n2 = R2C_ROWS[1] if M % 3 == 0 else R2C_ROWS[0]
    n1, rem = divmod(M, n2)
    lo, hi = R2C_COLS_RANGE
    if rem or not lo <= n1 <= hi or n1 & (n1 - 1):
        return None
    return n1, n2


def _roots(n: int, e: np.ndarray) -> np.ndarray:
    """``exp(-2 pi i e / n)`` in complex128, ``e`` integers below ``n``."""
    return np.exp(-2j * np.pi * (np.asarray(e, dtype=np.float64) / n))


def r2c_tables(n1: int, n2: int) -> dict[str, np.ndarray]:
    """The kernel's twiddle tables, made in double: ``tw1`` and ``tw2``
    (complex64 ``W_L^m``, m < L, for the N1- and N2-point FFTs, each rounded
    once) and ``th``, ``tl`` (complex128 ``W_2M^e`` at ``e = 2^11 h`` and
    ``e = j < 2^11``, whose product the kernel rounds once)."""
    two_m = 2 * n1 * n2
    return {
        "tw1": _roots(n1, np.arange(n1)).astype(np.complex64),
        "tw2": _roots(n2, np.arange(n2)).astype(np.complex64),
        "th": _roots(two_m, np.arange(two_m >> _LO_BITS) << _LO_BITS),
        "tl": _roots(two_m, np.arange(1 << _LO_BITS)),
    }


def _device_tables(dev: torch.device, n1: int, n2: int) -> dict[str, torch.Tensor]:
    """:func:`r2c_tables` on ``dev``, made once a process per card and split."""
    key = (str(dev), n1, n2)
    with _tables_lock:
        if key not in _tables:
            _tables[key] = {k: torch.from_numpy(v).to(dev) for k, v in r2c_tables(n1, n2).items()}
        return _tables[key]


def rfft_fourstep_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`rfft_r2c`: complex64[T, M + 1] of the real
    float32 series ``x[T, 2M]`` through the kernel's split: z = x read as
    complex[T, N1, N2], the N1-point FFTs over n1, times ``W_M^(n2 k1)``,
    the N2-point FFTs over n2 (Z at k1 + N1 k2), and the untangle
    ``X[k] = (Z[k] + conj Z[M-k]) / 2 - i W_N^k (Z[k] - conj Z[M-k]) / 2``;
    each twiddle complex64, rounded once from double."""
    T, N = x.shape
    split = r2c_split(N)
    if split is None:
        raise ValueError(f"no four-step split of a {N}-point transform")
    n1, n2 = split
    M = n1 * n2
    dev = x.device
    z = torch.view_as_complex(x.to(torch.float32).reshape(T, n1, n2, 2))
    y = torch.fft.fft(z, dim=1)
    k1n2 = np.arange(n1)[:, None] * np.arange(n2)[None, :]
    y = y * torch.from_numpy(_roots(M, k1n2).astype(np.complex64)).to(dev)
    Z = torch.fft.fft(y, dim=2).transpose(1, 2).reshape(T, M)
    k = np.arange(M + 1)
    zk = Z[:, torch.from_numpy(k % M).to(dev)]
    zm = Z[:, torch.from_numpy((M - k) % M).to(dev)].conj()
    w = torch.from_numpy(_roots(2 * M, k).astype(np.complex64)).to(dev)
    p = w * (zk - zm)
    a = zk + zm
    return torch.complex(0.5 * a.real + 0.5 * p.imag, 0.5 * a.imag - 0.5 * p.real)


def _r2c_operands(x: torch.Tensor) -> tuple[int, int, int, dict[str, torch.Tensor]]:
    """``(T, n1, n2, tables)`` of a launch of ``csrc/rfft.cu`` on the CUDA
    tensor ``x``; raises where :func:`rfft_r2c` says."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32[T, nsamples] tensor")
    T, N = x.shape
    if not 0 < T <= kernels.MAX_GRID_T:
        raise ValueError(f"template batch of {T} outside [1, {kernels.MAX_GRID_T}]")
    split = r2c_split(N)
    if split is None:
        raise ValueError(f"no four-step split of a {N}-point transform")
    n1, n2 = split
    return T, n1, n2, _device_tables(x.device, n1, n2)


def _count_launch(name: str, *counters: str) -> None:
    kernels.launch_counts[name] += 1
    from ..runtime import metrics

    for c in ("fft.r2c_kernel_batches",) + counters:
        metrics.counter(c).inc()


def rfft_r2c(x: torch.Tensor) -> torch.Tensor:
    """The kernel pair of ``csrc/rfft.cu``: complex64[T, M + 1], the R2C
    transforms of the float32 series ``x[T, 2M]``, bin for bin the layout
    ``torch.fft.rfft`` gives.  On a card it overwrites ``x``, which holds
    the first pass's intermediate afterwards (a caller that needs the series
    again passes a copy); the transform's working set is then the series and
    the spectrum alone.  On a CPU tensor, :func:`rfft_fourstep_plain`, which
    leaves ``x`` as it is.  Raises on a dtype other than float32, a
    non-contiguous input, a batch outside the grid, or a length without a
    split (:func:`r2c_split`)."""
    if x.device.type == "cpu":
        return rfft_fourstep_plain(x)
    T, n1, n2, tab = _r2c_operands(x)
    dev = x.device
    out = torch.empty((T, n1 * n2 + 1), dtype=torch.complex64, device=dev)
    rc = kernels.library("rfft").erp_fft_r2c(
        dev.index, kernels.stream_handle(dev), x.data_ptr(), out.data_ptr(),
        tab["tw1"].data_ptr(), tab["tw2"].data_ptr(), tab["th"].data_ptr(), tab["tl"].data_ptr(),
        T, n1, n2,
    )
    kernels.check(rc, "rfft kernel launch")
    _count_launch("fft_r2c")
    return out


def search_power(x: torch.Tensor, *, read: int) -> torch.Tensor:
    """float32[T, read]: the fold's power spectra of the float32 series
    ``x[T, nsamples]``, :func:`power_from_rfft` of their R2C transforms
    (DC 0) at the bins ``k < read`` (``read`` in [1, nsamples/2 + 1]).  On
    a card the kernel pair of ``csrc/rfft.cu`` with its second pass forming
    the power where it forms each bin, so the complex spectrum is never
    stored, bitwise the power kernel C forms from :func:`rfft_r2c`'s
    spectrum (launch count ``fft_r2c_power``; run-report counters
    ``fft.r2c_kernel_batches`` and ``fft.r2c_power_batches``).  It
    overwrites ``x`` there, as :func:`rfft_r2c` does, and raises where that
    does.  On a CPU tensor, the power of :func:`rfft_fourstep_plain`."""
    N = x.shape[-1]
    if not 1 <= read <= N // 2 + 1:
        raise ValueError(f"read {read} outside [1, {N // 2 + 1}]")
    if x.device.type == "cpu":
        return power_from_rfft(rfft_fourstep_plain(x)[:, :read], nsamples=N)
    T, n1, n2, tab = _r2c_operands(x)
    dev = x.device
    out = torch.empty((T, read), dtype=torch.float32, device=dev)
    rc = kernels.library("rfft").erp_fft_r2c_power(
        dev.index, kernels.stream_handle(dev), x.data_ptr(), out.data_ptr(),
        tab["tw1"].data_ptr(), tab["tw2"].data_ptr(), tab["th"].data_ptr(), tab["tl"].data_ptr(),
        T, n1, n2, read, float(np.float32(1.0 / N)),
    )
    kernels.check(rc, "rfft kernel launch (power out)")
    _count_launch("fft_r2c_power", "fft.r2c_power_batches")
    return out


def search_rfft(x: torch.Tensor) -> torch.Tensor:
    """The complex R2C of ``x[T, nsamples]``: :func:`rfft_r2c` for a CUDA
    tensor whose length has a split (which overwrites ``x``), else
    ``torch.fft.rfft`` through :func:`~.kernels.planned_fft` (cuFFT on a
    card, PyTorch's FFT on the CPU).  It routes by device and shape alone.
    The batch step takes it where it does not take :func:`search_power`:
    at lengths without a split, and on the CPU."""
    if x.device.type == "cuda" and r2c_split(x.shape[-1]) is not None:
        return rfft_r2c(x)
    return planned_fft(torch.fft.rfft, x)


def power_from_rfft(F: torch.Tensor, *, nsamples: int) -> torch.Tensor:
    """``(re*re + im*im) * float32(1/nsamples)`` of the complex spectra
    ``F[..., L]``, each multiply and add rounded on its own, DC bin zeroed
    per spectrum: the plain version of the power epilogue that kernel C
    forms from the complex spectrum (``ops/harmonic.py::sumspec_spectrum``)
    and that :func:`search_power`'s kernel forms in the transform."""
    ps = (F.real * F.real + F.imag * F.imag) * float(np.float32(1.0 / nsamples))
    ps[..., 0] = 0.0
    return ps


def power_spectrum(x: torch.Tensor, *, nsamples: int) -> torch.Tensor:
    """float32[..., nsamples//2 + 1] of the real series ``x[..., nsamples]``,
    DC bin zeroed per spectrum."""
    return power_from_rfft(planned_fft(torch.fft.rfft, x), nsamples=nsamples)
