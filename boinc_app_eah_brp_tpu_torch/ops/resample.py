"""Orbital resampling of the time series for a batch of templates.

Counterpart of the reference package's ``ops/resample.py`` and
``ops/pallas_resample.py``.  Two kernels carry it on the card:

* kernel A (``csrc/resample.cu``): per template and output sample, the
  LUT-sine phase -> ``del_t`` -> clipped nearest index -> gathered sample,
  plus per block the last index before the trailing run;
* kernel B (``csrc/fftprep.cu``): the gathered samples below ``n_steps``
  and the template's pad mean above, written as the interleaved padded
  series that the real FFT reads.

Between them :func:`batch_stats` reduces A's outputs to each template's
``(n_steps, mean)``.  Each kernel has its plain PyTorch version here; a
wrapper runs the plain version for CPU tensors and launches the kernel for
CUDA tensors (or raises).  The plain versions are separate eager float32
ops in the reference order and are never compiled: a fused multiply-add in
the index arithmetic would flip nearest indices.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .sincos import COS64, SIN64, TWO_PI, TWO_PI_INV, sincos_lut_unwrapped

STREAM_BLOCK = 256  # outputs per kernel-A block (csrc/resample.cu kStreamBlock)

_tables_ready: set[int] = set()


def _check_cuda(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_params(tau, omega, psi0, s0, device=None) -> torch.Tensor:
    """float32[T, 4] rows (tau, omega, psi0, S0) of a template batch."""
    cols = [torch.as_tensor(a, dtype=torch.float32, device=device).reshape(-1) for a in (tau, omega, psi0, s0)]
    return torch.stack(cols, dim=1).contiguous()


def _step_inv(dt: float) -> float:
    return float(np.float32(1.0) / np.float32(dt))


def resample_stream_plain(ts_even, ts_odd, params, *, n_unpadded: int, dt: float, renorm=None):
    """Plain version of kernel A: (raw float32[T, 2, half], lf int32[T, 2,
    n_blocks]) where ``raw[t, p, m]`` is the gathered sample of interleaved
    index ``2m+p`` and ``lf[t, p, b]`` the largest ``m`` of block ``b`` whose
    ``i - del_t < n-1`` (-1 when there is none)."""
    dev = ts_even.device
    T = params.shape[0]
    half = n_unpadded // 2
    n_blocks = -(-half // STREAM_BLOCK)
    tau, omega, psi0, s0 = (params[:, c].reshape(T, 1, 1) for c in range(4))
    m = torch.arange(half, dtype=torch.int32, device=dev)
    parity = torch.arange(2, dtype=torch.int32, device=dev)[:, None]
    i_f = (2 * m[None, :] + parity).to(torch.float32)[None]  # (1, 2, half), exact
    tt = i_f * float(np.float32(dt))
    phase = omega * tt + psi0
    s = sincos_lut_unwrapped(phase)[0]
    del_t = tau * s * _step_inv(dt) - s0
    x = i_f - del_t
    cond = x >= float(n_unpadded - 1)
    idx = (x + 0.5).to(torch.int32).clamp(0, n_unpadded - 1)
    ts = torch.stack([ts_even, ts_odd], dim=-1).reshape(-1)
    raw = ts[idx.long()]
    if renorm is not None:
        raw = raw * float(np.float32(renorm))
    last = torch.where(cond, torch.tensor(-1, dtype=torch.int32, device=dev), m)
    pad = n_blocks * STREAM_BLOCK - half
    last = torch.nn.functional.pad(last, (0, pad), value=-1)
    lf = last.reshape(T, 2, n_blocks, STREAM_BLOCK).amax(dim=3)
    return raw.contiguous(), lf.to(torch.int32).contiguous()


def resample_stream(ts_even, ts_odd, params, *, n_unpadded: int, dt: float, renorm=None):
    """Kernel A over the template batch ``params`` (:func:`stream_params`);
    see :func:`resample_stream_plain` for the outputs."""
    if ts_even.device.type == "cpu":
        return resample_stream_plain(
            ts_even, ts_odd, params, n_unpadded=n_unpadded, dt=dt, renorm=renorm
        )
    if ts_even.device.type != "cuda":
        raise ValueError(f"unsupported device {ts_even.device}")
    if not 0 < params.shape[0] <= kernels.MAX_GRID_T:
        raise ValueError(f"template batch of {params.shape[0]} outside [1, {kernels.MAX_GRID_T}]")
    if n_unpadded % 2:
        raise ValueError("the resampler requires an even n_unpadded")
    dev = ts_even.device
    T = params.shape[0]
    half = n_unpadded // 2
    _check_cuda("ts_even", ts_even, torch.float32, (half,), dev)
    _check_cuda("ts_odd", ts_odd, torch.float32, (half,), dev)
    _check_cuda("params", params, torch.float32, (T, 4), dev)
    lib = kernels.library("resample")
    if lib.erp_resample_block() != STREAM_BLOCK:
        raise RuntimeError("kernel A block size disagrees with STREAM_BLOCK")
    if dev.index not in _tables_ready:
        two_pi = np.array([TWO_PI, TWO_PI_INV], dtype=np.float32)
        kernels.check(
            lib.erp_resample_init(dev.index, SIN64.ctypes.data, COS64.ctypes.data, two_pi.ctypes.data),
            "resample table upload",
        )
        _tables_ready.add(dev.index)
    n_blocks = -(-half // STREAM_BLOCK)
    raw = torch.empty((T, 2, half), dtype=torch.float32, device=dev)
    lf = torch.empty((T, 2, n_blocks), dtype=torch.int32, device=dev)
    rc = lib.erp_resample_stream(
        dev.index, kernels.stream_handle(dev),
        ts_even.data_ptr(), ts_odd.data_ptr(), params.data_ptr(),
        raw.data_ptr(), lf.data_ptr(),
        T, half, n_unpadded, float(np.float32(dt)), _step_inv(dt),
        float(np.float32(renorm if renorm is not None else 1.0)), int(renorm is not None),
    )
    kernels.check(rc, "resample kernel launch")
    # the single-template launch stands for the reference package's
    # parity-stream kernel and is counted as its own entry
    kernels.launch_counts["resample_t1" if T == 1 else "resample"] += 1
    return raw, lf


def batch_stats(raw: torch.Tensor, lf: torch.Tensor, *, n_unpadded: int):
    """Per-template ``(n_steps int32[T], mean float32[T])`` from kernel A's
    outputs: the trailing-run start over both parities, and the mean of
    the samples below it (a reduction of its own order, so the mean agrees
    with the reference package's to a tolerance, not bitwise)."""
    half = n_unpadded // 2
    lf_glob = lf.amax(dim=2)  # (T, 2)
    n_steps = torch.maximum(2 * lf_glob[:, 0], 2 * lf_glob[:, 1] + 1).to(torch.int32)
    m2 = torch.arange(half, dtype=torch.int32, device=raw.device) * 2
    mask_e = m2[None, :] < n_steps[:, None]
    mask_o = (m2 + 1)[None, :] < n_steps[:, None]
    zero = torch.zeros((), dtype=raw.dtype, device=raw.device)
    total = torch.where(mask_e, raw[:, 0], zero).sum(dim=1) + torch.where(
        mask_o, raw[:, 1], zero
    ).sum(dim=1)
    mean = total / n_steps.to(torch.float32)
    return n_steps, mean


def fftprep_plain(raw, n_steps, mean, *, nsamples: int) -> torch.Tensor:
    """Plain version of kernel B: float32[T, nsamples], the gathered sample
    where the interleaved index is below ``n_steps``, else the mean."""
    T, _, half = raw.shape
    i = torch.arange(nsamples, dtype=torch.int32, device=raw.device)
    j = (i >> 1).clamp(max=half - 1).long()
    gathered = raw[:, (i & 1).long(), j]  # (T, nsamples)
    mask = (i[None, :] < n_steps[:, None]) & ((i >> 1) < half)[None, :]
    return torch.where(mask, gathered, mean[:, None]).contiguous()


def fftprep(raw, n_steps, mean, *, nsamples: int) -> torch.Tensor:
    """Kernel B; see :func:`fftprep_plain`."""
    if raw.device.type == "cpu":
        return fftprep_plain(raw, n_steps, mean, nsamples=nsamples)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    dev = raw.device
    T, _, half = raw.shape
    if not 0 < T <= kernels.MAX_GRID_T:
        raise ValueError(f"template batch of {T} outside [1, {kernels.MAX_GRID_T}]")
    _check_cuda("raw", raw, torch.float32, (T, 2, half), dev)
    _check_cuda("n_steps", n_steps, torch.int32, (T,), dev)
    _check_cuda("mean", mean, torch.float32, (T,), dev)
    out = torch.empty((T, nsamples), dtype=torch.float32, device=dev)
    rc = kernels.library("fftprep").erp_fftprep(
        dev.index, kernels.stream_handle(dev),
        raw.data_ptr(), n_steps.data_ptr(), mean.data_ptr(), out.data_ptr(),
        T, half, nsamples,
    )
    kernels.check(rc, "fftprep kernel launch")
    kernels.launch_counts["fftprep"] += 1
    return out


def fftprep_series(
    ts_even, ts_odd, tau, omega, psi0, s0, *, nsamples: int, n_unpadded: int, dt: float, renorm=None
) -> torch.Tensor:
    """Kernel A, the stats, kernel B: the interleaved padded series
    float32[T, nsamples] of every template, ready for the real FFT."""
    params = stream_params(tau, omega, psi0, s0, device=ts_even.device)
    raw, lf = resample_stream(ts_even, ts_odd, params, n_unpadded=n_unpadded, dt=dt, renorm=renorm)
    n_steps, mean = batch_stats(raw, lf, n_unpadded=n_unpadded)
    return fftprep(raw, n_steps, mean, nsamples=nsamples)


def resample_fftprep_batch(
    ts_even, ts_odd, tau, omega, psi0, s0, *, nsamples: int, n_unpadded: int, dt: float, renorm=None
):
    """(even, odd) float32[T, nsamples//2] parity views of
    :func:`fftprep_series`: the counterpart of
    ``resample_fftprep_pallas_batch``."""
    x = fftprep_series(
        ts_even, ts_odd, tau, omega, psi0, s0,
        nsamples=nsamples, n_unpadded=n_unpadded, dt=dt, renorm=renorm,
    )
    return x[:, 0::2], x[:, 1::2]


# The counterpart of ``resample_split_pallas_batch``: in the reference
# package it pads in XLA instead of in a kernel, but the result is the same
# select between the same sample and mean, so here kernel B does the pad.
resample_split_batch = resample_fftprep_batch


def resample_split(
    ts_even, ts_odd, tau, omega, psi0, s0, *, nsamples: int, n_unpadded: int, dt: float, renorm=None
):
    """One template: (even, odd) float32[nsamples//2], the T=1 launch of
    :func:`resample_split_batch` (counterpart of ``resample_split_pallas``)."""
    ev, od = resample_split_batch(
        ts_even, ts_odd, tau, omega, psi0, s0,
        nsamples=nsamples, n_unpadded=n_unpadded, dt=dt, renorm=renorm,
    )
    return ev[0], od[0]
