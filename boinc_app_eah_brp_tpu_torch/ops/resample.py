"""Orbital resampling of the time series for a batch of templates.

Counterpart of the reference package's ``ops/resample.py`` and
``ops/pallas_resample.py``.  Three kernels carry it on the card:

* kernel A (``csrc/resample.cu``): per template and output sample, the
  LUT-sine phase -> ``del_t`` -> clipped nearest index -> gathered sample,
  and per template the statistics ``(n_steps, mean)``: the start of the
  trailing run and the mean of the samples below it;
* kernel B (``csrc/fftprep.cu``): the gathered samples below ``n_steps``
  and the template's pad mean above, written as the interleaved padded
  series that the real FFT reads;
* on unwhitened runs, the exact mean (``csrc/resample.cu``, entry
  ``erp_exact_mean``, counted as ``serial_mean``): per template of a whole
  bank, ahead of the search, n_steps and the reference's pad mean, a
  strictly sequential float32 sum of A's samples (made again from ``ts``
  with A's own device functions), which kernel B then pads with instead
  of A's fixed-order mean.

Kernel A and the exact mean also come in an exact-sine instantiation
(``exact_sin=True``, the command line's ``--exact-sin``; the reference
package's ``use_lut=False``): ``torch.sin`` of the float32 phase, CUDA's
``sinf`` in the kernel, in place of the LUT sine, the rest of the chain
unchanged.  Each instantiation has its own launch count (``resample_exact``,
``resample_t1_exact``, ``serial_mean_exact``).

Each kernel has its plain PyTorch version here; a wrapper runs the plain
version for CPU tensors and launches the kernel for CUDA tensors (or
raises).  The plain versions are separate eager float32 ops in the
reference order and are never compiled: a fused multiply-add in the index
arithmetic would flip nearest indices.  The mean's sum has one fixed
order (:func:`masked_sum_plain`), so kernel and plain version agree bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle.resample import ResampleParams, compute_n_steps, resample_stats, serial_mean_f32
from ..runtime.devicecost import stage_scope
from . import kernels
from .sincos import COS64, SIN64, TWO_PI, TWO_PI_INV, sincos_lut_unwrapped

PER_LANE = 8  # outputs a lane of kernel A sums in order (csrc/resample.cu kPer)
UNIT = 32 * PER_LANE  # outputs a warp sums as one unit (kUnit)

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


def _halve(x: torch.Tensor) -> torch.Tensor:
    """Halving tree over the last axis: ``x[..., :h] + x[..., h:]`` until
    one element is left (the length must be a power of two)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def masked_sum_plain(raw: torch.Tensor, n_steps: torch.Tensor) -> torch.Tensor:
    """float32[T]: the sum of ``raw[t, p, m]`` over ``2m+p < n_steps[t]``,
    in kernel A's fixed order: per unit of ``UNIT`` outputs, lane ``j``'s
    ``PER_LANE`` outputs ``j, j+32, ...`` left to right, a halving tree
    over the 32 lanes, a halving tree over the units padded with +0.0 to a
    power of two, then ``sum_even + sum_odd``.  Left-out samples add
    +0.0."""
    T, _, half = raw.shape
    m = torch.arange(half, dtype=torch.int32, device=raw.device)
    i = 2 * m[None, :] + torch.arange(2, dtype=torch.int32, device=raw.device)[:, None]
    x = torch.where(i[None] < n_steps[:, None, None], raw, torch.zeros((), dtype=raw.dtype, device=raw.device))
    n_units = -(-half // UNIT)
    x = torch.nn.functional.pad(x, (0, n_units * UNIT - half))
    x = x.reshape(T, 2, n_units, PER_LANE, 32).transpose(-1, -2)
    lane = x[..., 0]
    for k in range(1, PER_LANE):
        lane = lane + x[..., k]
    units = _halve(lane)  # (T, 2, n_units)
    n_pow2 = 1 << (n_units - 1).bit_length()
    sums = _halve(torch.nn.functional.pad(units, (0, n_pow2 - n_units)))
    return sums[:, 0] + sums[:, 1]


def resample_stream_plain(ts, params, *, n_unpadded: int, dt: float, renorm=None, exact_sin: bool = False):
    """Plain version of kernel A: ``(raw float32[T, 2, half], n_steps
    int32[T], mean float32[T])``; the sine is the LUT's, or with
    ``exact_sin`` ``torch.sin`` of the float32 phase.  ``raw[t, p, m]`` is the gathered sample
    of interleaved index ``2m+p``; ``n_steps`` is ``max(2*lf_e, 2*lf_o+1)``
    with ``lf_p`` the largest ``m`` of parity ``p`` whose ``i - del_t <
    n-1`` (the reference's trailing-run start); ``mean`` is
    :func:`masked_sum_plain` over ``n_steps`` by IEEE division.  ``ts`` is
    the whitened time series float32[n_unpadded]."""
    dev = ts.device
    T = params.shape[0]
    half = n_unpadded // 2
    tau, omega, psi0, s0 = (params[:, c].reshape(T, 1, 1) for c in range(4))
    m = torch.arange(half, dtype=torch.int32, device=dev)
    parity = torch.arange(2, dtype=torch.int32, device=dev)[:, None]
    i_f = (2 * m[None, :] + parity).to(torch.float32)[None]  # (1, 2, half), exact
    tt = i_f * float(np.float32(dt))
    phase = omega * tt + psi0
    s = torch.sin(phase) if exact_sin else sincos_lut_unwrapped(phase)[0]
    del_t = tau * s * _step_inv(dt) - s0
    x = i_f - del_t
    cond = x >= float(n_unpadded - 1)
    idx = (x + 0.5).to(torch.int32).clamp(0, n_unpadded - 1)
    raw = ts[idx.long()]
    if renorm is not None:
        raw = raw * float(np.float32(renorm))
    last = torch.where(cond, torch.tensor(-1, dtype=torch.int32, device=dev), m)
    lf = last.amax(dim=2)  # (T, 2)
    n_steps = torch.maximum(2 * lf[:, 0], 2 * lf[:, 1] + 1).to(torch.int32)
    mean = masked_sum_plain(raw, n_steps) / n_steps.to(torch.float32)
    return raw.contiguous(), n_steps, mean


# the float32 sines an exact-sine resampler may meet (XLA's, NumPy's and
# PyTorch's on the CPU, CUDA's sinf) each keep within a few ulp of the true
# sine; SINE_ULPS of them bounds any two apart
SINE_ULPS = 4


def sine_ties(params, n: int, dt: float, ulps: int = SINE_ULPS) -> np.ndarray:
    """bool[T, 2, n//2]: the samples whose nearest index (or trailing-run
    test) two exact-sine resamplers, whose float32 sines are within
    ``ulps`` ulp of each other, may gather differently: where the float64
    tie distance of ``z = i - del_t + 0.5`` to the nearest integer (or of
    ``i - del_t`` to ``n - 1``) is within what that spread of the sine, one
    ulp of the phase (a contracted phase) and the roundings of
    ``tau*s*step_inv`` (which a compiler may fuse into the subtraction of
    S0), ``del_t``, ``i - del_t`` and ``z`` can move.  ``params`` are the
    four float32 columns (tau, omega, psi0, S0) of the templates."""
    f32, f64 = np.float32, np.float64
    tau, om, psi, s0 = (np.asarray(p, dtype=f32)[:, None] for p in params)
    step_inv = f32(1.0) / f32(dt)
    i_f = np.arange(n, dtype=f32)[None, :]
    phase = om * (i_f * f32(dt)) + psi
    s = np.sin(phase.astype(f64))
    d_s = ulps * np.spacing(np.abs(s).astype(f32)).astype(f64) + np.spacing(np.abs(phase)).astype(f64)
    a = tau.astype(f64) * s * f64(step_inv)
    del_t = a - s0.astype(f64)
    x = i_f.astype(f64) - del_t
    z = x + 0.5
    slack = (
        np.abs(tau.astype(f64) * f64(step_inv)) * d_s
        + 2 * np.spacing(np.abs(a).astype(f32)).astype(f64)
        + 2 * np.spacing(np.abs(del_t).astype(f32)).astype(f64)
        + np.spacing(np.abs(x).astype(f32)).astype(f64)
        + np.spacing(np.abs(z).astype(f32)).astype(f64)
    )
    near = (np.abs(z - np.round(z)) <= slack) | (np.abs(x - (n - 1)) <= slack)
    return near.reshape(tau.shape[0], n // 2, 2).transpose(0, 2, 1)


def _resample_library(dev: torch.device):
    """``resample.cu``'s library, its LUT tables uploaded to ``dev``."""
    lib = kernels.library("resample")
    if dev.index not in _tables_ready:
        if lib.erp_resample_unit() != UNIT:
            raise RuntimeError("kernel A unit size disagrees with UNIT")
        two_pi = np.array([TWO_PI, TWO_PI_INV], dtype=np.float32)
        kernels.check(
            lib.erp_resample_init(dev.index, SIN64.ctypes.data, COS64.ctypes.data, two_pi.ctypes.data),
            "resample table upload",
        )
        _tables_ready.add(dev.index)
    return lib


def resample_stream(
    ts, params, *, n_unpadded: int, dt: float, renorm=None, exact_sin: bool = False, count_as: str | None = None
):
    """Kernel A over the time series ``ts`` and the template batch
    ``params`` (:func:`stream_params`), in its exact-sine instantiation
    with ``exact_sin``; see :func:`resample_stream_plain` for the
    outputs.  A launch counts under ``count_as`` where given (the
    rescoring's), else by batch size and sine."""
    if ts.device.type == "cpu":
        return resample_stream_plain(ts, params, n_unpadded=n_unpadded, dt=dt, renorm=renorm, exact_sin=exact_sin)
    if ts.device.type != "cuda":
        raise ValueError(f"unsupported device {ts.device}")
    if params.shape[0] < 1:
        raise ValueError("empty template batch")
    if n_unpadded % 2 or n_unpadded <= 0:
        raise ValueError("the resampler requires an even, positive n_unpadded")
    dev = ts.device
    T = params.shape[0]
    half = n_unpadded // 2
    _check_cuda("ts", ts, torch.float32, (n_unpadded,), dev)
    _check_cuda("params", params, torch.float32, (T, 4), dev)
    lib = _resample_library(dev)
    n_units = -(-half // UNIT)
    raw = torch.empty((T, 2, half), dtype=torch.float32, device=dev)
    stats = torch.empty((2, T), dtype=torch.int32, device=dev)  # n_steps, mean bits
    units = torch.empty((2, T, 2, n_units), dtype=torch.int32, device=dev)  # sum bits, last
    n_steps, mean = stats[0], stats[1].view(torch.float32)
    rc = lib.erp_resample_stream(
        dev.index, kernels.stream_handle(dev),
        ts.data_ptr(), params.data_ptr(),
        raw.data_ptr(), n_steps.data_ptr(), mean.data_ptr(),
        units[0].data_ptr(), units[1].data_ptr(),
        T, half, n_unpadded, float(np.float32(dt)), _step_inv(dt),
        float(np.float32(renorm if renorm is not None else 1.0)), int(renorm is not None), int(exact_sin),
    )
    kernels.check(rc, "resample kernel launch")
    # the single-template launch stands for the reference package's
    # parity-stream kernel and is counted as its own entry
    kernels.launch_counts[count_as or ("resample_t1" if T == 1 else "resample") + ("_exact" if exact_sin else "")] += 1
    return raw, n_steps, mean


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


def serial_mean_plain(raw: torch.Tensor, n_steps: torch.Tensor) -> torch.Tensor:
    """The serial mean of kernel A's outputs: float32[T], per template
    the samples ``raw[t, i & 1, i >> 1]`` for ``i < n_steps[t]`` added
    strictly in order in float32, divided by ``n_steps[t]`` (0.0 where
    ``n_steps <= 0``): the exact mean of :func:`exact_mean_params`, taken
    from samples already made.  It is the oracle's own chain
    (``oracle/resample.py::serial_mean_f32``, ``np.add.accumulate`` with a
    float32 accumulator) run on the host, whatever device ``raw`` is on.
    Neither ``torch.cumsum`` nor ``torch.sum`` is this function: on the
    CPU both accumulate float32 data in double (on 2^22 samples of
    N(5, 1) they give the float64 sum, hundreds above the serial float32
    one; ``tests/test_torch_resample.py`` shows it)."""
    x = raw.detach().cpu().numpy()
    ns = n_steps.cpu().numpy()
    out = np.array(
        [serial_mean_f32(x[t].T.reshape(-1), int(ns[t])) for t in range(x.shape[0])],
        dtype=np.float32,
    )
    return torch.from_numpy(out).to(raw.device)


def _exact_sin_del_t(row: torch.Tensor, *, n_unpadded: int, dt: float) -> np.ndarray:
    """float32[n_unpadded] ``del_t`` of one template row (tau, omega,
    psi0, S0) with the exact sine: kernel A's plain chain at T = 1, on
    the row's device, copied to the host."""
    tau, omega, psi0, s0 = row
    i_f = torch.arange(n_unpadded, dtype=torch.int32, device=row.device).to(torch.float32)
    phase = omega * (i_f * float(np.float32(dt))) + psi0
    return (tau * torch.sin(phase) * _step_inv(dt) - s0).cpu().numpy()


def exact_mean_params_plain(ts, params, *, n_unpadded: int, dt: float, exact_sin: bool = False):
    """Plain version of the exact-mean kernel: ``(n_steps int32[N], mean
    float32[N])`` of the templates ``params`` (:func:`stream_params`
    rows), each the oracle's ``resample_stats`` on the host
    (``oracle/resample.py``: the LUT-sine ``del_t``, the reference's
    shrink loop, the nearest-index gather and the serial float32 mean, 0.0
    where ``n_steps <= 0``), whatever device ``ts`` is on.  It is the
    reference package's host pass ``host_exact_mean_params``.  With
    ``exact_sin`` the ``del_t`` is kernel A's plain exact-sine chain
    (``torch.sin``, on ``ts``'s device) and the rest the same host pass."""
    x = ts.detach().cpu().numpy().astype(np.float32, copy=False)
    if exact_sin:
        n_steps = np.empty(params.shape[0], dtype=np.int32)
        mean = np.empty(params.shape[0], dtype=np.float32)
        for t in range(params.shape[0]):
            del_t = _exact_sin_del_t(params[t].to(ts.device), n_unpadded=n_unpadded, dt=dt)
            n_steps[t] = compute_n_steps(del_t, n_unpadded)
            head = max(int(n_steps[t]), 0)
            idx = (np.arange(head, dtype=np.float32) - del_t[:head] + np.float32(0.5)).astype(np.int32)
            mean[t] = serial_mean_f32(x[np.clip(idx, 0, n_unpadded - 1)], int(n_steps[t]))
        return torch.from_numpy(n_steps).to(ts.device), torch.from_numpy(mean).to(ts.device)
    rows = params.detach().cpu().numpy().astype(np.float32, copy=False)
    dt32 = np.float32(dt)
    n_steps = np.empty(len(rows), dtype=np.int32)
    mean = np.empty(len(rows), dtype=np.float32)
    for t, (tau, omega, psi0, s0) in enumerate(rows):
        rp = ResampleParams(
            nsamples=n_unpadded, nsamples_unpadded=n_unpadded, fft_size=n_unpadded // 2 + 1,
            tau=tau, omega=omega, psi0=psi0, dt=dt32, step_inv=np.float32(1.0) / dt32, s0=s0,
        )
        n_steps[t], mean[t] = resample_stats(x, rp)
    return torch.from_numpy(n_steps).to(ts.device), torch.from_numpy(mean).to(ts.device)


def exact_mean_params(ts, params, *, n_unpadded: int, dt: float, exact_sin: bool = False, count_as: str | None = None):
    """The exact-mean kernel: ``(n_steps, mean)`` of every template of
    ``params`` in one launch, over the series ``ts`` (unwhitened runs
    search it as it is: no renorm), in its exact-sine instantiation with
    ``exact_sin``; see :func:`exact_mean_params_plain`.  ``n_steps``
    equals kernel A's.  A launch counts under ``count_as`` where given
    (the rescoring's), else by sine."""
    if ts.device.type == "cpu":
        return exact_mean_params_plain(ts, params, n_unpadded=n_unpadded, dt=dt, exact_sin=exact_sin)
    if ts.device.type != "cuda":
        raise ValueError(f"unsupported device {ts.device}")
    dev = ts.device
    N = params.shape[0]
    if N < 1:
        raise ValueError("empty template batch")
    if n_unpadded % 2 or n_unpadded <= 0:
        raise ValueError("the resampler requires an even, positive n_unpadded")
    _check_cuda("ts", ts, torch.float32, (n_unpadded,), dev)
    _check_cuda("params", params, torch.float32, (N, 4), dev)
    lib = _resample_library(dev)
    out = torch.empty((2, N), dtype=torch.int32, device=dev)  # n_steps, mean bits
    n_steps, mean = out[0], out[1].view(torch.float32)
    rc = lib.erp_exact_mean(
        dev.index, kernels.stream_handle(dev), ts.data_ptr(), params.data_ptr(),
        n_steps.data_ptr(), mean.data_ptr(), N, n_unpadded, float(np.float32(dt)), _step_inv(dt), int(exact_sin),
    )
    kernels.check(rc, "exact mean kernel launch")
    kernels.launch_counts[count_as or ("serial_mean_exact" if exact_sin else "serial_mean")] += 1
    return n_steps, mean


def fftprep_series(
    ts, tau, omega, psi0, s0, *, nsamples: int, n_unpadded: int, dt: float, renorm=None,
    exact_mean: bool = False, mean=None, exact_sin: bool = False,
) -> torch.Tensor:
    """Kernel A (samples and statistics), then kernel B: the interleaved
    padded series float32[T, nsamples] of every template, ready for the
    real FFT.  The pad is ``mean`` (float32[T]) where given, else with
    ``exact_mean`` (unwhitened runs) the reference's serial float32 mean
    of A's samples (:func:`exact_mean_params` over this batch), else A's
    fixed-order mean.  ``exact_sin`` takes the exact-sine instantiations
    of A and the exact mean.  A runs under the ``resample`` scope, B under
    ``fftprep`` (``runtime/devicecost.py``)."""
    with stage_scope("resample"):
        params = stream_params(tau, omega, psi0, s0, device=ts.device)
        raw, n_steps, a_mean = resample_stream(
            ts, params, n_unpadded=n_unpadded, dt=dt, renorm=renorm, exact_sin=exact_sin
        )
    if mean is None and exact_mean:
        if renorm is not None:
            raise ValueError("the exact mean is of the unwhitened series: it takes no renorm")
        with stage_scope("serial_mean"):
            mean = exact_mean_params(ts, params, n_unpadded=n_unpadded, dt=dt, exact_sin=exact_sin)[1]
    with stage_scope("fftprep"):
        return fftprep(raw, n_steps, a_mean if mean is None else mean, nsamples=nsamples)


def resample_fftprep_batch(
    ts, tau, omega, psi0, s0, *, nsamples: int, n_unpadded: int, dt: float, renorm=None,
    exact_mean: bool = False, exact_sin: bool = False,
):
    """(even, odd) float32[T, nsamples//2] parity views of
    :func:`fftprep_series`: the counterpart of
    ``resample_fftprep_pallas_batch`` (with ``exact_sin``, of the
    reference package's ``resample_split`` at ``use_lut=False``)."""
    x = fftprep_series(
        ts, tau, omega, psi0, s0,
        nsamples=nsamples, n_unpadded=n_unpadded, dt=dt, renorm=renorm, exact_mean=exact_mean,
        exact_sin=exact_sin,
    )
    return x[:, 0::2], x[:, 1::2]


# The counterpart of ``resample_split_pallas_batch``: in the reference
# package it pads in XLA instead of in a kernel, but the result is the same
# select between the same sample and mean, so here kernel B does the pad.
resample_split_batch = resample_fftprep_batch


def resample_split(
    ts, tau, omega, psi0, s0, *, nsamples: int, n_unpadded: int, dt: float, renorm=None, exact_sin: bool = False
):
    """One template: (even, odd) float32[nsamples//2], the T=1 launch of
    :func:`resample_split_batch` (counterpart of ``resample_split_pallas``,
    and with ``exact_sin`` of the reference package's ``resample_split`` at
    ``use_lut=False``)."""
    ev, od = resample_split_batch(
        ts, tau, omega, psi0, s0,
        nsamples=nsamples, n_unpadded=n_unpadded, dt=dt, renorm=renorm, exact_sin=exact_sin,
    )
    return ev[0], od[0]
