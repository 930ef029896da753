"""NumPy oracle of the CPU resampler (``demod_binary_resamp_cpu.c:80-136``).

Per orbital template (P_orb, tau, Psi0): undo the binary-orbit Doppler
modulation by nearest-neighbour resampling in pulsar time, then pad with
the mean to the padded length.  The C loop's semantics, float32 all
through:

* ``del_t[i] = tau * sinLUT(Omega*t + Psi0) * step_inv - S0``, with
  ``S0 = tau * sinf(Psi0) * step_inv`` through glibc's sinf
  (``demod_binary.c:1230``);
* the ``n_steps`` shrink loop (``:105-109``): from ``n_unpadded - 1``,
  decrement while ``n - del_t[n] >= n_unpadded - 1``;
* the gather ``out[i] = in[(int)(i - del_t[i] + 0.5)]``; the padding mean
  is the C's serial float32 sum (:func:`serial_mean_f32`).

Used by the host rescoring (``oracle/rescore.py``) and as the tests'
reference."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .sincos import libm_sinf, sincos_lut_lookup


@dataclass
class ResampleParams:
    """Mirror of ``RESAMP_PARAMS`` (structs.h:151-161), float32 fields."""

    nsamples: int  # padded length
    nsamples_unpadded: int
    fft_size: int
    tau: np.float32
    omega: np.float32  # 2*pi/P
    psi0: np.float32
    dt: np.float32
    step_inv: np.float32
    s0: np.float32

    @classmethod
    def from_template(
        cls, P: float, tau: float, psi0: float, dt: float, nsamples: int, n_unpadded: int
    ) -> "ResampleParams":
        """The per-template constants as the driver derives them
        (``demod_binary.c:1218,1230-1238``): float32 parameters, Omega =
        2*pi/P in double narrowed once, S0 an all-float32 chain through
        glibc's sinf."""
        P32 = np.float32(P)
        tau32 = np.float32(tau)
        psi32 = np.float32(psi0)
        dt32 = np.float32(dt)
        step_inv = np.float32(1.0) / dt32
        omega = np.float32(np.float64(2.0) * np.pi / np.float64(P32))
        s0 = np.float32(np.float32(tau32 * libm_sinf(psi32)) * step_inv)
        return cls(
            nsamples=nsamples,
            nsamples_unpadded=n_unpadded,
            fft_size=nsamples // 2 + 1,
            tau=tau32,
            omega=omega,
            psi0=psi32,
            dt=dt32,
            step_inv=step_inv,
            s0=s0,
        )


def compute_del_t(params: ResampleParams) -> np.ndarray:
    i_f = np.arange(params.nsamples_unpadded, dtype=np.float32)
    t = (i_f * params.dt).astype(np.float32)
    phase = (params.omega * t + params.psi0).astype(np.float32)
    sin_val, _ = sincos_lut_lookup(phase)
    return (params.tau * sin_val * params.step_inv - params.s0).astype(np.float32)


def compute_n_steps(del_t: np.ndarray, n_unpadded: int) -> int:
    """The serial shrink loop (``demod_binary_resamp_cpu.c:105-109``)."""
    limit = np.float32(n_unpadded - 1)
    n = n_unpadded - 1
    while n >= 0 and np.float32(n) - del_t[n] >= limit:
        n -= 1
    return n


def serial_mean_f32(gathered: np.ndarray, n_steps: int) -> np.float32:
    """The C's padding mean: ``mean += output[i]`` serially in float32
    (``demod_binary_resamp_cpu.c:121``), then divided by the float
    counter.  At 4M samples of nonnegative data the float32 accumulator
    saturates and the result sits ~2e-3 below the true mean; that error
    is the reference's observable behaviour (on unwhitened data it moves
    low-bin powers by percent), so it is replicated, not fixed.
    ``np.add.accumulate(dtype=float32)`` is that strictly sequential
    rounding chain.

    Deviation for ``n_steps <= 0``: the reference divides by 0.0 and pads
    with the NaN or inf; no physical template gets there, and 0.0 keeps
    the spectra finite."""
    if n_steps <= 0:
        return np.float32(0.0)
    ssum = np.add.accumulate(gathered[:n_steps], dtype=np.float32)[-1]
    return np.float32(ssum / np.float32(n_steps))


def _gather_head(ts: np.ndarray, params: ResampleParams) -> tuple[np.ndarray, int]:
    """(gathered[:n_steps], n_steps): the resampled head before padding."""
    del_t = compute_del_t(params)
    n_steps = compute_n_steps(del_t, params.nsamples_unpadded)
    head = max(n_steps, 0)  # -1 when every sample lies in the trailing run
    i_f = np.arange(head, dtype=np.float32)
    nearest_idx = (i_f - del_t[:head] + np.float32(0.5)).astype(np.int32)
    # the reference would read out of bounds below 0 (undefined); clamp
    nearest_idx = np.clip(nearest_idx, 0, params.nsamples_unpadded - 1)
    return ts[nearest_idx], n_steps


def _check_length(ts: np.ndarray, params: ResampleParams) -> None:
    if ts.shape[0] != params.nsamples_unpadded:
        raise ValueError(f"time series has {ts.shape[0]} samples, expected {params.nsamples_unpadded}")


def resample_stats(ts: np.ndarray, params: ResampleParams) -> tuple[int, np.float32]:
    """(n_steps, serial float32 mean) without the padded output."""
    _check_length(ts, params)
    gathered, n_steps = _gather_head(ts, params)
    return n_steps, serial_mean_f32(gathered, n_steps)


def pad_head(head: np.ndarray, n_steps: int, mean: np.float32, nsamples: int) -> np.ndarray:
    """float32[nsamples]: the mean everywhere, then the first ``n_steps``
    entries of ``head`` in front (none where ``n_steps <= 0``)."""
    out = np.full(nsamples, mean, dtype=np.float32)
    out[: max(n_steps, 0)] = head[: max(n_steps, 0)]
    return out


def resample(ts: np.ndarray, params: ResampleParams) -> tuple[np.ndarray, int, np.float32]:
    """(resampled float32[nsamples], n_steps, mean); all the mean (0.0)
    where ``n_steps = -1``."""
    _check_length(ts, params)
    gathered, n_steps = _gather_head(ts, params)
    mean = serial_mean_f32(gathered, n_steps)
    return pad_head(gathered, n_steps, mean, params.nsamples), n_steps, mean
