"""The batched template search and its on-device (M, T) maxima state.

The reference processes one template at a time (``demod_binary.c:1180-1443``)
and keeps per-template toplists with dynamic thresholds.  Here a batch of
templates runs through the resample -> FFT-prep -> rfft -> power + fold
chain in one pass (the fold forms the power from the complex spectrum),
and the device carries ``M[k][j]`` (the largest summed power of
fundamental bin j at harmonic level k over all templates so far)
and ``T[k][j]`` (the first template index reaching it), in the phase-major
layout of ``ops/harmonic.py``.  The merge uses strict ``>`` and the batch
argmax takes the first index, so earlier templates win ties, matching the
reference's keep-first-seen semantics (``demod_binary.c:1360``).

:class:`BankStep` holds the whole bank's parameters and the state on the
device and updates the state in place, one batch per call.

What outlives a workunit in a resident server is keyed by
:func:`step_cache_key`: the loaded kernel libraries (``ops/kernels.py``)
and cuFFT's plan of the batch's transform (torch's plan cache), both held
by the process.  :func:`warm_step` makes them ahead of the first
workunit; ``run_bank(step_cache=...)`` counts a hit or a miss per attempt.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..oracle.pipeline import DerivedParams
from ..oracle.sincos import libm_sinf_array
from ..ops.harmonic import from_natural_order, state_width, sumspec_spectrum, to_natural_order
from ..ops.kernels import planned_fft
from ..ops.resample import exact_mean_params, fftprep_series
from ..runtime.devicecost import scoped, stage_scope

# below any real summed power: padded batch slots are masked to this before
# the batch reduction so they can never claim a bin
NEG_SENTINEL = -3.0e38


@dataclass(frozen=True)
class SearchGeometry:
    """Static geometry of one search configuration."""

    nsamples: int
    n_unpadded: int
    fft_size: int
    window_2: int
    fund_hi: int
    harm_hi: int
    dt: float
    # bank-wide bound on |d del_t/di| = tau*omega (max_slope_for_bank)
    max_slope: float = 0.008
    # bank-wide bound on the per-sample LUT-index step 64*omega*dt/2pi
    lut_step: float = 1e-3
    # LUT periods covering the phase span psi0 + omega*t_obs
    lut_tiles: int = 1024
    # pad with the reference's serial float32 mean (ops/resample.py::
    # exact_mean_params) instead of kernel A's fixed-order one.  On unwhitened
    # data the float32 accumulator saturates (~2e-3 relative at 4M
    # samples) and the pad moves low-bin powers by percent; whitened series
    # have zero mean and skip it.  The driver sets it to ``not cfg.white``.
    exact_mean: bool = False
    # the reference's 64-point LUT sine; False (--exact-sin) takes the
    # exact-sine instantiations of kernel A and the exact mean, and drops
    # the LUT's bounds (lut_step, psi0 in [0, 2pi), lut_tiles), which lets
    # banks with orbits below milliseconds run
    use_lut: bool = True

    @classmethod
    def from_derived(
        cls,
        d: DerivedParams,
        max_slope: float = 0.008,
        lut_step: float = 1e-3,
        lut_tiles: int = 1024,
        exact_mean: bool = False,
        use_lut: bool = True,
    ) -> "SearchGeometry":
        return cls(
            nsamples=d.nsamples,
            n_unpadded=d.n_unpadded,
            fft_size=d.fft_size,
            window_2=d.window_2,
            fund_hi=d.fundamental_idx_hi,
            harm_hi=d.harmonic_idx_hi,
            dt=d.dt,
            max_slope=max_slope,
            lut_step=lut_step,
            lut_tiles=lut_tiles,
            exact_mean=exact_mean,
            use_lut=use_lut,
        )


def _pow2_ceil(x: float) -> float:
    return float(2.0 ** math.ceil(math.log2(x)))


def max_slope_for_bank(P: np.ndarray, tau: np.ndarray, headroom: float = 1.5) -> float:
    """Bank-derived modulation-slope bound, rounded up to a power of two."""
    if len(P) == 0:
        return 0.008
    slope = float(np.max(np.asarray(tau) * (2.0 * np.pi / np.asarray(P))))
    return _pow2_ceil(max(slope * headroom, 1.0 / 1024.0))


def lut_step_for_bank(P: np.ndarray, dt: float, headroom: float = 1.5) -> float:
    """Bank-derived LUT-index-step bound, rounded up to a power of two."""
    if len(P) == 0:
        return 1e-3
    step = 64.0 * float(dt) / float(np.min(np.asarray(P)))
    return _pow2_ceil(max(step * headroom, 1e-6))


def normalize_psi0(psi0: np.ndarray) -> np.ndarray:
    """Reduce initial orbital phases into [0, 2pi) on the host, in double;
    in-range values pass through bit-identical.  The unwrapped LUT index
    needs a nonnegative phase."""
    psi = np.asarray(psi0, dtype=np.float64)
    out = np.fmod(psi, 2.0 * np.pi)
    return np.where(out < 0.0, out + 2.0 * np.pi, out)


# largest LUT tiling the reference package builds (its ops/sincos.py)
MAX_LUT_TILES = 1 << 17


def lut_tiles_for_bank(P: np.ndarray, psi0: np.ndarray, n_unpadded: int, dt: float) -> int:
    """LUT periods covering this bank's phase span (normalized psi0 +
    omega*t_obs), a power of two in [1024, MAX_LUT_TILES]."""
    if len(P) == 0:
        return 1024
    psi_max = float(np.max(normalize_psi0(psi0))) if len(psi0) else 2 * np.pi
    span = psi_max / (2.0 * np.pi) + n_unpadded * float(dt) / float(np.min(P))
    tiles = 1024
    while tiles - 2 < span and tiles < MAX_LUT_TILES:
        tiles *= 2
    return tiles


def validate_bank_bounds(
    geom: SearchGeometry,
    bank_P: np.ndarray,
    bank_tau: np.ndarray,
    bank_psi0: np.ndarray | None = None,
) -> None:
    """Check the bank against the geometry's bounds: the same contract the
    reference package's kernels hold, so both search the same bank.  The
    three LUT bounds apply only where the geometry takes the LUT sine
    (``use_lut``)."""
    if not len(bank_P):
        return
    P = np.asarray(bank_P)
    bank_slope = float(np.max(np.asarray(bank_tau) * (2.0 * np.pi / P)))
    if bank_slope > geom.max_slope:
        raise ValueError(
            f"template bank modulation slope {bank_slope:.3g} exceeds "
            f"geometry bound {geom.max_slope:.3g}; rebuild SearchGeometry "
            "with max_slope_for_bank(P, tau)"
        )
    if not geom.use_lut:
        return
    bank_lut_step = 64.0 * geom.dt / float(np.min(P))
    if bank_lut_step > geom.lut_step:
        raise ValueError(
            f"template bank LUT-index step {bank_lut_step:.3g} exceeds "
            f"geometry bound {geom.lut_step:.3g}; rebuild SearchGeometry "
            "with lut_step_for_bank(P, dt)"
        )
    psi0_max = 2.0 * np.pi
    if bank_psi0 is not None and len(bank_psi0):
        psi0_min = float(np.min(np.asarray(bank_psi0)))
        psi0_max = float(np.max(np.asarray(bank_psi0)))
        if psi0_min < 0.0 or psi0_max >= 2.0 * np.pi:
            raise ValueError(
                f"template bank psi0 outside [0, 2pi) (min {psi0_min:.3g}, "
                f"max {psi0_max:.3g}): fold the bank through normalize_psi0 first"
            )
    span_periods = psi0_max / (2.0 * np.pi) + geom.n_unpadded * geom.dt / float(np.min(P))
    if span_periods > geom.lut_tiles - 2:
        raise ValueError(
            f"search phase spans {span_periods:.0f} LUT periods, beyond the "
            f"geometry's bound ({geom.lut_tiles}); rebuild SearchGeometry with "
            "lut_tiles_for_bank(P, psi0, n, dt) (or use use_lut=False for P_orb below milliseconds)"
        )


def bank_params_host(P, tau, psi0, dt) -> tuple[np.ndarray, ...]:
    """Per-template float32 ``(tau, Omega, psi0, S0)`` derived as the
    reference driver does (``demod_binary.c:1208-1238``): float casts,
    ``Omega = 2*pi/P`` in double narrowed once, ``S0 = tau * sinf(psi0) *
    step_inv`` as an all-float32 chain through glibc's sinf."""
    tau32 = np.asarray(tau, dtype=np.float32)
    psi32 = np.asarray(psi0, dtype=np.float32)
    P32 = np.asarray(P, dtype=np.float32)
    step_inv = np.float32(1.0) / np.float32(dt)
    omega = (np.float64(2.0) * np.pi / P32.astype(np.float64)).astype(np.float32)
    s0 = ((tau32 * libm_sinf_array(psi32)).astype(np.float32) * step_inv).astype(np.float32)
    return tau32, omega, psi32, s0


def upload_bank(params: tuple[np.ndarray, ...], batch_size: int, device="cuda") -> torch.Tensor:
    """The whole bank resident on ``device`` as float32[capacity, 4] rows
    (tau, omega, psi0, S0), padded past ``n + batch_size`` with the
    harmless template (0, 1, 0, 0) so every batch slice stays in range;
    padded slots are masked out by the step."""
    n = len(params[0])
    cap = n + int(batch_size)
    rows = np.tile(np.array([0.0, 1.0, 0.0, 0.0], dtype=np.float32), (cap, 1))
    rows[:n] = np.stack([np.asarray(a, dtype=np.float32) for a in params], axis=1)
    return torch.from_numpy(rows).to(resolve_device(device))


def init_state(geom: SearchGeometry, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed (M, T): float32 and int32 [5, W] phase-major."""
    dev = resolve_device(device)
    W = state_width(geom.fund_hi)
    return (
        torch.zeros((5, W), dtype=torch.float32, device=dev),
        torch.zeros((5, W), dtype=torch.int32, device=dev),
    )


def state_to_natural(arr, geom: SearchGeometry) -> np.ndarray:
    """Phase-major (5, W) M or T -> natural bin order (5, fund_hi) on the host."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    return to_natural_order(arr, geom.fund_hi)


def state_from_natural(arr: np.ndarray, geom: SearchGeometry) -> np.ndarray:
    """Natural bin order (5, fund_hi) -> phase-major (5, W) on the host."""
    return from_natural_order(np.asarray(arr), geom.fund_hi)


def state_from_jax(M, T, device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """The reference package's (M, T) state (arrays of any kind numpy
    accepts, same phase-major layout) as the port's tensors on ``device``."""
    dev = resolve_device(device)
    return (
        torch.from_numpy(np.array(M, dtype=np.float32)).to(dev),
        torch.from_numpy(np.array(T, dtype=np.int32)).to(dev),
    )


def bank_from_jax(params, device="cuda") -> torch.Tensor:
    """The reference package's bank arrays ``(tau, omega, psi0, S0)`` (from
    its ``bank_params_host`` or ``upload_bank``) as the port's resident
    float32[n, 4] bank on ``device``."""
    cols = [np.asarray(a, dtype=np.float32) for a in params]
    return torch.from_numpy(np.stack(cols, axis=1)).to(resolve_device(device))


# integers below 2**24 are exact in float32, so is a float32 count below it
_EXACT_F32_COUNT = 1 << 24


@scoped("health")
def batch_health_vec(sums: torch.Tensor, valid: torch.Tensor, M_new: torch.Tensor) -> torch.Tensor:
    """Device health scalars of one batch, a float32[4] vector
    ``[nonfinite_batch, nonfinite_state, finite_max, finite_min]``
    (counterpart of the reference package's ``batch_health_vec``, bit for
    bit).

    Computed from the batch's (B, 5, W) summed spectra before the
    max-merge's sentinel mask, the only place a NaN is still visible:
    ``NaN > M`` is false, so poisoned templates never reach (M, T)
    (``runtime/health.py``).  Padded slots are excluded through ``valid``
    (bool[B]); like the reference's, the finite max/min count each
    excluded or non-finite slot as the sentinel (``NEG_SENTINEL`` for the
    max, its negation for the min).  Plain torch reductions, outside any
    kernel, per template row and then over the valid rows, in six passes
    over the sums: the finite count (``1 + x*0`` is 1 where finite, NaN
    elsewhere, summed ignoring NaN), and a copy with the non-finite slots
    at -inf for the max, then at +inf in place for the min.
    ``torch.isfinite`` and boolean sums are avoided on the sums: on an H100
    the direct transcription with them takes 1.9x as long as these passes
    (``PERF.md``, section 6).

    The finite count is a float32 sum of ones, exact only below 2**24
    slots a row (5 * W; production has 1,647,760), so a longer row
    raises ``ValueError``."""
    B = sums.shape[0]
    x = sums.reshape(B, -1)
    row = x.shape[1]
    if row >= _EXACT_F32_COUNT:
        raise ValueError(f"batch_health_vec counts in float32: {row} slots a row, the limit is {_EXACT_F32_COUNT - 1}")
    inf = float("inf")
    one = torch.ones((), dtype=x.dtype, device=x.device)
    n_fin = torch.nansum(torch.addcmul(one, x, torch.zeros_like(one)), dim=1).to(torch.int64)
    m = torch.nan_to_num(x, nan=-inf, posinf=-inf, neginf=-inf)
    hi = m.amax(dim=1)
    lo = m.nan_to_num_(neginf=inf).amin(dim=1)
    del m
    fmax = torch.where(valid, hi, -inf).amax()
    fmin = torch.where(valid, lo, inf).amin()
    excluded = (~valid | (n_fin < row)).any()
    fmax = torch.where(excluded, torch.clamp(fmax, min=NEG_SENTINEL), fmax)
    fmin = torch.where(excluded, torch.clamp(fmin, max=-NEG_SENTINEL), fmin)
    nf_batch = ((row - n_fin) * valid).sum()
    nf_state = (~torch.isfinite(M_new)).sum()
    return torch.stack([nf_batch.to(torch.float32), nf_state.to(torch.float32), fmax, fmin])


def erp_precision() -> str:
    """The ``ERP_PRECISION`` spectrum-path precision: ``f32`` (the default
    and the only mode there is).  ``bf16`` raises ``NotImplementedError``
    and any other value ``ValueError``, as in the reference package, where
    ``bf16`` is reserved for a reduced-precision path neither package has.
    A command-line or served run reads it in ``Session._prepare``, before
    its first launch or cuFFT plan; :class:`BankStep` reads it for the
    callers that build a step without a ``Session``; and
    :func:`step_cache_key` folds it in, as the reference package's key
    does."""
    v = os.environ.get("ERP_PRECISION", "f32").strip().lower()
    if v == "f32":
        return v
    if v == "bf16":
        raise NotImplementedError(
            "ERP_PRECISION=bf16 is reserved for a reduced-precision spectrum path that does not exist; "
            "only f32 is implemented — unset ERP_PRECISION or set it to f32"
        )
    raise ValueError(f"ERP_PRECISION must be 'f32' or 'bf16', got {v!r}")


class BankStep(nn.Module):
    """One batch of the search: slice the resident bank at ``t_offset``,
    resample (kernel A), FFT-prep (kernel B), rfft, power + fold (kernel C
    on the complex spectrum), and merge the batch into the (M, T) state in
    place.  Each stage runs under its ``runtime/devicecost.py`` scope.

    ``bank`` is the float32[capacity, 4] resident bank (:func:`upload_bank`
    or :func:`bank_from_jax`) with capacity >= n_total + batch_size.
    ``mean`` (float32[capacity], optional) is the resident pad mean of
    every template, computed ahead (:func:`run_bank`); without it an
    unwhitened step (``geom.exact_mean``) computes its batch's exact means
    itself.  With ``with_health`` the step also returns the batch's
    :func:`batch_health_vec`, for ``runtime/health.py``'s watchdog; without
    it, it launches nothing more."""

    def __init__(
        self, geom: SearchGeometry, bank: torch.Tensor, batch_size: int, state=None, mean=None,
        with_health: bool = False,
    ):
        super().__init__()
        erp_precision()  # for the callers that build a step without a Session (tools/, parallel/)
        self.geom = geom
        self.batch_size = int(batch_size)
        self.with_health = bool(with_health)
        self.register_buffer("bank", bank)
        self.register_buffer("mean", mean)
        if state is None:
            state = init_state(geom, bank.device)
        self.register_buffer("M", state[0])
        self.register_buffer("T", state[1])

    @torch.no_grad()
    def forward(self, ts: torch.Tensor, t_offset: int, n_total: int):
        g = self.geom
        B = self.batch_size
        if t_offset + B > self.bank.shape[0]:
            raise ValueError("bank capacity too small for this batch: pad it by batch_size")
        with stage_scope("bank-slice"):
            p = self.bank[t_offset : t_offset + B]
            mean = None if self.mean is None else self.mean[t_offset : t_offset + B]
        x = fftprep_series(
            ts, p[:, 0], p[:, 1], p[:, 2], p[:, 3],
            nsamples=g.nsamples, n_unpadded=g.n_unpadded, dt=g.dt, exact_mean=g.exact_mean, mean=mean,
            exact_sin=not g.use_lut,
        )
        with stage_scope("fft"):
            F = planned_fft(torch.fft.rfft, x)
        del x
        with stage_scope("sumspec"):
            sums = sumspec_spectrum(F, nsamples=g.nsamples, fund_hi=g.fund_hi, harm_hi=g.harm_hi)
        del F  # sums: (B, 5, W)
        valid = self.merge(sums, t_offset, n_total)
        if not self.with_health:
            return self.M, self.T
        return self.M, self.T, batch_health_vec(sums, valid, self.M)

    @torch.no_grad()
    def merge(self, sums: torch.Tensor, t_offset: int, n_total: int) -> torch.Tensor:
        """Merge a batch's (B, 5, W) sums of templates ``t_offset`` on into
        the (M, T) state in place: slots at or past ``n_total`` masked to
        the sentinel, the batch's max and its first argmax, kept where they
        beat M (ties keep the earlier template).  Returns the valid-slot
        mask, bool[B]."""
        with stage_scope("merge"):
            valid = torch.arange(t_offset, t_offset + sums.shape[0], device=sums.device) < n_total
            masked = torch.where(valid[:, None, None], sums, torch.full_like(sums[:1], NEG_SENTINEL))
            bmax = masked.amax(dim=0)
            barg = masked.argmax(dim=0).to(torch.int32)  # first index of the max in the batch
            better = bmax > self.M
            self.M.copy_(torch.where(better, bmax, self.M))
            self.T.copy_(torch.where(better, barg + t_offset, self.T))
        return valid


def template_sumspec(ts: torch.Tensor, P: float, tau: float, psi0: float, geom: SearchGeometry) -> torch.Tensor:
    """One template's float32[5, W] phase-major run maxima over the
    series ``ts``, through the batch step's operations at T = 1: kernel A's
    single-template launch (counted ``resample_t1``, or
    ``resample_t1_exact`` where ``not geom.use_lut``), the exact mean where
    ``geom.exact_mean``, kernel B, a batch-1 rfft and kernel C.  The
    counterpart of the reference package's ``template_sumspec_fn``: the
    sentinel probe's device search (``runtime/health.py``)."""
    p = torch.from_numpy(np.stack(bank_params_host([P], [tau], [psi0], geom.dt), axis=1)).to(ts.device)
    x = fftprep_series(
        ts, p[:, 0], p[:, 1], p[:, 2], p[:, 3],
        nsamples=geom.nsamples, n_unpadded=geom.n_unpadded, dt=geom.dt, exact_mean=geom.exact_mean,
        exact_sin=not geom.use_lut,
    )
    with stage_scope("fft"):
        F = planned_fft(torch.fft.rfft, x)
    with stage_scope("sumspec"):
        return sumspec_spectrum(F, nsamples=geom.nsamples, fund_hi=geom.fund_hi, harm_hi=geom.harm_hi)[0]


def step_cache_key(geom: SearchGeometry, batch_size: int, device) -> tuple:
    """Residency key of a batch step: two searches with equal keys run the
    same kernels on the same transform, so the second needs no kernel
    build and no new cuFFT plan.  It folds in everything :class:`BankStep`
    and :func:`run_bank` read besides their operands: the geometry (a
    frozen dataclass of scalars, hashable, with ``exact_mean`` and
    ``use_lut``: the exact-sine kernels are another instantiation), the batch
    (the R2C plan is of (batch, nsamples)) and the device (plans are per
    card), and the ``ERP_PRECISION`` mode (:func:`erp_precision`, which
    raises for a mode that no step runs).  The health vector is not in it:
    it is eager reductions over the sums, with no build and no plan of its
    own."""
    return ("erp-torch-bank-step/1", geom, int(batch_size), str(resolve_device(device)), erp_precision())


def warm_step(geom: SearchGeometry, batch_size: int, device="cuda") -> None:
    """Make what a search of ``geom`` at ``batch_size`` needs before its
    first workunit: build and load every kernel library (on a card, at the
    first kernel launch), plan cuFFT's R2C of (batch, nsamples) by one
    :class:`BankStep` on zero operands of the production shapes, take the
    exact mean once where ``geom.exact_mean``, and otherwise (whitened
    runs) warm whitening (``ops/whiten.py::warm``).  On a card it also
    plans the rescoring's float64 R2C of (nsamples,)
    (``oracle/spectrum.py::power_at_on_device``)."""
    dev = resolve_device(device)
    B = int(batch_size)
    ts = torch.zeros(geom.n_unpadded, dtype=torch.float32, device=dev)
    params = bank_params_host(np.full(B, 1000.0), np.full(B, 0.01), np.zeros(B), geom.dt)
    bank = upload_bank(params, B, dev)
    mean = None
    if geom.exact_mean:
        mean = torch.zeros(bank.shape[0], dtype=torch.float32, device=dev)
        mean[:B] = exact_mean_params(
            ts, bank[:B], n_unpadded=geom.n_unpadded, dt=geom.dt, exact_sin=not geom.use_lut
        )[1]
    else:
        from ..ops.whiten import warm

        warm(geom.nsamples, dev)
    BankStep(geom, bank, B, mean=mean)(ts, 0, B)
    if dev.type == "cuda":
        planned_fft(torch.fft.rfft, torch.zeros(geom.nsamples, dtype=torch.float64, device=dev))
        torch.cuda.synchronize(dev)


def run_bank(
    ts: torch.Tensor,
    bank_P: np.ndarray,
    bank_tau: np.ndarray,
    bank_psi0: np.ndarray,
    geom: SearchGeometry,
    batch_size: int = 16,
    state=None,
    start_template: int = 0,
    stop_template: int | None = None,
    progress_cb=None,
    snapshot=None,
    recover: bool = True,
    step_cache=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Search templates ``[start_template, stop_template)`` of the bank
    over the time series ``ts`` (float32[n_unpadded], on the device the
    search runs on), merging into ``state`` (zeroed when None); returns
    the (M, T) state.  T holds global template indices.

    ``progress_cb(done, total, M, T)`` runs after each batch with the live
    state; it must read what it needs before it returns, since the next
    batch overwrites the state in place.  A ``False`` from it stops the
    loop after that batch.

    On unwhitened runs (``geom.exact_mean``) the exact pad means of the
    templates still to search are computed first, in one launch, and stay
    resident beside the bank; the padded slots past ``n_stop`` keep 0.0
    (they are masked).

    Failures classified transient (``runtime/resilience.py``) re-enter
    the loop from the last host snapshot instead of ending the run,
    spending from the per-run retry budget: a device OOM halves the batch
    (after the failed attempt's cached memory and cuFFT plans are
    released), anything else retries.  ``snapshot`` (a
    ``resilience.DispatchSnapshot`` of ``state`` at ``start_template``) is
    the recovery point; the caller refreshes it where it already waits on
    the card (``runtime/session.py``), and without one the loop restarts
    from ``state`` as given.  The (M, T) written does not depend on the
    batch: the merge keeps the earliest template on ties.
    ``ERP_RETRY_BUDGET=0`` or ``recover=False`` runs one attempt.

    ``step_cache`` (``runtime/scheduler.StepCache``) is told the attempt's
    :func:`step_cache_key`, and counts a hit or a miss.

    With ``ERP_HEALTH_EVERY`` set (``runtime/health.py``) each batch also
    returns its health vector; the watchdog checks the pending vectors
    every that many templates and at the end, where the loop waits on the
    card."""
    from ..runtime import flightrec, resilience

    validate_bank_bounds(geom, bank_P, bank_tau, bank_psi0)
    dev = ts.device
    n = len(bank_P)
    n_stop = n if stop_template is None else min(n, int(stop_template))
    params = bank_params_host(bank_P, bank_tau, bank_psi0, geom.dt)
    ts = ts.contiguous()
    mean = None
    if geom.exact_mean and start_template < n_stop:
        rows = upload_bank(params, 0, dev)[start_template:n_stop]
        with stage_scope("serial_mean"):
            mean = (
                start_template,
                exact_mean_params(ts, rows, n_unpadded=geom.n_unpadded, dt=geom.dt, exact_sin=not geom.use_lut)[1],
            )
        del rows
    attempt = dict(
        ts=ts, params=params, geom=geom, n=n, n_stop=n_stop, mean=mean, progress_cb=progress_cb, step_cache=step_cache
    )
    pol = resilience.policy() if recover else None
    if pol is None:
        return _run_bank_attempt(batch_size=batch_size, state=state, start=start_template, **attempt)
    snap = snapshot if snapshot is not None else resilience.DispatchSnapshot(state, start_template)
    ladder = resilience.DegradationLadder(pol, batch_size)
    cur_state, cur_start = state, start_template
    while True:
        try:
            return _run_bank_attempt(batch_size=ladder.batch_size, state=cur_state, start=cur_start, **attempt)
        except Exception as e:
            if not ladder.record_failure("dispatch", e):
                raise
            oom = resilience.is_oom(e)
        # out of the except block: the failed attempt's frames (and their
        # tensors) are gone, so their memory can go back to the card
        if oom:
            resilience.release_device_memory()
        ladder.sleep()
        host_state, cur_start = snap.restore()
        # copies: the attempt updates (M, T) in place, the snapshot stays as taken
        cur_state = None if host_state is None else tuple(torch.tensor(a, device=dev) for a in host_state)
        flightrec.record("redispatch", start=cur_start, batch_size=ladder.batch_size, attempt=ladder.attempt)


def _run_bank_attempt(ts, params, geom, n, n_stop, mean, progress_cb, step_cache, batch_size, state, start):
    """One pass of the dispatch loop over ``[start, n_stop)`` at
    ``batch_size``: upload the bank, then one :class:`BankStep` per batch.
    The loop never waits on the card: the stream queues ahead, and only a
    ``progress_cb`` that copies the state to the host, or the health
    watchdog's cadence check, synchronizes.  Each
    batch is bracketed for the metrics, the trace, the flight recorder,
    the watchdog (``dispatch``: the enqueue, the first one with the kernel
    build and the cuFFT plan) and the fault points ``h2d`` and
    ``dispatch``, under the JAX package's names."""
    from ..runtime import faultinject, flightrec, metrics, steptime, tracing, watchdog
    from ..runtime.health import watchdog as health_watchdog

    dev = ts.device
    # numerical health (runtime/health.py): None unless ERP_HEALTH_EVERY is
    # set, and then the step launches exactly what it launches without it
    wd = health_watchdog()
    if step_cache is not None:
        step_cache.touch(step_cache_key(geom, batch_size, dev))
    faultinject.fault_point("h2d", loop="run_bank")
    bank = upload_bank(params, batch_size, dev)
    mean_dev = None
    if mean is not None:
        mean_dev = torch.zeros(bank.shape[0], dtype=torch.float32, device=dev)
        mean_dev[mean[0] : n_stop] = mean[1]
    step = BankStep(geom, bank, batch_size, state=state, mean=mean_dev, with_health=wd is not None)

    # bound once outside the loop: shared no-op nulls when disabled
    m_batches = metrics.counter("search.batches")
    m_templates = metrics.counter("search.templates")
    m_dispatch_s = metrics.counter("search.dispatch_wall_s", unit="s")
    m_dispatch_ms = metrics.histogram("search.dispatch_ms", metrics.LATENCY_BUCKETS_MS, unit="ms")
    metrics.counter("search.h2d_bytes", unit="B").inc(bank.nbytes)
    # the exact means are computed ahead on the card and never waited for:
    # the JAX package's prefetch wait is 0 here
    metrics.counter("search.prefetch_wait_s", unit="s")
    st = steptime.recorder(dev)
    for start_b in range(start, n_stop, batch_size):
        stop = min(start_b + batch_size, n_stop)
        tracing.new_context()
        st.begin()
        t0 = time.perf_counter()
        with watchdog.guard("dispatch", start=start_b, stop=stop):
            faultinject.fault_point("dispatch", start=start_b, stop=stop)
            with tracing.span("dispatch", start=start_b, stop=stop):
                # templates past n_stop are masked like the padding of a last batch
                out = step(ts, start_b, n_stop)
                if wd is not None:
                    wd.push(start_b, stop, out[2])
        dt = time.perf_counter() - t0
        st.observe(step.M, start_b, stop)
        m_dispatch_s.inc(dt)
        m_dispatch_ms.observe(dt * 1e3)
        m_batches.inc()
        m_templates.inc(stop - start_b)
        flightrec.record("dispatch", start=start_b, stop=stop, ms=round(dt * 1e3, 3))
        flightrec.note_dispatch(loop="run_bank", start=start_b, stop=stop, n_total=n, batch_size=batch_size)
        if wd is not None:
            # the cadence check copies the pending vectors to the host: the
            # loop's one wait on the card, every ERP_HEALTH_EVERY templates
            wd.maybe_check("run_bank")
        if progress_cb is not None and progress_cb(stop, n, step.M, step.T) is False:
            break
    if wd is not None:
        wd.check("run_bank")
    st.flush()
    return step.M, step.T
