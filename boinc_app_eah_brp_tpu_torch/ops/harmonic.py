"""Harmonic summing: the 16-harmonic fold into five run-max levels.

Counterpart of the reference package's ``ops/harmonic.py`` and
``ops/pallas_sumspec.py``.  For spectrum index ``i = 16q + r`` multiplier
``l`` reads ``ps[(i*l + 8) >> 4] = ps[l*q + off_l(r)]``; the 16 phase rows
``r`` of the running sums are accumulated in the reference order
``_ACCUM_ORDER`` (``hs_common.c:78-148``), each level's new terms summed
left to right and then added as one group, and reduced to per-bin run
maxima.  Results are stored phase-major, a (5, W) row per template: level
k's phase p occupies ``[p*Q_k, (p+1)*Q_k)`` (see :func:`level_layout`).

Kernel C (``csrc/fold.cu``) does the whole fold of a template batch in one
launch, through two entries: :func:`sumspec_batch` folds float32 power
spectra, :func:`sumspec_spectrum` folds straight from the complex rfft
output and forms the power in the kernel, so the search never holds the
batch's float spectra.  :func:`sumspec_batch_plain` is the plain PyTorch
version, transcribed from ``_harmonic_sumspec_impl``, and
:func:`sumspec_spectrum_plain` puts :func:`~.spectrum.power_from_rfft`
before it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .spectrum import power_from_rfft

# C accumulation order across harmonic levels (hs_common.c:78-148)
_ACCUM_ORDER = [16, 8, 12, 4, 14, 10, 6, 2, 15, 13, 11, 9, 7, 5, 3, 1]

FOLD_COLS = 255  # output columns per kernel-C tile (csrc/fold.cu kCols)


def level_layout(fund_hi: int) -> list[tuple[int, int]]:
    """Per harmonic level k = 0..4: (n_phases, Q_k) of the phase-major
    storage.  Level k's row is ``n_ph * Q_k`` long (>= fund_hi; the tail
    slots are junk bins >= fund_hi, dropped by ``to_natural_order``)."""
    out = []
    for k in range(5):
        n_ph = 1 if k == 0 else 16 >> k
        out.append((n_ph, -(-fund_hi // n_ph)))
    return out


def state_width(fund_hi: int) -> int:
    """Row width of the phase-major (5, W) sumspec/maxima state."""
    return max(n_ph * q for n_ph, q in level_layout(fund_hi))


def row_to_natural(row: np.ndarray, k: int, fund_hi: int) -> np.ndarray:
    """One phase-major level row -> natural bin order."""
    n_ph, q = level_layout(fund_hi)[k]
    row = np.asarray(row)
    return row[: n_ph * q].reshape(n_ph, q).T.reshape(-1)[:fund_hi]


def to_natural_order(arr: np.ndarray, fund_hi: int) -> np.ndarray:
    """(5, W) phase-major -> (5, fund_hi) natural bin order."""
    arr = np.asarray(arr)
    out = np.empty((5, fund_hi), dtype=arr.dtype)
    for k in range(5):
        out[k] = row_to_natural(arr[k], k, fund_hi)
    return out


def from_natural_order(arr: np.ndarray, fund_hi: int) -> np.ndarray:
    """Inverse of :func:`to_natural_order`; pad slots are zero, which can
    never win a max-merge of nonnegative powers."""
    arr = np.asarray(arr)
    out = np.zeros((5, state_width(fund_hi)), dtype=arr.dtype)
    for k, (n_ph, q) in enumerate(level_layout(fund_hi)):
        row = np.zeros(n_ph * q, dtype=arr.dtype)
        row[:fund_hi] = arr[k]
        out[k, : n_ph * q] = row.reshape(n_ph, q, order="F").reshape(-1)
    return out


def _phase_major_upsample(ps: torch.Tensor, l: int, Q: int) -> list[torch.Tensor]:
    """16 rows (T, Q): ``row[r][:, q] = ps[:, (i*l + 8) >> 4]`` at
    ``i = 16q + r``; indices past the spectrum read 0."""
    T, L = ps.shape
    need = l * (Q + 1)
    ps_pad = torch.nn.functional.pad(ps, (0, max(0, need - L)))[:, :need]
    D = ps_pad.reshape(T, Q + 1, l).transpose(1, 2)  # D[:, c, q] = ps[:, l*q + c]
    rows = []
    for r in range(16):
        c = (l * r + 8) >> 4
        rows.append(D[:, c, :Q] if c < l else D[:, 0, 1 : Q + 1])
    return rows


def _rows_max(rows: list[torch.Tensor]) -> torch.Tensor:
    out = rows[0]
    for r in rows[1:]:
        out = torch.maximum(out, r)
    return out


def sumspec_batch_plain(ps: torch.Tensor, *, fund_hi: int, harm_hi: int) -> torch.Tensor:
    """Plain version of kernel C: float32[T, 5, W] phase-major run maxima
    of the 1/2/4/8/16-harmonic sums of the spectra ``ps[T, L]``."""
    T = ps.shape[0]
    Q = max(-(-harm_hi // 16), fund_hi)
    W = state_width(fund_hi)
    out = ps.new_zeros((T, 5, W))
    out[:, 0, :fund_hi] = ps[:, :fund_hi]
    running = _phase_major_upsample(ps, 16, Q)
    q_idx = torch.arange(Q, dtype=torch.int64, device=ps.device) * 16
    valid = [q_idx + r < harm_hi for r in range(16)]
    zero = torch.zeros((), dtype=ps.dtype, device=ps.device)
    for k in range(1, 5):
        L = 16 >> k
        new_ls = [l for l in _ACCUM_ORDER if l % L == 0 and l % (L * 2) != 0]
        terms = {l: _phase_major_upsample(ps, l, Q) for l in new_ls}
        for r in range(16):
            level = None
            for l in new_ls:
                level = terms[l][r] if level is None else level + terms[l][r]
            running[r] = running[r] + level
        masked = [torch.where(valid[r], running[r], zero) for r in range(16)]
        m = 1 << k
        h = m >> 1
        n_ph = 16 // m
        Qk = -(-fund_hi // n_ph)
        for p in range(n_ph):
            lo = m * p - h
            hi = m * p + h
            if lo < 0:
                prev = _rows_max([r[:, :Qk] for r in masked[16 + lo :]])
                prev = torch.nn.functional.pad(prev[:, :-1], (1, 0))
                v = torch.maximum(prev, _rows_max([r[:, :Qk] for r in masked[:hi]]))
            else:
                v = _rows_max([r[:, :Qk] for r in masked[lo:hi]])
            out[:, k, p * Qk : (p + 1) * Qk] = v
    return out


def _fold_read(L: int, W: int) -> int:
    """Spectrum prefix that the fold of W columns reads: 16W + 16 bins,
    or the whole spectrum when it is shorter."""
    return min(L, 16 * W + 16)


def _fold_launch_checks(x: torch.Tensor, dtype, what: str) -> None:
    if x.dtype != dtype or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype}[T, L] tensor")
    if x.shape[0] < 1:
        raise ValueError("empty template batch")


def _fold_library():
    lib = kernels.library("fold")
    if lib.erp_fold_cols() != FOLD_COLS:
        raise RuntimeError("kernel C tile width disagrees with FOLD_COLS")
    return lib


def sumspec_batch(ps: torch.Tensor, *, fund_hi: int, harm_hi: int) -> torch.Tensor:
    """Kernel C: float32[T, 5, W] phase-major run maxima of the spectra
    ``ps[T, L]`` (counterpart of ``sumspec_pallas_batch``)."""
    if ps.device.type == "cpu":
        return sumspec_batch_plain(ps, fund_hi=fund_hi, harm_hi=harm_hi)
    if ps.device.type != "cuda":
        raise ValueError(f"unsupported device {ps.device}")
    _fold_launch_checks(ps, torch.float32, "ps")
    T, L = ps.shape
    W = state_width(fund_hi)
    lib = _fold_library()
    dev = ps.device
    out = torch.empty((T, 5, W), dtype=torch.float32, device=dev)
    rc = lib.erp_fold(
        dev.index, kernels.stream_handle(dev), ps.data_ptr(), out.data_ptr(),
        T, L, _fold_read(L, W), fund_hi, harm_hi, W,
    )
    kernels.check(rc, "fold kernel launch")
    kernels.launch_counts["fold"] += 1
    return out


def sumspec_spectrum_plain(
    F: torch.Tensor, *, nsamples: int, fund_hi: int, harm_hi: int
) -> torch.Tensor:
    """Plain version of kernel C on complex input: :func:`sumspec_batch_plain`
    of the power spectra of ``F[T, L]`` (:func:`~.spectrum.power_from_rfft`)."""
    return sumspec_batch_plain(
        power_from_rfft(F, nsamples=nsamples), fund_hi=fund_hi, harm_hi=harm_hi
    )


def sumspec_spectrum(
    F: torch.Tensor, *, nsamples: int, fund_hi: int, harm_hi: int
) -> torch.Tensor:
    """Kernel C on the complex rfft output ``F`` (complex64[T, L],
    ``nsamples``-point transforms): float32[T, 5, W] phase-major run maxima
    of the power spectra, which exist only in a reused scratch of the
    spectrum prefix that the fold reads."""
    if F.device.type == "cpu":
        return sumspec_spectrum_plain(F, nsamples=nsamples, fund_hi=fund_hi, harm_hi=harm_hi)
    if F.device.type != "cuda":
        raise ValueError(f"unsupported device {F.device}")
    _fold_launch_checks(F, torch.complex64, "F")
    T, L = F.shape
    W = state_width(fund_hi)
    read = _fold_read(L, W)
    lib = _fold_library()
    dev = F.device
    # two power slots: the kernel converts template t+1 while it folds t
    scratch = torch.empty(2 * read, dtype=torch.float32, device=dev)
    out = torch.empty((T, 5, W), dtype=torch.float32, device=dev)
    rc = lib.erp_fold_spectrum(
        dev.index, kernels.stream_handle(dev), F.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        T, L, read, fund_hi, harm_hi, W, float(np.float32(1.0 / nsamples)),
    )
    kernels.check(rc, "fold kernel launch (complex input)")
    kernels.launch_counts["fold_spectrum"] += 1
    return out
