"""Point evaluation of the reference's harmonic sums (``hs_common.c:33-171``).

For each 16th-harmonic bin ``i`` in ``[window_2, harmonic_idx_hi)`` the
reference adds the power at the 16 positions ``(i*l + 8) >> 4`` (l = 1..16)
and, for 2^k summed harmonics, keeps the maximum of the partial sum over
the run of ``i`` that map to fundamental bin ``j = (i * 16/2^k + 8) >> 4``.
The rescorer (``oracle/rescore.py``) needs only the <= 100 winning
(bin, level) pairs, so this evaluates one pair at a time."""

from __future__ import annotations

import numpy as np

# each level's new multipliers, added left to right as one group to the
# running sum (hs_common.c:78-148); level 0 is ps[i] itself
_LEVELS = [(16,), (8,), (12, 4), (14, 10, 6, 2), (15, 13, 11, 9, 7, 5, 3, 1)]


def _level_sums(ps: np.ndarray, i: np.ndarray, k: int) -> np.ndarray:
    """Partial harmonic sums over 2^k harmonics at summing indices ``i``,
    float32 in the C's association."""
    s = None
    for ls in _LEVELS[: 1 + k]:
        level = None
        for l in ls:
            term = ps[(i * l + 8) >> 4]
            level = term if level is None else (level + term).astype(np.float32)
        s = level if s is None else (s + level).astype(np.float32)
    return s


def _summing_indices(j: int, k: int, window_2: int, harmonic_idx_hi: int) -> np.ndarray:
    """The summing indices ``i`` with ``i*(16>>k) in [16j-8, 16j+7]``
    inside ``[window_2, harmonic_idx_hi)``, for k >= 1."""
    mp = 16 >> k
    lo = -(-(16 * j - 8) // mp)
    hi = (16 * j + 7) // mp
    return np.arange(max(lo, window_2), min(hi + 1, harmonic_idx_hi), dtype=np.int64)


def harmonic_power_at(
    ps: np.ndarray, j: int, k: int, window_2: int, fundamental_idx_hi: int, harmonic_idx_hi: int
) -> np.float32:
    """``sumspec[k][j]``: the run maximum of the level-k sums over the
    summing indices ``i*(16>>k) in [16j-8, 16j+7]`` inside
    ``[window_2, harmonic_idx_hi)``."""
    if not 0 <= j < fundamental_idx_hi:
        return np.float32(0.0)
    if k == 0:
        return np.float32(ps[j])
    i = _summing_indices(j, k, window_2, harmonic_idx_hi)
    if len(i) == 0:
        return np.float32(0.0)
    return np.float32(np.max(_level_sums(ps, i, k)))


def harmonic_bins(j: int, k: int, window_2: int, fundamental_idx_hi: int, harmonic_idx_hi: int) -> np.ndarray:
    """int64: every bin of ``ps`` that :func:`harmonic_power_at` reads for
    the same arguments (with repeats)."""
    if not 0 <= j < fundamental_idx_hi:
        return np.zeros(0, dtype=np.int64)
    if k == 0:
        return np.array([j], dtype=np.int64)
    i = _summing_indices(j, k, window_2, harmonic_idx_hi)
    return np.concatenate([(i * l + 8) >> 4 for ls in _LEVELS[: 1 + k] for l in ls])
