"""Candidate toplist: the batch formulation over per-bin maxima and the
final output-stage selection (``demod_binary.c:1501-1671``).

The toplist state is the 500-entry ``CP_cand`` array (5 blocks of 100, block
k holding the 2^k-harmonic candidates sorted descending by power).
"""

from __future__ import annotations

import numpy as np

from ..io.formats import CP_CAND_DTYPE, N_CAND, N_CAND_5
from .stats import chisq_Q


def update_toplist_from_maxima(
    candidates_all: np.ndarray,
    max_power: np.ndarray,  # float32[5, fundamental_idx_hi] per-bin maxima
    tmpl_index: np.ndarray,  # int32[5, fundamental_idx_hi] first template achieving max
    bank_P: np.ndarray,
    bank_tau: np.ndarray,
    bank_psi0: np.ndarray,
    base_thr: np.ndarray,
    window_2: int,
) -> np.ndarray:
    """Build the 500-entry toplist from per-bin maxima over all templates.

    This is the batch formulation the search uses. It is provably the same
    final state as running :func:`update_toplist_literal` template by
    template: the sequential algorithm maintains, after each template, the
    top-100 distinct-frequency per-bin maxima above the static threshold —
    the dynamic threshold (weakest kept power) only prunes insertions that
    could never enter the list, and a same-frequency stronger value always
    beats the weakest entry (see analysis in tests/test_toplist.py).
    """
    out = np.zeros(N_CAND, dtype=CP_CAND_DTYPE)
    fund_hi = max_power.shape[1]
    for k in range(5):
        block = out[k * N_CAND_5 : (k + 1) * N_CAND_5]
        vals = max_power[k]
        mask = np.zeros(fund_hi, dtype=bool)
        mask[window_2:] = True
        mask &= vals > base_thr[k]
        bins = np.flatnonzero(mask)
        if len(bins) == 0:
            continue
        # top 100 by power; ties broken toward the lower frequency bin like
        # the sequential fill order would produce for distinct bins
        order = np.lexsort((bins, -vals[bins].astype(np.float64)))[:N_CAND_5]
        sel = bins[order]
        n = len(sel)
        t = tmpl_index[k][sel]
        block["power"][:n] = vals[sel]
        block["P_b"][:n] = np.float32(bank_P[t])
        block["tau"][:n] = np.float32(bank_tau[t])
        block["Psi"][:n] = np.float32(bank_psi0[t])
        block["n_harm"][:n] = 1 << k
        block["f0"][:n] = sel
    return out


_SIGMA = {1: 1.0, 2: np.sqrt(2.0), 4: 2.0, 8: np.sqrt(8.0), 16: 4.0}


def finalize_candidates(candidates_all: np.ndarray, t_obs: float) -> np.ndarray:
    """Final output-stage selection (``demod_binary.c:1501-1671``).

    Computes fA = -log10(chisq_Q(2*power, 2*n_harm)) (capped at 320), scales
    power into units of sigma, sorts by (fA, power, f0) descending and emits
    at most 100 candidates with cross-harmonic frequency dedup. Returns the
    emitted CP_cand records in output order (with scaled power and fA set).
    """
    cands = candidates_all.copy()
    for i in range(N_CAND):
        n_harm = int(cands["n_harm"][i])
        if n_harm in _SIGMA:
            q = float(chisq_Q(2.0 * cands["power"][i], 2 * n_harm))
            cands["fA"][i] = -np.log10(q) if q > 0.0 else 320.0
            cands["power"][i] = cands["power"][i] / _SIGMA[n_harm]
        else:
            cands["fA"][i] = -10.0

    def resort(arr):
        order = np.lexsort((-arr["f0"].astype(np.int64), -arr["power"], -arr["fA"]))
        return arr[order]

    cands = resort(cands)
    emitted = []
    counter = 0
    while counter < N_CAND_5 and cands["fA"][0] > 0.0:
        emitted.append(cands[0].copy())
        counter += 1
        same = cands["f0"] == cands["f0"][0]
        cands["fA"][same] = -10.0
        cands = resort(cands)
    return np.array(emitted, dtype=CP_CAND_DTYPE)
