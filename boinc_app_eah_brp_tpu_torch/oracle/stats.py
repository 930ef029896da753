"""Chi-squared tail statistics used for thresholds and false-alarm rates.

The reference uses GSL (``gsl_cdf_chisq_Q`` / ``gsl_cdf_chisq_Qinv``,
``demod_binary.c:1161-1165,1281,1517``) with even degrees of freedom
``nu = 2 * n_harm`` only. For even nu the survival function has the exact
closed (Erlang) form

    Q(x; 2k) = exp(-x/2) * sum_{j=0}^{k-1} (x/2)^j / j!

which we evaluate directly in float64 — no special-function library needed.
``chisq_Qinv`` inverts it with bisection + Newton; cross-checked against
``scipy.stats.chi2`` in the tests.
"""

from __future__ import annotations

import math

import numpy as np


def chisq_Q(x, nu: int):
    """Upper tail P(X > x) for chi-squared with even nu d.o.f. Vectorized."""
    if nu % 2 or nu <= 0:
        raise ValueError("closed form requires positive even nu")
    k = nu // 2
    x = np.asarray(x, dtype=np.float64)
    half = x / 2.0
    # sum_{j<k} half^j / j! evaluated with a stable recurrence
    term = np.ones_like(half)
    acc = np.ones_like(half)
    for j in range(1, k):
        term = term * half / j
        acc = acc + term
    with np.errstate(over="ignore", under="ignore"):
        out = np.exp(-half) * acc
    # exp underflow -> 0, matching GSL's behaviour for huge x
    return np.where(x < 0, 1.0, np.minimum(out, 1.0))


def chisq_Qinv(q: float, nu: int) -> float:
    """x such that ``chisq_Q(x, nu) == q`` (scalar), like gsl_cdf_chisq_Qinv."""
    if not (0.0 < q < 1.0):
        if q == 1.0:
            return 0.0
        raise ValueError("q must be in (0, 1]")
    k = nu // 2
    # initial bracket: mean +/- generous tails
    lo, hi = 0.0, float(nu)
    while chisq_Q(hi, nu) > q:
        hi *= 2.0
        if hi > 1e8:
            break
    # bisection to decent precision, then Newton polish
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if chisq_Q(mid, nu) > q:
            lo = mid
        else:
            hi = mid
        if hi - lo <= 1e-12 * max(1.0, hi):
            break
    x = 0.5 * (lo + hi)
    # pdf of chi2 with 2k dof: f(x) = x^{k-1} e^{-x/2} / (2^k (k-1)!)
    for _ in range(5):
        fx = float(chisq_Q(x, nu)) - q
        pdf = math.exp((k - 1) * math.log(x) - x / 2.0 - k * math.log(2.0) - math.lgamma(k)) if x > 0 else 0.0
        if pdf <= 0:
            break
        x = x + fx / pdf  # Q' = -pdf; Newton: x -= (Q - q)/Q' = x + (Q - q)/pdf
    return x


def single_bin_prob(fA: float, fft_size: int) -> np.float32:
    """``prob = 1 - (1 - fA)^(1/fft_size)`` as float
    (``demod_binary.c:1274``)."""
    return np.float32(1.0 - math.pow(1.0 - fA, 1.0 / fft_size))


def base_thresholds(fA: float, fft_size: int) -> np.ndarray:
    """float32[5] static part of thrA: ``0.5*Qinv(prob, 2*2^k)``
    (``demod_binary.c:1281``)."""
    prob = float(single_bin_prob(fA, fft_size))
    return np.array(
        [0.5 * chisq_Qinv(prob, 2 * (1 << k)) for k in range(5)], dtype=np.float32
    )
