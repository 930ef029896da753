"""The toplist, the false-alarm figures and the candidate file, for the
judge, written from the C's own procedure (``demod_binary.c``) and the
closed form of the chi-squared tail; nothing here comes from the program.

* :func:`tail`: the chi-squared upper tail with 2n degrees of freedom at
  2p, which is the upper tail of a Gamma(n) at p, in its closed form
  ``e^-p * (1 + p (1 + p/2 (1 + ... (1 + p/(n-1)))))``, in double.
* :func:`false_alarm`: ``fA = -log10`` of that tail (``:1501-1552``); a
  tail of 0 reads 320.  Below about 1e-300 the double a library returns
  is its own: the closed form is 0 once ``e^-p`` is (p > 745.13).
* :func:`thresholds`: the static part of ``thrA`` (``:1268-1282``): for
  each level the p whose tail is the single-bin probability, by
  bisection.
* :class:`Toplist`: the toplist as the C runs it, template after template
  in bank order (``:1310-1397``): five blocks of 100 entries sorted by
  power; a bin enters a block when its power beats the template's
  threshold (the larger of the static part and the block's weakest power
  when the template starts) and the block's weakest entry as it is then;
  an entry of the same bin is replaced only by a larger power, otherwise
  the weakest entry makes room.
* :func:`emit`: the output stage (``:1554-1671``): every entry's fA and
  its power in units of sigma, then the entries in order of fA, power
  and bin, descending, at most 100 of them, none with fA <= 0 and no bin
  twice.

And a parser of the candidate file (``:1557-1685``).
"""

from __future__ import annotations

import math

import numpy as np

BLOCK = 100  # entries a level keeps
LEVELS = 5  # 1, 2, 4, 8 and 16 harmonics
LINES = 100  # lines the output stage writes at most
FA_UNDERFLOW = 320.0
ROW_DTYPE = np.dtype(
    [("power", "<f8"), ("P_b", "<f8"), ("tau", "<f8"), ("Psi", "<f8"), ("fA", "<f8"), ("n_harm", "<u4"), ("f0", "<u4"),
     ("t", "<i8")]
)


def tail(p: float, n: int) -> float:
    """P(Gamma(n) > p), which is Q_chi2(2p; 2n), as a double."""
    if p <= 0.0:
        return 1.0
    s = 1.0
    for j in range(n - 1, 0, -1):
        s = 1.0 + p / j * s
    return min(1.0, float(np.exp(np.float64(-p))) * s)


def false_alarm(power: float, n_harm: int) -> float:
    """fA of a summed power over ``n_harm`` harmonics."""
    q = tail(float(power), int(n_harm))
    return -math.log10(q) if q > 0.0 else FA_UNDERFLOW


def thresholds(fA: float, fft_size: int) -> np.ndarray:
    """float32[5]: the power whose tail over 2^k harmonics is the
    single-bin probability ``1 - (1 - fA)^(1/fft_size)`` (a float)."""
    prob = float(np.float32(1.0 - math.pow(1.0 - fA, 1.0 / fft_size)))
    out = np.empty(LEVELS, dtype=np.float32)
    for k in range(LEVELS):
        n = 1 << k
        lo, hi = 0.0, float(n)
        while tail(hi, n) > prob:
            hi *= 2.0
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if mid in (lo, hi):
                break
            if tail(mid, n) > prob:
                lo = mid
            else:
                hi = mid
        out[k] = np.float32(0.5 * (lo + hi))
    return out


class Toplist:
    """The five blocks as the search fills them, template by template.
    An entry is ``[power, template, bin]``; each block is sorted by power,
    the strongest first."""

    def __init__(self, static: np.ndarray):
        self.static = [float(v) for v in static]
        self.blocks: list[list] = [[] for _ in range(LEVELS)]
        self._bins: list[dict] = [{} for _ in range(LEVELS)]

    def weakest(self, k: int) -> float:
        b = self.blocks[k]
        return b[-1][0] if len(b) == BLOCK else 0.0

    def threshold(self, k: int) -> float:
        """Level ``k``'s threshold for the next template."""
        return max(self.static[k], self.weakest(k))

    def template(self, t: int, hits) -> None:
        """Offer template ``t``'s bins: ``hits[k]`` is (bins ascending,
        powers) of level k, every bin whose power may beat the template's
        threshold."""
        for k in range(LEVELS):
            thr = self.threshold(k)
            bins, powers = hits[k]
            for f0, power in zip(bins, powers):
                self._offer(k, t, int(f0), float(power), thr)

    def _offer(self, k: int, t: int, f0: int, power: float, thr: float) -> None:
        if not (power > thr and power > self.weakest(k)):
            return
        block, where = self.blocks[k], self._bins[k]
        old = where.get(f0)
        if old is not None:
            if old[0] >= power:
                return
            old[0], old[1] = power, t
        else:
            if len(block) == BLOCK:
                del where[block.pop()[2]]
            entry = [power, t, f0]
            block.append(entry)
            where[f0] = entry
        block.sort(key=lambda e: -e[0])

    def entries(self):
        """(level, power, template, bin) of every kept entry."""
        return [(k, e[0], e[1], e[2]) for k in range(LEVELS) for e in self.blocks[k]]


def emit(entries, bank) -> np.ndarray:
    """The output stage over ``entries`` (level, summed power, template,
    bin): the written rows in order, each with its power in units of
    sigma (the sum over the square root of its harmonics), its fA and
    its template ``t``; ``bank`` is (P, tau, psi), written as floats."""
    P, tau, psi = bank
    rows = []
    for k, power, t, f0 in entries:
        n = 1 << k
        rows.append((false_alarm(power, n), power / math.sqrt(n), f0, n, t))
    rows.sort(key=lambda r: (-r[0], -r[1], -r[2]))
    out, seen = [], set()
    for fa, power, f0, n, t in rows:
        if len(out) == LINES or fa <= 0.0:
            break
        if f0 in seen:
            continue
        seen.add(f0)
        out.append((power, float(np.float32(P[t])), float(np.float32(tau[t])), float(np.float32(psi[t])), fa, n, f0, t))
    return np.array(out, dtype=ROW_DTYPE)


def parse_candidates(text: str, t_obs: float) -> np.ndarray | None:
    """The candidate lines of a file's text as rows (``f0`` the bin,
    ``freq * t_obs`` rounded), or None when the file is not whole: no
    ``%DONE%`` last line, or a line without its 7 columns; ``t`` is -1."""
    lines = text.splitlines()
    if not lines or lines[-1] != "%DONE%":
        return None
    rows = [ln.split() for ln in lines[:-1] if ln and not ln.startswith("%")]
    out = np.zeros(len(rows), dtype=ROW_DTYPE)
    for i, cols in enumerate(rows):
        if len(cols) != 7:
            return None
        try:
            freq, P, tau, psi, power, fA = (float(c) for c in cols[:6])
            n_harm = int(cols[6])
        except ValueError:
            return None
        out[i] = (power, P, tau, psi, fA, n_harm, int(round(freq * t_obs)), -1)
    return out
