"""GSL-compatible random number generation for RFI zapping.

The reference fills zapped FFT bins with Gaussian noise drawn from GSL's
``taus2`` generator + ``gsl_ran_gaussian_ziggurat``, seeded from the first
four bytes of the unpacked time series (``demod_binary.c:916-918,989-1021``).
Zap noise only lands in known-RFI bins, so scientific results don't depend
on the exact stream — but determinism *across our own runs* does, and
staying close to GSL keeps cross-validation against reference builds
meaningful.

* :class:`Taus2` implements the L'Ecuyer three-component combined Tausworthe
  generator exactly as documented for GSL's ``taus2`` (including the LCG
  seeding procedure with the s1>=2 / s2>=8 / s3>=16 adjustments and the six
  warm-up calls).
* :func:`gaussian_ziggurat` implements the Marsaglia-Tsang ziggurat with the
  same 128-level layout GSL uses (R = 3.44428647676..., same table
  construction); tail and wedge handling follow the published algorithm.
  Bit-exactness with a linked GSL could not be verified in this environment
  (no GSL available) — documented as statistically equivalent, deterministic
  given the seed.
"""

from __future__ import annotations

import math

import numpy as np

_MASK = 0xFFFFFFFF


class Taus2:
    """gsl_rng_taus2: three combined Tausworthe components."""

    def __init__(self, seed: int):
        self.set_seed(seed)

    def set_seed(self, s: int) -> None:
        s &= _MASK
        if s == 0:
            s = 1  # default seed is 1

        def lcg(n: int) -> int:
            return (69069 * n) & _MASK

        s1 = lcg(s)
        if s1 < 2:
            s1 += 2
        s2 = lcg(s1)
        if s2 < 8:
            s2 += 8
        s3 = lcg(s2)
        if s3 < 16:
            s3 += 16
        self.s1, self.s2, self.s3 = s1, s2, s3
        for _ in range(6):  # warm up
            self.get()

    def get(self) -> int:
        """Next uint32."""
        s1, s2, s3 = self.s1, self.s2, self.s3
        s1 = (((s1 & 4294967294) << 12) & _MASK) ^ ((((s1 << 13) & _MASK) ^ s1) >> 19)
        s2 = (((s2 & 4294967288) << 4) & _MASK) ^ ((((s2 << 2) & _MASK) ^ s2) >> 25)
        s3 = (((s3 & 4294967280) << 17) & _MASK) ^ ((((s3 << 3) & _MASK) ^ s3) >> 11)
        self.s1, self.s2, self.s3 = s1, s2, s3
        return s1 ^ s2 ^ s3

    def uniform(self) -> float:
        """U(0,1) with 2^-32 resolution like gsl_rng_uniform on taus2."""
        return self.get() / 4294967296.0


# --- ziggurat tables (Marsaglia & Tsang 2000, 128 levels, GSL layout)
_ZIG_R = 3.44428647676  # gsl gausszig.c PARAM_R
_ZIG_N = 128


def _build_tables():
    v = 9.91256303526217e-3
    x = np.empty(_ZIG_N + 1)
    x[_ZIG_N] = v / math.exp(-0.5 * _ZIG_R * _ZIG_R)
    x[_ZIG_N - 1] = _ZIG_R
    for i in range(_ZIG_N - 2, 0, -1):
        x[i] = math.sqrt(-2.0 * math.log(v / x[i + 1] + math.exp(-0.5 * x[i + 1] * x[i + 1])))
    x[0] = 0.0
    ktab = np.empty(_ZIG_N, dtype=np.uint32)
    wtab = np.empty(_ZIG_N)
    ftab = np.empty(_ZIG_N)
    # GSL uses 24-bit mantissa scaling (generates via 32-bit ints, sign + 24-bit)
    for i in range(_ZIG_N):
        if i == 0:
            ktab[0] = int((_ZIG_R * math.exp(-0.5 * _ZIG_R * _ZIG_R) / v) * 16777216.0)
            wtab[0] = v / math.exp(-0.5 * _ZIG_R * _ZIG_R) / 16777216.0
        else:
            ktab[i] = int((x[i] / x[i + 1]) * 16777216.0)
            wtab[i] = x[i + 1] / 16777216.0
        ftab[i] = math.exp(-0.5 * x[i + 1] * x[i + 1])
    return x, ktab, wtab, ftab


_ZIG_X, _ZIG_K, _ZIG_W, _ZIG_F = _build_tables()


def gaussian_ziggurat(rng: Taus2, sigma: float) -> float:
    """One N(0, sigma) variate via the 128-level ziggurat."""
    while True:
        u = rng.get()
        i = u & 0x7F  # level from low 7 bits
        sign = -1.0 if (u & 0x80) else 1.0
        j = (u >> 8) & 0xFFFFFF  # 24-bit magnitude
        x = j * _ZIG_W[i]
        if j < _ZIG_K[i]:
            break
        if i == 0:
            # tail: x > R
            while True:
                u1 = 1.0 - rng.uniform()
                u2 = rng.uniform()
                xx = -math.log(u1) / _ZIG_R
                yy = -math.log(u2)
                if yy + yy > xx * xx:
                    x = _ZIG_R + xx
                    break
            break
        else:
            # wedge test
            f0 = math.exp(-0.5 * (_ZIG_X[i] * _ZIG_X[i] - x * x))
            f1 = math.exp(-0.5 * (_ZIG_X[i + 1] * _ZIG_X[i + 1] - x * x))
            if f1 + rng.uniform() * (f0 - f1) < 1.0:
                break
    return sign * sigma * x


def gaussian_stream(seed: int, count: int, sigma: float) -> np.ndarray:
    """count N(0, sigma) variates from a fresh taus2(seed) stream."""
    rng = Taus2(seed)
    return np.array([gaussian_ziggurat(rng, sigma) for _ in range(count)], dtype=np.float64)
