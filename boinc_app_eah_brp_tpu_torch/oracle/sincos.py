"""64+1-entry sin/cos lookup table with 2nd-order Taylor interpolation.

NumPy replication of ``erp_utilities.cpp:45-46,147-209`` — the reference's
``sincosLUTLookup``. All arithmetic is float32, same operation order, so the
oracle matches the C code to the last ulp on typical inputs. The LUT
semantics matter: the resampler's nearest-neighbour index depends on this
exact approximation, so "correct" sine values would produce a slightly
different (equally valid, but not identical) candidate set.
"""

from __future__ import annotations

import numpy as np

ERP_SINCOS_LUT_RES = 64  # erp_utilities.h:27
ERP_SINCOS_LUT_RES_F = np.float32(ERP_SINCOS_LUT_RES)
ERP_SINCOS_LUT_RES_F_INV = np.float32(1.0) / ERP_SINCOS_LUT_RES_F
# The reference's 2*pi is the TRUNCATED 7-digit literal 6.283185f
# (erp_utilities.h:31) — one ulp BELOW the correctly-rounded float32 2*pi
# (6.2831855f). The ulp matters: it propagates through phase -> LUT sine
# -> del_t and flips the resampler's nearest-neighbour index at ~0.03% of
# samples (measured 1,301 of 4.2M on the shipped WU), which is the
# dominant source of candidate-power deltas vs the compiled reference.
ERP_TWO_PI = np.float32(6.283185)
ERP_TWO_PI_INV = np.float32(1.0) / ERP_TWO_PI

# The reference ships the table as literals printed with %f (6 decimals,
# erp_utilities.cpp:45-46) rather than recomputing it at runtime. Parsing the
# same literals keeps us bit-identical to the shipped app.
_SIN_SAMPLES_LITERAL = (
    "0.000000 0.098017 0.195090 0.290285 0.382683 0.471397 0.555570 0.634393 "
    "0.707107 0.773010 0.831470 0.881921 0.923880 0.956940 0.980785 0.995185 "
    "1.000000 0.995185 0.980785 0.956940 0.923880 0.881921 0.831470 0.773010 "
    "0.707107 0.634393 0.555570 0.471397 0.382683 0.290285 0.195091 0.098017 "
    "0.000000 -0.098017 -0.195090 -0.290284 -0.382683 -0.471397 -0.555570 "
    "-0.634393 -0.707107 -0.773010 -0.831469 -0.881921 -0.923880 -0.956940 "
    "-0.980785 -0.995185 -1.000000 -0.995185 -0.980785 -0.956940 -0.923880 "
    "-0.881921 -0.831470 -0.773011 -0.707107 -0.634394 -0.555570 -0.471397 "
    "-0.382684 -0.290285 -0.195091 -0.098017 -0.000000"
)
_COS_SAMPLES_LITERAL = (
    "1.000000 0.995185 0.980785 0.956940 0.923880 0.881921 0.831470 0.773010 "
    "0.707107 0.634393 0.555570 0.471397 0.382683 0.290285 0.195090 0.098017 "
    "0.000000 -0.098017 -0.195090 -0.290285 -0.382683 -0.471397 -0.555570 "
    "-0.634393 -0.707107 -0.773010 -0.831470 -0.881921 -0.923880 -0.956940 "
    "-0.980785 -0.995185 -1.000000 -0.995185 -0.980785 -0.956940 -0.923880 "
    "-0.881921 -0.831470 -0.773011 -0.707107 -0.634393 -0.555570 -0.471397 "
    "-0.382684 -0.290285 -0.195090 -0.098017 0.000000 0.098017 0.195090 "
    "0.290285 0.382683 0.471397 0.555570 0.634393 0.707107 0.773010 0.831470 "
    "0.881921 0.923879 0.956940 0.980785 0.995185 1.000000"
)

SIN_SAMPLES = np.array(_SIN_SAMPLES_LITERAL.split(), dtype=np.float32)
COS_SAMPLES = np.array(_COS_SAMPLES_LITERAL.split(), dtype=np.float32)
assert SIN_SAMPLES.shape == (ERP_SINCOS_LUT_RES + 1,)
assert COS_SAMPLES.shape == (ERP_SINCOS_LUT_RES + 1,)


def libm_sinf(x: float) -> np.float32:
    """glibc's float sine, bit-for-bit.

    The reference is C compiled as C++ (its Makefile runs $(CXX) on .c),
    so ``sin(Psi0)`` with a float argument resolves to the FLOAT overload
    — S0 is an all-float32 chain through glibc's sinf
    (demod_binary.c:1230). numpy has no guaranteed-glibc float32 sine, so
    bind the real one; fall back to numpy's (last-ulp differences
    possible) when libm isn't loadable."""
    global _LIBM
    if _LIBM is None:
        import ctypes

        try:
            lib = ctypes.CDLL("libm.so.6")
            lib.sinf.restype = ctypes.c_float
            lib.sinf.argtypes = [ctypes.c_float]
            _LIBM = lib
        except OSError:
            _LIBM = False
    if _LIBM is False:
        return np.sin(np.float32(x), dtype=np.float32)
    return np.float32(_LIBM.sinf(float(np.float32(x))))


_LIBM = None


def libm_sinf_array(x: np.ndarray) -> np.ndarray:
    """Elementwise :func:`libm_sinf` over a float32 array.

    glibc has no vectorized sinf with guaranteed scalar-identical results,
    so this loops the ctypes call — bit-for-bit the scalar chain, and fast
    enough for its one consumer: the once-per-run template-bank parameter
    derivation (``models/search.py::bank_params_host``, ~6.7k elements)."""
    x = np.asarray(x, dtype=np.float32)
    out = np.empty(x.shape, dtype=np.float32)
    flat_in = x.ravel()
    flat_out = out.ravel()
    for i in range(flat_in.size):
        flat_out[i] = libm_sinf(flat_in[i])
    return out


def sincos_lut_lookup(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized ``sincosLUTLookup`` (erp_utilities.cpp:176-209).

    Returns (sin(x), cos(x)) computed via the LUT + Taylor interpolation in
    float32, matching the C routine's operation order.
    """
    x = np.asarray(x, dtype=np.float32)
    # xt = modff(x / 2pi): fractional part, truncated toward zero
    scaled = (ERP_TWO_PI_INV * x).astype(np.float32)
    xt = (scaled - np.trunc(scaled)).astype(np.float32)  # in (-1, 1)
    xt = np.where(xt < 0.0, (xt + np.float32(1.0)).astype(np.float32), xt)

    i0 = (xt * ERP_SINCOS_LUT_RES_F + np.float32(0.5)).astype(np.int32)
    d = (ERP_TWO_PI * (xt - ERP_SINCOS_LUT_RES_F_INV * i0.astype(np.float32))).astype(
        np.float32
    )
    d2 = (d * (np.float32(0.5) * d)).astype(np.float32)

    ts = SIN_SAMPLES[i0]
    tc = COS_SAMPLES[i0]
    sin_x = (ts + d * tc - d2 * ts).astype(np.float32)
    cos_x = (tc - d * ts - d2 * tc).astype(np.float32)
    return sin_x, cos_x
