"""Shared helpers of the PyTorch port's parity tests.  The card's tests
import it too, so the JAX package is imported only where a helper needs it."""

import numpy as np

from boinc_app_eah_brp_tpu_torch.ops.resample import SINE_ULPS
from boinc_app_eah_brp_tpu_torch.ops.resample import sine_ties as port_sine_ties

DT = 500e-6  # sample time of the test workunits (s)


def contraction_ties(params, n):
    """bool[T, 2, n//2]: samples whose nearest index differs between the
    uncontracted del_t chain and one with ``tau*s*step_inv - S0`` fused."""
    from boinc_app_eah_brp_tpu.oracle.sincos import sincos_lut_lookup as oracle_sincos

    f32 = np.float32
    tau, om, psi, s0 = (np.asarray(p, dtype=f32)[:, None] for p in params)
    step_inv = f32(1.0) / f32(DT)
    i_f = np.arange(n, dtype=f32)[None, :]
    phase = om * (i_f * f32(DT)) + psi
    s = oracle_sincos(phase)[0]
    a = tau * s
    del_u = a * step_inv - s0
    del_f = (a.astype(np.float64) * np.float64(step_inv) - s0.astype(np.float64)).astype(f32)
    idx = [np.clip((i_f - d + f32(0.5)).astype(np.int32), 0, n - 1) for d in (del_u, del_f)]
    T = tau.shape[0]
    return (idx[0] != idx[1]).reshape(T, n // 2, 2).transpose(0, 2, 1)


def sine_ties(params, n, ulps=SINE_ULPS):
    """bool[T, 2, n//2]: samples where two exact-sine resamplers whose
    float32 sines are ``ulps`` ulp apart may gather differently (the tie
    rule of the exact-sine parity tests; ``ops/resample.py::sine_ties``)."""
    return port_sine_ties(params, n, DT, ulps)


def host_rescore(ts, candidates_all, emitted, derived):
    """The host oracle's rescoring, the reference of
    ``oracle/rescore.py::rescore_winners``: every winning template of
    ``emitted`` through ``_score_template`` (the host oracle's resample
    and numpy's FFT) on the numpy series ``ts``, and the toplist entries
    patched with its powers.  Returns the patched copy and the number of
    templates scored."""
    from boinc_app_eah_brp_tpu_torch.oracle import rescore

    if len(emitted) == 0:
        return candidates_all, 0
    wanted, entry_key = rescore._winning_pairs(candidates_all, emitted)
    ts = np.asarray(ts, dtype=np.float32)
    scored = {tpl: rescore._score_template(ts, derived, tpl, pairs) for tpl, pairs in sorted(wanted.items())}
    out = candidates_all.copy()
    for i, key in enumerate(entry_key):
        if key is not None:
            tpl, k, f0 = key
            out["power"][i] = scored[tpl][(k, f0)]
    return out, len(scored)
