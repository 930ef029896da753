"""Precision observatory: per-stage numerical-error attribution, ULP
histograms and candidate-recall scoring against the f64 oracle.

Counterpart of the reference package's ``runtime/precision.py``.  It runs
the port's own stage functions on the run's device and a float64
reference over the same workunit slice, taps every stage boundary (the
``runtime/devicecost.py`` stage registry is the single source of stage
names), and scores the final toplist against the oracle's with the
validator's matching semantics (``io/validate.py``).

Three dtype lanes through one harness:

* **f32**: the production path itself; the lane's end-to-end output is
  the byte-identical ``run_bank`` result (the tap is observation-only,
  proven per audit by running the loop twice over one step cache and
  comparing bytes and the kernel builds plus new cuFFT plans of the
  second pass, which must be 0);
* **bf16 shadow**: the same stage functions with a round-to-nearest-even
  bfloat16 quantization at every spectrum-path boundary (resampled
  series, power spectrum, harmonic sums) inside the audit only: bf16
  storage with f32 arithmetic;
* **f64 oracle**: the reference algorithm carried out in float64.

**Decision pinning.**  The pipeline's discrete decisions (LUT-sine
``del_t``, the ``n_steps`` shrink loop, nearest-neighbour indices) are
part of the search definition, computed in float32 by the reference C,
not rounding error.  The f64 oracle pins them to the production float32
chain (``oracle/resample.py``) and carries only the value arithmetic in
float64.

**Error-growth waterfall.**  For each stage the audit reports
``cumulative`` (lane chain against f64 chain at that tap) and
``introduced`` (the lane stage re-run on the f64 reference's input),
and the attribution block names the stage with the largest introduced
error.  Relative errors use a scaled denominator ``max(|ref|, REL_FLOOR
* max|ref|)``; ULP distances are on the lane's own grid after rounding
the f64 reference onto it.

The stage taps are the port's: resample = ``ops/resample.py::
fftprep_series`` (kernels A and B: the padded series in natural order),
fft+power = ``torch.fft.rfft`` and ``ops/spectrum.py::power_from_rfft``,
harmonic-sum = ``ops/harmonic.py::sumspec_batch`` (kernel C's float-power
entry), read back in natural order.  The unpack stage is the host unpack
of ``io/workunit.py``.

Import-light: no torch at import, so tools can load the validators; the
harness functions import torch lazily.
"""

from __future__ import annotations

import numpy as np

from . import devicecost, metrics

PRECISION_SCHEMA = "erp-precision-audit/1"
PRECISION_BASELINE_SCHEMA = "erp-precision-baseline/1"

# scaled-relative-error floor: |lane-ref| is divided by
# max(|ref|, REL_FLOOR * max|ref|) per compared array
REL_FLOOR = 1e-3

# ULP-distance histogram bucket upper bounds (first matching bound wins;
# anything beyond the last lands in the "inf" overflow)
ULP_BUCKETS = (0, 1, 2, 4, 8, 16, 64, 256, 1024, 4096)

# the audited numeric stage boundaries, in dataflow order: names are the
# devicecost stage buckets, scopes the erp.* scopes that feed each
AUDIT_STAGES = (
    ("unpack", ("unpack",)),
    ("whiten", ("whiten", "median")),
    ("resample", ("resample", "fftprep")),
    ("fft+power", ("fft", "power")),
    ("harmonic-sum", ("harmonic", "sumspec")),
)
# the candidate-selection boundary: scored by recall/rank/Jaccard rather
# than elementwise error; its scope collapses into the merge bucket
TOPLIST_STAGE = ("toplist", ("merge",))

STAGE_NAMES = tuple(name for name, _ in AUDIT_STAGES)

# the CI fixture (the reference package's tools/precision_audit.py):
# the 4096-sample geometry, 8 templates, window 200
CI_TEMPLATES = 8
CI_WINDOW = 200
CI_BATCH = 3
CI_TSAMPLE_US = 500.0
CI_SAMPLES = 4096


def stage_registry_problems() -> list[str]:
    """Cross-check the audit's stage table against the devicecost
    registry; non-empty means the two layers disagree on stage names."""
    problems = []
    for name, scopes in AUDIT_STAGES:
        for sc in scopes:
            if sc not in devicecost.STAGES:
                problems.append(f"audit scope {sc!r} not in devicecost.STAGES")
            elif devicecost.STAGES[sc] != name:
                problems.append(f"audit stage {name!r} != ledger bucket {devicecost.STAGES[sc]!r} for scope {sc!r}")
    for sc in TOPLIST_STAGE[1]:
        if sc not in devicecost.STAGES:
            problems.append(f"toplist scope {sc!r} not in devicecost.STAGES")
    return problems


# ---------------------------------------------------------------------------
# dtype grids: software bfloat16 + ordered-int ULP distance
# ---------------------------------------------------------------------------


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """int64[...] bfloat16 bit patterns of float32 input, rounded to
    nearest even (the hardware f32->bf16 conversion)."""
    f = np.asarray(x, dtype=np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    rounded = (u + np.uint64(0x7FFF) + ((u >> np.uint64(16)) & np.uint64(1))) >> np.uint64(16)
    bits = (rounded & np.uint64(0xFFFF)).astype(np.int64)
    # keep NaN a NaN: rounding may carry a NaN mantissa into the inf
    # encoding; force a quiet-NaN pattern instead
    bits = np.where(np.isnan(f), np.int64(0x7FC1 | (bits & 0x8000)), bits)
    return bits


def quantize_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded onto the bfloat16 grid (round to nearest
    even): the bf16 shadow lane's per-stage storage quantization."""
    bits = _bf16_bits(x).astype(np.uint64) << np.uint64(16)
    return bits.astype(np.uint32).view(np.float32).reshape(np.shape(x))


def _ordered_ints(x: np.ndarray, dtype: str) -> np.ndarray:
    """Monotone int64 encoding of floats on the given grid: adjacent
    representable values differ by 1, so |a - b| is the ULP distance."""
    if dtype == "bf16":
        bits = _bf16_bits(x)
        sign = np.int64(1) << 15
        mask = (np.int64(1) << 16) - 1
    elif dtype == "f32":
        bits = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.int64)
        sign = np.int64(1) << 31
        mask = (np.int64(1) << 32) - 1
    else:
        raise ValueError(f"unknown ULP grid dtype {dtype!r}")
    return np.where(bits & sign, mask - bits, bits + sign)


def ulp_histogram(lane: np.ndarray, ref: np.ndarray, dtype: str) -> dict:
    """ULP-distance histogram of ``lane`` against the f64 ``ref`` rounded
    onto the lane's grid.  Keys are stringified ULP_BUCKETS bounds plus
    ``"inf"``; values are counts (first matching bound wins)."""
    ref_on_grid = (
        quantize_bf16(np.asarray(ref, dtype=np.float32)) if dtype == "bf16" else np.asarray(ref, dtype=np.float32)
    )
    d = np.abs(_ordered_ints(lane, dtype) - _ordered_ints(ref_on_grid, dtype)).ravel()
    hist: dict[str, int] = {}
    remaining = d
    for b in ULP_BUCKETS:
        take = remaining <= b
        hist[str(b)] = int(np.count_nonzero(take))
        remaining = remaining[~take]
    hist["inf"] = int(len(remaining))
    return hist


def error_stats(lane: np.ndarray, ref: np.ndarray, dtype: str = "f32") -> dict:
    """Scaled relative-error statistics and ULP histogram of a lane array
    against its f64 reference."""
    lv = np.asarray(lane, dtype=np.float64).ravel()
    rv = np.asarray(ref, dtype=np.float64).ravel()
    if lv.shape != rv.shape:
        raise ValueError(f"shape mismatch {lv.shape} vs {rv.shape}")
    absdiff = np.abs(lv - rv)
    scale = float(np.max(np.abs(rv))) if len(rv) else 0.0
    if scale > 0.0:
        rel = absdiff / np.maximum(np.abs(rv), REL_FLOOR * scale)
    else:
        rel = absdiff  # all-zero reference: abs error is the statistic
    return {
        "max_rel_err": float(np.max(rel)) if len(rel) else 0.0,
        "mean_rel_err": float(np.mean(rel)) if len(rel) else 0.0,
        "max_abs_err": float(np.max(absdiff)) if len(absdiff) else 0.0,
        "n_values": int(len(lv)),
        "ulp_hist": ulp_histogram(lane, ref, dtype),
    }


class _StatAcc:
    """Merges per-template error_stats into one per-stage aggregate."""

    def __init__(self):
        self.max_rel = 0.0
        self.max_abs = 0.0
        self.rel_sum = 0.0
        self.n = 0
        self.ulp: dict[str, int] = {}

    def add(self, stats: dict) -> None:
        self.max_rel = max(self.max_rel, stats["max_rel_err"])
        self.max_abs = max(self.max_abs, stats["max_abs_err"])
        self.rel_sum += stats["mean_rel_err"] * stats["n_values"]
        self.n += stats["n_values"]
        for k, v in stats["ulp_hist"].items():
            self.ulp[k] = self.ulp.get(k, 0) + v

    def result(self) -> dict:
        return {
            "max_rel_err": self.max_rel,
            "mean_rel_err": (self.rel_sum / self.n) if self.n else 0.0,
            "max_abs_err": self.max_abs,
            "n_values": self.n,
            "ulp_hist": dict(self.ulp),
        }


# ---------------------------------------------------------------------------
# the f64 reference chain (pure numpy; decisions pinned to the f32 path)
# ---------------------------------------------------------------------------

# bytes of window copies the blocked median holds at once
_MEDIAN_BLOCK_BYTES = 64 << 20


def _running_median_f64(x: np.ndarray, bsize: int) -> np.ndarray:
    """Sliding-window median in float64, the high-precision counterpart of
    the oracle's running median (same definition, no f32 casts).  The
    windows are partitioned in blocks of at most ``_MEDIAN_BLOCK_BYTES``,
    so host memory stays bounded at any length (every window at once
    would take length x window x 8 bytes: ~50 GB at the production
    6,291,457 bins and window 1000); each window's median is the same
    value whichever block it falls in."""
    x = np.asarray(x, dtype=np.float64)
    n_out = len(x) - bsize + 1
    if n_out <= 0:
        raise ValueError("window larger than input")
    half = bsize // 2
    rows = max(1, _MEDIAN_BLOCK_BYTES // (bsize * 8))
    out = np.empty(n_out, dtype=np.float64)
    for a in range(0, n_out, rows):
        b = min(n_out, a + rows)
        windows = np.lib.stride_tricks.sliding_window_view(x[a : b + bsize - 1], bsize)
        if bsize % 2:
            out[a:b] = np.partition(windows, half, axis=1)[:, half]
        else:
            part = np.partition(windows, (half - 1, half), axis=1)
            out[a:b] = (part[:, half - 1] + part[:, half]) / 2.0
    return out


def whiten_f64(samples64: np.ndarray, derived, cfg) -> np.ndarray:
    """float64 whitening reference: the oracle's algorithm (pad, rfft,
    periodogram, running median, sqrt(ln2/median) scale, edge zero,
    scaled irfft) with every value computation in float64.  The audit
    passes no zap ranges, so the taus2 noise stream never enters."""
    n_unpadded = len(samples64)
    nsamples = derived.nsamples
    fft_size = derived.fft_size
    window = cfg.window
    window_2 = derived.window_2
    padded = np.zeros(nsamples, dtype=np.float64)
    padded[:n_unpadded] = samples64
    fft = np.fft.rfft(padded)
    ps = np.zeros(fft_size, dtype=np.float64)
    ps[1:] = fft.real[1:] ** 2 + fft.imag[1:] ** 2
    white_size = fft_size - window + 1
    rm = _running_median_f64(ps, window)
    factor = np.sqrt(np.log(2.0) / rm)
    fft[window_2 : window_2 + white_size] *= factor
    fft[:window_2] = 0.0
    if window_2 > 0:
        fft[fft_size - window_2 :] = 0.0
    back = np.fft.irfft(fft, n=nsamples) * np.sqrt(float(nsamples))
    return back[:n_unpadded]


def resample_f64(ts64: np.ndarray, rp) -> tuple[np.ndarray, int]:
    """float64 resample reference with pinned f32 decisions: ``del_t``,
    ``n_steps`` and the nearest-neighbour indices come from the exact
    production chain (``oracle/resample.py``); the gathered values and
    the padding mean are float64."""
    from ..oracle.resample import compute_del_t, compute_n_steps

    del_t = compute_del_t(rp)
    n_steps = compute_n_steps(del_t, rp.nsamples_unpadded)
    i_f = np.arange(n_steps, dtype=np.float32)
    idx = (i_f - del_t[:n_steps] + np.float32(0.5)).astype(np.int32)
    np.clip(idx, 0, rp.nsamples_unpadded - 1, out=idx)
    gathered = ts64[idx]
    mean = float(np.mean(gathered)) if n_steps > 0 else 0.0
    out = np.full(rp.nsamples, mean, dtype=np.float64)
    out[:n_steps] = gathered
    return out, n_steps


def power_spectrum_f64(resampled64: np.ndarray, nsamples: int) -> np.ndarray:
    """float64 power-spectrum reference (rfft periodogram, 1/nsamples
    norm, zeroed DC)."""
    fft = np.fft.rfft(resampled64)
    ps = (fft.real**2 + fft.imag**2) / float(nsamples)
    ps[0] = 0.0
    return ps


def _level_sums_any(ps: np.ndarray, i: np.ndarray, k: int) -> np.ndarray:
    """The oracle's harmonic level sums generalized over dtype: the same C
    association order, accumulating in the input's dtype."""
    levels = [(16,), (8,), (12, 4), (14, 10, 6, 2), (15, 13, 11, 9, 7, 5, 3, 1)]
    s = None
    for ls in levels[: 1 + k]:
        level = None
        for l in ls:
            term = ps[(i * l + 8) >> 4]
            level = term if level is None else (level + term).astype(ps.dtype)
        s = level if s is None else (s + level).astype(ps.dtype)
    return s


def harmonic_maxima(ps: np.ndarray, window_2: int, fund_hi: int, harm_hi: int) -> np.ndarray:
    """(5, fund_hi) per-bin harmonic-sum run maxima in the input's dtype:
    the natural-order fold without f32 casts, so a float64 ps yields the
    float64 reference."""
    out = np.zeros((5, fund_hi), dtype=ps.dtype)
    out[0] = ps[:fund_hi]
    i = np.arange(window_2, harm_hi, dtype=np.int64)
    if len(i) == 0:
        return out
    for k in range(1, 5):
        S = _level_sums_any(ps, i, k)
        j = (i * (16 >> k) + 8) >> 4
        valid = j < fund_hi
        Sv, jv = S[valid], j[valid]
        if len(jv) == 0:
            continue
        starts = np.concatenate([[0], np.flatnonzero(np.diff(jv)) + 1])
        out[k][jv[starts]] = np.maximum.reduceat(Sv, starts)
    return out


def merge_maxima(sums_stack: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(M, T) from per-template natural-order sumspecs: strict ``>`` so
    earlier templates win ties (the device merge), from the zero state."""
    M = np.zeros(sums_stack.shape[1:], dtype=sums_stack.dtype)
    T = np.zeros(sums_stack.shape[1:], dtype=np.int32)
    for t in range(sums_stack.shape[0]):
        better = sums_stack[t] > M
        M = np.where(better, sums_stack[t], M)
        T = np.where(better, np.int32(t), T)
    return M, T


def toplist_rows(
    M_nat: np.ndarray,
    T_nat: np.ndarray,
    bank_P: np.ndarray,
    bank_tau: np.ndarray,
    bank_psi0: np.ndarray,
    base_thr: np.ndarray,
    window_2: int,
    t_obs: float,
) -> list[tuple]:
    """Finalized candidate rows (validator column order: f0 Hz, P_b, tau,
    psi, power, fA, n_harm) from natural-order per-bin maxima, with the
    production tie-break semantics (``oracle/toplist.py``); float64
    maxima narrow to f32 at the toplist boundary, where the checkpoint
    record narrows them."""
    from ..io import empty_candidates
    from ..oracle.toplist import finalize_candidates, update_toplist_from_maxima

    cands = update_toplist_from_maxima(
        empty_candidates(), M_nat, T_nat, bank_P, bank_tau, bank_psi0, base_thr, window_2
    )
    out = finalize_candidates(cands, t_obs)
    return [
        (
            float(c["f0"]) / float(t_obs),
            float(c["P_b"]),
            float(c["tau"]),
            float(c["Psi"]),
            float(c["power"]),
            float(c["fA"]),
            int(c["n_harm"]),
        )
        for c in out
    ]


def candidate_scores(rows_ref: list[tuple], rows_lane: list[tuple], t_obs: float, power_rtol: float = 1.5e-2) -> dict:
    """recall@tol / rank-stability / toplist-Jaccard of a lane's finalized
    candidates against the f64 oracle's, with the BOINC validator's
    matching semantics (``io/validate.py``).

    * ``recall_at_tol``: fraction of the oracle's non-boundary candidates
      the lane recovers with power within ``power_rtol``;
    * ``rank_stability``: pairwise concordance of the matched candidates'
      power ordering;
    * ``jaccard``: |keys_ref & keys_lane| / |keys_ref | keys_lane| over
      all emitted candidates (boundary wobble included).
    """
    from ..io.validate import _key, compare_candidate_rows

    diff = compare_candidate_rows(rows_ref, rows_lane, t_obs, power_rtol=power_rtol)
    keys_ref = {_key(r, t_obs) for r in rows_ref}
    keys_lane = {_key(r, t_obs) for r in rows_lane}
    union = keys_ref | keys_lane
    inter = keys_ref & keys_lane
    power_mism = {m[0] for m in diff.mismatches if m[1] == "power"}
    n_ref = diff.matched + len(diff.missing)
    recovered = diff.matched - sum(1 for k in power_mism if k in inter)
    recall = 1.0 if n_ref == 0 else recovered / n_ref

    ref_map = {_key(r, t_obs): r for r in rows_ref}
    lane_map = {_key(r, t_obs): r for r in rows_lane}
    matched = sorted(inter)
    conc = tot = 0
    max_power_rel = 0.0
    for idx_a in range(len(matched)):
        ka = matched[idx_a]
        pa_r, pa_l = ref_map[ka][4], lane_map[ka][4]
        max_power_rel = max(max_power_rel, abs(pa_l - pa_r) / max(abs(pa_r), 1e-30))
        for idx_b in range(idx_a + 1, len(matched)):
            kb = matched[idx_b]
            dr = ref_map[ka][4] - ref_map[kb][4]
            dl = lane_map[ka][4] - lane_map[kb][4]
            if dr == 0.0 and dl == 0.0:
                conc += 1
            elif dr * dl > 0.0:
                conc += 1
            tot += 1
    rank_stability = 1.0 if tot == 0 else conc / tot
    return {
        "recall_at_tol": float(recall),
        "power_rtol": float(power_rtol),
        "rank_stability": float(rank_stability),
        "jaccard": 1.0 if not union else len(inter) / len(union),
        "oracle_n": len(rows_ref),
        "lane_n": len(rows_lane),
        "matched": diff.matched,
        "missing": len(diff.missing),
        "extra": len(diff.extra),
        "boundary": len(diff.boundary),
        "max_power_rel_err": float(max_power_rel),
    }


def oracle_stage_intermediates(ts_raw, bank_P, bank_tau, bank_psi0, cfg, derived) -> dict[str, np.ndarray]:
    """Per-stage f64 oracle intermediates for a (small) workunit slice:
    whitened series, per-template resampled series, power spectra and
    harmonic sumspecs, merged (M, T) maxima.  Pure numpy."""
    from ..oracle.resample import ResampleParams

    ts64 = np.asarray(ts_raw, dtype=np.float64)
    white64 = whiten_f64(ts64, derived, cfg)
    n_t = len(bank_P)
    res = np.zeros((n_t, derived.nsamples), dtype=np.float64)
    ps = np.zeros((n_t, derived.fft_size), dtype=np.float64)
    sums = np.zeros((n_t, 5, derived.fundamental_idx_hi), dtype=np.float64)
    for t in range(n_t):
        rp = ResampleParams.from_template(
            bank_P[t], bank_tau[t], bank_psi0[t], derived.dt, derived.nsamples, derived.n_unpadded
        )
        res[t], _ = resample_f64(white64, rp)
        ps[t] = power_spectrum_f64(res[t], derived.nsamples)
        sums[t] = harmonic_maxima(ps[t], derived.window_2, derived.fundamental_idx_hi, derived.harmonic_idx_hi)
    M64, T64 = merge_maxima(sums)
    return {
        "ts_raw": np.asarray(ts_raw, dtype=np.float32),
        "whitened": white64,
        "resampled": res,
        "power": ps,
        "sumspec": sums,
        "maxima_M": M64,
        "maxima_T": T64,
    }


def ci_fixture(n_samples: int = CI_SAMPLES, n_templates: int = CI_TEMPLATES):
    """(ts_raw, bank_P, bank_tau, bank_psi0, cfg, derived, geom) of the CI
    audit: the reference package's ``tools/precision_audit.py::
    build_fixture`` (its test fixtures' pulse train at 33 Hz on the
    injected orbit P 2.2 s, tau 0.04 s, psi 1.2, amplitude 7, N(4, 1)
    noise from seed 0, 4-bit quantized; the four-template bank around that
    orbit tiled to ``n_templates`` with small period and phase offsets;
    window 200 at 500 us), at ``n_samples`` samples."""
    from ..models.search import SearchGeometry
    from ..oracle.pipeline import DerivedParams, SearchConfig

    P_true, tau_true, psi_true = 2.2, 0.04, 1.2
    base_P = np.array([1000.0, P_true, P_true * 1.07, 1.7])
    base_tau = np.array([0.0, tau_true, tau_true * 0.8, 0.08])
    base_psi = np.array([0.0, psi_true, psi_true + 0.4, 2.5])
    reps = -(-n_templates // len(base_P))
    idx = np.arange(n_templates)
    P = np.tile(base_P, reps)[:n_templates] * (1.0 + 0.003 * idx)
    tau = np.tile(base_tau, reps)[:n_templates]
    psi0 = np.tile(base_psi, reps)[:n_templates] + 0.01 * idx

    rng = np.random.default_rng(0)
    dt = CI_TSAMPLE_US * 1e-6
    t = np.arange(n_samples) * dt
    i_idx = np.arange(n_samples, dtype=np.float64)
    del_t = (tau_true * np.sin(2 * np.pi / P_true * t + psi_true) - tau_true * np.sin(psi_true)) / dt
    t_pulsar = np.interp(i_idx, i_idx - del_t, i_idx) * dt
    pulse = 7.0 * (np.cos(2 * np.pi * 33.0 * t_pulsar) > 0.95)
    ts = np.clip(np.round(pulse + rng.normal(4.0, 1.0, size=n_samples)), 0, 15).astype(np.float32)

    cfg = SearchConfig(window=CI_WINDOW)
    derived = DerivedParams.derive(n_samples, CI_TSAMPLE_US, cfg)
    geom = SearchGeometry.from_derived(derived, max_slope=0.5, lut_step=0.05)
    return ts, P, tau, psi0, cfg, derived, geom


# ---------------------------------------------------------------------------
# the audit harness (imports torch lazily)
# ---------------------------------------------------------------------------


def _stage_fns(geom, device):
    """The port's production stage functions on ``device``, one template
    at a time (the audit's taps), each taking and returning host arrays:
    ``rs(ts32, params)`` the padded series float32[nsamples] in natural
    order (kernels A and B through ``fftprep_series``), ``ps(x32)`` the
    power spectrum (rfft and the power epilogue), ``hs(spec32)`` the
    (5, fund_hi) natural-order harmonic sums (kernel C's float-power entry,
    ``sumspec_batch``).  They are separate calls from the production
    ``run_bank``, which the audit never modifies."""
    import torch

    from ..device import resolve_device
    from ..models.search import state_to_natural
    from ..ops.harmonic import sumspec_batch
    from ..ops.kernels import planned_fft
    from ..ops.resample import fftprep_series
    from ..ops.spectrum import power_from_rfft

    dev = resolve_device(device)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    def rs(ts32, params):
        p = up(np.asarray(params, dtype=np.float32)[None, :])
        x = fftprep_series(
            up(ts32), p[:, 0], p[:, 1], p[:, 2], p[:, 3],
            nsamples=geom.nsamples, n_unpadded=geom.n_unpadded, dt=geom.dt, exact_mean=geom.exact_mean,
            exact_sin=not geom.use_lut,
        )
        return x[0].cpu().numpy()

    def ps(x32):
        F = planned_fft(torch.fft.rfft, up(x32)[None, :])
        return power_from_rfft(F, nsamples=geom.nsamples)[0].cpu().numpy()

    def hs(spec32):
        sums = sumspec_batch(up(spec32)[None, :], fund_hi=geom.fund_hi, harm_hi=geom.harm_hi)
        return state_to_natural(sums[0], geom)

    return rs, ps, hs


def _recompile_count() -> int | None:
    """Kernel builds plus new cuFFT plans so far (the port's counterpart of
    ``jax.recompiles``), None when the metrics layer is off."""
    if not metrics.enabled():
        return None
    counters = metrics.snapshot().get("counters", {})
    return sum(int(counters.get(n, {}).get("value", 0)) for n in ("torch.kernel_builds", "torch.cufft_plans"))


def run_audit(
    ts_raw: np.ndarray,
    bank_P: np.ndarray,
    bank_tau: np.ndarray,
    bank_psi0: np.ndarray,
    cfg,
    derived,
    geom,
    lanes: tuple[str, ...] = ("f32", "bf16"),
    batch_size: int = 3,
    device="cuda",
) -> dict:
    """Run the full precision audit on ``device`` and return the
    ``erp-precision-audit/1`` document.  ``ts_raw`` is the raw
    (4-bit-quantized, unwhitened) series; the harness unpacks it on the
    host, whitens it (the port on ``device`` against f64), runs every
    lane's per-template chain through the port's stage functions, merges
    maxima, finalizes toplists and scores recall, plus the
    observation-only tap proof on the f32 lane (two ``run_bank`` passes
    over one step cache: byte-identical (M, T), no kernel build and no
    new cuFFT plan in the second).  The build and plan counts come from
    the metrics layer: with it off, ``recompiles_in_window`` is None."""
    import time

    import torch

    from ..device import resolve_device
    from ..io.workunit import pack_4bit, unpack_4bit
    from ..models import search as msearch
    from ..ops.whiten import whiten_and_zap
    from ..oracle.stats import base_thresholds
    from .scheduler import StepCache

    unknown = [ln for ln in lanes if ln not in ("f32", "bf16")]
    if unknown:
        raise ValueError(f"unknown audit lanes {unknown}")
    problems = stage_registry_problems()
    if problems:
        raise RuntimeError("; ".join(problems))
    dev = resolve_device(device)

    ts_raw = np.asarray(ts_raw, dtype=np.float32)
    ts64 = ts_raw.astype(np.float64)
    base_thr = base_thresholds(cfg.fA, derived.fft_size)

    # --- WU-level stages: unpack + whiten (lane-independent: the bf16
    # shadow quantizes the per-template spectrum path only) -----------------
    payload = np.frombuffer(pack_4bit(ts_raw, 1.0), dtype=np.uint8)
    unpacked = unpack_4bit(payload, 1.0, len(ts_raw))
    white32 = (
        whiten_and_zap(ts_raw, derived, cfg, np.zeros((0, 2), dtype=np.float64), device=dev).cpu().numpy()
    )

    # --- f64 oracle chain (whitening and each template's stages) -----------
    n_t = len(bank_P)
    oracle = oracle_stage_intermediates(ts_raw, bank_P, bank_tau, bank_psi0, cfg, derived)
    white64, res64, ps64, sums64 = (oracle[k] for k in ("whitened", "resampled", "power", "sumspec"))
    rows64 = toplist_rows(
        oracle["maxima_M"], oracle["maxima_T"], bank_P, bank_tau, bank_psi0, base_thr, geom.window_2, derived.t_obs
    )

    # --- lane chains through the port's stage taps -------------------------
    rs_fn, ps_fn, hs_fn = _stage_fns(geom, dev)
    params = np.stack(msearch.bank_params_host(bank_P, bank_tau, bank_psi0, geom.dt), axis=1)

    eligible = slice(geom.window_2, None)
    lane_docs: dict[str, dict] = {}
    lane_sums32: dict[str, np.ndarray] = {}
    for lane in lanes:
        q = quantize_bf16 if lane == "bf16" else (lambda x: x)
        acc = {name: {"cum": _StatAcc(), "intro": _StatAcc()} for name, _ in AUDIT_STAGES}
        # WU-level stages (identical across lanes: a bf16 port would keep
        # the once-per-WU unpack/whiten chain in f32)
        st = error_stats(unpacked, ts64, dtype="f32")
        acc["unpack"]["cum"].add(st)
        acc["unpack"]["intro"].add(st)
        st = error_stats(white32, white64, dtype="f32")
        acc["whiten"]["cum"].add(st)
        acc["whiten"]["intro"].add(st)

        sums_lane = np.zeros((n_t, 5, geom.fund_hi), dtype=np.float32)
        for t in range(n_t):
            # cumulative chain: lane whiten -> lane stages, quantized at
            # every spectrum-path boundary for the bf16 shadow
            r_cum = q(rs_fn(white32, params[t]))
            p_cum = q(ps_fn(r_cum))
            s_cum = q(hs_fn(p_cum))
            sums_lane[t] = s_cum
            acc["resample"]["cum"].add(error_stats(r_cum, res64[t], lane))
            acc["fft+power"]["cum"].add(error_stats(p_cum[1:], ps64[t][1:], lane))
            acc["harmonic-sum"]["cum"].add(error_stats(s_cum[:, eligible], sums64[t][:, eligible], lane))
            # introduced: the lane stage on the f64 reference's input
            r_in = q(rs_fn(white64.astype(np.float32), params[t]))
            acc["resample"]["intro"].add(error_stats(r_in, res64[t], lane))
            p_in = q(ps_fn(q(res64[t].astype(np.float32))))
            acc["fft+power"]["intro"].add(error_stats(p_in[1:], ps64[t][1:], lane))
            s_in = q(hs_fn(q(ps64[t].astype(np.float32))))
            acc["harmonic-sum"]["intro"].add(error_stats(s_in[:, eligible], sums64[t][:, eligible], lane))
        lane_sums32[lane] = sums_lane

        stages = []
        for name, scopes in AUDIT_STAGES:
            row = acc[name]["cum"].result()
            row["stage"] = name
            row["scopes"] = list(scopes)
            row["introduced_rel_err"] = acc[name]["intro"].result()["max_rel_err"]
            stages.append(row)
        intro_sum = sum(s["introduced_rel_err"] for s in stages)
        waterfall = [
            {
                "stage": s["stage"],
                "introduced_rel_err": s["introduced_rel_err"],
                "cumulative_rel_err": s["max_rel_err"],
                "share": (s["introduced_rel_err"] / intro_sum if intro_sum > 0 else 0.0),
            }
            for s in stages
        ]
        worst = max(stages, key=lambda s: s["introduced_rel_err"])
        lane_docs[lane] = {
            "stages": stages,
            "waterfall": waterfall,
            "attribution": {
                "worst_stage": worst["stage"],
                "worst_introduced_rel_err": worst["introduced_rel_err"],
            },
        }

    # --- f32 lane: the production run itself + the observation-only tap
    # proof (two dispatch passes over one step cache) ------------------------
    ts_dev = torch.from_numpy(white32).to(dev)
    step_cache = StepCache()
    M_ref, T_ref = msearch.run_bank(
        ts_dev, bank_P, bank_tau, bank_psi0, geom, batch_size=batch_size, step_cache=step_cache
    )
    M_ref, T_ref = M_ref.cpu().numpy(), T_ref.cpu().numpy()
    rec_before = _recompile_count()
    M_tap, T_tap = msearch.run_bank(
        ts_dev, bank_P, bank_tau, bank_psi0, geom, batch_size=batch_size, step_cache=step_cache
    )
    M_tap, T_tap = M_tap.cpu().numpy(), T_tap.cpu().numpy()
    rec_after = _recompile_count()
    byte_identical = M_ref.tobytes() == M_tap.tobytes() and T_ref.tobytes() == T_tap.tobytes()
    recompiles = None if rec_before is None or rec_after is None else rec_after - rec_before

    M32_nat = msearch.state_to_natural(M_tap, geom)
    T32_nat = msearch.state_to_natural(T_tap, geom)

    # tap-vs-production consistency: merging the per-template tap sums
    # must reproduce the production merge (the same operations: the tap's
    # float power into C's float entry, production's complex entry forming
    # the same power inside the kernel)
    if "f32" in lane_docs:
        M_tap_merge, _ = merge_maxima(lane_sums32["f32"])
        denom = np.maximum(np.abs(M32_nat), REL_FLOOR * max(float(np.max(np.abs(M32_nat))), 1e-30))
        lane_docs["f32"]["tap"] = {
            "byte_identical": bool(byte_identical),
            "recompiles_in_window": recompiles,
            "tap_vs_production_max_rel": float(np.max(np.abs(M_tap_merge - M32_nat) / denom)),
        }

    # --- toplists + candidate scores ---------------------------------------
    for lane in lanes:
        if lane == "f32":
            M_l, T_l = M32_nat, T32_nat
        else:
            M_l, T_l = merge_maxima(lane_sums32[lane])
        rows_lane = toplist_rows(M_l, T_l, bank_P, bank_tau, bank_psi0, base_thr, geom.window_2, derived.t_obs)
        scores = candidate_scores(rows64, rows_lane, derived.t_obs)
        lane_docs[lane]["candidates"] = scores
        lane_docs[lane]["attribution"]["final_candidate_power_rel_err"] = scores["max_power_rel_err"]
        # per-stage gauges for the metrics registry (no-ops when off)
        for s in lane_docs[lane]["stages"]:
            metrics.gauge(metrics.labeled("precision.stage_rel_err", lane=lane, stage=s["stage"])).set(
                s["max_rel_err"]
            )
        metrics.gauge(metrics.labeled("precision.recall", lane=lane)).set(scores["recall_at_tol"])
        metrics.gauge(metrics.labeled("precision.jaccard", lane=lane)).set(scores["jaccard"])

    return {
        "schema": PRECISION_SCHEMA,
        "generated_unix": int(time.time()),
        "backend": dev.type,
        "geometry": {
            "n_unpadded": int(derived.n_unpadded),
            "nsamples": int(derived.nsamples),
            "fft_size": int(derived.fft_size),
            "window_2": int(derived.window_2),
            "fund_hi": int(geom.fund_hi),
            "harm_hi": int(geom.harm_hi),
            "templates": int(n_t),
            "batch_size": int(batch_size),
        },
        "oracle": {"dtype": "f64", "decision_pinning": "f32"},
        "lanes": lane_docs,
    }


def attribute_template(ts: np.ndarray, geom, derived, P: float, tau: float, psi0: float, device="cuda") -> dict:
    """Per-stage f32-vs-f64 error attribution for one template: the
    sentinel probe's drill-down (``runtime/health.py``), naming the stage
    that introduced an error instead of just the template.  ``ts`` is the
    series the device searches (whitened or not); the reference
    recomputes each stage from the same input in float64 with pinned f32
    decisions, and each port stage runs on ``device`` from the
    reference's input."""
    from ..models.search import bank_params_host
    from ..oracle.resample import ResampleParams

    ts32 = np.asarray(ts, dtype=np.float32)
    ts64 = ts32.astype(np.float64)
    rp = ResampleParams.from_template(P, tau, psi0, derived.dt, derived.nsamples, derived.n_unpadded)
    r64, _ = resample_f64(ts64, rp)
    p64 = power_spectrum_f64(r64, derived.nsamples)
    s64 = harmonic_maxima(p64, geom.window_2, geom.fund_hi, geom.harm_hi)

    rs_fn, ps_fn, hs_fn = _stage_fns(geom, device)
    params = np.stack(bank_params_host([P], [tau], [psi0], geom.dt), axis=1)[0]
    rel = {}
    rel["resample"] = error_stats(rs_fn(ts32, params), r64)["max_rel_err"]
    p_in = ps_fn(r64.astype(np.float32))
    rel["fft+power"] = error_stats(p_in[1:], p64[1:])["max_rel_err"]
    s_in = hs_fn(p64.astype(np.float32))
    rel["harmonic-sum"] = error_stats(s_in[:, geom.window_2 :], s64[:, geom.window_2 :])["max_rel_err"]
    worst = max(rel, key=rel.get)
    return {"stage_rel_err": rel, "worst_stage": worst}


# ---------------------------------------------------------------------------
# validators + baseline gate + regression diff (torch-free)
# ---------------------------------------------------------------------------


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _validate_stats_row(s: dict, where: str, problems: list[str]) -> None:
    for f in ("max_rel_err", "mean_rel_err", "max_abs_err", "introduced_rel_err"):
        if not _is_num(s.get(f)) or s.get(f) < 0:
            problems.append(f"{where}: bad {f}")
    if not isinstance(s.get("n_values"), int) or s.get("n_values") < 0:
        problems.append(f"{where}: bad n_values")
    h = s.get("ulp_hist")
    if not isinstance(h, dict) or not h:
        problems.append(f"{where}: missing ulp_hist")
    elif any(not isinstance(v, int) or v < 0 for v in h.values()) or "inf" not in h:
        problems.append(f"{where}: malformed ulp_hist")


def validate_precision_audit(doc: dict) -> list[str]:
    """Structural validation of an ``erp-precision-audit/1`` document;
    returns problems (empty = valid)."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return ["not a JSON object"]
    if doc.get("schema") != PRECISION_SCHEMA:
        problems.append(f"schema is {doc.get('schema')!r}, want {PRECISION_SCHEMA!r}")
    if not isinstance(doc.get("backend"), str) or not doc.get("backend"):
        problems.append("missing backend")
    if not _is_num(doc.get("generated_unix")):
        problems.append("missing generated_unix")
    geo = doc.get("geometry")
    if not isinstance(geo, dict) or not all(
        isinstance(geo.get(k), int) and geo.get(k) > 0 for k in ("n_unpadded", "nsamples", "fft_size", "templates")
    ):
        problems.append("malformed geometry")
    orc = doc.get("oracle")
    if not isinstance(orc, dict) or orc.get("dtype") != "f64":
        problems.append("oracle block must declare dtype f64")
    lanes = doc.get("lanes")
    if not isinstance(lanes, dict) or not lanes:
        return problems + ["missing lanes"]
    for lane, ld in lanes.items():
        if lane not in ("f32", "bf16"):
            problems.append(f"unknown lane {lane!r}")
            continue
        if not isinstance(ld, dict):
            problems.append(f"lane {lane}: not an object")
            continue
        stages = ld.get("stages")
        if not isinstance(stages, list) or [s.get("stage") for s in stages if isinstance(s, dict)] != list(
            STAGE_NAMES
        ):
            problems.append(f"lane {lane}: stages must cover {list(STAGE_NAMES)} in order")
        else:
            for s in stages:
                _validate_stats_row(s, f"lane {lane} stage {s.get('stage')}", problems)
        wf = ld.get("waterfall")
        if not isinstance(wf, list) or len(wf) != len(STAGE_NAMES):
            problems.append(f"lane {lane}: malformed waterfall")
        else:
            shares = [w.get("share") for w in wf]
            if not all(_is_num(v) and 0.0 <= v <= 1.0 for v in shares):
                problems.append(f"lane {lane}: waterfall shares out of range")
            elif sum(shares) > 0 and abs(sum(shares) - 1.0) > 1e-6:
                problems.append(f"lane {lane}: waterfall shares do not sum to 1")
        cand = ld.get("candidates")
        if not isinstance(cand, dict):
            problems.append(f"lane {lane}: missing candidates block")
        else:
            for f in ("recall_at_tol", "rank_stability", "jaccard"):
                v = cand.get(f)
                if not _is_num(v) or not 0.0 <= v <= 1.0:
                    problems.append(f"lane {lane}: bad candidates.{f}")
            for f in ("oracle_n", "lane_n", "matched", "missing", "extra"):
                if not isinstance(cand.get(f), int) or cand.get(f) < 0:
                    problems.append(f"lane {lane}: bad candidates.{f}")
        attr = ld.get("attribution")
        if not isinstance(attr, dict) or attr.get("worst_stage") not in STAGE_NAMES:
            problems.append(f"lane {lane}: malformed attribution")
        if lane == "f32":
            tap = ld.get("tap")
            if not isinstance(tap, dict) or not isinstance(tap.get("byte_identical"), bool):
                problems.append("lane f32: missing observation-only tap proof")
            elif tap.get("recompiles_in_window") is not None and not isinstance(tap.get("recompiles_in_window"), int):
                problems.append("lane f32: bad tap.recompiles_in_window")
    return problems


def validate_precision_baseline(doc: dict) -> list[str]:
    """Structural validation of ``erp-precision-baseline/1`` (the
    committed PRECISION_BASELINE.json); returns problems."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return ["not a JSON object"]
    if doc.get("schema") != PRECISION_BASELINE_SCHEMA:
        problems.append(f"schema is {doc.get('schema')!r}, want {PRECISION_BASELINE_SCHEMA!r}")
    if doc.get("lane") not in ("f32", "bf16"):
        problems.append("lane must be f32 or bf16")
    for f in ("recall_min", "jaccard_min", "rank_stability_min"):
        v = doc.get(f)
        if not _is_num(v) or not 0.0 <= v <= 1.0:
            problems.append(f"bad {f}")
    ceil = doc.get("stage_rel_err_max")
    if not isinstance(ceil, dict) or set(ceil) != set(STAGE_NAMES):
        problems.append(f"stage_rel_err_max must cover exactly {sorted(STAGE_NAMES)}")
    elif any(not _is_num(v) or v <= 0 for v in ceil.values()):
        problems.append("stage_rel_err_max ceilings must be positive numbers")
    if "min_candidates" in doc and (not isinstance(doc["min_candidates"], int) or doc["min_candidates"] < 0):
        problems.append("bad min_candidates")
    if "backend" in doc and (not isinstance(doc["backend"], str) or not doc["backend"]):
        problems.append("bad backend")
    return problems


def evaluate_baseline(doc: dict, baseline: dict) -> list[str]:
    """Gate an audit document against the committed baseline: per-stage
    error ceilings, recall/Jaccard/rank floors, and the observation-only
    tap requirements.  Returns problems naming the offending stage or
    metric (empty = pass).  A baseline that names a backend gates only
    audits of that backend."""
    problems = validate_precision_audit(doc)
    problems += validate_precision_baseline(baseline)
    if problems:
        return problems
    if baseline.get("backend") and baseline["backend"] != doc["backend"]:
        return []
    lane_name = baseline.get("lane", "f32")
    lane = doc["lanes"].get(lane_name)
    if lane is None:
        return [f"audit has no {lane_name} lane"]
    cand = lane["candidates"]
    for f, floor_key in (("recall_at_tol", "recall_min"), ("jaccard", "jaccard_min"), ("rank_stability", "rank_stability_min")):
        if cand[f] < baseline[floor_key] - 1e-12:
            problems.append(f"candidates.{f} {cand[f]:.6g} below baseline floor {baseline[floor_key]:.6g}")
    floor_n = baseline.get("min_candidates", 1)
    if cand["oracle_n"] < floor_n:
        problems.append(
            f"oracle toplist has {cand['oracle_n']} candidates, need >= {floor_n} for a meaningful recall score"
        )
    ceil = baseline["stage_rel_err_max"]
    for s in lane["stages"]:
        if s["max_rel_err"] > ceil[s["stage"]]:
            problems.append(
                f"stage {s['stage']}: max rel err {s['max_rel_err']:.3g} exceeds baseline ceiling "
                f"{ceil[s['stage']]:.3g}"
            )
    if lane_name == "f32":
        tap = lane["tap"]
        if not tap["byte_identical"]:
            problems.append("tap proof failed: tapped run_bank output not byte-identical to the untapped reference")
        rc = tap.get("recompiles_in_window")
        if rc is not None and rc != 0:
            problems.append(
                f"tap proof failed: {rc} kernel builds and new cuFFT plans in the tapped dispatch window (must be 0)"
            )
    return problems


def diff_docs(old: dict, new: dict, threshold: float = 0.25) -> list[str]:
    """Regression diff between two audit documents (same backend only):
    any f32-lane stage whose cumulative max relative error grew beyond
    ``threshold`` (fractional), or any drop in recall/Jaccard/rank,
    fails, naming the stage.  Returns problems (empty = no regression)."""
    problems = validate_precision_audit(old) + validate_precision_audit(new)
    if problems:
        return problems
    if old["backend"] != new["backend"]:
        return []  # cross-backend noise is not a regression signal
    o, n = old["lanes"].get("f32"), new["lanes"].get("f32")
    if o is None or n is None:
        return ["both documents need an f32 lane to diff"]
    o_stages = {s["stage"]: s for s in o["stages"]}
    for s in n["stages"]:
        base = o_stages[s["stage"]]["max_rel_err"]
        if s["max_rel_err"] > base * (1.0 + threshold) + 1e-12:
            problems.append(
                f"stage {s['stage']}: max rel err regressed {base:.3g} -> {s['max_rel_err']:.3g} "
                f"(> {threshold:.0%} growth)"
            )
    for f in ("recall_at_tol", "jaccard", "rank_stability"):
        if n["candidates"][f] < o["candidates"][f] - 1e-12:
            problems.append(f"candidates.{f} regressed {o['candidates'][f]:.6g} -> {n['candidates'][f]:.6g}")
    return problems
