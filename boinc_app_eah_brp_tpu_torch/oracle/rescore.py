"""Oracle rescoring of the winning candidates.

After the (M, T) -> toplist conversion, every template among the emitted
winners runs once through the oracle (``oracle/resample.py``'s reference
chain, the same float64 transform numpy's FFT rounds once, and a point
evaluation of the harmonic sums) and the toplist entries of those
templates take the oracle's powers.  The candidate file then carries the
reference's powers whatever FFT library and float contraction the search
used, and it is the same file the JAX package writes by default.

The pass runs once, after the template loop, when the device is idle,
on the session's searched series (a torch tensor, on the card or on the
CPU).  Each template's series comes from that device
(:func:`device_series`: kernel A's LUT gather and the exact serial mean,
both bitwise the oracle's resample, padded there), and so does its
spectrum (``spectrum.power_at_on_device``: one float64 rfft, the bins
the harmonic sums read and the float32 power epilogue); the host copies
a few thousand powers a template and evaluates the harmonic sums.  On a
CPU tensor the kernels run their plain versions.

Each pass is spans of ``runtime/tracing.py``: one
``rescore.device-resample`` a chunk of templates, and ``rescore.fft``
(the transform and the powers at the bins) and ``rescore.harmonics``
each with its template; it counts one ``rescore.templates``, and each
template one ``rescore.device_resamples`` and one
``rescore.device_ffts``.  :func:`_score_template`, the host oracle's
pass for one template (its resample spanned ``rescore.resample``, numpy's
FFT), is the sentinel probe's (``runtime/health.py``) and the tests'
reference.
"""

from __future__ import annotations

import os

import numpy as np

from .harmonic import harmonic_bins, harmonic_power_at
from .pipeline import DerivedParams
from .resample import ResampleParams, resample
from .spectrum import power_at, power_at_on_device


_OFF = ("off", "0", "none")
# templates resampled on the card in one launch of kernel A and of the
# exact mean (16.8 MB of samples each at the production width)
DEVICE_CHUNK = 8


def rescore_enabled() -> bool:
    """``ERP_RESCORE=off`` (or ``0``, ``none``) turns the output-boundary
    rescoring off, as ``--no-rescore`` does; it is on by default."""
    return os.environ.get("ERP_RESCORE", "").strip().lower() not in _OFF


def _template_key(P, tau, psi) -> tuple:
    return (np.float32(P), np.float32(tau), np.float32(psi))


def _winning_pairs(candidates_all: np.ndarray, emitted: np.ndarray):
    """(wanted, entry_key): ``wanted`` maps each unique winning template to
    the set of (k, f0) level/bin pairs its toplist entries need;
    ``entry_key[i]`` is (template, k, f0) for the entries of
    ``candidates_all`` to patch and None for the others."""
    live = emitted[emitted["n_harm"] > 0]
    wanted: dict[tuple, set] = {_template_key(r["P_b"], r["tau"], r["Psi"]): set() for r in live}
    entry_key: list = []
    for i in range(len(candidates_all)):
        n_harm = int(candidates_all["n_harm"][i])
        tpl = _template_key(candidates_all["P_b"][i], candidates_all["tau"][i], candidates_all["Psi"][i])
        if n_harm <= 0 or tpl not in wanted:
            entry_key.append(None)
            continue
        k = n_harm.bit_length() - 1
        f0 = int(candidates_all["f0"][i])
        wanted[tpl].add((k, f0))
        entry_key.append((tpl, k, f0))
    return wanted, entry_key


def _score_template(ts: np.ndarray, derived: DerivedParams, tpl: tuple, pairs) -> dict:
    """One oracle pass for ``tpl`` with the host oracle's resample,
    evaluated at the requested (k, f0)."""
    from ..runtime import tracing

    P, tau, psi0 = tpl
    with tracing.span("rescore.resample", template=(float(P), float(tau), float(psi0))):
        params = ResampleParams.from_template(P, tau, psi0, derived.dt, derived.nsamples, derived.n_unpadded)
        resampled, _, _ = resample(ts, params)
    return _score_series(resampled, derived, tpl, pairs)


def _score_series(resampled, derived: DerivedParams, tpl: tuple, pairs) -> dict:
    """The rest of an oracle pass over the resampled series of ``tpl``
    (a numpy array, or a torch tensor whose device takes the spectrum):
    the power at the bins the (k, f0) pairs read, and their harmonic
    sums on the host."""
    from ..runtime import metrics, tracing

    template = tuple(float(x) for x in tpl)
    geo = (derived.window_2, derived.fundamental_idx_hi, derived.harmonic_idx_hi)
    with tracing.span("rescore.fft", template=template):
        bins = np.unique(np.concatenate([harmonic_bins(f0, k, *geo) for (k, f0) in pairs]))
        if isinstance(resampled, np.ndarray):
            ps = power_at(resampled, bins, 1.0 / derived.nsamples)
        else:
            ps = power_at_on_device(resampled, bins, 1.0 / derived.nsamples)
            metrics.counter("rescore.device_ffts").inc()
    with tracing.span("rescore.harmonics", template=template):
        out = {(k, f0): harmonic_power_at(ps, f0, k, *geo) for (k, f0) in pairs}
    metrics.counter("rescore.templates").inc()
    return out


def device_series(ts, rows):
    """Yield ``(series, n_steps, mean)`` for each oracle parameter set of
    ``rows`` (``ResampleParams``), in order, resampled on ``ts``'s device:
    kernel A's LUT instantiation (no renorm: the oracle resamples the
    searched series as it is, whatever sine the search took) and the
    exact serial mean, :data:`DEVICE_CHUNK` templates a launch (counted
    as ``rescore_resample`` and ``rescore_serial_mean``), one
    ``rescore.device-resample`` span a chunk.  ``series`` is the padded
    float32[nsamples] series on that device (the mean everywhere, the
    first ``max(n_steps, 0)`` gathered samples in front), the oracle's
    ``resample`` bit for bit; ``mean`` is a numpy float32.  On a CPU
    tensor the kernels run their plain versions."""
    import torch

    from ..ops.resample import exact_mean_params, resample_stream, stream_params
    from ..runtime import metrics, tracing

    for c in range(0, len(rows), DEVICE_CHUNK):
        chunk = rows[c : c + DEVICE_CHUNK]
        n, dt = chunk[0].nsamples_unpadded, chunk[0].dt
        with tracing.span("rescore.device-resample", templates=len(chunk)):
            params = stream_params(*([getattr(r, f) for r in chunk] for f in ("tau", "omega", "psi0", "s0")),
                                   device=ts.device)
            raw = resample_stream(ts, params, n_unpadded=n, dt=dt, count_as="rescore_resample")[0]
            n_steps, mean = (
                x.cpu().numpy()
                for x in exact_mean_params(ts, params, n_unpadded=n, dt=dt, count_as="rescore_serial_mean")
            )
            metrics.counter("rescore.device_resamples").inc(len(chunk))
        for t, row in enumerate(chunk):
            m = max(int(n_steps[t]), 0)
            series = torch.full((row.nsamples,), float(mean[t]), dtype=torch.float32, device=ts.device)
            series[:m] = raw[t].t().reshape(-1)[:m]  # the two parities interleaved
            yield series, int(n_steps[t]), mean[t]


def unique_winner_count(emitted: np.ndarray) -> int:
    """Distinct winning templates among the live emitted rows."""
    live = emitted[emitted["n_harm"] > 0]
    return len({_template_key(r["P_b"], r["tau"], r["Psi"]) for r in live})


def rescore_winners(
    ts, candidates_all: np.ndarray, emitted: np.ndarray, derived: DerivedParams
) -> tuple[np.ndarray, int]:
    """A copy of the 500-entry toplist with oracle powers for every
    template among the ``emitted`` winners, and the number of templates
    that ran an oracle pass.  ``ts`` is the searched series as a torch
    tensor (the session's, on its device): each pass takes its resampled
    series and its spectrum from that device (:func:`device_series`, one
    template at a time).  The powers are the host oracle's bit for bit,
    except where the two float64 transforms round to either side of a
    float32 value (about one value in 10^7).  The caller finalizes the
    patched toplist again, so the statistics, sort and dedup see the new
    powers."""
    import torch

    if not isinstance(ts, torch.Tensor):
        raise TypeError(f"rescore_winners takes the searched series as a torch tensor, not {type(ts).__name__}")
    if len(emitted) == 0:
        return candidates_all, 0
    wanted, entry_key = _winning_pairs(candidates_all, emitted)
    if not wanted:
        return candidates_all, 0

    from ..runtime import metrics

    metrics.gauge("rescore.workers").set(1)  # the run report's width of the pass: the calling thread
    tpls = sorted(wanted)
    rows = [ResampleParams.from_template(*tpl, derived.dt, derived.nsamples, derived.n_unpadded) for tpl in tpls]
    scored = {tpl: _score_series(series, derived, tpl, wanted[tpl])
              for tpl, (series, _, _) in zip(tpls, device_series(ts, rows))}

    out = candidates_all.copy()
    for i, key in enumerate(entry_key):
        if key is not None:
            tpl, k, f0 = key
            out["power"][i] = scored[tpl][(k, f0)]
    return out, len(scored)
