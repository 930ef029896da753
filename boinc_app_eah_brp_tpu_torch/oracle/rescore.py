"""Host-oracle rescoring of the winning candidates.

After the (M, T) -> toplist conversion, every template among the emitted
winners runs once through the oracle (``oracle/resample.py``'s reference
chain, numpy's FFT or the same float64 transform on the session's device,
and a point evaluation of the harmonic sums)
and the toplist entries of those templates take the oracle's powers.  The
candidate file then carries the reference's powers whatever FFT library
and float contraction the device used, and it is the same file the JAX
package writes by default.

Cost: one oracle pass per unique winning template; on a numpy series
they run on a thread pool (numpy releases the interpreter lock in the
FFT and the large elementwise operations).  :class:`IncrementalRescorer`
overlaps that work with the search: each committed checkpoint already
builds the current toplist, so its winners are scored in the background
while the card searches on, and the end-of-run pass only scores what won
after the last checkpoint.  The scores are the same either way: a cached
value is reused only for the exact (template, level, bin) it was
computed for.

The end-of-run pass of a session runs after the template loop, when the
card is idle, and takes each template's spectrum from the card
(:func:`device_series`: kernel A's LUT gather and the exact serial mean,
both bitwise the oracle's resample, padded there; then
``spectrum.power_at_on_device``: one float64 rfft, the bins the harmonic
sums read and the float32 power epilogue), so the host copies a few
thousand powers a template and evaluates the harmonic sums.  The
background passes of :class:`IncrementalRescorer` run while the card
searches, so they keep the host oracle's resample and numpy's FFT; a
session on a card arms none, since its end-of-run pass takes ~10 ms a
template there.

Each pass is spans of ``runtime/tracing.py``: ``rescore.resample`` (a
host resample), ``rescore.fft`` (the transform and the powers at the
bins: numpy's on the host, or on the series' device) and
``rescore.harmonics``, each with its template, and one
``rescore.device-resample`` a chunk of device-resampled templates; it
counts one ``rescore.templates``, each device-resampled template one
``rescore.device_resamples`` and each spectrum taken on the device one
``rescore.device_ffts``.  The host pool's threads carry the workunit id
of the thread that handed them the work.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor

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


def overlap_enabled() -> bool:
    """``ERP_RESCORE_OVERLAP=off`` (or ``0``, ``none``) turns the
    checkpoint-cadence background rescoring (:class:`IncrementalRescorer`)
    off; the end-of-run pass then scores every winner.  On by default."""
    return os.environ.get("ERP_RESCORE_OVERLAP", "").strip().lower() not in _OFF


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
    ts,
    candidates_all: np.ndarray,
    emitted: np.ndarray,
    derived: DerivedParams,
    max_workers: int | None = None,
    cache: dict | None = None,
) -> tuple[np.ndarray, int]:
    """A copy of the 500-entry toplist with oracle powers for every
    template among the ``emitted`` winners, and the number of templates
    that ran an oracle pass.  ``ts`` is the searched series: a torch
    tensor (the session's, on its device) gives each pass its resampled
    series and its spectrum from that device (:func:`device_series`, one
    template at a time), a numpy array the host oracle's resample and
    numpy's FFT on a pool of ``max_workers`` threads (up to 8).  The
    powers are the same bit for bit, except where the two float64
    transforms round to either side of a float32 value (about one value
    in 10^7).
    ``cache`` (``{template: {(k, f0): power}}``,
    from :class:`IncrementalRescorer`) saves the pass of every template
    whose pairs it already holds.  The caller finalizes the patched
    toplist again, so the statistics, sort and dedup see the new powers."""
    if len(emitted) == 0:
        return candidates_all, 0
    wanted, entry_key = _winning_pairs(candidates_all, emitted)
    if not wanted:
        return candidates_all, 0
    cache = cache or {}

    scored: dict[tuple, dict] = {}
    todo: dict[tuple, set] = {}
    for tpl, pairs in wanted.items():
        have = cache.get(tpl, {})
        scored[tpl] = {p: have[p] for p in pairs if p in have}
        missing = pairs - scored[tpl].keys()
        if missing:
            todo[tpl] = missing

    import torch

    from ..runtime import metrics, tracing

    if isinstance(ts, torch.Tensor):
        metrics.gauge("rescore.workers").set(1)
        tpls = sorted(todo)
        rows = [ResampleParams.from_template(*tpl, derived.dt, derived.nsamples, derived.n_unpadded) for tpl in tpls]
        fresh = {tpl: _score_series(series, derived, tpl, todo[tpl])
                 for tpl, (series, _, _) in zip(tpls, device_series(ts, rows))}
    else:
        ts = np.asarray(ts, dtype=np.float32)
        wu = tracing.workunit()
        workers = max_workers or min(8, os.cpu_count() or 1, len(todo) or 1)
        metrics.gauge("rescore.workers").set(workers)

        def one(tpl):
            with tracing.for_workunit(wu):
                return tpl, _score_template(ts, derived, tpl, todo[tpl])

        if workers > 1 and len(todo) > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                fresh = dict(pool.map(one, sorted(todo)))
        else:
            fresh = dict(one(t) for t in sorted(todo))
    for tpl, pairs in fresh.items():
        scored[tpl].update(pairs)

    out = candidates_all.copy()
    for i, key in enumerate(entry_key):
        if key is not None:
            tpl, k, f0 = key
            out["power"][i] = scored[tpl][(k, f0)]
    return out, len(fresh)


class IncrementalRescorer:
    """Oracle rescoring that overlaps the search.

    The session hands :meth:`observe_async` the toplist each committed
    checkpoint builds from its host copy of (M, T).  A feed worker
    finalizes it and submits every winning template and pair not yet
    scored to a pool.  The host series is fetched by the first worker
    that needs it (``get_ts``).  :meth:`finalize` drains both and returns
    the score cache for ``rescore_winners(cache=...)``."""

    def __init__(self, get_ts, derived: DerivedParams, t_obs: float, max_workers: int | None = None):
        self._get_ts = get_ts
        self._derived = derived
        self._t_obs = float(t_obs)
        self._ts: np.ndarray | None = None
        self._ts_lock = threading.Lock()
        self._scored: dict[tuple, dict] = {}
        self._scored_lock = threading.Lock()
        self._pending: dict[tuple, set] = {}
        self._futures: list = []
        workers = max_workers or max(1, min(4, (os.cpu_count() or 1) - 1))
        self._pool: ThreadPoolExecutor | None = ThreadPoolExecutor(max_workers=workers)
        # one feed worker: observes run one at a time (``_pending`` needs no
        # lock) and the toplist build stays off the search thread
        self._feed: ThreadPoolExecutor | None = ThreadPoolExecutor(max_workers=1)
        self.observed = 0
        self.submitted = 0
        self.failed = 0

    def _series(self) -> np.ndarray:
        with self._ts_lock:
            if self._ts is None:
                self._ts = np.asarray(self._get_ts(), dtype=np.float32)
            return self._ts

    def _run(self, tpl: tuple, pairs: frozenset, wu: str | None) -> None:
        from ..runtime import tracing

        with tracing.for_workunit(wu):
            scores = _score_template(self._series(), self._derived, tpl, pairs)
        with self._scored_lock:
            self._scored.setdefault(tpl, {}).update(scores)

    def observe(self, candidates_all: np.ndarray) -> None:
        """Submit the unscored winners of the current toplist; returns at
        once."""
        pool = self._pool
        if pool is None:
            return
        from ..runtime import faultinject, flightrec, metrics, tracing
        from .toplist import finalize_candidates

        # an injected failure here fails this observe's future and counts
        # in finalize()'s ``failed``: the end-of-run rescore recomputes it
        faultinject.fault_point("rescore_feed", seq=self.observed + 1)
        self.observed += 1
        metrics.counter("rescore.observes").inc()
        flightrec.record("rescore", what="observe", seq=self.observed)
        emitted = finalize_candidates(candidates_all, self._t_obs)
        if len(emitted) == 0:
            return
        wanted, _ = _winning_pairs(candidates_all, emitted)
        wu = tracing.workunit()
        for tpl, pairs in wanted.items():
            with self._scored_lock:
                have = set(self._scored.get(tpl, {}))
            missing = pairs - have - self._pending.get(tpl, set())
            if not missing:
                continue
            self._pending.setdefault(tpl, set()).update(missing)
            self.submitted += 1
            metrics.counter("rescore.submitted").inc()
            try:
                self._futures.append(pool.submit(self._run, tpl, frozenset(missing), wu))
            except RuntimeError:
                # finalize() or abort() shut the pool down meanwhile; the
                # end-of-run rescore computes whatever is missing
                return

    def observe_async(self, build) -> None:
        """Feed the rescorer without blocking the search: ``build()`` (the
        toplist from host copies of the state, which its closure must
        hold: the next batch overwrites the device state in place) runs
        on the feed worker, then flows into :meth:`observe`."""
        feed = self._feed
        if feed is None:
            return
        from ..runtime import tracing, watchdog

        # the feed worker's span carries the trace context of the batch
        # whose checkpoint queued it, and its workunit
        ctx, wu = tracing.context(), tracing.workunit()

        def feed_observe():
            tracing.set_context(ctx)
            tracing.set_workunit(wu)
            with watchdog.guard("rescore_feed"), tracing.span("rescore-feed", tid="rescore-feed"):
                self.observe(build())

        try:
            self._futures.append(feed.submit(feed_observe))
        except RuntimeError:
            pass  # shut down meanwhile; nothing to feed

    def finalize(self) -> dict:
        """Drain the feed worker and the pool; returns the score cache.
        A failed worker only shrinks the cache (``rescore_winners``
        computes what is missing); ``failed`` counts them."""
        feed, self._feed = self._feed, None
        if feed is not None:
            feed.shutdown(wait=True)  # queued observes submit scoring work
        pool, self._pool = self._pool, None
        if pool is None:
            return self._scored
        pool.shutdown(wait=True)
        self.failed += sum(1 for f in self._futures if f.exception() is not None)
        if self.failed:
            from ..runtime import metrics

            metrics.counter("rescore.failed").inc(self.failed)
        return self._scored

    def series_if_fetched(self) -> np.ndarray | None:
        """The host series a worker already fetched, or None."""
        with self._ts_lock:
            return self._ts

    def abort(self) -> None:
        """Quit or error: drop queued work without waiting.  Safe to call
        more than once and after :meth:`finalize`."""
        feed, self._feed = self._feed, None
        if feed is not None:
            feed.shutdown(wait=False, cancel_futures=True)
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
