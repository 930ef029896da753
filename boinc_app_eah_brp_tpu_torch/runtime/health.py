"""Numerical-health watchdog: online finiteness/range checks and a
sentinel-template drift probe.

Counterpart of the reference package's ``runtime/health.py``.  Silent
numerical corruption is the worst failure a search has: a NaN in the
resample/FFT chain never reaches the carried (M, T) maxima, because
``NaN > M`` is false, so the merge drops every poisoned template and the
run ends with a plausible but wrong toplist.  Two online checks:

* **Batch checks.**  ``models/search.py::BankStep(with_health=True)``
  returns a float32[4] device vector a batch
  (:func:`~..models.search.batch_health_vec`), computed from the batch's
  summed spectra before the max-merge (the only place a NaN is still
  visible): the non-finite count over valid slots, the non-finite count
  of the merged M state, and the finite max/min summed power.  The
  dispatch loop hands them to :class:`Watchdog` without waiting, and the
  watchdog fetches them at the configured template cadence: that fetch is
  the loop's one host wait.
* **Sentinel drift probe.**  :class:`SentinelProbe` re-runs K fixed
  templates at each checkpoint through a one-template device search
  (kernel A at T = 1, kernel B, a batch-1 rfft and kernel C) and through
  the host oracle (``oracle/rescore.py``), and compares the peak summed
  power's relative error with the golden tolerance.  It catches drift
  (a corrupted kernel library, bad device memory) that finiteness checks
  cannot.

Violations increment metrics counters, land in the flight-recorder ring,
and warn or abort (:class:`HealthError`) per ``ERP_HEALTH_ACTION``.

Env surface: ``ERP_HEALTH_EVERY`` (template cadence; 0 = off, the
default), ``ERP_HEALTH_ACTION`` (``warn`` | ``abort``, default warn),
``ERP_HEALTH_SENTINELS`` (K fixed templates, default 2),
``ERP_HEALTH_TOL`` (sentinel relative-error tolerance, default 1e-2).

The disabled path never imports torch: this module is import-light and
:func:`watchdog` returns None before any device code is touched.
"""

from __future__ import annotations

import os

import numpy as np

from . import flightrec, metrics
from . import logging as erplog

HEALTH_EVERY_ENV = "ERP_HEALTH_EVERY"
HEALTH_ACTION_ENV = "ERP_HEALTH_ACTION"
HEALTH_SENTINELS_ENV = "ERP_HEALTH_SENTINELS"
HEALTH_TOL_ENV = "ERP_HEALTH_TOL"

_DEFAULT_SENTINELS = 2
_DEFAULT_TOL = 1e-2  # the golden-candidate rtol of the reference package

# powers are sums of |FFT|^2, finite float32 by construction; anything at
# this scale means an overflow upstream even if not yet inf
_RANGE_MAX = 1.0e30


class HealthError(RuntimeError):
    """A numerical-health violation under ``ERP_HEALTH_ACTION=abort``."""


def every() -> int:
    """Template cadence from ``ERP_HEALTH_EVERY``; 0 (default) = off."""
    try:
        return max(0, int(os.environ.get(HEALTH_EVERY_ENV, "0")))
    except ValueError:
        return 0


def action() -> str:
    a = (os.environ.get(HEALTH_ACTION_ENV, "warn") or "warn").strip().lower()
    return a if a in ("warn", "abort") else "warn"


def tolerance() -> float:
    try:
        return float(os.environ.get(HEALTH_TOL_ENV, _DEFAULT_TOL))
    except ValueError:
        return _DEFAULT_TOL


def sentinel_count() -> int:
    try:
        return max(0, int(os.environ.get(HEALTH_SENTINELS_ENV, _DEFAULT_SENTINELS)))
    except ValueError:
        return _DEFAULT_SENTINELS


def watchdog():
    """The run's :class:`Watchdog`, or None when ``ERP_HEALTH_EVERY`` is
    unset or 0: the no-op path that keeps the dispatch loop unchanged."""
    n = every()
    if n <= 0:
        return None
    return Watchdog(n, action())


class Watchdog:
    """Evaluates the per-batch health vectors at template cadence.

    The dispatch loop ``push``es each batch's device health vector (no
    wait); once ``every`` templates have accumulated, ``maybe_check``
    copies the pending vectors to the host and evaluates them.  A
    violation increments ``health.violations``, records a flight-recorder
    event, and warns or raises :class:`HealthError` per the action.
    """

    def __init__(self, every_n: int, act: str = "warn"):
        self.every = max(1, int(every_n))
        self.action = act
        self.violations = 0
        self._pending: list[tuple[int, int, object]] = []  # (start, stop, vec)
        self._since = 0
        self._m_checks = metrics.counter("health.checks")
        self._m_nonfinite = metrics.counter("health.nonfinite")
        self._m_violations = metrics.counter("health.violations")
        self._m_smax = metrics.gauge("health.spectrum_max")

    def push(self, start: int, stop: int, health_vec) -> None:
        """Queue one batch's health vector (a device tensor: no wait)."""
        self._pending.append((start, stop, health_vec))
        self._since += stop - start

    def due(self) -> bool:
        return self._since >= self.every

    def maybe_check(self, where: str) -> None:
        if self._pending and self.due():
            self.check(where)

    def check(self, where: str) -> None:
        """Fetch and evaluate every pending batch's health vector."""
        pending, self._pending = self._pending, []
        self._since = 0
        if not pending:
            return
        self._m_checks.inc()
        import torch

        # one copy from the card for all the pending vectors
        host = torch.stack([vec for _, _, vec in pending]).cpu().numpy().astype(np.float64)
        smax_all = None
        for (start, stop, _), a in zip(pending, host):
            nf_batch, nf_state, smax, smin = int(a[0]), int(a[1]), float(a[2]), float(a[3])
            if nf_batch:
                self._m_nonfinite.inc(nf_batch)
                self._violation(
                    where,
                    "nonfinite-spectrum",
                    f"{nf_batch} non-finite power-spectrum values in templates [{start}, {stop})",
                    start=start, stop=stop, count=nf_batch,
                )
            elif smax > _RANGE_MAX or smin < 0.0:
                # range checks only mean something on a finite batch
                self._violation(
                    where,
                    "power-out-of-range",
                    f"summed power out of range in templates [{start}, {stop}): max={smax:.6g} min={smin:.6g}",
                    start=start, stop=stop, max=smax, min=smin,
                )
            if nf_state:
                self._violation(
                    where,
                    "nonfinite-state",
                    f"{nf_state} non-finite entries in the carried maxima state after templates [{start}, {stop})",
                    start=start, stop=stop, count=nf_state,
                )
            if np.isfinite(smax):
                smax_all = smax if smax_all is None else max(smax_all, smax)
        if smax_all is not None:
            self._m_smax.set(smax_all)

    def _violation(self, where: str, kind: str, msg: str, **fields) -> None:
        self.violations += 1
        self._m_violations.inc()
        flightrec.record("health-violation", where=where, what=kind, **fields)
        if self.action == "abort":
            erplog.error("Numerical health violation (%s): %s\n", where, msg)
            raise HealthError(f"numerical health violation ({where}): {msg}")
        erplog.warn("Numerical health violation (%s): %s\n", where, msg)

    def sentinel_violation(self, msg: str, **fields) -> None:
        """Shared warn/abort handling for the sentinel probe."""
        self._violation("sentinel", "sentinel-drift", msg, **fields)


class SentinelProbe:
    """Re-run K fixed templates through the device pipeline and the host
    oracle at checkpoint cadence; compare the peak summed power's relative
    error with the golden tolerance.

    ``get_ts()`` returns the searched series: the device tensor the search
    runs on (read at each probe, so the probe holds no device memory of
    its own) or a host array, then uploaded to ``device`` at each probe.
    The oracle side is computed once per template (first probe) and
    cached: later probes detect device-side drift over the run.  Cost per
    probe after the first: K one-template device searches and K
    comparisons; the first also makes the batch-1 transform's twiddle tables
    (or its cuFFT plan where ``ops/spectrum.py::r2c_split`` has no split)."""

    def __init__(
        self,
        get_ts,
        bank_P: np.ndarray,
        bank_tau: np.ndarray,
        bank_psi0: np.ndarray,
        geom,
        derived,
        wd: Watchdog,
        k: int | None = None,
        device="cuda",
    ):
        self._get_ts = get_ts
        self._P = np.asarray(bank_P)
        self._tau = np.asarray(bank_tau)
        self._psi0 = np.asarray(bank_psi0)
        self._geom = geom
        self._derived = derived
        self._wd = wd
        self._device = device
        n = len(self._P)
        k = sentinel_count() if k is None else int(k)
        if n == 0 or k == 0:
            self.indices = np.zeros(0, dtype=int)
        else:
            self.indices = np.unique(np.linspace(0, n - 1, min(k, n)).round().astype(int))
        self._ts = None
        self._golden: dict[int, tuple[int, int, float]] = {}
        self._m_probes = metrics.counter("health.sentinel_probes")
        self._m_err = metrics.gauge("health.sentinel_max_rel_err")
        # per-template relative errors as a histogram, so a fleet rollup can
        # report drift percentiles across hosts
        self._m_hist = metrics.histogram(
            "health.sentinel_rel_err",
            buckets=(1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1),
            unit="rel",
        )

    def _series(self) -> np.ndarray:
        """The searched series on the host (copied once)."""
        if self._ts is None:
            ts = self._get_ts()
            if hasattr(ts, "cpu"):
                ts = ts.cpu().numpy()
            self._ts = np.asarray(ts, dtype=np.float32)
        return self._ts

    def _device_series(self):
        import torch

        ts = self._get_ts()
        if isinstance(ts, torch.Tensor):
            return ts
        from ..device import resolve_device

        return torch.from_numpy(np.ascontiguousarray(ts, dtype=np.float32)).to(resolve_device(self._device))

    def _device_peak(self, t: int) -> tuple[int, int, float]:
        """(k, f0, power) of the device pipeline's peak summed power for
        template ``t``, among candidate-eligible bins (f0 >= window_2, as
        the toplist scans)."""
        from ..models import search as msearch

        sums = msearch.template_sumspec(self._device_series(), self._P[t], self._tau[t], self._psi0[t], self._geom)
        nat = msearch.state_to_natural(sums, self._geom)  # (5, fund_hi)
        lo = int(self._geom.window_2)
        window = nat[:, lo:]
        k_h, f0 = np.unravel_index(int(np.argmax(window)), window.shape)
        return int(k_h), int(f0) + lo, float(window[k_h, f0])

    def _oracle_power(self, t: int, k: int, f0: int) -> float:
        from ..oracle.rescore import _score_template, _template_key

        tpl = _template_key(self._P[t], self._tau[t], self._psi0[t])
        scored = _score_template(self._series(), self._derived, tpl, [(k, f0)])
        return float(scored[(k, f0)])

    def probe(self, where: str = "checkpoint") -> list[dict]:
        """Run the probe; returns per-sentinel records (also pushed into
        the flight recorder).  Violations go through the watchdog's
        warn/abort action."""
        results = []
        max_err = 0.0
        for t in self.indices:
            t = int(t)
            k_h, f0, dev_p = self._device_peak(t)
            cached = self._golden.get(t)
            if cached is None or cached[:2] != (k_h, f0):
                golden = self._oracle_power(t, k_h, f0)
                self._golden[t] = (k_h, f0, golden)
            else:
                golden = cached[2]
            rel = abs(dev_p - golden) / max(abs(golden), 1e-30)
            # a NaN device power makes rel NaN, and NaN > tol is False:
            # treat any non-finite comparison as maximal drift
            if not np.isfinite(rel):
                rel = float("inf")
            max_err = max(max_err, rel)
            self._m_hist.observe(rel)
            rec = {"template": t, "harmonics": 1 << k_h, "f0": f0, "device": dev_p, "oracle": golden, "rel_err": rel}
            results.append(rec)
            if rel > tolerance():
                # drill down before alarming: the precision observatory
                # re-runs this template stage by stage against the f64
                # reference, so the alarm names the stage that introduced
                # the error.  Best effort: the drill-down must never mask
                # the violation itself.
                try:
                    from .precision import attribute_template

                    attrib = attribute_template(
                        self._series(), self._geom, self._derived,
                        float(self._P[t]), float(self._tau[t]), float(self._psi0[t]),
                        device=self._device_series().device,
                    )
                except Exception:
                    attrib = None
                stage_note = ""
                if attrib:
                    rec["worst_stage"] = attrib["worst_stage"]
                    rec["stage_rel_err"] = attrib["stage_rel_err"]
                    stage_note = (
                        f"; worst stage {attrib['worst_stage']} (introduced rel err "
                        f"{attrib['stage_rel_err'][attrib['worst_stage']]:.3g})"
                    )
                self._wd.sentinel_violation(
                    f"sentinel template {t} drifted: device {dev_p:.9g} vs oracle {golden:.9g} "
                    f"(rel err {rel:.3g} > {tolerance():.3g}){stage_note}",
                    **rec,
                )
        self._m_probes.inc()
        self._m_err.set(max_err)
        flightrec.record("sentinel-probe", where=where, n=len(results), max_rel_err=max_err)
        erplog.debug("Sentinel probe: %d templates, max rel err %.3g.\n", len(results), max_err)
        return results
