"""Retry policy, error classification, and the graceful-degradation ladder.

The reference survives hostile volunteer hosts by checkpointing and being
restartable; a transient failure still costs the whole process.  This layer
recovers IN-process where possible.  It is the first half of the JAX
package's ``runtime/resilience.py`` (the shard leases of multi-host runs
are not ported):

* :func:`classify` sorts exceptions into ``transient`` (a retry can win:
  device out-of-memory — ``torch.cuda.OutOfMemoryError``, cuFFT's
  ``CUFFT_ALLOC_FAILED`` — device-busy style errors, EIO/EAGAIN/EINTR I/O
  errors, injected transient faults) vs ``permanent`` (bad input, logic
  errors, and a sticky CUDA context error such as an illegal memory
  access or a device-side assert: after one every CUDA call fails, so the
  process must exit and be restarted by BOINC or ``--supervised``).
* :class:`RetryPolicy` holds the per-run retry budget (shared across all
  sites so a flapping device can't starve the checkpoint writer) plus
  exponential backoff with jitter.
* :class:`DegradationLadder` makes the dispatch-loop recovery decisions:
  on device OOM halve the batch and re-dispatch (after
  :func:`release_device_memory`); anything else transient retries.  There
  is no fallback rung: a kernel that fails is not replaced by its plain
  version.
* :class:`DispatchSnapshot` keeps a host copy of the (M, T) maxima state,
  refreshed only where the host already waits on the card, so a failed
  dispatch restarts from the last snapshot instead of from scratch.

Every recovery step lands in ``resilience.*`` metrics and flightrec events
so a run report shows WHAT degraded, not just that the run finished.
Disable the whole layer with ``ERP_RETRY_BUDGET=0`` (the dispatch loop
then also skips the snapshot copies).  Never imports torch: host policy
only; callers rebuild device state from the numpy snapshots themselves.
"""

from __future__ import annotations

import errno as _errno
import os
import random
import sys
import threading
import time

import numpy as np

from . import flightrec, metrics, tracing
from . import logging as erplog
from .faultinject import InjectedFault

ENV_BUDGET = "ERP_RETRY_BUDGET"  # per-run retries across all sites; 0 = off
ENV_BASE_S = "ERP_RETRY_BASE_S"
ENV_MAX_S = "ERP_RETRY_MAX_S"
ENV_SNAPSHOT_S = "ERP_RESIL_SNAPSHOT_S"

DEFAULT_BUDGET = 8
DEFAULT_BASE_S = 0.05
DEFAULT_MAX_S = 5.0

# substrings of runtime error messages that mark a failure worth
# retrying: torch.cuda.OutOfMemoryError says "CUDA out of memory", cuFFT's
# plan allocation failure "CUFFT_ALLOC_FAILED"; the upper-case markers are
# the JAX package's, kept so an injected fault reads the same in both
_TRANSIENT_MARKERS = (
    "RESOURCE_EXHAUSTED",
    "OUT_OF_MEMORY",
    "out of memory",
    "CUFFT_ALLOC_FAILED",
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "ABORTED",
    "device busy",
    "temporarily unavailable",
)

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "OUT_OF_MEMORY", "out of memory", "CUFFT_ALLOC_FAILED")

# a sticky CUDA context error: the context is unusable from then on, so no
# in-process retry can succeed, whatever else the message says
_STICKY_MARKERS = (
    "illegal memory access",
    "device-side assert",
    "unspecified launch failure",
    "misaligned address",
    "illegal instruction",
)

_TRANSIENT_ERRNOS = {
    _errno.EIO,
    _errno.EAGAIN,
    _errno.EINTR,
    _errno.EBUSY,
}


def is_sticky(exc: BaseException) -> bool:
    """A CUDA error that poisons the context (see ``_STICKY_MARKERS``)."""
    msg = str(exc)
    return any(m in msg for m in _STICKY_MARKERS)


def is_oom(exc: BaseException) -> bool:
    """Device/host memory exhaustion — the failure class the ladder
    answers with a smaller batch rather than a plain retry."""
    if isinstance(exc, MemoryError):
        return True
    if is_sticky(exc):
        return False
    msg = str(exc)
    return any(m in msg for m in _OOM_MARKERS)


def classify(exc: BaseException) -> str:
    """``"transient"`` (retry may win) or ``"permanent"``."""
    if isinstance(exc, InjectedFault):
        return "transient" if exc.transient else "permanent"
    if isinstance(exc, MemoryError):
        return "transient"
    if is_sticky(exc):
        return "permanent"
    if isinstance(exc, OSError):
        return (
            "transient" if exc.errno in _TRANSIENT_ERRNOS else "permanent"
        )
    msg = str(exc)
    if any(m in msg for m in _TRANSIENT_MARKERS):
        return "transient"
    return "permanent"


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class RetryPolicy:
    """Per-run retry budget + exponential backoff with jitter.

    The budget is shared across every site (dispatch, checkpoint write,
    result write): ``try_spend`` is the single gate, so total in-process
    recovery work is bounded no matter which subsystem is flapping."""

    def __init__(
        self,
        budget: int | None = None,
        base_s: float | None = None,
        max_s: float | None = None,
        seed: int = 0,
    ):
        self.budget = (
            _env_int(ENV_BUDGET, DEFAULT_BUDGET) if budget is None else budget
        )
        self.base_s = (
            _env_float(ENV_BASE_S, DEFAULT_BASE_S) if base_s is None else base_s
        )
        self.max_s = (
            _env_float(ENV_MAX_S, DEFAULT_MAX_S) if max_s is None else max_s
        )
        self.spent = 0
        self._lock = threading.Lock()
        self._rng = random.Random(seed)

    def enabled(self) -> bool:
        return self.budget > 0

    def remaining(self) -> int:
        with self._lock:
            return max(0, self.budget - self.spent)

    def try_spend(self, site: str, exc: BaseException) -> bool:
        """Spend one retry on ``exc`` at ``site``.  False when the error
        is permanent or the budget is gone — the caller must re-raise."""
        if classify(exc) != "transient":
            return False
        with self._lock:
            if self.spent >= self.budget:
                erplog.warn(
                    "Retry budget exhausted (%d) at %s; giving up on: %s\n",
                    self.budget, site, exc,
                )
                return False
            self.spent += 1
            n = self.spent
        metrics.counter("resilience.retries").inc()
        flightrec.record(
            "retry", site=site, error=type(exc).__name__,
            spent=n, budget=self.budget,
        )
        erplog.warn(
            "Transient failure at %s (%s: %s); retry %d/%d.\n",
            site, type(exc).__name__, exc, n, self.budget,
        )
        return True

    def backoff_s(self, attempt: int) -> float:
        """Exponential backoff for the ``attempt``-th retry (0-based),
        capped at ``max_s``, with +/-25% jitter so a fleet of workers
        retrying a shared resource doesn't stampede in lockstep."""
        base = min(self.max_s, self.base_s * (2.0 ** min(attempt, 16)))
        return max(0.0, base * (1.0 + 0.25 * (self._rng.random() * 2.0 - 1.0)))

    def sleep(self, attempt: int, site: str | None = None) -> None:
        delay = self.backoff_s(attempt)
        if delay > 0.0:
            # the backoff wall is a first-class stall on the timeline:
            # trace_report attributes it separately from real work
            with tracing.span(
                "retry-backoff", site=site or "?", attempt=attempt,
                delay_s=round(delay, 3),
            ):
                time.sleep(delay)


# one policy per run: the driver resets it at run start (begin_run), and
# every site — the dispatch ladder, checkpoint writes, the result write —
# draws from the same budget
_run_policy: RetryPolicy | None = None
_policy_lock = threading.Lock()


def begin_run() -> RetryPolicy | None:
    """Fresh per-run policy from the environment; None when disabled
    (``ERP_RETRY_BUDGET=0``)."""
    global _run_policy
    with _policy_lock:
        pol = RetryPolicy()
        _run_policy = pol if pol.enabled() else None
        return _run_policy


def policy() -> RetryPolicy | None:
    """The current run's policy, lazily created from the environment for
    callers outside a driver run (direct run_bank users, tests)."""
    with _policy_lock:
        if _run_policy is not None and _run_policy.enabled():
            return _run_policy
    return begin_run()


def call_with_retry(fn, site: str, retry_policy: RetryPolicy | None = None):
    """Run ``fn()``; on a transient exception spend from the policy's
    budget, back off, and try again.  Permanent errors and budget
    exhaustion re-raise the original exception."""
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:
            pol = retry_policy if retry_policy is not None else policy()
            if pol is None or not pol.try_spend(site, e):
                raise
            pol.sleep(attempt, site=site)
            attempt += 1


def snapshot_interval_s() -> float:
    """How often the dispatch loops refresh their host-side recovery
    snapshot (the only d2h the resilience layer adds).  Matches the
    checkpoint-cadence order of magnitude by default; 0 = every drain
    boundary (tests)."""
    return max(0.0, _env_float(ENV_SNAPSHOT_S, 30.0))


def _host_copy(x) -> np.ndarray:
    """A host numpy copy of a torch tensor (on any device) or an array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy().copy()
    return np.array(np.asarray(x), copy=True)


class DispatchSnapshot:
    """Host-side recovery point for the dispatch loop.

    A failed step may leave the device state half-updated, so recovery
    needs host copies.  ``maybe_commit`` refreshes them where the host
    already waits on the card (the checkpoint's and the screensaver's
    copies), throttled to :func:`snapshot_interval_s`, never per batch:
    the port's loop queues ahead without waiting.  It takes tensors or
    the host copies the caller already made.  On failure ``restore``
    hands back the numpy arrays (or None when the loop started from no
    state) plus the template index to re-dispatch from."""

    def __init__(self, state, start: int, interval_s: float | None = None):
        self._interval = (
            snapshot_interval_s() if interval_s is None else interval_s
        )
        self.start = int(start)
        if state is None:
            self._M = self._T = None
        else:
            self._M = _host_copy(state[0])
            self._T = _host_copy(state[1])
        self._last = time.monotonic()
        self.commits = 0

    def maybe_commit(self, M, T, done: int) -> None:
        if time.monotonic() - self._last >= self._interval:
            self.commit(M, T, done)

    def commit(self, M, T, done: int) -> None:
        self._M = _host_copy(M)
        self._T = _host_copy(T)
        self.start = int(done)
        self._last = time.monotonic()
        self.commits += 1

    def restore(self):
        """(state_or_None, start): ``state`` as host numpy (M, T)."""
        if self._M is None:
            return None, self.start
        return (self._M, self._T), self.start


class DegradationLadder:
    """Recovery decisions for the dispatch loop, one rung per retry.

    * device OOM -> halve the batch (down to 1) and re-dispatch from the
      snapshot (the caller first releases the failed attempt's memory,
      :func:`release_device_memory`);
    * any other transient failure -> plain retry.

    ``record_failure`` returns False when the caller must re-raise
    (permanent error or exhausted budget)."""

    def __init__(self, retry_policy: RetryPolicy, batch_size: int):
        self.policy = retry_policy
        self.batch_size = int(batch_size)
        self.attempt = 0

    def record_failure(self, site: str, exc: BaseException) -> bool:
        if self.policy is None or not self.policy.try_spend(site, exc):
            return False
        self.attempt += 1
        if is_oom(exc) and self.batch_size > 1:
            self.batch_size = max(1, self.batch_size // 2)
            metrics.counter("resilience.batch_halved").inc()
            metrics.gauge("resilience.batch_size").set(self.batch_size)
            flightrec.record(
                "batch-halved", site=site, batch_size=self.batch_size
            )
            erplog.warn(
                "Device memory exhausted; halving batch to %d and "
                "re-dispatching from the last snapshot.\n", self.batch_size,
            )
        return True

    def sleep(self) -> None:
        self.policy.sleep(max(0, self.attempt - 1), site="dispatch")


def release_device_memory() -> None:
    """Return what a failed attempt left cached to the card: the caching
    allocator's free blocks and every cuFFT plan (a plan of a large batch
    holds its work area, over a GB at production width).  A no-op in a
    process that has not initialised CUDA."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return
    for i in range(torch.cuda.device_count()):
        torch.backends.cuda.cufft_plan_cache[i].clear()
    torch.cuda.empty_cache()
