"""Retry policy, error classification, and the graceful-degradation ladder.

The reference survives hostile volunteer hosts by checkpointing and being
restartable; a transient failure still costs the whole process.  This layer
recovers IN-process where possible, and the shard-lease board carries a
multi-process search past the loss of a whole process.  Counterpart of
the JAX package's ``runtime/resilience.py``:

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
* :class:`LeaseBoard` (the host-loss rung): shard leases, heartbeats and
  adoption on a directory every process can reach (``ERP_SHARD_DIR``), in
  the JAX package's file formats, so a board one package writes the other
  joins.

Every recovery step lands in ``resilience.*`` metrics and flightrec events
so a run report shows WHAT degraded, not just that the run finished.
Disable the whole layer with ``ERP_RETRY_BUDGET=0`` (the dispatch loop
then also skips the snapshot copies).  Never imports torch: host policy
only; callers rebuild device state from the numpy snapshots themselves.
"""

from __future__ import annotations

import errno as _errno
import json
import os
import random
import sys
import threading
import time
from dataclasses import dataclass, replace

import numpy as np

from . import faultinject, flightrec, metrics, tracing, watchdog
from . import logging as erplog
from .faultinject import InjectedFault

ENV_BUDGET = "ERP_RETRY_BUDGET"  # per-run retries across all sites; 0 = off
ENV_BASE_S = "ERP_RETRY_BASE_S"
ENV_MAX_S = "ERP_RETRY_MAX_S"
ENV_SNAPSHOT_S = "ERP_RESIL_SNAPSHOT_S"
ENV_LEASE_TIMEOUT_S = "ERP_LEASE_TIMEOUT_S"  # stale heartbeat -> host dead
ENV_LEASE_GRACE_S = "ERP_LEASE_GRACE_S"  # never-started host allowance

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
    holds its work area, over a GB at production width).  The plans are
    cleared under the lock every card transform holds
    (``ops/kernels.py::planned_fft``): a plan destroyed while a transform on
    another thread (a session prepared on the scheduler's prep thread) is
    using it is freed under that transform.  A no-op in a process that has
    not initialised CUDA."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return
    from ..ops import kernels

    with kernels._plan_lock:
        for i in range(torch.cuda.device_count()):
            torch.backends.cuda.cufft_plan_cache[i].clear()
        kernels.planned_keys.clear()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# Shard leases: the host-loss rung of the ladder.
#
# The classes above recover a single process from its own faults; the lease
# board generalizes that to losing an entire HOST of a multi-process search.
# It is a small directory protocol on a filesystem every host can reach
# (ERP_SHARD_DIR) — deliberately not a torch.distributed collective, so a
# dead host can never hang the survivors:
#
#   board.json           erp-shard-board/1: template count, the contiguous
#                        per-shard ranges, and the bank identity.  Created
#                        once with O_EXCL (first host wins); every other
#                        host verifies identity against its own inputs.
#   host-<id>.hb         heartbeat, freshness by mtime.  Older than
#                        ERP_LEASE_TIMEOUT_S => the host is presumed dead.
#   lease-<k>.json       erp-shard-lease/1: who owns shard k, at which
#                        adoption epoch, how far it got (n_done), and where
#                        its committed state lives.  Written atomically
#                        (tmp + rename) only by the current owner.
#   claim-<k>.<epoch>    empty O_EXCL marker: at most one host wins any
#                        (shard, epoch) takeover, so two survivors racing
#                        to adopt a dead host's shard cannot both own it.
#
# Epochs make ownership monotonic: every takeover (initial claim, restart
# re-attach, or adoption from a dead host) bumps the epoch, and a slow
# not-actually-dead former owner discovers the new epoch on its next
# committed write and abandons the shard instead of double-writing.
# --------------------------------------------------------------------------

BOARD_SCHEMA = "erp-shard-board/1"
LEASE_SCHEMA = "erp-shard-lease/1"
HEARTBEAT_SCHEMA = "erp-heartbeat/2"
MERGE_SHARD = -1  # pseudo-shard serializing the final cross-host merge

DEFAULT_LEASE_TIMEOUT_S = 60.0


class LeaseError(RuntimeError):
    """Shard-board protocol violation (identity mismatch, foreign write)."""


def lease_timeout_s() -> float:
    return max(0.05, _env_float(ENV_LEASE_TIMEOUT_S, DEFAULT_LEASE_TIMEOUT_S))


def lease_grace_s() -> float:
    """Startup allowance before a host that never heartbeat at all is
    declared dead (it may still be compiling)."""
    return max(0.0, _env_float(ENV_LEASE_GRACE_S, 2.0 * lease_timeout_s()))


@dataclass(frozen=True)
class ShardLease:
    """One shard's ownership record, as last read from the board."""

    shard: int
    start: int
    stop: int
    owner: str
    epoch: int
    n_done: int
    complete: bool = False
    released: bool = False
    state_path: str | None = None

    def to_doc(self) -> dict:
        return {
            "schema": LEASE_SCHEMA,
            "shard": self.shard,
            "start": self.start,
            "stop": self.stop,
            "owner": self.owner,
            "epoch": self.epoch,
            "n_done": self.n_done,
            "complete": self.complete,
            "released": self.released,
            "state_path": self.state_path,
        }

    @staticmethod
    def from_doc(doc: dict) -> "ShardLease":
        if doc.get("schema") != LEASE_SCHEMA:
            raise LeaseError(f"Bad lease schema: {doc.get('schema')!r}")
        return ShardLease(
            shard=int(doc["shard"]),
            start=int(doc["start"]),
            stop=int(doc["stop"]),
            owner=str(doc["owner"]),
            epoch=int(doc["epoch"]),
            n_done=int(doc["n_done"]),
            complete=bool(doc.get("complete", False)),
            released=bool(doc.get("released", False)),
            state_path=doc.get("state_path"),
        )


def read_heartbeat(path: str) -> dict | None:
    """Parse a ``host-<id>.hb`` file into ``{"wall", "monotonic",
    "mtime", "schema"}`` (None when absent/unreadable).

    ``erp-heartbeat/2`` files carry a wall+monotonic pair; legacy
    single-value files (one ``time.time()`` line) still parse, with
    ``monotonic`` None and schema ``erp-heartbeat/1``.  ``mtime`` is the
    shared filesystem's stamp of the same write, so ``wall - mtime``
    estimates the writing host's clock offset."""
    try:
        st = os.stat(path)
        with open(path, encoding="utf-8") as f:
            text = f.read().strip()
    except OSError:
        return None
    wall = monotonic = None
    schema = "erp-heartbeat/1"
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict):
        schema = str(doc.get("schema") or HEARTBEAT_SCHEMA)
        wall = doc.get("wall")
        monotonic = doc.get("monotonic")
    else:
        try:  # legacy single-value form
            wall = float(text.split()[0])
        except (ValueError, IndexError):
            pass
    if not isinstance(wall, (int, float)):
        return None
    return {
        "schema": schema,
        "wall": float(wall),
        "monotonic": (
            float(monotonic) if isinstance(monotonic, (int, float)) else None
        ),
        "mtime": st.st_mtime,
    }


def _write_json_atomic(path: str, doc: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_json(path: str) -> dict | None:
    """None when absent; retries a torn concurrent read briefly (writes
    are atomic renames, so any persistent parse failure is corruption)."""
    for _ in range(3):
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (json.JSONDecodeError, OSError):
            time.sleep(0.02)
    raise LeaseError(f"Unreadable board file: {path}")


class LeaseBoard:
    """This host's view of (and handle on) the shard-lease directory."""

    def __init__(
        self,
        root: str,
        host_id: str,
        timeout_s: float | None = None,
        grace_s: float | None = None,
    ):
        self.root = root
        self.host_id = host_id
        self.timeout_s = lease_timeout_s() if timeout_s is None else timeout_s
        self.grace_s = lease_grace_s() if grace_s is None else grace_s
        self._lost_announced: set[str] = set()
        os.makedirs(root, exist_ok=True)

    # -- board ------------------------------------------------------------
    def _board_path(self) -> str:
        return os.path.join(self.root, "board.json")

    def publish_board(
        self, n_templates: int, ranges: list[tuple[int, int]], identity: dict
    ) -> dict:
        """Create the board (first host wins the O_EXCL race) or verify an
        existing one describes the SAME search; a mismatch means two
        different runs were pointed at one shard dir."""
        doc = {
            "schema": BOARD_SCHEMA,
            "n_templates": int(n_templates),
            "ranges": [[int(a), int(b)] for a, b in ranges],
            "identity": identity,
        }
        path = self._board_path()
        try:
            fd = os.open(path + ".claim", os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            _write_json_atomic(path, doc)
            return doc
        except FileExistsError:
            return self.wait_board(expect=doc)

    def wait_board(
        self, expect: dict | None = None, timeout_s: float = 30.0
    ) -> dict:
        """Poll for the board (the publisher may still be writing it)."""
        deadline = time.monotonic() + timeout_s
        while True:
            doc = _read_json(self._board_path())
            if doc is not None:
                if doc.get("schema") != BOARD_SCHEMA:
                    raise LeaseError(
                        f"Bad board schema: {doc.get('schema')!r}"
                    )
                if expect is not None:
                    for key in ("n_templates", "ranges", "identity"):
                        if doc.get(key) != expect.get(key):
                            raise LeaseError(
                                f"Shard board mismatch on {key!r}: board has "
                                f"{doc.get(key)!r}, this host derived "
                                f"{expect.get(key)!r} — refusing to join a "
                                f"different search's shard dir."
                            )
                return doc
            if time.monotonic() >= deadline:
                raise LeaseError(
                    f"No shard board appeared in {self.root} within "
                    f"{timeout_s:.0f}s."
                )
            time.sleep(0.05)

    # -- heartbeats -------------------------------------------------------
    def _hb_path(self, host_id: str) -> str:
        return os.path.join(self.root, f"host-{host_id}.hb")

    def heartbeat(self) -> None:
        # the watchdog guard is what makes a wedged heartbeat *visible*:
        # every other host only sees this file's mtime going stale, but
        # the sick host itself must notice, self-fence, and step aside
        with watchdog.guard("lease_io", op="heartbeat"):
            faultinject.fault_point("lease_io", op="heartbeat")
            path = self._hb_path(self.host_id)
            # wall + monotonic pair (erp-heartbeat/2): the file's mtime
            # is stamped by the shared filesystem's clock while `wall`
            # is this host's, so wall - mtime estimates the per-host
            # clock offset a cross-host timeline assembler needs, and
            # `monotonic` lets it spot a wall clock that stepped mid-run
            with open(path, "w", encoding="utf-8") as f:
                f.write(
                    json.dumps(
                        {
                            "schema": HEARTBEAT_SCHEMA,
                            "wall": round(time.time(), 3),
                            "monotonic": round(time.monotonic(), 3),
                        }
                    )
                    + "\n"
                )

    def read_heartbeat(self, host_id: str) -> dict | None:
        return read_heartbeat(self._hb_path(host_id))

    def host_alive(self, host_id: str) -> bool:
        """Fresh heartbeat, or no heartbeat yet but still inside the
        startup grace window (measured from board creation)."""
        if host_id == self.host_id:
            return True
        try:
            age = time.time() - os.stat(self._hb_path(host_id)).st_mtime
            return age <= self.timeout_s
        except FileNotFoundError:
            pass
        try:
            board_age = time.time() - os.stat(self._board_path()).st_mtime
        except FileNotFoundError:
            return True  # board not up yet: nobody is declared dead
        return board_age <= self.grace_s

    def note_host_lost(self, host_id: str) -> None:
        """Announce a dead host exactly once per run (counter + event)."""
        if host_id in self._lost_announced:
            return
        self._lost_announced.add(host_id)
        metrics.counter("resilience.host_lost").inc()
        flightrec.record("host-lost", host=host_id)
        # flightrec rings only persist in abnormal-exit dumps; the trace
        # instant is what lands the detection in a clean survivor's
        # per-host stream, where the fleet timeline assembler anchors
        # the host-lost -> takeover -> adoption flow chain
        tracing.instant("host-lost", host=host_id)
        erplog.warn(
            "Host %s heartbeat is stale (> %.1fs); declaring it lost and "
            "adopting its unfinished shards.\n", host_id, self.timeout_s,
        )

    # -- leases -----------------------------------------------------------
    def _lease_path(self, shard: int) -> str:
        name = "merge" if shard == MERGE_SHARD else str(shard)
        return os.path.join(self.root, f"lease-{name}.json")

    def read_lease(self, shard: int) -> ShardLease | None:
        doc = _read_json(self._lease_path(shard))
        return None if doc is None else ShardLease.from_doc(doc)

    def try_claim(
        self,
        shard: int,
        start: int,
        stop: int,
        preferred_owner: str | None = None,
    ) -> ShardLease | None:
        """Try to take ownership of ``shard`` at the next epoch.

        Ownership is takeable when the shard is unclaimed (and we are the
        preferred owner, or the preferred owner is dead), explicitly
        released, already ours (restart re-attach), or held by a host
        whose heartbeat went stale — that last case is the rebalance rung
        and is announced via ``resilience.host_lost``/``rebalance``.
        Returns the new lease, or None when someone else owns it (losing
        the O_EXCL race returns None too — the winner's lease will appear).

        A self-fenced host (its own heartbeat writes breached the
        watchdog's lease_io deadline) refuses every claim: its heartbeat
        file is about to go stale, so any range it took would be adopted
        by a survivor and computed twice."""
        if watchdog.fenced():
            metrics.counter("resilience.fence_refused").inc()
            return None
        cur = self.read_lease(shard)
        if cur is None:
            if preferred_owner not in (None, self.host_id) and self.host_alive(
                preferred_owner
            ):
                return None
            epoch, n_done, state_path = 1, start, None
            adopted_from = (
                preferred_owner
                if preferred_owner not in (None, self.host_id)
                else None
            )
        else:
            if cur.complete:
                return None
            start, stop = cur.start, cur.stop  # board ranges are fixed
            if cur.owner == self.host_id or cur.released:
                adopted_from = None
            elif not self.host_alive(cur.owner):
                adopted_from = cur.owner
            else:
                return None
            epoch, n_done, state_path = (
                cur.epoch + 1, cur.n_done, cur.state_path,
            )
        claim = os.path.join(self.root, f"claim-{shard}.{epoch}")
        with watchdog.guard("lease_io", op="claim", shard=shard):
            faultinject.fault_point("lease_io", op="claim", shard=shard)
            try:
                fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.close(fd)
            except FileExistsError:
                return None
            lease = ShardLease(
                shard=shard, start=start, stop=stop, owner=self.host_id,
                epoch=epoch, n_done=n_done, state_path=state_path,
            )
            _write_json_atomic(self._lease_path(shard), lease.to_doc())
        if adopted_from is not None:
            self.note_host_lost(adopted_from)
            metrics.counter("resilience.rebalance").inc()
            flightrec.record(
                "rebalance", shard=shard, start=start, stop=stop,
                n_done=n_done, from_host=adopted_from, to_host=self.host_id,
            )
            tracing.instant(
                "adopt", shard=shard, epoch=epoch, n_done=n_done,
                from_host=adopted_from, to_host=self.host_id,
            )
            erplog.warn(
                "Adopted shard %d (templates [%d, %d), resuming at %d) "
                "from lost host %s (epoch %d).\n",
                shard, start, stop, n_done, adopted_from, epoch,
            )
        return lease

    def update(self, lease: ShardLease, **changes) -> ShardLease | None:
        """Commit owner-side progress (n_done/state_path/complete/released).

        Re-reads the lease first: if another host adopted the shard at a
        higher epoch (we were presumed dead), returns None and the caller
        must abandon the shard — the adopter's state is now authoritative."""
        if lease.owner != self.host_id:
            raise LeaseError(
                f"Host {self.host_id} cannot update a lease owned by "
                f"{lease.owner}."
            )
        cur = self.read_lease(lease.shard)
        if cur is not None and (
            cur.epoch != lease.epoch or cur.owner != lease.owner
        ):
            erplog.warn(
                "Lost lease on shard %d to %s (epoch %d > %d); abandoning.\n",
                lease.shard, cur.owner, cur.epoch, lease.epoch,
            )
            metrics.counter("resilience.lease_lost").inc()
            return None
        new = replace(lease, **changes)
        with watchdog.guard("lease_io", op="update", shard=new.shard):
            faultinject.fault_point("lease_io", op="update", shard=new.shard)
            _write_json_atomic(self._lease_path(new.shard), new.to_doc())
        return new

    def leases(self, n_shards: int) -> dict[int, ShardLease | None]:
        return {k: self.read_lease(k) for k in range(n_shards)}
