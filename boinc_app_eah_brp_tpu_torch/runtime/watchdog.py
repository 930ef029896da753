"""Hang doctor: per-stage deadline supervision + poison-range quarantine.

Crashes are easy: the process dies, the flight recorder dumps, the
supervisor (or the BOINC client, in the reference app) restarts from the
last checkpoint.  *Hangs* are the failure mode this project actually hits
— a wedged device stream, a stuck collective, blocked lease/heartbeat IO
on a shared filesystem.  A hang produces no exception, no signal,
no dump: just a process that will sit at 43% forever.  The reference
app's whole liveness contract is heartbeat-based for the same reason — it
polls quit/abort/no_heartbeat every template (demod_binary.c:1436-1441)
and converts unrecoverable states into ``boinc_temporary_exit`` for a
supervised retry (erp_boinc_wrapper.cpp:560-570).

This module supplies three pieces:

**Deadline registry.**  Every bounded operation in the pipeline — batch
dispatch (in the port: the enqueue of one batch's kernels), the drain
(every point where the host waits on the card: the checkpoint's and the
screensaver's copies and the final copy — the only guards that can see a
wedged kernel, since the port's loop never waits between batches),
checkpoint/result writes, the rescore feed —
wraps itself in :func:`guard`, registering an entry with a per-stage
deadline (``DEADLINES``, overridable via ``ERP_WATCHDOG_SPEC``, e.g.
``"dispatch=2,lease_io=1.5"`` or ``"*=5"``).  Long-running stages call
:func:`beat` to reset their clock each time they make internal progress.
When unarmed, ``guard`` is a single flag test — the hot loop pays
nothing.

**Supervisor thread + escalation ladder.**  A daemon thread polls the
registry.  An entry past its deadline escalates in order:

1. *forensics* — flightrec instant + the stalled thread's stack captured
   into the event ring, ``watchdog.breaches`` counter;
2. *incident* — the template window in flight is appended to the
   persistent ``erp-incident-log/1`` sidecar (see below);
3. *self-fence* — a ``lease_io`` breach sets the fence flag: the lease
   path stops claiming shards, so a host whose own heartbeat writes are
   wedged steps aside *before* survivors adopt its range (no split-brain
   double work);
4. *blackbox* — full ``flightrec.dump("watchdog:<stage>")``;
5. *cooperative abort* — :func:`abort_requested` flips true; loops that
   still poll (the driver's progress callback, the elastic claim loop)
   exit cleanly with a committed checkpoint;
6. *hard exit* — after ``ERP_WATCHDOG_GRACE_S`` the wedge is declared
   unrecoverable and the process dies with
   ``RADPUL_TEMPORARY_EXIT`` (99) via ``os._exit`` — the distinct
   "restart me" rc that ``--supervised`` (``runtime/supervise.py``)
   understands.  An entry that completes during the grace window is logged
   as ``watchdog-recovered`` instead.

**Poison-range quarantine.**  :class:`IncidentLog` persists one record
per wedge/crash with the template window in flight.  After ``K``
incidents on the same window (``ERP_QUARANTINE_K``, default 3) the driver
quarantines that range: skips it, records the named gap in result
provenance and the ``resilience.quarantined`` metric, and keeps going —
the analogue of BOINC's per-workunit error limit, so one pathological
batch ends in a completed run with a named gap instead of a crash loop.

The module is the JAX package's ``runtime/watchdog.py``: the same
``DEADLINES``, ``ERP_WATCHDOG*`` knobs and ``erp-incident-log/1`` format,
so each package honours the other's quarantine.  It never imports torch,
and is armed only by the driver (``ERP_WATCHDOG=off`` disables).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from contextlib import contextmanager

from . import flightrec, metrics, tracing
from . import logging as erplog
from .errors import RADPUL_TEMPORARY_EXIT

ENV_ENABLE = "ERP_WATCHDOG"
ENV_SPEC = "ERP_WATCHDOG_SPEC"
ENV_GRACE = "ERP_WATCHDOG_GRACE_S"
ENV_POLL = "ERP_WATCHDOG_POLL_S"
ENV_QUARANTINE_K = "ERP_QUARANTINE_K"
ENV_INCIDENT_LOG = "ERP_INCIDENT_LOG"

INCIDENT_SCHEMA = "erp-incident-log/1"

# Default per-stage deadlines (seconds).  Deliberately generous: these
# catch *wedges*, not slowness — a false hard-exit costs a restart cycle,
# a missed wedge costs the whole session.  The drain bound covers a full
# compile of the search step on a cold cache.
DEADLINES: dict[str, float] = {
    "dispatch": 300.0,
    "drain": 900.0,
    "ckpt_write": 120.0,
    "result_write": 120.0,
    "lease_io": 90.0,
    "merge": 300.0,
    "rescore_feed": 600.0,
    # resident serving tier (serving/server.py): the dispatch thread's
    # pop->stage hand-off and the grant/journal step after a Session
    # returns.  A wedge here strands the whole queue, so both escalate
    # to RADPUL_TEMPORARY_EXIT and the supervised server restarts into
    # a journal replay.
    "serving_dispatch": 300.0,
    "serving_result": 120.0,
}

STAGES = tuple(DEADLINES)


class _Entry:
    __slots__ = ("token", "stage", "ident", "name", "t0", "deadline", "ctx",
                 "breached_at")

    def __init__(self, token, stage, ident, name, deadline, ctx):
        self.token = token
        self.stage = stage
        self.ident = ident
        self.name = name
        self.t0 = time.monotonic()
        self.deadline = deadline
        self.ctx = ctx
        self.breached_at = None


_lock = threading.Lock()
_armed = False
_thread: threading.Thread | None = None
_stop = threading.Event()
_entries: dict[int, _Entry] = {}
_next_token = 0
_deadlines: dict[str, float] = dict(DEADLINES)
_grace_s = 10.0
_poll_s = 0.25
_fenced = False
_abort = False
_incident_log: "IncidentLog | None" = None
# test seam: replaced by unit tests so escalation can be exercised
# without killing the pytest process
_exit_fn = os._exit
# scoped observability routing: a fleet Session hands its ObsContext to
# use_obs() so breach counters / stall events / dumps land in that
# session's artifacts; None keeps the historical module-global layers
_obs = None


def use_obs(bundle) -> None:
    """Route the watchdog's metrics / flightrec / tracing emissions
    through a scoped observability bundle (``runtime/obs.ObsContext`` or
    anything with ``metrics``/``flightrec``/``tracing`` attributes
    exposing the module APIs).  Pass None to restore the defaults.  The
    supervisor stays process-global — a process wedges once — but what
    it *emits* follows the active session."""
    global _obs
    _obs = bundle


def _m():
    return _obs.metrics if _obs is not None else metrics


def _fr():
    return _obs.flightrec if _obs is not None else flightrec


def _tr():
    return _obs.tracing if _obs is not None else tracing


def _parse_spec(spec: str) -> dict[str, float]:
    """``"dispatch=2,lease_io=1.5"`` → per-stage overrides; ``*`` sets
    every stage.  Unknown stages raise — a typo silently supervising
    nothing defeats the harness."""
    out = dict(DEADLINES)
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(f"bad watchdog spec entry {entry!r} (want stage=seconds)")
        stage, _, val = entry.partition("=")
        stage = stage.strip()
        try:
            seconds = float(val)
        except ValueError:
            raise ValueError(f"bad watchdog deadline in {entry!r}")
        if seconds <= 0:
            raise ValueError(f"watchdog deadline must be > 0 in {entry!r}")
        if stage == "*":
            out = {k: seconds for k in out}
        elif stage in out:
            out[stage] = seconds
        else:
            raise ValueError(
                f"unknown watchdog stage {stage!r} (know: {', '.join(DEADLINES)})"
            )
    return out


def enabled() -> bool:
    return (os.environ.get(ENV_ENABLE, "") or "").strip().lower() not in (
        "off", "none", "0", "false",
    )


def armed() -> bool:
    return _armed


def fenced() -> bool:
    """True once a lease_io breach fenced this host: stop claiming
    shards (checked by ``resilience.LeaseBoard.try_claim``)."""
    return _fenced


def abort_requested() -> bool:
    """Cooperative-abort flag: loops that poll this should commit what
    they have and unwind; the driver maps it to RADPUL_TEMPORARY_EXIT."""
    return _abort


def arm(incident_log: "IncidentLog | None" = None) -> bool:
    """Start the supervisor thread.  Returns False (and stays inert) when
    ``ERP_WATCHDOG=off``.  Safe to call twice; re-arming resets fence and
    abort state (a fresh run in the same process starts healthy)."""
    global _armed, _thread, _deadlines, _grace_s, _poll_s
    global _fenced, _abort, _incident_log
    if not enabled():
        return False
    spec = os.environ.get(ENV_SPEC, "")
    deadlines = _parse_spec(spec) if spec.strip() else dict(DEADLINES)
    try:
        grace = float(os.environ.get(ENV_GRACE, ""))
    except ValueError:
        grace = max(2.0, min(30.0, 0.25 * min(deadlines.values())))
    try:
        poll = float(os.environ.get(ENV_POLL, ""))
    except ValueError:
        poll = max(0.05, min(1.0, 0.25 * min(deadlines.values())))
    with _lock:
        _deadlines = deadlines
        _grace_s = max(grace, 2 * poll)
        _poll_s = poll
        _fenced = False
        _abort = False
        _incident_log = incident_log
        _entries.clear()
        _armed = True
        if _thread is None or not _thread.is_alive():
            _stop.clear()
            _thread = threading.Thread(
                target=_supervise, name="erp-watchdog", daemon=True
            )
            _thread.start()
    erplog.debug(
        "Watchdog armed: %s (grace %.1fs).\n",
        ", ".join(f"{k}={v:g}s" for k, v in sorted(deadlines.items())),
        _grace_s,
    )
    return True


def disarm() -> None:
    global _armed, _thread
    with _lock:
        _armed = False
        _entries.clear()
    _stop.set()
    t = _thread
    if t is not None and t.is_alive() and t is not threading.current_thread():
        t.join(timeout=2.0)
    _thread = None


@contextmanager
def guard(stage: str, **ctx):
    """Register a deadline entry for the calling thread while the wrapped
    operation runs.  A single flag test when unarmed."""
    if not _armed:
        yield
        return
    global _next_token
    t = threading.current_thread()
    with _lock:
        token = _next_token = _next_token + 1
        deadline = _deadlines.get(stage, max(_deadlines.values()))
        _entries[token] = _Entry(token, stage, t.ident, t.name, deadline, ctx)
    try:
        yield
    finally:
        with _lock:
            entry = _entries.pop(token, None)
        if entry is not None and entry.breached_at is not None:
            late = time.monotonic() - entry.breached_at
            _m().counter("watchdog.recovered").inc()
            _fr().record(
                "watchdog-recovered", stage=stage, late_s=round(late, 3)
            )
            erplog.warn(
                "Watchdog: stage '%s' recovered %.1fs past its deadline.\n",
                stage, late,
            )


def beat(stage: str) -> None:
    """Reset the calling thread's open entry for ``stage`` — progress
    beats for long-running guards that loop internally."""
    if not _armed:
        return
    ident = threading.get_ident()
    now = time.monotonic()
    with _lock:
        for entry in _entries.values():
            if entry.stage == stage and entry.ident == ident:
                entry.t0 = now
                entry.breached_at = None


def beat_ages() -> dict[str, float]:
    """Seconds since the most recent beat per stage with an open guard
    entry — the ``/statusz`` liveness view of the serving dispatch
    thread.  Empty when unarmed or nothing is in flight."""
    if not _armed:
        return {}
    now = time.monotonic()
    out: dict[str, float] = {}
    with _lock:
        for entry in _entries.values():
            age = now - entry.t0
            if entry.stage not in out or age < out[entry.stage]:
                out[entry.stage] = age
    return {k: round(v, 3) for k, v in out.items()}


def _inflight_window(entry: _Entry) -> list[int] | None:
    """The template window to blame: the breached entry's own ctx when it
    carries one, else the latest dispatch-window snapshot (a lease or
    merge wedge still happened *while* some window was in flight)."""
    start, stop = entry.ctx.get("start"), entry.ctx.get("stop")
    if start is None or stop is None:
        d = _fr().dispatch_snapshot()
        start, stop = d.get("start"), d.get("stop")
    if start is None or stop is None:
        return None
    return [int(start), int(stop)]


def _stalled_stack(ident) -> list[str]:
    frame = sys._current_frames().get(ident)
    if frame is None:
        return []
    return [
        f"{fs.filename}:{fs.lineno} {fs.name}"
        for fs in traceback.extract_stack(frame)[-12:]
    ]


def _escalate(entry: _Entry, elapsed: float) -> None:
    global _fenced, _abort
    window = _inflight_window(entry)
    stack = _stalled_stack(entry.ident)
    _m().counter("watchdog.breaches").inc()
    _tr().instant(
        "watchdog-stall", stage=entry.stage,
        elapsed_s=round(elapsed, 3), deadline_s=entry.deadline,
    )
    _fr().record(
        "watchdog-stall",
        stage=entry.stage,
        elapsed_s=round(elapsed, 3),
        deadline_s=entry.deadline,
        thread=entry.name,
        window=window,
        stack=stack,
        **entry.ctx,
    )
    erplog.warn(
        "Watchdog: stage '%s' stalled %.1fs (deadline %.1fs) in thread %s"
        " — escalating.\n",
        entry.stage, elapsed, entry.deadline, entry.name,
    )
    if _incident_log is not None:
        try:
            _incident_log.append(
                stage=entry.stage,
                reason=f"watchdog:{entry.stage}",
                window=window,
            )
        except OSError as e:
            erplog.warn("Watchdog: incident log write failed: %s\n", e)
    if entry.stage == "lease_io" and not _fenced:
        _fenced = True
        _m().counter("watchdog.self_fenced").inc()
        _fr().record("watchdog-self-fence", stage=entry.stage)
        erplog.warn(
            "Watchdog: heartbeat IO wedged — self-fencing (no new shard"
            " claims) so survivors can adopt cleanly.\n"
        )
    _fr().dump(f"watchdog:{entry.stage}")
    _abort = True


def _hard_exit(entry: _Entry, elapsed: float) -> None:
    erplog.error(
        "Watchdog: stage '%s' still wedged %.1fs after breach — hard exit"
        " rc=%d (temporary_exit; supervisor should restart from the last"
        " checkpoint).\n",
        entry.stage, elapsed, RADPUL_TEMPORARY_EXIT,
    )
    _m().counter("watchdog.hard_exits").inc()
    _fr().record(
        "watchdog-hard-exit", stage=entry.stage, elapsed_s=round(elapsed, 3)
    )
    try:
        _m().emergency_flush("watchdog-hard-exit")
    except Exception:
        pass
    try:
        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:
        pass
    _exit_fn(RADPUL_TEMPORARY_EXIT)


def _supervise() -> None:
    while not _stop.wait(_poll_s):
        if not _armed:
            continue
        now = time.monotonic()
        breached = None
        expired = None
        with _lock:
            for entry in _entries.values():
                elapsed = now - entry.t0
                if entry.breached_at is None:
                    if elapsed > entry.deadline:
                        entry.breached_at = now
                        breached = (entry, elapsed)
                        break
                elif now - entry.breached_at > _grace_s:
                    expired = (entry, elapsed)
                    break
        # escalation runs outside the lock: it takes flightrec/metrics
        # locks and a blackbox dump, and guards must stay cheap meanwhile
        if breached is not None:
            _escalate(*breached)
        if expired is not None:
            _hard_exit(*expired)


# ---------------------------------------------------------------------------
# incident log + quarantine


class IncidentLog:
    """Persistent ``erp-incident-log/1`` sidecar: one record per
    wedge/crash with the template window in flight.  Lives next to the
    checkpoint so it survives restarts — it is the memory that turns the
    Kth wedge on one window into a quarantine instead of a crash loop."""

    SCHEMA = INCIDENT_SCHEMA

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def read(self) -> dict:
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                doc = json.load(fh)
        except FileNotFoundError:
            return {"schema": self.SCHEMA, "incidents": []}
        except (OSError, ValueError) as e:
            # a torn write must not wedge recovery of the thing that
            # records wedges; start a fresh log but say so
            erplog.warn("Incident log %s unreadable (%s); resetting.\n",
                        self.path, e)
            return {"schema": self.SCHEMA, "incidents": []}
        if doc.get("schema") != self.SCHEMA or not isinstance(
            doc.get("incidents"), list
        ):
            erplog.warn("Incident log %s has wrong schema; resetting.\n",
                        self.path)
            return {"schema": self.SCHEMA, "incidents": []}
        return doc

    def append(self, stage: str, reason: str, window=None) -> dict:
        rec = {
            "t": time.time(),
            "pid": os.getpid(),
            "stage": stage,
            "reason": reason,
            "window": [int(window[0]), int(window[1])] if window else None,
        }
        with self._lock:
            doc = self.read()
            doc["incidents"].append(rec)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, indent=1)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        _m().counter("watchdog.incidents").inc()
        return rec

    def window_counts(self) -> dict[tuple[int, int], int]:
        counts: dict[tuple[int, int], int] = {}
        for rec in self.read().get("incidents", []):
            w = rec.get("window")
            if not w or len(w) != 2:
                continue
            key = (int(w[0]), int(w[1]))
            counts[key] = counts.get(key, 0) + 1
        return counts

    def quarantined(self, k: int | None = None) -> list[tuple[int, int]]:
        """Windows with >= k incidents, merged where adjacent/overlapping,
        sorted.  k defaults to ``ERP_QUARANTINE_K`` (3)."""
        if k is None:
            k = quarantine_threshold()
        bad = sorted(w for w, n in self.window_counts().items() if n >= k)
        merged: list[list[int]] = []
        for a, b in bad:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]


def quarantine_threshold() -> int:
    try:
        return max(1, int(os.environ.get(ENV_QUARANTINE_K, "3")))
    except ValueError:
        return 3


def default_incident_path(checkpointfile: str | None) -> str | None:
    """Where the sidecar lives: ``ERP_INCIDENT_LOG`` wins, else next to
    the checkpoint (the one path guaranteed durable across restarts)."""
    env = os.environ.get(ENV_INCIDENT_LOG, "").strip()
    if env:
        return env
    if checkpointfile:
        return checkpointfile + ".incidents.json"
    return None


def runnable_segments(
    n: int, quarantined: list[tuple[int, int]], start: int = 0
) -> list[tuple[int, int]]:
    """Complement of the quarantined ranges within ``[start, n)`` — the
    segments the driver actually dispatches, in order."""
    segments: list[tuple[int, int]] = []
    cur = start
    for a, b in sorted(quarantined):
        a, b = max(a, start), min(b, n)
        if b <= cur:
            continue
        if a > cur:
            segments.append((cur, min(a, n)))
        cur = max(cur, b)
        if cur >= n:
            break
    if cur < n:
        segments.append((cur, n))
    return segments


def on_crash_dump(reason: str) -> None:
    """Called by ``flightrec.dump`` so *every* wedge/crash lands in the
    incident log, not only watchdog breaches.  Watchdog-originated dumps
    already appended their incident; so did the cooperative-abort path
    (the driver's ``exit-code-99`` dump is the SAME wedge the escalation
    already recorded) — skip both to keep quarantine counts honest."""
    log = _incident_log
    if (
        log is None
        or reason.startswith("watchdog:")
        or reason == f"exit-code-{RADPUL_TEMPORARY_EXIT}"
    ):
        return
    d = _fr().dispatch_snapshot()
    start, stop = d.get("start"), d.get("stop")
    window = [int(start), int(stop)] if start is not None and stop is not None else None
    try:
        log.append(stage="crash", reason=reason, window=window)
    except OSError:
        pass


def validate_incident_log(doc) -> list[str]:
    """Schema check for ``erp-incident-log/1`` (tools/metrics_report.py
    --check).  Returns a list of problems, empty when valid."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return ["incident log is not a JSON object"]
    if doc.get("schema") != INCIDENT_SCHEMA:
        problems.append(
            f"schema is {doc.get('schema')!r}, want {INCIDENT_SCHEMA!r}"
        )
    incidents = doc.get("incidents")
    if not isinstance(incidents, list):
        return problems + ["'incidents' is not a list"]
    for i, rec in enumerate(incidents):
        if not isinstance(rec, dict):
            problems.append(f"incidents[{i}] is not an object")
            continue
        for key in ("t", "pid", "stage", "reason"):
            if key not in rec:
                problems.append(f"incidents[{i}] missing {key!r}")
        w = rec.get("window")
        if w is not None and (
            not isinstance(w, list)
            or len(w) != 2
            or not all(isinstance(x, int) for x in w)
            or w[0] >= w[1]
        ):
            problems.append(
                f"incidents[{i}].window must be null or [start, stop) ints"
            )
    return problems
