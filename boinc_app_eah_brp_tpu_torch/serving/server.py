"""FleetServer: queue-in / result-out serving of workunits with no kernel
build and no new cuFFT plan after warm-up.

One resident process replaces one-process-per-WU: submit a workunit
(the same argument surface as ``runtime/driver.DriverArgs``), get a
ticket, collect a ``runtime/scheduler.SessionResult``.  The server owns
a single :class:`~..runtime.scheduler.Scheduler` (the card, the built
kernels, the cuFFT plans, the step cache) and drives it from a dispatch
thread that

* **packs** the queue: requests whose cheap geometry proxy (bank path,
  search knobs, batch, device) matches the step currently resident run
  back to back (``runtime/scheduler.py::plan_packing`` semantics), so the
  step cache stays hot;
* **overlaps** prep: while WU k runs, WU k+1's ``Session.prepare``
  (parse, upload, whitening, geometry) runs on the scheduler's prep
  thread;
* **contains** failures: a poisoned WU maps to a failed SessionResult
  through the driver's exact error table and quarantine provenance; the
  server keeps serving.

The durable tier (``serving/journal.py``) makes the server the same
kind of component as everything else in a BOINC deployment — one that
can die and be re-issued.  With ``resume_dir=`` every accepted WU is
write-ahead journaled before ``submit`` returns, the journal is
replayed at startup (accepted-but-ungranted WUs re-enqueue in submit
order, half-done WUs resume mid-bank from their Session checkpoints),
and ``close()`` takes an explicit drain-or-abort decision that is
itself journaled.  The server defends itself under load: a bounded
queue (``$ERP_SERVING_QUEUE_MAX``) sheds new submits with an explicit
:class:`ServerOverloaded` retry-after rejection, repeated
out-of-memory failures walk a per-geometry
``runtime/resilience.py`` DegradationLadder rung that halves the warm
batch shape, and the dispatch thread runs under the
``serving_dispatch`` / ``serving_result`` deadlines of
``runtime/watchdog.py`` (a wedge escalates to rc 99 and the supervised
entry restarts into a journal replay).

The port's counterpart of the JAX package's ``serving/server.py``, with
the same API, journal format, knobs and ``erp-fleet-serving/1``
scoreboard.  ``device`` (default ``"cuda"``) is the Scheduler's card;
requests carry their own ``DriverArgs.device``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass, field

from ..runtime import faultinject
from ..runtime import metrics
from ..runtime import resilience
from ..runtime import watchdog
from ..runtime import logging as erplog
from ..runtime.percentiles import percentile
from ..runtime.scheduler import Scheduler, SessionResult
from .introspect import introspector_from_env
from .journal import WUJournal, compact, journal_path, replay
from .slo import monitor_from_env

QUEUE_MAX_ENV = "ERP_SERVING_QUEUE_MAX"
CLOSE_MODE_ENV = "ERP_SERVING_CLOSE"


class ServerOverloaded(RuntimeError):
    """Admission-control rejection: the bounded queue is full.  Carries
    the explicit retry-after contract (``retry_after_s``) — the client
    backs off instead of the server growing without bound."""

    def __init__(self, msg: str, *, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


def _geometry_proxy(args) -> tuple:
    """Cheap stand-in for ``step_cache_key`` computable without parsing
    the workunit: everything in the request that decides the resident
    step except the sample count (same-bank, same-knob requests share
    geometry in every deployment).  Used to ORDER the queue and to key the
    per-class degradation ladders; correctness never depends on it."""
    return (
        args.templatebank, args.f0, args.padding, args.fA, args.window,
        args.white, args.use_lut, args.batch_size, args.device,
    )


@dataclass
class FleetRequest:
    """One queued workunit: driver argument surface + fabric identity."""

    ticket: str
    args: object  # runtime/driver.DriverArgs (duck-typed)
    corr_id: str | None = None
    submitted: float = field(default_factory=time.monotonic)


class FleetServer:
    """Resident Session/Scheduler server with a queue-in/result-out API.

    ``warm_specs`` (``runtime/scheduler.WarmSpec``) builds the kernels and
    plans cuFFT for the expected classes before the first WU; each WU's
    prep overlaps the execution of the one before it.  ``resume_dir``
    arms the WU journal: accepted work survives a crash and is replayed
    on the next start.  ``queue_max`` (default ``$ERP_SERVING_QUEUE_MAX``,
    unset = unbounded) bounds the queue; at capacity ``submit`` raises
    :class:`ServerOverloaded` with a retry-after estimate."""

    def __init__(
        self,
        *,
        scheduler: Scheduler | None = None,
        warm_specs=None,
        slo=None,
        name: str = "fleet",
        resume_dir: str | None = None,
        queue_max: int | None = None,
        device: str = "cuda",
    ):
        self.name = name
        self.scheduler = scheduler or Scheduler(device=device)
        self.resume_dir = resume_dir
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: list[FleetRequest] = []
        self._results: dict[str, SessionResult] = {}
        self._completed_order: list[str] = []
        self._seq = 0
        self._stop = False
        self._closed = False
        self._drain_on_close = True
        self._loop_done = False
        self._last_key: tuple | None = None
        self._first_exec_start: float | None = None
        self._last_exec_end: float | None = None
        self._shed_total = 0
        self._inflight = 0
        # per-geometry degradation ladders (armed after repeated
        # out-of-memory failures, see _note_outcome)
        self._ladders: dict[tuple, resilience.DegradationLadder] = {}
        self._oom_streak: dict[tuple, int] = {}
        if queue_max is None:
            raw = os.environ.get(QUEUE_MAX_ENV, "").strip()
            if raw:
                try:
                    queue_max = int(raw)
                except ValueError:
                    erplog.warn(
                        "%s=%r is not an int; queue stays unbounded.\n",
                        QUEUE_MAX_ENV, raw,
                    )
        self._queue_max = queue_max if (queue_max or 0) > 0 else None
        # live SLO heartbeat (serving/slo.py): explicit monitor, or armed
        # from $ERP_SLO_FILE; attached BEFORE warmup so the monitor's
        # warmup boundary tracks the scheduler's
        self.slo = slo if slo is not None else monitor_from_env(
            n_chips=self.scheduler.n_devices, name=name
        )
        if self.slo is not None:
            self.scheduler.arm_slo(self.slo)
        self.warm_report: dict = {}
        if warm_specs:
            self.warm_report = self.scheduler.warm(warm_specs)
        # durable tier: WAL + replay of accepted-but-ungranted work
        self.journal: WUJournal | None = None
        self.replayed_wus = 0
        self._incident_log = None
        if resume_dir:
            self._resume(resume_dir)
        # read-only live introspection (serving/introspect.py): armed
        # from $ERP_STATUSZ_PORT, shared no-op otherwise
        self.introspect = introspector_from_env(server=self, name=name)
        self._thread = threading.Thread(
            target=self._loop, name=f"erp-{name}-dispatch", daemon=True
        )
        self._thread.start()

    def _resume(self, resume_dir: str) -> None:
        """Arm the journal and replay it: every accepted-but-ungranted
        WU re-enqueues in original submit order (FIFO; the packing rule
        applies at pop time exactly as for live submits), ticket
        numbering continues past the replayed maximum, and terminal
        records are compacted away."""
        os.makedirs(resume_dir, exist_ok=True)
        self._incident_log = watchdog.IncidentLog(
            os.path.join(resume_dir, "server.incidents.json")
        )
        jpath = journal_path(resume_dir)
        state = replay(jpath)
        if state.done or state.failed:
            compact(jpath)  # compaction rule: resume-time sweep
        self.journal = WUJournal(jpath)
        if not state.pending:
            return
        from ..runtime.driver import DriverArgs

        known = {f.name for f in dataclasses.fields(DriverArgs)}
        for rec in state.pending:
            kw = {
                k: v for k, v in (rec.get("args") or {}).items()
                if k in known
            }
            try:
                args = DriverArgs(**kw)
            except TypeError as e:
                erplog.warn(
                    "Journal replay: cannot rebuild %s (%s); skipping.\n",
                    rec.get("ticket"), e,
                )
                continue
            self._pending.append(
                FleetRequest(
                    ticket=rec["ticket"], args=args,
                    corr_id=rec.get("corr_id"),
                )
            )
        self.replayed_wus = len(self._pending)
        self._seq = max(self._seq, state.max_wu_seq)
        metrics.counter("fleet.replayed").inc(self.replayed_wus)
        metrics.gauge("fleet.queue_depth").set(len(self._pending))
        erplog.info(
            "Journal replay: re-enqueued %d accepted-but-ungranted "
            "WU(s) from %s.\n", self.replayed_wus, jpath,
        )

    # -- public API -------------------------------------------------------

    def submit(self, args, *, corr_id: str | None = None) -> str:
        """Queue one workunit; returns the ticket to collect with
        :meth:`result`.  With a journal armed the accept record is
        fsync'd to the WAL before the WU becomes visible to dispatch.
        Raises :class:`ServerOverloaded` when the bounded queue is
        full."""
        faultinject.fault_point("serving_submit", corr_id=corr_id)
        with self._cv:
            if self._stop:
                raise RuntimeError("FleetServer is closed")
            if (
                self._queue_max is not None
                and len(self._pending) >= self._queue_max
            ):
                self._shed_total += 1
                metrics.counter("fleet.shed").inc()
                retry_after = self._retry_after_locked()
                raise ServerOverloaded(
                    f"queue full ({len(self._pending)}/{self._queue_max}); "
                    f"retry in ~{retry_after:.0f}s",
                    retry_after_s=retry_after,
                )
            self._seq += 1
            ticket = f"{self.name}-wu-{self._seq}"
            if self.journal is not None:
                # write-ahead: a journal failure here rejects the
                # submit — the server never holds work it cannot prove
                # it accepted
                self.journal.record_submit(ticket, args, corr_id=corr_id)
            self._pending.append(
                FleetRequest(ticket=ticket, args=args, corr_id=corr_id)
            )
            metrics.gauge("fleet.queue_depth").set(len(self._pending))
            if self.slo is not None:
                self.slo.observe_queue_depth(len(self._pending))
            self._cv.notify_all()
        return ticket

    def result(self, ticket: str, timeout: float | None = None) -> SessionResult:
        """Block until ``ticket``'s Session finished; returns its
        SessionResult.  Raises TimeoutError after ``timeout`` seconds,
        and RuntimeError once the server closed without granting the
        ticket (abort-close leaves it journaled for the next resume)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while ticket not in self._results:
                if self._loop_done:
                    raise RuntimeError(
                        f"FleetServer closed before {ticket} was granted "
                        "(still journaled for resume)"
                    )
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"no result for {ticket} yet")
                self._cv.wait(timeout=remaining)
            return self._results[ticket]

    def process(self, args, *, corr_id: str | None = None) -> SessionResult:
        """submit + result in one blocking call — the drop-in for a
        driver subprocess."""
        return self.result(self.submit(args, corr_id=corr_id))

    def retry_after_estimate(self) -> float:
        """The retry-after a shed submit would be told right now —
        ``/healthz`` surfaces it as a ``Retry-After`` header while
        shedding."""
        with self._lock:
            return self._retry_after_locked()

    @property
    def shedding(self) -> bool:
        """True while the bounded queue is at capacity — new submits are
        being rejected and ``/healthz`` answers 503."""
        return (
            self._queue_max is not None
            and len(self._pending) >= self._queue_max
        )

    def durability(self) -> dict:
        """The ``/statusz`` durability block: journal location/size/
        depth, replay and shed counters, admission-control state."""
        with self._lock:
            depth = len(self._pending)
            inflight = self._inflight
            shed = self._shed_total
        doc: dict = {
            "queue_depth": depth,
            "queue_max": self._queue_max,
            "shedding": self.shedding,
            "shed_total": shed,
            "replayed_wus": self.replayed_wus,
            "journal": None,
        }
        if self.journal is not None:
            doc["journal"] = {
                "path": self.journal.path,
                "bytes": self.journal.size_bytes(),
                # accepted-but-ungranted: the backlog a crash would
                # hand to the next resume
                "depth": depth + inflight,
            }
        return doc

    def stats(self) -> dict:
        """The serving-tier scoreboard (``erp-fleet-serving/1``):
        WUs/hour/chip over the busy window, recompiles (kernel builds and
        new cuFFT plans) after warm-up (WU 1 is the warm-up when
        :meth:`~..runtime.scheduler.Scheduler.warm` wasn't called), p95
        inter-WU gap, step/AOT cache traffic, plus the durability counters
        (``resumed_wus``, ``shed_total``)."""
        with self._lock:
            results = [self._results[t] for t in self._completed_order]
            first = self._first_exec_start
            last = self._last_exec_end
            shed = self._shed_total
        served = len(results)
        ok = sum(1 for r in results if r.ok)
        wall = (last - first) if (first is not None and last is not None) else 0.0
        n_chips = max(1, self.scheduler.n_devices())
        # warm-up boundary: everything after the first completed session
        # must run on resident steps (after an explicit warm(), session 1
        # already must)
        warm_cut = 0 if self.scheduler.warmed else 1
        after = results[warm_cut:]
        # exact p95 (runtime/percentiles.py)
        gaps = sorted(self.scheduler.inter_wu_gaps_s)
        p95_gap = percentile(gaps, 95)
        return {
            "schema": "erp-fleet-serving/1",
            "served": served,
            "ok": ok,
            "failed": served - ok,
            "busy_wall_s": round(wall, 3),
            "n_chips": n_chips,
            "wus_per_hour_per_chip": round(
                (ok / (wall / 3600.0) / n_chips) if wall > 0 else 0.0, 3
            ),
            "recompiles_after_warmup": sum(r.recompiles for r in after),
            "recompiles_total": sum(r.recompiles for r in results),
            "p95_inter_wu_gap_s": round(p95_gap, 4),
            "prep_overlap_s": round(sum(r.prepare_s for r in results), 3),
            "step_cache": {
                "entries": len(self.scheduler.step_cache),
                "hits": self.scheduler.step_cache.hits,
                "misses": self.scheduler.step_cache.misses,
            },
            "warm": dict(self.warm_report),
            "resumed_wus": self.replayed_wus,
            "shed_total": shed,
            "queue_max": self._queue_max,
            "journal_bytes": (
                self.journal.size_bytes() if self.journal is not None else 0
            ),
        }

    def close(self, timeout: float = 60.0, drain: bool | None = None) -> None:
        """Stop the server with an EXPLICIT drain-or-abort decision
        (default ``drain``; ``$ERP_SERVING_CLOSE=abort`` or
        ``drain=False`` flips it), journaled before the dispatch thread
        is joined — never a thread-timing coin flip:

        * **drain**: every already-accepted WU is granted before the
          dispatch thread exits; the journal compacts to empty;
        * **abort**: the queue is cleared NOW (under the lock, so
          dispatch cannot pop another), at most the in-flight Session
          finishes, and abandoned WUs stay journaled as accepted — the
          next ``resume_dir`` start replays them."""
        if drain is None:
            drain = (
                os.environ.get(CLOSE_MODE_ENV, "drain").strip().lower()
                != "abort"
            )
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._stop = True
            self._drain_on_close = bool(drain)
            abandoned: list[str] = []
            if not drain:
                abandoned = [r.ticket for r in self._pending]
                self._pending.clear()
                metrics.gauge("fleet.queue_depth").set(0)
            pending_now = len(abandoned) if not drain else len(self._pending)
            self._cv.notify_all()
        if self.journal is not None:
            try:
                self.journal.record_close(
                    "drain" if drain else "abort",
                    pending=pending_now, abandoned=abandoned,
                )
            except Exception as e:
                erplog.warn("Journal close record failed: %s\n", e)
        self._thread.join(timeout=timeout)
        if self.journal is not None:
            if drain:
                try:
                    self.journal.compact()
                except Exception as e:
                    erplog.warn("Journal compaction failed: %s\n", e)
            self.journal.close()
        self.scheduler.close()
        if self.slo is not None:
            self.slo.close()  # final heartbeat covers every session
        self.introspect.close()

    def __enter__(self) -> "FleetServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatch loop ----------------------------------------------------

    def _retry_after_locked(self) -> float:
        """Retry-after estimate for a shed submit: recent mean session
        wall x backlog / chips (callers hold the lock)."""
        walls = [
            self._results[t].wall_s for t in self._completed_order[-8:]
        ]
        walls = [w for w in walls if w and w > 0]
        mean = (sum(walls) / len(walls)) if walls else 5.0
        n = max(1, self.scheduler.n_devices())
        return max(1.0, round(mean * (len(self._pending) + 1) / n, 1))

    def _pop(self, block: bool) -> FleetRequest | None:
        """Next request per the packing rule: stay on the resident
        step's group while it has backlog, else FIFO."""
        with self._cv:
            while True:
                if self._pending:
                    idx = 0
                    if self._last_key is not None:
                        for i, req in enumerate(self._pending):
                            if _geometry_proxy(req.args) == self._last_key:
                                idx = i
                                break
                    req = self._pending.pop(idx)
                    metrics.gauge("fleet.queue_depth").set(len(self._pending))
                    if self.slo is not None:
                        self.slo.observe_queue_depth(len(self._pending))
                    return req
                if self._stop or not block:
                    return None
                self._cv.wait()

    def _stage(self, req: FleetRequest):
        """Build the Session and launch its host prep on the prep pool.
        An armed degradation ladder for this geometry class overrides
        the batch (``req.args`` keeps the original for packing)."""
        args = req.args
        ladder = self._ladders.get(_geometry_proxy(args))
        if ladder is not None and dataclasses.is_dataclass(args):
            bs = getattr(args, "batch_size", None)
            if bs and ladder.batch_size < bs:
                args = dataclasses.replace(args, batch_size=ladder.batch_size)
                metrics.gauge("fleet.degraded_batch").set(ladder.batch_size)
                erplog.warn(
                    "Serving %s at degraded batch %d (was %d) after "
                    "repeated out-of-memory failures.\n",
                    req.ticket, ladder.batch_size, bs,
                )
        session = self.scheduler.build_session(
            args, corr_id=req.corr_id, name=req.ticket
        )
        return req, session, self.scheduler.prepare_async(session)

    def _note_outcome(self, req: FleetRequest, res: SessionResult) -> None:
        """Overload-ladder bookkeeping: two consecutive OOM-classified
        failures of one geometry class arm a
        ``runtime/resilience.DegradationLadder`` whose every further OOM
        halves the class's batch shape (floor 1)."""
        key = _geometry_proxy(req.args)
        if res.ok:
            self._oom_streak.pop(key, None)
            return
        exc = RuntimeError(res.error or f"session exit {res.code}")
        if not resilience.is_oom(exc):
            self._oom_streak.pop(key, None)
            return
        streak = self._oom_streak.get(key, 0) + 1
        self._oom_streak[key] = streak
        if streak < 2:
            return
        ladder = self._ladders.get(key)
        if ladder is None:
            bs = getattr(req.args, "batch_size", None)
            if not bs or bs <= 1:
                return
            ladder = resilience.DegradationLadder(
                resilience.RetryPolicy(), batch_size=bs
            )
            self._ladders[key] = ladder
        ladder.record_failure("serving_dispatch", exc)
        metrics.gauge("fleet.degraded_batch").set(ladder.batch_size)

    def _record_grant(self, req: FleetRequest, res: SessionResult,
                      t0: float) -> None:
        self._note_outcome(req, res)
        if self.journal is not None:
            # a failing WAL degrades durability, never availability
            try:
                if res.ok:
                    self.journal.record_done(req.ticket, res.outputfile)
                else:
                    self.journal.record_failed(
                        req.ticket, res.code if res.code is not None else -1,
                        res.error,
                    )
            except Exception as e:
                erplog.warn(
                    "Journal grant record for %s failed (%s); serving "
                    "on.\n", req.ticket, e,
                )
        with self._cv:
            if self._first_exec_start is None:
                self._first_exec_start = t0
            self._last_exec_end = time.monotonic()
            self._results[req.ticket] = res
            self._completed_order.append(req.ticket)
            self._inflight = 0
            self._cv.notify_all()

    def _loop(self) -> None:
        staged = None
        try:
            while True:
                if staged is None:
                    req = self._pop(block=True)
                    if req is None:
                        break
                    staged = self._stage(req)
                # abort-close decision point: BEFORE a new session
                # starts, never via join timing.  The staged WU stays
                # journaled as accepted — the next resume replays it.
                with self._cv:
                    if self._stop and not self._drain_on_close:
                        erplog.warn(
                            "Abort-close: abandoning staged %s "
                            "(journaled for resume).\n", staged[0].ticket,
                        )
                        break
                    self._inflight = 1
                req, session, fut = staged
                watchdog.arm(incident_log=self._incident_log)
                with watchdog.guard("serving_dispatch", ticket=req.ticket):
                    faultinject.fault_point(
                        "serving_dispatch", ticket=req.ticket
                    )
                    watchdog.beat("serving_dispatch")
                    self._last_key = _geometry_proxy(req.args)
                    if self.journal is not None:
                        try:
                            self.journal.record_dispatch(req.ticket)
                        except Exception as e:
                            erplog.warn(
                                "Journal dispatch record for %s failed "
                                "(%s); serving on.\n", req.ticket, e,
                            )
                    # stage WU k+1 NOW: its parse/upload/whitening
                    # overlaps WU k's run on the prep thread
                    nxt = self._pop(block=False)
                    staged = self._stage(nxt) if nxt is not None else None
                t0 = time.monotonic()
                try:
                    res = self.scheduler.execute(session, prep_future=fut)
                except Exception as e:  # unmapped: fail the WU, keep serving
                    erplog.error(
                        "Session %s died unmapped: %s\n", req.ticket, e
                    )
                    res = SessionResult(
                        name=req.ticket, code=-1, corr_id=req.corr_id,
                        outputfile=getattr(req.args, "outputfile", None),
                        error=f"{type(e).__name__}: {e}",
                    )
                # scheduler.execute disarmed the per-session watchdog;
                # re-arm for the grant step (fsync'd WAL write + result
                # bookkeeping can wedge on bad storage)
                watchdog.arm(incident_log=self._incident_log)
                with watchdog.guard("serving_result", ticket=req.ticket):
                    self._record_grant(req, res, t0)
                watchdog.disarm()
        finally:
            watchdog.disarm()
            with self._cv:
                self._loop_done = True
                self._inflight = 0
                self._cv.notify_all()
