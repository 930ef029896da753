"""Host-side span tracing with Perfetto-loadable Chrome trace export.

The port's copy of the JAX package's ``runtime/tracing.py``: the same span
names, JSONL stream (``erp-trace/1``), Chrome export and validators, so the
repo's trace tools read both packages' timelines alike.  The profiler
(``profiling.trace``) sees the card; this module answers "where did the
wall clock go" on ANY host with zero device dependency: a thread-aware
span API over one shared timestamp base, recording into a bounded ring,
streaming to JSONL when ``ERP_TRACE_FILE`` is set, and exporting a Chrome
trace-event JSON (``<trace_file>.chrome.json``) that loads directly in
Perfetto / ``chrome://tracing``.

Span sites cover the critical path of the dispatch loop: the dispatch of
each batch (``models/search.py``), the points where the host waits on the
card (``drain``: the checkpoint's and the screensaver's copies, the final
copy), the rescorer's feed thread, checkpoint + retry-backoff paths, and
the driver's coarse phases (``setup``, ``finalize``, ``result-write``) —
so ``tools/trace_report.py`` can attribute the run wall to named stalls.
The process's start is spanned too (``import``, ``cuda-init``,
``kernel-load``, ``cufft-plan``, ``input-read``), the served queue
(``exec-wait``) and each oracle pass of the rescoring
(``rescore.resample`` where the host resamples, ``rescore.fft`` the
spectrum at the bins read, on the host or the card, ``rescore.harmonics``;
``rescore.device-resample`` a chunk of templates the card resamples).
Device-side per-stage spans (measured by ``steptime.capture_profile``,
moved onto this module's clock) merge onto ``device:*`` lanes of the
Chrome export via ``add_device_records``; they never enter the JSONL
stream, whose records must stay strictly ordered by ``end_us``.

**The profiler sees every span.**  Whenever a ``torch.profiler`` records,
``span(name)`` also opens ``record_function("erp:" + name)``, whether or
not this tracer is armed, so a profiler trace names the same stages
(``runtime/profiling.py::phase`` spans its phases, so they appear as
``erp:whitening``, ``erp:template loop``, ``erp:oracle rescore``).  The
test is torch's own global flag, read from ``sys.modules`` (this module
never imports torch).

**Every span knows its workunit.**  A session marks its threads with
:func:`for_workunit` (``runtime/session.py``: the correlation id, the
server's ticket, or the workunit file's name); spans and instants opened
there carry ``wu``, and the workers that serve the session (the server's
prep thread, the rescorer's feed thread and pool) adopt the id the way
they adopt the trace context.

Design rules (same contract as ``metrics`` / ``flightrec`` /
``faultinject``):

* **Near-zero cost when disabled.**  ``span()`` is a flag test and one
  ``sys.modules`` lookup (is a profiler recording?) returning one shared
  no-op context manager; no file is created, no thread-local state
  touched, and ``import tracing`` never imports torch.
* **Thread-safe.**  Spans open/close concurrently on the dispatch loop,
  prefetch worker, rescore feed and heartbeat threads; the ring and the
  stream share one lock, and the completion timestamp is taken INSIDE
  that lock so streamed records are strictly ordered by their ``end_us``
  (the monotonicity ``validate_stream`` verifies).
* **One timestamp base.**  ``epoch_unix`` (wall clock at ``configure``)
  plus a perf-counter offset in microseconds; metrics heartbeats and
  flightrec events carry wall-clock ``t`` fields, so ``t ~= epoch_unix +
  ts_us/1e6`` correlates all three layers.  Completed spans are bridged
  into a ``span.<name>_ms`` metrics histogram, and spans slower than
  ``_FLIGHTREC_MIN_MS`` land in the flightrec ring; a crash dump embeds
  the open-span stack (``open_spans``) at the moment of death.
* **Scoped contexts.**  All state lives on :class:`TraceContext`; the
  module-level functions delegate to one default env-driven instance,
  while scoped instances (``runtime/obs.py``) own isolated rings,
  streams and thread-local span stacks, and bridge into their own
  metrics/flightrec contexts.

Trace contexts: ``new_context()`` allocates a window id on the current
thread; workers that service that window call ``set_context`` (or pass
``ctx=``) so their spans carry the same id — the report can then line up
a drain stall with the prefetch/rescore work of the SAME batch even
though they ran on different threads.

Env surface: ``ERP_TRACE_FILE`` (JSONL stream path; enables the layer),
``ERP_TRACE_EVENTS`` (ring capacity, default 16384), ``ERP_TRACE_LANE``
(stable lane identity for merged fleet timelines; falls back to
``host<$ERP_PROCESS_ID>`` then the correlation id).  Env fallbacks
apply only to the default context.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import sys
import threading
import time
import weakref
from collections import deque

from . import logging as erplog

TRACE_FILE_ENV = "ERP_TRACE_FILE"
TRACE_EVENTS_ENV = "ERP_TRACE_EVENTS"
CORR_ID_ENV = "ERP_CORR_ID"
# stable lane identity for merged fleet timelines: OS pids recycle under
# supervised restarts and subprocess soaks, so a cross-host assembler
# (tools/fleet_timeline.py) needs an identity that survives re-exec.
# Explicit ERP_TRACE_LANE wins; a multi-host run inherits host<N> from
# ERP_PROCESS_ID (parallel/distributed.py naming); a fabric subprocess
# falls back to its correlation id.  Unset => header and Chrome export
# are byte-identical to the historical single-process form.
LANE_ID_ENV = "ERP_TRACE_LANE"
PROCESS_ID_ENV = "ERP_PROCESS_ID"

TRACE_SCHEMA = "erp-trace/1"
CHROME_SUFFIX = ".chrome.json"

_DEFAULT_RING = 16384
_MAX_ARG_CHARS = 200
_MAX_DEVICE_RECORDS = 65536

# a profiler range opened by each span: "erp:<name>"
RANGE_PREFIX = "erp:"
# torch's autograd profiler module, whose global flag says whether a
# torch.profiler session records; looked up, never imported
_PROFILER_MODULE = "torch.autograd.profiler"

# spans at least this slow are mirrored into the flightrec event ring so
# the blackbox dump of a crashed run shows its recent stalls without the
# trace file (ordinary dispatch spans would flood the small ring)
_FLIGHTREC_MIN_MS = 50.0


def _short(v):
    """Span args must stay JSON-light: scalars pass through, anything
    else is repr-truncated."""
    if v is None or isinstance(v, (bool, int, float)):
        return v
    s = str(v)
    return s if len(s) <= _MAX_ARG_CHARS else s[:_MAX_ARG_CHARS] + "..."


class _NullSpan:
    """Shared no-op span: the whole disabled-path cost of a ``with
    tracing.span(...)`` block is one flag test, one ``sys.modules``
    lookup and two no-op calls."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


def _recording():
    """torch's autograd profiler module while a ``torch.profiler`` session
    records, else None (torch not loaded, or no session)."""
    prof = sys.modules.get(_PROFILER_MODULE)
    if prof is not None and getattr(prof, "_is_profiler_enabled", False):
        return prof
    return None


class _Range:
    """The span of a disarmed tracer while a profiler records: the
    profiler range alone."""

    __slots__ = ("_rf",)

    def __init__(self, rf):
        self._rf = rf

    def __enter__(self):
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False

    def set(self, **args) -> None:
        pass


# the workunit each thread works for (for_workunit); module-wide, so
# every TraceContext's spans carry it
_wu = threading.local()


def workunit() -> str | None:
    """The workunit id spans opened on this thread carry (None outside a
    session)."""
    return getattr(_wu, "id", None)


def set_workunit(wu: str | None) -> None:
    """Adopt a workunit id captured on another thread (a worker serving
    that workunit's session)."""
    _wu.id = wu


@contextlib.contextmanager
def for_workunit(wu: str | None):
    """Spans opened on this thread inside the block carry ``wu``; the
    thread's previous id comes back after it."""
    prev = getattr(_wu, "id", None)
    _wu.id = wu
    try:
        yield
    finally:
        _wu.id = prev


class _Span:
    __slots__ = ("owner", "name", "tid", "ctx", "wu", "args", "_rf", "_start_us", "_depth")

    def __init__(self, owner, name, tid, ctx, args, rf=None):
        self.owner = owner
        self.name = name
        self.tid = tid
        self.ctx = ctx
        self.wu = None
        self.args = args
        self._rf = rf  # the profiler range, when a profiler records
        self._start_us = 0.0
        self._depth = 0

    def set(self, **args) -> None:
        """Attach/overwrite args after the span opened (e.g. the batch
        size only known mid-block)."""
        self.args.update(args)

    def __enter__(self):
        o = self.owner
        t = threading.current_thread()
        if self.tid is None:
            self.tid = t.name
        if self.ctx is None:
            self.ctx = getattr(o._tls, "ctx", None)
        self.wu = getattr(_wu, "id", None)
        stack = getattr(o._tls, "stack", None)
        if stack is None:
            stack = o._tls.stack = []
        if o._open.get(t.ident) is not stack:  # first span, or re-armed
            with o._state_lock:
                o._open[t.ident] = stack
        self._depth = len(stack)
        stack.append(self)
        # the profiler range opens after the start and closes before the
        # end: the span holds its range, and the range's cost
        self._start_us = o._now_us()
        if self._rf is not None:
            self._rf.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        o = self.owner
        stack = o._tls.stack
        if stack and stack[-1] is self:
            stack.pop()
        else:  # misnested exit: drop self wherever it sits, keep going
            try:
                stack.remove(self)
            except ValueError:
                pass
        if not o._enabled:
            return False  # window closed while the span was open
        rec = {
            "kind": "span",
            "name": self.name,
            "tid": self.tid,
            "ctx": self.ctx,
            "depth": self._depth,
            "ts_us": round(self._start_us, 1),
        }
        if self.wu is not None:
            rec["wu"] = self.wu
        if self.args:
            rec["args"] = {k: _short(v) for k, v in self.args.items()}
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        with o._state_lock:
            # completion stamp taken under the lock: streamed records are
            # strictly ordered by end_us (what --check verifies), at the
            # cost of folding any lock wait into the duration
            end_us = o._now_us()
            if end_us < o._last_end_us:  # perf_counter ties at µs rounding
                end_us = o._last_end_us
            o._last_end_us = end_us
            rec["dur_us"] = round(max(0.0, end_us - self._start_us), 1)
            rec["end_us"] = round(end_us, 1)
            o._ring.append(rec)
            o._total += 1
            # written under the stamp's lock: a span closing on another
            # thread cannot write its later stamp first
            o._write_locked(rec)
        o._bridge(rec)
        return False


# every live context, for the atexit terminator
_contexts_lock = threading.Lock()
_all_contexts: "weakref.WeakSet[TraceContext]" = weakref.WeakSet()


class TraceContext:
    """One isolated tracing window: ring + stream + Chrome export.

    ``metrics_ctx`` / ``recorder`` wire the span bridges to a scoped
    metrics context and flight recorder (``runtime/obs.py``); left None
    they fall through to the module-level defaults, preserving the
    historical singleton behavior for the default context."""

    def __init__(self, name: str = "scoped", env_fallback: bool = False):
        self.name = name
        self._env_fallback = env_fallback
        self.metrics_ctx = None
        self.recorder = None
        self._state_lock = threading.Lock()
        self._enabled = False
        self._stream_path: str | None = None
        self._chrome_path: str | None = None
        self._stream_broken = False
        self._epoch_unix: float | None = None
        self._epoch_perf: float | None = None
        self._ring: deque = deque(maxlen=_DEFAULT_RING)
        self._total = 0  # completed spans+instants (ring may drop)
        self._last_end_us = 0.0  # monotone completion stamp (under lock)
        self._ctx_counter = 0
        self._device_records: list = []  # Chrome export only
        self._open: dict[int, list] = {}  # thread ident -> open-span stack
        self._tls = threading.local()
        self._corr_id: str | None = None
        self._lane_id: str | None = None
        with _contexts_lock:
            _all_contexts.add(self)

    # -- accessors --------------------------------------------------------

    def enabled(self) -> bool:
        return self._enabled

    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch_perf) * 1e6

    def now_us(self) -> float | None:
        """The current offset on this window's timestamp base (µs), or
        None when disabled — what fabric lifecycle lanes stamp their
        transition times with."""
        if not self._enabled:
            return None
        return self._now_us()

    def epoch_unix(self) -> float | None:
        """The Unix time (s) this window's ``ts_us`` count from, or None
        when disabled: what moves a profiler's records onto this clock
        (``steptime.capture_profile``)."""
        if not self._enabled:
            return None
        return self._epoch_unix

    # -- trace contexts (window ids propagated across threads) ------------

    def new_context(self) -> int:
        """Allocate a fresh trace-context id and make it current on this
        thread.  The dispatch loop calls this once per window; spans
        opened while it is current (on any thread that adopted it) carry
        the id."""
        if not self._enabled:
            return 0
        with self._state_lock:
            self._ctx_counter += 1
            ctx = self._ctx_counter
        self._tls.ctx = ctx
        return ctx

    def context(self) -> int | None:
        """The current thread's trace-context id (None outside a
        window)."""
        return getattr(self._tls, "ctx", None)

    def set_context(self, ctx: int | None) -> None:
        """Adopt a context id captured on another thread (prefetch
        worker, rescore feed) so cross-thread spans correlate with their
        window."""
        self._tls.ctx = ctx

    # -- spans ------------------------------------------------------------

    def span(
        self, name: str, tid: str | None = None, ctx: int | None = None,
        **args,
    ):
        """Open a named span as a context manager.  ``tid`` overrides
        the timeline lane (defaults to the thread name), ``ctx`` the
        trace context (defaults to the thread's current one).  While a
        ``torch.profiler`` records, the span also opens the profiler range
        ``erp:<name>``, armed or not.  Disabled path, no profiler: a
        shared inert object."""
        if not self._enabled:
            prof = _recording()
            if prof is None:
                return _NULL_SPAN
            return _Range(prof.record_function(RANGE_PREFIX + name))
        prof = _recording()
        rf = prof.record_function(RANGE_PREFIX + name) if prof is not None else None
        return _Span(self, name, tid, ctx, dict(args) if args else {}, rf)

    def instant(self, name: str, tid: str | None = None, **args) -> None:
        """A zero-duration marker on the timeline (Chrome ``i``
        event)."""
        if not self._enabled:
            return
        rec = {
            "kind": "instant",
            "name": name,
            "tid": tid or threading.current_thread().name,
            "ctx": getattr(self._tls, "ctx", None),
        }
        wu = getattr(_wu, "id", None)
        if wu is not None:
            rec["wu"] = wu
        if args:
            rec["args"] = {k: _short(v) for k, v in args.items()}
        with self._state_lock:
            ts = self._now_us()
            if ts < self._last_end_us:
                ts = self._last_end_us
            self._last_end_us = ts
            rec["ts_us"] = rec["end_us"] = round(ts, 1)
            self._ring.append(rec)
            self._total += 1
            self._write_locked(rec)

    def add_device_records(self, records: list[dict]) -> int:
        """Merge side-channel span records into the timeline.

        ``runtime/devicecost.py`` produces device-side spans — measured
        (profiler xplane) or estimated (AOT roofline) — on lanes named
        ``device:*``; the work fabric produces per-WU lifecycle spans on
        ``wu:*`` lanes.  They land ONLY in the Chrome export and the
        finish summary, never in the JSONL stream: their ``ts_us``
        values interleave with already-streamed host spans, so streaming
        them would break the strict ``end_us`` ordering that ``--check``
        verifies.  Returns the number of records accepted (0 when
        tracing is disabled)."""
        if not self._enabled:
            return 0
        accepted = []
        for rec in records:
            try:
                if not isinstance(rec.get("name"), str):
                    continue
                ts = float(rec["ts_us"])
                dur = float(rec.get("dur_us", 0.0))
                if ts < 0 or dur < 0:
                    continue
            except (KeyError, TypeError, ValueError):
                continue
            accepted.append(
                {
                    "kind": rec.get("kind")
                    if rec.get("kind") in ("span", "instant")
                    else "span",
                    "name": rec["name"],
                    "tid": str(rec.get("tid") or "device"),
                    "ctx": rec.get("ctx"),
                    "ts_us": round(ts, 1),
                    "dur_us": round(dur, 1),
                    "end_us": round(rec.get("end_us", ts + dur), 1),
                    "args": dict(rec.get("args") or {}),
                }
            )
        with self._state_lock:
            room = _MAX_DEVICE_RECORDS - len(self._device_records)
            if room <= 0:
                return 0
            accepted = accepted[:room]
            self._device_records.extend(accepted)
        return len(accepted)

    def device_records(self) -> list[dict]:
        """Accepted side-channel records, in insertion order."""
        with self._state_lock:
            return list(self._device_records)

    def open_spans(self) -> list[dict]:
        """Snapshot of every thread's open-span stack, innermost last —
        the flight recorder embeds this in the blackbox dump so a crash
        shows exactly which pipeline stage was live when the run died."""
        if not self._enabled:
            return []
        now = self._now_us()
        with self._state_lock:
            stacks = {
                ident: list(stack) for ident, stack in self._open.items()
            }
        threads = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for ident, stack in stacks.items():
            for s in stack:
                try:
                    out.append(
                        {
                            "name": s.name,
                            "tid": s.tid or threads.get(ident, str(ident)),
                            "ctx": s.ctx,
                            "depth": s._depth,
                            "elapsed_ms": round(
                                max(0.0, now - s._start_us) / 1e3, 3
                            ),
                            "args": {
                                k: _short(v) for k, v in s.args.items()
                            },
                        }
                    )
                except Exception:  # a stack mutating mid-crash
                    continue
        out.sort(key=lambda r: (r["tid"], r["depth"]))
        return out

    # -- bridges (metrics histogram + flightrec ring: one time base) ------

    def _bridge(self, rec: dict) -> None:
        ms = rec["dur_us"] / 1e3
        try:
            from . import metrics

            m = self.metrics_ctx if self.metrics_ctx is not None else metrics
            m.histogram(
                "span." + rec["name"] + "_ms", metrics.LATENCY_BUCKETS_MS,
                unit="ms",
            ).observe(ms)
        except Exception:
            pass
        if ms >= _FLIGHTREC_MIN_MS:
            try:
                from . import flightrec

                fr = self.recorder if self.recorder is not None else flightrec
                fr.record(
                    "span", name=rec["name"], tid=rec["tid"],
                    ctx=rec["ctx"], ms=round(ms, 3), ts_us=rec["ts_us"],
                )
            except Exception:
                pass

    # -- stream + export --------------------------------------------------

    def _stream_record(self, rec: dict) -> None:
        with self._state_lock:
            self._write_locked(rec)

    def _write_locked(self, rec: dict) -> None:
        """Append ``rec`` to the stream; the caller holds ``_state_lock``."""
        if self._stream_path is None or self._stream_broken:
            return
        try:
            with open(self._stream_path, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")
        except OSError as e:
            # telemetry must never take down the search; warn once, stop
            self._stream_broken = True
            erplog.warn("Trace stream %s unwritable (%s); disabling.\n",
                        self._stream_path, e)

    def configure(
        self,
        trace_file: str | None = None,
        ring_events: int | None = None,
        force: bool = False,
        lane_id: str | None = None,
    ) -> bool:
        """Arm this tracing window for one run; returns True when
        enabled.

        On the default context ``trace_file`` falls back to
        ``$ERP_TRACE_FILE``; with neither set the layer stays disabled
        (free) unless ``force`` — the in-memory mode tests use to
        exercise the ring without a stream file.  Reconfiguring resets
        the ring (each run's timeline stands alone).

        ``lane_id`` names this process's stable timeline lane in merged
        fleet views (falls back to ``$ERP_TRACE_LANE``, then
        ``host<$ERP_PROCESS_ID>``, then the correlation id on the
        default context); left unresolved the stream header and Chrome
        export keep their historical single-process shape."""
        path = trace_file or (
            os.environ.get(TRACE_FILE_ENV) if self._env_fallback else None
        ) or None
        if path is None and not force:
            return False

        if ring_events is None:
            try:
                ring_events = int(
                    os.environ.get(TRACE_EVENTS_ENV, _DEFAULT_RING)
                )
            except ValueError:
                ring_events = _DEFAULT_RING
        with self._state_lock:
            self._enabled = False  # quiesce racing spans while state swaps
            self._epoch_unix = time.time()
            self._epoch_perf = time.perf_counter()
            self._ring = deque(maxlen=max(16, ring_events))
            self._total = 0
            self._last_end_us = 0.0
            self._ctx_counter = 0
            self._stream_broken = False
            self._stream_path = path
            self._chrome_path = path + CHROME_SUFFIX if path else None
            self._device_records.clear()
            self._open.clear()
            self._corr_id = (
                os.environ.get(CORR_ID_ENV) if self._env_fallback else None
            ) or None
            if lane_id is None and self._env_fallback:
                lane_id = os.environ.get(LANE_ID_ENV) or None
                if lane_id is None:
                    proc = os.environ.get(PROCESS_ID_ENV)
                    if proc is not None and proc.strip() != "":
                        lane_id = f"host{proc.strip()}"
                if lane_id is None:
                    lane_id = self._corr_id
            self._lane_id = lane_id or None
            self._enabled = True
        _register_atexit()
        if path:
            try:  # each run's stream stands alone (append would interleave)
                if os.path.exists(path):
                    os.remove(path)
            except OSError:
                pass
            start = {
                "kind": "start",
                "schema": TRACE_SCHEMA,
                "t": self._epoch_unix,
                "epoch_unix": self._epoch_unix,
                "pid": os.getpid(),
                "argv": sys.argv,
                "ring_events": self._ring.maxlen,
            }
            if self._corr_id:
                start["corr_id"] = self._corr_id
            if self._lane_id:
                start["lane"] = self._lane_id
            self._stream_record(start)
        return True

    def lane_id(self) -> str | None:
        """The stable lane identity resolved at :meth:`configure`, or
        None (historical single-process form)."""
        return self._lane_id

    def events(self) -> list[dict]:
        """The ring's completed records, oldest first."""
        with self._state_lock:
            return list(self._ring)

    def chrome_trace(
        self,
        records: list[dict] | None = None,
        device: list[dict] | None = None,
    ) -> dict:
        """The timeline as a Chrome trace-event JSON object (Perfetto /
        ``chrome://tracing`` compatible): paired ``B``/``E`` duration
        events per span, ``i`` instants, and ``M`` metadata naming the
        process and each timeline lane.  Side-channel records
        (``add_device_records``: ``device:*`` cost lanes, ``wu:*``
        fabric lifecycle lanes) merge here — and only here — so the
        export shows host, chip and fleet time on one clock."""
        if records is None:
            records = self.events()
        if device is None:
            device = self.device_records()
        if device:
            records = list(records) + device
        pid = os.getpid()
        lanes: dict[str, int] = {}

        def lane(tid) -> int:
            t = str(tid)
            if t not in lanes:
                lanes[t] = len(lanes) + 1
            return lanes[t]

        trace_events: list[dict] = []
        for rec in records:
            if rec.get("kind") not in ("span", "instant"):
                continue
            args = dict(rec.get("args") or {})
            if rec.get("ctx") is not None:
                args["ctx"] = rec["ctx"]
            if rec.get("wu") is not None:
                args["wu"] = rec["wu"]
            if rec.get("error"):
                args["error"] = rec["error"]
            base = {
                "name": rec["name"],
                "pid": pid,
                "tid": lane(rec.get("tid", "?")),
                "cat": "erp",
            }
            if rec["kind"] == "instant":
                trace_events.append(
                    {**base, "ph": "i", "ts": rec["ts_us"], "s": "t",
                     "args": args}
                )
                continue
            trace_events.append(
                {**base, "ph": "B", "ts": rec["ts_us"], "args": args}
            )
            trace_events.append(
                {**base, "ph": "E", "ts": rec["end_us"]}
            )
        # stable sort: Chrome requires per-(pid,tid) nesting; ties broken
        # so E precedes B at the same stamp only when it closes an
        # earlier span
        trace_events.sort(key=lambda e: (e["ts"], e["ph"] != "E"))
        # the stable lane identity (not the recyclable OS pid) names the
        # process lane, so a merged fleet timeline can tell two runs
        # that happened to share a pid apart; unset keeps the historical
        # byte-identical form
        proc_name = (
            f"erp-search:{self._lane_id}" if self._lane_id else "erp-search"
        )
        meta = [
            {
                "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": proc_name},
            }
        ]
        for tname, tnum in sorted(lanes.items(), key=lambda kv: kv[1]):
            meta.append(
                {
                    "ph": "M", "pid": pid, "tid": tnum,
                    "name": "thread_name", "args": {"name": tname},
                }
            )
        other = {
            "schema": TRACE_SCHEMA,
            "epoch_unix": self._epoch_unix,
            "spans_total": self._total,
            "spans_dropped": max(
                0, self._total - (len(records) - len(device))
            ),
            "device_records": len(device),
        }
        if self._lane_id:
            other["lane"] = self._lane_id
        return {
            "traceEvents": meta + trace_events,
            "displayTimeUnit": "ms",
            "otherData": other,
        }

    def finish(self, exit_status=None) -> dict | None:
        """Close this tracing window: append the ``finish`` line
        (open-span stack included — empty on a clean exit), write the
        Chrome export next to the stream, disable the layer.  Returns a
        small summary, or None when the layer was never enabled.
        Idempotent."""
        if not self._enabled:
            return None
        still_open = self.open_spans()
        with self._state_lock:
            wall_us = round(self._now_us(), 1)
            total = self._total
            dropped = max(0, total - len(self._ring))
            n_device = len(self._device_records)
        summary = {
            "wall_us": wall_us,
            "spans_total": total,
            "spans_dropped": dropped,
            "device_records": n_device,
            "open_spans": still_open,
            "trace_file": self._stream_path,
            "chrome_trace_file": self._chrome_path,
        }
        self._stream_record(
            {
                "kind": "finish",
                "t": time.time(),
                "end_us": wall_us,
                "exit_status": exit_status,
                "wall_us": wall_us,
                "spans_total": total,
                "spans_dropped": dropped,
                "open_spans": still_open,
            }
        )
        if self._chrome_path:
            doc = self.chrome_trace()
            doc["otherData"]["wall_us"] = wall_us
            doc["otherData"]["exit_status"] = (
                exit_status if isinstance(exit_status, (int, str)) else None
            )
            try:
                tmp = self._chrome_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(doc, f)
                    f.write("\n")
                os.replace(tmp, self._chrome_path)
            except OSError as e:
                erplog.warn("Chrome trace %s unwritable: %s\n",
                            self._chrome_path, e)
        with self._state_lock:
            # leave the context in the same empty state a fresh one has:
            # after finish, events()/device_records() must not replay
            # this window to the next in-process consumer
            self._ring.clear()
            self._device_records.clear()
        self._enabled = False
        return summary

    close = finish  # ObsContext teardown idiom


_DEFAULT = TraceContext(name="default", env_fallback=True)


def default_context() -> TraceContext:
    """The env-driven default context the module-level API delegates to."""
    return _DEFAULT


# ---------------------------------------------------------------------------
# module-level delegation (the historical singleton API)


def enabled() -> bool:
    return _DEFAULT.enabled()


def now_us() -> float | None:
    return _DEFAULT.now_us()


def new_context() -> int:
    return _DEFAULT.new_context()


def context() -> int | None:
    return _DEFAULT.context()


def set_context(ctx: int | None) -> None:
    _DEFAULT.set_context(ctx)


def epoch_unix() -> float | None:
    return _DEFAULT.epoch_unix()


def span(name: str, tid: str | None = None, ctx: int | None = None, **args):
    return _DEFAULT.span(name, tid=tid, ctx=ctx, **args)


def instant(name: str, tid: str | None = None, **args) -> None:
    _DEFAULT.instant(name, tid=tid, **args)


def add_device_records(records: list[dict]) -> int:
    return _DEFAULT.add_device_records(records)


def device_records() -> list[dict]:
    return _DEFAULT.device_records()


def open_spans() -> list[dict]:
    return _DEFAULT.open_spans()


def configure(
    trace_file: str | None = None,
    ring_events: int | None = None,
    force: bool = False,
    lane_id: str | None = None,
) -> bool:
    return _DEFAULT.configure(
        trace_file=trace_file, ring_events=ring_events, force=force,
        lane_id=lane_id,
    )


def lane_id() -> str | None:
    return _DEFAULT.lane_id()


def events() -> list[dict]:
    return _DEFAULT.events()


def chrome_trace(
    records: list[dict] | None = None,
    device: list[dict] | None = None,
) -> dict:
    return _DEFAULT.chrome_trace(records=records, device=device)


def finish(exit_status=None) -> dict | None:
    return _DEFAULT.finish(exit_status)


def _atexit_finish() -> None:
    """Any window still open at interpreter exit means nobody called
    ``finish`` — close each so every stream carries its terminator and
    the Chrome exports exist (open spans at that point are recorded as
    such, which is exactly what --check should flag on a dirty exit)."""
    with _contexts_lock:
        live = [c for c in _all_contexts if c.enabled()]
    for c in live:
        c.finish("abnormal-exit")


_atexit_registered = False


def _register_atexit() -> None:
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(_atexit_finish)


# ---------------------------------------------------------------------------
# validation (shared by tools/metrics_report.py --check and tests)


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_stream(lines: list[dict]) -> list[str]:
    """Structural check of a parsed ``erp-trace/1`` JSONL stream;
    returns a list of problems (empty = valid).  Hand-rolled: the
    container has no jsonschema."""
    errs: list[str] = []
    if not lines:
        return ["empty trace stream"]
    head = lines[0]
    if not isinstance(head, dict) or head.get("kind") != "start":
        errs.append("first record must be kind=start")
    elif head.get("schema") != TRACE_SCHEMA:
        errs.append(
            f"schema is {head.get('schema')!r}, expected {TRACE_SCHEMA!r}"
        )
    elif not _is_num(head.get("epoch_unix")):
        errs.append("start record lacks numeric epoch_unix")
    last_end = -1.0
    finishes = 0
    for i, rec in enumerate(lines[1:], start=2):
        if not isinstance(rec, dict):
            errs.append(f"line {i}: not a JSON object")
            continue
        kind = rec.get("kind")
        if kind == "finish":
            finishes += 1
            if not isinstance(rec.get("open_spans"), list):
                errs.append(f"line {i}: finish lacks open_spans list")
            continue
        if kind not in ("span", "instant"):
            errs.append(f"line {i}: unknown kind {kind!r}")
            continue
        if not rec.get("name") or not isinstance(rec.get("name"), str):
            errs.append(f"line {i}: span lacks a name")
        if not _is_num(rec.get("ts_us")) or rec.get("ts_us", -1) < 0:
            errs.append(f"line {i}: ts_us missing or negative")
        if kind == "span" and (
            not _is_num(rec.get("dur_us")) or rec.get("dur_us", -1) < 0
        ):
            errs.append(f"line {i}: dur_us missing or negative")
        end = rec.get("end_us")
        if not _is_num(end):
            errs.append(f"line {i}: end_us missing")
        elif end < last_end:
            errs.append(
                f"line {i}: end_us {end} goes backwards (prev {last_end})"
            )
        else:
            last_end = end
    if finishes == 0:
        errs.append("no finish record (run died before tracing.finish)")
    elif finishes > 1:
        errs.append(f"{finishes} finish records (expected exactly 1)")
    else:
        fin = lines[-1]
        if fin.get("kind") != "finish":
            errs.append("finish record is not the last line")
        elif fin.get("open_spans"):
            names = [s.get("name") for s in fin["open_spans"]]
            errs.append(f"spans left open on exit: {names}")
    return errs


def validate_chrome(doc) -> list[str]:
    """Structural check of a Chrome trace-event JSON object: every event
    carries ``ph``/``pid``/``tid``, timed events a numeric ``ts``,
    ``B``/``E`` pairs balance per (pid, tid) lane with matching names,
    and flow arrows (``s``/``t``/``f``, the cross-lane causality links
    merged fleet timelines carry) bind to an ``id`` that was started
    before it is stepped/finished and is finished before the trace
    ends."""
    errs: list[str] = []
    if not isinstance(doc, dict) or not isinstance(
        doc.get("traceEvents"), list
    ):
        return ["not an object with a traceEvents list"]
    stacks: dict[tuple, list] = {}
    flows: dict = {}  # flow id -> "open" | "finished"
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("B", "E", "X", "i", "I", "M", "s", "t", "f"):
            errs.append(f"event {i}: unsupported ph {ph!r}")
            continue
        if "pid" not in ev or "tid" not in ev:
            errs.append(f"event {i}: missing pid/tid")
            continue
        if ph == "M":
            continue
        if not _is_num(ev.get("ts")):
            errs.append(f"event {i}: missing numeric ts")
            continue
        if ph in ("s", "t", "f"):
            fid = ev.get("id")
            if fid is None:
                errs.append(f"event {i}: flow {ph!r} lacks an id")
                continue
            state = flows.get(fid)
            if ph == "s":
                if state == "open":
                    errs.append(
                        f"event {i}: flow id {fid!r} started twice"
                    )
                flows[fid] = "open"
            elif state is None:
                errs.append(
                    f"event {i}: flow {ph!r} for id {fid!r} with no "
                    f"start"
                )
            elif state == "finished":
                errs.append(
                    f"event {i}: flow {ph!r} after id {fid!r} finished"
                )
            elif ph == "f":
                flows[fid] = "finished"
            continue
        key = (ev["pid"], ev["tid"])
        if ph == "B":
            stacks.setdefault(key, []).append(ev)
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                errs.append(f"event {i}: E with no open B on lane {key}")
                continue
            b = stack.pop()
            if b.get("name") != ev.get("name"):
                errs.append(
                    f"event {i}: E name {ev.get('name')!r} closes B "
                    f"{b.get('name')!r} on lane {key}"
                )
            elif ev["ts"] < b["ts"]:
                errs.append(f"event {i}: E precedes its B on lane {key}")
    for key, stack in stacks.items():
        if stack:
            errs.append(
                f"lane {key}: {len(stack)} B event(s) never closed "
                f"({[b.get('name') for b in stack]})"
            )
    for fid, state in flows.items():
        if state == "open":
            errs.append(f"flow id {fid!r} started but never finished")
    return errs
