"""Measured step time: how long one batch of the search takes on the card.

The port's counterpart of the JAX package's ``runtime/steptime.py``, with
the same ``erp-steptime/1`` stream, metric (``steptime.step_ms``), trace
instant (``step-measured``), env knobs and validators.  The dispatch loop
(``models/search.py::run_bank``) brackets each batched step with two CUDA
events on the stream: one recorded before the step's kernels are queued,
one after.  Their elapsed time is the step's time on the card.  The
bracket never waits: each ``observe`` collects the brackets whose end
event the card has already passed (an event query, no synchronize), and
``flush`` at the end of the loop waits for the rest.  The loop keeps
queueing ahead exactly as it does with the gate off.  (The JAX bracket
drains each step instead.)  On the CPU, where each step runs to its end
before the call returns, the bracket is the wall clock.

* **Near-zero cost when disabled.**  ``recorder()`` returns one shared
  no-op object; the loop pays three no-op method calls per batch, and
  ``import steptime`` never imports torch.
* **Thread-safe.**  One recorder per dispatch loop; the shared context
  appends under a lock.

Three outputs per measured window: a ``steptime.step_ms`` histogram
observation (``runtime/metrics.py``), a ``step-measured`` instant in the
host trace stream (``runtime/tracing.py``), and a record in this module's
own ``erp-steptime/1`` JSONL artifact when ``ERP_STEPTIME_FILE`` names a
path.

:func:`capture_profile` is the on-demand device half: it wraps a block in
a ``torch.profiler`` session over the CPU and CUDA activities, maps each
kernel to its stage through the port's own stage map
(:func:`stage_of_kernel`: the kernels of ``csrc/`` and cuFFT's), and
merges the per-stage records into the Chrome export as a
``device:measured`` lane.  ``ERP_STEPTIME_PROFILE=<dir>`` arms it for the
Session's template loop (:func:`maybe_capture_profile`).

Env surface: ``ERP_STEPTIME`` (truthy enables the bracket),
``ERP_STEPTIME_FILE`` (JSONL artifact path; implies enabled),
``ERP_STEPTIME_EVENTS`` (ring capacity, default 65536),
``ERP_STEPTIME_PROFILE`` (profiler logdir for the session's template
loop).  Env fallbacks apply only to the default context.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

from . import logging as erplog
# the kernel -> stage map lives in the stage registry (re-exported here)
from .devicecost import SCOPE_PREFIX, stage_of_kernel
from .percentiles import latency_block

STEPTIME_ENV = "ERP_STEPTIME"
STEPTIME_FILE_ENV = "ERP_STEPTIME_FILE"
STEPTIME_EVENTS_ENV = "ERP_STEPTIME_EVENTS"
STEPTIME_PROFILE_ENV = "ERP_STEPTIME_PROFILE"

STEPTIME_SCHEMA = "erp-steptime/1"
REPORT_SCHEMA = "erp-step-report/1"
BASELINE_SCHEMA = "erp-steptime-baseline/1"

_DEFAULT_RING = 65536

_FALSY = ("", "0", "false", "no", "off")


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() not in _FALSY


class _NullRecorder:
    """Shared no-op bracket: the whole disabled-path cost per batch is
    three no-op method calls — no clock read, no event, nothing."""

    __slots__ = ()

    def begin(self) -> None:
        pass

    def observe(self, state, start, stop) -> None:
        pass

    def flush(self) -> None:
        pass


_NULL_RECORDER = _NullRecorder()


class _Recorder:
    """One live bracket for one dispatch loop on ``device``: ``begin()``
    before the step is queued, ``observe(state, start, stop)`` after it.
    On a card each bracket is a pair of CUDA events read lazily (see the
    module docstring); on the CPU it is the wall clock."""

    __slots__ = ("_ctx", "_t0", "_ev0", "_pending", "_torch")

    def __init__(self, ctx: "StepTimeContext", device=None):
        self._ctx = ctx
        self._t0 = 0.0
        self._ev0 = None
        self._pending: deque = deque()
        self._torch = None
        if device is not None and getattr(device, "type", str(device).split(":")[0]) == "cuda":
            import torch  # measurement path only; the gate never imports torch

            self._torch = torch

    def begin(self) -> None:
        if self._torch is None:
            self._t0 = time.perf_counter()
            return
        self._ev0 = self._torch.cuda.Event(enable_timing=True)
        self._ev0.record()

    def observe(self, state, start, stop) -> None:
        if self._torch is None:
            self._ctx.record(int(start), int(stop), (time.perf_counter() - self._t0) * 1e3)
            return
        ev1 = self._torch.cuda.Event(enable_timing=True)
        ev1.record()
        self._pending.append((int(start), int(stop), self._ev0, ev1))
        self._collect(wait=False)

    def _collect(self, wait: bool) -> None:
        while self._pending:
            start, stop, ev0, ev1 = self._pending[0]
            if wait:
                ev1.synchronize()
            elif not ev1.query():
                return
            self._pending.popleft()
            self._ctx.record(start, stop, ev0.elapsed_time(ev1))

    def flush(self) -> None:
        """Record every bracket still pending, waiting for the card to pass
        them: call once, where the loop ends."""
        self._collect(wait=True)


# every live context, for the atexit terminator (tracing/metrics idiom)
_contexts_lock = threading.Lock()
_all_contexts: list = []


class StepTimeContext:
    """One measured-step-time window: bounded ring + optional JSONL
    stream + metrics/tracing feeds."""

    def __init__(self, name: str = "scoped", env_fallback: bool = False):
        self.name = name
        self._env_fallback = env_fallback
        self._env_checked = False
        self._lock = threading.Lock()
        self._enabled = False
        self._stream_path: str | None = None
        self._stream_broken = False
        self._ring: deque = deque(maxlen=_DEFAULT_RING)
        self._total = 0
        self._templates = 0
        self._sum_ms = 0.0
        self._last_t = 0.0
        with _contexts_lock:
            _all_contexts.append(self)

    # -- gate -------------------------------------------------------------

    def enabled(self) -> bool:
        return self._enabled

    def _maybe_arm_from_env(self) -> None:
        """Lazy env arming: the bracket is always installed in the
        dispatch loop, so the gate must be decidable without any driver
        wiring — first ``recorder()`` call checks ``$ERP_STEPTIME`` /
        ``$ERP_STEPTIME_FILE`` exactly once per process."""
        if self._env_checked or self._enabled:
            return
        self._env_checked = True
        if _env_truthy(STEPTIME_ENV) or os.environ.get(STEPTIME_FILE_ENV):
            self.configure()

    def recorder(self, device=None):
        """The per-loop bracket for a loop on ``device``: a live recorder
        when measuring, the shared no-op otherwise.  Bind once outside the
        dispatch loop, like the metrics instruments."""
        if self._env_fallback:
            self._maybe_arm_from_env()
        if not self._enabled:
            return _NULL_RECORDER
        return _Recorder(self, device)

    # -- recording --------------------------------------------------------

    def record(self, start: int, stop: int, ms: float) -> None:
        """Append one measured window.  Feeds the ring, the JSONL
        stream, the ``steptime.step_ms`` histogram and a
        ``step-measured`` trace instant (each layer independently
        no-ops when unarmed)."""
        if not self._enabled:
            return
        with self._lock:
            self._total += 1
            seq = self._total
            t = time.time()
            if t < self._last_t:  # wall clock stepped back: keep monotone
                t = self._last_t
            self._last_t = t
            rec = {
                "kind": "step",
                "seq": seq,
                "t": round(t, 6),
                "start": start,
                "stop": stop,
                "templates": max(0, stop - start),
                "ms": round(float(ms), 3),
            }
            self._ring.append(rec)
            self._templates += rec["templates"]
            self._sum_ms += float(ms)
        self._stream_record(rec)
        try:
            from . import metrics, tracing

            metrics.histogram(
                "steptime.step_ms", metrics.LATENCY_BUCKETS_MS, unit="ms"
            ).observe(float(ms))
            tracing.instant(
                "step-measured", start=start, stop=stop,
                ms=round(float(ms), 3),
            )
        except Exception:
            pass  # telemetry must never take down the search

    def records(self, since: int = 0) -> list[dict]:
        """Measured windows with ``seq > since``, oldest first (bounded
        by the ring: a long fleet run keeps the most recent window)."""
        with self._lock:
            return [r for r in self._ring if r["seq"] > since]

    def count(self) -> int:
        with self._lock:
            return self._total

    def summary(self) -> dict:
        """The scoreboard block: ``{windows, templates,
        templates_per_sec, step_ms: {n, p50, p95, p99, mean, max}}``
        over the ring's windows (percentiles) and lifetime totals
        (throughput)."""
        with self._lock:
            ring = list(self._ring)
            total = self._total
            templates = self._templates
            sum_ms = self._sum_ms
        return {
            "windows": total,
            "templates": templates,
            "templates_per_sec": round(
                templates / (sum_ms / 1e3), 3
            ) if sum_ms > 0 else 0.0,
            "step_ms": latency_block([r["ms"] for r in ring], digits=3),
        }

    # -- stream -----------------------------------------------------------

    def _stream_record(self, rec: dict) -> None:
        if self._stream_path is None or self._stream_broken:
            return
        try:
            line = json.dumps(rec, default=str)
            with self._lock:
                with open(self._stream_path, "a") as f:
                    f.write(line + "\n")
        except OSError as e:
            self._stream_broken = True
            erplog.warn("Steptime stream %s unwritable (%s); disabling.\n",
                        self._stream_path, e)

    def configure(
        self, steptime_file: str | None = None, ring_events: int | None = None,
        force: bool = False,
    ) -> bool:
        """Arm this window; returns True when enabled.  On the default
        context the stream path falls back to ``$ERP_STEPTIME_FILE``;
        ``force`` arms the in-memory ring without a file (tests, tools).
        Reconfiguring resets the ring — each run's windows stand alone."""
        path = steptime_file or (
            os.environ.get(STEPTIME_FILE_ENV) if self._env_fallback else None
        ) or None
        if path is None and not force and not (
            self._env_fallback and _env_truthy(STEPTIME_ENV)
        ):
            return False
        if ring_events is None:
            try:
                ring_events = int(
                    os.environ.get(STEPTIME_EVENTS_ENV, _DEFAULT_RING)
                )
            except ValueError:
                ring_events = _DEFAULT_RING
        with self._lock:
            self._ring = deque(maxlen=max(16, ring_events))
            self._total = 0
            self._templates = 0
            self._sum_ms = 0.0
            self._last_t = 0.0
            self._stream_broken = False
            self._stream_path = path
            self._enabled = True
        _register_atexit()
        if path:
            try:  # each run's stream stands alone (append would interleave)
                if os.path.exists(path):
                    os.remove(path)
            except OSError:
                pass
            self._stream_record(
                {
                    "kind": "start",
                    "schema": STEPTIME_SCHEMA,
                    "t": time.time(),
                    "pid": os.getpid(),
                    "argv": sys.argv,
                }
            )
        return True

    def finish(self, exit_status=None) -> dict | None:
        """Close the window: append the finish line (with the summary
        block) and disable.  Returns the summary, or None when never
        enabled.  Idempotent."""
        if not self._enabled:
            return None
        summary = self.summary()
        self._stream_record(
            {
                "kind": "finish",
                "t": time.time(),
                "exit_status": exit_status,
                "summary": summary,
            }
        )
        with self._lock:
            self._enabled = False
            self._ring.clear()
            self._total = 0
            self._templates = 0
            self._sum_ms = 0.0
        return summary

    close = finish


_DEFAULT = StepTimeContext(name="default", env_fallback=True)


def default_context() -> StepTimeContext:
    return _DEFAULT


# ---------------------------------------------------------------------------
# module-level delegation


def enabled() -> bool:
    return _DEFAULT.enabled()


def recorder(device=None):
    return _DEFAULT.recorder(device)


def record(start: int, stop: int, ms: float) -> None:
    _DEFAULT.record(start, stop, ms)


def records(since: int = 0) -> list[dict]:
    return _DEFAULT.records(since)


def count() -> int:
    return _DEFAULT.count()


def summary() -> dict:
    return _DEFAULT.summary()


def configure(
    steptime_file: str | None = None, ring_events: int | None = None,
    force: bool = False,
) -> bool:
    return _DEFAULT.configure(
        steptime_file=steptime_file, ring_events=ring_events, force=force
    )


def finish(exit_status=None) -> dict | None:
    return _DEFAULT.finish(exit_status)


def _atexit_finish() -> None:
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
# on-demand device profiling

# the profiler's categories of work that occupies the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_records_from_chrome(doc) -> list[dict]:
    """The card's work in a ``torch.profiler`` Chrome trace (the parsed
    JSON, or its path): one record per kernel, copy or memset, sorted by
    start, with ``ts_us``/``dur_us``/``end_us`` on the trace's clock."""
    if isinstance(doc, str):
        with open(doc) as f:
            doc = json.load(f)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    out = []
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        out.append({"name": ev.get("name", "?"), "cat": ev["cat"], "ts_us": ts, "dur_us": dur, "end_us": ts + dur})
    out.sort(key=lambda r: r["ts_us"])
    return out


def on_tracer_clock(records: list[dict], doc: dict, epoch_unix: float) -> list[dict]:
    """``records`` of the Chrome trace ``doc`` moved onto the host
    tracer's clock (``runtime/tracing.py``: µs since ``epoch_unix``).
    The profiler's ``ts`` counts µs from the trace's
    ``baseTimeNanoseconds``; both bases are Unix time, so the move is one
    shift."""
    shift = float(doc.get("baseTimeNanoseconds", 0)) / 1e3 - float(epoch_unix) * 1e6
    return [{**r, "ts_us": r["ts_us"] + shift, "end_us": r["end_us"] + shift} for r in records]


def device_idle_share(records: list[dict], n_gaps: int = 3) -> dict:
    """Busy and idle time of the card over the span of ``records`` (first
    start to last end): ``busy_us`` is the union of the records' intervals,
    ``idle_share`` the rest over the span (None when there is no record),
    and ``gaps`` the ``n_gaps`` longest idle stretches, each with the
    names of the work before and after it."""
    if not records:
        return {"span_us": 0.0, "busy_us": 0.0, "idle_share": None, "n": 0, "gaps": []}
    busy, gaps = 0.0, []
    cur_a, cur_b, last = records[0]["ts_us"], records[0]["end_us"], records[0]
    for r in records[1:]:
        if r["ts_us"] > cur_b:
            busy += cur_b - cur_a
            gaps.append({"us": r["ts_us"] - cur_b, "after": last["name"], "before": r["name"]})
            cur_a, cur_b = r["ts_us"], r["end_us"]
        else:
            cur_b = max(cur_b, r["end_us"])
        if r["end_us"] >= last["end_us"]:
            last = r
    busy += cur_b - cur_a
    span = max(r["end_us"] for r in records) - records[0]["ts_us"]
    return {
        "span_us": span,
        "busy_us": busy,
        "idle_share": (1.0 - busy / span) if span > 0 else 0.0,
        "n": len(records),
        "gaps": sorted(gaps, key=lambda g: -g["us"])[:n_gaps],
    }


def stage_records(records: list[dict], lane: str = "device:measured") -> list[dict]:
    """Per-stage measured records for the Chrome export: the records whose
    kernel maps to a stage (:func:`stage_of_kernel`), renamed
    ``erp.<stage>`` and moved onto ``lane``; the rest are dropped."""
    out = []
    for r in records:
        stage = stage_of_kernel(r.get("name"))
        if stage is None:
            continue
        out.append(
            {
                "name": SCOPE_PREFIX + stage,
                "tid": lane,
                "ts_us": r["ts_us"],
                "dur_us": r["dur_us"],
                "end_us": r["end_us"],
                "args": {"measured": True, "stage": stage, "op": r.get("name", "?")},
            }
        )
    return out


@dataclass
class ProfileCapture:
    """Result of one :func:`capture_profile` session: the raw device
    records, the per-stage records merged into the Chrome export, the
    per-stage measured totals and the card's idle share."""

    logdir: str
    lane: str = "device:measured"
    records: list = field(default_factory=list)
    stage_records: list = field(default_factory=list)
    stage_ms: dict = field(default_factory=dict)
    idle: dict = field(default_factory=dict)
    warning: str | None = None


@contextmanager
def capture_profile(logdir: str, lane: str = "device:measured"):
    """Device-profiling orchestrator: a ``torch.profiler`` session (CPU and
    CUDA activities) around the with-block, its Chrome trace written to
    ``<logdir>/trace.json``, the card's records mapped to stages and merged
    into the host tracer's Chrome export as ``lane``, on the tracer's clock
    (:func:`on_tracer_clock`), so a kernel sits under the host span that
    launched it.

    Yields a :class:`ProfileCapture` filled on exit.  A run without a card
    yields a capture with no records and ``warning`` set — a logged
    warning, never an error: profiling is diagnostics, the search result
    is the product."""
    import torch

    from . import metrics, profiling, tracing

    cap = ProfileCapture(logdir=str(logdir), lane=lane)
    os.makedirs(logdir, exist_ok=True)
    with_cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    prof = profiling.start_profiler(with_cuda)
    doc = {}
    try:
        yield cap
    finally:
        try:
            profiling.stop_profiler(prof, with_cuda)
            path = os.path.join(str(logdir), profiling.TRACE_NAME)
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
            cap.records = device_records_from_chrome(doc)
        except Exception as e:  # a dead profiler session must not mask the run
            cap.warning = f"profiler stop failed: {type(e).__name__}: {e}"
        if not cap.records and cap.warning is None:
            cap.warning = "the profile holds no device records"
        if cap.warning:
            erplog.warn("steptime.capture_profile: %s\n", cap.warning)
        cap.stage_records = stage_records(cap.records, lane=lane)
        for r in cap.stage_records:
            stage = r["args"]["stage"]
            cap.stage_ms[stage] = round(cap.stage_ms.get(stage, 0.0) + r["dur_us"] / 1e3, 3)
        cap.idle = device_idle_share(cap.records)
        epoch = tracing.epoch_unix()
        if cap.stage_records and epoch is not None:
            tracing.add_device_records(on_tracer_clock(cap.stage_records, doc, epoch))
        metrics.note_trace(str(logdir))


def maybe_capture_profile():
    """The env-armed form the Session wraps its template loop in:
    :func:`capture_profile` when ``$ERP_STEPTIME_PROFILE`` names a
    logdir, else a no-op context (no torch import, nothing written)."""
    logdir = os.environ.get(STEPTIME_PROFILE_ENV)
    if not logdir:
        return nullcontext(None)
    return capture_profile(logdir)


# ---------------------------------------------------------------------------
# validation (the same checks as the JAX package's steptime.validate_stream
# and validate_step_report)


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_stream(lines: list[dict]) -> list[str]:
    """Structural check of a parsed ``erp-steptime/1`` JSONL stream:
    start header, per-step records with nonnegative ``ms`` and
    non-decreasing timestamps / strictly increasing ``seq``, exactly
    one trailing finish line carrying the summary."""
    errs: list[str] = []
    if not lines:
        return ["empty steptime stream"]
    head = lines[0]
    if not isinstance(head, dict) or head.get("kind") != "start":
        errs.append("first record must be kind=start")
    elif head.get("schema") != STEPTIME_SCHEMA:
        errs.append(
            f"schema is {head.get('schema')!r}, expected {STEPTIME_SCHEMA!r}"
        )
    last_t = -1.0
    last_seq = 0
    finishes = 0
    for i, rec in enumerate(lines[1:], start=2):
        if not isinstance(rec, dict):
            errs.append(f"line {i}: not a JSON object")
            continue
        kind = rec.get("kind")
        if kind == "finish":
            finishes += 1
            if not isinstance(rec.get("summary"), dict):
                errs.append(f"line {i}: finish lacks summary object")
            continue
        if kind != "step":
            errs.append(f"line {i}: unknown kind {kind!r}")
            continue
        if not _is_num(rec.get("ms")) or rec.get("ms", -1) < 0:
            errs.append(f"line {i}: ms missing or negative")
        if not isinstance(rec.get("seq"), int) or rec["seq"] <= last_seq:
            errs.append(
                f"line {i}: seq {rec.get('seq')!r} not strictly increasing "
                f"(prev {last_seq})"
            )
        else:
            last_seq = rec["seq"]
        t = rec.get("t")
        if not _is_num(t):
            errs.append(f"line {i}: t missing")
        elif t < last_t:
            errs.append(f"line {i}: t {t} goes backwards (prev {last_t})")
        else:
            last_t = t
        a, b = rec.get("start"), rec.get("stop")
        if not (isinstance(a, int) and isinstance(b, int) and b > a >= 0):
            errs.append(f"line {i}: window [{a}, {b}) is not a valid range")
    if finishes == 0:
        errs.append("no finish record (run died before steptime.finish)")
    elif finishes > 1:
        errs.append(f"{finishes} finish records (expected exactly 1)")
    elif lines[-1].get("kind") != "finish":
        errs.append("finish record is not the last line")
    return errs


def _check_block(block, path: str, errs: list[str]) -> None:
    if not isinstance(block, dict):
        errs.append(f"{path} missing or not an object")
        return
    for key in ("n", "p50", "p95", "p99", "mean", "max"):
        if not _is_num(block.get(key)):
            errs.append(f"{path}.{key} missing or not numeric")


def validate_step_report(doc) -> list[str]:
    """Structural check of an ``erp-step-report/1`` reconciliation
    artifact (``tools/step_report.py``)."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["not a JSON object"]
    if doc.get("schema") != REPORT_SCHEMA:
        errs.append(
            f"schema is {doc.get('schema')!r}, expected {REPORT_SCHEMA!r}"
        )
    if not doc.get("backend"):
        errs.append("missing backend")
    if not _is_num(doc.get("generated_unix")):
        errs.append("missing numeric generated_unix")
    meas = doc.get("measured")
    if not isinstance(meas, dict):
        errs.append("missing measured object")
    else:
        for key in ("windows", "templates", "templates_per_sec"):
            if not _is_num(meas.get(key)):
                errs.append(f"measured.{key} missing or not numeric")
        _check_block(meas.get("step_ms"), "measured.step_ms", errs)
    model = doc.get("modeled")
    if not isinstance(model, dict):
        errs.append("missing modeled object")
    elif not _is_num(model.get("templates_per_sec")):
        errs.append("modeled.templates_per_sec missing or not numeric")
    stages = doc.get("stages")
    if not isinstance(stages, list) or not stages:
        errs.append("missing non-empty stages list")
    else:
        for i, row in enumerate(stages):
            if not isinstance(row, dict) or not row.get("stage"):
                errs.append(f"stage row {i}: missing stage name")
                continue
            for key in ("modeled_fraction", "measured_ms_per_window"):
                if not _is_num(row.get(key)):
                    errs.append(f"stage {row['stage']}: missing numeric {key}")
            frac = row.get("modeled_fraction")
            if _is_num(frac) and not (0.0 <= frac <= 1.0):
                errs.append(
                    f"stage {row['stage']}: modeled_fraction {frac} "
                    "outside [0, 1]"
                )
    if doc.get("device_lane") not in ("measured", "modeled-split"):
        errs.append(
            "device_lane must be 'measured' or 'modeled-split' "
            f"(got {doc.get('device_lane')!r})"
        )
    return errs
