"""Structured metrics + run-report telemetry for the search pipeline.

The port's copy of the JAX package's ``runtime/metrics.py``: the same
registry of monotonic counters, last-value gauges and fixed-bucket
histograms, the same periodic JSONL heartbeat stream and end-of-run **run
report** (``erp-run-report/1``), the same metric names and env knobs, so
``tools/metrics_report.py`` and the serving layer read both packages'
artifacts alike.  ``runtime/profiling.py`` carries the human-read
channels (memory watermarks, phase brackets).

Design rules:

* **Near-zero cost when disabled.**  Every accessor returns a shared
  null instrument whose mutators are no-op method calls; no file is ever
  created, no thread started, and ``import metrics`` never imports torch.
* **Thread-safe.**  The dispatch loop, the rescorer's feed/pool threads
  and the heartbeat emitter all touch the registry concurrently; every
  mutation takes the instrument's lock.
* **Self-contained stream.**  The JSONL stream opens with a ``start``
  line, carries ``heartbeat`` snapshots at ``ERP_METRICS_INTERVAL``
  cadence, and closes with the full ``run_report`` line — the same
  report also written to its own JSON artifact.
* **Scoped contexts.**  All state lives on :class:`MetricsContext`; the
  module-level functions delegate to one default instance (env-driven),
  while resident sessions instantiate their own isolated contexts
  (``runtime/obs.py`` bundles the per-layer contexts).

Where the JAX package bridges ``jax.monitoring`` (recompiles, cache
traffic), the port counts its own builds: ``torch.kernel_builds`` and
``torch.kernel_build_s`` (``nvcc`` runs of ``ops/kernels.py::build``) and
``torch.cufft_plans`` (cuFFT plans created during the window, as
``ops/kernels.py::planned_fft`` reports them).  Both fan out to every live
context, unless the thread that made them is charged to one context
(:func:`charged_to`): a resident server prepares one workunit on its prep
thread while another executes, and each counts its own.

Env surface: ``ERP_METRICS_FILE`` (JSONL stream path; enables the layer),
``ERP_METRICS_INTERVAL`` (heartbeat seconds, default 30, <= 0 disables
heartbeats), ``ERP_RUN_REPORT`` (report path override; default is the
stream path + ``.report.json``), ``ERP_CORR_ID`` (workunit correlation
id).  Env fallbacks apply only to the default context; scoped contexts
take explicit paths.
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

from . import logging as erplog

METRICS_FILE_ENV = "ERP_METRICS_FILE"
METRICS_INTERVAL_ENV = "ERP_METRICS_INTERVAL"
RUN_REPORT_ENV = "ERP_RUN_REPORT"
CORR_ID_ENV = "ERP_CORR_ID"

REPORT_SCHEMA = "erp-run-report/1"
STREAM_SCHEMA = "erp-metrics/1"

_DEFAULT_INTERVAL_S = 30.0

# Fixed latency buckets (ms): wide enough for µs-scale dispatch on fast
# chips through multi-second CPU-backend batches.
LATENCY_BUCKETS_MS = (
    1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)

# Dispatch-window occupancy (in-flight steps at each dispatch).  The
# driver default lookahead is 2; the tail buckets cover operator
# ERP_LOOKAHEAD experiments.
OCCUPANCY_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 16.0)


def labeled(name: str, **labels) -> str:
    """Canonical labeled-metric name: ``name{k=v,...}`` with keys sorted,
    so every call site producing the same label set hits the same
    instrument.  Correlation labels (``host_id=``, ``wu_id=``) keep
    fleet counters groupable without a second registry dimension."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic accumulator (int or float increments)."""

    kind = "counter"
    __slots__ = ("name", "unit", "_lock", "_value")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"kind": self.kind, "unit": self.unit, "value": self.value}


class Gauge:
    """Last-value instrument; holds any JSON scalar (number or string)."""

    kind = "gauge"
    __slots__ = ("name", "unit", "_lock", "_value")

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self._lock = threading.Lock()
        self._value = None

    def set(self, value) -> None:
        with self._lock:
            self._value = value

    @property
    def value(self):
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"kind": self.kind, "unit": self.unit, "value": self.value}


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` tallies observations
    ``<= buckets[i]`` (first matching bound), ``counts[-1]`` the
    overflow.  Tracks count/sum/min/max exactly alongside."""

    kind = "histogram"
    __slots__ = (
        "name", "unit", "buckets", "_lock", "_counts",
        "_count", "_sum", "_min", "_max",
    )

    def __init__(self, name: str, buckets, unit: str = ""):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"histogram {name!r}: buckets must be a nonempty strictly "
                f"increasing sequence, got {buckets!r}"
            )
        self.name = name
        self.unit = unit
        self.buckets = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = None
        self._max = None

    def observe(self, value) -> None:
        v = float(value)
        # bisect without the import: bucket lists are short (<= ~16)
        i = 0
        for bound in self.buckets:
            if v <= bound:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "kind": self.kind,
                "unit": self.unit,
                "buckets": list(self.buckets),
                "counts": list(self._counts),
                "count": self._count,
                "sum": self._sum,
                "min": self._min,
                "max": self._max,
            }


class _NullInstrument:
    """Shared no-op stand-in for every instrument type when the metrics
    layer is disabled: ``inc``/``set``/``observe`` cost one no-op method
    call in the hot loop and nothing else."""

    __slots__ = ()

    def inc(self, n=1) -> None:
        pass

    def set(self, value) -> None:
        pass

    def observe(self, value) -> None:
        pass


_NULL = _NullInstrument()


class Registry:
    """Named instrument store.  ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent across call sites); asking for an existing
    name with a different type is a programming error and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._phases: dict[str, dict] = {}

    def _get_or_create(self, name: str, factory, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str, unit: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, unit), Counter)

    def gauge(self, name: str, unit: str = "") -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, unit), Gauge)

    def histogram(self, name: str, buckets, unit: str = "") -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, buckets, unit), Histogram
        )

    def record_phase(self, name: str, seconds: float) -> None:
        with self._lock:
            p = self._phases.setdefault(name, {"count": 0, "wall_s": 0.0})
            p["count"] += 1
            p["wall_s"] += float(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            metrics = dict(self._metrics)
            phases = {k: dict(v) for k, v in self._phases.items()}
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in metrics.items():
            out[m.kind + "s"][name] = m.snapshot()
        out["phases"] = phases
        return out


# ---------------------------------------------------------------------------
# scoped contexts

# every live context, for the process-global bridges (kernel-build
# listener, atexit flush) that must reach all armed contexts exactly once
_contexts_lock = threading.Lock()
_all_contexts: "weakref.WeakSet[MetricsContext]" = weakref.WeakSet()


class MetricsContext:
    """One isolated metrics window: registry + stream + heartbeat emitter.

    The module-level functions operate on one default instance; scoped
    instances (one per fabric run / fleet session) are fully independent
    — separate registries, stream files, report artifacts, and a
    per-context emitter stop event so closing a scoped context can never
    stop (or duplicate the flush of) another context's heartbeat."""

    def __init__(self, name: str = "scoped", env_fallback: bool = False):
        self.name = name
        self._env_fallback = env_fallback
        self._lock = threading.Lock()
        self._registry = Registry()
        self._enabled = False
        self._stream_path: str | None = None
        self._stream_broken = False
        self._report_path: str | None = None
        self._emitter: threading.Thread | None = None
        self._emitter_stop = threading.Event()
        self._started_monotonic: float | None = None
        self._trace_dirs: list[str] = []
        self._host_trace_file: str | None = None
        self._corr_id: str | None = None
        with _contexts_lock:
            _all_contexts.add(self)

    # -- accessors --------------------------------------------------------

    def enabled(self) -> bool:
        return self._enabled

    def registry(self) -> Registry:
        return self._registry

    def counter(self, name: str, unit: str = ""):
        return self._registry.counter(name, unit) if self._enabled else _NULL

    def gauge(self, name: str, unit: str = ""):
        return self._registry.gauge(name, unit) if self._enabled else _NULL

    def histogram(self, name: str, buckets, unit: str = ""):
        return (
            self._registry.histogram(name, buckets, unit)
            if self._enabled
            else _NULL
        )

    def record_phase(self, name: str, seconds: float) -> None:
        if self._enabled:
            self._registry.record_phase(name, seconds)

    def note_trace(self, logdir: str) -> None:
        """Record that a profiler trace was captured during this run (the
        run report carries it so the trace artifacts correlate afterwards)."""
        if self._enabled:
            with self._lock:
                self._trace_dirs.append(str(logdir))

    def note_host_trace(self, path: str) -> None:
        """Record the host span-trace stream (runtime/tracing.py) active
        for this run, so the run report links the timeline artifacts."""
        if self._enabled:
            with self._lock:
                self._host_trace_file = str(path)

    def cufft_plans(self) -> int:
        """cuFFT plans created in this window (0 when disabled or none)."""
        if not self._enabled or "torch.cufft_plans" not in self._registry._metrics:
            return 0
        return int(self._registry.counter("torch.cufft_plans").value)

    def snapshot(self) -> dict:
        return self._registry.snapshot()

    # -- stream emitter ---------------------------------------------------

    def _write_line(self, record: dict) -> None:
        if self._stream_path is None or self._stream_broken:
            return
        line = json.dumps(record, default=str)
        try:
            with self._lock:
                with open(self._stream_path, "a") as f:
                    f.write(line + "\n")
        except OSError as e:
            # telemetry must never take down the search; warn once, stop
            self._stream_broken = True
            erplog.warn("Metrics stream %s unwritable (%s); disabling.\n",
                        self._stream_path, e)

    def _heartbeat(self, seq: int) -> dict:
        return {
            "kind": "heartbeat",
            "t": time.time(),
            "seq": seq,
            "uptime_s": round(
                time.monotonic() - self._started_monotonic, 3
            ) if self._started_monotonic is not None else 0.0,
            "metrics": self.snapshot(),
        }

    def _emit_loop(self, interval: float, stop: threading.Event) -> None:
        # the stop event is captured by argument: a reconfigure swaps in
        # a fresh event, so a stale emitter from the prior window always
        # sees ITS OWN event set and can never be kept alive (or stopped)
        # by another window's lifecycle
        seq = 0
        while not stop.wait(interval):
            seq += 1
            self._write_line(self._heartbeat(seq))

    def configure(
        self,
        metrics_file: str | None = None,
        interval: float | None = None,
        run_report_file: str | None = None,
        force: bool = False,
    ) -> bool:
        """Arm this context for one run; returns True when enabled.

        On the default context ``metrics_file`` falls back to
        ``$ERP_METRICS_FILE``; with neither set the layer stays disabled
        (free) unless ``force`` — the in-memory mode bench.py uses to
        embed a run report without a stream file.  Scoped contexts take
        explicit paths only.  Reconfiguring resets the registry (each
        run's numbers stand alone)."""
        path = metrics_file or (
            os.environ.get(METRICS_FILE_ENV) if self._env_fallback else None
        ) or None
        if path is None and not force:
            return False

        self.finish(None) if self._enabled else None  # dangling prior window
        with self._lock:
            self._registry = Registry()
            self._trace_dirs = []
            self._host_trace_file = None
            self._stream_broken = False
            self._stream_path = path
            self._report_path = (
                run_report_file
                or (
                    os.environ.get(RUN_REPORT_ENV)
                    if self._env_fallback
                    else None
                )
                or (path + ".report.json" if path else None)
            )
            self._started_monotonic = time.monotonic()
            self._corr_id = (
                os.environ.get(CORR_ID_ENV) if self._env_fallback else None
            ) or None
            self._emitter_stop = threading.Event()
            self._enabled = True
        _register_build_hook()
        _register_atexit()
        if path:
            start = {
                "kind": "start",
                "schema": STREAM_SCHEMA,
                "t": time.time(),
                "pid": os.getpid(),
                "argv": sys.argv,
            }
            if self._corr_id:
                start["corr_id"] = self._corr_id
            self._write_line(start)
            if interval is None:
                try:
                    interval = float(
                        os.environ.get(
                            METRICS_INTERVAL_ENV, _DEFAULT_INTERVAL_S
                        )
                    )
                except ValueError:
                    interval = _DEFAULT_INTERVAL_S
            if interval > 0:
                self._emitter = threading.Thread(
                    target=self._emit_loop,
                    args=(max(0.2, float(interval)), self._emitter_stop),
                    name=f"erp-metrics-heartbeat-{self.name}",
                    daemon=True,
                )
                self._emitter.start()
        return True

    # -- reports ----------------------------------------------------------

    def run_report(self, exit_status, context: dict | None = None) -> dict:
        """The end-of-run summary artifact.  ``exit_status`` is the
        driver's return code; ``None`` means the run died on an unhandled
        exception (recorded as ``"exception"`` so failure reports are
        distinguishable from every numeric code).  String statuses pass
        through verbatim — the abnormal-exit paths (atexit flush,
        flight-recorder dumps) label their reports that way."""
        wall = (
            time.monotonic() - self._started_monotonic
            if self._started_monotonic is not None
            else 0.0
        )
        if exit_status is None:
            status = "exception"
        elif isinstance(exit_status, str):
            status = exit_status
        else:
            status = int(exit_status)
        report = {
            "schema": REPORT_SCHEMA,
            "generated_unix": time.time(),
            "pid": os.getpid(),
            "wall_s": round(wall, 3),
            "exit_status": status,
            "ok": status == 0,
            "metrics": self.snapshot(),
            "tracing": {
                "active": bool(self._trace_dirs),
                "dirs": list(self._trace_dirs),
                "host_trace_file": self._host_trace_file,
            },
            "devices": _device_peaks(),
        }
        ctx = dict(context) if context else {}
        if self._corr_id and "corr_id" not in ctx:
            ctx["corr_id"] = self._corr_id
        if ctx:
            report["context"] = ctx
        return report

    def _write_report(self, report: dict) -> None:
        if not self._report_path:
            return
        try:
            tmp = self._report_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(report, f, indent=1)
                f.write("\n")
            os.replace(tmp, self._report_path)
        except OSError as e:
            erplog.warn(
                "Run report %s unwritable: %s\n", self._report_path, e
            )

    def finish(self, exit_status, context: dict | None = None) -> dict | None:
        """Close this metrics window: stop the heartbeat, append the run
        report to the stream, write the report artifact.  Returns the
        report (None when the context was never enabled).  Idempotent:
        the first call wins; later calls are no-ops until the next
        ``configure``."""
        if not self._enabled:
            return None
        self._emitter_stop.set()
        emitter, self._emitter = self._emitter, None
        if emitter is not None:
            emitter.join(timeout=5.0)
        report = self.run_report(exit_status, context)
        self._write_line(
            {"kind": "run_report", "t": time.time(), "report": report}
        )
        self._write_report(report)
        self._enabled = False
        return report

    close = finish  # ObsContext teardown idiom

    def emergency_flush(self, status: str = "abnormal-exit") -> dict | None:
        """Flush telemetry NOW without closing the window: append a final
        heartbeat line and (re)write the report artifact labelled with
        ``status``.  The flight recorder's dump path calls this — on its
        own context only, so a scoped dump never double-flushes the
        default window — so a run killed between cadence ticks still
        ships its last numbers; if the process survives (graceful
        SIGTERM), the normal ``finish`` later overwrites the artifact
        with the real exit status."""
        if not self._enabled:
            return None
        hb = self._heartbeat(-1)  # out-of-band: not the emitter's sequence
        self._write_line(hb)
        report = self.run_report(status)
        try:
            self._write_report(report)
        except OSError:
            pass
        return report


_DEFAULT = MetricsContext(name="default", env_fallback=True)


def default_context() -> MetricsContext:
    """The env-driven default context the module-level API delegates to."""
    return _DEFAULT


def _live_contexts() -> list[MetricsContext]:
    with _contexts_lock:
        return [c for c in _all_contexts if c.enabled()]


# ---------------------------------------------------------------------------
# module-level delegation (the historical singleton API, byte-compatible)


def enabled() -> bool:
    return _DEFAULT.enabled()


def registry() -> Registry:
    return _DEFAULT.registry()


def counter(name: str, unit: str = ""):
    return _DEFAULT.counter(name, unit)


def gauge(name: str, unit: str = ""):
    return _DEFAULT.gauge(name, unit)


def histogram(name: str, buckets, unit: str = ""):
    return _DEFAULT.histogram(name, buckets, unit)


def record_phase(name: str, seconds: float) -> None:
    _DEFAULT.record_phase(name, seconds)


def note_trace(logdir: str) -> None:
    _DEFAULT.note_trace(logdir)


def note_host_trace(path: str) -> None:
    _DEFAULT.note_host_trace(path)


def snapshot() -> dict:
    return _DEFAULT.snapshot()


def configure(
    metrics_file: str | None = None,
    interval: float | None = None,
    run_report_file: str | None = None,
    force: bool = False,
) -> bool:
    return _DEFAULT.configure(
        metrics_file=metrics_file,
        interval=interval,
        run_report_file=run_report_file,
        force=force,
    )


def run_report(exit_status, context: dict | None = None) -> dict:
    return _DEFAULT.run_report(exit_status, context)


def finish(exit_status, context: dict | None = None) -> dict | None:
    return _DEFAULT.finish(exit_status, context)


def emergency_flush(status: str = "abnormal-exit") -> dict | None:
    return _DEFAULT.emergency_flush(status)


# ---------------------------------------------------------------------------
# kernel builds and cuFFT plans (the port's counterpart of the JAX
# package's jax.monitoring bridge)

_build_hooked = False
_atexit_registered = False
_charge = threading.local()


@contextlib.contextmanager
def charged_to(ctx: MetricsContext | None):
    """Kernel builds and cuFFT plans made on this thread inside the block
    count in ``ctx`` alone (None: in every live context, the default)."""
    prev = getattr(_charge, "ctx", None)
    _charge.ctx = ctx
    try:
        yield
    finally:
        _charge.ctx = prev


def _charged_contexts() -> list[MetricsContext]:
    ctx = getattr(_charge, "ctx", None)
    if ctx is not None:
        return [ctx] if ctx.enabled() else []
    return _live_contexts()


def _on_kernel_build(n_built: int, seconds: float) -> None:
    for ctx in _charged_contexts():
        ctx.registry().counter("torch.kernel_builds").inc(int(n_built))
        ctx.registry().counter("torch.kernel_build_s", unit="s").inc(float(seconds))


def _on_cufft_plans(n_made: int) -> None:
    for ctx in _charged_contexts():
        ctx.registry().counter("torch.cufft_plans").inc(int(n_made))


def _register_build_hook() -> None:
    """Count ``nvcc`` runs of ``ops/kernels.py::build`` (one per kernel
    source compiled; a cached library counts nothing) and the cuFFT plans
    of ``ops/kernels.py::planned_fft``.  Registered once per process."""
    global _build_hooked
    if _build_hooked:
        return
    from ..ops import kernels  # stdlib-only at import: no torch

    _build_hooked = True
    kernels.build_listeners.append(_on_kernel_build)
    kernels.plan_listeners.append(_on_cufft_plans)


def _cuda_ready():
    """``torch`` when this process already imported it and initialised
    CUDA, else None: the metrics layer never imports torch itself and
    never creates a CUDA context."""
    torch = sys.modules.get("torch")
    try:
        if torch is not None and torch.cuda.is_initialized():
            return torch
    except Exception:
        pass
    return None


def _device_peaks() -> list[dict]:
    """Per-card peak memory for the run report: the caching allocator's
    peak (``torch.cuda.max_memory_allocated``) and the card's size
    (``mem_get_info``).  Empty when the process never initialised CUDA."""
    if _cuda_ready() is None:
        return []
    try:
        from . import profiling

        return [
            {
                "device": s["device"],
                "peak_bytes_in_use": s["peak_bytes_in_use"],
                "bytes_limit": s["bytes_limit"],
            }
            for s in profiling.memory_stats()
        ]
    except Exception:  # diagnostics only — report generation must not fail
        return []


def compact_report(report: dict) -> dict:
    """Small embeddable view (bench.py's stdout line is capped ~2 kB by
    the capture window): phase walls + counter/gauge values, histograms
    reduced to count/sum/max."""
    m = report.get("metrics", {})
    return {
        "wall_s": report.get("wall_s"),
        "exit_status": report.get("exit_status"),
        "phases": {
            k: round(v["wall_s"], 3) for k, v in m.get("phases", {}).items()
        },
        "counters": {
            k: v["value"] for k, v in m.get("counters", {}).items()
        },
        "gauges": {k: v["value"] for k, v in m.get("gauges", {}).items()},
        "histograms": {
            k: {"count": v["count"], "sum": round(v["sum"], 3), "max": v["max"]}
            for k, v in m.get("histograms", {}).items()
        },
    }


def _atexit_flush() -> None:
    """Any window still open at interpreter exit means nobody called
    ``finish`` — the run died between cadence ticks (hard SystemExit,
    stray exception path).  Close every live context exactly once with
    an ``abnormal-exit`` status so no final heartbeat is lost."""
    for ctx in _live_contexts():
        ctx.finish("abnormal-exit")


def _register_atexit() -> None:
    global _atexit_registered
    if not _atexit_registered:
        _atexit_registered = True
        atexit.register(_atexit_flush)


# ---------------------------------------------------------------------------
# schema validation (shared by tools/metrics_report.py --check and tests)

def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_report(report) -> list[str]:
    """Structural check of a run report; returns a list of problems
    (empty = valid).  Hand-rolled: the container has no jsonschema."""
    errs: list[str] = []
    if not isinstance(report, dict):
        return ["report is not a JSON object"]
    if report.get("schema") != REPORT_SCHEMA:
        errs.append(
            f"schema is {report.get('schema')!r}, expected {REPORT_SCHEMA!r}"
        )
    if not _is_num(report.get("wall_s")) or report.get("wall_s", -1) < 0:
        errs.append("wall_s missing or not a nonnegative number")
    status = report.get("exit_status")
    if not (isinstance(status, int) and not isinstance(status, bool)) and (
        not isinstance(status, str)
    ):
        errs.append(
            "exit_status must be an int or a status string "
            "(\"exception\", \"abnormal-exit\", ...)"
        )
    if not isinstance(report.get("ok"), bool):
        errs.append("ok must be a bool")
    m = report.get("metrics")
    if not isinstance(m, dict):
        errs.append("metrics missing or not an object")
        return errs
    for section in ("counters", "gauges", "histograms", "phases"):
        if not isinstance(m.get(section), dict):
            errs.append(f"metrics.{section} missing or not an object")
    for name, c in (m.get("counters") or {}).items():
        if not isinstance(c, dict) or not _is_num(c.get("value")):
            errs.append(f"counter {name}: value must be a number")
    for name, h in (m.get("histograms") or {}).items():
        if not isinstance(h, dict):
            errs.append(f"histogram {name}: not an object")
            continue
        buckets, counts = h.get("buckets"), h.get("counts")
        if (
            not isinstance(buckets, list)
            or not all(_is_num(b) for b in buckets)
            or buckets != sorted(buckets)
        ):
            errs.append(f"histogram {name}: buckets must be a sorted list")
        if (
            not isinstance(counts, list)
            or not isinstance(buckets, list)
            or len(counts) != len(buckets) + 1
        ):
            errs.append(
                f"histogram {name}: counts must have len(buckets)+1 entries"
            )
        elif h.get("count") != sum(counts):
            errs.append(
                f"histogram {name}: count {h.get('count')} != sum(counts) "
                f"{sum(counts)}"
            )
    for name, p in (m.get("phases") or {}).items():
        if (
            not isinstance(p, dict)
            or not _is_num(p.get("wall_s"))
            or not isinstance(p.get("count"), int)
        ):
            errs.append(f"phase {name}: needs numeric wall_s and int count")
    tracing = report.get("tracing")
    if not isinstance(tracing, dict) or not isinstance(
        tracing.get("active"), bool
    ):
        errs.append("tracing.active missing or not a bool")
    return errs
