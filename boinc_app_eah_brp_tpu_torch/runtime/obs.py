"""Scoped observability contexts: one bundle per session / fabric run.

The observability layers are process-global singletons — one metrics
registry, one trace ring, one flight recorder per process — the right
shape for the one-workunit volunteer binary.  A resident server runs
many Sessions in one process: each needs its own counters, its own
timeline and its own black box, without stepping on the default
artifacts the driver still writes.

:class:`ObsContext` is that unit of isolation.  It instantiates one
:class:`~.metrics.MetricsContext`, one :class:`~.tracing.TraceContext`
and one :class:`~.flightrec.Recorder`, and wires the cross-layer
bridges *within the bundle*:

* completed trace spans feed the bundle's ``span.<name>_ms`` histograms
  and its flightrec ring (not the default ones);
* a flightrec dump embeds the bundle's metrics snapshot and open-span
  stack, and emergency-flushes the bundle's metrics stream only — so a
  scoped dump never double-flushes the default context.

The module-level APIs of ``metrics`` / ``tracing`` / ``flightrec`` keep
delegating to their env-driven default instances, so every existing
call site and artifact is untouched; :func:`default` wraps those same
defaults in the bundle interface for code that wants one type to pass
around.

Never imports torch: an ObsContext is constructible in tools and tests on
any host.  The same bundle as the JAX package's ``runtime/obs.py``.
"""

from __future__ import annotations

from . import flightrec, metrics, tracing


class ObsContext:
    """One isolated observability scope: metrics + tracing + flightrec
    with intra-bundle bridges wired.

    Construct, ``configure(...)`` the layers you want armed, use the
    ``metrics`` / ``tracing`` / ``flightrec`` attributes exactly like
    the module-level APIs, then ``close(exit_status)``."""

    def __init__(self, name: str = "scoped"):
        self.name = name
        self.metrics = metrics.MetricsContext(name=name)
        self.tracing = tracing.TraceContext(name=name)
        self.flightrec = flightrec.Recorder(name=name)
        # bridges stay inside the bundle: spans -> this bundle's
        # histograms/ring, dumps -> this bundle's snapshot/flush
        self.tracing.metrics_ctx = self.metrics
        self.tracing.recorder = self.flightrec
        self.flightrec.metrics_ctx = self.metrics
        self.flightrec.tracing_ctx = self.tracing
        self._closed = False

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return (
            f"ObsContext({self.name!r}, metrics="
            f"{'on' if self.metrics.enabled() else 'off'}, tracing="
            f"{'on' if self.tracing.enabled() else 'off'}, flightrec="
            f"{'armed' if self.flightrec.armed() else 'off'})"
        )

    def configure(
        self,
        *,
        metrics_file: str | None = None,
        metrics_interval: float | None = None,
        run_report_file: str | None = None,
        trace_file: str | None = None,
        trace_ring: int | None = None,
        dump_dir: str | None = None,
        context: dict | None = None,
        force_metrics: bool = False,
        force_trace: bool = False,
    ) -> "ObsContext":
        """Arm the layers for one scoped run.  Each layer arms only when
        given a target (or forced into in-memory mode), mirroring the
        module-level semantics minus the env fallbacks — a scoped
        context is explicit by construction.  Returns self for
        chaining."""
        if metrics_file or run_report_file or force_metrics:
            self.metrics.configure(
                metrics_file=metrics_file,
                interval=metrics_interval,
                run_report_file=run_report_file,
                force=force_metrics,
            )
        if trace_file or force_trace:
            self.tracing.configure(
                trace_file=trace_file, ring_events=trace_ring,
                force=force_trace,
            )
        if dump_dir is not None:
            self.flightrec.arm(dump_dir=dump_dir, context=context)
        return self

    def close(self, exit_status=0, context: dict | None = None) -> dict:
        """Tear the bundle down in crash-forensics order — recorder
        first (a dump during teardown should still see the other
        layers), then tracing, then metrics (stops its heartbeat
        emitter).  Idempotent; returns the layer summaries."""
        if self._closed:
            return {}
        self._closed = True
        self.flightrec.disarm()
        trace_summary = self.tracing.finish(exit_status)
        report = self.metrics.finish(exit_status, context=context)
        return {"tracing": trace_summary, "run_report": report}

    def __enter__(self) -> "ObsContext":
        return self

    def __exit__(self, etype, exc, tb) -> bool:
        if etype is not None and self.flightrec.armed():
            self.flightrec.dump("scoped-exception", exc=(etype, exc, tb))
        self.close("abnormal-exit" if etype is not None else 0)
        return False


class _DefaultBundle:
    """The env-driven default contexts behind the bundle interface.

    Bridges are NOT rewired here: the defaults already reach each other
    through the module-level fallbacks, and rebinding them would break
    the singleton call sites."""

    name = "default"

    def __init__(self):
        self.metrics = metrics.default_context()
        self.tracing = tracing.default_context()
        self.flightrec = flightrec.default_recorder()


_DEFAULT_BUNDLE = _DefaultBundle()


def default() -> _DefaultBundle:
    """The default (env-driven, process-global) contexts as one bundle —
    what fabric code uses when no scoped ObsContext is supplied."""
    return _DEFAULT_BUNDLE
