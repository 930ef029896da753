"""Live serving SLO telemetry: the heartbeat a resident fleet emits
while it is still running.

``FleetServer.stats()`` is a one-shot end-of-run snapshot — a server
that serves for hours has no health surface until it closes.  This
module is the rolling-window counterpart: the :class:`SLOMonitor` rides the
Scheduler's execute path and the server's queue, keeps bounded rolling
windows of

* per-geometry measured step latency (the ``runtime/steptime.py``
  bracket's records, p50/p95/p99 via the shared exact percentiles in
  ``runtime/percentiles.py``),
* inter-WU gap (the same stream ``stats()`` summarizes at the end),
* queue depth and recompile events,

and emits a periodic ``erp-serving-slo/1`` heartbeat line to a JSONL
stream, flagging SLO burn against the committed
``FLEET_SERVING_BASELINE.json`` floors *while the server runs* instead
of at ``stats()``.  ``close()`` always emits a final heartbeat, so even
a seconds-long bench run leaves at least one line for
``tools/metrics_report.py --check`` to validate.

Wiring: ``FleetServer`` arms one from ``$ERP_SLO_FILE`` automatically
(interval ``$ERP_SLO_INTERVAL``, default 10 s) and hands it to its
Scheduler; embedders can construct and attach one explicitly via
``Scheduler.arm_slo``.  Monitoring never takes down serving: every
observe/emit is best-effort, and a monitor with no stream path is a
pure in-memory window (``snapshot()`` on demand).

The port's copy of the JAX package's ``serving/slo.py``, on the port's
``runtime/percentiles.py``; ``n_chips`` is the Scheduler's
``n_devices`` (the cards of the process).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from ..runtime import logging as erplog
from ..runtime.percentiles import latency_block

SLO_SCHEMA = "erp-serving-slo/1"

SLO_FILE_ENV = "ERP_SLO_FILE"
SLO_INTERVAL_ENV = "ERP_SLO_INTERVAL"
SLO_WINDOW_ENV = "ERP_SLO_WINDOW"

_DEFAULT_INTERVAL_S = 10.0
_DEFAULT_WINDOW = 512

BASELINE_FILE = "FLEET_SERVING_BASELINE.json"


def _load_baseline(baseline) -> dict:
    """Accepts a dict, a path, or None (probe ``BASELINE_FILE`` in the
    cwd).  Absent/unreadable baselines mean no burn gating — the
    heartbeat still carries the rolling numbers."""
    if isinstance(baseline, dict):
        return baseline
    path = baseline or (BASELINE_FILE if os.path.exists(BASELINE_FILE) else None)
    if not path:
        return {}
    try:
        with open(path) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else {}
    except (OSError, ValueError) as e:
        erplog.warn("SLO baseline %s unreadable (%s); burn gating off.\n",
                    path, e)
        return {}


def slo_key(args) -> str:
    """Short stable per-geometry label for the step-latency windows:
    bank file + the knobs that decide the compiled executable (the
    human-readable cousin of ``server._geometry_proxy``)."""
    bank = os.path.basename(str(getattr(args, "templatebank", "?") or "?"))
    return (
        f"{bank}:b{getattr(args, 'batch_size', '?')}"
        f":w{getattr(args, 'window', '?')}"
    )


class SLOMonitor:
    """Rolling serving-health window + periodic heartbeat stream."""

    def __init__(
        self,
        *,
        path: str | None = None,
        baseline=None,
        interval_s: float | None = None,
        window: int | None = None,
        n_chips=None,
        name: str = "fleet",
    ):
        self.name = name
        self.path = path
        self.baseline = _load_baseline(baseline)
        self._n_chips = n_chips  # callable or int; resolved lazily
        if window is None:
            try:
                window = int(os.environ.get(SLO_WINDOW_ENV, _DEFAULT_WINDOW))
            except ValueError:
                window = _DEFAULT_WINDOW
        window = max(16, window)
        self._lock = threading.Lock()
        self._step_ms: dict[str, deque] = {}
        self._gaps_s: deque = deque(maxlen=window)
        self._wall_s: deque = deque(maxlen=window)
        self._window = window
        self._queue_depth = 0
        self._queue_depth_max = 0
        self._sessions = 0
        self._failed = 0
        self._recompiles_total = 0
        self._recompiles_after_warmup = 0
        self.warmed = False
        self._seq = 0
        self._last_t = 0.0
        self._last_doc: dict | None = None
        self._stream_broken = False
        self._closed = False
        if path:
            try:  # each server run's stream stands alone
                if os.path.exists(path):
                    os.remove(path)
            except OSError:
                pass
        if interval_s is None:
            try:
                interval_s = float(
                    os.environ.get(SLO_INTERVAL_ENV, _DEFAULT_INTERVAL_S)
                )
            except ValueError:
                interval_s = _DEFAULT_INTERVAL_S
        self.interval_s = max(0.2, interval_s)
        self._stop = threading.Event()
        self._thread = None
        if path:
            self._thread = threading.Thread(
                target=self._emit_loop, name=f"erp-{name}-slo", daemon=True
            )
            self._thread.start()

    # -- observation (Scheduler / FleetServer feed) -----------------------

    def observe_session(
        self, key: str, result, step_ms=None, gap_s: float | None = None
    ) -> None:
        """One completed Session: its geometry key, SessionResult,
        measured step latencies (ms, from the steptime bracket — may be
        empty when ``ERP_STEPTIME`` is off) and the inter-WU gap that
        preceded it."""
        with self._lock:
            warmup = self._sessions == 0 and not self.warmed
            self._sessions += 1
            if not getattr(result, "ok", False):
                self._failed += 1
            rec = int(getattr(result, "recompiles", 0) or 0)
            self._recompiles_total += rec
            if not warmup:
                self._recompiles_after_warmup += rec
            self._wall_s.append(float(getattr(result, "wall_s", 0.0) or 0.0))
            if gap_s is not None:
                self._gaps_s.append(float(gap_s))
            if step_ms:
                dq = self._step_ms.get(key)
                if dq is None:
                    dq = self._step_ms[key] = deque(maxlen=self._window)
                dq.extend(float(v) for v in step_ms)

    def observe_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._queue_depth = int(depth)
            if depth > self._queue_depth_max:
                self._queue_depth_max = int(depth)

    # -- rollup -----------------------------------------------------------

    def _chips(self) -> int:
        n = self._n_chips
        if callable(n):
            try:
                n = n()
            except Exception:
                n = 1
        return max(1, int(n or 1))

    def _burn_flags(self, gaps_block, wus_per_hour_per_chip, sessions) -> list[str]:
        """Rolling-window burn against the committed serving floors.
        Throughput is only judged with >= 2 completed sessions (one
        session's wall is warmup-shaped); gap p95 and recompiles gate
        from the first heartbeat."""
        b = self.baseline
        flags: list[str] = []
        if not b:
            return flags
        gap_max = b.get("p95_inter_wu_gap_s_max")
        if gap_max is not None and gaps_block["n"] > 0 and (
            gaps_block["p95"] > gap_max
        ):
            flags.append(
                f"p95 inter-WU gap {gaps_block['p95']:.4f}s exceeds "
                f"baseline max {gap_max}s"
            )
        rec_max = b.get("recompiles_after_warmup_max")
        if rec_max is not None and self._recompiles_after_warmup > rec_max:
            flags.append(
                f"{self._recompiles_after_warmup} recompiles after warmup "
                f"exceed baseline max {rec_max}"
            )
        thr_min = b.get("wus_per_hour_per_chip_min")
        if (
            thr_min is not None and sessions >= 2
            and 0 < wus_per_hour_per_chip < thr_min
        ):
            flags.append(
                f"{wus_per_hour_per_chip:.1f} WUs/hour/chip under "
                f"baseline floor {thr_min}"
            )
        return flags

    def snapshot(self) -> dict:
        """One heartbeat document (``erp-serving-slo/1``): the rolling
        windows, rolled up with the shared exact percentiles, plus the
        burn flags against the baseline floors.  Advances the heartbeat
        ``seq``; read-only consumers (the ``/statusz`` / ``/healthz``
        introspection plane) use :meth:`peek` instead."""
        return self._snapshot(bump_seq=True)

    def peek(self) -> dict:
        """A current heartbeat document WITHOUT advancing ``seq`` — the
        stream's strictly-increasing sequence stays gap-free no matter
        how often an introspection endpoint is scraped."""
        return self._snapshot(bump_seq=False)

    def _snapshot(self, *, bump_seq: bool) -> dict:
        with self._lock:
            if bump_seq:
                self._seq += 1
            seq = self._seq
            t = time.time()
            if t < self._last_t:
                t = self._last_t
            self._last_t = t
            gaps = list(self._gaps_s)
            walls = list(self._wall_s)
            steps = {k: list(v) for k, v in self._step_ms.items()}
            sessions = self._sessions
            failed = self._failed
            depth = self._queue_depth
            depth_max = self._queue_depth_max
            rec_total = self._recompiles_total
            rec_after = self._recompiles_after_warmup
        busy = sum(walls)
        chips = self._chips()
        wuph = (
            round(len(walls) / (busy / 3600.0) / chips, 3) if busy > 0 else 0.0
        )
        gaps_block = latency_block(gaps, digits=4)
        flags = self._burn_flags(gaps_block, wuph, sessions)
        return {
            "schema": SLO_SCHEMA,
            "kind": "heartbeat",
            "name": self.name,
            "seq": seq,
            "t": round(t, 6),
            "sessions": sessions,
            "failed": failed,
            "queue_depth": depth,
            "queue_depth_max": depth_max,
            "n_chips": chips,
            "window": {
                "sessions": len(walls),
                "busy_wall_s": round(busy, 3),
                "wus_per_hour_per_chip": wuph,
            },
            "inter_wu_gap_s": gaps_block,
            "step_latency_ms": {
                k: latency_block(v, digits=3) for k, v in sorted(steps.items())
            },
            "recompiles": {"total": rec_total, "after_warmup": rec_after},
            "slo": {
                "baseline": bool(self.baseline),
                "burning": bool(flags),
                "flags": flags,
            },
        }

    # -- stream -----------------------------------------------------------

    def _write_line(self, doc: dict) -> None:
        if not self.path or self._stream_broken:
            return
        try:
            line = json.dumps(doc, default=str)
            with open(self.path, "a") as f:
                f.write(line + "\n")
        except OSError as e:
            self._stream_broken = True
            erplog.warn("SLO stream %s unwritable (%s); disabling.\n",
                        self.path, e)

    def heartbeat(self) -> dict:
        """Emit one heartbeat now (burn flags are also logged, so a tail
        of the server log shows the SLO state without the stream)."""
        doc = self.snapshot()
        if doc["slo"]["burning"]:
            erplog.warn(
                "Serving SLO burning: %s\n", "; ".join(doc["slo"]["flags"])
            )
        self._write_line(doc)
        self._last_doc = doc
        return doc

    def last_heartbeat(self) -> dict | None:
        """The most recently *emitted* heartbeat document (None before
        the first) — what ``/statusz`` reports as the stream's view, as
        opposed to the live :meth:`peek` rollup."""
        return self._last_doc

    def _emit_loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.heartbeat()
            except Exception:
                pass  # monitoring must never take down serving

    def close(self) -> dict | None:
        """Stop the emitter and write the final heartbeat (guarantees at
        least one line per server run).  Idempotent."""
        if self._closed:
            return None
        self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        doc = self.heartbeat()
        doc["kind"] = "final"  # in-memory marker; the stream line says heartbeat
        return doc


def monitor_from_env(*, n_chips=None, name: str = "fleet") -> SLOMonitor | None:
    """The FleetServer hook: an armed monitor when ``$ERP_SLO_FILE``
    names a stream path, else None (zero threads, zero state)."""
    path = os.environ.get(SLO_FILE_ENV)
    if not path:
        return None
    return SLOMonitor(path=path, n_chips=n_chips, name=name)


# ---------------------------------------------------------------------------
# validation (shared by tools/metrics_report.py --check)


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _check_block(block, path: str, errs: list[str]) -> None:
    if not isinstance(block, dict):
        errs.append(f"{path} missing or not an object")
        return
    for key in ("n", "p50", "p95", "p99"):
        if not _is_num(block.get(key)):
            errs.append(f"{path}.{key} missing or not numeric")


def validate_serving_slo(doc) -> list[str]:
    """Structural check of one ``erp-serving-slo/1`` heartbeat."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["not a JSON object"]
    if doc.get("schema") != SLO_SCHEMA:
        errs.append(
            f"schema is {doc.get('schema')!r}, expected {SLO_SCHEMA!r}"
        )
    if not isinstance(doc.get("seq"), int) or doc.get("seq", 0) < 1:
        errs.append("missing positive integer seq")
    if not _is_num(doc.get("t")):
        errs.append("missing numeric t")
    for key in ("sessions", "failed", "queue_depth"):
        v = doc.get(key)
        if not _is_num(v) or v < 0:
            errs.append(f"missing nonnegative {key}")
    _check_block(doc.get("inter_wu_gap_s"), "inter_wu_gap_s", errs)
    steps = doc.get("step_latency_ms")
    if not isinstance(steps, dict):
        errs.append("missing step_latency_ms object")
    else:
        for key, block in steps.items():
            _check_block(block, f"step_latency_ms[{key}]", errs)
    rec = doc.get("recompiles")
    if not isinstance(rec, dict) or not _is_num(rec.get("total")):
        errs.append("missing recompiles.total")
    slo = doc.get("slo")
    if not isinstance(slo, dict) or not isinstance(slo.get("flags"), list):
        errs.append("missing slo.flags list")
    elif bool(slo.get("burning")) != bool(slo["flags"]):
        errs.append("slo.burning inconsistent with slo.flags")
    return errs


def validate_slo_stream(lines: list[dict]) -> list[str]:
    """A heartbeat JSONL stream: every line a valid heartbeat, seq
    strictly increasing, t non-decreasing."""
    if not lines:
        return ["empty SLO stream"]
    errs: list[str] = []
    last_seq = 0
    last_t = -1.0
    for i, doc in enumerate(lines, start=1):
        for e in validate_serving_slo(doc):
            errs.append(f"line {i}: {e}")
        if not isinstance(doc, dict):
            continue
        seq, t = doc.get("seq"), doc.get("t")
        if isinstance(seq, int):
            if seq <= last_seq:
                errs.append(
                    f"line {i}: seq {seq} not strictly increasing "
                    f"(prev {last_seq})"
                )
            else:
                last_seq = seq
        if _is_num(t):
            if t < last_t:
                errs.append(f"line {i}: t {t} goes backwards (prev {last_t})")
            else:
                last_t = t
    return errs
