"""Flight recorder: crash forensics for the search runtime.

The reference app treats a volunteer host's crash as a first-class
diagnosable event: its signal handlers walk the stack with
``erp_execinfo_plus`` and print it to the uploaded stderr
(``erp_boinc_wrapper.cpp``), because the only artifact a dead volunteer
run ever ships home is what it wrote on the way down.  This module is
the port's black box, a copy of the JAX package's ``runtime/flightrec.py``
with the same ``erp-blackbox/1`` format:

* a bounded, thread-safe **event ring** of structured events — dispatch
  / drain / checkpoint / rescore / autobatch decisions / health
  violations / fabric lifecycle transitions — fed by the hot loops at
  ~µs cost per event;
* a tap on ``runtime/logging.py`` keeping the **last N log lines**;
* the **in-flight dispatch window** state (one mutable snapshot updated
  per batch by ``run_bank``);
* crash handlers layered onto the existing ``boinc.py`` SIGTERM/SIGINT
  path: ``faulthandler`` for the genuine fault signals (SIGSEGV /
  SIGFPE / SIGBUS / SIGILL — a Python-level handler for those would
  re-execute the faulting instruction forever, so they get text
  tracebacks to a sidecar file), a Python SIGABRT handler, and
  ``sys.excepthook`` / ``threading.excepthook`` wrappers.

On any abnormal exit :func:`dump` writes one ``erp-blackbox/1`` JSON
document next to the checkpoint: the event ring, all-thread Python
tracebacks, the exception (if any), a ``torch`` section (the version, the
card's name, the memory allocated and reserved), the last metrics
snapshot, and the dispatch
window — enough to answer "what was the run doing when it died" from
the artifact alone.

Scoped contexts: the ring/log-tail/dispatch/dump state lives on
:class:`Recorder`, and the module-level functions delegate to one
default instance — the only one that installs the process-wide crash
hooks and env-driven dump-dir override.  Scoped recorders
(``runtime/obs.py``) give the fabric and future fleet sessions isolated
event rings and dump targets; crash *ownership* (excepthook,
faulthandler, SIGABRT) stays with the default, because a process dies
exactly once.  A recorder's ``dump`` pushes the emergency flush of its
OWN metrics context only, so a scoped dump never double-flushes the
default stream.

Env surface: ``ERP_BLACKBOX=off`` disables the whole layer (all
recorders); ``ERP_BLACKBOX_DIR`` overrides the dump directory for the
default recorder only (default: the dir the driver armed with —
checkpoint dir, else output dir); ``ERP_BLACKBOX_EVENTS`` sizes the
ring (default 256).

Never imports torch: the ``torch`` section reads it only when the
process already loaded it, and never creates a CUDA context.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import sys
import threading
import time
import traceback
import weakref
from collections import deque

from . import logging as erplog
from . import metrics

SCHEMA = "erp-blackbox/1"

BLACKBOX_ENV = "ERP_BLACKBOX"
BLACKBOX_DIR_ENV = "ERP_BLACKBOX_DIR"
BLACKBOX_EVENTS_ENV = "ERP_BLACKBOX_EVENTS"

_DEFAULT_RING = 256
_LOG_TAIL_N = 50


def disabled() -> bool:
    return (os.environ.get(BLACKBOX_ENV, "") or "").strip().lower() in (
        "off", "none", "0", "false",
    )


# every live recorder, so the log tap fans each line out to all armed
# rings without the tap holding strong references
_recorders_lock = threading.Lock()
_all_recorders: "weakref.WeakSet[Recorder]" = weakref.WeakSet()


class Recorder:
    """One isolated flight-recorder scope: ring + log tail + dispatch
    snapshot + dump target.

    ``metrics_ctx`` / ``tracing_ctx`` wire the dump's metrics snapshot,
    emergency flush and open-span capture to a scoped observability
    context (``runtime/obs.py``); left None they fall through to the
    module-level defaults.  Only the recorder constructed with
    ``owns_hooks=True`` (the module default) installs crash hooks and
    the faulthandler sidecar — scoped recorders isolate events, not
    process death."""

    def __init__(
        self, name: str = "scoped",
        env_fallback: bool = False, owns_hooks: bool = False,
    ):
        self.name = name
        self._env_fallback = env_fallback
        self._owns_hooks = owns_hooks
        self.metrics_ctx = None
        self.tracing_ctx = None
        # Mutations that must be atomic rebind whole objects (deque
        # append and attribute assignment are atomic under the GIL); the
        # state lock only serializes arm/disarm/dump-count against each
        # other.
        self._state_lock = threading.Lock()
        self._armed = False
        self._dump_dir: str | None = None
        self._context: dict = {}
        self._ring: deque = deque(maxlen=_DEFAULT_RING)
        self._log_tail: deque = deque(maxlen=_LOG_TAIL_N)
        self._dispatch: dict = {}
        self._dump_count = 0
        self._last_dump_path: str | None = None
        # dump() can be re-entered: a signal handler firing while an
        # exception dump is mid-write would interleave two writers.
        # Non-blocking acquire: legitimate dumps are sequential, so a
        # contender is always a re-entry — drop it rather than deadlock
        # inside a signal handler.
        self._dump_lock = threading.Lock()
        with _recorders_lock:
            _all_recorders.add(self)

    # -- recording --------------------------------------------------------

    def armed(self) -> bool:
        return self._armed

    def last_dump_path(self) -> str | None:
        return self._last_dump_path

    def record(self, kind: str, **fields) -> None:
        """Append one structured event to the ring.  No-op when
        disarmed, so hot-loop call sites pay one attribute read +
        branch."""
        if not self._armed:
            return
        ev = {"t": time.time(), "kind": kind}
        ev.update(fields)
        self._ring.append(ev)

    def note_dispatch(self, **fields) -> None:
        """Replace the in-flight dispatch-window snapshot (one mutable
        dict, not a ring event: the dump wants only the LATEST window
        state)."""
        if not self._armed:
            return
        d = {"t": time.time()}
        d.update(fields)
        self._dispatch = d

    def dispatch_snapshot(self) -> dict:
        """The latest in-flight dispatch-window snapshot (empty when
        none) — the watchdog's incident log blames this window for
        off-loop wedges."""
        return dict(self._dispatch)

    def _tap_line(self, line: str) -> None:
        if self._armed:
            self._log_tail.append(line.rstrip("\n"))

    # -- arm / disarm -----------------------------------------------------

    def arm(
        self, dump_dir: str | None = None, context: dict | None = None,
    ) -> bool:
        """Arm the recorder for one run: reset the ring, remember where
        dumps go, and — on the hook-owning default — (re)install the
        crash hooks.  Idempotent per process/recorder.  Returns False
        (and stays inert) when ``ERP_BLACKBOX=off``."""
        if disabled():
            return False
        try:
            cap = int(os.environ.get(BLACKBOX_EVENTS_ENV, _DEFAULT_RING))
        except ValueError:
            cap = _DEFAULT_RING
        with self._state_lock:
            self._dump_dir = (
                (os.environ.get(BLACKBOX_DIR_ENV) if self._env_fallback
                 else None)
                or dump_dir
                or os.getcwd()
            )
            self._context = dict(context or {})
            self._ring = deque(maxlen=max(16, cap))
            self._log_tail = deque(maxlen=_LOG_TAIL_N)
            self._dispatch = {}
            self._dump_count = 0
            self._armed = True
        _install_tap()
        if self._owns_hooks:
            with _hooks_lock:
                _install_hooks()
                _enable_faulthandler(self._dump_dir)
        return True

    def update_context(self, **fields) -> None:
        """Set ``fields`` in the context every later dump carries (the
        driver names the pass of a task it is running)."""
        with self._state_lock:
            self._context.update(fields)

    def disarm(self) -> None:
        """Stop recording (any installed hooks stay but gate on the
        armed flag, so a disarmed recorder behaves like one never
        armed).  The hook owner also releases the faulthandler sidecar
        and removes it when empty — a clean run must not litter the
        checkpoint directory."""
        self._armed = False
        if self._owns_hooks:
            _release_faulthandler()

    close = disarm  # ObsContext teardown idiom

    # -- dump -------------------------------------------------------------

    def build_dump(self, reason: str, exc=None) -> dict:
        """The ``erp-blackbox/1`` document.  Every section is
        best-effort: forensics of a dying process must not die
        itself."""
        doc: dict = {
            "schema": SCHEMA,
            "t": time.time(),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "reason": str(reason),
            "context": dict(self._context),
            "dispatch": dict(self._dispatch),
            "events": list(self._ring),
            "log_tail": list(self._log_tail),
        }
        for key, fn in (
            ("threads", _thread_tracebacks),
            ("torch", _torch_info),
            ("open_spans", self._open_spans),
        ):
            try:
                doc[key] = fn()
            except Exception as e:
                doc[key] = None
                doc.setdefault("section_errors", {})[key] = (
                    f"{type(e).__name__}: {e}"
                )
        if exc is not None:
            try:
                etype, value, tb = exc if isinstance(exc, tuple) else (
                    type(exc), exc, exc.__traceback__
                )
                doc["exception"] = {
                    "type": getattr(etype, "__name__", str(etype)),
                    "message": str(value),
                    "traceback": traceback.format_exception(etype, value, tb),
                }
            except Exception:
                doc["exception"] = {"type": "unknown", "message": repr(exc)}
        else:
            doc["exception"] = None
        try:
            m = self.metrics_ctx if self.metrics_ctx is not None else metrics
            doc["metrics"] = m.snapshot() if m.enabled() else None
        except Exception:
            doc["metrics"] = None
        return doc

    def _open_spans(self) -> list[dict]:
        """The host span tracer's open-span stack at the moment of death
        — which pipeline stage each thread was inside when the run died.
        Lazy import: tracing pulls flightrec only inside its bridge, so
        neither module costs the other anything at import time."""
        from . import tracing

        t = self.tracing_ctx if self.tracing_ctx is not None else tracing
        return t.open_spans()

    def dump(self, reason: str, exc=None) -> str | None:
        """Write the black-box JSON; returns its path (None when
        disarmed, unwritable, or another dump is already in progress).
        Also pushes the OWN metrics context's emergency flush so the
        final heartbeat / run report survive alongside the dump — and
        only that context's, so a scoped dump never double-flushes the
        default stream."""
        if not self._armed:
            return None
        if not self._dump_lock.acquire(blocking=False):
            erplog.warn(
                "Black-box dump already in progress; skipping dump (%s).\n",
                reason,
            )
            return None
        try:
            try:
                m = (
                    self.metrics_ctx
                    if self.metrics_ctx is not None else metrics
                )
                m.emergency_flush(f"blackbox:{reason}")
            except Exception:
                pass
            doc = self.build_dump(reason, exc=exc)
            with self._state_lock:
                self._dump_count += 1
                n = self._dump_count
            name = (
                f"erp-blackbox-{os.getpid()}.json"
                if n == 1
                else f"erp-blackbox-{os.getpid()}-{n}.json"
            )
            path = os.path.join(self._dump_dir or ".", name)
            try:
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(doc, f, indent=1, default=str)
                    f.write("\n")
                os.replace(tmp, path)
            except OSError as e:
                erplog.warn("Black-box dump %s unwritable: %s\n", path, e)
                return None
            self._last_dump_path = path
            erplog.error("Black-box dump written: %s (%s)\n", path, reason)
            if self._owns_hooks:
                # every process-level crash is an incident: let the hang
                # doctor's quarantine accounting see it (lazy import —
                # watchdog imports this module).  Scoped dumps stay out
                # of the global quarantine ledger.
                try:
                    from . import watchdog

                    watchdog.on_crash_dump(reason)
                except Exception:
                    pass
            return path
        finally:
            self._dump_lock.release()


# ---------------------------------------------------------------------------
# process-global crash plumbing (owned by the default recorder)

_hooks_lock = threading.Lock()
_hooks_installed = False
_tap_installed = False
_fault_file = None
_fault_path: str | None = None
_prev_excepthook = None
_prev_threading_hook = None


def _log_tap(level, line: str) -> None:
    with _recorders_lock:
        live = list(_all_recorders)
    for r in live:
        r._tap_line(line)


def _install_tap() -> None:
    global _tap_installed
    if not _tap_installed:
        erplog.set_tap(_log_tap)
        _tap_installed = True


def _on_sigabrt(signum, frame):
    # externally delivered SIGABRT (or a Python-level abort): dump, then
    # restore the default disposition and re-raise so the exit status is
    # still "killed by SIGABRT" (wrapper retry logic keys on it)
    dump("signal:SIGABRT")
    signal.signal(signal.SIGABRT, signal.SIG_DFL)
    os.kill(os.getpid(), signal.SIGABRT)


def _excepthook(etype, value, tb):
    dump("unhandled-exception", exc=(etype, value, tb))
    if _prev_excepthook is not None:
        _prev_excepthook(etype, value, tb)


def _threading_hook(args):
    # a crashed worker thread does not kill the process, but it silently
    # degrades the run (dead prefetcher, dead heartbeat) — dump anyway
    record(
        "thread-exception",
        thread=getattr(args.thread, "name", None),
        type=getattr(args.exc_type, "__name__", str(args.exc_type)),
        message=str(args.exc_value),
    )
    dump(
        "thread-exception",
        exc=(args.exc_type, args.exc_value, args.exc_traceback),
    )
    if _prev_threading_hook is not None:
        _prev_threading_hook(args)


def _install_hooks() -> None:
    global _hooks_installed, _prev_excepthook, _prev_threading_hook
    if not _hooks_installed:
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
        _prev_threading_hook = threading.excepthook
        threading.excepthook = _threading_hook
        _hooks_installed = True
    try:
        # signal handlers only exist on the main thread; an arm() from a
        # worker thread keeps everything else and skips this part
        signal.signal(signal.SIGABRT, _on_sigabrt)
    except ValueError:
        pass


def _enable_faulthandler(dump_dir: str | None) -> None:
    """Text tracebacks for the genuine fault signals.  These must stay
    with faulthandler's C-level handler: a Python handler returning from
    SIGSEGV re-executes the faulting instruction in an infinite loop.
    The output file sits next to the JSON dumps."""
    global _fault_file, _fault_path
    path = os.path.join(
        dump_dir or ".", f"erp-blackbox-{os.getpid()}.faulthandler.txt"
    )
    try:
        f = open(path, "w")
    except OSError:
        return
    old, _fault_file = _fault_file, f
    try:
        faulthandler.enable(file=f, all_threads=True)
    except (OSError, ValueError):
        _fault_file = old
        f.close()
        return
    _fault_path = path
    if old is not None:
        try:
            old.close()
        except OSError:
            pass


def _release_faulthandler() -> None:
    global _fault_file, _fault_path
    with _hooks_lock:
        f, path = _fault_file, _fault_path
        _fault_file = _fault_path = None
    if f is None:
        return
    try:
        faulthandler.disable()
    except (OSError, ValueError):
        pass
    try:
        f.close()
    except OSError:
        pass
    try:
        if path is not None and os.path.getsize(path) == 0:
            os.unlink(path)
    except OSError:
        pass


# ---------------------------------------------------------------------------
# dump-section helpers shared by every recorder

def _thread_tracebacks() -> list[dict]:
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        t = names.get(ident)
        out.append(
            {
                "ident": ident,
                "name": t.name if t is not None else None,
                "daemon": t.daemon if t is not None else None,
                "stack": [
                    {"file": fs.filename, "line": fs.lineno, "func": fs.name}
                    for fs in traceback.extract_stack(frame)
                ],
            }
        )
    return out


def _torch_info() -> dict | None:
    """torch version, card and memory summary — only if the process
    already imported torch (the dump path must never trigger the import
    itself).  Each query stands alone: after a sticky CUDA error (an
    illegal address, a device-side assert) every CUDA call raises, and
    the dump must still be written, so a failed query becomes a note."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    info: dict = {"version": str(getattr(torch, "__version__", "?"))}
    try:
        if not torch.cuda.is_initialized():
            info["cuda"] = None
            return info
    except Exception as e:
        info["error"] = f"{type(e).__name__}: {e}"
        return info
    for key, fn in (
        ("device", lambda: torch.cuda.get_device_name(torch.cuda.current_device())),
        ("memory_allocated", torch.cuda.memory_allocated),
        ("memory_reserved", torch.cuda.memory_reserved),
        ("max_memory_allocated", torch.cuda.max_memory_allocated),
    ):
        try:
            info[key] = fn()
        except Exception as e:
            info.setdefault("errors", {})[key] = f"{type(e).__name__}: {e}"
    return info


# ---------------------------------------------------------------------------
# the default recorder + module-level delegation (historical API)

_DEFAULT = Recorder(name="default", env_fallback=True, owns_hooks=True)


def default_recorder() -> Recorder:
    """The env-driven, hook-owning recorder the module-level API
    delegates to."""
    return _DEFAULT


def armed() -> bool:
    return _DEFAULT.armed()


def last_dump_path() -> str | None:
    return _DEFAULT.last_dump_path()


def record(kind: str, **fields) -> None:
    _DEFAULT.record(kind, **fields)


def note_dispatch(**fields) -> None:
    _DEFAULT.note_dispatch(**fields)


def dispatch_snapshot() -> dict:
    return _DEFAULT.dispatch_snapshot()


def arm(dump_dir: str | None = None, context: dict | None = None) -> bool:
    return _DEFAULT.arm(dump_dir=dump_dir, context=context)


def update_context(**fields) -> None:
    _DEFAULT.update_context(**fields)


def disarm() -> None:
    _DEFAULT.disarm()


def build_dump(reason: str, exc=None) -> dict:
    return _DEFAULT.build_dump(reason, exc=exc)


def dump(reason: str, exc=None) -> str | None:
    return _DEFAULT.dump(reason, exc=exc)


def __getattr__(name: str):
    # historical private surface a few tests poke; resolve against the
    # default recorder so `flightrec._ring` keeps meaning "the process
    # ring" after the scoped-context refactor (PEP 562)
    if name == "_ring":
        return _DEFAULT._ring
    if name == "_dump_lock":
        return _DEFAULT._dump_lock
    if name == "_dispatch":
        return _DEFAULT._dispatch
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# ---------------------------------------------------------------------------
# schema validation (tools/metrics_report.py --check, blackbox_report, tests)

def events_from_dump(doc) -> list[dict]:
    """The well-formed wall-clock events of an ``erp-blackbox/1`` dump,
    oldest first — the form ``tools/fleet_timeline.py`` merges onto a
    crashed host's lane.  Tolerant of partial dumps: events without a
    numeric ``t`` or a ``kind`` are skipped, never raised on."""
    if not isinstance(doc, dict):
        return []
    out = []
    for ev in doc.get("events") or []:
        if (
            isinstance(ev, dict)
            and isinstance(ev.get("t"), (int, float))
            and not isinstance(ev.get("t"), bool)
            and ev.get("kind")
        ):
            out.append(dict(ev))
    out.sort(key=lambda ev: ev["t"])
    return out


def validate_dump(doc) -> list[str]:
    """Structural check of an ``erp-blackbox/1`` document; returns the
    list of problems (empty = valid).  Hand-rolled like
    ``metrics.validate_report`` — the container has no jsonschema."""
    errs: list[str] = []
    if not isinstance(doc, dict):
        return ["dump is not a JSON object"]
    if doc.get("schema") != SCHEMA:
        errs.append(f"schema is {doc.get('schema')!r}, expected {SCHEMA!r}")
    if not isinstance(doc.get("reason"), str) or not doc.get("reason"):
        errs.append("reason missing or not a nonempty string")
    if not isinstance(doc.get("pid"), int):
        errs.append("pid missing or not an int")
    if not isinstance(doc.get("t"), (int, float)):
        errs.append("t missing or not a number")
    events = doc.get("events")
    if not isinstance(events, list):
        errs.append("events missing or not a list")
    else:
        for i, ev in enumerate(events):
            if not isinstance(ev, dict) or "kind" not in ev or "t" not in ev:
                errs.append(f"events[{i}]: needs t and kind")
                break
    if not isinstance(doc.get("dispatch"), dict):
        errs.append("dispatch missing or not an object")
    tail = doc.get("log_tail")
    if not isinstance(tail, list) or not all(
        isinstance(s, str) for s in tail
    ):
        errs.append("log_tail missing or not a list of strings")
    threads = doc.get("threads")
    if not isinstance(threads, list) or not threads:
        errs.append("threads missing or empty")
    else:
        for i, th in enumerate(threads):
            if not isinstance(th, dict) or not isinstance(
                th.get("stack"), list
            ):
                errs.append(f"threads[{i}]: needs a stack list")
                break
    exc = doc.get("exception")
    if exc is not None and (
        not isinstance(exc, dict) or not isinstance(exc.get("type"), str)
    ):
        errs.append("exception must be null or carry a type string")
    if "context" in doc and not isinstance(doc["context"], dict):
        errs.append("context must be an object")
    return errs
