"""Tracing, profiling and device-memory observability.

The port's counterpart of the JAX package's ``runtime/profiling.py``:

* ``device_memory_status(tag)`` — per-card memory usage logging at each
  pipeline stage, the analogue of the reference CUDA backend's
  global-memory watermark prints after every ``set_up_*`` call
  (``cuda_utilities.c:240-259``, called from ``demod_binary.c:1126-1147``),
  read from the caching allocator and ``torch.cuda.mem_get_info``.
* ``trace(...)`` / ``ERP_PROFILE_DIR`` / ``--profile-dir`` —
  ``torch.profiler`` capture of the CPU and CUDA activities around a
  block, written as a Chrome trace (``trace.json``) into the directory.
* ``annotate(name)`` — a named range in that trace
  (``record_function``) and on the NVTX timeline: the ``erp.<stage>``
  device scopes of ``runtime/devicecost.py``.  Every host span of
  ``runtime/tracing.py`` opens its own ``erp:<name>`` range.
* ``phase(name)`` — wall-clock + memory bracket around a pipeline stage at
  debug level, the analogue of the reference's per-kernel-launch
  ``logMessage(debug, ...)`` lines (``demod_binary_cuda.cu:435,519,573``);
  a span, so a profiler trace shows it as ``erp:<name>``.

Nothing here imports torch at module level, and the memory walks never
create a CUDA context in a process that has not made one.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

from . import logging as erplog
from . import metrics, tracing

PROFILE_DIR_ENV = "ERP_PROFILE_DIR"
TRACE_NAME = "trace.json"


def memory_stats() -> list[dict]:
    """One dict per card: bytes in use (allocated tensors), card size and
    the allocator's peak since the last reset.  Empty when the process
    never initialised CUDA (a CPU run has no card to report)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        _, total = torch.cuda.mem_get_info(i)
        out.append(
            {
                "device": f"cuda:{i}",
                "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                "bytes_reserved": int(torch.cuda.memory_reserved(i)),
                "bytes_limit": int(total),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
            }
        )
    return out


def _fmt_bytes(n) -> str:
    if n is None:
        return "n/a"
    return f"{n / (1024.0 * 1024.0):.1f} MB"


def device_memory_status(tag: str, level: erplog.Level = erplog.Level.DEBUG) -> None:
    """Log current/peak memory per card, like the reference's "Used %u MB
    out of %u MB global memory" prints.  Early-returns when ``level`` is
    suppressed: no device walk at all."""
    if not erplog.enabled(level):
        return
    for s in memory_stats():
        erplog.log_message(
            level,
            True,
            "%s: device %s using %s of %s (peak %s)\n",
            tag,
            s["device"],
            _fmt_bytes(s["bytes_in_use"]),
            _fmt_bytes(s["bytes_limit"]),
            _fmt_bytes(s["peak_bytes_in_use"]),
        )


@contextlib.contextmanager
def phase(name: str, level: erplog.Level = erplog.Level.DEBUG):
    """Debug bracket: wall time + post-phase memory for one pipeline stage.

    The wall time always lands in the metrics registry and — when the
    host span tracer is armed — on the span timeline (both no-ops when
    disabled), and a recording ``torch.profiler`` sees the range
    ``erp:<name>``; the log lines and the memory walk only happen when
    ``level`` clears the active log threshold."""
    loud = erplog.enabled(level)
    t0 = time.perf_counter()
    if loud:
        erplog.log_message(level, True, "phase %s: start\n", name)
    try:
        with tracing.span(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        metrics.record_phase(name, dt)
        if loud:
            erplog.log_message(level, True, "phase %s: done in %.3f s\n", name, dt)
            device_memory_status(f"phase {name}", level)


def start_profiler(with_cuda: bool):
    """A started ``torch.profiler.profile`` over the CPU activity and, when
    ``with_cuda``, the CUDA activity (kernels and copies, CUPTI)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if with_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def stop_profiler(prof, with_cuda: bool) -> None:
    """Stop a profiler from :func:`start_profiler`, draining the card first
    so every queued kernel lands in the trace."""
    import torch

    if with_cuda:
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """``torch.profiler`` capture around a block, exported as a Chrome
    trace to ``<logdir>/trace.json``.

    ``logdir`` falls back to ``$ERP_PROFILE_DIR``; when neither is set this
    is a free no-op, so callers can wrap unconditionally.  Yields the
    profiler (None when off), whose ``key_averages()`` the caller may read
    after the block."""
    logdir = logdir or os.environ.get(PROFILE_DIR_ENV)
    if not logdir:
        yield None
        return
    import torch

    os.makedirs(logdir, exist_ok=True)
    with_cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    erplog.info("Capturing torch.profiler trace to %s\n", logdir)
    metrics.note_trace(logdir)
    prof = start_profiler(with_cuda)
    try:
        yield prof
    finally:
        # an exception mid-search must still write the trace — a
        # truncated trace of a crashing run is the one you most need
        stop_profiler(prof, with_cuda)
        path = os.path.join(logdir, TRACE_NAME)
        prof.export_chrome_trace(path)
        erplog.info("Profiler trace written to %s\n", path)


def annotate(name: str):
    """Named region in a profiler trace (``record_function``) and on the
    NVTX timeline, the way the reference's per-kernel debug lines name
    each launch in its logs."""
    import torch

    stack = contextlib.ExitStack()
    stack.enter_context(torch.profiler.record_function(name))
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.nvtx.range_push(name)
        stack.callback(torch.cuda.nvtx.range_pop)
    return stack
