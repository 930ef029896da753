"""BOINC-facing adapter: progress, checkpoint cadence, status polling.

The reference talks to the BOINC client through the BOINC API
(``boinc_fraction_done``, ``boinc_time_to_checkpoint``,
``boinc_checkpoint_completed``, ``boinc_get_status`` —
``demod_binary.c:1418-1441``) and through a 1 KiB shared-memory XML segment
for the screensaver (``erp_boinc_ipc.cpp``). This adapter reproduces that
surface for the worker:

* standalone mode (default): fraction-done goes to the log and an optional
  status file; checkpoint cadence is time-based (BOINC's default
  ``checkpoint_cpu_period`` is 60 s); quit requests come from signals.
* wrapped mode: the native C++ wrapper (``native/erp_wrapper``) supervises
  the worker, passes file descriptors/paths for status, and forwards BOINC
  client control. The file protocol is: worker appends
  ``fraction_done <f>\\n`` lines to the status path and polls the control
  path for ``quit``/``abort`` tokens.
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass, field

from . import logging as erplog
from .errors import RADPUL_EVAL
from .shmem import ShmemWriter


def _default_checkpoint_period() -> float:
    """BOINC's default ``checkpoint_cpu_period`` (60 s), overridable via
    ``ERP_CHECKPOINT_PERIOD`` for harnesses that need every batch
    checkpointed (0 = always due)."""
    try:
        return float(os.environ.get("ERP_CHECKPOINT_PERIOD", 60.0))
    except (TypeError, ValueError):
        return 60.0


def _default_progress_min_delta() -> float:
    """Minimum fraction-done movement before the status file / log is
    rewritten (``ERP_PROGRESS_MIN_DELTA``, default 0.001 = 0.1%).  A
    fast chip on a small batch size calls ``fraction_done`` hundreds of
    times per percent; the wrapper polls at 5 Hz and the BOINC client
    displays two decimals, so sub-0.1% rewrites are pure churn."""
    try:
        return max(
            0.0, float(os.environ.get("ERP_PROGRESS_MIN_DELTA", 0.001))
        )
    except (TypeError, ValueError):
        return 0.001


@dataclass
class BoincAdapter:
    status_path: str | None = None  # wrapper-provided fraction_done sink
    control_path: str | None = None  # wrapper-provided quit/abort source
    checkpoint_period_s: float = field(
        default_factory=_default_checkpoint_period
    )
    communication_reduction: int = 1  # report every N templates
    # (Debian builds use -DCOMMUNICATIONREDUCTION=250, debian/rules:162)
    progress_min_delta: float = field(
        default_factory=_default_progress_min_delta
    )
    shmem: ShmemWriter | None = None

    _last_checkpoint: float = field(default_factory=time.monotonic)
    # ppid at construction: orphan detection must trigger on a CHANGE to
    # ppid 1 (the supervising wrapper died), not on having been launched
    # detached in the first place (daemonized test runners start at ppid 1)
    _initial_ppid: int = field(default_factory=os.getppid)
    _quit_requested: bool = False
    _sigterm_count: int = 0
    _report_counter: int = 0
    _last_reported_fraction: float = -1.0
    _suspended_now: bool = field(default=False, repr=False)
    _last_search_info: dict = field(default_factory=dict, repr=False)
    _last_info_write: float = field(default=0.0, repr=False)

    def install_signal_handlers(self) -> dict:
        """First SIGTERM/SIGINT flags a graceful quit (finish the batch,
        checkpoint, exit); a SECOND one means the sender is out of
        patience — force an immediate ``os._exit(RADPUL_EVAL)`` rather
        than waiting for a drain that may never finish (the wrapper
        escalates the same way, ``erp_boinc_wrapper.cpp:143-152``).
        Returns the handlers it replaced, for :func:`restore_signal_handlers`."""

        def handler(signum, frame):
            self._sigterm_count += 1
            self._quit_requested = True
            if self._sigterm_count >= 2:
                # no atexit, no GC — just go, with an error code so the
                # client records a failed task instead of a clean exit
                erplog.error("Caught signal %d again; forcing immediate exit.\n", signum)
                os._exit(RADPUL_EVAL)
            erplog.warn("Caught signal %d (%d); finishing batch then exiting.\n",
                        signum, self._sigterm_count)
            # black-box snapshot on the first signal (runtime/flightrec.py):
            # a client that escalates to SIGKILL leaves it as the only
            # record; a plain JSON write, no device sync
            from . import flightrec

            flightrec.dump(f"signal-{signum}")

        return {sig: signal.signal(sig, handler) for sig in (signal.SIGTERM, signal.SIGINT)}

    def fraction_done(self, fraction: float) -> None:
        self._report_counter += 1
        if self._report_counter % max(1, self.communication_reduction):
            return
        # delta throttle on top of the counter gate: even at reduction 1
        # the status file / log only move when progress moved enough to
        # matter (ERP_PROGRESS_MIN_DELTA), or at the terminal report
        delta = fraction - self._last_reported_fraction
        if delta < self.progress_min_delta and fraction < 1.0:
            return
        self._last_reported_fraction = fraction
        if self.status_path:
            with open(self.status_path, "a") as f:
                f.write(f"fraction_done {fraction:.6f}\n")
        erplog.debug("fraction done: %.4f\n", fraction)
        # progress lands in the metrics heartbeat and the flightrec ring,
        # so a run report or a black-box dump shows how far the run got
        from . import flightrec, metrics

        metrics.gauge("boinc.fraction_done").set(round(fraction, 6))
        flightrec.record("progress", fraction=round(fraction, 6))

    def time_to_checkpoint(self) -> bool:
        return time.monotonic() - self._last_checkpoint >= self.checkpoint_period_s

    def checkpoint_completed(self) -> None:
        self._last_checkpoint = time.monotonic()

    def _control_tokens(self) -> list[str]:
        if not (self.control_path and os.path.exists(self.control_path)):
            return []
        try:
            return open(self.control_path).read().split()
        except OSError:
            return []

    def quit_requested(self) -> bool:
        if self._quit_requested:
            return True
        # wrapper mode: a SIGKILLed wrapper cannot forward anything, and an
        # orphaned worker would otherwise compute the whole WU alongside
        # the client's replacement instance (wasted volunteer compute;
        # checkpoint writes stay atomic but interleave).  Detect the ppid
        # CHANGE to init and exit gracefully at the next batch boundary —
        # same reparenting rule as wait_while_suspended.
        if (
            self.control_path
            and self._initial_ppid != 1
            and os.getppid() == 1
        ):
            erplog.warn("Supervising wrapper died; checkpointing and exiting.\n")
            self._quit_requested = True
            return True
        tokens = self._control_tokens()
        if "quit" in tokens or "abort" in tokens:
            self._quit_requested = True
        return self._quit_requested

    def suspended(self) -> bool:
        """Client-requested suspension, the
        ``boinc_get_status().suspended`` stand-in
        (``demod_binary.c:1436-1441``): the wrapper rewrites the control
        file with ``suspend``/``resume`` tokens; the last one wins."""
        state = False
        for tok in self._control_tokens():
            if tok == "suspend":
                state = True
            elif tok in ("resume", "quit", "abort"):
                state = False
        return state

    def wait_while_suspended(self, poll_s: float = 0.5) -> None:
        """Park between batches while suspended. Device state stays
        resident; the loop still honours quit requests (a volunteer
        pausing BOINC must idle the card, not keep it at full tilt)."""
        self._suspended_now = False
        parked = False
        while self.suspended() and not self.quit_requested():
            if (
                os.getppid() == 1
                and self._initial_ppid != 1
                and self.control_path
            ):
                # the supervising wrapper died without unparking us (hard
                # kill); nobody will ever rewrite the control file — treat
                # as quit rather than polling a dead file forever
                erplog.warn("Wrapper died while suspended; exiting.\n")
                self._quit_requested = True
                break
            if not parked:
                erplog.info("Suspended by client; parking between batches.\n")
                parked = True
                self._suspended_now = True
                if self.shmem is not None:
                    self.update_shmem(self._last_search_info)
            time.sleep(poll_s)
        if parked:
            self._suspended_now = False
            erplog.info("Resuming computation.\n")

    def search_info_due(self) -> bool:
        """Something downstream consumes screensaver data AND an update is
        worth producing now: a shmem segment owned by this process (the
        reference updates per template, we per batch), or the wrapper via
        the status file — throttled to ~1/s, since building the payload
        costs a device sync + spectrum transfer and the wrapper polls at
        5 Hz anyway."""
        if self.shmem is not None:
            return True
        if self.status_path is None:
            return False
        return time.monotonic() - self._last_info_write >= 1.0

    def update_shmem(self, search_info: dict) -> None:
        self._last_search_info = dict(search_info)
        if self.shmem is None and self.status_path:
            # wrapped mode: the wrapper owns the shmem segment — stream the
            # search info over the status file (erp_wrapper.cpp parses new
            # lines each poll), so the screensaver still sees live sky
            # position, orbital params and the 40-bin spectrum
            self._last_info_write = time.monotonic()
            try:
                with open(self.status_path, "a") as f:
                    if "skypos_rac" in search_info:
                        f.write(
                            "skypos %.9f %.9f %.3f\n"
                            % (
                                search_info.get("skypos_rac", 0.0),
                                search_info.get("skypos_dec", 0.0),
                                search_info.get("dispersion_measure", 0.0),
                            )
                        )
                    if "orbital_period" in search_info:
                        f.write(
                            "orbital %.6f %.6f %.6f\n"
                            % (
                                search_info.get("orbital_radius", 0.0),
                                search_info.get("orbital_period", 0.0),
                                search_info.get("orbital_phase", 0.0),
                            )
                        )
                    spectrum = search_info.get("power_spectrum")
                    if spectrum is not None:
                        f.write("spectrum %s\n" % spectrum[:40].hex())
            except OSError:
                pass  # observability is best-effort, never fail the search
            return
        if self.shmem is None:
            return
        info = dict(search_info)
        # live process stats, like boinc_worker_thread_cpu_time() and the
        # client-reported working set (erp_boinc_ipc.cpp:118-160): CPU time
        # of this process and VmRSS/VmHWM from the kernel
        info.setdefault("cpu_time", time.process_time())
        status = dict(info.get("boinc_status", {}))
        rss, hwm = _working_set_bytes()
        status.setdefault("working_set_size", rss)
        status.setdefault("max_working_set_size", hwm)
        status.setdefault("quit_request", int(self._quit_requested))
        status.setdefault("suspended", int(self._suspended_now))
        info["boinc_status"] = status
        self.shmem.update(info)


def _working_set_bytes() -> tuple[int, int]:
    """(VmRSS, VmHWM) in bytes from /proc/self/status; zeros when
    unavailable (non-Linux)."""
    rss = hwm = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                elif line.startswith("VmHWM:"):
                    hwm = int(line.split()[1]) * 1024
    except OSError:
        pass
    return rss, hwm


def restore_signal_handlers(previous: dict) -> None:
    """Put back the handlers :meth:`BoincAdapter.install_signal_handlers`
    replaced."""
    for sig, h in previous.items():
        signal.signal(sig, h)
