"""Supervised-restart loop: the multi-pass semantics of the native
wrapper, in-process.

The reference deployment never trusts a single worker pass: the BOINC
wrapper re-launches the science app when it calls
``boinc_temporary_exit`` (erp_boinc_wrapper.cpp:560-570), and the search
resumes from its last committed checkpoint.  The watchdog
(runtime/watchdog.py) converts an indefinite stall into exactly that
exit — rc ``RADPUL_TEMPORARY_EXIT`` (99) — so something must sit above
the worker and turn the exit back into forward progress.  This module is
that something: re-exec the worker command while it keeps asking for a
retry, under a bounded restart budget so a crash-looping workunit fails
loudly instead of spinning forever (the per-WU error limit idea, client
side).

``python -m boinc_app_eah_brp_tpu_torch --supervised N -i ...`` — the
driver flag (``runtime/cli.py``) re-execs the port minus the flag.  A copy
of the JAX package's ``runtime/supervise.py``; only :func:`self_cmd`
differs.

Restart policy: rc 99 always restarts; signal deaths (rc < 0) restart
only with ``restart_on_crash`` — a SIGKILL may be the OOM killer, and
retrying OOM without backoff is how machines die.  Every restart waits
an exponentially growing backoff (``ERP_SUPERVISE_BACKOFF_S`` scales the
base) so a tight wedge-crash cycle cannot saturate the host.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

from . import logging as erplog
from .errors import RADPUL_TEMPORARY_EXIT

ENV_BACKOFF = "ERP_SUPERVISE_BACKOFF_S"
DEFAULT_MAX_RESTARTS = 5


def _backoff_base() -> float:
    try:
        return max(0.0, float(os.environ.get(ENV_BACKOFF, "1.0")))
    except ValueError:
        return 1.0


def should_restart(rc: int, *, restart_on_crash: bool = False) -> bool:
    """The restart predicate, separated for tests: temporary-exit always
    retries; signal deaths only when the caller opted in; any other rc
    (success or a mapped RADPUL_* failure) is final."""
    if rc == RADPUL_TEMPORARY_EXIT:
        return True
    if rc < 0 and restart_on_crash:
        return True
    return False


def run_supervised(
    cmd: list[str],
    *,
    max_restarts: int = DEFAULT_MAX_RESTARTS,
    restart_on_crash: bool = False,
    env: dict | None = None,
    sleep=time.sleep,
    runner=None,
) -> int:
    """Run ``cmd`` to completion, re-execing it while the restart
    predicate holds and the budget lasts.  Returns the final pass's exit
    code (the budget-exhausted case returns the last worker rc, which is
    nonzero by construction).

    ``sleep``/``runner`` are test seams: ``runner(cmd, env)`` -> rc
    replaces the subprocess launch."""
    passes = 0
    rc = 0
    base = _backoff_base()
    while True:
        passes += 1
        if runner is not None:
            rc = runner(cmd, env)
        else:
            rc = _run_pass(cmd, env)
        if not should_restart(rc, restart_on_crash=restart_on_crash):
            if passes > 1:
                erplog.info(
                    "Supervised worker finished with rc %d after %d "
                    "pass(es).\n", rc, passes,
                )
            return rc
        if passes > max_restarts:
            erplog.error(
                "Supervised worker still exiting rc %d after %d restarts "
                "— restart budget exhausted, giving up.\n",
                rc, max_restarts,
            )
            return rc
        delay = base * (2.0 ** (passes - 1)) if base > 0 else 0.0
        erplog.warn(
            "Supervised worker exited rc %d (pass %d); restarting in "
            "%.1f s (%d of %d restarts used).\n",
            rc, passes, delay, passes, max_restarts,
        )
        if delay > 0:
            sleep(delay)


def _run_pass(cmd: list[str], env: dict | None) -> int:
    """One worker pass as a subprocess, forwarding SIGTERM/SIGINT so a
    quit request reaches the worker (which checkpoints and exits 0 —
    the supervisor then stops, because 0 is final)."""
    proc = subprocess.Popen(cmd, env=env)

    forwarded: list[int] = []

    def forward(signum, frame):
        forwarded.append(signum)
        try:
            proc.send_signal(signum)
        except OSError:
            pass

    old = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old[sig] = signal.signal(sig, forward)
        except ValueError:
            # not the main thread (tests): run unforwarded
            pass
    try:
        return proc.wait()
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)


def self_cmd(argv: list[str]) -> list[str]:
    """The re-exec command for the driver's ``--supervised`` flag: this
    interpreter, this package, the given (already flag-stripped) args."""
    return [sys.executable, "-m", "boinc_app_eah_brp_tpu_torch", *argv]


def strip_supervised_flag(argv: list[str]) -> tuple[list[str], int | None]:
    """Remove ``--supervised [N]`` from ``argv``.  Returns the cleaned
    argv and the restart budget (None when the flag is absent; the
    default budget when the flag carries no numeric value)."""
    out: list[str] = []
    budget: int | None = None
    i = 0
    while i < len(argv):
        if argv[i] == "--supervised":
            budget = DEFAULT_MAX_RESTARTS
            if i + 1 < len(argv):
                try:
                    budget = int(argv[i + 1])
                except ValueError:
                    i += 1
                    continue
                i += 2
                continue
            i += 1
            continue
        out.append(argv[i])
        i += 1
    return out, budget
