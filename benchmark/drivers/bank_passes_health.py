"""The search cell's whole-bank passes (``drivers/bank_passes.py``, run
as it is) with the program's numerical health watchdog on
(``runtime/health.py``): set-up sets ``ERP_HEALTH_EVERY`` to the
traffic's ``health_every`` and arms the program's metrics before the
search cell's set-up, so every ``run_bank`` of set-up and window pushes
each batch's health vector and the watchdog copies and checks them at
that cadence.  The window reads the program's ``health.checks`` counter
before and after the search cell's window; a window in which it did not
move is a failed run (else the cell would be the search cell measured
again).  The check is the search cell's."""

from __future__ import annotations

import os
import sys

from bmlib import harness

IN_PROCESS = True
BASE = harness.load_module("drivers", "bank_passes")
check = BASE.check


def _checks() -> int:
    from boinc_app_eah_brp_tpu_torch.runtime import metrics

    return int(getattr(metrics.counter("health.checks"), "value", 0))


def setup(run) -> dict:
    from boinc_app_eah_brp_tpu_torch.runtime import metrics

    os.environ["ERP_HEALTH_EVERY"] = str(int(run.traffic["health_every"]))
    metrics.configure(force=True)
    return BASE.setup(run)


def window(run, st) -> None:
    before = _checks()
    BASE.window(run, st)
    checks = _checks() - before
    print(f"bank_passes_health: health.checks {checks} in the window", file=sys.stderr)
    if checks <= 0:
        run.failed += 1
        print("bank_passes_health: the health watchdog checked nothing in the window", file=sys.stderr)
