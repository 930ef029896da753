"""Inputs the tools make for themselves, from a seed.

Two workunit classes:

* the fixture class of the soaks: 4096 4-bit samples at 500 us with a
  pulse train on a binary orbit (P 2.2 s, tau 0.04 s, psi 1.2), the
  four-template bank around that orbit, window 200, batch 2 — the JAX
  package's ``tests/fixtures.py``, copied so the port imports nothing of
  that package;
* the production class: 2^22 samples at 65.476 us (searched with
  padding 3, f0 400 Hz, ``-A 0.08`` and window 1000 over a bank such as
  ``tests/golden/bank200.txt``), with a pulse train on one bank row's
  orbit — what the card runs at full width.  ``chip_smoke.py``'s
  whitened search and the committed golden ``tests/golden/jax_synth200.*``
  read one definition of its workunit: bank200 row :data:`INJECT` from
  :data:`SEED`, zapped with :data:`ZAPLIST`.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import sys

import numpy as np

from ..io import TemplateBank, write_template_bank, write_workunit

# pinned header date: result files from different runs compare by byte
RESULT_DATE = "2008-11-12T00:00:00+00:00"

N_SAMPLES = 4096
TSAMPLE_US = 500.0
WINDOW = 200
BATCH = 2
# padded observation time of a fixture workunit (4096 is a power of two):
# the validator rebuilds frequency bins from it
T_OBS = N_SAMPLES * TSAMPLE_US * 1e-6

PRODUCTION_SAMPLES = 1 << 22
PRODUCTION_TSAMPLE_US = 65.476
INJECT = 57  # bank200 row whose orbit the production workunit's signal follows
SEED = 20261016
# the zaplist of the whitened production search: two lines, Hz
ZAPLIST = "60.0 60.5\n180.0 180.2\n"


# the fixture class's injected orbit: P (s), tau (s), psi0
ORBIT = (2.2, 0.04, 1.2)


def pulsed_series(n: int, tsample_us: float, orbit, f_signal: float, amp: float, seed: int) -> np.ndarray:
    """``n`` 4-bit samples: N(4, 1) noise from ``seed`` plus a pulse train
    of ``amp`` at ``f_signal`` Hz whose arrival times follow ``orbit``
    (P, tau, psi0); the JAX package's ``tests/fixtures.py::
    synthetic_timeseries``."""
    P, tau, psi0 = orbit
    rng = np.random.default_rng(seed)
    dt = tsample_us * 1e-6
    i = np.arange(n, dtype=np.float64)
    t = i * dt
    # detector sample i sees pulsar time f^-1(i), f(j) = j - del_t[j]
    del_t = (tau * np.sin(2 * np.pi / P * t + psi0) - tau * np.sin(psi0)) / dt
    t_pulsar = np.interp(i, i - del_t, i) * dt
    pulse = amp * (np.cos(2 * np.pi * f_signal * t_pulsar) > 0.95)
    return np.clip(np.round(pulse + rng.normal(4.0, 1.0, size=n)), 0, 15).astype(np.float32)


def small_bank() -> TemplateBank:
    """The null template and three orbits bracketing the fixture orbit."""
    P, tau, psi = ORBIT
    return TemplateBank(
        np.asarray([1000.0, P, P * 1.07, 1.7]),
        np.asarray([0.0, tau, tau * 0.8, 0.08]),
        np.asarray([0.0, psi, psi + 0.4, 2.5]),
    )


def fixture_workunit(path: str, *, f_signal: float, amp: float = 7.0, seed: int = 0) -> str:
    """A fixture-class workunit with its pulse train at ``f_signal`` Hz."""
    ts = pulsed_series(N_SAMPLES, TSAMPLE_US, ORBIT, f_signal, amp, seed)
    write_workunit(path, ts, tsample_us=TSAMPLE_US, scale=1.0, dm=55.5)
    return path


def fixture_bank(path: str) -> str:
    write_template_bank(path, small_bank())
    return path


def production_workunit(
    path: str, bank: TemplateBank, inject: int, seed: int, n_samples: int = PRODUCTION_SAMPLES
) -> tuple[float, float]:
    """A production-class workunit: a pulse train of 0.4 at 123.4567 Hz on
    bank row ``inject``'s orbit, made from ``seed``.  Returns that
    template's (P, tau) as the candidate file prints them (float32)."""
    orbit = (bank.P[inject], bank.tau[inject], bank.psi0[inject])
    ts = pulsed_series(n_samples, PRODUCTION_TSAMPLE_US, orbit, 123.4567, 0.4, seed)
    write_workunit(path, ts, tsample_us=PRODUCTION_TSAMPLE_US, scale=1.0)
    return float(np.float32(orbit[0])), float(np.float32(orbit[1]))


def content_sha256(path: str) -> str:
    """sha256 of a search input's content: a workunit's decompressed header
    and samples (the gzip member's mtime differs between two writes of the
    same samples), any other file's bytes."""
    opener = gzip.open if path.endswith((".bin4", ".binary")) else open
    h = hashlib.sha256()
    with opener(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def require_device(device: str) -> str:
    """``device`` unchanged once it is usable here: ``"cuda"`` without a
    card raises (a tool never moves to the CPU by itself)."""
    from ..device import resolve_device

    resolve_device(device)
    return device


def cli_cmd(wu: str, bank: str, out: str, cp: str | None, *extra: str) -> list[str]:
    """The port's command line as a subprocess argv."""
    cmd = [sys.executable, "-m", "boinc_app_eah_brp_tpu_torch", "-i", wu, "-o", out, "-t", bank]
    if cp:
        cmd += ["-c", cp]
    return cmd + list(extra)


def child_env(**values: str) -> dict:
    """This process's environment for a child run, with the repository
    on ``PYTHONPATH``, the result date pinned and ``values`` set."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["ERP_RESULT_DATE"] = RESULT_DATE
    env.update(values)
    return env
