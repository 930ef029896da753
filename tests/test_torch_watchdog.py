"""PyTorch port, the hang doctor and supervised restarts against the JAX
package's.

* ``runnable_segments``, the deadline spec and the ``erp-incident-log/1``
  sidecar agree with the JAX package's, and each package reads the
  other's incident log (so each honours the other's quarantine);
* a quarantine the JAX package wrote gives the same candidate rows and
  the same ``% Quarantined templates`` header in both drivers;
* the port's escalation ladder on a breached guard: incident, abort flag,
  then the temporary-exit code;
* one ``--supervised 2`` run of the port with ``dispatch:hang@n=3``: the
  watchdog hard-exits the wedged worker (rc 99), the supervisor restarts
  it once, it resumes from its checkpoint and writes the uninterrupted
  run's rows; its incident log validates in both packages.

Tolerance: exact (unwhitened rows of both packages pad with the same
serial float32 mean, ``test_torch_session.py``).
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from boinc_app_eah_brp_tpu.io import parse_result_file as jax_parse
from boinc_app_eah_brp_tpu.runtime import watchdog as jwd
from boinc_app_eah_brp_tpu.runtime.driver import DriverArgs as JaxArgs
from boinc_app_eah_brp_tpu.runtime.driver import run_search as jax_run_search
from boinc_app_eah_brp_tpu_torch.io import parse_result_file, write_template_bank, write_workunit
from boinc_app_eah_brp_tpu_torch.runtime import watchdog as pwd
from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs, run_search
from fixtures import small_bank, synthetic_timeseries
from torch_parity import DT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for k in ("ERP_WATCHDOG_SPEC", "ERP_WATCHDOG_GRACE_S", "ERP_INCIDENT_LOG", "ERP_QUARANTINE_K", "ERP_FAULT_SPEC"):
        monkeypatch.delenv(k, raising=False)
    yield
    pwd.disarm()
    jwd.disarm()


@pytest.mark.parametrize(
    "n,quarantined,start",
    [
        (10, [], 0),
        (10, [(2, 4)], 0),
        (10, [(0, 3), (5, 6), (9, 12)], 0),
        (10, [(2, 4), (3, 7)], 5),
        (10, [(0, 10)], 0),
        (200, [(32, 64), (100, 101)], 40),
    ],
)
def test_runnable_segments_match(n, quarantined, start):
    assert pwd.runnable_segments(n, quarantined, start=start) == jwd.runnable_segments(n, quarantined, start=start)


@pytest.mark.parametrize("spec", ["dispatch=2,lease_io=1.5", "*=5", "drain=0.5", "ckpt_write=3,*=7"])
def test_deadline_spec_matches(spec):
    assert pwd._parse_spec(spec) == jwd._parse_spec(spec)
    assert pwd.DEADLINES == jwd.DEADLINES


@pytest.mark.parametrize("spec", ["dispatch", "dispatch=0", "nowhere=3", "dispatch=x"])
def test_bad_deadline_spec_refused_by_both(spec):
    with pytest.raises(ValueError):
        pwd._parse_spec(spec)
    with pytest.raises(ValueError):
        jwd._parse_spec(spec)


@pytest.mark.parametrize("writer,reader", [(jwd, pwd), (pwd, jwd)])
def test_incident_log_read_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "cp.bin.incidents.json")
    log = writer.IncidentLog(path)
    for window in ([4, 8], [4, 8], [8, 12], [4, 8], None, [8, 12]):
        log.append(stage="dispatch", reason="watchdog:dispatch", window=window)
    other = reader.IncidentLog(path)
    assert other.window_counts() == log.window_counts() == {(4, 8): 3, (8, 12): 2}
    for k in (1, 2, 3, 4):
        assert other.quarantined(k) == log.quarantined(k)
    doc = other.read()
    assert reader.validate_incident_log(doc) == [] and writer.validate_incident_log(doc) == []
    assert pwd.default_incident_path("cp.bin") == jwd.default_incident_path("cp.bin") == "cp.bin.incidents.json"


@pytest.fixture
def workdir(tmp_path):
    ts = synthetic_timeseries(N, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    write_workunit(str(tmp_path / "wu.bin4"), ts, tsample_us=DT * 1e6, scale=1.0)
    write_template_bank(str(tmp_path / "bank.dat"), small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2))
    return tmp_path


def _args(workdir, name, batch=1):
    return dict(
        inputfile=str(workdir / "wu.bin4"), templatebank=str(workdir / "bank.dat"), window=200, batch_size=batch,
        outputfile=str(workdir / f"{name}.cand"), checkpointfile=str(workdir / f"{name}.cpt"),
    )


def test_jax_quarantine_same_rows_and_header_in_both_drivers(workdir):
    """Three incidents on the window [2, 3), written by the JAX package
    beside each run's checkpoint: both drivers skip template 2 and name
    the gap in the result header."""
    for name in ("port", "jax"):
        log = jwd.IncidentLog(jwd.default_incident_path(str(workdir / f"{name}.cpt")))
        for _ in range(3):
            log.append(stage="dispatch", reason="watchdog:dispatch", window=[2, 3])
    assert run_search(DriverArgs(device="cpu", **_args(workdir, "port"))) == 0
    assert jax_run_search(JaxArgs(mesh_devices=1, **_args(workdir, "jax"))) == 0
    got, want = parse_result_file(str(workdir / "port.cand")), jax_parse(str(workdir / "jax.cand"))
    np.testing.assert_array_equal(got.lines, want.lines)
    tag = "% Quarantined templates: [2, 3)"
    assert tag in got.header_lines and tag in want.header_lines


def test_escalation_ladder_on_a_breached_guard(tmp_path, monkeypatch):
    """A guard past its deadline: the incident is logged with the window
    in flight, the cooperative abort is raised, and after the grace the
    temporary-exit code goes to the exit function (a stub here)."""
    monkeypatch.setenv("ERP_WATCHDOG_SPEC", "dispatch=0.2")
    monkeypatch.setenv("ERP_WATCHDOG_GRACE_S", "0.3")
    monkeypatch.setenv("ERP_WATCHDOG_POLL_S", "0.05")
    exited = threading.Event()
    codes = []
    monkeypatch.setattr(pwd, "_exit_fn", lambda rc: (codes.append(rc), exited.set()))
    log = pwd.IncidentLog(str(tmp_path / "incidents.json"))
    assert pwd.arm(incident_log=log)
    with pwd.guard("dispatch", start=6, stop=8):
        deadline = time.monotonic() + 10.0
        while not exited.is_set() and time.monotonic() < deadline:
            time.sleep(0.05)
    pwd.disarm()
    assert codes[:1] == [pwd.RADPUL_TEMPORARY_EXIT]
    assert pwd.abort_requested()
    assert log.window_counts() == {(6, 8): 1}
    pwd.arm()  # a fresh run starts healthy
    assert not pwd.abort_requested()


def test_supervised_restart_after_a_dispatch_hang(workdir):
    """``--supervised 2`` with ``dispatch:hang@n=3``, a 3 s dispatch
    deadline and a checkpoint every batch: one restart, then the rows of
    an uninterrupted run."""
    assert run_search(DriverArgs(device="cpu", **_args(workdir, "whole"))) == 0
    env = dict(
        os.environ,
        PYTHONPATH=REPO,
        ERP_FAULT_SPEC="dispatch:hang@n=3",
        ERP_FAULT_STATE=str(workdir / "faults.json"),
        ERP_WATCHDOG_SPEC="dispatch=3",
        ERP_WATCHDOG_GRACE_S="1",
        ERP_CHECKPOINT_PERIOD="0",
        ERP_SUPERVISE_BACKOFF_S="0",
        ERP_LOGLEVEL="info",
    )
    a = _args(workdir, "sup")
    argv = (
        f"--supervised 2 -i {a['inputfile']} -o {a['outputfile']} -t {a['templatebank']} -c {a['checkpointfile']} "
        "-B 200 --batch 1 --device cpu"
    ).split()
    # a session of its own: on a timeout the supervisor's worker goes too
    proc = subprocess.Popen(
        [sys.executable, "-m", "boinc_app_eah_brp_tpu_torch", *argv], env=env, cwd=str(workdir),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True,
    )
    try:
        _, stderr = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, stderr[-3000:]
    assert "exited rc 99 (pass 1)" in stderr and "after 2 pass(es)" in stderr
    np.testing.assert_array_equal(
        parse_result_file(a["outputfile"]).lines, parse_result_file(str(workdir / "whole.cand")).lines
    )
    doc = pwd.IncidentLog(a["checkpointfile"] + ".incidents.json").read()
    assert pwd.validate_incident_log(doc) == [] and jwd.validate_incident_log(doc) == []
    assert [(i["stage"], i["window"]) for i in doc["incidents"]] == [("dispatch", [2, 3])]
