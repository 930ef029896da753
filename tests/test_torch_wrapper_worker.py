"""Native wrapper driving the port's worker end to end on the CPU.

The twin of ``test_wrapper_worker_integration.py`` with the port's worker
(``--worker "python -m boinc_app_eah_brp_tpu_torch --device cpu"``: the
wrapper forwards only the science flags it knows, and ``--device`` is not
one of them, so it goes into the worker command, which the wrapper splits
on spaces).  It keeps every assertion of the JAX test: the candidate file
ends with ``%DONE%`` and has 7 columns a line, the checkpoint is removed
after the completed pass, the shmem reaches fraction_done 1 with a real
orbit, the stderr archive holds both streams, no protocol file is left.

Tolerance against the JAX worker on the same fixture: the two packages
whiten through different FFT libraries, so the rows agree within the
validator's tolerance (``io/validate.py::compare_candidate_rows``), as in
``test_torch_session.py``.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest

from boinc_app_eah_brp_tpu.io import parse_result_file as jax_parse
from boinc_app_eah_brp_tpu.io.templates import write_template_bank
from boinc_app_eah_brp_tpu.io.validate import compare_candidate_rows
from boinc_app_eah_brp_tpu.io.workunit import write_workunit
from boinc_app_eah_brp_tpu.runtime.driver import DriverArgs as JaxArgs
from boinc_app_eah_brp_tpu.runtime.driver import run_search as jax_run_search
from boinc_app_eah_brp_tpu_torch.io import parse_result_file
from fixtures import small_bank, synthetic_timeseries

REPO = pathlib.Path(__file__).resolve().parent.parent
NATIVE_DIR = REPO / "native"
N, TSAMPLE_US = 4096, 500.0
WORKER = f"{sys.executable} -m boinc_app_eah_brp_tpu_torch --device cpu"


@pytest.fixture(scope="module")
def wrapper(tmp_path_factory):
    """The wrapper built into a directory of this module's own (the
    Makefile's ``BUILD``), so no other test's build races it."""
    build = tmp_path_factory.mktemp("native")
    r = subprocess.run(["make", f"BUILD={build}"], cwd=NATIVE_DIR, capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-2000:]
    return str(build / "erp_wrapper")


@pytest.fixture
def fixture_dir(tmp_path):
    ts = synthetic_timeseries(N, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    write_workunit(str(tmp_path / "wu.bin4"), ts, tsample_us=TSAMPLE_US, scale=1.0)
    write_template_bank(str(tmp_path / "bank.txt"), small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2))
    (tmp_path / "zap.txt").write_text("900.0 910.0\n")
    return tmp_path


def test_wrapper_runs_the_ports_worker_end_to_end(wrapper, fixture_dir):
    tmp_path = fixture_dir
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [
            wrapper, "--worker", WORKER,
            "-i", "wu.bin4", "-o", "out.cand", "-c", "cp.cpt",
            "-t", "bank.txt", "-l", "zap.txt",
            "-A", "0.08", "-P", "3.0", "-f", "400.0", "-W",
            "--batch", "2",
            "--shmem", str(tmp_path / "shm"),
            "--stderr-file", "stderr.txt",
        ],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, (r.stderr, (tmp_path / "stderr.txt").read_text())

    out = (tmp_path / "out.cand").read_text()
    assert out.rstrip().endswith("%DONE%")
    payload = [line for line in out.splitlines() if line.strip() and not line.startswith("%")]
    assert payload and all(len(line.split()) == 7 for line in payload)

    # checkpoint removed after the completed pass (reference lifecycle)
    assert not (tmp_path / "cp.cpt").exists()

    # shmem: fraction done reached 1, a real (nonzero-tau) orbit appeared
    shm = (tmp_path / "shm").read_bytes().rstrip(b"\x00").decode()
    assert "<graphics_info>" in shm
    frac = float(re.search(r"<fraction_done>([\d.]+)", shm).group(1))
    assert frac == pytest.approx(1.0, abs=1e-6)
    assert float(re.search(r"<orb_period>([\d.]+)", shm).group(1)) > 0.0

    # the stderr archive captured both wrapper and worker streams
    captured = (tmp_path / "stderr.txt").read_text()
    assert "erp_wrapper" in captured
    assert "Data processing finished successfully" in captured

    # no protocol files left behind
    assert not list(tmp_path.glob("erp_status.*"))
    assert not list(tmp_path.glob("erp_control.*"))

    # the JAX worker's rows on the same fixture, within the validator's tolerance
    jax_args = JaxArgs(
        inputfile=str(tmp_path / "wu.bin4"), outputfile=str(tmp_path / "jax.cand"),
        templatebank=str(tmp_path / "bank.txt"), zaplistfile=str(tmp_path / "zap.txt"),
        fA=0.08, padding=3.0, f0=400.0, white=True, batch_size=2, mesh_devices=1,
    )
    assert jax_run_search(jax_args) == 0
    got = parse_result_file(str(tmp_path / "out.cand")).lines
    want = jax_parse(str(tmp_path / "jax.cand")).lines
    diff = compare_candidate_rows(got, want, t_obs=3 * N * TSAMPLE_US * 1e-6)
    assert diff.ok, diff.report()
