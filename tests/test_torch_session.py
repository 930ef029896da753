"""PyTorch port, the driver's default path on the CPU against the JAX
driver: unwhitened runs with a checkpoint file and oracle rescoring,
whitened runs with rescoring, and interrupted runs resumed by either
package.

Tolerances:
* unwhitened runs: candidate rows equal.  Both pad with the reference's
  serial float32 mean (the port's ``exact_mean_params`` plain version, the
  JAX package's host pass), and the rescored powers come from the same numpy
  oracle on the same raw samples.  The fixture bank has no contraction tie
  at this length (``torch_parity``), where XLA on the CPU would gather
  another sample;
* whitened runs: the two packages whiten through different FFT
  libraries, so rows agree within the validator's tolerance
  (``io/validate.py::compare_candidate_rows``);
* resumed runs: rows equal to the uninterrupted run's.
"""

import os

import numpy as np
import pytest

from boinc_app_eah_brp_tpu.io import parse_result_file as jax_parse
from boinc_app_eah_brp_tpu.io.validate import compare_candidate_rows
from boinc_app_eah_brp_tpu.runtime.boinc import BoincAdapter as JaxAdapter
from boinc_app_eah_brp_tpu.runtime.driver import DriverArgs as JaxArgs
from boinc_app_eah_brp_tpu.runtime.driver import run_search as jax_run_search
from boinc_app_eah_brp_tpu_torch.io import parse_result_file, write_template_bank, write_workunit
from boinc_app_eah_brp_tpu_torch.io.checkpoint import read_checkpoint
from boinc_app_eah_brp_tpu_torch.models.search import bank_params_host, normalize_psi0
from boinc_app_eah_brp_tpu_torch.runtime.boinc import BoincAdapter
from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs, run_search
from fixtures import small_bank, synthetic_timeseries
from torch_parity import DT, contraction_ties

N = 4096
BATCH = 2


@pytest.fixture
def workdir(tmp_path):
    ts = synthetic_timeseries(N, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    paths = {k: str(tmp_path / v) for k, v in dict(wu="test.bin4", bank="bank.dat", zap="zap.txt").items()}
    write_workunit(paths["wu"], ts, tsample_us=DT * 1e6, scale=1.0, dm=55.5)
    bank = small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2)
    write_template_bank(paths["bank"], bank)
    with open(paths["zap"], "w") as f:
        f.write("50.0 51.0\n120.0 121.5\n")
    paths["tmp"] = tmp_path
    paths["bank_rows"] = bank
    return paths


def _common(workdir, white=False):
    common = dict(inputfile=workdir["wu"], templatebank=workdir["bank"], window=200, batch_size=BATCH, white=white)
    if white:
        common["zaplistfile"] = workdir["zap"]
    return common


def _run(pkg, workdir, name, adapter=None, white=False):
    """One run of ``pkg`` ("port" or "jax") with checkpoint file
    ``<name>.cpt`` and result ``<name>.cand``, rescoring on (the default);
    returns the exit code."""
    files = dict(
        outputfile=str(workdir["tmp"] / f"{name}.cand"),
        checkpointfile=str(workdir["tmp"] / f"{name}.cpt"),
    )
    if pkg == "port":
        return run_search(DriverArgs(device="cpu", **files, **_common(workdir, white)), adapter)
    return jax_run_search(JaxArgs(mesh_devices=1, **files, **_common(workdir, white)), adapter)


def _rows(workdir, name):
    parsed = parse_result_file(str(workdir["tmp"] / f"{name}.cand"))
    assert parsed.done and len(parsed.lines) > 0
    return parsed.lines


def test_fixture_bank_has_no_contraction_tie(workdir):
    b = workdir["bank_rows"]
    params = bank_params_host(b.P, b.tau, normalize_psi0(b.psi0), DT)
    assert not contraction_ties(params, N).any()


def test_unwhitened_run_matches_jax_driver(workdir):
    assert _run("port", workdir, "port") == 0
    assert _run("jax", workdir, "jax") == 0
    got, want = _rows(workdir, "port"), jax_parse(str(workdir["tmp"] / "jax.cand")).lines
    assert abs(got[0][1] - 2.2) < 1e-4 and abs(got[0][2] - 0.04) < 1e-4
    np.testing.assert_array_equal(got, want)
    cp = read_checkpoint(str(workdir["tmp"] / "port.cpt"))
    assert cp.n_template == len(workdir["bank_rows"])
    assert cp.originalfile == workdir["wu"]


def test_whitened_run_with_rescore_matches_jax_driver(workdir):
    assert _run("port", workdir, "port", white=True) == 0
    assert _run("jax", workdir, "jax", white=True) == 0
    got, want = _rows(workdir, "port"), jax_parse(str(workdir["tmp"] / "jax.cand")).lines
    diff = compare_candidate_rows(got, want, t_obs=N * DT)
    assert diff.ok, diff.report()


def _quit_after_one(base):
    class QuitAfterOne(base):
        """Checkpoint every batch, quit after the first."""

        def __init__(self):
            super().__init__(checkpoint_period_s=0.0)

        def quit_requested(self):
            return True

    return QuitAfterOne()


@pytest.mark.parametrize("first,second", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_interrupted_run_resumes_across_packages(workdir, first, second):
    assert _run("port", workdir, "whole") == 0
    want = _rows(workdir, "whole")

    base = BoincAdapter if first == "port" else JaxAdapter
    assert _run(first, workdir, "split", adapter=_quit_after_one(base)) == 0
    assert not os.path.exists(workdir["tmp"] / "split.cand")
    assert read_checkpoint(str(workdir["tmp"] / "split.cpt")).n_template == BATCH

    assert _run(second, workdir, "split") == 0
    np.testing.assert_array_equal(_rows(workdir, "split"), want)
    assert read_checkpoint(str(workdir["tmp"] / "split.cpt")).n_template == len(workdir["bank_rows"])


def _bank_260(workdir, n=260):
    """The fixture's injected orbit and a DC template among 258 seeded
    ones: 17 batches of 16, past the JAX package's 256-template floor for
    its background rescorer."""
    from boinc_app_eah_brp_tpu_torch.io import TemplateBank

    rng = np.random.default_rng(3)
    P = np.concatenate([[1000.0, 2.2], rng.uniform(1.6, 3.0, n - 2)])
    tau = np.concatenate([[0.0, 0.04], rng.uniform(0.0, 0.09, n - 2)])
    psi = np.concatenate([[0.0, 1.2], rng.uniform(0.0, 2 * np.pi, n - 2)])
    write_template_bank(workdir["bank"], TemplateBank(P, tau, psi))


def _body(path) -> bytes:
    """A result file's bytes less its ``% Date:`` line."""
    with open(path, "rb") as f:
        return b"".join(ln for ln in f if not ln.startswith(b"% Date:"))


def test_rescore_overlap_gives_the_same_rows(workdir, monkeypatch):
    """260 templates at batch 16, a checkpoint every batch: the port's
    rows equal the JAX driver's with its background rescorer armed (four
    cores), and its file is byte for byte, but for the date, a run
    without a checkpoint file."""
    import boinc_app_eah_brp_tpu.oracle.rescore as jax_rescore

    _bank_260(workdir)
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    observes = []
    real_observe = jax_rescore.IncrementalRescorer.observe
    monkeypatch.setattr(
        jax_rescore.IncrementalRescorer, "observe", lambda self, c: (observes.append(1), real_observe(self, c))
    )
    common = dict(_common(workdir), batch_size=16)

    def files(name, checkpoint=True):
        out = {"outputfile": str(workdir["tmp"] / f"{name}.cand")}
        if checkpoint:
            out["checkpointfile"] = str(workdir["tmp"] / f"{name}.cpt")
        return out

    assert run_search(DriverArgs(device="cpu", **files("port"), **common), BoincAdapter(checkpoint_period_s=0.0)) == 0
    assert jax_run_search(JaxArgs(mesh_devices=1, **files("jax"), **common), JaxAdapter(checkpoint_period_s=0.0)) == 0
    assert len(observes) == 18  # the JAX rescorer armed: 17 batches and the final checkpoint
    assert run_search(DriverArgs(device="cpu", **files("nocp", checkpoint=False), **common),
                      BoincAdapter(checkpoint_period_s=0.0)) == 0
    got = _rows(workdir, "port")
    np.testing.assert_array_equal(got, jax_parse(str(workdir["tmp"] / "jax.cand")).lines)
    assert _body(workdir["tmp"] / "port.cand") == _body(workdir["tmp"] / "nocp.cand")


@pytest.mark.parametrize("every_batch", [True, False], ids=["checkpoint_every_batch", "checkpoint_at_quit"])
def test_a_260_template_run_quit_after_its_first_checkpoint_resumes_to_the_whole_rows(workdir, every_batch):
    """260 templates at batch 16, quit after the first batch, with a
    checkpoint every batch or only the one the quit writes: the run
    checkpoints 16 templates and writes no result, and the resumed run's
    file is the uninterrupted run's, but for the date."""
    _bank_260(workdir)
    common = dict(_common(workdir), batch_size=16)
    period = 0.0 if every_batch else 3600.0

    class QuitAfterOne(BoincAdapter):
        def __init__(self):
            super().__init__(checkpoint_period_s=period)

        def quit_requested(self):
            return True

    def run(name, adapter):
        args = DriverArgs(device="cpu", outputfile=str(workdir["tmp"] / f"{name}.cand"),
                          checkpointfile=str(workdir["tmp"] / f"{name}.cpt"), **common)
        return run_search(args, adapter)

    assert run("whole", BoincAdapter(checkpoint_period_s=period)) == 0
    assert run("split", QuitAfterOne()) == 0
    assert not os.path.exists(workdir["tmp"] / "split.cand")
    assert read_checkpoint(str(workdir["tmp"] / "split.cpt")).n_template == 16
    assert run("split", BoincAdapter(checkpoint_period_s=period)) == 0
    assert read_checkpoint(str(workdir["tmp"] / "split.cpt")).n_template == 260
    assert _body(workdir["tmp"] / "split.cand") == _body(workdir["tmp"] / "whole.cand")
