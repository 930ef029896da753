"""PyTorch port, checkpoint files against the JAX package's: the same
bytes for the same candidates, each read by the other, generations and
the resume checks.  Exact: both write the reference's packed format."""

import json
import os

import numpy as np
import pytest

from boinc_app_eah_brp_tpu.io import checkpoint as jax_ckpt
from boinc_app_eah_brp_tpu_torch.io import checkpoint as port_ckpt
from boinc_app_eah_brp_tpu_torch.io.formats import CP_CAND_DTYPE, N_CAND

PKGS = {"port": port_ckpt, "jax": jax_ckpt}
AUDIT_KEYS = ("schema", "sha256", "n_bytes", "n_template", "originalfile", "bank", "seq", "topology")


def _candidates(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    c = np.zeros(N_CAND, dtype=CP_CAND_DTYPE)
    live = rng.random(N_CAND) < 0.8
    c["power"] = np.where(live, rng.exponential(30.0, N_CAND), 0.0)
    c["P_b"] = rng.uniform(1000.0, 30000.0, N_CAND)
    c["tau"] = rng.uniform(0.0, 3.0, N_CAND)
    c["Psi"] = rng.uniform(0.0, 2 * np.pi, N_CAND)
    c["fA"] = rng.uniform(0.0, 20.0, N_CAND)
    c["n_harm"] = np.where(live, 1 << rng.integers(0, 5, N_CAND), 0)
    c["f0"] = rng.integers(0, 300000, N_CAND)
    return c


def _write(pkg, path, n_template, seed, inputfile="wu.bin4", bank=("bank.dat", 200)):
    m = PKGS[pkg]
    cp = m.Checkpoint(n_template=n_template, originalfile=inputfile, candidates=_candidates(seed))
    m.write_checkpoint(str(path), cp, bank=bank, topology=m.topology_record(1))
    return cp


def test_same_bytes_and_audit_for_the_same_candidates(tmp_path):
    for pkg in PKGS:
        for n_template, seed in ((64, 1), (128, 2)):  # the second write bumps the counter
            _write(pkg, tmp_path / f"{pkg}.cpt", n_template, seed)
    port_bytes = open(tmp_path / "port.cpt", "rb").read()
    assert port_bytes == open(tmp_path / "jax.cpt", "rb").read()
    assert open(tmp_path / "port.cpt.1", "rb").read() == open(tmp_path / "jax.cpt.1", "rb").read()
    audits = [json.load(open(tmp_path / f"{pkg}.cpt.audit.json")) for pkg in PKGS]
    assert {k: audits[0].get(k) for k in AUDIT_KEYS} == {k: audits[1].get(k) for k in AUDIT_KEYS}
    assert audits[0]["seq"] == 1 and audits[0]["n_template"] == 128
    assert audits[0]["bank"] == {"path": "bank.dat", "n_templates": 200}


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_each_package_reads_the_others_checkpoint(tmp_path, writer, reader):
    path = tmp_path / "cp.cpt"
    cp = _write(writer, path, 96, 3)
    got = PKGS[reader].read_checkpoint(str(path))
    assert got.n_template == 96 and got.originalfile == "wu.bin4"
    assert got.candidates.tobytes() == cp.candidates.tobytes()
    used = PKGS[reader].load_resumable_checkpoint(str(path), 200, "wu.bin4", bank_path="bank.dat", process_count=1)
    assert used[1:] == (str(path), 0) and used[0].n_template == 96


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_generations_rotate_and_a_corrupt_newest_falls_back(tmp_path, writer):
    path = tmp_path / "cp.cpt"
    for n_template, seed in ((32, 4), (64, 5), (96, 6)):
        _write(writer, path, n_template, seed)
    assert port_ckpt.read_checkpoint(str(path) + ".1").n_template == 64
    assert not os.path.exists(str(path) + ".2")  # two generations by default
    raw = bytearray(open(path, "rb").read())
    raw[300] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    cp, used, gen = port_ckpt.load_resumable_checkpoint(str(path), 200, "wu.bin4", bank_path="bank.dat")
    assert (gen, used, cp.n_template) == (1, str(path) + ".1", 64)
    # a corrupt live checkpoint is not rotated over its good backup
    _write("port", path, 128, 7)
    assert port_ckpt.read_checkpoint(str(path) + ".1").n_template == 64


@pytest.mark.parametrize(
    "inputfile,total,bank_path",
    [("other.bin4", 200, "bank.dat"), ("wu.bin4", 150, "bank.dat"), ("wu.bin4", 200, "other.dat")],
)
def test_resume_refuses_another_input_or_bank(tmp_path, inputfile, total, bank_path):
    path = tmp_path / "cp.cpt"
    _write("jax", path, 96, 8)
    with pytest.raises(port_ckpt.CheckpointError):
        port_ckpt.load_resumable_checkpoint(str(path), total, inputfile, bank_path=bank_path)


def test_resume_refuses_another_process_count_unless_rebalanced(tmp_path, monkeypatch):
    path = tmp_path / "cp.cpt"
    cp = jax_ckpt.Checkpoint(n_template=96, originalfile="wu.bin4", candidates=_candidates(9))
    jax_ckpt.write_checkpoint(str(path), cp, topology=jax_ckpt.topology_record(4, [(0, 50), (50, 100)]))
    with pytest.raises(port_ckpt.CheckpointError, match="4-process"):
        port_ckpt.load_resumable_checkpoint(str(path), 200, "wu.bin4", process_count=1)
    monkeypatch.setenv("ERP_RESUME_REBALANCE", "1")
    assert port_ckpt.load_resumable_checkpoint(str(path), 200, "wu.bin4", process_count=1)[0].n_template == 96
