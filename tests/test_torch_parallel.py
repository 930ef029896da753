"""PyTorch port, the template-sharded search (``parallel/``) on the CPU.

The port's ``run_bank_sharded`` over 1-4 logical CPU shards (a mesh that
repeats the CPU device) against its own single-device ``run_bank``:
bitwise, whatever the shard count, the per-device batch, the padding, an
early stop and resume, or a window bound (the cases of the JAX package's
``tests/test_parallel.py``).  Against the JAX package's
``run_bank_sharded`` on its virtual 8-device CPU mesh, on the same numpy
inputs: M to rtol 1e-5 (two FFT libraries, as ``test_torch_search.py``)
and T equal, on templates without a contraction tie at this length
(``torch_parity.contraction_ties``: XLA on the CPU fuses a multiply-add
the port does not).  The mesh helpers and the command line's ``--mesh``
with the JAX package's errors and exit codes.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu.models import SearchGeometry as JaxGeometry
from boinc_app_eah_brp_tpu.oracle import DerivedParams as JaxDerived
from boinc_app_eah_brp_tpu.oracle import SearchConfig as JaxConfig
from boinc_app_eah_brp_tpu.parallel import make_mesh as jax_make_mesh
from boinc_app_eah_brp_tpu.parallel import run_bank_sharded as jax_run_bank_sharded
from boinc_app_eah_brp_tpu_torch.io import TemplateBank, write_template_bank, write_workunit
from boinc_app_eah_brp_tpu_torch.models import search
from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
from boinc_app_eah_brp_tpu_torch.parallel import distributed, make_mesh, run_bank_sharded
from boinc_app_eah_brp_tpu_torch.parallel.mesh import TEMPLATE_AXIS, local_devices
from boinc_app_eah_brp_tpu_torch.parallel.sharded_search import _merge_take, merge_shard_states
from boinc_app_eah_brp_tpu_torch.runtime.cli import main
from boinc_app_eah_brp_tpu_torch.runtime.errors import RADPUL_EVAL
from fixtures import synthetic_timeseries
from torch_parity import DT, contraction_ties

M_RTOL = 1e-5
N = 2048


def _bank(n_templates: int, seed: int = 11) -> TemplateBank:
    """The JAX package's test bank: a null template, then modulated ones."""
    rng = np.random.default_rng(seed)
    P = np.concatenate([[1000.0], rng.uniform(1.5, 3.0, n_templates - 1)])
    tau = np.concatenate([[0.0], rng.uniform(0.0, 0.1, n_templates - 1)])
    psi = np.concatenate([[0.0], rng.uniform(0.0, 2 * np.pi, n_templates - 1)])
    return TemplateBank(P, tau, psi)


@pytest.fixture(scope="module")
def problem():
    ts = synthetic_timeseries(N, f_signal=41.0, P_orb=1.9, tau=0.05, psi0=0.4, amp=6.0)
    d = DerivedParams.derive(N, DT * 1e6, SearchConfig(window=100))
    geom = search.SearchGeometry.from_derived(d, max_slope=0.5, lut_step=0.05)
    return torch.from_numpy(ts), geom


def _cpu_mesh(k):
    return make_mesh(devices=["cpu"] * k)


def _equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_sharded_matches_single_device(problem, n_dev):
    ts, geom = problem
    bank = _bank(23)  # divisible by no global batch: padded slots
    ref = search.run_bank(ts, bank.P, bank.tau, bank.psi0, geom, batch_size=4)
    got = run_bank_sharded(ts, bank.P, bank.tau, bank.psi0, geom, _cpu_mesh(n_dev), per_device_batch=2)
    _equal(ref, got)


def test_sharded_batch_size_invariance(problem):
    ts, geom = problem
    bank = _bank(17)
    a = run_bank_sharded(ts, bank.P, bank.tau, bank.psi0, geom, _cpu_mesh(4), per_device_batch=1)
    b = run_bank_sharded(ts, bank.P, bank.tau, bank.psi0, geom, _cpu_mesh(4), per_device_batch=5)
    _equal(a, b)


def test_sharded_resume_and_early_stop(problem):
    ts, geom = problem
    bank = _bank(20)
    stopped = {}

    def stop_after_first(done, total, M, T):
        stopped["done"] = done
        stopped["state"] = (M.clone(), T.clone())
        return False

    half = run_bank_sharded(
        ts, bank.P, bank.tau, bank.psi0, geom, _cpu_mesh(2), per_device_batch=3, progress_cb=stop_after_first
    )
    done = stopped["done"]
    assert 0 < done < len(bank.P)
    _equal(half, stopped["state"])
    full = run_bank_sharded(
        ts, bank.P, bank.tau, bank.psi0, geom, _cpu_mesh(2), per_device_batch=3, state=half, start_template=done
    )
    _equal(full, search.run_bank(ts, bank.P, bank.tau, bank.psi0, geom, batch_size=6))


def test_sharded_stop_template_matches_truncated_bank(problem):
    ts, geom = problem
    bank = _bank(20)
    stop = 13
    got = run_bank_sharded(
        ts, bank.P, bank.tau, bank.psi0, geom, _cpu_mesh(2), per_device_batch=3, stop_template=stop
    )
    ref = search.run_bank(ts, bank.P[:stop], bank.tau[:stop], bank.psi0[:stop], geom, batch_size=6)
    _equal(ref, got)


def test_sharded_windows_compose_to_full_bank(problem):
    """Disjoint [start, stop) windows chained through the state give the
    whole bank's state: what the shard leases (``parallel/elastic.py``)
    rely on."""
    ts, geom = problem
    bank = _bank(21)
    a = run_bank_sharded(ts, bank.P, bank.tau, bank.psi0, geom, _cpu_mesh(2), per_device_batch=2, stop_template=9)
    ab = run_bank_sharded(ts, bank.P, bank.tau, bank.psi0, geom, _cpu_mesh(2), per_device_batch=2, state=a,
                          start_template=9)
    _equal(ab, search.run_bank(ts, bank.P, bank.tau, bank.psi0, geom, batch_size=4))


@pytest.mark.parametrize("use_lut", [True, False])
def test_sharded_exact_mean_matches_single_device(problem, use_lut):
    """Unwhitened (each shard's slice of the exact means) and exact-sine
    geometries, bitwise ``run_bank``'s."""
    ts, geom = problem
    geom_em = dataclasses.replace(geom, exact_mean=True, use_lut=use_lut)
    bank = _bank(19)
    ts_u = ts + 3.0
    ref = search.run_bank(ts_u, bank.P, bank.tau, bank.psi0, geom_em, batch_size=4)
    got = run_bank_sharded(ts_u, bank.P, bank.tau, bank.psi0, geom_em, _cpu_mesh(4), per_device_batch=2)
    _equal(ref, got)


def test_sharded_seed_state_keeps_run_bank_ties(problem):
    """A seeded state (a checkpoint's virtual templates past the bank) wins
    ties against the bank's templates, as run_bank's strict ``>`` keeps it:
    the cross-shard merge compares indices only between shards' finds."""
    ts, geom = problem
    bank = _bank(12)
    ref = search.run_bank(ts, bank.P, bank.tau, bank.psi0, geom, batch_size=4)
    seed_M = ref[0].clone()
    seed_T = torch.full_like(ref[1], 10_000)  # virtual templates past the bank, same powers
    want = search.run_bank(ts, bank.P, bank.tau, bank.psi0, geom, batch_size=4, state=(seed_M.clone(), seed_T.clone()))
    got = run_bank_sharded(ts, bank.P, bank.tau, bank.psi0, geom, _cpu_mesh(3), per_device_batch=2,
                           state=(seed_M, seed_T))
    _equal(want, got)
    assert bool((got[1] == 10_000).all())


def test_merge_take_orders_power_then_index():
    M1 = torch.tensor([[2.0, 1.0, 5.0]])
    T1 = torch.tensor([[3, 4, 5]], dtype=torch.int32)
    M2 = torch.tensor([[2.0, 3.0, 4.0]])
    T2 = torch.tensor([[1, 9, 9]], dtype=torch.int32)
    M, T = merge_shard_states([(M1, T1), (M2, T2)], torch.device("cpu"))
    assert M.tolist() == [[2.0, 3.0, 5.0]] and T.tolist() == [[1, 9, 5]]
    M3, T3 = _merge_take(M1, T1, M, T)  # idempotent
    assert torch.equal(M3, M) and torch.equal(T3, T)


def _untied_bank(n_templates):
    """The test bank without the templates that have a contraction tie at N."""
    bank = _bank(n_templates)
    params = search.bank_params_host(bank.P, bank.tau, bank.psi0, DT)
    keep = ~contraction_ties(params, N).any(axis=(1, 2))
    return TemplateBank(bank.P[keep], bank.tau[keep], bank.psi0[keep])


@pytest.mark.parametrize("n_dev", [2, 3])
def test_sharded_matches_jax_sharded(problem, n_dev):
    """The same numpy inputs through the JAX package's run_bank_sharded on
    its virtual CPU mesh: M to rtol 1e-5, T equal."""
    ts, geom = problem
    bank = _untied_bank(23)
    assert len(bank.P) >= 15
    jd = JaxDerived.derive(N, DT * 1e6, JaxConfig(window=100))
    jgeom = JaxGeometry.from_derived(jd, max_slope=0.5, lut_step=0.05)
    jM, jT = jax_run_bank_sharded(
        ts.numpy(), bank.P, bank.tau, bank.psi0, jgeom, jax_make_mesh(n_dev), per_device_batch=2
    )
    M, T = run_bank_sharded(ts, bank.P, bank.tau, bank.psi0, geom, _cpu_mesh(n_dev), per_device_batch=2)
    np.testing.assert_allclose(M.numpy(), np.asarray(jM), rtol=M_RTOL)
    np.testing.assert_array_equal(T.numpy(), np.asarray(jT))


def test_make_mesh_axis_and_repeats():
    mesh = make_mesh(devices=["cpu", "cpu", "cpu"])
    assert mesh.axis_name == TEMPLATE_AXIS and mesh.size == 3
    with pytest.raises(ValueError, match="were given"):
        make_mesh(2, devices=["cpu"])
    with pytest.raises(ValueError, match="at least one"):
        make_mesh(devices=[])


def test_make_mesh_cpu_shards_from_env(monkeypatch):
    monkeypatch.delenv(distributed.ENV_LOCAL_DEVICES, raising=False)
    assert make_mesh(platform="cpu").size == 1
    monkeypatch.setenv(distributed.ENV_LOCAL_DEVICES, "3")
    assert local_devices("cpu") == [torch.device("cpu")] * 3
    assert make_mesh(2, platform="cpu").size == 2
    with pytest.raises(ValueError, match="available"):
        make_mesh(4, platform="cpu")


def test_make_mesh_multiprocess_overdraw_names_the_fix(monkeypatch):
    """As the JAX package's: a multi-process run asking for more devices
    than this process addresses is pointed at parallel.elastic."""
    monkeypatch.setattr(
        distributed, "context", lambda: distributed.DistributedConfig(num_processes=4, process_id=1)
    )
    monkeypatch.delenv(distributed.ENV_LOCAL_DEVICES, raising=False)
    with pytest.raises(ValueError, match="parallel.elastic"):
        make_mesh(2, platform="cpu")


def test_mesh_overdraw_message_matches_jax(monkeypatch):
    """The same overdraw gives the JAX package's message word for word:
    its 8 virtual CPU devices against the port's 8 logical CPU shards."""
    n = len(jax.local_devices())
    with pytest.raises(ValueError) as want:
        jax_make_mesh(n + 1)
    monkeypatch.setenv(distributed.ENV_LOCAL_DEVICES, str(n))
    with pytest.raises(ValueError) as got:
        make_mesh(n + 1, platform="cpu")
    assert str(got.value) == str(want.value)


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ERP_RESULT_DATE", "2026-01-01T00:00:00+00:00")
    monkeypatch.delenv(distributed.ENV_LOCAL_DEVICES, raising=False)
    distributed.reset()
    ts = synthetic_timeseries(4096, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    write_workunit("wu.bin4", ts, tsample_us=500.0, scale=1.0)
    rng = np.random.default_rng(5)
    P = np.concatenate([[2.2], rng.uniform(1.8, 2.6, 10)])
    tau = np.concatenate([[0.04], rng.uniform(0.0, 0.06, 10)])
    psi = np.concatenate([[1.2], rng.uniform(0.0, 2 * np.pi, 10)])
    write_template_bank("bank.dat", TemplateBank(P, tau, psi))
    yield tmp_path
    distributed.reset()


def _cli(extra):
    return main(f"-i wu.bin4 -t bank.dat -B 200 --batch 2 --device cpu {extra}".split())


def test_cli_mesh_gives_the_single_device_rows(workdir, monkeypatch):
    """``--mesh 3`` over ERP_LOCAL_DEVICES=3 logical CPU shards, and the
    default mesh over them, write the bytes of ``--mesh 1``; unwhitened
    with a checkpoint and rescoring, the JAX driver's defaults."""
    assert _cli("-o one.cand -c one.cpt --mesh 1") == 0
    monkeypatch.setenv(distributed.ENV_LOCAL_DEVICES, "3")
    assert _cli("-o three.cand -c three.cpt --mesh 3") == 0
    assert _cli("-o auto.cand -c auto.cpt") == 0
    one = open("one.cand", "rb").read()
    assert one.endswith(b"%DONE%\n")
    assert open("three.cand", "rb").read() == one
    assert open("auto.cand", "rb").read() == one


def test_cli_mesh_wider_than_the_devices_is_radpul_eval(workdir):
    assert _cli("-o wide.cand --mesh 2") == RADPUL_EVAL
    assert not os.path.exists("wide.cand")
