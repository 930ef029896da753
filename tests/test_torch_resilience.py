"""PyTorch port, resilience and fault injection against the JAX package's.

* ``classify`` and ``is_oom`` agree with the JAX package on a shared table
  of exceptions; on the port's own (``torch.cuda.OutOfMemoryError``,
  cuFFT's ``CUFFT_ALLOC_FAILED``, sticky CUDA context errors) they give
  the classes ``runtime/resilience.py`` documents;
* ``parse_spec`` parses each fault spec to the same rules, or refuses it
  in both;
* ``run_bank`` under an injected ``dispatch:oom@n=2`` halves the batch and
  gives the clean run's (M, T) bitwise; a driver run under
  ``ckpt_write:eio@n=1`` retries and writes the clean run's checkpoint
  bytes and candidate rows; an out-of-memory the ladder cannot absorb
  exits ``RADPUL_EMEM``.

Tolerance: exact throughout.
"""

import errno
import json
import os
import sys

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu.runtime import faultinject as jfi
from boinc_app_eah_brp_tpu.runtime import resilience as jres
from boinc_app_eah_brp_tpu_torch.io import parse_result_file, write_template_bank, write_workunit
from boinc_app_eah_brp_tpu_torch.models import search
from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
from boinc_app_eah_brp_tpu_torch.runtime import faultinject as pfi
from boinc_app_eah_brp_tpu_torch.runtime import metrics as pm
from boinc_app_eah_brp_tpu_torch.runtime import resilience as pres
from fixtures import small_bank, synthetic_timeseries
from torch_parity import DT

N = 4096


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for k in ("ERP_FAULT_SPEC", "ERP_FAULT_STATE", "ERP_METRICS_FILE", "ERP_TRACE_FILE", "ERP_BATCH"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("ERP_RETRY_BASE_S", "0")
    monkeypatch.setenv("ERP_METRICS_INTERVAL", "0")
    yield
    # the schedules and the retry budget are process-global: leave both
    # packages unarmed for the next test
    for fi in (pfi, jfi):
        fi.configure("")
    pres.begin_run()
    jres.begin_run()


SHARED = [
    MemoryError(),
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to allocate"),
    RuntimeError("OUT_OF_MEMORY"),
    RuntimeError("failed: out of memory"),
    RuntimeError("DEADLINE_EXCEEDED"),
    RuntimeError("UNAVAILABLE: socket closed"),
    RuntimeError("device busy"),
    RuntimeError("resource temporarily unavailable"),
    OSError(errno.EIO, "I/O error"),
    OSError(errno.EAGAIN, "again"),
    OSError(errno.ENOSPC, "no space"),
    FileNotFoundError(errno.ENOENT, "gone"),
    ValueError("bad bank"),
    RuntimeError("CUDA kernel build failed"),
    KeyError("x"),
]


@pytest.mark.parametrize("exc", SHARED, ids=lambda e: f"{type(e).__name__}:{e}")
def test_classify_and_is_oom_match_jax(exc):
    assert pres.classify(exc) == jres.classify(exc)
    assert pres.is_oom(exc) == jres.is_oom(exc)


@pytest.mark.parametrize("kind", ["oom", "exc", "fatal", "eio"])
def test_injected_faults_classify_alike(kind):
    for fi, res in ((pfi, pres), (jfi, jres)):
        fi.configure(f"dispatch:{kind}")
        with pytest.raises(Exception) as info:
            fi.fault_point("dispatch")
        assert res.classify(info.value) == ("permanent" if kind == "fatal" else "transient")
        assert res.is_oom(info.value) == (kind == "oom")


@pytest.mark.parametrize(
    "exc,cls,oom",
    [
        (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 48.00 GiB"), "transient", True),
        (RuntimeError("cuFFT error: CUFFT_ALLOC_FAILED"), "transient", True),
        (RuntimeError("CUDA error: an illegal memory access was encountered"), "permanent", False),
        (RuntimeError("CUDA error: device-side assert triggered"), "permanent", False),
        (RuntimeError("CUDA error: unspecified launch failure"), "permanent", False),
        # a sticky error stays permanent whatever else its message says
        (RuntimeError("CUDA error: an illegal memory access was encountered (out of memory?)"), "permanent", False),
    ],
)
def test_port_classifies_cuda_errors(exc, cls, oom):
    assert pres.classify(exc) == cls
    assert pres.is_oom(exc) == oom


SPECS = [
    "",
    "dispatch:oom@n=37;ckpt_write:eio@p=0.05;seed=7",
    "dispatch:hang@n=3",
    "h2d:exc@every=4;result_write:fatal",
    "rescore_feed:corrupt@tmpl=12;seed=3",
    "dispatch:oom@tmpl=0",
]
BAD_SPECS = ["dispatch", "nowhere:oom", "dispatch:melt", "dispatch:oom@n=0", "dispatch:oom@p=2", "seed=x", "dispatch:oom@q=1"]


def _rules(parsed):
    rules, seed = parsed
    return seed, {site: [(r.site, r.kind, r.nth, r.every, r.p, r.tmpl, r._index) for r in rs] for site, rs in rules.items()}


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_matches_jax(spec):
    assert _rules(pfi.parse_spec(spec)) == _rules(jfi.parse_spec(spec))
    assert pfi.SITES == jfi.SITES and pfi.KINDS == jfi.KINDS


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_refused_by_both(spec):
    with pytest.raises(pfi.FaultSpecError):
        pfi.parse_spec(spec)
    with pytest.raises(jfi.FaultSpecError):
        jfi.parse_spec(spec)


def test_backoff_and_budget_match_jax():
    p, j = pres.RetryPolicy(budget=3, base_s=0.05, max_s=1.0, seed=5), jres.RetryPolicy(budget=3, base_s=0.05, max_s=1.0, seed=5)
    assert [p.backoff_s(a) for a in range(8)] == [j.backoff_s(a) for a in range(8)]
    err = RuntimeError("RESOURCE_EXHAUSTED")
    assert [p.try_spend("dispatch", err) for _ in range(4)] == [j.try_spend("dispatch", err) for _ in range(4)]


def test_ladder_halves_on_oom_and_retries_the_rest():
    ladder = pres.DegradationLadder(pres.RetryPolicy(budget=5, base_s=0.0), 8)
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")
    assert ladder.record_failure("dispatch", oom) and ladder.batch_size == 4
    assert ladder.record_failure("dispatch", RuntimeError("device busy")) and ladder.batch_size == 4
    for want in (2, 1, 1):
        assert ladder.record_failure("dispatch", oom) and ladder.batch_size == want
    assert not ladder.record_failure("dispatch", oom)  # the budget of 5 is spent
    assert not pres.DegradationLadder(pres.RetryPolicy(budget=5), 8).record_failure("dispatch", ValueError("x"))


def _geometry(bank, exact_mean):
    derived = DerivedParams.derive(N, DT * 1e6, SearchConfig(window=200, white=not exact_mean))
    return search.SearchGeometry.from_derived(
        derived,
        max_slope=search.max_slope_for_bank(bank.P, bank.tau),
        lut_step=search.lut_step_for_bank(bank.P, derived.dt),
        lut_tiles=search.lut_tiles_for_bank(bank.P, bank.psi0, N, derived.dt),
        exact_mean=exact_mean,
    )


@pytest.mark.parametrize("exact_mean", [False, True])
def test_run_bank_injected_oom_halves_batch_same_state(exact_mean, tmp_path):
    """``dispatch:oom@n=2`` at batch 4: the second batch fails, the ladder
    halves to 2 and re-dispatches from the snapshot (the state as given),
    and (M, T) equal the clean run's bitwise."""
    rng = np.random.default_rng(4)
    n_t = 14
    bank = small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2)
    P = np.concatenate([bank.P, rng.uniform(1.6, 3.0, n_t - len(bank.P))])
    tau = np.concatenate([bank.tau, rng.uniform(0.0, 0.09, n_t - len(bank.P))])
    psi = np.concatenate([bank.psi0, rng.uniform(0.0, 2 * np.pi, n_t - len(bank.P))])
    geom = _geometry(type(bank)(P, tau, psi), exact_mean)
    raw = synthetic_timeseries(N, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    ts = torch.from_numpy((raw + (4.0 if exact_mean else 0.0)).astype(np.float32))

    M0, T0 = search.run_bank(ts, P, tau, psi, geom, batch_size=4)
    assert pm.configure(metrics_file=str(tmp_path / "m.jsonl"), interval=0)
    try:
        pfi.configure("dispatch:oom@n=2")
        pres.begin_run()
        M1, T1 = search.run_bank(ts, P, tau, psi, geom, batch_size=4)
        counters = pm.snapshot()["counters"]
    finally:
        pm.finish(0)
    assert counters["resilience.batch_halved"]["value"] == 1
    assert counters["faultinject.fired"]["value"] == 1
    assert torch.equal(M1, M0) and torch.equal(T1, T0)


def _workdir(tmp_path):
    ts = synthetic_timeseries(N, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    write_workunit(str(tmp_path / "wu.bin4"), ts, tsample_us=DT * 1e6, scale=1.0)
    write_template_bank(str(tmp_path / "bank.dat"), small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2))


def _cli(tmp_path, name, extra=""):
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main

    argv = f"-i {tmp_path}/wu.bin4 -t {tmp_path}/bank.dat -B 200 --device cpu -o {tmp_path}/{name}.cand -c {tmp_path}/{name}.cpt {extra}"
    return main(argv.split())


def test_checkpoint_write_retry_same_bytes(tmp_path, monkeypatch):
    """``ckpt_write:eio@n=1``: the first checkpoint write fails with EIO,
    the retry writes it; the checkpoint bytes and the candidate rows equal
    the clean run's."""
    _workdir(tmp_path)
    assert _cli(tmp_path, "clean", "--batch 2") == 0
    monkeypatch.setenv("ERP_FAULT_SPEC", "ckpt_write:eio@n=1")
    assert _cli(tmp_path, "retried", "--batch 2 --metrics-file " + str(tmp_path / "m.jsonl")) == 0
    with open(tmp_path / "clean.cpt", "rb") as a, open(tmp_path / "retried.cpt", "rb") as b:
        clean, retried = a.read(), b.read()
    assert retried == clean  # the header names the same workunit file
    np.testing.assert_array_equal(
        parse_result_file(str(tmp_path / "retried.cand")).lines, parse_result_file(str(tmp_path / "clean.cand")).lines
    )
    counters = json.load(open(tmp_path / "m.jsonl.report.json"))["metrics"]["counters"]
    assert counters["resilience.retries"]["value"] == 1 and counters["faultinject.fired"]["value"] == 1


def test_unabsorbed_oom_exits_radpul_emem(tmp_path, monkeypatch):
    """With the retry budget off an injected OOM reaches the command line,
    which exits RADPUL_EMEM (1) as a device OOM does."""
    _workdir(tmp_path)
    monkeypatch.setenv("ERP_RETRY_BUDGET", "0")
    monkeypatch.setenv("ERP_FAULT_SPEC", "dispatch:oom@n=1")
    assert _cli(tmp_path, "oom", "--batch 2") == 1
    assert not os.path.exists(tmp_path / "oom.cand")


def test_session_redispatches_from_the_checkpoint_snapshot(tmp_path, monkeypatch):
    """With a checkpoint every batch and the snapshot unthrottled, the
    session refreshes the recovery point at each checkpoint's copy: an OOM
    injected at the third dispatch re-dispatches from template 2, not from
    0 (4 templates searched in all), and the rows equal the clean run's."""
    _workdir(tmp_path)
    assert _cli(tmp_path, "clean", "--batch 1") == 0
    monkeypatch.setenv("ERP_CHECKPOINT_PERIOD", "0")
    monkeypatch.setenv("ERP_RESIL_SNAPSHOT_S", "0")
    monkeypatch.setenv("ERP_FAULT_SPEC", "dispatch:oom@n=3")
    assert _cli(tmp_path, "redone", "--batch 1 --metrics-file " + str(tmp_path / "m.jsonl")) == 0
    counters = json.load(open(tmp_path / "m.jsonl.report.json"))["metrics"]["counters"]
    assert counters["resilience.retries"]["value"] == 1
    assert counters["search.templates"]["value"] == 4 and counters["search.batches"]["value"] == 4
    np.testing.assert_array_equal(
        parse_result_file(str(tmp_path / "redone.cand")).lines, parse_result_file(str(tmp_path / "clean.cand")).lines
    )


def test_release_device_memory_clears_plans_under_the_transform_lock(monkeypatch):
    """The cuFFT plans are cleared under ``planned_fft``'s lock, so a
    transform on another thread (the scheduler's prep thread) never has
    its plan destroyed under it."""
    from types import SimpleNamespace

    from boinc_app_eah_brp_tpu_torch.ops import kernels

    held = []

    class Cache:
        def clear(self):
            held.append(kernels._plan_lock.locked())

    fake = SimpleNamespace(
        cuda=SimpleNamespace(is_initialized=lambda: True, device_count=lambda: 2, empty_cache=lambda: None),
        backends=SimpleNamespace(cuda=SimpleNamespace(cufft_plan_cache=[Cache(), Cache()])),
    )
    monkeypatch.setitem(sys.modules, "torch", fake)
    pres.release_device_memory()
    assert held == [True, True]
    assert not kernels._plan_lock.locked()
