"""PyTorch port, the batched search step and the slice end to end on the
CPU, against the JAX package.

Tolerances:
* one ``BankStep`` against JAX ``make_bank_step`` (resident Pallas chain,
  interpret mode) from the same carried-over state: the power spectra
  come from two FFT libraries, so M is held to rtol 1e-5 (the largest
  difference seen is ~1e-6) and T must be equal.  The templates are ones
  without a contraction tie at this length (``torch_parity``): at a tie
  XLA on the CPU fuses a multiply-add the reference does not, gathers a
  different sample, and moves every bin of that template by ~1%;
* the candidate files of the two drivers are compared with the
  validator's tolerance (``io/validate.py::compare_candidate_rows``);
* the exact-sine step (``use_lut=False``) against JAX ``make_bank_step``
  at ``use_lut=False`` (XLA's ``jnp.sin``) as the LUT step, on templates
  without a sine tie at this length (``torch_parity.sine_ties``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu.io import parse_result_file as jax_parse
from boinc_app_eah_brp_tpu.io.validate import compare_candidate_rows
from boinc_app_eah_brp_tpu.models import search as jax_search
from boinc_app_eah_brp_tpu.ops.resample import resample_split as xla_resample_split
from boinc_app_eah_brp_tpu.oracle.pipeline import DerivedParams as JaxDerived
from boinc_app_eah_brp_tpu.oracle.pipeline import SearchConfig as JaxConfig
from boinc_app_eah_brp_tpu.runtime.driver import DriverArgs as JaxArgs
from boinc_app_eah_brp_tpu.runtime.driver import run_search as jax_run_search
from boinc_app_eah_brp_tpu_torch.io import (
    parse_result_file,
    write_template_bank,
    write_workunit,
)
from boinc_app_eah_brp_tpu_torch.models import search
from boinc_app_eah_brp_tpu_torch.ops import resample
from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
from boinc_app_eah_brp_tpu_torch.runtime.cli import main, parse_args
from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs, run_search
from boinc_app_eah_brp_tpu_torch.runtime.errors import RADPUL_EFILE, RADPUL_EMISC, RADPUL_EVAL
from fixtures import small_bank, synthetic_timeseries
from torch_parity import DT, contraction_ties, sine_ties

M_RTOL = 1e-5
BANK200 = os.path.join(os.path.dirname(__file__), "golden", "bank200.txt")


def _geoms(n, cfg_kw, P, tau, psi0):
    jd = JaxDerived.derive(n, DT * 1e6, JaxConfig(**cfg_kw))
    d = DerivedParams.derive(n, DT * 1e6, SearchConfig(**cfg_kw))
    bounds = dict(
        max_slope=search.max_slope_for_bank(P, tau),
        lut_step=search.lut_step_for_bank(P, DT),
        lut_tiles=search.lut_tiles_for_bank(P, psi0, n, DT),
    )
    return jax_search.SearchGeometry.from_derived(jd, **bounds), search.SearchGeometry.from_derived(
        d, **bounds
    )


def test_bank_step_matches_jax_resident_step(monkeypatch):
    monkeypatch.setenv("ERP_PALLAS_RESIDENT", "1")
    monkeypatch.setenv("ERP_PALLAS_SUMSPEC", "1")
    n, B = 1 << 13, 3
    b = np.loadtxt(BANK200)[[0, 1, 2, 6, 9]]
    P, tau, psi0 = b[:, 0], b[:, 1], b[:, 2]
    assert not contraction_ties(search.bank_params_host(P, tau, psi0, DT), n).any()
    jgeom, geom = _geoms(n, dict(padding=1.5, window=200, f0=250.0), P, tau, psi0)
    assert jax_search.use_pallas_resident(jgeom) and jax_search.use_pallas_sumspec(jgeom)
    ts = np.random.default_rng(11).normal(0.0, 1.0, n).astype(np.float32)
    ts_args = jax_search.prepare_ts(jgeom, ts)
    jbank = jax_search.upload_bank(jax_search.bank_params_host(P, tau, psi0, DT), B)
    jstep = jax_search.make_bank_step(jgeom, B)
    M, T = jax_search.init_state(jgeom)
    M, T = jstep(ts_args, *jbank, jnp.int32(0), jnp.int32(len(P)), M, T)

    # carry the JAX state after the first batch into the port, then run
    # the second (partly masked) batch on both
    step = search.BankStep(
        geom,
        search.bank_from_jax([np.asarray(a) for a in jbank], device="cpu"),
        B,
        state=search.state_from_jax(np.asarray(M), np.asarray(T), device="cpu"),
    )
    M, T = jstep(ts_args, *jbank, jnp.int32(B), jnp.int32(len(P)), M, T)
    pM, pT = step(torch.from_numpy(ts), B, len(P))
    np.testing.assert_allclose(pM.numpy(), np.asarray(M), rtol=M_RTOL)
    np.testing.assert_array_equal(pT.numpy(), np.asarray(T))
    assert set(np.unique(pT.numpy())) <= set(range(len(P)))


def test_ties_go_to_the_earliest_template():
    """First-index argmax inside a batch, strict '>' across batches: a bank
    of the same two templates twice keeps every bin on templates 0/1."""
    n, B = 1 << 12, 2
    row = np.loadtxt(BANK200)[[3, 8]]
    b = np.concatenate([row, row, row[:1]])
    P, tau, psi0 = b[:, 0], b[:, 1], b[:, 2]
    _, geom = _geoms(n, dict(padding=1.0, window=100, f0=200.0), P, tau, psi0)
    ts = torch.from_numpy(np.random.default_rng(2).normal(0.0, 1.0, n).astype(np.float32))
    M, T = search.run_bank(ts, P, tau, psi0, geom, batch_size=B)
    assert int(T.max()) <= 1
    # a batch holding template 0 twice resolves every tie to its first slot
    bank = search.upload_bank(search.bank_params_host(P[[0, 0]], tau[[0, 0]], psi0[[0, 0]], DT), 2, "cpu")
    step = search.BankStep(geom, bank, 2, state=search.init_state(geom, "cpu"))
    M2, T2 = step(ts, 0, 2)
    assert int(T2.max()) == 0 and float(M2.max()) > 0.0


@pytest.mark.parametrize("start", [0, 4])
def test_unwhitened_run_bank_matches_per_batch_steps(monkeypatch, start):
    """An unwhitened run_bank computes the exact means of the templates
    still to search once, ahead, and gives the same (M, T) as BankStep
    computing each batch's means itself, from the start and from a resume
    offset carrying the state of the templates before it; the last batch
    is partial."""
    n, B = 1 << 12, 3
    b = np.loadtxt(BANK200)[[0, 1, 2, 6, 9, 30, 77]]
    P, tau, psi0 = b[:, 0], b[:, 1], b[:, 2]
    _, geom = _geoms(n, dict(padding=1.5, window=200, f0=250.0), P, tau, psi0)
    geom = dataclasses.replace(geom, exact_mean=True)
    ts = torch.from_numpy(np.random.default_rng(13).normal(4.0, 1.0, n).astype(np.float32))
    before = search.run_bank(ts, P, tau, psi0, geom, batch_size=B, stop_template=start)
    calls = []

    def spy(ts_, params, **kw):
        calls.append(params.shape[0])
        return resample.exact_mean_params(ts_, params, **kw)

    monkeypatch.setattr(search, "exact_mean_params", spy)
    M, T = search.run_bank(
        ts, P, tau, psi0, geom, batch_size=B, state=tuple(x.clone() for x in before), start_template=start
    )
    assert calls == [len(P) - start]

    bank = search.upload_bank(search.bank_params_host(P, tau, psi0, DT), B, "cpu")
    step = search.BankStep(geom, bank, B, state=tuple(x.clone() for x in before))
    assert step.mean is None
    for t in range(start, len(P), B):
        step(ts, t, len(P))
    assert torch.equal(M, step.M) and torch.equal(T, step.T)
    assert int(T.max()) == len(P) - 1 and float(M.min()) >= 0.0


@pytest.fixture
def workdir(tmp_path):
    n = 4096
    ts = synthetic_timeseries(n, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    paths = {k: str(tmp_path / v) for k, v in dict(
        wu="test.bin4", bank="bank.dat", zap="zap.txt", jax="jax.cand", port="port.cand"
    ).items()}
    write_workunit(paths["wu"], ts, tsample_us=500.0, scale=1.0, dm=55.5)
    write_template_bank(paths["bank"], small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2))
    with open(paths["zap"], "w") as f:
        f.write("50.0 51.0\n120.0 121.5\n")
    return paths


def test_slice_matches_jax_driver(workdir):
    common = dict(
        inputfile=workdir["wu"], templatebank=workdir["bank"], zaplistfile=workdir["zap"],
        window=200, batch_size=2, white=True,
    )
    assert run_search(DriverArgs(outputfile=workdir["port"], device="cpu", **common)) == 0
    assert jax_run_search(
        JaxArgs(outputfile=workdir["jax"], rescore=False, mesh_devices=1, **common)
    ) == 0
    got, want = parse_result_file(workdir["port"]), jax_parse(workdir["jax"])
    assert got.done and want.done and len(got.lines) > 0
    for rows in (got.lines, want.lines):
        assert abs(rows[0][1] - 2.2) < 1e-4 and abs(rows[0][2] - 0.04) < 1e-4
    diff = compare_candidate_rows(got.lines, want.lines, t_obs=4096 * DT)
    assert diff.ok, diff.report()


def test_cli_runs_the_slice(workdir):
    rc = main(
        f"-i {workdir['wu']} -o {workdir['port']} -t {workdir['bank']} -l {workdir['zap']} "
        "-W -B 200 -P 1.0 --batch 3 --device cpu".split()
    )
    assert rc == 0
    assert open(workdir["port"]).read().endswith("%DONE%\n")


@pytest.mark.parametrize(
    "argv,want",
    [
        ("--mesh 2", {"mesh_devices": 2, "device": "cuda"}),
        ("--mesh 2 -D 0", RADPUL_EVAL),
        ("--mesh 0", RADPUL_EVAL),
        ("--supervised 3", RADPUL_EMISC),
        ("--rescore", RADPUL_EMISC),
        ("--exact-sin", {"use_lut": False}),
        ("-P 0.5", RADPUL_EVAL),
        ("--batch 0", RADPUL_EVAL),
        ("--bogus", RADPUL_EMISC),
    ],
)
def test_cli_refuses_what_the_slice_does_not_honour(argv, want):
    """The JAX package's range checks and exit codes (an int), or the
    fields a flag the port honours parses to (a dict): ``--mesh`` and
    ``--exact-sin`` are honoured, ``-D`` with ``--mesh N>1`` and ``--mesh 0``
    are RADPUL_EVAL, as in the JAX driver."""
    base = "-i a.bin4 -o o.cand -t t.bank ".split()
    got = parse_args(base + argv.split())
    if isinstance(want, dict):
        assert isinstance(got, DriverArgs) and {k: getattr(got, k) for k in want} == want
    else:
        assert got == want


def test_cli_parses_the_jax_default_surface():
    """The JAX driver's default command line and the wrapper's flags."""
    parsed = parse_args(
        "-i in.bin4 -o out.cand -t bank.dat -c cp.bin -l zap.txt -A 0.08 -P 3.0 -f 400.0 -B 1000 -z "
        "-D 1 --no-rescore --status-file st.txt --control-file ctl.txt --shmem seg".split()
    )
    assert isinstance(parsed, DriverArgs)
    assert (parsed.checkpointfile, parsed.device, parsed.debug, parsed.rescore, parsed.white) == (
        "cp.bin", "cuda:1", True, False, False
    )
    assert (parsed.status_file, parsed.control_file, parsed.shmem) == ("st.txt", "ctl.txt", "seg")
    assert parse_args("-i a.bin4 -o o -t t".split()).rescore
    assert parse_args("-i a.bin4 -o o -t t -D x".split()) == RADPUL_EVAL
    assert parse_args("-i a.bin4 -o o -t t -c".split()) == RADPUL_EFILE


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = DerivedParams.derive(1024, 500.0, SearchConfig(window=100))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search.init_state(search.SearchGeometry.from_derived(d))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search.state_from_jax(np.zeros((5, 8), np.float32), np.zeros((5, 8), np.int32))


def test_exact_sin_runs_a_bank_the_lut_refuses():
    """An orbit of 0.3 s at 500 us moves the LUT index 0.1 a sample, past
    the default geometry's bound: both packages refuse it with the LUT and
    search it with the exact sine.  One exact-sine BankStep against the JAX
    step at ``use_lut=False``: M to rtol 1e-5, T equal."""
    n, B = 1 << 12, 3
    rng = np.random.default_rng(31)
    P = rng.uniform(0.3, 0.6, 6)
    tau = rng.uniform(1e-3, 4e-3, 6)
    psi0 = rng.uniform(0.0, 2 * np.pi, 6)
    params = search.bank_params_host(P, tau, psi0, DT)
    ts = np.random.default_rng(12).normal(0.0, 1.0, n).astype(np.float32)
    # the templates whose gathered samples are the JAX package's (its
    # jnp.sin and fused del_t): a flip may only be a tie
    raw, n_steps, _ = resample.resample_stream(
        torch.from_numpy(ts), resample.stream_params(*params), n_unpadded=n, dt=DT, exact_sin=True
    )
    ev, od = jax.vmap(
        lambda a, b, c, d: xla_resample_split(
            jnp.asarray(ts[0::2]), jnp.asarray(ts[1::2]), a, b, c, d, nsamples=n, n_unpadded=n, dt=DT,
            use_lut=False, max_slope=0.5,
        )
    )(*(jnp.asarray(p) for p in params))
    head = (2 * np.arange(n // 2)[None, None, :] + np.arange(2)[None, :, None]) < n_steps.numpy()[:, None, None]
    flips = (raw.numpy() != np.stack([np.asarray(ev), np.asarray(od)], axis=1)) & head
    assert not (flips & ~(sine_ties(params, n) | contraction_ties(params, n))).any()
    keep = ~flips.any(axis=(1, 2))
    P, tau, psi0 = P[keep], tau[keep], psi0[keep]
    assert len(P) >= B
    cfg = dict(padding=1.5, window=200, f0=250.0)
    jgeom = jax_search.SearchGeometry.from_derived(JaxDerived.derive(n, DT * 1e6, JaxConfig(**cfg)), max_slope=0.5)
    geom = search.SearchGeometry.from_derived(DerivedParams.derive(n, DT * 1e6, SearchConfig(**cfg)), max_slope=0.5)
    for validate, g in ((jax_search.validate_bank_bounds, jgeom), (search.validate_bank_bounds, geom)):
        with pytest.raises(ValueError, match="LUT-index step"):
            validate(g, P, tau, psi0)
        validate(dataclasses.replace(g, use_lut=False), P, tau, psi0)
    jgeom, geom = (dataclasses.replace(g, use_lut=False) for g in (jgeom, geom))
    jbank = jax_search.upload_bank(jax_search.bank_params_host(P[:B], tau[:B], psi0[:B], DT), B)
    M, T = jax_search.init_state(jgeom)
    jstep = jax_search.make_bank_step(jgeom, B)
    M, T = jstep(jax_search.prepare_ts(jgeom, ts), *jbank, jnp.int32(0), jnp.int32(B), M, T)
    pM, pT = search.run_bank(torch.from_numpy(ts), P[:B], tau[:B], psi0[:B], geom, batch_size=B)
    np.testing.assert_allclose(pM.numpy(), np.asarray(M), rtol=M_RTOL)
    np.testing.assert_array_equal(pT.numpy(), np.asarray(T))


@pytest.mark.parametrize("white", [True, False])
def test_exact_sin_cli_matches_jax_driver(workdir, white):
    """``--exact-sin`` through both drivers, whitened and unwhitened (the
    JAX package's exact-sine host pass is its own best effort), compared
    with the validator's tolerance; the port's rows also equal its LUT
    rows on this bank of orbits of seconds within the same tolerance."""
    common = dict(inputfile=workdir["wu"], templatebank=workdir["bank"], window=200, batch_size=2, white=white)
    if white:
        common["zaplistfile"] = workdir["zap"]
    argv = f"-i {workdir['wu']} -o {workdir['port']} -t {workdir['bank']} -B 200 --batch 2 --device cpu --exact-sin"
    if white:
        argv += f" -W -l {workdir['zap']}"
    parsed = parse_args(argv.split())
    assert parsed.use_lut is False
    assert run_search(parsed) == 0
    assert jax_run_search(JaxArgs(outputfile=workdir["jax"], use_lut=False, mesh_devices=1, **common)) == 0
    got, want = parse_result_file(workdir["port"]), jax_parse(workdir["jax"])
    assert got.done and want.done and len(got.lines) > 0
    diff = compare_candidate_rows(got.lines, want.lines, t_obs=4096 * DT)
    assert diff.ok, diff.report()
    lut = workdir["port"] + ".lut"
    assert run_search(DriverArgs(outputfile=lut, device="cpu", **common)) == 0
    assert compare_candidate_rows(parse_result_file(lut).lines, got.lines, t_obs=4096 * DT).ok
