"""PyTorch port, the host oracle and its rescoring against the JAX
package's.  Both are numpy on the same inputs, so every comparison is
bitwise.

The end-of-run pass takes each template's resampled series from the
session's device (``rescore.device_series``: kernel A's gather and the
exact serial mean, their plain versions on a CPU tensor) and its spectrum
there (``spectrum.power_at_on_device``: a float64 rfft, which on a CPU
tensor is torch's own); both are held bitwise against the host oracle
here, and the patched toplist bytes against the host pass's and the JAX
package's.  At the production length the float64 transform rounded to
float32 is numpy's float32 transform but for a few 1-ulp roundings, and
a float32 transform is not."""

import importlib
import os

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu_torch.io import empty_candidates, write_template_bank, write_workunit
from boinc_app_eah_brp_tpu_torch.models import search
from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
from boinc_app_eah_brp_tpu_torch.oracle import harmonic, rescore, resample, spectrum
from boinc_app_eah_brp_tpu_torch.oracle.stats import base_thresholds
from boinc_app_eah_brp_tpu_torch.oracle.toplist import finalize_candidates, update_toplist_from_maxima
from boinc_app_eah_brp_tpu_torch.runtime import metrics, tracing
from fixtures import small_bank, synthetic_timeseries
from torch_parity import DT, host_rescore

# the JAX package's oracle/__init__ re-exports functions named like its
# modules, so the modules are fetched by name
jax_harmonic, jax_rescore, jax_resample, jax_spectrum = (
    importlib.import_module(f"boinc_app_eah_brp_tpu.oracle.{m}") for m in ("harmonic", "rescore", "resample", "spectrum")
)
N = 4096
BANK200 = os.path.join(os.path.dirname(__file__), "golden", "bank200.txt")


@pytest.fixture(scope="module")
def toplist():
    """A series, its geometry and the toplist of a CPU search of a small
    bank over it (the injected orbit and its neighbours)."""
    ts = synthetic_timeseries(N, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0).astype(np.float32)
    cfg = SearchConfig(window=200, padding=1.5)
    d = DerivedParams.derive(N, DT * 1e6, cfg)
    b = small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2)
    P, tau, psi0 = b.P, b.tau, search.normalize_psi0(b.psi0)
    geom = search.SearchGeometry.from_derived(
        d,
        max_slope=search.max_slope_for_bank(P, tau),
        lut_step=search.lut_step_for_bank(P, DT),
        lut_tiles=search.lut_tiles_for_bank(P, psi0, N, DT),
        exact_mean=True,
    )
    M, T = search.run_bank(torch.from_numpy(ts), P, tau, psi0, geom, batch_size=2)
    cands = update_toplist_from_maxima(
        empty_candidates(),
        search.state_to_natural(M, geom),
        search.state_to_natural(T, geom),
        P.astype(np.float32), tau.astype(np.float32), psi0.astype(np.float32),
        base_thresholds(cfg.fA, d.fft_size), geom.window_2,
    )
    emitted = finalize_candidates(cands, d.t_obs)
    assert len(emitted) > 10
    return ts, d, cands, emitted


@pytest.mark.parametrize("tpl", [(2.2, 0.04, 1.2), (1.7, 0.09, 5.9), (1000.0, 0.0, 0.0)])
def test_oracle_copies_match(toplist, tpl):
    ts, d, _, _ = toplist
    args = (*tpl, d.dt, d.nsamples, d.n_unpadded)
    out, n_steps, mean = resample.resample(ts, resample.ResampleParams.from_template(*args))
    j_out, j_n, j_mean = jax_resample.resample(ts, jax_resample.ResampleParams.from_template(*args))
    assert n_steps == j_n and mean.tobytes() == j_mean.tobytes()
    assert out.tobytes() == j_out.tobytes()
    ps = spectrum.power_spectrum(out, 1.0 / d.nsamples)
    assert ps.tobytes() == jax_spectrum.power_spectrum(out, 1.0 / d.nsamples).tobytes()
    geo = (d.window_2, d.fundamental_idx_hi, d.harmonic_idx_hi)
    for k in range(5):
        for j in (0, d.window_2 // 16, 97, d.fundamental_idx_hi - 1, d.fundamental_idx_hi):
            assert harmonic.harmonic_power_at(ps, j, k, *geo) == jax_harmonic.harmonic_power_at(ps, j, k, *geo)


def test_rescore_winners_matches_jax(toplist):
    ts, d, cands, emitted = toplist
    got, n_got = rescore.rescore_winners(torch.from_numpy(ts), cands, emitted, d)
    want, n_want = jax_rescore.rescore_winners(ts, cands, emitted, d)
    assert n_got == n_want == rescore.unique_winner_count(emitted) == jax_rescore.unique_winner_count(emitted)
    assert got.tobytes() == want.tobytes()
    assert not np.array_equal(got["power"], cands["power"])  # the device powers were replaced


def test_rescore_winners_refuses_a_numpy_series(toplist):
    """The pass takes the searched series as a torch tensor: a numpy
    array is refused before any work, not scored on another path."""
    ts, d, cands, emitted = toplist
    with pytest.raises(TypeError, match="torch tensor"):
        rescore.rescore_winners(ts, cands, emitted, d)


def _fixture_rows(d, extra=()):
    """The oracle's parameters of the fixture bank and the first ten rows
    of bank200 (two launches of ``DEVICE_CHUNK``), then ``extra``."""
    b = small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2)
    b200 = np.loadtxt(BANK200)[:10]
    tpls = list(zip(b.P, b.tau, search.normalize_psi0(b.psi0))) + [tuple(r) for r in b200]
    rows = [resample.ResampleParams.from_template(*t, d.dt, d.nsamples, d.n_unpadded) for t in tpls]
    return rows + list(extra)


def _no_sample_row(d, s0):
    """A parameter set whose integer S0 leaves no sample before the
    trailing run (n_steps = -1 for s0 >= n - 1)."""
    return resample.ResampleParams(
        nsamples=d.nsamples, nsamples_unpadded=d.n_unpadded, fft_size=d.nsamples // 2 + 1, tau=np.float32(0.0),
        omega=np.float32(1.0), psi0=np.float32(0.0), dt=np.float32(d.dt),
        step_inv=np.float32(1.0) / np.float32(d.dt), s0=np.float32(s0),
    )


def _whitened(ts, d):
    from boinc_app_eah_brp_tpu_torch.ops.whiten import whiten_and_zap

    cfg = SearchConfig(window=200, padding=1.5, white=True)
    zap = np.array([[50.0, 51.0], [120.0, 121.5]])
    return whiten_and_zap(ts, d, cfg, zap, device="cpu").numpy()


@pytest.mark.parametrize("case", ["unwhitened", "whitened", "no_sample"])
def test_device_heads_are_the_oracle_resample(toplist, case):
    """Every template's series resampled and padded on the device, its
    n_steps and its mean are the host oracle's ``resample`` bit for bit:
    the raw series and a whitened one (no renorm either way), and
    parameter sets with n_steps = -1 (an all-mean series) among them."""
    ts, d, _, _ = toplist
    series = _whitened(ts, d) if case == "whitened" else ts
    extra = [_no_sample_row(d, d.n_unpadded - 1), _no_sample_row(d, d.n_unpadded + 40)] if case == "no_sample" else []
    rows = _fixture_rows(d, extra)
    assert len(rows) > rescore.DEVICE_CHUNK
    assert metrics.configure(force=True)
    try:
        got = list(rescore.device_series(torch.from_numpy(series), rows))
        counted = metrics.snapshot()["counters"]["rescore.device_resamples"]["value"]
    finally:
        metrics.finish(0)
    assert counted == len(got) == len(rows)
    for row, (padded, n_steps, mean) in zip(rows, got):
        want, w_steps, w_mean = resample.resample(series, row)
        assert n_steps == w_steps and mean.tobytes() == w_mean.tobytes()
        assert padded.dtype == torch.float32 and padded.numpy().tobytes() == want.tobytes()
    if case == "no_sample":
        assert [g[1] for g in got[-2:]] == [-1, -1]
        assert not resample.resample(series, extra[0])[0].any()  # the mean, 0.0


def _power_bins(n_bins):
    return np.unique(np.r_[0, 1, 97, np.random.default_rng(5).integers(0, n_bins, 300), n_bins - 1])


@pytest.mark.parametrize("tpl", [(2.2, 0.04, 1.2), (1000.0, 0.0, 0.0)])
def test_power_at_is_the_power_spectrum_at_its_bins(toplist, tpl):
    ts, d, _, _ = toplist
    out = resample.resample(ts, resample.ResampleParams.from_template(*tpl, d.dt, d.nsamples, d.n_unpadded))[0]
    full = spectrum.power_spectrum(out, 1.0 / d.nsamples)
    bins = _power_bins(len(full))
    got = spectrum.power_at(out, bins, 1.0 / d.nsamples)
    assert got.shape == full.shape and got.dtype == np.float32
    assert got[bins].tobytes() == full[bins].tobytes()
    rest = np.ones(len(full), dtype=bool)
    rest[bins] = False
    assert not got[rest].any()


@pytest.mark.parametrize("tpl", [(2.2, 0.04, 1.2), (1000.0, 0.0, 0.0)])
def test_power_at_on_device_is_power_at(toplist, tpl):
    """The fixture's resampled series as a tensor: the spectrum taken on
    its device (a float64 rfft, rounded to float32 at the bins) is
    ``power_at``'s byte for byte, DC and the unlisted bins 0."""
    ts, d, _, _ = toplist
    out = resample.resample(ts, resample.ResampleParams.from_template(*tpl, d.dt, d.nsamples, d.n_unpadded))[0]
    bins = _power_bins(d.nsamples // 2 + 1)
    want = spectrum.power_at(out, bins, 1.0 / d.nsamples)
    got = spectrum.power_at_on_device(torch.from_numpy(out), bins, 1.0 / d.nsamples)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    assert got[0] == 0.0 and got[bins[1:]].all()


PRODUCTION_NSAMPLES = 12_582_912  # the palfa geometry's padded series, 3 x 2^22


@pytest.fixture(scope="module")
def production_rfft():
    """A seeded float32 series of the production length and numpy's
    float32 rfft of it (complex64), as the host oracle takes it."""
    x = (np.random.default_rng(24).standard_normal(PRODUCTION_NSAMPLES) * 1.5 + 0.25).astype(np.float32)
    want = np.fft.rfft(x)
    assert want.dtype == np.complex64
    return x, want


def _ulps_apart(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """The float32 values of ``got`` and ``want`` (complex64, re and im
    apart) that differ, each as its distance in units in the last place."""
    a, b = (np.ascontiguousarray(v).view(np.float32).view(np.int32).astype(np.int64) for v in (got, want))
    # a monotone integer line through 0 for the sign-magnitude bit pattern
    a, b = (np.where(v < 0, -(v & 0x7FFFFFFF), v) for v in (a, b))
    return np.abs(a - b)[a != b]


@pytest.mark.parametrize("dtype, close", [(torch.float64, True), (torch.float32, False)])
def test_the_oracle_spectrum_is_a_float64_transform(production_rfft, dtype, close):
    """numpy's rfft of a float32 series is the float64 transform rounded
    once: torch's float64 rfft, rounded to complex64, differs from it in
    at most 4 of the 12,582,914 values, each by 1 ulp, at the production
    length.  A float32 transform misses nearly every value, so a cheaper
    FFT in the rescoring would change the candidate file's powers."""
    x, want = production_rfft
    got = torch.fft.rfft(torch.from_numpy(x).to(dtype)).to(torch.complex64).numpy()
    apart = _ulps_apart(got, want)
    assert (len(apart) <= 4 and apart.max(initial=0) <= 1) == close, (len(apart), apart.max(initial=0))


def test_harmonic_bins_are_every_bin_harmonic_power_at_reads(toplist):
    """The sums over a spectrum that is NaN outside the listed bins are
    the full spectrum's, bit for bit: no other bin is read."""
    ts, d, _, _ = toplist
    out = resample.resample(ts, resample.ResampleParams.from_template(2.2, 0.04, 1.2, d.dt, d.nsamples, d.n_unpadded))[0]
    ps = spectrum.power_spectrum(out, 1.0 / d.nsamples)
    geo = (d.window_2, d.fundamental_idx_hi, d.harmonic_idx_hi)
    for k in range(5):
        for j in (0, d.window_2 // 16, d.window_2, 97, d.fundamental_idx_hi - 1, d.fundamental_idx_hi):
            sparse = np.full_like(ps, np.nan)
            bins = harmonic.harmonic_bins(j, k, *geo)
            sparse[bins] = ps[bins]
            want = harmonic.harmonic_power_at(ps, j, k, *geo)
            assert harmonic.harmonic_power_at(sparse, j, k, *geo).tobytes() == want.tobytes(), (j, k)


@pytest.mark.parametrize("chunk", [1, 3, 4])
def test_rescore_winners_from_a_device_series_is_the_host_pass(toplist, monkeypatch, chunk):
    """The pass resamples the 4 winners on the series' device (here the
    plain versions) in launches of ``chunk``: one template a launch, a
    short last launch, or one whole launch.  The same bytes as the host
    oracle's pass, and as the JAX package's."""
    ts, d, cands, emitted = toplist
    monkeypatch.setattr(rescore, "DEVICE_CHUNK", chunk)
    assert metrics.configure(force=True) and tracing.configure(force=True)
    try:
        got, n_got = rescore.rescore_winners(torch.from_numpy(ts), cands, emitted, d)
        counters = metrics.snapshot()["counters"]
        launches = [r["args"]["templates"] for r in tracing.events() if r.get("name") == "rescore.device-resample"]
    finally:
        metrics.finish(0)
        tracing.finish(0)
    host, n_host = host_rescore(ts, cands, emitted, d)
    want, _ = jax_rescore.rescore_winners(ts, cands, emitted, d)
    assert n_got == n_host == rescore.unique_winner_count(emitted) == 4
    assert launches == {1: [1, 1, 1, 1], 3: [3, 1], 4: [4]}[chunk]
    assert got.tobytes() == host.tobytes() == want.tobytes()
    for name in ("rescore.device_resamples", "rescore.device_ffts", "rescore.templates"):
        assert counters[name]["value"] == n_got, name


@pytest.fixture
def wu_files(tmp_path):
    ts = synthetic_timeseries(N, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    paths = {k: str(tmp_path / v) for k, v in dict(wu="test.bin4", bank="bank.dat").items()}
    write_workunit(paths["wu"], ts, tsample_us=DT * 1e6, scale=1.0, dm=55.5)
    write_template_bank(paths["bank"], small_bank(P_true=2.2, tau_true=0.04, psi_true=1.2))
    paths["tmp"] = tmp_path
    return paths


def _body(path) -> bytes:
    """A result file's bytes less its ``% Date:`` line."""
    with open(path, "rb") as f:
        return b"".join(ln for ln in f if not ln.startswith(b"% Date:"))


def _host_pass(monkeypatch):
    """``rescore_winners`` replaced by the host oracle's pass over the
    host copy of the session's series (``torch_parity.host_rescore``)."""
    monkeypatch.setattr(rescore, "rescore_winners", lambda ts, *a: host_rescore(ts.cpu().numpy(), *a))


def test_an_exact_sine_run_rescores_with_the_lut_oracle(wu_files, monkeypatch):
    """Under --exact-sin the search takes the exact sine, but the oracle
    (and so the rescoring) the LUT's: the device-resampled pass writes the
    host oracle pass's file byte for byte."""
    from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs, run_search

    def run(name):
        return run_search(DriverArgs(
            inputfile=wu_files["wu"], templatebank=wu_files["bank"], window=200, batch_size=2, use_lut=False,
            outputfile=str(wu_files["tmp"] / f"{name}.cand"), checkpointfile=str(wu_files["tmp"] / f"{name}.cpt"),
            device="cpu",
        ))

    assert metrics.configure(force=True)
    try:
        assert run("device") == 0
        counters = metrics.snapshot()["counters"]
    finally:
        metrics.finish(0)
    assert counters["rescore.device_resamples"]["value"] == counters["rescore.templates"]["value"] > 0
    assert counters["rescore.device_ffts"]["value"] == counters["rescore.templates"]["value"]
    _host_pass(monkeypatch)
    assert run("host") == 0
    files = [_body(wu_files["tmp"] / f"{n}.cand") for n in ("device", "host")]
    assert files[0] == files[1] and b"%DONE%" in files[0]


def _bank_260(path, n=260):
    rng = np.random.default_rng(3)
    P = np.concatenate([[1000.0, 2.2], rng.uniform(1.6, 3.0, n - 2)])
    tau = np.concatenate([[0.0, 0.04], rng.uniform(0.0, 0.09, n - 2)])
    psi = np.concatenate([[0.0, 1.2], rng.uniform(0.0, 2 * np.pi, n - 2)])
    from boinc_app_eah_brp_tpu_torch.io import TemplateBank

    write_template_bank(path, TemplateBank(P, tau, psi))


@pytest.mark.parametrize("big", [False, True])
def test_a_served_end_of_run_pass_resamples_every_template_on_the_device(wu_files, monkeypatch, big):
    """On a served workunit every template of the end-of-run pass is
    device-resampled and takes its spectrum there, and no host resample
    runs: the fixture bank, and 260 templates with a checkpoint every
    batch.  The file is the host oracle pass's."""
    from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs
    from boinc_app_eah_brp_tpu_torch.serving import FleetServer

    if big:
        _bank_260(wu_files["bank"])
        monkeypatch.setenv("ERP_CHECKPOINT_PERIOD", "0")

    def args(name):
        return DriverArgs(
            inputfile=wu_files["wu"], templatebank=wu_files["bank"], window=200, batch_size=16 if big else 2,
            outputfile=str(wu_files["tmp"] / f"{name}.cand"), checkpointfile=str(wu_files["tmp"] / f"{name}.cpt"),
            device="cpu",
        )

    assert metrics.configure(force=True) and tracing.configure(force=True)
    try:
        with FleetServer(name="t-rescore", device="cpu") as server:
            assert server.result(server.submit(args("device"))).ok
        counters = {k: v["value"] for k, v in metrics.snapshot()["counters"].items()}
        spans = [r["name"] for r in tracing.events() if r.get("kind") == "span"]
    finally:
        metrics.finish(0)
        tracing.finish(0)
    n = counters["rescore.templates"]
    assert counters["rescore.device_resamples"] == counters["rescore.device_ffts"] == n > 0
    assert spans.count("rescore.fft") == n
    assert "rescore.resample" not in spans
    assert spans.count("rescore.device-resample") == -(-n // rescore.DEVICE_CHUNK)
    if big:
        assert counters["checkpoint.count"] >= 17  # 17 batches, each checkpointed
    _host_pass(monkeypatch)
    with FleetServer(name="t-rescore-host", device="cpu") as server:
        assert server.result(server.submit(args("host"))).ok
    files = [_body(wu_files["tmp"] / f"{n}.cand") for n in ("device", "host")]
    assert files[0] == files[1] and b"%DONE%" in files[0]


@pytest.mark.parametrize("extra_workers", [None, 4])
def test_device_passes_on_many_threads_give_the_host_oracle_scores(toplist, monkeypatch, extra_workers):
    """The device pass keeps each template's series and spectrum on the
    device, so passes on several threads at once (a resident server's
    sessions) share nothing but the plan cache: two threads, or more
    threads than cores, each with its own templates, under a short
    switch interval, each give the host oracle's scores."""
    import sys
    import threading

    ts, d, _, _ = toplist
    b = np.loadtxt(BANK200)[:30]
    todo = {rescore._template_key(P, tau, psi): {(k, f0) for k in range(5) for f0 in (97, 101, 150)}
            for P, tau, psi in b}
    monkeypatch.setattr(rescore, "DEVICE_CHUNK", 7)
    n_threads = 2 if extra_workers is None else (os.cpu_count() or 1) + extra_workers
    tpls = sorted(todo)
    shares = [tpls[i::n_threads] for i in range(n_threads)]
    got: dict = {}
    lock = threading.Lock()

    def one(mine):
        rows = [resample.ResampleParams.from_template(*t, d.dt, d.nsamples, d.n_unpadded) for t in mine]
        out = {t: rescore._score_series(s, d, t, todo[t])
               for t, (s, _, _) in zip(mine, rescore.device_series(torch.from_numpy(ts), rows))}
        with lock:
            got.update(out)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=one, args=(m,)) for m in shares]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert got.keys() == todo.keys()
    for tpl, pairs in todo.items():
        want = rescore._score_template(ts, d, tpl, pairs)
        assert {p: v.tobytes() for p, v in got[tpl].items()} == {p: v.tobytes() for p, v in want.items()}, tpl


def test_a_cpu_session_of_256_templates_takes_every_winner_through_the_device_pass(wu_files, monkeypatch):
    """A command-line session whose series is on the CPU, with 260
    templates and a checkpoint every batch, takes every winner's series
    and spectrum through the device pass at the end of the run, as a
    session on a card does (``tests/test_torch_cuda.py``)."""
    from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs, run_search

    _bank_260(wu_files["bank"])
    monkeypatch.setenv("ERP_CHECKPOINT_PERIOD", "0")
    assert metrics.configure(force=True)
    try:
        assert run_search(DriverArgs(
            inputfile=wu_files["wu"], templatebank=wu_files["bank"], window=200, batch_size=16,
            outputfile=str(wu_files["tmp"] / "cpu.cand"), checkpointfile=str(wu_files["tmp"] / "cpu.cpt"),
            device="cpu",
        )) == 0
        counters = {k: v["value"] for k, v in metrics.snapshot()["counters"].items()}
    finally:
        metrics.finish(0)
    n = counters["rescore.templates"]
    assert counters["rescore.device_resamples"] == counters["rescore.device_ffts"] == n > 0
    assert counters["checkpoint.count"] >= 17


def test_a_session_without_a_checkpoint_file_copies_the_state_to_the_host_once(wu_files, monkeypatch):
    """260 templates on the CPU, no checkpoint file, a checkpoint due
    every batch: no checkpoint is taken, so (M, T) comes to the host once,
    for the final toplist, and ``search.d2h_bytes`` is one state's bytes."""
    from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs, run_search
    from boinc_app_eah_brp_tpu_torch.runtime.session import Session

    _bank_260(wu_files["bank"])
    monkeypatch.setenv("ERP_CHECKPOINT_PERIOD", "0")
    state_bytes = []
    real_execute = Session.execute

    def execute(self, *a, **k):
        state_bytes.append(sum(t.numel() * t.element_size() for t in self.state))
        return real_execute(self, *a, **k)

    monkeypatch.setattr(Session, "execute", execute)
    assert metrics.configure(force=True)
    try:
        assert run_search(DriverArgs(
            inputfile=wu_files["wu"], templatebank=wu_files["bank"], window=200, batch_size=16,
            outputfile=str(wu_files["tmp"] / "nocp.cand"), device="cpu",
        )) == 0
        counters = {k: v["value"] for k, v in metrics.snapshot()["counters"].items()}
    finally:
        metrics.finish(0)
    assert len(state_bytes) == 1 and state_bytes[0] > 0
    assert counters["search.d2h_bytes"] == state_bytes[0]
    assert counters.get("checkpoint.count", 0) == 0
    assert counters["rescore.device_resamples"] == counters["rescore.templates"] > 0
