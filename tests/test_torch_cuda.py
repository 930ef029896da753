"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, at small shapes with ragged edges.
Skips without a CUDA card; run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest.py imports jax, which the card's
machine need not have).

Tolerance: bitwise (kernel and plain version run the same float32
operations; the fold's adds are in one fixed order).
"""

import os

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu_torch.models import search
from boinc_app_eah_brp_tpu_torch.ops import harmonic, kernels, median, native_median, resample

pytestmark = pytest.mark.cuda

BANK200 = os.path.join(os.path.dirname(__file__), "golden", "bank200.txt")
DT = 65.476e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _params(rows, dev):
    b = np.loadtxt(BANK200)[rows]
    return resample.stream_params(*search.bank_params_host(b[:, 0], b[:, 1], b[:, 2], DT), device=dev)


def _edge_rows(n, dev):
    """Null templates (tau 0) whose integer S0 = K puts n_steps = n-2-K just
    below, on and just above the start of a unit, in both parities (so the
    cut crosses a unit, or falls on its edge)."""
    e = 2 * (n // 2 // resample.UNIT // 2) * resample.UNIT
    K = np.array([n - 2 - c for c in (e - 2, e - 1, e, e + 1, e + 2)], dtype=np.float32)
    return resample.stream_params(np.zeros(5), np.ones(5), np.zeros(5), K, device=dev)


def _off_table_rows(dev):
    """Templates whose LUT argument leaves [0, 2^23): a negative phase at
    the start, and a phase past 2^23 / 64 LUT periods at the end (the
    kernel's conversion path)."""
    return resample.stream_params([0.2, 0.1], [1e-3, 3e5], [-3.0, 0.5], [0.0, 0.0], device=dev)


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("renorm", [None, 3.25])
# past 2^23 samples the kernel takes its wide path (conversions, no 2^23
# add); past 2^24 the interleaved index is no longer exact in float32 and
# both sides round it the same way
@pytest.mark.parametrize("n", [1 << 16, 70002, (1 << 23) + 2, (1 << 24) + 6])
def test_resample_and_fftprep_match_plain(dev, n, renorm, T):
    """Kernel A's raw, n_steps and mean bitwise against the plain version,
    for bank templates (whose cut lies inside a unit), for cuts placed
    around a unit edge and for LUT arguments outside [0, 2^23); then
    kernel B on its outputs."""
    ts = torch.from_numpy(np.random.default_rng(n).normal(0, 1, n).astype(np.float32)).to(dev)
    rows = [_params([0, 5, 17, 57, 199], dev), _edge_rows(n, dev), _off_table_rows(dev)]
    for params in rows:
        params = params[:T].contiguous()
        key = "resample_t1" if T == 1 else "resample"
        before = kernels.launch_counts[key]
        raw, n_steps, mean = resample.resample_stream(ts, params, n_unpadded=n, dt=DT, renorm=renorm)
        assert kernels.launch_counts[key] == before + 1
        raw_p, n_steps_p, mean_p = resample.resample_stream_plain(ts, params, n_unpadded=n, dt=DT, renorm=renorm)
        assert torch.equal(raw, raw_p)
        assert torch.equal(n_steps, n_steps_p)
        assert torch.equal(mean, mean_p)
        nsamples = 3 * n
        x = resample.fftprep(raw, n_steps, mean, nsamples=nsamples)
        assert torch.equal(x, resample.fftprep_plain(raw, n_steps, mean, nsamples=nsamples))


def _positive_series(n, seed, dev):
    """An unwhitened (positive) series, as the exact mean is taken of."""
    return torch.from_numpy(np.random.default_rng(seed).normal(5.0, 1.0, n).astype(np.float32)).to(dev)


def _assert_exact_mean_equal(got, want):
    assert torch.equal(got[0].cpu(), want[0].cpu())
    assert torch.equal(got[1].cpu().view(torch.int32), want[1].cpu().view(torch.int32))


@pytest.mark.parametrize("N", [1, 33, 200])
@pytest.mark.parametrize("n", [1 << 16, 70002, 1 << 18])
def test_exact_mean_matches_plain(dev, n, N):
    """The exact-mean kernel over bank200 templates, in one launch:
    n_steps and mean bitwise against the host oracle, n_steps equal to
    kernel A's."""
    ts = _positive_series(n, n + N, dev)
    params = _params(list(range(N)), dev)
    before = kernels.launch_counts["serial_mean"]
    got = resample.exact_mean_params(ts, params, n_unpadded=n, dt=DT)
    assert kernels.launch_counts["serial_mean"] == before + 1
    _assert_exact_mean_equal(got, resample.exact_mean_params_plain(ts, params, n_unpadded=n, dt=DT))
    assert torch.equal(got[0], resample.resample_stream(ts, params, n_unpadded=n, dt=DT)[1])


def _exact_edge_rows(n, dev):
    """Null templates whose integer S0 = K puts n_steps = n-2-K at -1, 0,
    odd counts, around the edges of a unit (512 samples) and of the
    longest stage (2048), and in the middle of a unit; then bank
    templates."""
    counts = [-1, 0, 1, 7, 511, 512, 513, 2047, 2048, 2049, 512 * 50 + 301, n - 2]
    K = np.array([n - 2 - c for c in counts], dtype=np.float32)
    null = resample.stream_params(np.zeros(len(K)), np.ones(len(K)), np.zeros(len(K)), K, device=dev)
    return torch.cat([null, _params(list(range(0, 200, 10)), dev)])


# N sets the templates a block holds: 1, 2 (four units a stage), 16 (two)
# and 17 (one), on 132 SMs
@pytest.mark.parametrize("N", [32, 200, 2112, 4300])
def test_exact_mean_edges_match_plain(dev, N):
    """Edge counts beside bank templates in the same blocks, the rows
    tiled to N: each row bitwise its plain version, n_steps equal to
    kernel A's."""
    n = 70002
    ts = _positive_series(n, N, dev)
    rows = _exact_edge_rows(n, dev)
    reps = -(-N // rows.shape[0])
    params = rows.repeat(reps, 1)[:N].contiguous()
    got = resample.exact_mean_params(ts, params, n_unpadded=n, dt=DT)
    want = [w.repeat(reps)[:N] for w in resample.exact_mean_params_plain(ts, rows, n_unpadded=n, dt=DT)]
    _assert_exact_mean_equal(got, want)
    assert torch.equal(got[0][: rows.shape[0]], resample.resample_stream(ts, rows, n_unpadded=n, dt=DT)[1])


def test_exact_mean_wide_series(dev):
    """Past 2^23 samples the kernel makes its samples by kernel A's wide
    path (conversions, no 2^23 add)."""
    n = (1 << 23) + 2
    ts = _positive_series(n, 3, dev)
    null = resample.stream_params(np.zeros(2), np.ones(2), np.zeros(2), [0.0, 5.0], device=dev)
    params = torch.cat([_params([0, 57, 199], dev), null])
    got = resample.exact_mean_params(ts, params, n_unpadded=n, dt=DT)
    _assert_exact_mean_equal(got, resample.exact_mean_params_plain(ts, params, n_unpadded=n, dt=DT))
    assert torch.equal(got[0], resample.resample_stream(ts, params, n_unpadded=n, dt=DT)[1])


@pytest.mark.parametrize("L,fund_hi,harm_hi", [(98305, 5149, 82388), (5001, 301, 4817)])
def test_fold_matches_plain(dev, L, fund_hi, harm_hi):
    g = torch.Generator(device="cpu").manual_seed(L)
    ps = torch.empty((3, L)).exponential_(generator=g).to(dev)
    got = harmonic.sumspec_batch(ps, fund_hi=fund_hi, harm_hi=harm_hi)
    assert torch.equal(got, harmonic.sumspec_batch_plain(ps, fund_hi=fund_hi, harm_hi=harm_hi))


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize(
    "L,fund_hi,harm_hi",
    # the last geometry's fold reads past the spectrum: 16W + 16 = 2064 > L
    [(98305, 5149, 82388), (5001, 301, 4817), (2049, 127, 1949)],
)
def test_fold_spectrum_matches_plain(dev, T, L, fund_hi, harm_hi):
    rng = np.random.default_rng(L + T)
    F = (rng.normal(size=(T, L)) + 1j * rng.normal(size=(T, L))).astype(np.complex64)
    F = torch.from_numpy(F).to(dev)
    n = 2 * (L - 1)
    before = kernels.launch_counts["fold_spectrum"]
    got = harmonic.sumspec_spectrum(F, nsamples=n, fund_hi=fund_hi, harm_hi=harm_hi)
    assert kernels.launch_counts["fold_spectrum"] == before + 1
    want = harmonic.sumspec_spectrum_plain(F, nsamples=n, fund_hi=fund_hi, harm_hi=harm_hi)
    assert torch.equal(got, want)


def _median_input(n, seed, kind="draws"):
    """Non-negative float32 with zeros and ties (ops/median.py's keys are
    the float's bits), or a ramp up or down (the median moves one rank an
    output), or a constant (only the position orders the keys)."""
    if kind == "ascending":
        return np.arange(n, dtype=np.float32) * np.float32(0.25)
    if kind == "descending":
        return np.arange(n, 0, -1, dtype=np.float32) * np.float32(0.25)
    if kind == "constant":
        return np.full(n, 1.5, dtype=np.float32)
    x = np.random.default_rng(seed).exponential(1.0, n).astype(np.float32)
    x[::13] = 0.0
    x[n // 3 : n // 3 + n // 10] = np.round(x[n // 3 : n // 3 + n // 10], 1)
    return x


_MEDIAN_CASES = [
    # odd and even windows, the last tile partial, exactly full (n_out 1024)
    # and one past; windows on both sides of the shared-memory limit
    # (15,361) and one far above it
    (5000, 1), (5000, 2), (5000, 3), (70001, 999), (70001, 1000), (2023, 1000), (2024, 1000),
    (40000, 15361), (40000, 15362), (100000, 40001),
    # n_out 4,005: a multiple neither of a thread's run nor of a tile
    (5003, 999),
] + [(n, w, kind) for kind in ("ascending", "descending", "constant")
     for n, w in ((5003, 1), (5003, 2), (70001, 999), (70001, 1000), (100000, 40001))]


@pytest.mark.parametrize(
    "n,window,kind",
    [c if len(c) == 3 else (*c, "draws") for c in _MEDIAN_CASES],
    ids=["-".join(map(str, c)) for c in _MEDIAN_CASES],
)
def test_median_matches_plain(dev, n, window, kind):
    x = torch.from_numpy(_median_input(n, n + window, kind)).to(dev)
    # the kernel takes its shared-memory instantiation up to window 15,361
    assert (median.scratch_entries(x.device, n, window) == 0) == (window <= 15361)
    before = kernels.launch_counts["median"]
    got = median.running_median(x, bsize=window)
    assert kernels.launch_counts["median"] == before + 1
    want = median.running_median_plain(x, bsize=window, block=2048)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if 2 <= window <= 1000:  # and the native rngmed (windows of 2 and more), bitwise on non-negative input
        assert got.cpu().numpy().tobytes() == native_median.running_median(x.cpu().numpy(), window).tobytes()


def test_median_refuses_what_it_does_not_take(dev):
    with pytest.raises(ValueError, match="window larger than input"):
        median.running_median(torch.zeros(9, device=dev), bsize=10)
    with pytest.raises(ValueError, match="contiguous float32"):
        median.running_median(torch.zeros(20, device=dev)[::2], bsize=3)


def test_whitening_on_the_card_takes_the_device_median(dev, monkeypatch):
    """At the palfa200 geometry (2^22 samples, window 1000, padding 3, the
    benchmark's two zap ranges, ``tools/bench.py::ZAP_RANGES``), a seeded
    workunit whitened on the card with ``ERP_MEDIAN`` unset takes the
    device median: one kernel launch, one ``whiten.device_medians`` in the
    run report, no call of the host median; the series is bitwise the one
    ``ERP_MEDIAN=native`` gives, which runs the host median once and counts
    no device median."""
    from boinc_app_eah_brp_tpu_torch.ops.whiten import whiten_and_zap
    from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
    from boinc_app_eah_brp_tpu_torch.runtime import metrics
    from boinc_app_eah_brp_tpu_torch.tools import bench

    n = 1 << 22
    x = np.clip(np.round(np.random.default_rng(2026).normal(4.0, 1.5, n)), 0, 15).astype(np.float32)
    cfg = SearchConfig(f0=400.0, padding=3.0, fA=0.08, window=1000, white=True)
    d = DerivedParams.derive(n, DT * 1e6, cfg)
    zap = np.array(bench.ZAP_RANGES, dtype=np.float64)
    host_calls = []
    real = native_median.running_median
    monkeypatch.setattr(native_median, "running_median", lambda *a, **k: host_calls.append(1) or real(*a, **k))
    out, counted = {}, {}
    assert metrics.configure(force=True)
    try:
        for path in (None, "native"):
            if path is None:
                monkeypatch.delenv("ERP_MEDIAN", raising=False)
            else:
                monkeypatch.setenv("ERP_MEDIAN", path)
            launches, hosts = kernels.launch_counts["median"], len(host_calls)
            before = metrics.snapshot()["counters"].get("whiten.device_medians", {}).get("value", 0)
            out[path] = whiten_and_zap(x, d, cfg, zap, device=dev)
            torch.cuda.synchronize(dev)
            after = metrics.snapshot()["counters"].get("whiten.device_medians", {}).get("value", 0)
            counted[path] = (after - before, kernels.launch_counts["median"] - launches, len(host_calls) - hosts)
    finally:
        metrics.finish(0)
    assert counted[None] == (1, 1, 0)
    assert counted["native"] == (0, 0, 1)
    assert out[None].is_cuda and out[None].cpu().numpy().tobytes() == out["native"].cpu().numpy().tobytes()


def _r2c_input(T, nsamples, seed):
    """A series as kernel B writes it: noise with a pulse train, and a
    constant pad past four fifths."""
    x = np.random.default_rng(seed).normal(0.0, 1.0, (T, nsamples)).astype(np.float32)
    x[:, ::97] += 6.0
    x[:, 4 * nsamples // 5 :] = 0.25
    return x


def _r2c_gap(F: torch.Tensor, ref: torch.Tensor) -> float:
    return float((F - ref).abs().max() / ref.abs().max())


# T = 4 and 5 take pass 2's rows in every sector phase of F (template t's
# spectrum starts t mod 4 bins into a 32-byte sector)
@pytest.mark.parametrize("T", [1, 3, 4, 5])
# M = 3 * 2^15 (the card tests' search geometry), 2^15, and the production
# 3 * 2^21 (nsamples 12,582,912), there at T = 2 in place of 3
@pytest.mark.parametrize("nsamples", [3 << 16, 1 << 16, 12582912])
def test_rfft_kernel_matches_cufft(dev, nsamples, T):
    """The search's R2C (``csrc/rfft.cu``) against cuFFT's through
    ``torch.fft.rfft``: max |dF| <= 1e-5 max |F| (float32 sums in another
    order), template by template, the whole spectrum in torch's layout.
    The pulse train makes max |F| 25-330 times rms |F|, so both are also
    held against the float64 transform: the kernel's rms error at most
    cuFFT's, its largest error at most 1.5 times cuFFT's (on the card
    0.6 and 0.7-1.0 times).  One ``fft_r2c`` launch a call, and two calls
    on copies of one series give the same bits (the kernel overwrites its
    input)."""
    from boinc_app_eah_brp_tpu_torch.ops import spectrum

    if nsamples == 12582912:
        T = 2 if T == 3 else T
    x = torch.from_numpy(_r2c_input(T, nsamples, nsamples + T)).to(dev)
    ref = torch.fft.rfft(x)
    before = kernels.launch_counts["fft_r2c"]
    F = spectrum.rfft_r2c(x.clone())
    F2 = spectrum.rfft_r2c(x.clone())
    assert kernels.launch_counts["fft_r2c"] == before + 2
    torch.cuda.synchronize(dev)
    assert F.shape == ref.shape and F.dtype == ref.dtype
    assert [F[t].data_ptr() // 8 % 4 for t in range(T)] == [t % 4 for t in range(T)]
    for t in range(T):
        assert _r2c_gap(F[t], ref[t]) <= 1e-5, t
    assert torch.equal(torch.view_as_real(F), torch.view_as_real(F2))
    exact = torch.fft.rfft(x.double())
    dk, dc = (F.to(torch.complex128) - exact).abs(), (ref.to(torch.complex128) - exact).abs()
    assert dk.square().mean() <= dc.square().mean()
    assert dk.max() <= 1.5 * dc.max()


def test_rfft_kernel_matches_its_plain_version(dev):
    """The kernel and ``rfft_fourstep_plain`` on the same CUDA series (the
    plain version's sub-transforms are cuFFT's), to the same rule."""
    from boinc_app_eah_brp_tpu_torch.ops import spectrum

    x = torch.from_numpy(_r2c_input(3, 3 << 16, 5)).to(dev)
    plain = spectrum.rfft_fourstep_plain(x)
    assert _r2c_gap(spectrum.rfft_r2c(x), plain) <= 1e-5


def test_search_rfft_routes_an_unsupported_length_to_cufft(dev):
    """M = 5 * 2^10 has no split: the step's transform goes to cuFFT (a
    plan made through ``planned_fft``), with no ``fft_r2c`` launch and no
    ``fft.r2c_kernel_batches``; a supported length counts one of each and
    makes no plan."""
    from boinc_app_eah_brp_tpu_torch.ops import spectrum
    from boinc_app_eah_brp_tpu_torch.runtime import metrics

    plans = []
    kernels.plan_listeners.append(plans.append)
    assert metrics.configure(force=True)
    try:
        counted = {}
        for nsamples in (10 << 10, 3 << 16):
            x = torch.from_numpy(_r2c_input(2, nsamples, 9)).to(dev)
            torch.backends.cuda.cufft_plan_cache[dev.index].clear()
            kernels.planned_keys.clear()
            del plans[:]
            launches = kernels.launch_counts["fft_r2c"]
            before = metrics.snapshot()["counters"].get("fft.r2c_kernel_batches", {}).get("value", 0)
            F = spectrum.search_rfft(x.clone())  # the kernel overwrites its input
            torch.cuda.synchronize(dev)
            after = metrics.snapshot()["counters"].get("fft.r2c_kernel_batches", {}).get("value", 0)
            counted[nsamples] = (kernels.launch_counts["fft_r2c"] - launches, after - before, sum(plans))
            assert _r2c_gap(F, torch.fft.rfft(x)) <= 1e-5
    finally:
        metrics.finish(0)
        kernels.plan_listeners.remove(plans.append)
    assert spectrum.r2c_split(10 << 10) is None
    assert counted[10 << 10][:2] == (0, 0) and counted[10 << 10][2] >= 1
    assert counted[3 << 16] == (1, 1, 0)


def test_rfft_kernel_refuses_what_it_does_not_take(dev):
    """The kernel's wrapper raises on a dtype other than float32, a
    non-contiguous series and a length without a split."""
    from boinc_app_eah_brp_tpu_torch.ops import spectrum

    x = torch.zeros((2, 3 << 16), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="float32"):
        spectrum.rfft_r2c(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        spectrum.rfft_r2c(torch.zeros((3 << 16, 2), dtype=torch.float32, device=dev).t())
    with pytest.raises(ValueError, match="split"):
        spectrum.rfft_r2c(torch.zeros((2, 10 << 10), dtype=torch.float32, device=dev))


# the card tests' search length (every bin, and the fold's 16W + 16 of
# test_fold_spectrum_matches_plain's geometry) and the production length at
# its fold's read (W = 329,552)
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("nsamples,fund_hi", [(3 << 16, 0), (3 << 16, 5149), (12582912, 329552)])
def test_rfft_power_pass_is_the_power_of_the_complex_pass(dev, nsamples, fund_hi, T):
    """``search_power`` (``erp_fft_r2c_power``) bitwise the power of the
    complex pass's spectrum (``power_from_rfft``, the epilogue kernel C
    forms) at every bin below ``read``, DC 0; one ``fft_r2c_power`` launch
    a call and none of ``fft_r2c``; two calls give the same bits."""
    from boinc_app_eah_brp_tpu_torch.ops import spectrum

    L = nsamples // 2 + 1
    read = harmonic.fold_read(L, harmonic.state_width(fund_hi)) if fund_hi else L
    assert fund_hi == 0 or read < L
    x = torch.from_numpy(_r2c_input(T, nsamples, nsamples + T + fund_hi)).to(dev)
    want = spectrum.power_from_rfft(spectrum.rfft_r2c(x.clone())[:, :read], nsamples=nsamples)
    before = dict(kernels.launch_counts)
    p = spectrum.search_power(x.clone(), read=read)
    p2 = spectrum.search_power(x.clone(), read=read)
    assert kernels.launch_counts["fft_r2c_power"] == before["fft_r2c_power"] + 2
    assert kernels.launch_counts["fft_r2c"] == before["fft_r2c"]
    torch.cuda.synchronize(dev)
    assert p.shape == (T, read) and p.dtype == torch.float32
    assert (p[:, 0] == 0).all()
    assert torch.equal(p.view(torch.int32), want.view(torch.int32))
    assert torch.equal(p.view(torch.int32), p2.view(torch.int32))


def _small_geom(n, b):
    from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig

    d = DerivedParams.derive(n, DT * 1e6, SearchConfig(padding=3.0, f0=400.0, window=1000))
    return search.SearchGeometry.from_derived(
        d,
        max_slope=search.max_slope_for_bank(b[:, 0], b[:, 1]),
        lut_step=search.lut_step_for_bank(b[:, 0], DT),
        lut_tiles=search.lut_tiles_for_bank(b[:, 0], b[:, 2], n, DT),
    )


# n = 2^16: nsamples 196,608 has a split (32 x 3072); n = 4096: 12,288 has
# none (N1 = 2), so the step keeps cuFFT
@pytest.mark.parametrize("n", [1 << 16, 4096])
def test_bank_step_routes_the_power_pass_by_length(dev, n, monkeypatch):
    """At a split length a ``BankStep`` batch takes the power pass and C's
    float entry: per batch one ``fft_r2c_power``, one ``fold``, no
    ``fold_spectrum`` and no ``fft_r2c``, and one ``fft.r2c_power_batches``
    beside one ``fft.r2c_kernel_batches``; its (M, T) bitwise those of the
    complex route (``rfft_r2c`` and ``sumspec_spectrum``) on the same batch.
    A length without a split keeps cuFFT and C's complex entry, and counts
    none of the power pass's launches or batches."""
    from boinc_app_eah_brp_tpu_torch.ops import spectrum
    from boinc_app_eah_brp_tpu_torch.runtime import metrics

    b = np.loadtxt(BANK200)[[0, 5, 17, 57]]
    geom = _small_geom(n, b)
    split = spectrum.r2c_split(geom.nsamples) is not None
    assert split == (n == 1 << 16)
    ts = torch.from_numpy(np.random.default_rng(n).normal(0, 1, n).astype(np.float32)).to(dev)
    bank = search.upload_bank(search.bank_params_host(b[:, 0], b[:, 1], b[:, 2], DT), 4, dev)

    def counted(name):
        return metrics.snapshot()["counters"].get(name, {}).get("value", 0)

    names = ("fft_r2c_power", "fold", "fold_spectrum", "fft_r2c")
    batches = ("fft.r2c_power_batches", "fft.r2c_kernel_batches")
    assert metrics.configure(force=True)
    try:
        launches, before = dict(kernels.launch_counts), {c: counted(c) for c in batches}
        M, T = search.BankStep(geom, bank, 4)(ts, 0, 4)
        torch.cuda.synchronize(dev)
        got = {k: kernels.launch_counts[k] - launches[k] for k in names}
        got.update({c: counted(c) - before[c] for c in batches})
    finally:
        metrics.finish(0)
    if split:
        assert got == {"fft_r2c_power": 1, "fold": 1, "fold_spectrum": 0, "fft_r2c": 0,
                       "fft.r2c_power_batches": 1, "fft.r2c_kernel_batches": 1}, got
    else:
        assert got == {"fft_r2c_power": 0, "fold": 0, "fold_spectrum": 1, "fft_r2c": 0,
                       "fft.r2c_power_batches": 0, "fft.r2c_kernel_batches": 0}, got
    # the complex route on the same batch
    complex_route = spectrum.rfft_r2c if split else spectrum.search_rfft
    monkeypatch.setattr(search, "fold_input", lambda x, g: complex_route(x))
    Mc, Tc = search.BankStep(geom, bank, 4)(ts, 0, 4)
    assert torch.equal(M.view(torch.int32), Mc.view(torch.int32)) and torch.equal(T, Tc)


@pytest.mark.parametrize("exact_mean", [False, True])
def test_bank_step_card_matches_cpu(dev, exact_mean):
    """A search of a few batches on the card against the same search on
    the CPU: spectra from cuFFT and PyTorch's CPU FFT, so M to rtol 1e-4.
    Unwhitened (``exact_mean``, a series of mean 1), the run launches the
    exact mean once, ahead of its batches."""
    n = 1 << 16
    b = np.loadtxt(BANK200)[:6]
    P, tau, psi0 = b[:, 0], b[:, 1], b[:, 2]
    from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig

    d = DerivedParams.derive(n, DT * 1e6, SearchConfig(padding=3.0, f0=400.0, window=1000))
    geom = search.SearchGeometry.from_derived(
        d,
        max_slope=search.max_slope_for_bank(P, tau),
        lut_step=search.lut_step_for_bank(P, DT),
        lut_tiles=search.lut_tiles_for_bank(P, psi0, n, DT),
        exact_mean=exact_mean,
    )
    ts = np.random.default_rng(1).normal(float(exact_mean), 1, n).astype(np.float32)
    out = {}
    for device in ("cpu", dev):
        before = kernels.launch_counts["serial_mean"]
        M, T = search.run_bank(torch.from_numpy(ts).to(device), P, tau, psi0, geom, batch_size=4)
        if device != "cpu":
            assert kernels.launch_counts["serial_mean"] == before + int(exact_mean)
        out[str(device)] = (M.cpu().numpy(), T.cpu().numpy())
    (Mc, Tc), (Mg, Tg) = out["cpu"], out[str(dev)]
    np.testing.assert_allclose(Mg, Mc, rtol=1e-4, atol=1e-6)
    assert (Tg == Tc).mean() > 0.99


def test_steptime_bracket_reads_events_without_a_sync(dev, monkeypatch, tmp_path):
    """The CUDA-event step bracket: no synchronize while the loop runs
    (each observe only queries its events), positive times once flushed."""
    from boinc_app_eah_brp_tpu_torch.runtime import steptime

    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: waits.append("device"))
    real_wait = torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda.Event, "synchronize", lambda self: (waits.append("event"), real_wait(self))[1])
    ctx = steptime.StepTimeContext(name="card")
    ctx.configure(force=True)
    rec = ctx.recorder(dev)
    x = torch.randn(16, 1 << 20, device=dev)
    for start in range(0, 40, 8):
        rec.begin()
        torch.fft.rfft(x).abs().amax()
        rec.observe(None, start, start + 8)
    assert waits == []
    rec.flush()
    records = ctx.records()
    assert [r["start"] for r in records] == [0, 8, 16, 24, 32]
    assert all(r["ms"] > 0 for r in records)
    ctx.finish(0)


def test_is_oom_on_a_real_out_of_memory(dev):
    from boinc_app_eah_brp_tpu_torch.runtime import resilience

    with pytest.raises(torch.cuda.OutOfMemoryError) as info:
        torch.empty(1 << 50, dtype=torch.uint8, device=dev)
    assert resilience.is_oom(info.value) and resilience.classify(info.value) == "transient"


def test_choose_batch_on_the_card(dev, monkeypatch, tmp_path):
    from boinc_app_eah_brp_tpu_torch.runtime import autobatch

    monkeypatch.delenv("ERP_BATCH", raising=False)
    monkeypatch.setenv(autobatch.SWEEP_ENV, str(tmp_path / "none.json"))
    lines = []
    b = autobatch.choose_batch(12_582_912, log=lines.append, device=dev)
    assert b in (8, 16, 32, 64, 128)
    assert len(lines) == 1 and lines[0].startswith(f"Batch size {b} (memory model, HBM budget ")
    assert autobatch.device_memory_budget(dev) > 0


@pytest.mark.parametrize("white", [False, True])
def test_warmed_scheduler_serves_without_builds_or_plans(dev, tmp_path, monkeypatch, white):
    """On a warmed Scheduler two same-geometry sessions make no kernel
    build and no new cuFFT plan (whitened: nor whitening's transforms),
    launch the main path's kernels, and give device memory back to the
    post-warm value.  A session whose second batch runs out of memory
    clears every plan and halves its batch: the plan it then makes (the
    rescoring's float64 transform; the batch step's R2C, ``csrc/rfft.cu``,
    plans nothing at either batch) counts though the plan cache is smaller
    than when its window opened.  The next session of the class, prepared
    on the prep thread meanwhile, replans whitening's transforms and counts
    that too; an unwhitened one has nothing left to replan."""
    from boinc_app_eah_brp_tpu_torch.io import TemplateBank, write_template_bank, write_workunit
    from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs
    from boinc_app_eah_brp_tpu_torch.runtime.scheduler import Scheduler, WarmSpec
    from boinc_app_eah_brp_tpu_torch.runtime.session import Session

    n = 1 << 16
    b = np.loadtxt(BANK200)[:10]
    bank = str(tmp_path / "bank.dat")
    write_template_bank(bank, TemplateBank(b[:, 0], b[:, 1], b[:, 2]))
    zap = tmp_path / "zap.txt"
    zap.write_text("50.0 51.0\n")
    rng = np.random.default_rng(5)
    for i in range(2):
        x = np.clip(np.round(rng.normal(4.0, 1.0, n)), 0, 15).astype(np.float32)
        write_workunit(str(tmp_path / f"wu{i}.bin4"), x, tsample_us=DT * 1e6, scale=1.0)

    def args(i, name, batch=4):
        return DriverArgs(
            inputfile=str(tmp_path / f"wu{i}.bin4"), outputfile=str(tmp_path / f"{name}.cand"), templatebank=bank,
            checkpointfile=str(tmp_path / f"{name}.cpt"), window=200, white=white,
            zaplistfile=str(zap) if white else None, batch_size=batch, device=str(dev),
        )

    probe = Session(args(0, "probe")).prepare()
    spec = WarmSpec(probe.geom, 4)
    probe.release()
    del probe
    sched = Scheduler(device=str(dev))
    try:
        sched.warm([spec])
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        for i in range(2):
            kernels.reset_launch_counts()
            r = sched.process(args(i, f"served{i}"))
            torch.cuda.synchronize(dev)
            assert r.ok, r.error
            assert r.recompiles == 0
            assert r.step_cache_hits >= 1 and r.step_cache_misses == 0
            for k in ("resample", "fftprep", "fft_r2c_power", "fold"):
                assert kernels.launch_counts[k] > 0
            assert kernels.launch_counts["serial_mean"] == int(not white)
            assert torch.cuda.memory_allocated(dev) == base
        monkeypatch.setenv("ERP_FAULT_SPEC", "dispatch:oom@n=2")
        oom_s, again_s = sched.build_session(args(1, "oom")), sched.build_session(args(0, "replanned"))
        oom_f, again_f = sched.prepare_async(oom_s), sched.prepare_async(again_s)
        oom = sched.execute(oom_s, prep_future=oom_f)
        monkeypatch.delenv("ERP_FAULT_SPEC")
        assert oom.ok and oom.recompiles >= 1 and oom.step_cache_misses == 1, (oom.recompiles, oom.step_cache_misses)
        again = sched.execute(again_s, prep_future=again_f)
        assert again.ok and again.step_cache_hits >= 1
        assert again.recompiles >= 1 if white else again.recompiles == 0, again.recompiles
        torch.cuda.synchronize(dev)
        assert torch.cuda.memory_allocated(dev) == base
        assert len(sched.step_cache) == 2  # batches 4 and 2
    finally:
        sched.close()


@pytest.mark.parametrize("case", ["clean", "nan", "padded"])
def test_health_vector_card_matches_cpu(dev, case):
    """``batch_health_vec`` on the card equals the CPU's bit for bit (the
    counts and extrema are exact)."""
    rng = np.random.default_rng(3)
    sums = rng.exponential(3.0, (4, 5, 1000)).astype(np.float32)
    valid = np.array([True, True, case != "padded", case != "padded"])
    M = rng.exponential(5.0, (5, 1000)).astype(np.float32)
    if case == "nan":
        sums[1, 2, 7] = np.nan
        sums[2, 0, 3] = np.inf
        M[0, 9] = np.nan
    args = [torch.from_numpy(a) for a in (sums, valid, M)]
    want = search.batch_health_vec(*args)
    got = search.batch_health_vec(*(a.to(dev) for a in args))
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()


def test_template_sumspec_is_a_step_row_on_the_card(dev):
    """The sentinel probe's one-template search launches kernel A at T = 1,
    B, a batch-1 rfft with its power pass and C's float entry, and gives
    the batch step's row for that template."""
    n = 1 << 16
    b = np.loadtxt(BANK200)[[17]]
    from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig

    d = DerivedParams.derive(n, DT * 1e6, SearchConfig(padding=3.0, f0=400.0, window=1000))
    geom = search.SearchGeometry.from_derived(
        d,
        max_slope=search.max_slope_for_bank(b[:, 0], b[:, 1]),
        lut_step=search.lut_step_for_bank(b[:, 0], DT),
        lut_tiles=search.lut_tiles_for_bank(b[:, 0], b[:, 2], n, DT),
    )
    ts = torch.from_numpy(np.random.default_rng(2).normal(0, 1, n).astype(np.float32)).to(dev)
    before = dict(kernels.launch_counts)
    one = search.template_sumspec(ts, b[0, 0], b[0, 1], b[0, 2], geom)
    for k in ("resample_t1", "fftprep", "fft_r2c_power", "fold"):
        assert kernels.launch_counts[k] == before[k] + 1, k
    bank = search.upload_bank(search.bank_params_host(b[:, 0], b[:, 1], b[:, 2], DT), 2, dev)
    step = search.BankStep(geom, bank, 2, with_health=True)
    M, _, vec = step(ts, 0, 1)
    assert torch.equal(one, M)
    assert vec[0].item() == 0 and vec[1].item() == 0


def test_precision_audit_on_the_card(dev):
    """The precision audit with the port's kernels as its taps, on the CI
    fixture: the committed baseline's ceilings and floors hold on the card
    too (the baseline names the CPU backend, so it is applied without
    that key), and the tap proof: (M, T) byte-identical, no kernel build
    and no new cuFFT plan in the second pass."""
    import json

    from boinc_app_eah_brp_tpu_torch.runtime import metrics, precision

    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "PRECISION_BASELINE.json")) as f:
        baseline = json.load(f)
    baseline.pop("backend")
    metrics.configure(force=True)
    try:
        before = dict(kernels.launch_counts)
        doc = precision.run_audit(*precision.ci_fixture(), lanes=("f32",), device=dev)
    finally:
        metrics.finish(0)
    assert doc["backend"] == "cuda"
    assert precision.evaluate_baseline(doc, baseline) == []
    assert doc["lanes"]["f32"]["tap"]["recompiles_in_window"] == 0
    # the harmonic-sum tap is kernel C's float-power entry, the resample tap A at T = 1
    assert kernels.launch_counts["fold"] > before["fold"]
    assert kernels.launch_counts["resample_t1"] > before["resample_t1"]


def _slow_sine_rows(dev):
    """Orbits of 0.2 and 0.5 ms: past ~3.5 and ~8.4 s of the series every
    phase exceeds 105,615 rad, where CUDA's sinf takes its slow reduction."""
    return resample.stream_params([1e-6, 2e-6], [3.1e4, 1.26e4], [0.4, 5.0], [0.0, 0.0], device=dev)


@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("n", [1 << 16, 70002, (1 << 23) + 2])
def test_exact_sin_resample_matches_plain(dev, n, T):
    """Kernel A's exact-sine instantiation (``sinf``) bitwise against its
    plain version (``torch.sin`` on the card), for bank templates, for cuts
    around a unit edge and for phases on sinf's slow path; its own launch
    counts."""
    ts = torch.from_numpy(np.random.default_rng(n + 1).normal(0, 1, n).astype(np.float32)).to(dev)
    for params in (_params([0, 5, 17, 57, 199], dev), _edge_rows(n, dev), _slow_sine_rows(dev)):
        params = params[:T].contiguous()
        key = "resample_t1_exact" if params.shape[0] == 1 else "resample_exact"
        before = dict(kernels.launch_counts)
        got = resample.resample_stream(ts, params, n_unpadded=n, dt=DT, exact_sin=True)
        assert kernels.launch_counts[key] == before[key] + 1
        assert kernels.launch_counts["resample"] == before["resample"]
        want = resample.resample_stream_plain(ts, params, n_unpadded=n, dt=DT, exact_sin=True)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("N", [1, 33])
def test_exact_sin_exact_mean_matches_plain(dev, N):
    """The exact-sine exact mean bitwise against its plain version, its
    n_steps equal to kernel A's exact-sine ones; counted as
    ``serial_mean_exact``."""
    n = 70002
    ts = _positive_series(n, 7 + N, dev)
    params = torch.cat([_params(list(range(N)), dev), _slow_sine_rows(dev)])
    before = dict(kernels.launch_counts)
    got = resample.exact_mean_params(ts, params, n_unpadded=n, dt=DT, exact_sin=True)
    assert kernels.launch_counts["serial_mean_exact"] == before["serial_mean_exact"] + 1
    assert kernels.launch_counts["serial_mean"] == before["serial_mean"]
    _assert_exact_mean_equal(got, resample.exact_mean_params_plain(ts, params, n_unpadded=n, dt=DT, exact_sin=True))
    assert torch.equal(got[0], resample.resample_stream(ts, params, n_unpadded=n, dt=DT, exact_sin=True)[1])


@pytest.mark.parametrize("exact_mean", [False, True])
def test_two_shard_mesh_on_one_card_matches_run_bank(dev, exact_mean):
    """run_bank_sharded over two shards on the one card (a mesh that
    repeats it) gives run_bank's (M, T) bitwise, whitened and unwhitened."""
    import dataclasses

    from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
    from boinc_app_eah_brp_tpu_torch.parallel import make_mesh, run_bank_sharded

    n = 1 << 16
    b = np.loadtxt(BANK200)[:23]
    d = DerivedParams.derive(n, DT * 1e6, SearchConfig(padding=3.0, f0=400.0, window=1000))
    geom = search.SearchGeometry.from_derived(
        d,
        max_slope=search.max_slope_for_bank(b[:, 0], b[:, 1]),
        lut_step=search.lut_step_for_bank(b[:, 0], DT),
        lut_tiles=search.lut_tiles_for_bank(b[:, 0], b[:, 2], n, DT),
        exact_mean=exact_mean,
    )
    ts = _positive_series(n, 3, dev) if exact_mean else torch.from_numpy(
        np.random.default_rng(3).normal(0, 1, n).astype(np.float32)
    ).to(dev)
    ref = search.run_bank(ts, b[:, 0], b[:, 1], b[:, 2], geom, batch_size=4)
    got = run_bank_sharded(ts, b[:, 0], b[:, 1], b[:, 2], geom, make_mesh(devices=[dev, dev]), per_device_batch=2)
    assert all(torch.equal(x, y) for x, y in zip(ref, got))
    exact = dataclasses.replace(geom, use_lut=False)
    ref = search.run_bank(ts, b[:, 0], b[:, 1], b[:, 2], exact, batch_size=4)
    got = run_bank_sharded(ts, b[:, 0], b[:, 1], b[:, 2], exact, make_mesh(devices=[dev, dev]), per_device_batch=2)
    assert all(torch.equal(x, y) for x, y in zip(ref, got))


def test_server_backend_on_the_card_gives_the_cli_rows(dev, tmp_path, monkeypatch):
    """The fabric's ServerBackend on the card returns a candidate file
    whose rows are the command line's on the same workunit."""
    from boinc_app_eah_brp_tpu_torch.fabric import ServerBackend
    from boinc_app_eah_brp_tpu_torch.io import parse_result_file
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main
    from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs
    from boinc_app_eah_brp_tpu_torch.tools import _inputs

    monkeypatch.setenv("ERP_RESULT_DATE", _inputs.RESULT_DATE)
    wu = _inputs.fixture_workunit(str(tmp_path / "wu.bin4"), f_signal=33.0)
    bank = _inputs.fixture_bank(str(tmp_path / "bank.dat"))
    argv = f"-i {wu} -o {tmp_path / 'cli.cand'} -t {bank} -c {tmp_path / 'cli.cpt'} -B 200 --batch 2 --device cuda"
    assert main(argv.split()) == 0
    with ServerBackend(name="t-card") as backend:
        data = backend.compute(DriverArgs(inputfile=wu, outputfile=str(tmp_path / "srv.cand"), templatebank=bank,
                                          checkpointfile=str(tmp_path / "srv.cpt"), window=200, batch_size=2))
        assert backend.stats()["ok"] == 1
    assert data == open(tmp_path / "srv.cand", "rb").read()
    assert np.array_equal(parse_result_file(str(tmp_path / "srv.cand")).lines,
                          parse_result_file(str(tmp_path / "cli.cand")).lines)


def test_fabric_soak_on_the_card(dev, tmp_path, monkeypatch):
    """The fabric soak at its small size with the references on the card."""
    from boinc_app_eah_brp_tpu_torch.tools import fabric_soak

    monkeypatch.setenv("ERP_QUORUM_KEY", "card-test-key")
    monkeypatch.setenv("ERP_RESULT_DATE", "2008-11-12T00:00:00+00:00")
    monkeypatch.setenv("ERP_FABRIC_BACKEND", "server")
    assert fabric_soak.main(["--streams", "16", "--wus", "8", "--device", "cuda", "--workdir", str(tmp_path)]) == 0


def test_step_report_measures_the_card(dev, tmp_path, monkeypatch):
    """``tools/step_report.py`` on the card: the measured lane from
    ``torch.profiler``, an rfft stage made of cuFFT's kernels, and a
    document the validator accepts."""
    from boinc_app_eah_brp_tpu_torch.runtime import steptime
    from boinc_app_eah_brp_tpu_torch.tools import _inputs, step_report

    monkeypatch.setenv("ERP_RESULT_DATE", _inputs.RESULT_DATE)
    work = str(tmp_path)
    doc = step_report.run(step_report.fixture_args(work, "warm", "cuda"),
                          step_report.fixture_args(work, "wu", "cuda"), work)
    assert steptime.validate_step_report(doc) == []
    assert doc["device_lane"] == "measured" and doc["backend"] == torch.cuda.get_device_name(dev)
    stages = {s["stage"]: s["measured_ms_per_window"] for s in doc["stages"]}
    for name in ("resample", "fftprep", "rfft", "fold_spectrum"):
        assert stages[name] > 0, name
    rfft = [k for k in doc["device"]["kernels"] if k["stage"] == "rfft"]
    assert rfft and all(k["launches"] > 0 and k["ms"] > 0 for k in rfft)


def test_smoke_gate_passes_on_the_card(dev, tmp_path):
    """``tools/smoke.py``'s default gate with ``--device cuda`` at the
    fixture size, the main path's kernels launched."""
    from boinc_app_eah_brp_tpu_torch.tools import smoke

    work = str(tmp_path)
    res = smoke.gate(work, *smoke.fixture(work), device="cuda")
    assert res["coverage"] >= smoke.COVERAGE_MIN and res["health_checks"] > 0
    for name in ("resample", "fftprep", "fold_spectrum", "serial_mean"):
        assert res["launches"].get(name, 0) > 0, name


def _production_toplist(dev, seed):
    """The whitened production workunit of ``seed`` (2^22 samples, the
    bank200 pulsar injected), its geometry, and the toplist and winners
    of bank200 searched over it at batch 32 on the card."""
    from boinc_app_eah_brp_tpu_torch.io import empty_candidates
    from boinc_app_eah_brp_tpu_torch.ops.whiten import whiten_and_zap
    from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
    from boinc_app_eah_brp_tpu_torch.oracle.stats import base_thresholds
    from boinc_app_eah_brp_tpu_torch.oracle.toplist import finalize_candidates, update_toplist_from_maxima
    from boinc_app_eah_brp_tpu_torch.tools import _inputs

    n = 1 << 22
    b = np.loadtxt(BANK200)
    P, tau, psi0 = b[:, 0], b[:, 1], search.normalize_psi0(b[:, 2])
    inj = _inputs.INJECT
    x = _inputs.pulsed_series(n, DT * 1e6, (P[inj], tau[inj], psi0[inj]), 123.4567, 0.4, seed)
    cfg = SearchConfig(f0=400.0, padding=3.0, fA=0.08, window=1000, white=True)
    d = DerivedParams.derive(n, DT * 1e6, cfg)
    zap = np.array([[60.0, 60.5], [180.0, 180.2]])
    ts = whiten_and_zap(x, d, cfg, zap, device=dev)
    geom = search.SearchGeometry.from_derived(
        d, max_slope=search.max_slope_for_bank(P, tau), lut_step=search.lut_step_for_bank(P, DT),
        lut_tiles=search.lut_tiles_for_bank(P, psi0, n, DT),
    )
    M, T = search.run_bank(ts, P, tau, psi0, geom, batch_size=32)
    cands = update_toplist_from_maxima(
        empty_candidates(), search.state_to_natural(M, geom), search.state_to_natural(T, geom),
        P.astype(np.float32), tau.astype(np.float32), psi0.astype(np.float32),
        base_thresholds(cfg.fA, d.fft_size), geom.window_2,
    )
    return ts, d, geom, cands, finalize_candidates(cands, d.t_obs)


def test_end_of_run_rescoring_on_the_card_is_the_host_oracle_pass(dev):
    """At the production width (2^22 samples, bank200, the whitened
    production workunit): the series of every winner resampled and
    padded on the card (kernel A's LUT gather, the exact serial mean) is
    the host oracle's ``resample`` bit for bit, and the toplist the pass
    patches with the spectra it takes on the card (a float64 cuFFT
    transform each) is the host oracle pass's, byte for byte.  The pass
    launches A and the exact mean under the rescoring's own entries,
    takes every winner's spectrum on the card, and opens no host
    resample; after ``warm_step`` neither it nor a second workunit's
    pass, of another winner count, makes a cuFFT plan."""
    from boinc_app_eah_brp_tpu_torch.oracle import rescore
    from boinc_app_eah_brp_tpu_torch.oracle import resample as oracle
    from boinc_app_eah_brp_tpu_torch.runtime import metrics, tracing
    from boinc_app_eah_brp_tpu_torch.tools import _inputs
    from torch_parity import host_rescore

    ts, d, geom, cands, emitted = _production_toplist(dev, _inputs.SEED)
    host = ts.cpu().numpy()
    winners = sorted(rescore._winning_pairs(cands, emitted)[0])
    assert len(winners) > rescore.DEVICE_CHUNK
    rows = [oracle.ResampleParams.from_template(*t, d.dt, d.nsamples, d.n_unpadded) for t in winners]
    for row, (padded, n_steps, mean) in zip(rows, rescore.device_series(ts, rows)):
        want, w_steps, w_mean = oracle.resample(host, row)
        assert n_steps == w_steps and mean.tobytes() == w_mean.tobytes()
        assert padded.cpu().numpy().tobytes() == want.tobytes()
    search.warm_step(geom, 32, dev)
    plans = []
    kernels.plan_listeners.append(plans.append)
    assert metrics.configure(force=True) and tracing.configure(force=True)
    try:
        before = dict(kernels.launch_counts)
        got, n_got = rescore.rescore_winners(ts, cands, emitted, d)
        after = dict(kernels.launch_counts)
        counters = {k: v["value"] for k, v in metrics.snapshot()["counters"].items()}
        spans = [r["name"] for r in tracing.events() if r.get("kind") == "span"]
        ts2, d2, _, cands2, emitted2 = _production_toplist(dev, _inputs.SEED + 1)
        n_second = rescore.rescore_winners(ts2, cands2, emitted2, d2)[1]
    finally:
        kernels.plan_listeners.remove(plans.append)
        metrics.finish(0)
        tracing.finish(0)
    chunks = -(-len(winners) // rescore.DEVICE_CHUNK)
    assert after["rescore_resample"] == before["rescore_resample"] + chunks
    assert after["rescore_serial_mean"] == before["rescore_serial_mean"] + chunks
    for k in ("resample", "resample_t1", "serial_mean"):
        assert after[k] == before[k], k
    assert counters["rescore.device_ffts"] == counters["rescore.device_resamples"] == len(winners)
    assert spans.count("rescore.fft") == len(winners) and "rescore.resample" not in spans
    assert n_second != len(winners) and n_second == rescore.unique_winner_count(emitted2) > 0
    assert sum(plans) == 0
    want, n_want = host_rescore(host, cands, emitted, d)
    assert n_got == n_want == len(winners)
    assert got.tobytes() == want.tobytes()
    assert not np.array_equal(got["power"], cands["power"])
