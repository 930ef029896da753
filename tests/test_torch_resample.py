"""PyTorch port, resampler (kernels A and B, plain versions on the CPU)
against the JAX package's Pallas kernels in interpret mode and its XLA
resampler, on the same numpy inputs.

Tolerances: gathered samples and n_steps are bitwise equal to the JAX
package's numpy oracle (``oracle/resample.py``, the reference's
uncontracted float32 chain).  Against the JAX functions run by XLA on the
CPU they are bitwise equal except at samples where XLA contracts
``tau*s*step_inv - S0`` into a fused multiply-add and ``i - del_t`` lands
on the other side of a rounding tie: every such mismatch must be one where
the contracted and the uncontracted index differ (``torch_parity.contraction_ties``).  The pad mean is a float32 sum of up to 1.6e4
positive samples taken in another order (XLA on the CPU accumulates
serially, with an error bound of ~n*eps; the port in kernel A's fixed
order of lane runs and halving trees): it is held to rtol 1e-4, about 8x
the largest difference seen (1.3e-5).  The fixed order itself is held to
rtol 1e-6 against a float64 sum, and bitwise against a replay of the
kernel's own scheme of unit sums, cut unit and tree.

The exact (serial) pad mean of unwhitened runs, ``exact_mean_params``
(and ``serial_mean_plain`` of kernel A's samples), is bitwise equal to the
JAX package's host pass (``host_exact_mean_params``), as are its n_steps
and kernel A's; one ``BankStep`` on an exact-mean geometry is held against
JAX ``make_bank_step`` as the whitened step is in ``test_torch_search.py``
(M to rtol 1e-5, T equal).

The exact-sine resampler (``exact_sin=True``, the JAX package's
``use_lut=False``): XLA's ``jnp.sin``, NumPy's ``np.sin`` and
``torch.sin`` on the CPU are three float32 sines a few ulp apart, so a
gathered sample (or the trailing-run test) may flip only where the float64
tie distance lies within what ``torch_parity.SINE_ULPS`` (4) ulp of the
sine and one ulp of the phase can move (``torch_parity.sine_ties``); every
other sample and n_steps are bitwise, the pad mean to MEAN_RTOL against
XLA's pairwise sum, and the exact mean bitwise against the JAX package's
host pass wherever a template's head has no flip.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu.models import search as jax_search
from boinc_app_eah_brp_tpu.models.search import bank_params_host as jax_bank_params
from boinc_app_eah_brp_tpu.ops.pallas_resample import (
    _batch_stats,
    _launch_stream_batch,
    resample_fftprep_pallas_batch,
    resample_split_pallas,
    resample_split_pallas_batch,
)
from boinc_app_eah_brp_tpu.ops.resample import resample_split as xla_resample_split
from boinc_app_eah_brp_tpu.ops.sincos import sincos_lut_lookup as jax_sincos
from boinc_app_eah_brp_tpu.oracle.pipeline import DerivedParams as JaxDerived
from boinc_app_eah_brp_tpu.oracle.pipeline import SearchConfig as JaxConfig
from boinc_app_eah_brp_tpu.oracle.resample import ResampleParams, resample as oracle_resample
from boinc_app_eah_brp_tpu.oracle.resample import resample_stats as jax_resample_stats
from boinc_app_eah_brp_tpu_torch.models import search
from boinc_app_eah_brp_tpu_torch.models.search import bank_params_host
from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
from boinc_app_eah_brp_tpu_torch.oracle import resample as port_oracle
from boinc_app_eah_brp_tpu_torch.ops import resample as port
from boinc_app_eah_brp_tpu_torch.ops.sincos import sincos_lut_unwrapped
from fixtures import synthetic_timeseries
from torch_parity import DT, SINE_ULPS, contraction_ties, sine_ties

MEAN_RTOL = 1e-4
# the sine-tie band (torch_parity.sine_ties) is wider than the contraction
# ties: at 2^14 samples one ulp of i - del_t alone is ~1e-3 of a sample
SINE_TIE_SHARE = 1e-2
MAX_SLOPE = 0.00390625
LUT_STEP = 1.52587890625e-05
BANK200 = os.path.join(os.path.dirname(__file__), "golden", "bank200.txt")


def _bank(rows):
    """float32 (tau, omega, psi0, S0) of bank200 rows, via the port (the
    JAX package's derivation is checked equal in test_bank_params_match)."""
    b = np.loadtxt(BANK200)[rows]
    return bank_params_host(b[:, 0], b[:, 1], b[:, 2], DT)


def _series(n, seed=0):
    """The time series (the port's input) and its two parity streams (the
    JAX package's)."""
    ts = synthetic_timeseries(n, f_signal=33.0, P_orb=1462.99, tau=0.19, psi0=1.75, seed=seed)
    return ts, ts[0::2].copy(), ts[1::2].copy()


def _kw(n, padding):
    nsamples = int(padding * n + 0.5)
    nsamples += nsamples % 2
    return dict(nsamples=nsamples, n_unpadded=n, dt=DT)


def _jax_kw(n, padding):
    return dict(_kw(n, padding), max_slope=MAX_SLOPE, lut_step=LUT_STEP, lut_tiles=1024)


def _assert_equal_but_ties(got, want, ties, max_share=1e-3):
    """got == want bitwise, except where ``ties`` marks a tie (contraction
    ties by default, at most ``max_share`` of the samples)."""
    got, want = np.asarray(got), np.asarray(want)
    bad = (got != want) & ~ties
    assert not bad.any(), f"{bad.sum()} mismatches outside contraction ties"
    assert ties.mean() < max_share


def test_bank_params_match():
    b = np.loadtxt(BANK200)
    got = bank_params_host(b[:, 0], b[:, 1], b[:, 2], DT)
    want = jax_bank_params(b[:, 0], b[:, 1], b[:, 2], DT)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sincos_matches_blocked_lut():
    # monotone phase with a LUT-index step of 0.0127 per element, inside
    # the blocked lookup's max_step contract
    x = (np.linspace(0.0, 50.0, 40000) + 0.3).astype(np.float32)
    ws, wc = jax_sincos(jnp.asarray(x), max_step=0.02, tiles=1024)
    gs, gc = sincos_lut_unwrapped(torch.from_numpy(x))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("renorm", [None, 6.5])
@pytest.mark.parametrize("n,padding", [(1 << 14, 1.5), (10000, 1.0)])
def test_stream_and_stats_match_pallas(n, padding, renorm):
    """Kernel A's plain version == the Pallas batched stream launch: raw
    gathered streams and n_steps bitwise, mean to MEAN_RTOL."""
    ts, ev, od = _series(n)
    params = _bank([0, 1, 2, 7, 150])
    raw, n_steps, mean = port.resample_stream(
        torch.from_numpy(ts), port.stream_params(*params), n_unpadded=n, dt=DT, renorm=renorm,
    )
    T = len(params[0])
    out, jlf, n_blocks = _launch_stream_batch(
        jnp.asarray(ev), jnp.asarray(od), *(jnp.asarray(p) for p in params),
        n_unpadded=n, dt=DT, max_slope=MAX_SLOPE, lut_tiles=1024,
        renorm=renorm, interpret=True,
    )
    _, _, w_steps, _, _, w_mean = _batch_stats(out, jlf, T=T, half=n // 2, n_blocks=n_blocks)
    w_raw = np.asarray(out).reshape(T, 2, -1)[:, :, : n // 2]
    _assert_equal_but_ties(raw.numpy(), w_raw, contraction_ties(params, n))
    np.testing.assert_array_equal(n_steps.numpy(), np.asarray(w_steps))
    np.testing.assert_allclose(mean.numpy(), np.asarray(w_mean), rtol=MEAN_RTOL)


def _assert_padded_match(got, want, n_steps, mean, ties, max_share=1e-3):
    """(even, odd) outputs: equal below n_steps but for ties (contraction
    ties by default), the pad within MEAN_RTOL."""
    ge, go = (np.asarray(a) for a in got)
    we, wo = (np.asarray(a) for a in want)
    T, half_out = ge.shape
    half = ties.shape[2]
    for t in range(T):
        i = np.arange(half_out * 2).reshape(-1, 2)
        for p, (g, w) in enumerate(((ge[t], we[t]), (go[t], wo[t]))):
            head = i[:, p] < n_steps[t]
            tie = np.zeros(half_out, dtype=bool)
            tie[: min(half, half_out)] = ties[t, p, :half_out]
            _assert_equal_but_ties(g[head], w[head], tie[head], max_share)
            np.testing.assert_allclose(g[~head], w[~head], rtol=MEAN_RTOL)
            np.testing.assert_array_equal(g[~head], np.full((~head).sum(), mean[t]))


def _port_stats(ts, params, n):
    _, n_steps, mean = port.resample_stream(
        torch.from_numpy(ts), port.stream_params(*params), n_unpadded=n, dt=DT
    )
    return n_steps.numpy(), mean.numpy()


@pytest.mark.parametrize("entry", ["split", "fftprep"])
def test_batch_entries_match_pallas(entry):
    n = 1 << 14
    ts, ev, od = _series(n, seed=1)
    params = _bank([0, 3, 42, 199])
    if entry == "split":
        port_fn, jax_fn = port.resample_split_batch, resample_split_pallas_batch
    else:
        port_fn, jax_fn = port.resample_fftprep_batch, resample_fftprep_pallas_batch
    got = port_fn(torch.from_numpy(ts), *(torch.from_numpy(p) for p in params), **_kw(n, 1.5))
    want = jax_fn(
        jnp.asarray(ev), jnp.asarray(od), *(jnp.asarray(p) for p in params),
        interpret=True, **_jax_kw(n, 1.5),
    )
    assert got[0].shape == tuple(want[0].shape)
    _assert_padded_match(got, want, *_port_stats(ts, params, n), contraction_ties(params, n))


@pytest.mark.parametrize("rows", [[0, 1, 2], [17, 60, 199]])
def test_stream_matches_oracle(rows):
    """Kernel A's plain version + stats == the numpy oracle of the
    reference resampler: gathered head and n_steps bitwise, the serial
    float32 mean to MEAN_RTOL."""
    n = 1 << 14
    ts = _series(n, seed=6)[0]
    b = np.loadtxt(BANK200)[rows]
    params = bank_params_host(b[:, 0], b[:, 1], b[:, 2], DT)
    raw, n_steps, mean = port.resample_stream(
        torch.from_numpy(ts), port.stream_params(*params), n_unpadded=n, dt=DT
    )
    for t, (P, tau, psi) in enumerate(b):
        rp = ResampleParams.from_template(P, tau, psi, DT, 2 * n, n)
        want, w_steps, w_mean = oracle_resample(ts, rp)
        assert int(n_steps[t]) == w_steps
        got = raw[t].T.reshape(-1).numpy()  # interleave the parity streams
        np.testing.assert_array_equal(got[:w_steps], want[:w_steps])
        np.testing.assert_allclose(float(mean[t]), w_mean, rtol=MEAN_RTOL)


def test_fftprep_equals_split_path():
    """Kernel B's series == kernel A + a mean pad written out here, bit for
    bit (the same select between the same sample and mean bits)."""
    n = 1 << 13
    ts = torch.from_numpy(_series(n, seed=2)[0])
    params = [torch.from_numpy(p) for p in _bank([1, 5, 9])]
    kw = _kw(n, 3.0)
    raw, n_steps, mean = port.resample_stream(ts, port.stream_params(*params), n_unpadded=n, dt=kw["dt"])
    half, half_out = n // 2, kw["nsamples"] // 2
    m2 = torch.arange(half, dtype=torch.int32) * 2
    tail = mean[:, None].expand(len(mean), half_out - half)
    want = [
        torch.cat([torch.where(m2 + p < n_steps[:, None], raw[:, p], mean[:, None]), tail], dim=1)
        for p in (0, 1)
    ]
    got = port.resample_split_batch(ts, *params, **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_single_template_matches_pallas():
    """The T=1 form (kernel A1's counterpart)."""
    n = 1 << 14
    ts, ev, od = _series(n, seed=4)
    params = _bank([17])
    got = port.resample_split(torch.from_numpy(ts), *(torch.from_numpy(p[0:1]) for p in params), **_kw(n, 1.5))
    want = resample_split_pallas(
        jnp.asarray(ev), jnp.asarray(od), *(jnp.float32(p[0]) for p in params),
        interpret=True, **_jax_kw(n, 1.5),
    )
    _assert_padded_match(
        [g[None] for g in got], [np.asarray(w)[None] for w in want],
        *_port_stats(ts, params, n), contraction_ties(params, n),
    )


def test_batch_matches_vmapped_xla():
    n = 1 << 13
    ts, ev, od = _series(n, seed=5)
    params = _bank([0, 11, 120])
    got = port.resample_split_batch(torch.from_numpy(ts), *(torch.from_numpy(p) for p in params), **_kw(n, 1.5))
    kw = _jax_kw(n, 1.5)
    we, wo = jax.vmap(
        lambda a, b, c, d: xla_resample_split(
            jnp.asarray(ev), jnp.asarray(od), a, b, c, d, use_lut=True, **kw
        )
    )(*(jnp.asarray(p) for p in params))
    _assert_padded_match(
        got, (we, wo), *_port_stats(ts, params, n), contraction_ties(params, n)
    )


def test_plain_stream_needs_cpu_tensor():
    """A wrapper takes its plain version only for a CPU tensor."""
    ts = torch.zeros(16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.resample_stream(ts, torch.zeros(1, 4, device="meta"), n_unpadded=16, dt=DT)


def _halve_np(x):
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _unit_sums_np(x):
    """float32 sums of whole units of port.UNIT outputs in kernel A's order:
    lane j sums outputs j, j+32, ... left to right."""
    lanes = x.reshape(-1, port.PER_LANE, 32).swapaxes(-1, -2)
    acc = lanes[..., 0]
    for k in range(1, port.PER_LANE):
        acc = acc + lanes[..., k]
    return _halve_np(acc)


def _kernel_stats_np(raw, n_steps):
    """numpy float32 replay of csrc/resample.cu's statistics: unit sums of
    every sample, the units below the cut taken whole, the one unit the cut
    crosses re-summed with the mask, a halving tree over the units."""
    T, _, half = raw.shape
    n_units = -(-half // port.UNIT)
    n_pow2 = 1 << (n_units - 1).bit_length()
    out = np.empty(T, dtype=np.float32)
    for t in range(T):
        sums = []
        for p in (0, 1):
            x = np.zeros(n_units * port.UNIT, dtype=np.float32)
            x[:half] = raw[t, p]
            whole = _unit_sums_np(x)
            m_cut = 0 if n_steps[t] - p <= 0 else (int(n_steps[t]) - p + 1) >> 1
            u_cut = m_cut // port.UNIT
            tree = np.zeros(n_pow2, dtype=np.float32)
            tree[: min(u_cut, n_units)] = whole[: min(u_cut, n_units)]
            if u_cut < n_units:
                seg = x[u_cut * port.UNIT : (u_cut + 1) * port.UNIT].copy()
                seg[np.arange(u_cut * port.UNIT, (u_cut + 1) * port.UNIT) >= m_cut] = 0.0
                tree[u_cut] = _unit_sums_np(seg)[0]
            sums.append(_halve_np(tree))
        out[t] = sums[0] + sums[1]
    return out


def _cuts_at_unit_edge(edge_unit):
    """n_steps values whose cut falls just below, on and just above the
    start of unit ``edge_unit``, in both parities."""
    e = 2 * edge_unit * port.UNIT
    return np.array([e - 2, e - 1, e, e + 1, e + 2, e + 3], dtype=np.int32)


@pytest.mark.parametrize("half", [1 << 13, 5001])
def test_masked_sum_fixed_order(half):
    """The plain version's fixed-order masked sum: against a numpy float64
    masked sum to rtol 1e-6, and bitwise against a replay of the kernel's
    unit-sum / cut-unit / tree scheme, for cuts around unit edges (the
    ragged last unit too) at both parities."""
    rng = np.random.default_rng(half)
    edges = [1, half // port.UNIT // 2, half // port.UNIT]
    n_steps = np.concatenate([_cuts_at_unit_edge(u) for u in edges] + [np.array([2 * half - 1, 1, 0, -1])])
    n_steps = np.clip(n_steps, -1, 2 * half - 1).astype(np.int32)
    raw = rng.normal(4.0, 1.0, (len(n_steps), 2, half)).astype(np.float32)
    got = port.masked_sum_plain(torch.from_numpy(raw), torch.from_numpy(n_steps)).numpy()
    i = 2 * np.arange(half)[None, :] + np.arange(2)[:, None]
    want = np.array([raw[t].astype(np.float64)[i < n].sum() for t, n in enumerate(n_steps)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got, _kernel_stats_np(raw, n_steps))


@pytest.mark.parametrize("n", [1 << 14, 10002])
def test_null_template_n_steps(n):
    """tau = 0 resamples to n_steps = n - 2 (the C shrink loop decrements
    once even for del_t == 0); an integer S0 = K moves the cut to n-2-K."""
    ts = _series(n, seed=3)[0]
    K = np.array([0.0, 3.0, 2 * port.UNIT - n % (2 * port.UNIT) + 1.0], dtype=np.float32)
    params = port.stream_params(np.zeros(3), np.ones(3), np.zeros(3), K)
    raw, n_steps, mean = port.resample_stream(torch.from_numpy(ts), params, n_unpadded=n, dt=DT)
    np.testing.assert_array_equal(n_steps.numpy(), (n - 2 - K).astype(np.int32))
    ts = ts.astype(np.float64)
    want = [ts[int(k) : int(k) + int(s)].sum() / s for k, s in zip(K, n_steps.numpy())]
    np.testing.assert_allclose(mean.numpy(), want, rtol=1e-6)


def _exact_geoms(n, P, tau, psi0, **cfg_kw):
    bounds = dict(
        max_slope=search.max_slope_for_bank(P, tau),
        lut_step=search.lut_step_for_bank(P, DT),
        lut_tiles=search.lut_tiles_for_bank(P, psi0, n, DT),
        exact_mean=True,
    )
    jd = JaxDerived.derive(n, DT * 1e6, JaxConfig(**cfg_kw))
    d = DerivedParams.derive(n, DT * 1e6, SearchConfig(**cfg_kw))
    return jax_search.SearchGeometry.from_derived(jd, **bounds), search.SearchGeometry.from_derived(d, **bounds)


EXACT_ROWS = [0, 1, 2, 7, 57, 150, 199]


def _exact_problem(n=1 << 14):
    """bank200 rows and 2^14 samples of an unwhitened (positive) series,
    with the JAX package's host pass over them."""
    b = np.loadtxt(BANK200)[EXACT_ROWS]
    P, tau, psi0 = b[:, 0], b[:, 1], b[:, 2]
    ts = (_series(n, seed=5)[0] + 3.0).astype(np.float32)
    params = _bank(EXACT_ROWS)
    jgeom, _ = _exact_geoms(n, P, tau, psi0, padding=1.5, window=200)
    return ts, params, jax_search.host_exact_mean_params(ts, list(zip(*params)), jgeom)


def test_serial_mean_matches_host_exact_mean():
    """Kernel A's n_steps and the serial mean of its samples, bitwise
    against the JAX package's host pass."""
    n = 1 << 14
    ts, params, (want_n, want_mean) = _exact_problem(n)
    raw, n_steps, _ = port.resample_stream(torch.from_numpy(ts), port.stream_params(*params), n_unpadded=n, dt=DT)
    got = port.serial_mean_plain(raw, n_steps)
    np.testing.assert_array_equal(n_steps.numpy(), want_n)
    assert got.numpy().tobytes() == want_mean.tobytes()
    # the exact-mean series pads with it
    x = port.fftprep_series(torch.from_numpy(ts), *params, **_kw(n, 1.5), exact_mean=True)
    assert x[:, -1].numpy().tobytes() == want_mean.tobytes()


def test_exact_mean_params_match_host_exact_mean():
    """The exact-mean entry (its plain version on the CPU) made from the
    series alone: n_steps and mean bitwise against the JAX package's host
    pass, n_steps equal to kernel A's; an explicit ``mean`` replaces A's
    in the padded series."""
    n = 1 << 14
    ts, params, (want_n, want_mean) = _exact_problem(n)
    tsr, rows = torch.from_numpy(ts), port.stream_params(*params)
    n_steps, mean = port.exact_mean_params(tsr, rows, n_unpadded=n, dt=DT)
    assert n_steps.dtype == torch.int32 and mean.dtype == torch.float32
    np.testing.assert_array_equal(n_steps.numpy(), want_n)
    assert mean.numpy().tobytes() == want_mean.tobytes()
    np.testing.assert_array_equal(n_steps.numpy(), port.resample_stream(tsr, rows, n_unpadded=n, dt=DT)[1].numpy())
    x = port.fftprep_series(tsr, *params, **_kw(n, 1.5), mean=mean)
    assert x[:, -1].numpy().tobytes() == want_mean.tobytes()


def _serial_chain(x):
    """The reference's float32 mean written out: one add at a time."""
    s = np.float32(0.0)
    for v in x:
        s = np.float32(s + v)
    return np.float32(s / np.float32(len(x))) if len(x) else np.float32(0.0)


@pytest.mark.parametrize("n", [1 << 14, 10002])
def test_exact_mean_null_template_and_cut(n):
    """tau = 0 gathers ts[i + K] for an integer S0 = K, up to n_steps = n-2-K:
    the null template (K = 0) and S0s that move the cut, against the
    float32 chain written out."""
    ts = (_series(n, seed=7)[0] + 3.0).astype(np.float32)
    K = np.array([0.0, 3.0, 2 * port.UNIT - n % (2 * port.UNIT) + 1.0], dtype=np.float32)
    params = port.stream_params(np.zeros(3), np.ones(3), np.zeros(3), K)
    n_steps, mean = port.exact_mean_params(torch.from_numpy(ts), params, n_unpadded=n, dt=DT)
    np.testing.assert_array_equal(n_steps.numpy(), (n - 2 - K).astype(np.int32))
    for t, (k, s) in enumerate(zip(K.astype(int), n_steps.numpy())):
        assert mean.numpy()[t].tobytes() == _serial_chain(ts[k : k + s]).tobytes()


def test_exact_mean_nonpositive_n_steps():
    """S0 at or past the end leaves no sample before the trailing run:
    n_steps 0 or -1, and the mean 0.0 (the oracle's documented deviation
    from the reference's division by zero)."""
    n = 1 << 12
    ts = (_series(n, seed=8)[0] + 3.0).astype(np.float32)
    K = np.array([n - 2, n - 1, n + 40], dtype=np.float32)
    params = port.stream_params(np.zeros(3), np.ones(3), np.zeros(3), K)
    n_steps, mean = port.exact_mean_params(torch.from_numpy(ts), params, n_unpadded=n, dt=DT)
    np.testing.assert_array_equal(n_steps.numpy(), [0, -1, -1])
    assert mean.numpy().tobytes() == np.zeros(3, np.float32).tobytes()


@pytest.mark.parametrize("K", [4095.0, 4136.0])
def test_n_steps_minus_one_jax_oracle_raises_port_gives_zero(K):
    """Where the integer S0 = K leaves no sample before the trailing run,
    n_steps = -1: the JAX package's oracle raises ValueError
    (``np.arange(-1)`` against ``del_t[:-1]``); the port's oracle and its
    exact mean give (-1, 0.0), as its kernel does on the card."""
    n = 4096
    ts = (_series(n, seed=10)[0] + 3.0).astype(np.float32)
    fields = dict(
        nsamples=2 * n, nsamples_unpadded=n, fft_size=n + 1, tau=np.float32(0.0), omega=np.float32(1.0),
        psi0=np.float32(0.0), dt=np.float32(DT), step_inv=np.float32(1.0) / np.float32(DT), s0=np.float32(K),
    )
    with pytest.raises(ValueError):
        jax_resample_stats(ts, ResampleParams(**fields))
    n_steps, mean = port_oracle.resample_stats(ts, port_oracle.ResampleParams(**fields))
    assert n_steps == -1 and mean.tobytes() == np.float32(0.0).tobytes()
    params = port.stream_params([0.0], [1.0], [0.0], [K])
    ns, mn = port.exact_mean_params(torch.from_numpy(ts), params, n_unpadded=n, dt=DT)
    assert ns.tolist() == [-1] and mn.numpy().tobytes() == np.float32(0.0).tobytes()


def test_exact_mean_refuses_renorm():
    """The exact mean is of the unwhitened series, which is never
    renormalised."""
    n = 1 << 10
    ts = torch.from_numpy((_series(n, seed=9)[0] + 3.0).astype(np.float32))
    with pytest.raises(ValueError, match="renorm"):
        port.fftprep_series(ts, *_bank([0]), **_kw(n, 1.5), renorm=2.0, exact_mean=True)


@pytest.mark.parametrize("n_steps", [[7, 1, 2 * 37 - 1], [0, -1, 2 * 37 - 2]])
def test_serial_mean_edges(n_steps):
    """Odd counts (the last sample of the even row), one sample, and
    n_steps <= 0 (0.0, the oracle's documented deviation), against the
    float32 chain written out."""
    raw = np.random.default_rng(len(n_steps)).normal(5.0, 1.0, (3, 2, 37)).astype(np.float32)
    got = port.serial_mean_plain(torch.from_numpy(raw), torch.tensor(n_steps, dtype=torch.int32)).numpy()
    for t, n in enumerate(n_steps):
        s = np.float32(0.0)
        for i in range(n):
            s = np.float32(s + raw[t, i & 1, i >> 1])
        want = np.float32(s / np.float32(n)) if n > 0 else np.float32(0.0)
        assert got[t].tobytes() == want.tobytes()


def test_serial_mean_is_not_cumsum():
    """Why the plain version is the numpy chain: torch's cumsum and sum of
    float32 on the CPU give the double-precision sum, hundreds away from
    the reference's serial float32 one at 2^22 samples of N(5, 1)."""
    x = np.random.default_rng(0).normal(5.0, 1.0, 1 << 22).astype(np.float32)
    serial = np.add.accumulate(x, dtype=np.float32)[-1]
    exact = np.float32(x.astype(np.float64).sum())
    xt = torch.from_numpy(x)
    assert torch.cumsum(xt, 0)[-1].item() == exact and torch.sum(xt).item() == exact
    assert abs(float(serial) - float(exact)) > 100.0
    raw = torch.from_numpy(np.stack([x[0::2], x[1::2]])[None])
    got = port.serial_mean_plain(raw, torch.tensor([1 << 22], dtype=torch.int32))
    assert got.numpy()[0] == np.float32(serial / np.float32(1 << 22))


def test_exact_mean_bank_step_matches_jax_step():
    """One BankStep on an exact-mean geometry against JAX make_bank_step
    fed the host pass's (n_steps, mean), from the same carried-over state:
    M to rtol 1e-5 (two FFT libraries), T equal.  Templates without a
    contraction tie at this length.  The series has mean 1: the float32
    FFT's error grows with the series' power at DC, and at mean 4 the two
    libraries' M differ by up to ~2e-5 in a few small bins."""
    n, B = 1 << 13, 3
    b = np.loadtxt(BANK200)[[0, 1, 2, 6, 9]]
    P, tau, psi0 = b[:, 0], b[:, 1], b[:, 2]
    params = search.bank_params_host(P, tau, psi0, DT)
    assert not contraction_ties(params, n).any()
    jgeom, geom = _exact_geoms(n, P, tau, psi0, padding=1.5, window=200, f0=250.0)
    ts = np.random.default_rng(12).normal(1.0, 1.0, n).astype(np.float32)
    ts_args = jax_search.prepare_ts(jgeom, ts)
    jbank = jax_search.upload_bank(jax_search.bank_params_host(P, tau, psi0, DT), B)
    jstep = jax_search.make_bank_step(jgeom, B)
    ns, mn = jax_search.host_exact_mean_params(ts, list(zip(*params)), jgeom)
    ns = np.concatenate([ns, np.full(B, ns[0], np.int32)])  # masked slots, as ExactMeanPrefetch pads
    mn = np.concatenate([mn, np.full(B, mn[0], np.float32)])
    M, T = jax_search.init_state(jgeom)
    M, T = jstep(ts_args, *jbank, jnp.int32(0), jnp.int32(len(P)), M, T, jnp.asarray(ns[:B]), jnp.asarray(mn[:B]))

    step = search.BankStep(
        geom,
        search.bank_from_jax([np.asarray(a) for a in jbank], device="cpu"),
        B,
        state=search.state_from_jax(np.asarray(M), np.asarray(T), device="cpu"),
    )
    M, T = jstep(
        ts_args, *jbank, jnp.int32(B), jnp.int32(len(P)), M, T, jnp.asarray(ns[B : 2 * B]), jnp.asarray(mn[B : 2 * B])
    )
    pM, pT = step(torch.from_numpy(ts), B, len(P))
    np.testing.assert_allclose(pM.numpy(), np.asarray(M), rtol=1e-5)
    np.testing.assert_array_equal(pT.numpy(), np.asarray(T))


def _exact_sin_problem(n, rows, seed):
    ts, ev, od = _series(n, seed=seed)
    params = _bank(rows)
    return ts, ev, od, params


def _flips(got, want, ties):
    """The mismatches of ``got`` against ``want``; each must be a tie."""
    got, want = np.asarray(got), np.asarray(want)
    bad = got != want
    assert not (bad & ~ties).any(), f"{int((bad & ~ties).sum())} mismatches outside the sine ties"
    return int(bad.sum())


@pytest.mark.parametrize("n,padding", [(1 << 14, 1.5), (10000, 1.0)])
def test_exact_sin_stream_matches_xla(n, padding):
    """Kernel A's exact-sine plain version against the JAX package's
    vmapped ``resample_split(use_lut=False)`` (XLA's ``jnp.sin``): samples
    bitwise but at sine ties, n_steps equal, the pad within MEAN_RTOL."""
    ts, ev, od, params = _exact_sin_problem(n, [0, 1, 2, 7, 57, 150, 199], seed=21)
    kw = _kw(n, padding)
    got = port.resample_fftprep_batch(
        torch.from_numpy(ts), *(torch.from_numpy(p) for p in params), exact_sin=True, **kw
    )
    we, wo = jax.vmap(
        lambda a, b, c, d: xla_resample_split(
            jnp.asarray(ev), jnp.asarray(od), a, b, c, d, use_lut=False, **_jax_kw(n, padding)
        )
    )(*(jnp.asarray(p) for p in params))
    raw, n_steps, mean = port.resample_stream(
        torch.from_numpy(ts), port.stream_params(*params), n_unpadded=n, dt=DT, exact_sin=True
    )
    ties = sine_ties(params, n)
    _assert_padded_match(got, (we, wo), n_steps.numpy(), mean.numpy(), ties, SINE_TIE_SHARE)
    # the unpadded samples alone, counted
    w_raw = np.stack([np.asarray(we)[:, : n // 2], np.asarray(wo)[:, : n // 2]], axis=1)
    head = (2 * np.arange(n // 2)[None, None, :] + np.arange(2)[None, :, None]) < n_steps.numpy()[:, None, None]
    assert _flips(raw.numpy()[head], w_raw[head], ties[head]) <= int(ties.sum())


def test_exact_sin_single_template_matches_xla():
    """The T = 1 launch (A1's exact-sine instantiation)."""
    n = 1 << 14
    ts, ev, od, params = _exact_sin_problem(n, [17], seed=22)
    got = port.resample_split(
        torch.from_numpy(ts), *(torch.from_numpy(p[0:1]) for p in params), **_kw(n, 1.5), exact_sin=True
    )
    want = xla_resample_split(
        jnp.asarray(ev), jnp.asarray(od), *(jnp.float32(p[0]) for p in params), use_lut=False, **_jax_kw(n, 1.5)
    )
    _, n_steps, mean = port.resample_stream(
        torch.from_numpy(ts), port.stream_params(*params), n_unpadded=n, dt=DT, exact_sin=True
    )
    _assert_padded_match(
        [g[None] for g in got], [np.asarray(w)[None] for w in want], n_steps.numpy(), mean.numpy(),
        sine_ties(params, n), SINE_TIE_SHARE,
    )


def test_exact_sin_exact_mean_matches_jax_host_pass():
    """The exact-sine exact mean (its plain version) against the JAX
    package's host pass at ``use_lut=False`` (``np.sin``): n_steps equal,
    the samples equal but at sine ties, and the mean bitwise for every
    template none of whose samples flipped (within rtol 1e-6 otherwise:
    one flipped sample of ~1.6e4)."""
    n = 1 << 14
    b = np.loadtxt(BANK200)[EXACT_ROWS]
    P, tau, psi0 = b[:, 0], b[:, 1], b[:, 2]
    ts = (_series(n, seed=23)[0] + 3.0).astype(np.float32)
    params = _bank(EXACT_ROWS)
    jgeom, _ = _exact_geoms(n, P, tau, psi0, padding=1.5, window=200)
    jgeom = dataclasses.replace(jgeom, use_lut=False)
    want_n, want_mean = jax_search.host_exact_mean_params(ts, list(zip(*params)), jgeom)
    rows = port.stream_params(*params)
    n_steps, mean = port.exact_mean_params(torch.from_numpy(ts), rows, n_unpadded=n, dt=DT, exact_sin=True)
    np.testing.assert_array_equal(n_steps.numpy(), want_n)
    # the host pass's samples, its np.sin chain written out
    f32 = np.float32
    tau32, om, psi, s0 = (np.asarray(p, f32)[:, None] for p in params)
    i_f = np.arange(n, dtype=f32)[None, :]
    ph = (om * (i_f * f32(DT)).astype(f32) + psi).astype(f32)
    del_t = (tau32 * np.sin(ph).astype(f32) * (f32(1.0) / f32(DT)) - s0).astype(f32)
    want = ts[np.clip((i_f - del_t + f32(0.5)).astype(np.int32), 0, n - 1)].reshape(len(EXACT_ROWS), n // 2, 2)
    got = port.resample_stream(torch.from_numpy(ts), rows, n_unpadded=n, dt=DT, exact_sin=True)[0].numpy()
    head = (2 * np.arange(n // 2)[None, None, :] + np.arange(2)[None, :, None]) < want_n[:, None, None]
    flipped = (got != want.transpose(0, 2, 1)) & head
    assert not (flipped & ~sine_ties(params, n)).any()
    clean = ~flipped.any(axis=(1, 2))
    assert mean.numpy()[clean].tobytes() == want_mean[clean].tobytes()
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-6)


def test_exact_sin_exact_mean_is_the_serial_mean_of_its_samples():
    """Inside the port the exact-sine exact mean is the serial mean of
    kernel A's exact-sine samples, bitwise, with A's n_steps (what the
    card's kernels are held to in ``chip_smoke.py``)."""
    n = 1 << 13
    ts = torch.from_numpy((_series(n, seed=24)[0] + 3.0).astype(np.float32))
    rows = port.stream_params(*_bank([3, 40, 120]))
    raw, ns_a, _ = port.resample_stream(ts, rows, n_unpadded=n, dt=DT, exact_sin=True)
    n_steps, mean = port.exact_mean_params(ts, rows, n_unpadded=n, dt=DT, exact_sin=True)
    assert torch.equal(n_steps, ns_a)
    assert port.serial_mean_plain(raw, ns_a).numpy().tobytes() == mean.numpy().tobytes()


def test_exact_sin_needs_no_lut_range():
    """Phases far past the LUT's tiled range (an orbit of 5 ms over the
    series: ~10^3 rad at 2^13 samples, to ~10^6 at the production t_obs)
    resample with the exact sine: the plain version against a float64
    sine, equal but at ties of ``SINE_ULPS`` ulp."""
    n = 1 << 13
    ts = _series(n, seed=25)[0]
    P = np.array([5e-3, 7.3e-3, 11e-3])
    params = bank_params_host(P, np.array([2e-4, 1e-4, 3e-4]), np.array([0.3, 2.0, 6.0]), DT)
    raw, n_steps, _ = port.resample_stream(
        torch.from_numpy(ts), port.stream_params(*params), n_unpadded=n, dt=DT, exact_sin=True
    )
    f32 = np.float32
    tau, om, psi, s0 = (np.asarray(p, f32)[:, None] for p in params)
    i_f = np.arange(n, dtype=f32)[None, :]
    phase = om * (i_f * f32(DT)) + psi
    del_t = (tau * np.sin(phase.astype(np.float64)).astype(f32) * (f32(1.0) / f32(DT)) - s0).astype(f32)
    idx = np.clip((i_f - del_t + f32(0.5)).astype(np.int32), 0, n - 1)
    want = ts[idx].reshape(3, n // 2, 2).transpose(0, 2, 1)
    _flips(raw.numpy(), want, sine_ties(params, n, ulps=SINE_ULPS))
