"""PyTorch port, the device running median (``ops/median.py``) on the CPU,
where it runs its plain version, against the JAX package's device median
(``ops/median.py::running_median``, run on the CPU as its own test runs
it) and the port's native ``rngmed``.

Tolerance: bitwise throughout.  The plain version sorts every window as
the JAX package does and takes the same float32 midpoint; the native
median's double midpoint of two non-negative float32 values rounds to the
same float32 (the double sum is exact, and halving commutes with
rounding), so on a spectrum the three agree bit for bit.  The whitened
series under the two median paths are then bitwise equal too.
"""

import functools

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu.ops.median import running_median as jax_median
from boinc_app_eah_brp_tpu_torch.ops import kernels, median, native_median
from boinc_app_eah_brp_tpu_torch.ops.whiten import whiten_and_zap
from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
from boinc_app_eah_brp_tpu_torch.runtime import roofline
from fixtures import synthetic_timeseries

WINDOWS = [2, 3, 7, 100, 999, 1000]
N = 5000
ZAPS = np.array([[50.0, 51.5], [120.0, 120.2]])


def spectrum(n: int, seed: int) -> np.ndarray:
    """Non-negative float32 draws with zeros and ties: exponential values,
    every 17th zero, a stretch rounded to one decimal (many equal values)
    and a run of one repeated value."""
    x = np.random.default_rng(seed).exponential(1.0, n).astype(np.float32)
    x[::17] = 0.0
    x[n // 5 : n // 5 + 600] = np.round(x[n // 5 : n // 5 + 600], 1)
    x[n // 2 : n // 2 + 300] = x[7]
    return x


@functools.cache
def jax_result(window: int) -> np.ndarray:
    return np.asarray(jax_median(spectrum(N, window), bsize=window, block=512))


@pytest.mark.parametrize("block", [1, 257, 4096])
@pytest.mark.parametrize("window", WINDOWS)
def test_plain_median_matches_jax_bitwise(window, block):
    got = median.running_median_plain(torch.from_numpy(spectrum(N, window)), bsize=window, block=block)
    assert got.dtype == torch.float32 and got.shape == (N - window + 1,)
    assert got.numpy().tobytes() == jax_result(window).tobytes()


@pytest.mark.parametrize("window", WINDOWS)
def test_plain_median_matches_native_rngmed_bitwise(window):
    x = spectrum(N, 100 + window)
    got = median.running_median_plain(torch.from_numpy(x), bsize=window)
    assert got.numpy().tobytes() == native_median.running_median(x, window).tobytes()


def test_window_larger_than_input_raises():
    x = torch.zeros(9)
    for fn in (median.running_median, median.running_median_plain):
        with pytest.raises(ValueError, match="window larger than input"):
            fn(x, bsize=10)
    with pytest.raises(ValueError, match="window larger than input"):
        jax_median(np.zeros(9, dtype=np.float32), bsize=10)


def test_cpu_tensor_runs_the_plain_version_and_launches_nothing(monkeypatch, capfd):
    monkeypatch.setattr(median, "_warned", False)
    monkeypatch.setattr(kernels, "library", lambda name: pytest.fail("the CPU loaded a kernel library"))
    before = kernels.launch_counts["median"]
    x = torch.from_numpy(spectrum(600, 1))
    capfd.readouterr()
    for _ in range(2):
        got = median.running_median(x, bsize=100, block=64)
        assert torch.equal(got, median.running_median_plain(x, bsize=100))
    assert kernels.launch_counts["median"] == before
    assert capfd.readouterr().err.count("Device running median selected") == 1
    with pytest.raises(ValueError, match="unsupported device"):
        median.running_median(torch.zeros(8, device="meta"), bsize=3)


def test_a_failed_native_build_is_tried_once(monkeypatch, tmp_path):
    """``native_median.available`` with no ``$ERP_RNGMED_LIB`` and a
    source that does not compile: False each time, one build a process;
    later calls only look for the built file."""
    from boinc_app_eah_brp_tpu_torch.runtime.errors import RADPUL_EVAL, RadpulError

    src = tmp_path / "erp_rngmed.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.delenv(native_median.LIB_ENV, raising=False)
    monkeypatch.setattr(native_median, "SOURCE", str(src))
    monkeypatch.setattr(native_median, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_median, "_lib", None)
    monkeypatch.setattr(native_median, "_build_error", None)
    builds = []
    real_run = native_median.subprocess.run

    def run(cmd, **k):
        builds.append(cmd)
        return real_run(cmd, **k)

    monkeypatch.setattr(native_median.subprocess, "run", run)
    assert not native_median.available() and not native_median.available()
    with pytest.raises(RadpulError) as e:
        native_median.load()
    assert e.value.code == RADPUL_EVAL and "failed" in str(e.value)
    assert len(builds) == 1
    assert "median" in kernels.SOURCES and "median" in kernels.KERNELS


def order_keys(x: np.ndarray) -> np.ndarray:
    """``csrc/median.cu::key_of``: the float's bits mapped so that unsigned
    order is float order."""
    b = x.view(np.uint32)
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint64)


def slide_model(x: np.ndarray, w: int, tile: int, run: int) -> tuple[np.ndarray, dict]:
    """A numpy model of ``csrc/median.cu``'s walk: per tile of ``tile``
    outputs the sorted union of 64-bit entries (key above position, padded
    to a power of two) and its rank map; per run of ``run`` outputs the
    first walk, from index J where the central entry is expected, in
    groups of eight then entry by entry, to the entry with k_lo in-window
    entries below it; then the slide (the leaving entry ``rank[t]``, the
    entering ``rank[t + w]``, j moved to the next or previous in-window
    entry), and an even window's upper entry the next in-window entry
    after j.  Returns the medians and the entries each part read (the
    first walk's count of in-window entries below J: a tile's ranks)."""
    n = x.shape[0]
    n_out = n - w + 1
    k_hi = w // 2
    k_lo = k_hi if w % 2 else k_hi - 1
    P = 1 << (tile + w - 2).bit_length()
    J = min(((k_lo + 1) * (tile + w - 1) // w) & ~7, P - 8)
    keys = order_keys(x)
    out = np.empty(n_out, dtype=np.float32)
    steps = dict(first_walk=0, slide=0)
    for o0 in range(0, n_out, tile):
        U = min(tile + w - 1, n - o0)
        a = np.full(P, np.uint64(0xFFFFFFFFFFFFFFFF))
        a[:U] = np.sort((keys[o0 : o0 + U] << np.uint64(32)) | np.arange(U, dtype=np.uint64))
        pos = (a & np.uint64(0xFFFFFFFF)).astype(np.int64)
        rank = np.empty(U, dtype=np.int64)
        rank[pos[:U]] = np.arange(U)
        steps["first_walk"] += U
        for t0 in range(0, min(tile, n_out - o0), run):
            t = t0
            inside = (pos >= t) & (pos < t + w)
            j = int(np.flatnonzero(inside)[k_lo])
            if inside[:J].sum() <= k_lo:  # forward: whole groups, then j's group up to j
                steps["first_walk"] += (j - J) // 8 * 8 + 8 + (j - J) % 8 + 1
            else:  # backward
                steps["first_walk"] += (J - 1 - j) // 8 * 8 + 8 + (J - 1 - j) % 8 + 1
            for i in range(min(run, tile - t0, n_out - o0 - t0)):
                if i:
                    ra, rb = rank[t], rank[t + w]
                    t += 1
                    inside[ra], inside[rb] = False, True
                    c = k_lo - (ra < j) + (rb < j)
                    if c < k_lo or (c == k_lo and ra == j):
                        q = j + 1 + int(np.argmax(inside[j + 1 :]))
                    elif c > k_lo:
                        q = j - 1 - int(np.argmax(inside[j - 1 :: -1]))
                    else:
                        q = j
                    steps["slide"] += abs(q - j)
                    j = q
                lo = np.float32(x[o0 + pos[j]])
                if w % 2:
                    out[o0 + t] = lo
                else:
                    h = j + 1 + int(np.argmax(inside[j + 1 :]))
                    steps["slide"] += h - j
                    out[o0 + t] = (lo + np.float32(x[o0 + pos[h]])) * np.float32(0.5)
    return out, steps


def model_input(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if kind == "ascending":
        return np.arange(n, dtype=np.float32) * np.float32(0.25)
    if kind == "descending":
        return np.arange(n, 0, -1, dtype=np.float32) * np.float32(0.25)
    if kind == "constant":
        return np.full(n, 1.5, dtype=np.float32)
    x = rng.exponential(1.0, n).astype(np.float32)
    x[rng.random(n) < 0.6] = 0.0  # zero-heavy: most of each window ties at zero
    return x


# (tile, run): the shared instantiation's sizes, and runs and tiles with
# ragged ends (a run that does not divide the tile, n_out that neither divides)
SLIDE_SIZES = [(1024, 16), (100, 7), (37, 37)]


@pytest.mark.parametrize("tile,run", SLIDE_SIZES)
@pytest.mark.parametrize("window", [1, 2, 999, 1000])
@pytest.mark.parametrize("kind", ["ascending", "descending", "constant", "zero_heavy", "spectrum"])
def test_slide_model_matches_plain_bitwise(kind, window, tile, run):
    n = 3001
    x = spectrum(n, window) if kind == "spectrum" else model_input(kind, n)
    got, _ = slide_model(x, window, tile, run)
    want = median.running_median_plain(torch.from_numpy(x), bsize=window)
    assert got.tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("window", [999, 1000])
def test_step_model_matches_the_slide_model(window):
    """``roofline.median_steps`` against the entries the slide model reads
    on exponential draws, within 15%, and the sort's compare-exchanges
    exactly (a bitonic network of next_pow2(tile + w - 1) entries)."""
    n, tile, run = 8000, 1024, 16
    x = np.random.default_rng(window).exponential(1.0, n).astype(np.float32)
    _, counted = slide_model(x, window, tile, run)
    steps = roofline.median_steps(n, window, tile=tile, run=run)
    assert steps["first_walk"] == pytest.approx(counted["first_walk"], rel=0.15)
    assert steps["slide"] == pytest.approx(counted["slide"], rel=0.15)
    assert steps["compare_exchanges"] == -(-(n - window + 1) // tile) * 1024 * 66


def test_roofline_counts_the_median():
    cost = roofline.median_cost(6_291_457, 1000)
    assert cost.bytes == (6_291_457 + 6_290_458) * 4
    b = cost.bound()
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(0.015, abs=5e-4)
    # tile 1,024 (a union of 2,023 in 2,048 entries), runs of 16: 6,144
    # tiles of 2,023 ranks and 393,154 runs (the last tile's 26 outputs are
    # two), each walking ~18.1 + 12.5 entries from J; ~3 slide reads an
    # output, ~1 at the odd window (a walk from index 0 for every output
    # would read 6.38e9 entries)
    steps = roofline.median_steps(6_291_457, 1000)
    assert steps["compare_exchanges"] == 6144 * 1024 * 66
    assert steps["first_walk"] == pytest.approx(6144 * 2023 + 393_154 * 30.61, rel=1e-3)
    assert steps["slide"] == pytest.approx((6_290_458 - 393_154) * 1.0115 + 6_290_458 * 2.023)
    assert roofline.median_steps(6_291_457, 999)["slide"] == pytest.approx((6_290_459 - 393_154) * 2022 / 1998)


@pytest.mark.parametrize("window", [200, 201])
def test_whitening_device_path_equals_native_path(monkeypatch, window):
    n = 4096
    ts = synthetic_timeseries(n, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    cfg = SearchConfig(padding=3.0, window=window, white=True)
    derived = DerivedParams.derive(n, 500.0, cfg)
    out = {}
    for path in ("native", "device"):
        monkeypatch.setenv("ERP_MEDIAN", path)
        out[path] = whiten_and_zap(ts, derived, cfg, ZAPS, median_block=300, device="cpu")
    assert out["device"].numpy().tobytes() == out["native"].numpy().tobytes()


@pytest.mark.parametrize("path", ["native", "device"])
def test_a_cpu_whitening_counts_no_card_median(monkeypatch, path):
    """``whiten.device_medians`` counts the whitenings whose median ran on
    a card: none on the CPU, whichever path runs there."""
    from boinc_app_eah_brp_tpu_torch.runtime import metrics

    n = 4096
    cfg = SearchConfig(padding=3.0, window=200, white=True)
    ts = synthetic_timeseries(n, f_signal=33.0, P_orb=2.2, tau=0.04, psi0=1.2, amp=7.0)
    monkeypatch.setenv("ERP_MEDIAN", path)
    assert metrics.configure(force=True)
    try:
        whiten_and_zap(ts, DerivedParams.derive(n, 500.0, cfg), cfg, ZAPS, median_block=300, device="cpu")
        counters = metrics.snapshot()["counters"]
    finally:
        metrics.finish(0)
    assert "whiten.device_medians" not in counters


@pytest.mark.parametrize("path", ["native", "device"])
def test_warm_takes_the_path_the_whitening_will_take(monkeypatch, path):
    """``ops/whiten.py::warm`` runs the median that ``whiten_and_zap``
    will run, so a warmed server builds nothing on its first workunit."""
    import boinc_app_eah_brp_tpu_torch.ops.whiten as whiten

    calls = []
    monkeypatch.setattr(whiten, "running_median", lambda *a, **k: calls.append("device"))
    monkeypatch.setattr(native_median, "running_median", lambda *a, **k: calls.append("native"))
    monkeypatch.setenv("ERP_MEDIAN", path)
    whiten.warm(64, device="cpu")
    assert calls == [path]
