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


def test_roofline_counts_the_median():
    cost = roofline.median_cost(6_291_457, 1000)
    assert cost.bytes == (6_291_457 + 6_290_458) * 4
    b = cost.bound()
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(0.015, abs=5e-4)
    steps = roofline.median_steps(6_291_457, 1000)
    assert steps["walk"] == pytest.approx(6.3e9, rel=0.02)
    assert steps["compare_exchanges"] == 6144 * 1024 * 66


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
