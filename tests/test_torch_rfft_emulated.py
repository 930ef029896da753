"""PyTorch port, the search's real-to-complex transform (``csrc/rfft.cu``)
compiled with g++ and run on the host (``tests/torch_cuda_emu.py``: one
thread a CUDA thread, blocks in turn), against its plain version
(``ops/spectrum.py::rfft_fourstep_plain``) and numpy's float64 transform.

This holds the kernels' own logic on a machine without nvcc or a card:
the in-place stages of both plans (radix 16 alone, and 3, 4, 16, 16), the
swizzled slots, the four-step twiddles' recurrence, the row pairing and
the untangle with its self-paired rows 0 and N1/2, and that every one of
the M + 1 outputs is written; and its power form (``erp_fft_r2c_power``,
``ops/spectrum.py::search_power``) bitwise the power of its complex output,
with every bin below ``read`` written and none above.  What nvcc makes of it is held on the card
(``tests/test_torch_cuda.py::test_rfft_kernel_matches_cufft``).

Tolerance: max |dF| <= 1e-5 max |F|, as on the card; the power is held
bitwise.
"""

import ctypes

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu_torch.ops import spectrum
from test_torch_rfft import gap, r2c_input
from torch_cuda_emu import build


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = ctypes.CDLL(build("rfft", tmp_path_factory.mktemp("rfft_emu")))
    lib.erp_fft_r2c.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
    lib.erp_fft_r2c_power.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float]
    )
    return lib


def aligned(shape, dtype, align: int = 32) -> np.ndarray:
    """An array whose first element sits on an ``align``-byte boundary,
    as the card's allocator places a tensor."""
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    buf = np.empty(n + align, dtype=np.uint8)
    start = -buf.ctypes.data % align
    return buf[start : start + n].view(dtype).reshape(shape)


# M = 2^15 (N1 = 16, N2 = 2048) and M = 3 * 2^14 (N1 = 16, N2 = 3072); F
# starts on a 32-byte sector, so template t's spectrum starts t mod 4 bins
# into one (M + 1 bins a row), and T = 4 takes pass 2's rows in every phase
@pytest.mark.parametrize("nsamples,T", [(1 << 16, 1), (3 << 15, 2), (3 << 15, 4)])
def test_emulated_kernel_matches_plain(lib, nsamples, T):
    n1, n2 = spectrum.r2c_split(nsamples)
    M = n1 * n2
    x = r2c_input(T, nsamples, nsamples)
    plain = spectrum.rfft_fourstep_plain(torch.from_numpy(x)).numpy()
    want = np.fft.rfft(x.astype(np.float64), axis=1)
    tab = spectrum.r2c_tables(n1, n2)
    F = aligned((T, M + 1), np.complex64)
    F[:] = np.nan
    assert [(F[t].ctypes.data // 8) % 4 for t in range(T)] == [t % 4 for t in range(T)]
    ptr = [a.ctypes.data for a in (x, F, tab["tw1"], tab["tw2"], tab["th"], tab["tl"])]
    assert lib.erp_fft_r2c(0, None, *ptr, T, n1, n2) == 0  # overwrites x
    assert not np.isnan(F).any()
    for t in range(T):
        assert gap(F[t], plain[t]) <= 1e-5, t
        assert gap(F[t], want[t]) <= 1e-5, t


# the three shapes above with every bin (read = M + 1), and a read below
# M + 1 that is no multiple of 16, as the fold's 16W + 16 is below M + 1 at
# the production width
@pytest.mark.parametrize("nsamples,T,below", [
    (1 << 16, 1, 0), (3 << 15, 2, 0), (3 << 15, 4, 0), (1 << 16, 2, 12_345),
])
def test_emulated_power_is_the_power_of_the_complex_output(lib, nsamples, T, below):
    n1, n2 = spectrum.r2c_split(nsamples)
    M = n1 * n2
    read = below or M + 1
    x = r2c_input(T, nsamples, nsamples)
    tab = spectrum.r2c_tables(n1, n2)
    F = aligned((T, M + 1), np.complex64)
    xc = x.copy()  # each call overwrites its series
    ptr = [a.ctypes.data for a in (xc, F, tab["tw1"], tab["tw2"], tab["th"], tab["tl"])]
    assert lib.erp_fft_r2c(0, None, *ptr, T, n1, n2) == 0
    want = spectrum.power_from_rfft(torch.from_numpy(F[:, :read]), nsamples=nsamples).numpy()
    # NaN everywhere, and 64 sentinel floats past the last row
    buf = aligned((T * read + 64,), np.float32)
    buf[:] = np.nan
    scale = float(np.float32(1.0 / nsamples))
    ptr[:2] = [x.ctypes.data, buf.ctypes.data]
    assert lib.erp_fft_r2c_power(0, None, *ptr, T, n1, n2, read, scale) == 0
    p = buf[: T * read].reshape(T, read)
    assert not np.isnan(p).any()  # every bin below read written
    assert np.isnan(buf[T * read :]).all()  # none past it
    assert (p[:, 0] == 0).all()
    assert np.array_equal(p, want)
    # on the CPU, search_power is the power of the plain transform's bins
    xt = torch.from_numpy(r2c_input(T, nsamples, nsamples))
    plain = spectrum.power_from_rfft(spectrum.rfft_fourstep_plain(xt)[:, :read], nsamples=nsamples)
    assert torch.equal(spectrum.search_power(xt, read=read), plain)


def test_emulated_kernel_refuses_a_split_it_was_not_built_for(lib):
    z = np.zeros(4, dtype=np.float32)
    assert lib.erp_fft_r2c(0, None, *([z.ctypes.data] * 6), 1, 8, 2048) != 0
    assert lib.erp_fft_r2c(0, None, *([z.ctypes.data] * 6), 1, 16, 1024) != 0
    assert lib.erp_fft_r2c_power(0, None, *([z.ctypes.data] * 6), 1, 8, 2048, 1, 1.0) != 0
    # a read outside [1, M + 1]
    for read in (0, (16 << 11) + 2):
        assert lib.erp_fft_r2c_power(0, None, *([z.ctypes.data] * 6), 1, 16, 2048, read, 1.0) != 0
