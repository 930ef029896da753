"""PyTorch port, the search's real-to-complex transform (``csrc/rfft.cu``)
compiled with g++ and run on the host (``tests/torch_cuda_emu.py``: one
thread a CUDA thread, blocks in turn), against its plain version
(``ops/spectrum.py::rfft_fourstep_plain``) and numpy's float64 transform.

This holds the kernels' own logic on a machine without nvcc or a card:
the in-place stages of both plans (radix 16 alone, and 3, 4, 16, 16), the
swizzled slots, the four-step twiddles' recurrence, the row pairing and
the untangle with its self-paired rows 0 and N1/2, and that every one of
the M + 1 outputs is written.  What nvcc makes of it is held on the card
(``tests/test_torch_cuda.py::test_rfft_kernel_matches_cufft``).

Tolerance: max |dF| <= 1e-5 max |F|, as on the card.
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


def test_emulated_kernel_refuses_a_split_it_was_not_built_for(lib):
    z = np.zeros(4, dtype=np.float32)
    assert lib.erp_fft_r2c(0, None, *([z.ctypes.data] * 6), 1, 8, 2048) != 0
    assert lib.erp_fft_r2c(0, None, *([z.ctypes.data] * 6), 1, 16, 1024) != 0
