"""PyTorch port, the device running median's CUDA source (``csrc/median.cu``)
compiled with g++ and run on the host (``tests/torch_cuda_emu.h``: one
thread a CUDA thread, blocks in turn), against its plain version
(``ops/median.py::running_median_plain``).

This holds the kernel's own logic on a machine without nvcc or a card:
the sort, the rank map, the counts below the walk's start, the first walk
up or down, the slide and the ragged runs and tiles, in both
instantiations.  What nvcc makes of it is held on the card
(``tests/test_torch_cuda.py::test_median_matches_plain``, ``chip_smoke.py``
phase (m1)).

Tolerance: bitwise, as on the card.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from boinc_app_eah_brp_tpu_torch.ops import kernels, median

EMU_H = os.path.join(os.path.dirname(__file__), "torch_cuda_emu.h")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """``median.cu`` built for the host: its launches rewritten to
    ``emu_launch`` and its dynamic shared array to the header's."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the native median too (ops/native_median.py)"
    src = open(os.path.join(kernels.CSRC, "median.cu")).read()
    src = src.replace("#include <cuda_runtime.h>", f'#include "{EMU_H}"')
    src = re.sub(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), \w+>>>\(", r"emu_launch(\2, \3, \4, \1, ", src)
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu_dynamic_shared.data());", src)
    assert "<<<" not in src and "extern __shared__" not in src
    d = tmp_path_factory.mktemp("median_emu")
    cpp, so = d / "median_emu.cpp", d / "libmedian_emu.so"
    cpp.write_text(src)
    subprocess.run([gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-o", str(so), str(cpp)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.erp_median.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    lib.erp_median_scratch_entries.argtypes = [ctypes.c_int] * 3
    return lib


def _input(kind: str, n: int) -> np.ndarray:
    """Exponential draws with every 13th bin zero, a ramp up or down, a
    constant, or draws shifted to straddle zero (negative keys)."""
    if kind == "ascending":
        return np.arange(n, dtype=np.float32) * np.float32(0.25)
    if kind == "descending":
        return np.arange(n, 0, -1, dtype=np.float32) * np.float32(0.25)
    if kind == "constant":
        return np.full(n, 1.5, dtype=np.float32)
    x = np.random.default_rng(n).exponential(1.0, n).astype(np.float32)
    x[::13] = 0.0
    return x - np.float32(0.7) if kind == "signed" else x


def _run(lib, x: np.ndarray, w: int) -> np.ndarray:
    n = x.shape[0]
    out = np.zeros(n - w + 1, dtype=np.float32)
    entries = lib.erp_median_scratch_entries(0, n, w)
    scratch = np.zeros(max(entries, 1), dtype=np.int64)
    assert lib.erp_median(0, None, x.ctypes.data, scratch.ctypes.data, out.ctypes.data, n, w) == 0
    return out, entries


@pytest.mark.parametrize("kind", ["draws", "ascending", "descending", "constant", "signed"])
@pytest.mark.parametrize(
    "n,window",
    # windows 1 and 2 (the degenerate slides), odd and even; n_out 4,005
    # (neither a multiple of a run nor of a tile), 1,024 (one full tile)
    # and 1,025; 15,361, the shared instantiation's largest window
    [(5003, 1), (5003, 2), (5003, 999), (5003, 1000), (2023, 1000), (2024, 1000), (16000, 15361)],
)
def test_emulated_kernel_matches_plain_bitwise(lib, kind, n, window):
    x = _input(kind, n)
    got, entries = _run(lib, x, window)
    assert entries == 0  # the shared-memory instantiation
    want = median.running_median_plain(torch.from_numpy(x), bsize=window)
    assert got.tobytes() == want.numpy().tobytes()


def test_emulated_device_memory_instantiation_matches_plain_bitwise(lib):
    """Window 15,362, past shared memory: one persistent block's tile,
    sorted in device-memory scratch (its union, ranks and masks)."""
    n, window = 15362 + 400, 15362
    x = _input("draws", n)
    got, entries = _run(lib, x, window)
    assert entries > 0
    want = median.running_median_plain(torch.from_numpy(x), bsize=window)
    assert got.tobytes() == want.numpy().tobytes()
