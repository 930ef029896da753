"""The whitening's running median on the device.

Counterpart of the reference package's ``ops/median.py``: the sliding
median of a float32 spectrum over a window of ``bsize`` bins, the two
central order statistics' float32 midpoint ``(a + b) * 0.5`` for an even
window.  The whitening takes it where ``ERP_MEDIAN=device`` asks for it,
or where the native ``rngmed`` (``ops/native_median.py``) does not load
(``ops/whiten.py::check_median``); the native median stays the default.

:func:`running_median` launches ``csrc/median.cu`` on a CUDA tensor,
which picks its instantiation by the window: a tile's sorted union in
shared memory up to window 15,361, in device-memory scratch above
(:func:`scratch_entries`).  :func:`running_median_plain` is the plain
PyTorch version, the reference package's blocked sort: ``unfold`` windows
of ``block`` outputs at a time, ``torch.sort`` along the window, the
central entries; the blocks bound its memory (the whole (n_out, w)
matrix is 25 GB at production).
The two are bitwise equal, and equal to the native median for
non-negative inputs (``tests/test_torch_median.py``).
"""

from __future__ import annotations

import torch

from ..runtime import logging as erplog
from . import kernels

_warned = False


def running_median_plain(x: torch.Tensor, *, bsize: int, block: int = 4096) -> torch.Tensor:
    """float32[len(x) - bsize + 1]: medians of ``x[m : m + bsize]``,
    ``block`` outputs at a time."""
    n_out = x.shape[0] - bsize + 1
    if n_out <= 0:
        raise ValueError("window larger than input")
    half = bsize // 2
    out = torch.empty(n_out, dtype=torch.float32, device=x.device)
    for s in range(0, n_out, block):
        e = min(s + block, n_out)
        sw = torch.sort(x[s : e + bsize - 1].unfold(0, bsize, 1), dim=1).values
        out[s:e] = sw[:, half] if bsize % 2 else (sw[:, half - 1] + sw[:, half]) * 0.5
    return out


def scratch_entries(device: torch.device, n: int, bsize: int) -> int:
    """int64 entries of device-memory scratch the kernel takes for ``n``
    inputs and window ``bsize`` on CUDA ``device``: 0 where a tile's union
    fits shared memory, so its shared-memory instantiation runs."""
    entries = kernels.library("median").erp_median_scratch_entries(device.index, n, bsize)
    if entries < 0:
        kernels.check(-entries, "median scratch query")
    return entries


def running_median(x: torch.Tensor, *, bsize: int, block: int = 4096) -> torch.Tensor:
    """float32[len(x) - bsize + 1] sliding median of ``x`` (float32[n]),
    window ``bsize``: the kernel on a CUDA tensor, the plain version in
    blocks of ``block`` outputs on a CPU tensor.  Logs once a process that
    the device median was chosen over the native one."""
    global _warned
    if not _warned:
        _warned = True
        erplog.warn(
            "Device running median selected: the whitening's default is the native rngmed "
            "(ops/native_median.py); this path serves ERP_MEDIAN=device and hosts where that "
            "library does not load.\n"
        )
    if x.device.type == "cpu":
        return running_median_plain(x, bsize=bsize, block=block)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous float32[n] tensor")
    n = x.shape[0]
    n_out = n - bsize + 1
    if n_out <= 0:
        raise ValueError("window larger than input")
    dev = x.device
    out = torch.empty(n_out, dtype=torch.float32, device=dev)
    # each persistent block of the device-memory instantiation sorts its tiles' unions here
    scratch = torch.empty(scratch_entries(dev, n, bsize), dtype=torch.int64, device=dev)
    rc = kernels.library("median").erp_median(
        dev.index, kernels.stream_handle(dev), x.data_ptr(), scratch.data_ptr(), out.data_ptr(), n, bsize
    )
    kernels.check(rc, "median kernel launch")
    kernels.launch_counts["median"] += 1
    return out
