"""Build, load and count the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, in the package's git-ignored ``build/`` directory, at first
use; all sources build at once, one ``nvcc`` process each.  The libraries
are keyed by a hash of their source and flags, so an edited kernel
rebuilds and an unchanged one is reused.

A deployed host has no ``nvcc``: ``$ERP_KERNEL_DIR`` (a deployment
bundle's ``__main__`` sets it to the bundle directory,
``tools/make_bundle.py``) names a directory of prebuilt libraries, and
then nothing is built.  A library there is used only when its name carries
the digest of the sources this package holds (read with ``pkgutil``, so
the check works inside a zipapp); a missing or mismatched library raises,
naming the file expected, and :data:`build_listeners` are told that no
source was compiled.  ctypes binds every pointer and
the stream as ``c_void_p``; each C entry returns ``cudaGetLastError()``
and :func:`check` raises when it is not 0.

The first load of the libraries is a ``kernel-load`` span of
``runtime/tracing.py`` (the build check, ``ctypes.CDLL``, the
signatures).

``launch_counts`` holds one plain integer per kernel entry (``KERNELS``):
a wrapper adds one where it launches its kernel and nowhere else, so a run
can show that it went through the kernels.  One source may serve several
entries: ``resample.cu`` the batched and the single-template resampler
and the reference's serial float32 pad mean of unwhitened runs (entry
``serial_mean``: every template's mean of a bank in one launch, from
kernel A's device functions), each also in its exact-sine instantiation
(``--exact-sin``: ``resample_exact``, ``resample_t1_exact``,
``serial_mean_exact``), ``fold.cu`` the fold of float power and of
the complex spectrum; ``median.cu`` the whitening's device running median
in its two instantiations (entry ``median``).  The end-of-run rescoring's
launches of kernel A and the exact mean count apart from the search's
(``rescore_resample``, ``rescore_serial_mean``).

:func:`planned_fft` runs the port's ``torch.fft`` transforms and tells
:data:`plan_listeners` how many cuFFT plans each created, on the thread
that created them; the first transform of each (device, shape, dtype,
transform, arguments) key, where torch makes the plan, is a
``cufft-plan`` span.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import pkgutil
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

KERNEL_DIR_ENV = "ERP_KERNEL_DIR"

SOURCES = ("resample", "fftprep", "fold", "median")
KERNELS = (
    "resample", "resample_t1", "fftprep", "fold", "fold_spectrum", "serial_mean",
    # the exact-sine instantiations of kernel A, A1 and the exact mean (--exact-sin)
    "resample_exact", "resample_t1_exact", "serial_mean_exact",
    # the whitening's device running median (either of its instantiations)
    "median",
    # kernel A and the exact mean (LUT sine) run by the end-of-run rescoring
    "rescore_resample", "rescore_serial_mean",
)
MAX_GRID_T = 65535  # templates per FFT-prep launch: the batch is a grid dimension
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no FMA contraction anywhere: the resampler's index arithmetic must
    # round every multiply and add on its own (csrc/resample.cu)
    "-fmad=false",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "resample": {
        "erp_resample_unit": [],
        "erp_resample_init": [_I, _P, _P, _P],
        "erp_resample_stream": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I],
        "erp_exact_mean": [_I, _P, _P, _P, _P, _P, _I, _I, _F, _F, _I],
    },
    "fftprep": {
        "erp_fftprep": [_I, _P, _P, _P, _P, _P, _I, _I, _I],
    },
    "fold": {
        "erp_fold_cols": [],
        "erp_fold": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I],
        "erp_fold_spectrum": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F],
    },
    "median": {
        "erp_median_scratch_entries": [_I, _I, _I],
        "erp_median": [_I, _P, _P, _P, _P, _I, _I],
    },
}

launch_counts = {name: 0 for name in KERNELS}
# callables told (sources compiled, wall seconds) after each build that ran
# nvcc, and (0, 0.0) when the libraries were loaded from $ERP_KERNEL_DIR
# (the metrics layer's kernel-build counters)
build_listeners: list = []
# callables told the number of cuFFT plans a transform of planned_fft just
# created, on its thread (the metrics layer's plan counters)
plan_listeners: list = []
# the (device, shape, dtype, transform, arguments) keys planned_fft has
# run on the card; emptied with torch's plan caches
# (runtime/resilience.py::release_device_memory), under _plan_lock
planned_keys: set = set()

_libs: dict[str, ctypes.CDLL] = {}
# ptxas's resource report of each kernel built by this process
ptxas_report: dict[str, list[str]] = {}
_lock = threading.Lock()
_plan_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_name(name: str) -> str:
    """``lib<name>-<digest>.so``: the digest is of the source this package
    holds and the flags, read through the package loader (a plain file or
    a zipapp member alike)."""
    key = pkgutil.get_data(__package__.rpartition(".")[0], f"csrc/{name}.cu") + " ".join(NVCC_FLAGS).encode()
    return f"lib{name}-{hashlib.sha1(key).hexdigest()[:12]}.so"


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, library_name(name))


def kernel_dir() -> str | None:
    """The directory of prebuilt libraries (``$ERP_KERNEL_DIR``), or None
    when the libraries are built here at first use."""
    return os.environ.get(KERNEL_DIR_ENV) or None


def shipped_paths(directory: str) -> dict[str, str]:
    """Each source's library in ``directory``; raises, naming the file
    expected, when one is missing (a library of other sources there is
    named too)."""
    out = {}
    for name in SOURCES:
        path = os.path.join(directory, library_name(name))
        if not os.path.isfile(path):
            others = sorted(os.path.basename(p) for p in glob.glob(os.path.join(directory, f"lib{name}-*.so")))
            raise RuntimeError(
                f"kernel library {path} is missing"
                + (f" ({', '.join(others)} there was built from other sources)" if others else "")
                + f": build it on a machine with nvcc and a card from these sources, or unset ${KERNEL_DIR_ENV}"
            )
        out[name] = path
    return out


def build() -> float:
    """Compile every kernel library that is not built yet, all in
    parallel; returns the wall seconds and keeps ptxas's resource report
    of each in :data:`ptxas_report`.  Raises with nvcc's output when a
    source does not compile.  With ``$ERP_KERNEL_DIR`` set nothing is
    compiled: the libraries there are checked (:func:`shipped_paths`) and
    0.0 is returned."""
    if kernel_dir() is not None:
        shipped_paths(kernel_dir())
        return 0.0
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in SOURCES:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, proc, tmp, out))
    failures = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent process never loads a torn file
            ptxas_report[name] = [
                ln.split("ptxas info    : ")[-1].strip()
                for ln in log.splitlines()
                if any(w in ln for w in ("entry function", "registers", "spill"))
            ]
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    wall = time.perf_counter() - t0
    if jobs:
        for fn in build_listeners:
            fn(len(jobs), wall)
    return wall


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all kernels first
    when any is missing; with ``$ERP_KERNEL_DIR`` set, the prebuilt ones
    there (:func:`shipped_paths`)."""
    with _lock:
        if name not in _libs:
            from ..runtime import tracing

            with tracing.span("kernel-load"):
                shipped = kernel_dir()
                if shipped is not None:
                    paths = shipped_paths(shipped)
                else:
                    build()
                    paths = {n: library_path(n) for n in SOURCES}
                for n in SOURCES:
                    if n in _libs:
                        continue
                    lib = ctypes.CDLL(paths[n])
                    for fn, argtypes in _SIGNATURES[n].items():
                        getattr(lib, fn).argtypes = argtypes
                        getattr(lib, fn).restype = ctypes.c_int
                    _libs[n] = lib
            if shipped is not None:
                for fn in build_listeners:
                    fn(0, 0.0)
        return _libs[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def planned_fft(transform, x, **kwargs):
    """``transform(x, **kwargs)``, a ``torch.fft`` transform, telling
    :data:`plan_listeners` how many cuFFT plans it created.  torch's plan
    cache of ``x``'s card is read before and after the call under one lock,
    so a transform on another thread is never counted as this one's (cuFFT
    makes a plan on the calling thread, before the launch).  The first
    call of a key is a ``cufft-plan`` span."""
    if x.device.type != "cuda":
        return transform(x, **kwargs)
    import torch

    from ..runtime import tracing

    cache = torch.backends.cuda.cufft_plan_cache[x.device.index]
    key = (str(x.device), tuple(x.shape), x.dtype, transform, tuple(sorted(kwargs.items())))
    with _plan_lock:
        before = cache.size
        if key in planned_keys:
            out = transform(x, **kwargs)
        else:
            planned_keys.add(key)
            with tracing.span("cufft-plan", shape=str(tuple(x.shape)), transform=transform.__name__):
                out = transform(x, **kwargs)
        made = cache.size - before
    if made > 0:
        for fn in plan_listeners:
            fn(made)
    return out
