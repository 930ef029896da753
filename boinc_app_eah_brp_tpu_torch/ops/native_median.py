"""ctypes binding for the native running median (``native/erp_rngmed.cpp``).

The reference's sliding median over the spectrum (``rngmed``,
``demod_binary.c:856-1079``) on the host.  It is the whitening's median on
the CPU, as in the reference package; on a card the whitening takes the
device median unless ``ERP_MEDIAN=native`` asks for this one
(``ops/whiten.py::check_median``).  The library is compiled with ``g++``
into the package's git-ignored ``build/`` directory at first use.  A build
or load failure raises ``RadpulError(RADPUL_EVAL)`` from :func:`load` and
:func:`running_median`; :func:`available` answers False instead, and a
whitening on the CPU then takes the device median's plain version, as the
reference package does.

``$ERP_RNGMED_LIB`` names a prebuilt library (a deployment bundle ships
one, ``tools/make_bundle.py``) and is exclusive, as in the JAX package:
when it is set, that file is loaded and nothing is built or probed
elsewhere; a path that does not load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..runtime import logging as erplog
from .kernels import BUILD_DIR

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "erp_rngmed.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
N_THREADS = min(os.cpu_count() or 1, 16)
LIB_ENV = "ERP_RNGMED_LIB"

_lib: ctypes.CDLL | None = None
_build_error: str | None = None  # a failed build's message; the build is not tried again
_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = os.environ.get(LIB_ENV)
        try:
            path = path or _built_library()
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError) as e:
            from ..runtime.errors import RADPUL_EVAL, RadpulError

            raise RadpulError(
                RADPUL_EVAL,
                f"the native running median {path or SOURCE} does not load ({e})",
            ) from e
        lib.erp_rngmed.restype = ctypes.c_int
        lib.erp_rngmed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32,
        ]
        _lib = lib
        erplog.debug("Running median library: %s\n", path)
        return lib


def load() -> str:
    """Load the library now (building it first where ``$ERP_RNGMED_LIB``
    is unset and it is missing); returns its file.  Raises as a median
    would."""
    return _library()._name


def available() -> bool:
    """Whether the library loads (building it first where
    ``$ERP_RNGMED_LIB`` is unset), the reference package's
    ``native_available``.  Only a load is remembered: a library that
    appears later is loaded then.  A build that failed is not tried again
    in this process; later calls look for the built file only."""
    from ..runtime.errors import RadpulError

    try:
        _library()
    except RadpulError:
        return False
    return True


def _built_library() -> str:
    """The library compiled from ``SOURCE``, built first when missing and
    no build of this process has failed."""
    global _build_error
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"liberp_rngmed-{digest}.so")
    if not os.path.exists(path):
        if _build_error is not None:
            raise RuntimeError(_build_error)
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, SOURCE, "-o", tmp],
            capture_output=True, text=True,
        )
        if proc.returncode:
            _build_error = f"building {SOURCE} failed:\n{proc.stderr}"
            raise RuntimeError(_build_error)
        os.replace(tmp, path)
    return path


def running_median(x: np.ndarray, window: int) -> np.ndarray:
    """float32[len(x) - window + 1]: medians of ``x[m : m + window]``, the
    two central values averaged in double for an even window
    (``rngmed.c`` semantics)."""
    lib = _library()
    x = np.ascontiguousarray(x, dtype=np.float32)
    n_out = len(x) - window + 1
    if n_out <= 0:
        raise ValueError("window larger than input")
    out = np.empty(n_out, dtype=np.float32)
    rc = lib.erp_rngmed(x.ctypes.data, len(x), window, out.ctypes.data, N_THREADS)
    if rc != 0:
        raise RuntimeError(f"erp_rngmed failed with code {rc}")
    return out
