"""Build the port's installable BOINC deployment bundle for Hopper hosts.

The port's twin of the repository's ``tools/make_bundle.py``: one command
that writes a directory a BOINC client can register (anonymous platform).
A volunteer host has no ``nvcc``, and ctypes cannot load a library from
inside a zip, so the bundle ships the CUDA kernel libraries built for
``sm_90a`` beside the worker archive.  Contents:

    erp_wrapper              native host wrapper (main program: supervises the
                             worker, owns signals, shmem and the stderr archive)
    liberp_rngmed.so         native running median of the whitening, for
                             ERP_MEDIAN=native (on the card the whitening
                             takes the median kernel)
    lib<kernel>-<digest>.so  the kernel libraries, one a source of
                             ``kernels.SOURCES`` (resample, fftprep, fold,
                             median), named by the digest of the sources the
                             worker archive holds (``ops/kernels.py``)
    eah_brp_worker.pyz       the port's package as a zipapp
                             (``python3 eah_brp_worker.pyz -i ... -o ...``)
    app_info.xml             registration (``tools/make_app_info.py``): the
                             wrapper as <main_program/>, one NVIDIA card
    install.sh               install step: permissions and a ctypes load
                             check of every library
    README.md                the install story

The kernel libraries are taken from ``$ERP_KERNEL_DIR``, else the
package's build directory, where the first
use of a kernel on a machine with ``nvcc`` and a card builds them
(``python -c "from boinc_app_eah_brp_tpu_torch.ops import kernels;
kernels.build()"``).  A missing library, or one built from other sources,
raises naming the file expected.  The archive's ``__main__`` points
``$ERP_RNGMED_LIB`` and ``$ERP_KERNEL_DIR`` at the bundle directory, so
the worker builds nothing.  There is no wisdom step: the port has no
compilation cache to warm.

Usage: python -m boinc_app_eah_brp_tpu_torch.tools.make_bundle
           [--out dist/eah_brp_tpu_torch]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import zipapp

from ..ops import kernels
from .make_app_info import render

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(_PKG)
PACKAGE = os.path.basename(_PKG)

INSTALL_SH = """#!/bin/sh
# Install step of the BRP app bundle for NVIDIA sm_90a (H100) hosts.  Run
# from the bundle directory after copying it into the BOINC project dir.
set -e
cd "$(dirname "$0")"
chmod +x erp_wrapper
echo "== native library load check =="
# a library that cannot load fails every workunit: refuse at install time
python3 - <<'PY'
import ctypes
for name in {libraries!r}:
    ctypes.CDLL("./" + name)
    print(f"   {{name}} loads OK")
PY
echo "== bundle ready =="
echo "Register with the BOINC client by placing this directory's files in"
echo "the project directory (anonymous platform): app_info.xml names"
echo "erp_wrapper as the main program, and the worker archive and the"
echo "libraries as bundled files."
"""

README = """# Einstein@Home BRP search — CUDA app bundle (NVIDIA H100, sm_90a)

Installable BOINC anonymous-platform deployment of the PyTorch/CUDA port
of the BRP search.  It is for hosts with an NVIDIA Hopper card (H100,
`sm_90a`) and its driver: the kernel libraries are built for that
architecture alone.  The host needs Python 3 with PyTorch built for CUDA
and numpy; it needs no CUDA toolkit and no compiler.

## Install

1. Copy this directory's files into the BOINC project directory
   (`projects/einstein.phys.uwm.edu/` or equivalent).
2. Run `./install.sh` once: it marks the wrapper executable and checks
   that every native library loads.
3. Restart the BOINC client; it reads `app_info.xml` and schedules BRP
   workunits against `erp_wrapper` on one NVIDIA card each.

## Pieces

- `erp_wrapper`: native supervisor: multi-pass loop, coarse resume,
  checkpoint lifecycle, SIGTERM tolerance, suspend/resume, heartbeat
  loss, temporary exit, stderr archival (`stderr.txt`), screensaver
  shmem.
- `eah_brp_worker.pyz`: the PyTorch/CUDA worker (binary-compatible
  workunit, checkpoint and candidate formats).  It runs standalone too:
  `python3 eah_brp_worker.pyz -i wu.bin4 -o out.cand -t bank -W -l zap`.
- `lib<kernel>-<digest>.so`: the CUDA kernels (resampler, FFT-prep,
  harmonic fold, the whitening's device running median, which the
  worker takes on the card), named by the digest of the worker's
  kernel sources; the
  worker refuses a library of other sources, naming the file it expected.
- `liberp_rngmed.so`: the native running median of the whitening, taken
  under `ERP_MEDIAN=native`.
"""

PYZ_MAIN = """\
# zipapp entry: environment defaults of the deployed bundle, then the
# package's command line (the same as `python -m {package}`).
import glob
import os
import sys

# inside a zipapp __file__ is <archive>.pyz/__main__.py, so the first
# real directory up the chain is the bundle directory
_here = os.path.dirname(os.path.abspath(__file__))
while _here != os.path.dirname(_here) and not os.path.isdir(_here):
    _here = os.path.dirname(_here)
# the libraries ship next to the archive; BOINC links the bundle's files
# into the slot dir, so try the bundle directory and then the cwd
_dirs = (_here, os.getcwd())
if "ERP_RNGMED_LIB" not in os.environ:
    for _d in _dirs:
        if os.path.exists(os.path.join(_d, "liberp_rngmed.so")):
            os.environ["ERP_RNGMED_LIB"] = os.path.join(_d, "liberp_rngmed.so")
            break
if "ERP_KERNEL_DIR" not in os.environ:
    os.environ["ERP_KERNEL_DIR"] = next(
        (_d for _d in _dirs if glob.glob(os.path.join(_d, "libresample-*.so"))), _here
    )

from {package}.runtime.cli import main

sys.exit(main())
"""


def kernel_libraries(kernel_dir: str) -> list[str]:
    """The kernel libraries of this package's sources in ``kernel_dir``;
    raises naming the file expected when one is missing or was built
    from other sources."""
    try:
        return list(kernels.shipped_paths(kernel_dir).values())
    except RuntimeError as e:
        raise RuntimeError(
            f"{e}.  Build them on the card's machine with "
            f'python -c "from {PACKAGE}.ops import kernels; kernels.build()" '
            f"(into {kernels.BUILD_DIR}) or set ${kernels.KERNEL_DIR_ENV}"
        ) from None


def build_native(build_dir: str) -> None:
    """``make`` of ``native/`` into ``build_dir`` (its Makefile's
    ``BUILD``), so nothing is written beside the sources."""
    proc = subprocess.run(
        ["make", "-C", os.path.join(REPO, "native"), f"BUILD={build_dir}"], capture_output=True, text=True
    )
    if proc.returncode:
        raise RuntimeError(f"building native/ failed:\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")


def build_pyz(out_path: str) -> None:
    with tempfile.TemporaryDirectory() as stage:
        shutil.copytree(
            _PKG,
            os.path.join(stage, PACKAGE),
            ignore=shutil.ignore_patterns("__pycache__", "build"),
        )
        with open(os.path.join(stage, "__main__.py"), "w") as f:
            f.write(PYZ_MAIN.format(package=PACKAGE))
        zipapp.create_archive(stage, out_path)


def make_bundle(out: str, app_name: str = "einsteinbinary_BRP4", version: int = 56) -> list[str]:
    """Write the bundle into ``out``; returns its file names."""
    libs = kernel_libraries(kernels.kernel_dir() or kernels.BUILD_DIR)
    os.makedirs(out, exist_ok=True)
    with tempfile.TemporaryDirectory() as native_build:
        build_native(native_build)
        for name in ("erp_wrapper", "liberp_rngmed.so"):
            shutil.copy2(os.path.join(native_build, name), out)
    for path in libs:
        shutil.copy2(path, out)
    build_pyz(os.path.join(out, "eah_brp_worker.pyz"))
    lib_names = ["liberp_rngmed.so"] + [os.path.basename(p) for p in libs]

    # heartbeat: BOINC apps run two levels below the client dir (slots/N/),
    # and the client rewrites client_state.xml every few seconds, so its
    # mtime says the client is alive (demod_binary.c:1436-1441)
    cmdline = (
        "--worker 'python3 eah_brp_worker.pyz' --stderr-file stderr.txt "
        "--heartbeat-file ../../client_state.xml --heartbeat-timeout 120"
    )
    with open(os.path.join(out, "app_info.xml"), "w") as f:
        f.write(render(app_name, version, "erp_wrapper", cmdline, extra_files=["eah_brp_worker.pyz", *lib_names]))
    with open(os.path.join(out, "install.sh"), "w") as f:
        f.write(INSTALL_SH.format(libraries=lib_names))
    os.chmod(os.path.join(out, "install.sh"), 0o755)
    with open(os.path.join(out, "README.md"), "w") as f:
        f.write(README)
    return sorted(os.listdir(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "dist", "eah_brp_tpu_torch"))
    ap.add_argument("--app-name", default="einsteinbinary_BRP4")
    ap.add_argument("--version", type=int, default=56)
    args = ap.parse_args(argv)
    try:
        names = make_bundle(args.out, args.app_name, args.version)
    except RuntimeError as e:
        print(f"make_bundle: {e}", file=sys.stderr)
        return 1
    print(f"bundle at {args.out}:")
    for name in names:
        print(f"  {name:32s} {os.path.getsize(os.path.join(args.out, name)):>12,} B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
