"""Running-median path study: both of the whitening's median paths at
production size, and which one the port takes by default.

The port's twin of the repository's ``tools/median_study.py``.  It
measures the two paths of ``ops/whiten.py::check_median`` on one
chi^2-like spectrum of the production geometry (6,291,457 bins, window
1000, from seed 0 as the JAX tool makes it):

* ``native_cpp_s``: the native ``rngmed`` on the host
  (``ops/native_median.py``), one call;
* ``device_s``: the device median (``ops/median.py``; on a card the
  kernel ``csrc/median.cu``, timed with CUDA events over ``--repeat``
  calls after a cold one, ``device_cold_s``, which builds the kernels);

and holds them against each other: ``differing`` outputs and their
``max_ulp`` (0 and 0 when they are bitwise equal, ``paths_agree_bitwise``).

``--kernel-windows`` times the kernel alone instead, as ``chip_smoke.py``
phase (m1) does, on the same spectrum: windows 1000 and 999 over all its
bins and 40,001 (the device-memory instantiation) over its first 400,000,
each held bitwise against the plain version and timed by CUDA events over
10 calls (3 at 40,001) after a warm-up (``kernel_windows``).  With
``--split`` it also splits the shared instantiation's time at windows 1000
and 999 (``kernel_split``): ``csrc/median.cu`` rebuilt with nvcc cut
after each block's sort and rank map, and after each run's first output,
so that the sort, the first walks and the slides each get their share.

The default follows the device of the series (``ops/whiten.py::
check_median``): on a card the device median, which is bitwise the native
one on a spectrum and runs where the spectrum is, so the 25 MB spectrum
never goes to the host and back; on the CPU the native median, as in the
JAX package.  ``ERP_MEDIAN`` takes either path on either device.

Usage: python -m boinc_app_eah_brp_tpu_torch.tools.median_study
           [--json PATH] [--skip-device] [--repeat 3] [--device cuda] [--n N]
           [--kernel-windows [--split]]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

N_PRODUCTION = 6291457  # fft_size for 3 x 2^22 padded samples
WINDOW = 1000
# chip_smoke.py phase (m1)'s cases: (window, bins or None for all, timed calls)
KERNEL_WINDOWS = ((WINDOW, None, 10), (WINDOW - 1, None, 10), (40001, 400_000, 3))


def chi2_spectrum(n: int, seed: int = 0) -> np.ndarray:
    """The JAX tool's spectrum: the sum of two squared normals a bin."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) ** 2 + rng.standard_normal(n) ** 2).astype(np.float32)


def ulp_diff(a: np.ndarray, b: np.ndarray) -> tuple[int, int]:
    """(outputs that differ, the largest difference in units in the last
    place) of two float32 arrays of non-negative values."""
    d = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    return int(np.count_nonzero(d)), int(d.max(initial=0))


def study(n: int = N_PRODUCTION, window: int = WINDOW, device: str = "cuda", repeat: int = 3,
          skip_device: bool = False, log=print) -> dict:
    """Both paths on :func:`chi2_spectrum` of ``n`` bins; returns the
    artifact."""
    from ..ops import native_median
    from ..ops.whiten import default_median

    ps = chi2_spectrum(n)
    out: dict = {
        "what": f"sliding median paths at production size (n={n}, window={window})",
        "default": default_median(device),
        "decision": "the whitening's median follows its series: the device median on a card, where the "
        "spectrum is and bitwise the native one; the native rngmed on the CPU, as in the JAX package",
    }
    native_median.load()  # its first use builds the library: not the median's time
    t0 = time.perf_counter()
    ref = native_median.running_median(ps, window)
    out["native_cpp_s"] = time.perf_counter() - t0
    log(f"native C++: {out['native_cpp_s']:.4f} s")
    if skip_device:
        return out

    import torch

    from ..device import resolve_device
    from ..ops.median import running_median

    dev = resolve_device(device)
    out["backend"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    x = torch.from_numpy(ps).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    got = running_median(x, bsize=window)
    sync()
    out["device_cold_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeat):
            running_median(x, bsize=window)
        stop.record()
        sync()
        out["device_s"] = start.elapsed_time(stop) / repeat / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(repeat):
            running_median(x, bsize=window)
        out["device_s"] = (time.perf_counter() - t0) / repeat
    out["differing"], out["max_ulp"] = ulp_diff(got.cpu().numpy(), ref)
    out["paths_agree_bitwise"] = out["differing"] == 0
    log(f"device ({out['backend']}): {out['device_s']:.6f} s steady ({out['device_cold_s']:.3f} s cold); "
        f"{out['differing']} outputs differ from the native median, max {out['max_ulp']} ulp")
    return out


# the shared instantiation's runs in csrc/median.cu, and the cuts --split
# builds in their place: "sort" stops each block after its sort and rank
# map (one output a thread, read from them, so nothing is optimised away),
# "first_walk" after each run's first output
RUN_CALL = "median_run(s, rank, mask, before, P, J, t0, len, static_cast<uint32_t>(w), out + o0 + t0);"
SPLIT_CUTS = {
    "sort": "out[o0 + t0] = value_of(s[t0]) + static_cast<float>(rank[t0 + 1]);",
    "first_walk": "median_run(s, rank, mask, before, P, J, t0, 1, static_cast<uint32_t>(w), out + o0 + t0);",
}


def split_sources(source: str) -> dict:
    """``csrc/median.cu``'s text with its runs cut as :data:`SPLIT_CUTS`
    says; raises if the shared kernel no longer calls them as expected."""
    if source.count(RUN_CALL) != 1:
        raise ValueError("csrc/median.cu's shared kernel no longer runs median_run as --split expects")
    return {name: source.replace(RUN_CALL, cut) for name, cut in SPLIT_CUTS.items()}


def kernel_split(n: int = N_PRODUCTION, log=print) -> dict:
    """The shared instantiation's ms a call at windows 1000 and 999 over
    :func:`chi2_spectrum` of ``n`` bins: the whole kernel, the cut after
    the sort (``sort_ms``), and the first walks and the slides as the
    differences of the cuts (:func:`split_sources`)."""
    import torch

    from ..ops import kernels
    from ..ops.median import running_median
    from .stagebench import _Timer

    with open(os.path.join(kernels.CSRC, "median.cu")) as f:
        cuts = split_sources(f.read())
    tmp = tempfile.mkdtemp(prefix="median_split_")
    try:
        procs = {}
        for name, text in cuts.items():
            cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"lib{name}.so")
            with open(cu, "w") as f:
                f.write(text)
            procs[name] = (subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so, cu],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
        libs = {}
        for name, (proc, so) in procs.items():
            out_text, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"the {name} cut of csrc/median.cu does not build:\n{out_text}")
            lib = ctypes.CDLL(so)
            lib.erp_median.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
            libs[name] = lib
        dev = torch.device("cuda", torch.cuda.current_device())
        timed = _Timer(torch, dev)
        ps = torch.from_numpy(chi2_spectrum(n)).to(dev)
        out: dict = {}
        for window in (WINDOW, WINDOW - 1):
            y = torch.empty(n - window + 1, dtype=torch.float32, device=dev)

            def cut(lib, window=window, y=y):
                rc = lib.erp_median(dev.index, kernels.stream_handle(dev), ps.data_ptr(), None, y.data_ptr(), n,
                                    window)
                kernels.check(rc, "median cut launch")

            ms = {name: timed(lambda lib=lib: cut(lib), 10) for name, lib in libs.items()}
            whole = timed(lambda window=window: running_median(ps, bsize=window), 10)
            out[str(window)] = dict(kernel_ms=whole, sort_ms=ms["sort"], first_walk_ms=ms["first_walk"] - ms["sort"],
                                    slide_ms=whole - ms["first_walk"])
            log(f"window {window}: kernel {whole:.4f} ms = sort {ms['sort']:.4f} + first walks "
                f"{out[str(window)]['first_walk_ms']:.4f} + slides {out[str(window)]['slide_ms']:.4f}")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def kernel_windows(n: int = N_PRODUCTION, log=print) -> dict:
    """The kernel alone on a card at each of :data:`KERNEL_WINDOWS` over
    :func:`chi2_spectrum` of ``n`` bins: ``ms`` a call and whether it is
    ``bitwise`` the plain version, keyed by window."""
    import torch

    from ..ops.median import running_median, running_median_plain
    from .stagebench import _Timer

    if not torch.cuda.is_available():
        raise RuntimeError("--kernel-windows times the kernel on a CUDA card; none is available")
    dev = torch.device("cuda", torch.cuda.current_device())
    timed = _Timer(torch, dev)
    ps = torch.from_numpy(chi2_spectrum(n)).to(dev)
    out: dict = {"backend": torch.cuda.get_device_name(dev), "bins": n}
    for window, bins, reps in KERNEL_WINDOWS:
        x = ps[:bins].contiguous()
        got = running_median(x, bsize=window)
        want = running_median_plain(x, bsize=window, block=max(1, (1 << 26) // window))
        out[str(window)] = dict(
            bins=int(x.shape[0]), ms=timed(lambda x=x, window=window: running_median(x, bsize=window), reps),
            bitwise=bool(torch.equal(got.view(torch.int32), want.view(torch.int32))),
        )
        log(f"window {window} over {x.shape[0]} bins: {out[str(window)]['ms']:.4f} ms, "
            f"bitwise {out[str(window)]['bitwise']}")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--skip-device", action="store_true", help="time the native median alone")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N_PRODUCTION, help="spectrum bins")
    ap.add_argument("--kernel-windows", action="store_true",
                    help="time the kernel alone at chip_smoke.py phase (m1)'s windows, on a card")
    ap.add_argument("--split", action="store_true",
                    help="with --kernel-windows: split the kernel's time into sort, first walks and slides")
    args = ap.parse_args(argv)
    if args.kernel_windows:
        out = kernel_windows(args.n)
        if args.split:
            out["split"] = kernel_split(args.n)
    else:
        out = study(args.n, WINDOW, device=args.device, repeat=args.repeat, skip_device=args.skip_device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
