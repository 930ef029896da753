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

The default stays the native median, as in the JAX package: it is the
reference's algorithm (``rngmed``), its library ships with the deployment
bundle, and it runs once per workunit on the host while the card is idle.
The device median is the path for ``ERP_MEDIAN=device`` and for hosts
where the library does not load; whether the default should follow the
faster path on the card is measured first (ROADMAP, Queue 4).

Usage: python -m boinc_app_eah_brp_tpu_torch.tools.median_study
           [--json PATH] [--skip-device] [--repeat 3] [--device cuda] [--n N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

N_PRODUCTION = 6291457  # fft_size for 3 x 2^22 padded samples
WINDOW = 1000
DEFAULT = "native"


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

    ps = chi2_spectrum(n)
    out: dict = {
        "what": f"sliding median paths at production size (n={n}, window={window})",
        "default": DEFAULT,
        "decision": "the native rngmed stays the whitening's default, as in the JAX package: the reference's "
        "algorithm, shipped in the bundle, once a workunit on the host; the device median serves "
        "ERP_MEDIAN=device and hosts without the library",
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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--skip-device", action="store_true", help="time the native median alone")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N_PRODUCTION, help="spectrum bins")
    args = ap.parse_args(argv)
    out = study(args.n, WINDOW, device=args.device, repeat=args.repeat, skip_device=args.skip_device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
