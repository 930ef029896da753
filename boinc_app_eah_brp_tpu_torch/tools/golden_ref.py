"""The f64 oracle's per-stage dump: the ``--stages`` mode of the JAX
package's ``tools/golden_ref.py``.

It dumps the f64 oracle's per-stage intermediates (whitened series,
per-template resampled series, power spectra and harmonic sumspecs, the
merged maxima: ``runtime/precision.py::oracle_stage_intermediates``) for
the CI audit geometry (``precision.ci_fixture()``) as one npz plus an
``erp-oracle-stages/1`` sidecar with one sha256 digest per array.  Pure
numpy: it needs no card and no reference checkout, and its arrays are
bitwise the JAX tool's.

The golden diff against the compiled reference binary, the JAX tool's
other mode, needs the reference sources and their shipped workunit,
which this repository does not hold; it is not ported.

Usage:
    python -m boinc_app_eah_brp_tpu_torch.tools.golden_ref --stages OUTDIR
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

STAGES_SCHEMA = "erp-oracle-stages/1"
NPZ_NAME = "oracle_stages_ci.npz"
SIDECAR_NAME = "oracle_stages_ci.sha256.json"


def dump_stages(outdir: str) -> int:
    """Write ``oracle_stages_ci.npz`` and its sha256 sidecar into
    ``outdir``."""
    import numpy as np

    from ..runtime.precision import ci_fixture, oracle_stage_intermediates

    ts, P, tau, psi0, cfg, derived, geom = ci_fixture()
    stages = oracle_stage_intermediates(ts, P, tau, psi0, cfg, derived)
    os.makedirs(outdir, exist_ok=True)
    npz_path = os.path.join(outdir, NPZ_NAME)
    np.savez_compressed(npz_path, **stages)
    sidecar = {
        "schema": STAGES_SCHEMA,
        "generated_unix": int(time.time()),
        "npz": NPZ_NAME,
        "geometry": {
            "n_unpadded": int(derived.n_unpadded),
            "nsamples": int(derived.nsamples),
            "fft_size": int(derived.fft_size),
            "window_2": int(derived.window_2),
            "fund_hi": int(geom.fund_hi),
            "harm_hi": int(geom.harm_hi),
            "templates": int(len(P)),
        },
        "arrays": {
            name: {
                "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest(),
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
            }
            for name, arr in stages.items()
        },
    }
    sidecar_path = os.path.join(outdir, SIDECAR_NAME)
    with open(sidecar_path, "w", encoding="utf-8") as f:
        json.dump(sidecar, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"golden-ref: stages dumped to {npz_path}")
    print(f"golden-ref: sidecar at {sidecar_path}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Dump the f64 oracle's per-stage intermediates of the CI audit geometry.")
    ap.add_argument("--stages", metavar="OUTDIR", required=True,
                    help="directory for the npz and its sha256 sidecar")
    args = ap.parse_args(argv)
    return dump_stages(args.stages)


if __name__ == "__main__":
    sys.exit(main())
