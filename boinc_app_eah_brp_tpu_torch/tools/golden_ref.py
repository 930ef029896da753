"""The golden diff and the f64 oracle's per-stage dump: the JAX package's
``tools/golden_ref.py``.

The golden diff builds the reference's own CPU science path as a
standalone oracle (``tools/refbuild``: its non-BOINC configuration with
FFTW and GSL shims; this tool only runs its ``make``), runs the
``benchmark.patch`` protocol (the first N templates of the shipped
6,662-template bank, ``bench_single.sh:28``'s flags ``-A 0.08 -P 3.0
-f 400.0 -W -z``) on the shipped Arecibo workunit with the reference
binary and with the port's command line, and compares the two candidate
files under the BOINC validator's tolerance (``io/validate.py``).  The
reference sources and their workunit live outside this repository, in
the directory ``tools/refbuild/Makefile`` names ``REF``; without them the
reference step raises and names the missing path.  :func:`compare` is the
diff alone, for any two candidate files of one workunit;
``boundary_analysis.py`` gives the cause of each boundary row.

``--stages OUTDIR`` dumps the f64 oracle's per-stage intermediates
(whitened series, per-template resampled series, power spectra and
harmonic sumspecs, the merged maxima:
``runtime/precision.py::oracle_stage_intermediates``) for the CI audit
geometry (``precision.ci_fixture()``) as one npz plus an
``erp-oracle-stages/1`` sidecar with one sha256 digest per array.  Pure
numpy: it needs no card and no reference checkout, and its arrays are
bitwise the JAX tool's.

Usage:
    python -m boinc_app_eah_brp_tpu_torch.tools.golden_ref [--templates N] [--bank FILE] [--out DIR]
        [--skip-ref] [--skip-tpu] [--json FILE] [--device cuda|cpu]
    python -m boinc_app_eah_brp_tpu_torch.tools.golden_ref --stages OUTDIR

The diff exits 0 iff it passes; ``--json`` records its summary.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REFBUILD = os.path.join(REPO, "tools", "refbuild")
# the shipped workunit, its bank and its zaplist, under the reference sources
TESTWU = os.path.join("debian", "extra", "einstein_bench", "testwu")
WU_NAME = "p2030.20151015.G187.41-00.88.N.b2s0g0.00000_1099.bin4"
BANK_NAME = "stochastic_full.bank"
ZAP_NAME = "p2030.20151015.G187.41-00.88.N.b2s0g0.00000.zap"

SEARCH_FLAGS = ["-A", "0.08", "-P", "3.0", "-f", "400.0", "-W", "-z"]
DEFAULT_OUT = os.path.join(REPO, "boinc_app_eah_brp_tpu_torch", "build", "golden_ref")  # git-ignored
STAGES_SCHEMA = "erp-oracle-stages/1"
NPZ_NAME = "oracle_stages_ci.npz"
SIDECAR_NAME = "oracle_stages_ci.sha256.json"


def padded_t_obs(wu_path: str, padding: float = 3.0) -> float:
    """The padded observation time that bins the output frequencies of a
    search of ``wu_path`` (``demod_binary.c:1640-1642``): padding x
    nsamples x tsample."""
    from ..io.workunit import read_workunit

    wu = read_workunit(wu_path)
    return padding * wu.nsamples * float(wu.header["tsample"]) * 1e-6


def reference_dir() -> str:
    """The reference sources' directory: ``REF`` of
    ``tools/refbuild/Makefile``, which builds the binary from it."""
    with open(os.path.join(REFBUILD, "Makefile")) as f:
        m = re.search(r"^REF\s*\?=\s*(\S+)\s*$", f.read(), re.MULTILINE)
    return m.group(1)


def reference_inputs() -> dict:
    """The shipped workunit, bank and zaplist; a missing one raises and
    names its path (the diff mode never skips quietly)."""
    testwu = os.path.join(reference_dir(), TESTWU)
    paths = {"wu": os.path.join(testwu, WU_NAME), "bank": os.path.join(testwu, BANK_NAME),
             "zap": os.path.join(testwu, ZAP_NAME)}
    for path in paths.values():
        if not os.path.exists(path):
            raise FileNotFoundError(f"the golden diff needs the reference sources' shipped workunit: {path} is missing")
    return paths


def build_ref() -> str:
    """``make -C tools/refbuild``: the reference binary, built from the
    sources in :func:`reference_dir`."""
    ref = reference_dir()
    if not os.path.isdir(ref):
        raise FileNotFoundError(f"the reference binary is built from the reference sources: {ref} is missing")
    subprocess.run(["make", "-C", REFBUILD], check=True)
    return os.path.join(REFBUILD, "build", "einsteinbinary_ref")


def _run(cmd: list, log: str, what: str, env: dict | None = None) -> None:
    t0 = time.time()
    with open(log, "w") as logf:
        subprocess.run(cmd, check=True, env=env, stdout=logf, stderr=subprocess.STDOUT)
    print(f"{what}: {time.time() - t0:.1f}s", file=sys.stderr)


def run_ref(binary: str, bank: str, out_dir: str) -> str:
    """The reference binary on the shipped workunit: ``ref.cand``."""
    inputs = reference_inputs()
    cand = os.path.join(out_dir, "ref.cand")
    cmd = [binary, "-i", inputs["wu"], "-t", bank, "-l", inputs["zap"], "-o", cand,
           "-c", os.path.join(out_dir, "ref.cpt")] + SEARCH_FLAGS
    _run(cmd, os.path.join(out_dir, "ref.log"), "reference binary")
    return cand


def run_port(bank: str, out_dir: str, device: str = "cuda") -> str:
    """The port's command line on the shipped workunit with the
    reference's flags: ``port.cand`` (and ``port.cpt``)."""
    from ._inputs import child_env, cli_cmd

    inputs = reference_inputs()
    cand = os.path.join(out_dir, "port.cand")
    cmd = cli_cmd(inputs["wu"], bank, cand, os.path.join(out_dir, "port.cpt"), "-l", inputs["zap"],
                  *SEARCH_FLAGS, "--device", device)
    _run(cmd, os.path.join(out_dir, "port.log"), "port", env=child_env())
    return cand


def summary(diff, bank: str | None = None) -> dict:
    """The JAX tool's summary of a :class:`~..io.validate.CandidateDiff`."""
    return {
        "bank": os.path.basename(bank) if bank else None,
        "ok": diff.ok,
        "matched": diff.matched,
        "missing": len(diff.missing),
        "extra": len(diff.extra),
        "boundary": len(diff.boundary),
        "mismatches": len(diff.mismatches),
    }


def compare(ref_cand: str, port_cand: str, t_obs: float, bank: str | None = None) -> dict:
    """The golden diff of two candidate files of one workunit under the
    validator's tolerance: the JAX tool's summary."""
    from ..io.validate import compare_candidate_files

    return summary(compare_candidate_files(ref_cand, port_cand, t_obs=t_obs), bank)


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
    ap = argparse.ArgumentParser(description="Golden-diff the port against the reference binary, or dump the "
                                             "f64 oracle's per-stage intermediates.")
    ap.add_argument("--stages", metavar="OUTDIR",
                    help="dump per-stage f64 oracle intermediates for the CI audit geometry (npz + sha256 "
                         "sidecar) and exit; needs neither the reference sources nor a card")
    ap.add_argument("--templates", type=int, default=200)
    ap.add_argument("--bank", default=None, help="explicit bank file (overrides --templates)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-ref", action="store_true", help="reuse the existing ref.cand in --out")
    ap.add_argument("--skip-tpu", action="store_true", help="reuse the port's existing port.cand in --out")
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda", help="the port's device (cuda by default, cpu for a CPU run)")
    args = ap.parse_args(argv)

    if args.stages:
        return dump_stages(args.stages)

    inputs = reference_inputs()
    os.makedirs(args.out, exist_ok=True)
    bank = args.bank
    if bank is None:
        bank = os.path.join(args.out, f"bank{args.templates}.txt")
        with open(inputs["bank"]) as src, open(bank, "w") as dst:
            for i, line in enumerate(src):
                if i >= args.templates:
                    break
                dst.write(line)

    ref_cand = os.path.join(args.out, "ref.cand")
    port_cand = os.path.join(args.out, "port.cand")
    if not args.skip_ref:
        ref_cand = run_ref(build_ref(), bank, args.out)
    if not args.skip_tpu:
        from ._inputs import require_device

        port_cand = run_port(bank, args.out, require_device(args.device))

    from ..io.validate import compare_candidate_files

    diff = compare_candidate_files(ref_cand, port_cand, t_obs=padded_t_obs(inputs["wu"]))
    print(diff.report())
    out = summary(diff, bank)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0 if diff.ok else 1


if __name__ == "__main__":
    sys.exit(main())
