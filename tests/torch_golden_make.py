"""Remake the JAX package's golden for the synthetic production workunit:
``tests/golden/jax_synth200.cand``, ``.cpt`` and ``.json``.

The workunit is the one ``chip_smoke.py``'s whitened search (its phase 4)
runs on the card: ``tools/_inputs.py::production_workunit`` at 2^22
samples, bank200 row ``INJECT``'s orbit from ``SEED``, zapped with
``ZAPLIST``.  The JAX package's command line searches it on the CPU with
phase 4's flags and a checkpoint file (the final checkpoint's toplist is
what ``boundary_analysis`` reads), with the native running median, so
both packages run ``rngmed``.  The sidecar records the inputs' digests
(a workunit's is of its decompressed content), the command, the numpy and
JAX versions, the median that ran, ``t_obs``, the wall time and the row
count.

Run from the repository root (minutes; the median library must be built,
``make -C native``):

    JAX_PLATFORMS=cpu ERP_MEDIAN=native python tests/torch_golden_make.py [--work DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from boinc_app_eah_brp_tpu_torch.io import parse_result_file, read_template_bank  # noqa: E402
from boinc_app_eah_brp_tpu_torch.io.checkpoint import read_checkpoint  # noqa: E402
from boinc_app_eah_brp_tpu_torch.tools import _inputs  # noqa: E402
from boinc_app_eah_brp_tpu_torch.tools.golden_ref import padded_t_obs  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "golden")
BANK = os.path.join(GOLDEN, "bank200.txt")
NAME = "jax_synth200"
# chip_smoke.py phase 4's search flags; the batch only bounds host memory
FLAGS = ["-W", "-P", "3.0", "-f", "400.0", "-A", "0.08", "-B", "1000", "--batch", "8"]
ENV = {"JAX_PLATFORMS": "cpu", "ERP_MEDIAN": "native", "ERP_RESULT_DATE": _inputs.RESULT_DATE}


def make(work: str) -> dict:
    """Write the inputs into ``work``, run the JAX command line there on
    names relative to it (the checkpoint records its input's path), copy
    the candidate file and the checkpoint into ``tests/golden/`` and
    return the sidecar."""
    bank = read_template_bank(BANK)
    P_inj, tau_inj = _inputs.production_workunit(os.path.join(work, "synth200.bin4"), bank, _inputs.INJECT,
                                                 _inputs.SEED)
    shutil.copyfile(BANK, os.path.join(work, "bank200.txt"))
    with open(os.path.join(work, "synth200.zap"), "w") as f:
        f.write(_inputs.ZAPLIST)
    argv = ["-i", "synth200.bin4", "-o", f"{NAME}.cand", "-t", "bank200.txt", "-c", f"{NAME}.cpt",
            "-l", "synth200.zap"] + FLAGS
    env = dict(os.environ, **ENV)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    with open(os.path.join(work, f"{NAME}.log"), "w") as f:
        rc = subprocess.run([sys.executable, "-m", "boinc_app_eah_brp_tpu", *argv], env=env, cwd=work,
                            stdout=f, stderr=subprocess.STDOUT).returncode
    wall = time.perf_counter() - t0
    text = open(os.path.join(work, f"{NAME}.log")).read()
    if rc != 0:
        raise SystemExit(f"the JAX command line exited {rc}:\n{text[-3000:]}")
    medians = [ln.split("Running median path:")[1].strip() for ln in text.splitlines() if "Running median path:" in ln]
    path = {name: os.path.join(work, name) for name in ("synth200.bin4", "synth200.zap", f"{NAME}.cand", f"{NAME}.cpt")}
    parsed = parse_result_file(path[f"{NAME}.cand"])
    if not parsed.done or read_checkpoint(path[f"{NAME}.cpt"]).n_template != len(bank):
        raise SystemExit("the JAX run left no %DONE% file or a checkpoint short of the bank")

    import jax
    import jaxlib
    import numpy as np

    for name in (f"{NAME}.cand", f"{NAME}.cpt"):
        shutil.copyfile(path[name], os.path.join(GOLDEN, name))
    return {
        "schema": "erp-jax-golden/1",
        "workunit": {
            "sha256": _inputs.content_sha256(path["synth200.bin4"]), "samples": _inputs.PRODUCTION_SAMPLES,
            "tsample_us": _inputs.PRODUCTION_TSAMPLE_US, "inject": _inputs.INJECT, "seed": _inputs.SEED,
            "injected": {"P_b": P_inj, "tau": tau_inj},
            "made_by": "boinc_app_eah_brp_tpu_torch/tools/_inputs.py::production_workunit",
        },
        "bank": {"path": "tests/golden/bank200.txt", "sha256": _inputs.content_sha256(BANK), "templates": len(bank)},
        "zaplist": {"text": _inputs.ZAPLIST, "sha256": _inputs.content_sha256(path["synth200.zap"])},
        "command": ["python", "-m", "boinc_app_eah_brp_tpu", *argv],
        "env": ENV,
        "versions": {"python": platform.python_version(), "numpy": np.__version__, "jax": jax.__version__,
                     "jaxlib": jaxlib.__version__},
        "median": medians[-1] if medians else None,
        "t_obs": padded_t_obs(path["synth200.bin4"]),
        "wall_s": wall,
        "rows": len(parsed.lines),
        "files": {name: _inputs.content_sha256(path[name]) for name in (f"{NAME}.cand", f"{NAME}.cpt")},
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", default=None, help="scratch directory for the workunit and the run (a temp dir)")
    args = ap.parse_args(argv)
    work = args.work or tempfile.mkdtemp(prefix="jax_golden_")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    side = make(work)
    with open(os.path.join(GOLDEN, f"{NAME}.json"), "w") as f:
        json.dump(side, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: side[k] for k in ("median", "t_obs", "wall_s", "rows")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
