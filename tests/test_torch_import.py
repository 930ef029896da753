"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points run on the CPU when asked to."""

import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "boinc_app_eah_brp_tpu_torch"

_PROBE = """
import sys
import numpy as np
from boinc_app_eah_brp_tpu_torch.io import write_template_bank, write_workunit, TemplateBank
from boinc_app_eah_brp_tpu_torch.runtime.cli import main

rng = np.random.default_rng(0)
write_workunit("wu.bin4", np.clip(np.round(rng.normal(4, 1, 2048)), 0, 15).astype(np.float32),
               tsample_us=500.0, scale=1.0)
write_template_bank("bank.dat", TemplateBank(np.array([1000.0, 2.0]), np.array([0.0, 0.03]),
                                             np.array([0.0, 1.0])))
open("zap.txt", "w").write("50.0 51.0\\n")
rc = main("-i wu.bin4 -o out.cand -t bank.dat -l zap.txt -W -B 100 --batch 2 --device cpu".split())
assert rc == 0, rc
assert open("out.cand").read().endswith("%DONE%\\n")
# the JAX driver's defaults: unwhitened, a checkpoint file, oracle rescoring
rc = main("-i wu.bin4 -o out2.cand -t bank.dat -c cp.bin -B 100 --batch 2 --device cpu".split())
assert rc == 0, rc
assert open("out2.cand").read().endswith("%DONE%\\n")
# the serving tier: one resident server, the same workunit
from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs
from boinc_app_eah_brp_tpu_torch.serving import FleetServer
with FleetServer(name="probe", device="cpu") as server:
    res = server.process(DriverArgs(inputfile="wu.bin4", outputfile="out3.cand", templatebank="bank.dat",
                                    window=100, batch_size=2, device="cpu"))
assert res.ok, res
assert open("out3.cand").read().endswith("%DONE%\\n")
# the fabric's server backend over the same tier, and the tools' checks
from boinc_app_eah_brp_tpu_torch.fabric import ServerBackend
from boinc_app_eah_brp_tpu_torch.tools import report_check
with ServerBackend(name="probe-fabric", device="cpu") as backend:
    data = backend.compute(DriverArgs(inputfile="wu.bin4", outputfile="out4.cand", templatebank="bank.dat",
                                      window=100, batch_size=2))
assert data.endswith(b"%DONE%\\n")
from boinc_app_eah_brp_tpu_torch.fabric import HostModel, Replica, validate_single
open("r.cand", "wb").write(HostModel(host_id=3).compute("wu", data, 7)[0])
out = validate_single("wu", Replica(host_id=3, path="r.cand", bank_epoch=7), 2048 * 500e-6, expected_epoch=7,
                      outdir="verdicts")
assert out.granted, out.doc
assert report_check.check_path(out.path) == ("erp-quorum/1", [])
assert "jax" not in sys.modules, "jax imported"
assert not [m for m in sys.modules if m.startswith("boinc_app_eah_brp_tpu.")
            or m == "boinc_app_eah_brp_tpu"], "JAX package imported"
print("ok")
"""


def test_port_cpu_path_imports_no_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


RUNTIME_LAYERS = (
    "percentiles", "metrics", "tracing", "flightrec", "obs", "profiling", "steptime",
    "autobatch", "faultinject", "resilience", "watchdog", "supervise", "errors", "scheduler",
    "health", "devicecost", "roofline", "precision", "artifacts",
)
SERVING = ("journal", "slo", "introspect", "server")


def test_runtime_layers_import_neither_torch_nor_jax():
    """The observability and resilience layers are host code: importing
    them loads neither torch nor jax (nor the JAX package)."""
    probe = (
        "import sys\n"
        + "".join(f"import boinc_app_eah_brp_tpu_torch.runtime.{m}\n" for m in RUNTIME_LAYERS)
        + "bad = [m for m in sys.modules if m in ('torch', 'jax') or m.startswith('boinc_app_eah_brp_tpu.')]\n"
        + "assert not bad, bad\nprint('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    for m in RUNTIME_LAYERS:
        assert (PORT / "runtime" / f"{m}.py").is_file()


def test_serving_imports_neither_torch_nor_jax():
    """The serving tier (the FleetServer, its journal, SLO monitor and
    introspection) is host code: importing it loads neither torch nor jax;
    torch comes in with the first session."""
    probe = (
        "import sys\n"
        "import boinc_app_eah_brp_tpu_torch.serving\n"
        + "".join(f"import boinc_app_eah_brp_tpu_torch.serving.{m}\n" for m in SERVING)
        + "bad = [m for m in sys.modules if m in ('torch', 'jax') or m.startswith('boinc_app_eah_brp_tpu.')]\n"
        + "assert not bad, bad\nprint('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    for m in SERVING:
        assert (PORT / "serving" / f"{m}.py").is_file()


FABRIC = ("hosts", "validator", "workfabric")
TOOLS = ("_inputs", "fleet_report", "report_check", "fabric_soak", "fleet_bench", "chaos_soak",
         "serving_chaos", "precision_audit", "trace_report", "bench", "batch_sweep", "stagebench",
         "make_app_info", "make_bundle")


def test_fabric_and_tools_import_neither_torch_nor_jax():
    """The fabric (hosts, validator, scheduler) and the tools are host
    code: importing them loads neither torch nor jax; torch comes in with
    a ServerBackend or a tool's first run."""
    probe = (
        "import sys\n"
        "import boinc_app_eah_brp_tpu_torch.fabric, boinc_app_eah_brp_tpu_torch.tools\n"
        + "".join(f"import boinc_app_eah_brp_tpu_torch.fabric.{m}\n" for m in FABRIC)
        + "".join(f"import boinc_app_eah_brp_tpu_torch.tools.{m}\n" for m in TOOLS)
        + "bad = [m for m in sys.modules if m in ('torch', 'jax') or m.startswith('boinc_app_eah_brp_tpu.')]\n"
        + "assert not bad, bad\nprint('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    for sub, names in (("fabric", FABRIC), ("tools", TOOLS)):
        for m in names:
            assert (PORT / sub / f"{m}.py").is_file()


def test_port_sources_name_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"boinc_app_eah_brp_tpu\.|from jax|import jax")
    scanned = [p for p in sorted(PORT.rglob("*")) if p.suffix in (".py", ".cu", ".cuh")]
    offenders = [str(p.relative_to(REPO)) for p in scanned if pattern.search(p.read_text())]
    assert not offenders, offenders
    for sub in ("fabric", "tools"):
        assert any(p.parent.name == sub for p in scanned), sub
