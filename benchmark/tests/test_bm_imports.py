"""What the benchmark loads: no process of it holds JAX or the JAX
package, and the reference and the judge hold nothing of the program.
Top-level module names (the part before the first dot) are compared
whole: the program's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from bmlib import harness  # noqa: E402

JAX = {"jax", "jaxlib", "flax", "boinc_app_eah_brp_tpu"}
PROGRAM = "boinc_app_eah_brp_tpu_torch"
# the reference side: the plain reference, the judge, the control
REFERENCE = ("bmlib.reference", "bmlib.judge", "bmlib.cands", "bmlib.gslrng", "bmlib.inputs", "control")


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {HERE!r}); {code}; "
         "print('\\n'.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": ""},
    )
    return set(out.stdout.split())


def test_the_reference_loads_neither_jax_nor_the_program():
    tops = _loaded("; ".join(f"import {m}" for m in REFERENCE))
    assert not tops & (JAX | {PROGRAM}), tops & (JAX | {PROGRAM})


def test_the_harness_and_drivers_load_no_jax():
    code = ("from bmlib import harness; harness.import_program(); "
            "[harness.load_module('drivers', d) for d in ('bank_passes', 'served', 'cli')]; "
            "[harness.load_module('readers', r) for r in ('roofline', 'device_idle', 'peak_memory', 'phase_per_wu', 'startup')]; "
            "import boinc_app_eah_brp_tpu_torch.serving, boinc_app_eah_brp_tpu_torch.runtime.cli, "
            "boinc_app_eah_brp_tpu_torch.models.search, boinc_app_eah_brp_tpu_torch.ops.whiten")
    tops = _loaded(code)
    assert PROGRAM in tops and not tops & JAX, tops & JAX


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_under_the_folder_imports_jax():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                assert not _imports(os.path.join(d, f)) & JAX, f


@pytest.mark.parametrize("name", ["reference.py", "judge.py", "cands.py", "gslrng.py", "inputs.py"])
def test_no_reference_source_imports_the_program(name):
    assert PROGRAM not in _imports(os.path.join(HERE, "bmlib", name))


def test_names_are_compared_whole():
    assert harness.forbidden_modules({"boinc_app_eah_brp_tpu_torch.ops": 1, "jaxtyping": 1, "numpy": 1}) == []
    assert harness.forbidden_modules({"boinc_app_eah_brp_tpu.ops": 1, "jax.numpy": 1, "flax": 1}) == [
        "boinc_app_eah_brp_tpu.ops", "flax", "jax.numpy"]


def test_without_a_card_there_is_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload", "palfa6662.search", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_alone_with_its_manifest_the_benchmark_gives_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's folder:
    the program is missing, and the run exits non-zero with no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "palfa6662.search", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path, env={**os.environ, "PYTHONPATH": ""},
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
