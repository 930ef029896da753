"""PyTorch port, deployment on the CPU: ``$ERP_RNGMED_LIB`` honoured
exclusively, the shipped kernel libraries of ``$ERP_KERNEL_DIR`` (named by
the digest of the package's sources, refused when missing or mismatched,
never built), ``tools/make_app_info.py`` and ``tools/make_bundle.py``, and
the bundle's zipapp run from outside the repository.

Tolerances: the zipapp's candidate file is byte for byte the command
line's on the same fixture.
"""

import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from boinc_app_eah_brp_tpu_torch.ops import kernels, native_median
from boinc_app_eah_brp_tpu_torch.runtime import metrics
from boinc_app_eah_brp_tpu_torch.tools import _inputs, make_app_info

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "boinc_app_eah_brp_tpu_torch"
BUNDLE_FILES = ("erp_wrapper", "liberp_rngmed.so", "eah_brp_worker.pyz", "app_info.xml", "install.sh", "README.md")


def _build_median(directory: pathlib.Path) -> str:
    out = directory / "liberp_rngmed_test.so"
    subprocess.run(["g++", *native_median.CXX_FLAGS, native_median.SOURCE, "-o", str(out)], check=True)
    return str(out)


def test_rngmed_lib_env_is_exclusive(tmp_path, monkeypatch):
    """``$ERP_RNGMED_LIB`` names the library loaded, and nothing else is
    tried: a path that does not load raises, naming it."""
    lib = _build_median(tmp_path)
    x = np.random.default_rng(5).normal(size=257).astype(np.float32)
    monkeypatch.setattr(native_median, "_lib", None)
    want = native_median.running_median(x, 9)
    monkeypatch.setattr(native_median, "_lib", None)
    monkeypatch.setenv("ERP_RNGMED_LIB", lib)
    np.testing.assert_array_equal(native_median.running_median(x, 9), want)
    assert native_median.load() == lib
    missing = str(tmp_path / "absent" / "liberp_rngmed.so")
    monkeypatch.setattr(native_median, "_lib", None)
    monkeypatch.setenv("ERP_RNGMED_LIB", missing)
    monkeypatch.setattr(native_median, "_built_library", lambda: pytest.fail("probed the build directory"))
    with pytest.raises(RuntimeError, match="absent/liberp_rngmed.so"):
        native_median.running_median(x, 9)
    assert native_median._lib is None


def test_library_names_carry_the_digest_of_the_sources():
    """The digest read through the package loader (a zipapp member alike)
    is the one of the source files and the flags: a library built on the
    card keeps its name in the bundle."""
    for name in kernels.SOURCES:
        key = (PORT / "csrc" / f"{name}.cu").read_bytes() + " ".join(kernels.NVCC_FLAGS).encode()
        assert kernels.library_name(name) == f"lib{name}-{hashlib.sha1(key).hexdigest()[:12]}.so"
        assert kernels.library_path(name) == os.path.join(kernels.BUILD_DIR, kernels.library_name(name))


def _stub_libraries(directory: pathlib.Path, names=None) -> None:
    """Loadable stand-ins for the kernel libraries, exporting every C entry
    the bindings declare, under the names given (default: the real ones)."""
    src = directory / "stub.c"
    fns = [fn for sigs in kernels._SIGNATURES.values() for fn in sigs]
    src.write_text("".join(f"int {fn}(void) {{ return 0; }}\n" for fn in fns))
    for n in kernels.SOURCES:
        out = directory / ((names or {}).get(n) or kernels.library_name(n))
        subprocess.run(["gcc", "-shared", "-fPIC", str(src), "-o", str(out)], check=True)


def test_kernel_dir_loads_the_shipped_libraries_and_builds_nothing(tmp_path, monkeypatch):
    _stub_libraries(tmp_path)
    monkeypatch.setenv(kernels.KERNEL_DIR_ENV, str(tmp_path))
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_nvcc", lambda: pytest.fail("nvcc reached with a kernel directory"))
    assert kernels.build() == 0.0
    metrics.configure(force=True)
    try:
        lib = kernels.library("fold")
        report = metrics.finish(0)
    finally:
        metrics.finish(0)
    assert lib._name == str(tmp_path / kernels.library_name("fold"))
    assert report["metrics"]["counters"]["torch.kernel_builds"]["value"] == 0
    assert set(kernels._libs) == set(kernels.SOURCES)


@pytest.mark.parametrize("what", ["missing", "mismatched"])
def test_kernel_dir_refuses_a_missing_or_mismatched_library(tmp_path, monkeypatch, what):
    if what == "mismatched":
        _stub_libraries(tmp_path, names={"fftprep": "libfftprep-000000000000.so"})
    else:
        _stub_libraries(tmp_path)
        (tmp_path / kernels.library_name("fftprep")).unlink()
    expected = str(tmp_path / kernels.library_name("fftprep"))
    monkeypatch.setenv(kernels.KERNEL_DIR_ENV, str(tmp_path))
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(kernels, "_nvcc", lambda: pytest.fail("nvcc reached with a kernel directory"))
    for call in (kernels.build, lambda: kernels.library("resample")):
        with pytest.raises(RuntimeError, match="missing") as err:
            call()
        assert expected in str(err.value)
        if what == "mismatched":
            assert "libfftprep-000000000000.so" in str(err.value)
    assert kernels._libs == {}
    r = subprocess.run([sys.executable, "-m", "boinc_app_eah_brp_tpu_torch.tools.make_bundle",
                        "--out", str(tmp_path / "bundle")],
                       env=dict(os.environ, PYTHONPATH=str(REPO), ERP_KERNEL_DIR=str(tmp_path)),
                       capture_output=True, text=True)
    assert r.returncode == 1 and expected in r.stderr and "kernels.build()" in r.stderr
    assert not (tmp_path / "bundle").exists()


def test_make_app_info_valid_xml_with_the_cuda_plan_class(tmp_path):
    out = tmp_path / "app_info.xml"
    r = subprocess.run([sys.executable, "-m", "boinc_app_eah_brp_tpu_torch.tools.make_app_info", "-o", str(out)],
                       env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    root = ET.parse(out).getroot()
    assert root.tag == "app_info" and root.find("app/name").text == "einsteinbinary_BRP4"
    av = root.find("app_version")
    assert av.find("app_name").text == "einsteinbinary_BRP4" and int(av.find("version_num").text) == 56
    assert av.find("plan_class").text == make_app_info.PLAN_CLASS == "cuda_sm90a"
    assert av.find("coproc/type").text == "NVIDIA" and av.find("coproc/count").text == "1"
    assert av.find("file_ref/main_program") is not None
    assert "boinc_app_eah_brp_tpu_torch" in av.find("cmdline").text


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """The bundle, built with placeholder kernel libraries named by the
    real digests in ``$ERP_KERNEL_DIR`` (the CPU never loads them)."""
    kdir = tmp_path_factory.mktemp("kernels")
    for n in kernels.SOURCES:
        (kdir / kernels.library_name(n)).write_bytes(b"placeholder")
    out = tmp_path_factory.mktemp("dist") / "bundle"
    r = subprocess.run([sys.executable, "-m", "boinc_app_eah_brp_tpu_torch.tools.make_bundle", "--out", str(out)],
                       env=dict(os.environ, PYTHONPATH=str(REPO), ERP_KERNEL_DIR=str(kdir)),
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return out


def test_make_bundle_produces_installable_dir(bundle):
    libs = [kernels.library_name(n) for n in kernels.SOURCES]
    for name in (*BUNDLE_FILES, *libs):
        assert (bundle / name).exists(), name
    assert os.access(bundle / "install.sh", os.X_OK)
    root = ET.parse(bundle / "app_info.xml").getroot()
    refs = [fr.find("file_name").text for fr in root.findall("app_version/file_ref")]
    assert refs == ["erp_wrapper", "eah_brp_worker.pyz", "liberp_rngmed.so", *libs]
    assert set(refs) == {fi.find("name").text for fi in root.findall("file_info")}
    assert root.find("app_version/file_ref/main_program") is not None
    assert root.find("app_version/plan_class").text == "cuda_sm90a"
    assert "--stderr-file" in root.find("app_version/cmdline").text
    install = (bundle / "install.sh").read_text()
    assert all(name in install for name in ("liberp_rngmed.so", *libs)) and "wisdom" not in install
    assert "sm_90a" in (bundle / "README.md").read_text()
    import zipfile

    members = zipfile.ZipFile(bundle / "eah_brp_worker.pyz").namelist()
    assert "__main__.py" in members and "boinc_app_eah_brp_tpu_torch/csrc/resample.cu" in members
    assert not any("/build/" in m or "__pycache__" in m for m in members)
    rr = subprocess.run([sys.executable, str(bundle / "eah_brp_worker.pyz"), "-h"], capture_output=True, text=True,
                        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert "--input_file" in rr.stdout + rr.stderr  # the command line's usage


def test_bundle_zipapp_gives_the_command_lines_rows(bundle, tmp_path):
    """The zipapp, run from a directory outside the repository with no
    ``PYTHONPATH``, on the fixture with ``--device cpu``: the command
    line's candidate file byte for byte, the median loaded from the
    bundle."""
    run = tmp_path / "slot"
    run.mkdir()
    wu = _inputs.fixture_workunit(str(run / "wu.bin4"), f_signal=33.0)
    bank = _inputs.fixture_bank(str(run / "bank.txt"))
    (run / "zap.txt").write_text("50.0 51.0\n")
    args = ["-i", wu, "-t", bank, "-l", str(run / "zap.txt"), "-W", "-B", "200", "--batch", "2", "--device", "cpu"]
    clean = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "ERP_KERNEL_DIR", "ERP_RNGMED_LIB")}
    clean["ERP_RESULT_DATE"] = _inputs.RESULT_DATE
    z = subprocess.run([sys.executable, str(bundle / "eah_brp_worker.pyz"), *args, "-o", "bundle.cand",
                        "-c", "bundle.cpt"], cwd=str(run), env=clean, capture_output=True, text=True, timeout=300)
    assert z.returncode == 0, z.stderr
    assert f"Running median library: {bundle / 'liberp_rngmed.so'}" in z.stdout
    c = subprocess.run([sys.executable, "-m", "boinc_app_eah_brp_tpu_torch", *args, "-o", "cli.cand",
                        "-c", "cli.cpt"], cwd=str(run), env=dict(clean, PYTHONPATH=str(REPO)),
                       capture_output=True, text=True, timeout=300)
    assert c.returncode == 0, c.stderr
    got, want = (run / "bundle.cand").read_bytes(), (run / "cli.cand").read_bytes()
    assert got == want and got.endswith(b"%DONE%\n") and len(got.splitlines()) > 2
    shutil.rmtree(run)
