"""PyTorch port, the operator knobs against the JAX package on the CPU:
``ERP_RESCORE``, ``ERP_PRECISION`` and ``ERP_MEDIAN``, each set with ``monkeypatch.setenv`` for both drivers on
``test_torch_session.py``'s fixture workunit.

Tolerances:
* ``ERP_RESCORE=off``: the unwhitened rows' frequency, template and
  harmonic columns equal, power and fA within the validator's tolerance
  (``io/validate.py::compare_candidate_rows``): without the rescoring the
  powers are the device FFT's, torch's against XLA's on the CPU.  The
  port's rows equal its own ``--no-rescore`` rows;
* ``ERP_PRECISION`` and ``ERP_MEDIAN=native`` with the library missing:
  the same exception class, or the same exit code;
* ``ERP_MEDIAN=device``, and the knob unset with the library missing:
  both packages whiten with their device median; the rows are held as
  ``ERP_RESCORE=off``'s are (frequency, template and harmonic columns
  equal, power and fA within the validator's tolerance: the whitened
  series passes through each package's FFT library);
* ``check_median``: the same path, or the same refusal, as the JAX
  package's dispatch for every value, with the library and without; on a
  CUDA device the device median unless ``ERP_MEDIAN=native``.
"""

import numpy as np
import pytest

import boinc_app_eah_brp_tpu.models.search as jax_search
import boinc_app_eah_brp_tpu.ops.native_median as jax_native_median
import boinc_app_eah_brp_tpu.oracle.rescore as jax_rescore
import boinc_app_eah_brp_tpu_torch.models.search as search
import boinc_app_eah_brp_tpu_torch.ops.native_median as native_median
import boinc_app_eah_brp_tpu_torch.ops.whiten as whiten
import boinc_app_eah_brp_tpu_torch.oracle.rescore as rescore
from boinc_app_eah_brp_tpu.io import parse_result_file as jax_parse
from boinc_app_eah_brp_tpu.io.validate import compare_candidate_rows
from boinc_app_eah_brp_tpu_torch.runtime.errors import RADPUL_EVAL
from test_torch_session import _run, _rows, workdir  # noqa: F401  (workdir: the fixture)
from torch_parity import DT

SPELLINGS = ["", "off", "OFF", " Off ", "0", "none", "NONE", "on", "1", "yes", "false"]


def _jax_rows(workdir, name):
    parsed = jax_parse(str(workdir["tmp"] / f"{name}.cand"))
    assert parsed.done and len(parsed.lines) > 0
    return parsed.lines


@pytest.mark.parametrize("value", SPELLINGS)
@pytest.mark.parametrize("knob,fn", [("ERP_RESCORE", "rescore_enabled")])
def test_rescore_knob_spellings_match_jax(monkeypatch, knob, fn, value):
    monkeypatch.setenv(knob, value)
    assert getattr(rescore, fn)() == getattr(jax_rescore, fn)()
    assert getattr(rescore, fn)() == (value.strip().lower() not in ("off", "0", "none"))


def test_rescore_off_rows_match_jax(workdir, monkeypatch):
    monkeypatch.setenv("ERP_RESCORE", "off")
    scored = []
    monkeypatch.setattr(rescore, "rescore_winners", lambda *a, **k: scored.append("port"))
    monkeypatch.setattr(jax_rescore, "rescore_winners", lambda *a, **k: scored.append("jax"))
    assert _run("port", workdir, "port") == 0
    assert _run("jax", workdir, "jax") == 0
    assert scored == []
    got, want = _rows(workdir, "port"), _jax_rows(workdir, "jax")
    # unrescored powers are the device FFT's (torch against XLA on the
    # CPU): the frequency, template and harmonic columns are equal, the
    # power and fA within the validator's tolerance
    np.testing.assert_array_equal(got[:, [0, 1, 2, 3, 6]], want[:, [0, 1, 2, 3, 6]])
    diff = compare_candidate_rows(got, want, t_obs=4096 * DT)
    assert diff.ok, diff.report()

    # the knob is --no-rescore: the same rows as the flag gives
    monkeypatch.delenv("ERP_RESCORE")
    from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs, run_search

    args = DriverArgs(
        inputfile=workdir["wu"], templatebank=workdir["bank"], outputfile=str(workdir["tmp"] / "flag.cand"),
        checkpointfile=str(workdir["tmp"] / "flag.cpt"), window=200, batch_size=2, rescore=False, device="cpu",
    )
    assert run_search(args) == 0
    np.testing.assert_array_equal(got, _rows(workdir, "flag"))


@pytest.mark.parametrize("value", [None, "f32", " F32 ", "bf16", "BF16", "xx", "fp16", ""])
def test_erp_precision_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("ERP_PRECISION", raising=False)
    else:
        monkeypatch.setenv("ERP_PRECISION", value)
    outcomes = []
    for fn in (search.erp_precision, jax_search.erp_precision):
        try:
            outcomes.append(("ok", fn()))
        except (NotImplementedError, ValueError) as e:
            outcomes.append((type(e), str(e) if isinstance(e, ValueError) else None))
    assert outcomes[0] == outcomes[1]


def _refuse_device_work(monkeypatch):
    """Every FFT, kernel wrapper and exact mean the search runs fails the
    test: a refused knob must stop the run before them."""

    def refuse(*a, **k):
        raise AssertionError("device work after a refused knob")

    monkeypatch.setattr(whiten, "_forward", refuse)
    monkeypatch.setattr(search, "fftprep_series", refuse)
    monkeypatch.setattr(search, "exact_mean_params", refuse)


@pytest.mark.parametrize("white", [False, True], ids=["unwhitened", "whitened"])
@pytest.mark.parametrize("value,want", [("f32", 0), ("bf16", NotImplementedError), ("xx", RADPUL_EVAL)])
def test_erp_precision_exits_like_jax(workdir, monkeypatch, value, want, white):
    monkeypatch.setenv("ERP_PRECISION", value)
    if want == 0:
        assert _run("port", workdir, "port", white=white) == 0
        assert _run("jax", workdir, "jax", white=white) == 0
        return
    for pkg in ("jax", "port"):
        if pkg == "port":
            _refuse_device_work(monkeypatch)
        if isinstance(want, int):
            assert _run(pkg, workdir, pkg, white=white) == want
        else:
            with pytest.raises(want):
                _run(pkg, workdir, pkg, white=white)
        assert not (workdir["tmp"] / f"{pkg}.cand").exists()


def _forget_median_libraries(monkeypatch):
    monkeypatch.setattr(native_median, "_lib", None)
    monkeypatch.setattr(jax_native_median, "_lib", None)
    monkeypatch.setattr(jax_native_median, "_lib_tried", False)


def test_median_native_without_the_library_is_radpul_eval_in_both(workdir, monkeypatch):
    monkeypatch.setenv("ERP_MEDIAN", "native")
    monkeypatch.setenv("ERP_RNGMED_LIB", str(workdir["tmp"] / "absent" / "liberp_rngmed.so"))
    _forget_median_libraries(monkeypatch)
    assert _run("jax", workdir, "jax", white=True) == RADPUL_EVAL
    _refuse_device_work(monkeypatch)
    assert _run("port", workdir, "port", white=True) == RADPUL_EVAL
    for pkg in ("jax", "port"):
        assert not (workdir["tmp"] / f"{pkg}.cand").exists()


def test_median_native_with_the_library_is_the_default_run(workdir, monkeypatch):
    assert _run("port", workdir, "default", white=True) == 0
    monkeypatch.setenv("ERP_MEDIAN", "native")
    assert _run("port", workdir, "native", white=True) == 0
    np.testing.assert_array_equal(_rows(workdir, "native"), _rows(workdir, "default"))


def _count_device_medians(monkeypatch) -> list:
    """Each package's device median, counted; the port's native median
    fails the test."""
    import boinc_app_eah_brp_tpu.ops.whiten as jax_whiten

    calls = []
    for mod, tag in ((whiten, "port"), (jax_whiten, "jax")):
        real = mod.running_median

        def counted(*a, _real=real, _tag=tag, **k):
            calls.append(_tag)
            return _real(*a, **k)

        monkeypatch.setattr(mod, "running_median", counted)
    monkeypatch.setattr(native_median, "running_median", lambda *a, **k: pytest.fail("the native median ran"))
    return calls


def _assert_device_rows_match_jax(workdir):
    got, want = _rows(workdir, "port"), _jax_rows(workdir, "jax")
    np.testing.assert_array_equal(got[:, [0, 1, 2, 3, 6]], want[:, [0, 1, 2, 3, 6]])
    diff = compare_candidate_rows(got, want, t_obs=4096 * DT)
    assert diff.ok, diff.report()


def test_median_device_runs_in_both_packages_and_rows_agree(workdir, monkeypatch, capfd):
    """``ERP_MEDIAN=device`` in both packages: an unwhitened run takes no
    median in either package; each whitened command line logs the device
    path, whitens with its device median once and writes a file, and the
    rows agree."""
    monkeypatch.setenv("ERP_MEDIAN", "device")
    calls = _count_device_medians(monkeypatch)
    assert _run("port", workdir, "unwhitened") == 0
    assert _run("jax", workdir, "jax_unwhitened") == 0
    assert calls == []
    capfd.readouterr()
    assert _run("port", workdir, "port", white=True) == 0
    assert "Running median path: device" in capfd.readouterr().err
    assert _run("jax", workdir, "jax", white=True) == 0
    assert "Running median path: device" in capfd.readouterr().err
    assert calls == ["port", "jax"]
    _assert_device_rows_match_jax(workdir)


def test_median_unset_without_the_library_takes_the_device_median_in_both(workdir, monkeypatch):
    """``ERP_MEDIAN`` unset and a native library that does not load: both
    packages fall back to their device median and write a file, and the
    rows agree."""
    monkeypatch.delenv("ERP_MEDIAN", raising=False)
    monkeypatch.setenv("ERP_RNGMED_LIB", str(workdir["tmp"] / "absent" / "liberp_rngmed.so"))
    _forget_median_libraries(monkeypatch)
    calls = _count_device_medians(monkeypatch)
    assert _run("port", workdir, "port", white=True) == 0
    assert _run("jax", workdir, "jax", white=True) == 0
    assert calls == ["port", "jax"]
    _assert_device_rows_match_jax(workdir)


@pytest.mark.parametrize("library", ["loads", "missing"])
def test_check_median_refuses_device_only(monkeypatch, tmp_path, library):
    """``check_median`` resolves every value as the JAX package's dispatch
    (``ops/whiten.py:198-218``) does, the value compared as given:
    ``native`` with no library is ``RADPUL_EVAL``, ``device`` or no
    library the device median, anything else the native one.  (The name
    is from when the port refused ``device``.)"""
    from boinc_app_eah_brp_tpu_torch.runtime.errors import RadpulError

    lib = native_median.load() if library == "loads" else str(tmp_path / "absent" / "liberp_rngmed.so")
    monkeypatch.setenv("ERP_RNGMED_LIB", lib)
    for value in ("", "auto", "Native", "native", "device", "DEVICE", " device"):
        monkeypatch.setenv("ERP_MEDIAN", value)
        _forget_median_libraries(monkeypatch)
        have = jax_native_median.native_available()
        assert have == (library == "loads")
        want = "refused" if value == "native" and not have else "native" if value != "device" and have else "device"
        try:
            got = whiten.check_median()
        except RadpulError as e:
            assert e.code == RADPUL_EVAL
            got = "refused"
        assert got == want, value


def _jax_median(value, have: bool) -> str:
    """The JAX package's median dispatch (``ops/whiten.py:198-218``) for an
    ``ERP_MEDIAN`` value (None: unset) with the native library loading or
    not: its path, or ``"refused"`` for ``RADPUL_EVAL``."""
    value = value or ""
    return "refused" if value == "native" and not have else "native" if value != "device" and have else "device"


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("library", ["loads", "missing"])
@pytest.mark.parametrize("value", [None, "", "auto", "Native", "native", "device", "DEVICE", " device"])
def test_check_median_resolves_by_device(monkeypatch, capfd, device, library, value):
    """``check_median(device)`` with the native library loading or missing
    (``available`` and ``load`` monkeypatched, so no card is needed to
    resolve): on the CPU the JAX package's answer, value for value; on a
    CUDA device the device median, where the spectrum is, for every value
    but ``native``, which still takes the host median there and is
    ``RADPUL_EVAL`` without the library.  The log line names the path."""
    from boinc_app_eah_brp_tpu_torch.runtime.errors import RadpulError

    have = library == "loads"

    def load():
        if not have:
            raise RadpulError(RADPUL_EVAL, "the native running median does not load")
        return "liberp_rngmed.so"

    monkeypatch.setattr(native_median, "available", lambda: have)
    monkeypatch.setattr(native_median, "load", load)
    if value is None:
        monkeypatch.delenv("ERP_MEDIAN", raising=False)
    else:
        monkeypatch.setenv("ERP_MEDIAN", value)
    want = _jax_median(value, have) if device == "cpu" or value == "native" else "device"
    capfd.readouterr()
    try:
        got = whiten.check_median(device)
    except RadpulError as e:
        assert e.code == RADPUL_EVAL
        got = "refused"
    assert got == want
    if got != "refused":
        label = "native C++ on the host" if got == "native" else f"device, on the {'card' if device == 'cuda' else 'CPU'}"
        assert f"Running median path: {label}" in capfd.readouterr().err


def test_step_cache_key_folds_the_precision_mode(monkeypatch):
    """The mode is part of the residency key, as in the JAX package's
    ``step_cache_key``; a mode no step runs cannot make a key."""
    from boinc_app_eah_brp_tpu_torch.oracle.pipeline import DerivedParams, SearchConfig

    d = DerivedParams.derive(4096, DT * 1e6, SearchConfig(window=200))
    geom = search.SearchGeometry.from_derived(d, max_slope=1.0, lut_step=1.0, lut_tiles=1)
    monkeypatch.delenv("ERP_PRECISION", raising=False)
    k0 = search.step_cache_key(geom, 4, "cpu")
    assert k0[-1] == "f32" == jax_search.erp_precision()
    monkeypatch.setenv("ERP_PRECISION", " F32 ")
    assert search.step_cache_key(geom, 4, "cpu") == k0
    monkeypatch.setenv("ERP_PRECISION", "bf16")
    with pytest.raises(NotImplementedError):
        search.step_cache_key(geom, 4, "cpu")
    monkeypatch.setenv("ERP_PRECISION", "xx")
    with pytest.raises(ValueError):
        search.step_cache_key(geom, 4, "cpu")


@pytest.mark.parametrize("value,want", [("bf16", 5), ("xx", RADPUL_EVAL)])
def test_refused_precision_exits_alike_through_both_command_lines(workdir, monkeypatch, value, want):
    """Through the command line the unmapped ``NotImplementedError`` of
    ``bf16`` is RADPUL_EMISC in both packages, ``ValueError`` RADPUL_EVAL
    (the JAX package on one device: see the mesh case below)."""
    from boinc_app_eah_brp_tpu.runtime.cli import main as jax_main
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main as port_main
    from boinc_app_eah_brp_tpu_torch.runtime.errors import RADPUL_EMISC

    assert RADPUL_EMISC == 5
    monkeypatch.setenv("ERP_PRECISION", value)
    for pkg, main, extra in (("jax", jax_main, "--mesh 1"), ("port", port_main, "--device cpu")):
        argv = f"-i {workdir['wu']} -o {workdir['tmp'] / pkg}.cand -t {workdir['bank']} -B 200 --batch 2 {extra}"
        assert main(argv.split()) == want
        assert not (workdir["tmp"] / f"{pkg}.cand").exists()


def test_refused_precision_on_a_mesh_is_refused_by_the_port_and_ignored_by_jax(workdir, monkeypatch):
    """A recorded divergence: the JAX package's sharded step never reads
    ERP_PRECISION, so over a two-device mesh it searches at f32 and exits
    0; the port's sharded step is built from BankStep and refuses."""
    from boinc_app_eah_brp_tpu.runtime.cli import main as jax_main
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main as port_main

    monkeypatch.setenv("ERP_PRECISION", "xx")
    monkeypatch.setenv("ERP_LOCAL_DEVICES", "2")
    argv = f"-i {workdir['wu']} -t {workdir['bank']} -B 200 --batch 2 --mesh 2"
    assert jax_main(f"{argv} -o {workdir['tmp'] / 'jax.cand'}".split()) == 0
    assert port_main(f"{argv} -o {workdir['tmp'] / 'port.cand'} --device cpu".split()) == RADPUL_EVAL
    assert not (workdir["tmp"] / "port.cand").exists()
