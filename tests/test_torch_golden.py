"""PyTorch port, the golden diff against the JAX package's tools:
``tools/golden_ref.py``'s diff (``compare``) and
``tools/boundary_analysis.py`` (``classify_boundary``, ``analyse``,
``main``), on crafted candidate files and checkpoints that hit every
cause, and end to end at the fixture size: a seeded 2^14-sample workunit
and 16 templates searched by the JAX command line and by the port's with
``--device cpu``.  Beside them: the production workunit's digest pinned to
the committed JAX golden (``tests/golden/jax_synth200.json``, which
``tests/torch_golden_make.py`` writes), the reference mode's guard, and
the twins of ``tests/test_refbuild.py``.

Tolerances: the tools' results equal the JAX tools' exactly (dicts, JSON
documents, exit codes); the end-to-end diff under the validator's
defaults (``power_rtol`` 1.5e-2, ``fa_atol`` 0.15, ``param_rtol`` 1e-9):
``ok`` with 0 mismatches.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from boinc_app_eah_brp_tpu.io import parse_result_file as jax_parse
from boinc_app_eah_brp_tpu.io.validate import compare_candidate_files as jax_compare
from boinc_app_eah_brp_tpu_torch.io import (
    TemplateBank, parse_result_file, read_template_bank, write_template_bank, write_workunit,
)
from boinc_app_eah_brp_tpu_torch.io.checkpoint import Checkpoint, write_checkpoint
from boinc_app_eah_brp_tpu_torch.io.formats import CP_CAND_DTYPE, N_CAND
from boinc_app_eah_brp_tpu_torch.oracle.stats import chisq_Qinv
from boinc_app_eah_brp_tpu_torch.tools import _inputs
from boinc_app_eah_brp_tpu_torch.tools import boundary_analysis as p_boundary
from boinc_app_eah_brp_tpu_torch.tools import golden_ref as p_golden_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
REFBUILD = os.path.join(REPO, "tools", "refbuild")
sys.path.insert(0, os.path.join(REPO, "tools"))

import boundary_analysis as j_boundary  # noqa: E402

T_OBS = 800.0  # the crafted files' padded observation time
TPL = (700.0, 0.1, 1.0)  # the crafted rows' template
OTHER_TPL = (650.0, 0.12, 2.0)


def _row(bin_idx, fa, n_harm=4, tpl=TPL):
    return (bin_idx / T_OBS, *tpl, 20.0 + fa, fa, n_harm)


def _write_cand(path, rows, done=True):
    with open(path, "w") as f:
        for r in rows:
            f.write("%.12f %.12f %.12f %.12f %g %g %d\n" % tuple(r))
        if done:
            f.write("%DONE%\n")
    return path


def _write_cpt(path, entries):
    """A checkpoint whose toplist holds ``entries`` (bin, n_harm, fA,
    template): each power is the one whose false-alarm value is fA."""
    cands = np.zeros(N_CAND, dtype=CP_CAND_DTYPE)
    for i, (bin_idx, n_harm, fa, tpl) in enumerate(entries):
        cands[i] = (chisq_Qinv(10.0 ** -fa, 2 * n_harm) / 2.0, *tpl, fa, n_harm, bin_idx)
    write_checkpoint(path, Checkpoint(n_template=16, originalfile="wu.bin4", candidates=cands))
    return path


# 96 rows both files hold, then four rows each file holds alone.  The
# reference's weakest row is fA 6.05, the port's 6.08, both files 100 rows.
COMMON = [_row(1000 + i, round(9.0 - 0.03 * i, 2)) for i in range(96)]
REF_ONLY = [_row(3000, 6.10), _row(3100, 6.05), _row(3500, 6.10), _row(3600, 6.2)]
PORT_ONLY = [_row(3000, 6.12, n_harm=2), _row(3200, 6.08), _row(3300, 6.09), _row(3400, 6.11)]
# what each run's own toplist says of rows the other file holds alone
PORT_CPT = [(3100, 4, 6.0, TPL), (3500, 4, 6.5, TPL), (3600, 4, 6.0, OTHER_TPL)]
REF_CPT = [(3000, 2, 6.0, TPL), (3200, 4, 6.0, OTHER_TPL), (3400, 4, 6.3, TPL)]


@pytest.fixture
def crafted(tmp_path):
    return dict(
        ref=_write_cand(str(tmp_path / "ref.cand"), COMMON + REF_ONLY),
        port=_write_cand(str(tmp_path / "port.cand"), COMMON + PORT_ONLY),
        ref_cpt=_write_cpt(str(tmp_path / "ref.cpt"), REF_CPT),
        port_cpt=_write_cpt(str(tmp_path / "port.cpt"), PORT_CPT),
        tmp=tmp_path,
    )


# (case, key, the side that holds it, with the other side's checkpoint, the cause)
CASES = [
    ("dedup", (3000, 4), "ref", True, "dedup"),
    ("cap-cutoff, other side's view", (3100, 4), "ref", True, "cap-cutoff"),
    ("cap-cutoff, no checkpoint", (3100, 4), "ref", False, "cap-cutoff"),
    ("cap-cutoff, another template won there", (3600, 4), "ref", True, "cap-cutoff"),
    ("cap-cutoff, the other side's n_harm lost", (3000, 2), "port", True, "cap-cutoff"),
    ("cap-cutoff, another template, port side", (3200, 4), "port", True, "cap-cutoff"),
    ("threshold, other side's view", (3500, 4), "ref", True, "threshold"),
    ("threshold, own view above the floor", (3400, 4), "port", True, "threshold"),
    ("threshold, not in the other toplist", (3300, 4), "port", True, "threshold"),
    ("threshold, no checkpoint", (3600, 4), "ref", False, "threshold"),
]


@pytest.mark.parametrize("case,key,side,with_cpt,cause", CASES, ids=[c[0] for c in CASES])
def test_classify_boundary_matches_jax(crafted, case, key, side, with_cpt, cause):
    j = {s: j_boundary._by_key(jax_parse(crafted[s]).lines, T_OBS) for s in ("ref", "port")}
    p = {s: p_boundary._by_key(parse_result_file(crafted[s]).lines, T_OBS) for s in ("ref", "port")}
    other = "port" if side == "ref" else "ref"
    cpt = crafted[f"{other}_cpt"] if with_cpt else None
    want = j_boundary.classify_boundary(key, j[side], j[other], T_OBS, other_cpt=cpt)
    got = p_boundary.classify_boundary(key, p[side], p[other], T_OBS, other_cpt=cpt)
    assert got == want
    assert got["cause"] == cause, got


def _jax_main_out(monkeypatch, tmp, t_obs, ref, port, ref_cpt, port_cpt):
    """The JAX tool's ``main`` on these files: (exit code, its JSON)."""
    out = str(tmp / "jax_boundary.json")
    monkeypatch.setattr(j_boundary, "padded_t_obs", lambda: t_obs)
    monkeypatch.setattr(sys, "argv", ["boundary_analysis.py", "--ref", ref, "--tpu", port, "--ref-cpt", ref_cpt,
                                      "--tpu-cpt", port_cpt, "--json", out])
    rc = j_boundary.main()
    with open(out) as f:
        return rc, json.load(f)


def _t_obs_workunit(path, t_obs):
    """A 16-sample workunit whose padded observation time is ``t_obs``."""
    write_workunit(path, np.full(16, 4.0, np.float32), tsample_us=t_obs / (3.0 * 16) * 1e6)
    return path


def test_analyse_and_main_match_jax(crafted, monkeypatch, capsys):
    c = crafted
    rc, want = _jax_main_out(monkeypatch, c["tmp"], T_OBS, c["ref"], c["port"], c["ref_cpt"], c["port_cpt"])
    got = p_boundary.analyse(c["ref"], c["port"], c["ref_cpt"], c["port_cpt"], T_OBS)
    assert json.loads(json.dumps(got)) == want
    assert {e["cause"] for e in got["boundary"]} == {"dedup", "cap-cutoff", "threshold"}
    assert len(got["boundary"]) == 8 and got["matched"] == 96

    wu = _t_obs_workunit(str(c["tmp"] / "wu.bin4"), T_OBS)
    assert p_golden_ref.padded_t_obs(wu) == pytest.approx(T_OBS, rel=1e-12)
    out = str(c["tmp"] / "port_boundary.json")
    p_rc = p_boundary.main(["--wu", wu, "--ref", c["ref"], "--tpu", c["port"], "--ref-cpt", c["ref_cpt"],
                            "--tpu-cpt", c["port_cpt"], "--json", out])
    assert p_rc == rc == 1  # a threshold cause
    with open(out) as f:
        assert json.load(f) == want
    assert "8 boundary candidates, causes: cap-cutoff, dedup, threshold" in capsys.readouterr().out


def _compare_pairs(tmp):
    rows = COMMON + REF_ONLY
    a = _write_cand(str(tmp / "a.cand"), rows)
    pairs = {
        "crafted": (a, _write_cand(str(tmp / "b.cand"), COMMON + PORT_ONLY)),
        "identical": (a, _write_cand(str(tmp / "same.cand"), rows)),
        "power off by 5%": (a, _write_cand(str(tmp / "power.cand"), [_row(1000, 9.0)[:4] + (29.0 * 1.05, 9.0, 4)]
                                           + rows[1:])),
        "no %DONE%": (a, _write_cand(str(tmp / "undone.cand"), rows, done=False)),
        "a top row moved": (a, _write_cand(str(tmp / "moved.cand"), [_row(1001, 9.5)] + rows[1:])),
    }
    return pairs


@pytest.mark.parametrize("pair", ["crafted", "identical", "power off by 5%", "no %DONE%", "a top row moved"])
def test_compare_matches_jax_summary(tmp_path, pair):
    a, b = _compare_pairs(tmp_path)[pair]
    d = jax_compare(a, b, t_obs=T_OBS)
    want = {"bank": "bank200.txt", "ok": d.ok, "matched": d.matched, "missing": len(d.missing),
            "extra": len(d.extra), "boundary": len(d.boundary), "mismatches": len(d.mismatches)}
    assert p_golden_ref.compare(a, b, T_OBS, bank="tests/golden/bank200.txt") == want
    assert want["ok"] == (pair in ("crafted", "identical"))


# ---- end to end at the fixture size ----

N_E2E = 1 << 14
FLAGS = ["-A", "0.08", "-P", "3.0", "-f", "400.0", "-W", "-B", "200", "--batch", "4"]


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The JAX command line and the port's (``--device cpu``) on one seeded
    workunit, 16 templates, whitened with a zaplist, each with its
    checkpoint."""
    work = tmp_path_factory.mktemp("golden_e2e")
    wu = str(work / "wu.bin4")
    ts = _inputs.pulsed_series(N_E2E, _inputs.TSAMPLE_US, _inputs.ORBIT, 33.0, 7.0, seed=5)
    write_workunit(wu, ts, tsample_us=_inputs.TSAMPLE_US, scale=1.0)
    rng = np.random.default_rng(16)
    P, tau, psi = _inputs.ORBIT
    bank = str(work / "bank.txt")
    write_template_bank(bank, TemplateBank(
        np.concatenate([[1000.0, P], rng.uniform(1.6, 3.0, 14)]),
        np.concatenate([[0.0, tau], rng.uniform(0.0, 0.09, 14)]),
        np.concatenate([[0.0, psi], rng.uniform(0.0, 2 * np.pi, 14)]),
    ))
    zap = str(work / "zap.txt")
    with open(zap, "w") as f:
        f.write("50.0 51.0\n120.0 121.5\n")
    out = {"wu": wu, "tmp": work}
    for side, module, extra in (("ref", "boinc_app_eah_brp_tpu", []),
                                ("port", "boinc_app_eah_brp_tpu_torch", ["--device", "cpu"])):
        cand, cpt = str(work / f"{side}.cand"), str(work / f"{side}.cpt")
        cmd = [sys.executable, "-m", module, "-i", wu, "-o", cand, "-t", bank, "-c", cpt, "-l", zap, *FLAGS, *extra]
        r = subprocess.run(cmd, env=_inputs.child_env(JAX_PLATFORMS="cpu"), capture_output=True, text=True,
                           timeout=600)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
        out[side], out[f"{side}_cpt"] = cand, cpt
    return out


def test_e2e_golden_diff_is_ok(e2e):
    t_obs = p_golden_ref.padded_t_obs(e2e["wu"])
    assert t_obs == pytest.approx(3.0 * N_E2E * _inputs.TSAMPLE_US * 1e-6)
    s = p_golden_ref.compare(e2e["ref"], e2e["port"], t_obs, bank="bank.txt")
    assert s["ok"] and s["mismatches"] == 0 and s["missing"] == 0 and s["extra"] == 0, s
    assert s["matched"] >= 8, s
    # the injected orbit's row leads both files
    for side in ("ref", "port"):
        top = parse_result_file(e2e[side]).lines[0]
        assert abs(top[1] - _inputs.ORBIT[0]) < 1e-6 and abs(top[2] - _inputs.ORBIT[1]) < 1e-6, top


def test_e2e_boundary_analysis_exits_0_and_matches_jax(e2e, monkeypatch):
    e = e2e
    t_obs = p_golden_ref.padded_t_obs(e["wu"])
    rc, want = _jax_main_out(monkeypatch, e["tmp"], t_obs, e["ref"], e["port"], e["ref_cpt"], e["port_cpt"])
    out = str(e["tmp"] / "port_boundary.json")
    assert p_boundary.main(["--wu", e["wu"], "--ref", e["ref"], "--tpu", e["port"], "--ref-cpt", e["ref_cpt"],
                            "--tpu-cpt", e["port_cpt"], "--json", out]) == rc == 0
    with open(out) as f:
        assert json.load(f) == want


# ---- the committed JAX golden of the production workunit ----


def _sidecar():
    with open(os.path.join(GOLDEN, "jax_synth200.json")) as f:
        return json.load(f)


def test_production_workunit_digest_is_the_goldens(tmp_path):
    """The workunit ``chip_smoke.py`` searches, rebuilt from
    ``tools/_inputs.py``, is the one the JAX golden was made from; so are
    the bank and the zaplist, and the committed files are the sidecar's."""
    side = _sidecar()
    bank = read_template_bank(os.path.join(GOLDEN, "bank200.txt"))
    wu = str(tmp_path / "synth200.bin4")
    P_inj, tau_inj = _inputs.production_workunit(wu, bank, _inputs.INJECT, _inputs.SEED)
    assert _inputs.content_sha256(wu) == side["workunit"]["sha256"]
    assert (side["workunit"]["inject"], side["workunit"]["seed"]) == (_inputs.INJECT, _inputs.SEED)
    assert side["workunit"]["injected"] == {"P_b": P_inj, "tau": tau_inj}
    assert _inputs.content_sha256(os.path.join(GOLDEN, "bank200.txt")) == side["bank"]["sha256"]
    assert side["zaplist"]["text"] == _inputs.ZAPLIST
    for name, digest in side["files"].items():
        assert _inputs.content_sha256(os.path.join(GOLDEN, name)) == digest
    assert p_golden_ref.padded_t_obs(wu) == side["t_obs"]


def test_jax_golden_holds_the_injected_row():
    side = _sidecar()
    rows = parse_result_file(os.path.join(GOLDEN, "jax_synth200.cand"))
    assert rows.done and len(rows.lines) == side["rows"] == 100
    inj = side["workunit"]["injected"]
    top = rows.lines[:5]
    assert any(abs(r[1] - inj["P_b"]) < 1e-6 * inj["P_b"] and abs(r[2] - inj["tau"]) < 1e-6 for r in top)
    assert side["median"] == "native C++" and side["env"]["ERP_MEDIAN"] == "native"
    s = p_golden_ref.compare(os.path.join(GOLDEN, "jax_synth200.cand"), os.path.join(GOLDEN, "jax_synth200.cand"),
                             side["t_obs"])
    assert s["ok"] and s["matched"] == 100


# ---- the reference mode ----


def test_reference_dir_is_the_makefiles():
    with open(os.path.join(REFBUILD, "Makefile")) as f:
        assert f"REF ?= {p_golden_ref.reference_dir()}\n" in f.read()


@pytest.mark.parametrize("argv", [[], ["--skip-tpu"], ["--skip-ref", "--skip-tpu"]])
def test_reference_mode_raises_and_names_the_missing_path(tmp_path, monkeypatch, argv):
    absent = str(tmp_path / "absent_reference")
    monkeypatch.setattr(p_golden_ref, "reference_dir", lambda: absent)
    with pytest.raises(FileNotFoundError, match=absent):
        p_golden_ref.main(argv + ["--out", str(tmp_path / "out")])
    with pytest.raises(FileNotFoundError, match=absent):
        p_golden_ref.build_ref()
    assert not (tmp_path / "out").exists()


# ---- the twins of tests/test_refbuild.py ----


@pytest.fixture(scope="module")
def shim_selftest_bin(tmp_path_factory):
    """The reference binary's RNG shim, built into a directory of this
    module's own (its ``make`` needs no reference sources)."""
    build = str(tmp_path_factory.mktemp("refbuild"))
    path = os.path.join(build, "shim_selftest")
    r = subprocess.run(["make", "-C", REFBUILD, f"BUILD={build}", path], capture_output=True)
    if r.returncode != 0 or not os.path.exists(path):
        pytest.skip("refbuild shims not buildable here")
    return path


def test_c_taus2_and_ziggurat_match_port_oracle(shim_selftest_bin):
    """The C shim behind the reference binary and the port's oracle draw
    the same zap-noise stream."""
    from boinc_app_eah_brp_tpu_torch.oracle.gslrng import Taus2, gaussian_ziggurat

    out = subprocess.run([shim_selftest_bin, "dump"], capture_output=True, text=True, check=True).stdout
    c_uints, c_gauss = [], []
    for line in out.splitlines():
        tag, val = line.split()
        (c_uints if tag == "u" else c_gauss).append(float(val))
    rng = Taus2(42)
    assert [int(u) for u in c_uints] == [rng.get() for _ in range(8)]
    rng = Taus2(42)
    np.testing.assert_array_equal(np.array(c_gauss), np.array([gaussian_ziggurat(rng, 0.5) for _ in range(8)]))


def _shipped():
    return os.path.isdir(os.path.join(p_golden_ref.reference_dir(), p_golden_ref.TESTWU))


def _port_on_shipped(tmp_path, bank, wu=None):
    inputs = p_golden_ref.reference_inputs()
    cand = str(tmp_path / "port.cand")
    cmd = _inputs.cli_cmd(wu or inputs["wu"], bank, cand, str(tmp_path / "port.cpt"), "-l", inputs["zap"],
                          "-W", "-P", "3.0", "-f", "400.0", "-A", "0.08", "-B", "1000", "--device", "cpu")
    r = subprocess.run(cmd, env=_inputs.child_env(), capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    return cand, p_golden_ref.padded_t_obs(inputs["wu"])


@pytest.mark.skipif(not _shipped(), reason="reference test WU unavailable")
def test_golden32_port_matches_reference_binary(tmp_path):
    cand, t_obs = _port_on_shipped(tmp_path, os.path.join(GOLDEN, "bank_golden.txt"))
    s = p_golden_ref.compare(os.path.join(GOLDEN, "ref_golden32.cand"), cand, t_obs)
    assert s["ok"] and s["matched"] >= 8, s


@pytest.mark.skipif(os.environ.get("ERP_GOLDEN_FULL") != "1",
                    reason="full 200-template golden diff is slow; set ERP_GOLDEN_FULL=1")
def test_golden200_port_matches_reference_binary(tmp_path):
    cand, t_obs = _port_on_shipped(tmp_path, os.path.join(GOLDEN, "bank200.txt"))
    s = p_golden_ref.compare(os.path.join(GOLDEN, "ref200.cand"), cand, t_obs)
    assert s["ok"] and s["matched"] >= 8, s


@pytest.mark.skipif(not _shipped(), reason="reference test WU unavailable")
def test_golden32_8bit_wu_port_matches_reference_binary(tmp_path):
    """The 8-bit (.binary) unpack path: the shipped workunit repacked as
    signed bytes carries the same sample values."""
    import gzip

    from boinc_app_eah_brp_tpu_torch.io.formats import DD_HEADER_DTYPE
    from boinc_app_eah_brp_tpu_torch.io.workunit import read_workunit

    wu_path = p_golden_ref.reference_inputs()["wu"]
    wu = read_workunit(wu_path)
    vals = np.round(wu.samples * float(wu.header["scale"])).astype(np.int8)
    wu8 = str(tmp_path / "wu8.binary")
    with gzip.open(wu_path, "rb") as f:
        header_bytes = f.read(DD_HEADER_DTYPE.itemsize)
    with gzip.open(wu8, "wb", compresslevel=1) as f:
        f.write(header_bytes)
        f.write(vals.tobytes())
    cand, t_obs = _port_on_shipped(tmp_path, os.path.join(GOLDEN, "bank_golden.txt"), wu=wu8)
    s = p_golden_ref.compare(os.path.join(GOLDEN, "ref_golden32.cand"), cand, t_obs)
    assert s["ok"], s
