"""The port's fleet timeline (``boinc_app_eah_brp_tpu_torch/tools/
fleet_timeline.py``) against the JAX package's tool on the same run
directory: the synthetic two-host host-loss run of
``tests/test_fleet_timeline.py::make_fleet_run``, with and without its
adoption and its shard board, and with a flight-recorder dump of the
killed host.

Tolerance: the merged Chrome traces equal; the sidecars equal apart from
their generation time ``t``; the gates, ``--check`` and ``--diff`` give
the same lists, exit codes and text.
"""

import json
import os
import shutil
import sys

import pytest

from boinc_app_eah_brp_tpu_torch.runtime import flightrec as pfr
from boinc_app_eah_brp_tpu_torch.runtime import tracing as ptracing
from boinc_app_eah_brp_tpu_torch.tools import fleet_timeline as pft
from boinc_app_eah_brp_tpu_torch.tools import report_check

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import fleet_timeline as jft  # noqa: E402
from test_fleet_timeline import BASE, make_fleet_run  # noqa: E402


def _plant_dump(run, monkeypatch):
    """A dump of the killed host written by the port's flight recorder,
    its events moved to the run's clock (host1's last second)."""
    monkeypatch.delenv(pfr.BLACKBOX_ENV, raising=False)
    monkeypatch.setenv(pfr.BLACKBOX_DIR_ENV, str(run))
    assert pfr.arm(context={"suite": "fleet"})
    pfr.record("dispatch", start=4, stop=6)
    pfr.record("health-violation", where="batch", what="nonfinite-spectrum")
    path = pfr.dump("watchdog:dispatch")
    pfr.disarm()
    with open(path) as f:
        doc = json.load(f)
    for i, ev in enumerate(doc["events"]):
        ev["t"] = BASE + 1.5 + 0.1 * i
    target = os.path.join(run, "erp-blackbox-host1.json")
    with open(target, "w") as f:
        json.dump(doc, f)
    os.remove(path)


VARIANTS = ("adoption", "no-adoption", "no-board", "dump")


def _run(tmp_path, variant, monkeypatch):
    run = make_fleet_run(tmp_path / variant, adoption=variant not in ("no-adoption", "no-board"))
    if variant == "no-board":
        shutil.rmtree(os.path.join(run, "shards"))
    if variant == "dump":
        _plant_dump(run, monkeypatch)
    return run


def _without_t(sidecar):
    return {k: v for k, v in sidecar.items() if k != "t"}


@pytest.mark.parametrize("variant", VARIANTS)
def test_assemble_matches_jax(tmp_path, variant, monkeypatch):
    run = _run(tmp_path, variant, monkeypatch)
    p_chrome, p_side = pft.assemble(run)
    j_chrome, j_side = jft.assemble(run)
    assert p_chrome == j_chrome
    assert _without_t(p_side) == _without_t(j_side)
    assert ptracing.validate_chrome(p_chrome) == []
    assert pft.validate_fleet_timeline(p_side) == jft.validate_fleet_timeline(j_side) == []
    assert (len(p_side["adoptions"]) == 1) == (variant in ("adoption", "dump"))
    if variant == "dump":
        assert p_side["summary"]["blackbox_dumps"] == 1
        assert any(ev.get("name") == "fr:health-violation" for ev in p_chrome["traceEvents"])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("floor,adopt", [(0.0, False), (0.95, True), (0.99, True), (0.95, False)])
def test_gates_match_jax(tmp_path, variant, floor, adopt, monkeypatch):
    _, side = pft.assemble(_run(tmp_path, variant, monkeypatch))
    assert pft.check_gates(side, floor, adopt) == jft.check_gates(side, floor, adopt)
    expect_pass = floor <= 0.95 and (not adopt or variant in ("adoption", "dump"))
    assert (pft.check_gates(side, floor, adopt) == []) == expect_pass


def _damaged(side, case):
    bad = json.loads(json.dumps(side))
    if case == "hosts":
        bad["hosts"] = {}
    elif case == "coverage":
        bad["hosts"]["host0"]["coverage"] = 1.7
    elif case == "offset":
        bad["hosts"]["host0"]["offset_source"] = "guessed"
    elif case == "latency":
        bad["adoptions"][0]["latency_s"] = -0.2
    elif case == "flows":
        bad["flows"]["adoption"] = 5
    elif case == "summary":
        bad["summary"]["hosts"] = 9
    elif case == "not-an-object":
        bad = [bad]
    return bad


@pytest.mark.parametrize("case", ["hosts", "coverage", "offset", "latency", "flows", "summary", "not-an-object"])
def test_validator_matches_jax_on_damage(tmp_path, case, monkeypatch):
    _, side = pft.assemble(_run(tmp_path, "adoption", monkeypatch))
    bad = _damaged(side, case)
    errs = pft.validate_fleet_timeline(bad)
    assert errs and errs == jft.validate_fleet_timeline(bad)
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(bad))
    if isinstance(bad, dict):
        assert report_check.check_path(str(path)) == (pft.TIMELINE_SCHEMA, errs)


@pytest.mark.parametrize("variant", VARIANTS)
def test_cli_check_matches_jax(tmp_path, variant, monkeypatch, capsys):
    run = _run(tmp_path, variant, monkeypatch)
    argv = [run, "--check", "--min-coverage", "0.95", "--require-adoption"]
    rc = pft.main(argv)
    port_out = capsys.readouterr().out
    port_side = json.load(open(os.path.join(run, pft.SIDECAR_NAME)))
    assert rc == jft.main(argv) == (0 if variant in ("adoption", "dump") else 1)
    assert port_out == capsys.readouterr().out
    assert _without_t(port_side) == _without_t(json.load(open(os.path.join(run, jft.SIDECAR_NAME))))
    # the written sidecar re-validates alone, and the router knows it
    sidecar = os.path.join(run, pft.SIDECAR_NAME)
    argv = [sidecar, "--check", "--require-adoption"]
    assert pft.main(argv) == jft.main(argv)
    capsys.readouterr()
    assert report_check.check_path(sidecar) == (pft.TIMELINE_SCHEMA, [])
    assert pft.main([sidecar]) == 0
    port_out = capsys.readouterr().out
    assert jft.main([sidecar]) == 0
    assert port_out == capsys.readouterr().out


def test_cli_diff_matches_jax(tmp_path, monkeypatch, capsys):
    a = _run(tmp_path, "adoption", monkeypatch)
    b = _run(tmp_path, "no-board", monkeypatch)
    for run in (a, b):
        assert pft.main([run]) == 0
    capsys.readouterr()
    argv = [os.path.join(a, pft.SIDECAR_NAME), os.path.join(b, pft.SIDECAR_NAME), "--diff"]
    assert pft.main(argv) == 0
    port_out = capsys.readouterr().out
    assert jft.main(argv) == 0
    assert port_out == capsys.readouterr().out
    assert "coverage:host0" in port_out and "mean_adoption_latency_s" in port_out
    # not a sidecar: both refuse
    argv = [os.path.join(a, pft.CHROME_NAME), os.path.join(b, pft.SIDECAR_NAME), "--diff"]
    assert pft.main(argv) == jft.main(argv) == 1
