"""The health cell's traffic (``traffic/search_health.json``, the cell
``palfa6662.search-health``) at a small size on the CPU: the search
cell's passes with the numerical health watchdog on, correct, with the
program's ``health.checks`` counter moving in the window; where the
watchdog checks nothing, the run fails."""

import json
import os
import sys
import types

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from bmlib import harness  # noqa: E402

harness.import_program()

from boinc_app_eah_brp_tpu_torch.runtime import health, metrics  # noqa: E402

TINY = json.load(open(os.path.join(HERE, "tests", "tiny.json")))
SEED = 2**31 + 4421


def _run(tmp_path, monkeypatch):
    tr = harness.load_json(HERE, "traffic", "search_health.json")
    cell = types.SimpleNamespace(config=TINY, traffic=tr, workload={"chips": 1})
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    # restored after the test, though the driver sets it
    monkeypatch.setenv("ERP_HEALTH_EVERY", "0")
    run = harness.Run(cell, SEED, 0.5, False, "cpu")
    drv = harness.load_module("drivers", tr["driver"])
    try:
        st = drv.setup(run)
        assert os.environ["ERP_HEALTH_EVERY"] == str(tr["health_every"])
        drv.window(run, st)
        checks = metrics.counter("health.checks").value
        correct, rows = drv.check(run, st)
    finally:
        run.close()
        metrics.finish(0)
    return run, correct, rows, checks


def test_the_health_cell_is_correct_and_checks_every_batch(tmp_path, monkeypatch):
    run, correct, rows, checks = _run(tmp_path, monkeypatch)
    assert correct, rows
    assert run.failed == 0 and run.attempted >= 1 and run.metrics["templates_per_s"] > 0
    # set-up's pass and every window pass: one check a batch
    batches = -(-TINY["templates"] // 16)
    assert checks >= (1 + run.attempted) * batches


def test_a_window_without_health_checks_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(health, "watchdog", lambda: None)
    run, correct, rows, checks = _run(tmp_path, monkeypatch)
    assert checks == 0 and run.failed >= 1 and not correct, rows


@pytest.mark.parametrize("cell", ["palfa6662.search-health"])
def test_the_cell_reports_the_search_metric(cell):
    c = harness.Cell(harness.load_json(harness.ROOT, "BENCHMARK.json"), cell)
    assert {m["name"] for m in c.end_to_end} == {"templates_per_s", "setup_s"}
    assert c.traffic["driver"] == "bank_passes_health" and c.per_layer
