"""The whole-bank command-line traffic (``traffic/cli_whole.json``, the
cell ``palfa6662.cli``) at a small size on the CPU.  ``ERP_BATCH`` makes
the children search the bank in batches that leave a ragged last one, as
the production bank does at the program's batch (6,662 = 52 x 128 + 6):
a sound run is correct, and a traced one reads every per-layer metric of
the cell; a child that drops the sums of the last, partial batch is not
correct.  A test marked ``cuda`` holds the bfloat16 control at the cell's
own size on a card."""

import json
import os
import sys
import types

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from bmlib import harness, judge  # noqa: E402

harness.import_program()
import control  # noqa: E402

TINY = json.load(open(os.path.join(HERE, "tests", "tiny.json")))
SEED = 2**31 + 977
CELL = "palfa6662.cli"
# 24 templates at batch 7: batches at 0, 7, 14 and 21, the last 3 of 7 slots used
BATCH = 7


def _run(tmp_path, monkeypatch, traced=False):
    """One run of the cell's traffic over the tiny configuration; returns
    the run, whether it is correct, its compared numbers and the
    per-layer readings of the cell's metrics (traced runs only)."""
    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    real = harness.Cell(manifest, CELL)
    cell = types.SimpleNamespace(config=TINY, traffic=real.traffic, workload={"chips": 1}, per_layer=real.per_layer)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("ERP_BATCH", str(BATCH))
    run = harness.Run(cell, SEED, 1.0, traced, "cpu")
    drv = harness.load_module("drivers", real.traffic["driver"])
    try:
        st = drv.setup(run)
        drv.window(run, st)
        readings = harness.per_layer(run, cell) if traced else {}
        correct, checks = drv.check(run, st)
    finally:
        run.close()
    return run, correct, {n: v for n, v, _ in checks}, readings


@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_whole_bank_run_is_correct(traced, tmp_path, monkeypatch):
    run, correct, numbers, readings = _run(tmp_path, monkeypatch, traced=traced)
    assert correct, numbers
    assert run.attempted >= 1 and run.failed == 0 and run.metrics["cli_wu_per_hour"] > 0
    if not traced:
        return
    names = {m["name"] for m in harness.Cell(harness.load_json(harness.ROOT, "BENCHMARK.json"), CELL).per_layer}
    whole = {n for n in names if n.endswith(".cli_whole")}
    assert len(whole) == 6
    assert whole <= set(readings), sorted(whole - set(readings))
    assert all(readings[n]["value"] > 0 for n in whole), readings
    # the traced child searched the bank in at least three batches, the
    # last one ragged
    dispatches = [a for name, a, _ in run.obs["trace"].annotations if name == "erp:dispatch"]
    assert len(dispatches) == -(-TINY["templates"] // BATCH) >= 3 and TINY["templates"] % BATCH


def test_dropping_the_last_partial_batch_is_not_correct(tmp_path, monkeypatch):
    """The children load the fault from a sitecustomize on their path: a
    batch that runs past the bank's end merges nothing."""
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(
        "import torch\n"
        "from boinc_app_eah_brp_tpu_torch.models import search\n"
        "_merge = search.BankStep.merge\n"
        "def _drop_tail(self, sums, t_offset, n_total):\n"
        "    if t_offset + sums.shape[0] > n_total:\n"
        "        return torch.zeros(sums.shape[0], dtype=torch.bool, device=sums.device)\n"
        "    return _merge(self, sums, t_offset, n_total)\n"
        "search.BankStep.merge = _drop_tail\n"
    )
    monkeypatch.setenv("PYTHONPATH", f"{hook}{os.pathsep}{harness.ROOT}")
    run, correct, numbers, _ = _run(tmp_path, monkeypatch)
    assert run.attempted >= 1 and run.failed == 0
    assert not correct, numbers


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size():
    """The bfloat16 control over the whole bank fails the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.Cell(harness.load_json(harness.ROOT, "BENCHMARK.json"), CELL)
    ok, rows = judge.verdict(control.control_numbers(cell.config, cell.traffic, 1, "cuda"), cell.traffic["limits"])
    assert not ok, rows
