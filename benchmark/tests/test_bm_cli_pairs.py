"""The multi-pass command-line traffic (``traffic/cli_pairs.json``, the
cell ``palfa6662p8.cli_pairs``) at a small size on the CPU: tasks of
three whole-bank pairs of the tiny configuration.  A sound run is
correct and a traced one reads every per-layer metric of the cell, with
no cold load in a warm pass; a task whose last pass leaves its file
unwritten, a task whose later passes write the first pass's toplist, and
a task that loads a module named ``jax`` are not correct or fail, a
program that keeps one pair a task gives no result, and set-up fills the
tasks' bytecode cache."""

import json
import os
import sys
import types

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from bmlib import harness  # noqa: E402

harness.import_program()

TINY = dict(json.load(open(os.path.join(HERE, "tests", "tiny.json"))), pairs_per_task=3)
SEED = 2**31 + 1213
CELL = "palfa6662p8.cli_pairs"
BATCH = 7


def _run(tmp_path, monkeypatch, traced=False, hook=None):
    """One run of the cell's traffic over the tiny configuration, its
    tasks' children loading ``hook`` as a sitecustomize when given;
    returns the run, whether it is correct, its compared numbers and the
    per-layer readings (traced runs only)."""
    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    real = harness.Cell(manifest, CELL)
    cell = types.SimpleNamespace(config=TINY, traffic=real.traffic, workload={"chips": 1}, per_layer=real.per_layer)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("ERP_BATCH", str(BATCH))
    if hook is not None:
        d = tmp_path / "hook"
        d.mkdir()
        (d / "sitecustomize.py").write_text(hook)
        monkeypatch.setenv("PYTHONPATH", f"{d}{os.pathsep}{harness.ROOT}")
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
def test_a_sound_multipass_run_is_correct(traced, tmp_path, monkeypatch):
    run, correct, numbers, readings = _run(tmp_path, monkeypatch, traced=traced)
    assert correct, numbers
    assert numbers["files_not_whole"] == 0
    n = TINY["pairs_per_task"]
    assert run.attempted >= n and run.attempted % n == 0 and run.failed == 0
    assert run.metrics["cli_wu_per_hour"] > 0
    if not traced:
        return
    names = {m["name"] for m in harness.Cell(harness.load_json(harness.ROOT, "BENCHMARK.json"), CELL).per_layer}
    assert len(names) == 4 and names <= set(readings), sorted(names - set(readings))
    assert readings["cold_loads_per_pass.cli_pairs"]["value"] == 0
    assert all(readings[m]["value"] > 0 for m in names - {"cold_loads_per_pass.cli_pairs"}), readings
    # the traced task ran each of its passes under a pass range
    passes = [a for name, a, _ in run.obs["trace"].annotations if name == "erp:pass"]
    assert len(passes) == n


def test_a_task_that_drops_its_last_file_is_not_correct(tmp_path, monkeypatch):
    hook = (
        "from boinc_app_eah_brp_tpu_torch.runtime import session\n"
        "_write = session.write_result_file\n"
        f"def _drop_last(path, result):\n"
        f"    if not path.endswith('p{TINY['pairs_per_task'] - 1}.cand'):\n"
        "        _write(path, result)\n"
        "session.write_result_file = _drop_last\n"
    )
    run, correct, numbers, _ = _run(tmp_path, monkeypatch, hook=hook)
    assert run.failed >= 1 and not correct, numbers


def test_later_passes_writing_the_first_passs_toplist_is_not_correct(tmp_path, monkeypatch):
    hook = (
        "from boinc_app_eah_brp_tpu_torch.runtime import session\n"
        "_write = session.write_result_file\n"
        "_first = []\n"
        "def _stale(path, result):\n"
        "    _first.append(result)\n"
        "    _write(path, _first[0])\n"
        "session.write_result_file = _stale\n"
    )
    run, correct, numbers, _ = _run(tmp_path, monkeypatch, hook=hook)
    assert run.failed == 0 and numbers["files_not_whole"] == 0
    assert not correct, numbers


def test_a_task_that_loads_jax_fails(tmp_path, monkeypatch):
    run, correct, _, _ = _run(tmp_path, monkeypatch, hook="import sys, types\nsys.modules['jax'] = types.ModuleType('jax')\n")
    assert run.forbidden and set(run.forbidden) == {"jax"}
    assert run.attempted >= 1 and run.failed == run.attempted and not correct
    cell = types.SimpleNamespace(config=TINY, traffic=harness.load_json(HERE, "traffic", "cli_pairs.json"),
                                 workload={"chips": 1}, per_layer=[], end_to_end=[])
    again = harness.Run(cell, SEED, 1.0, False, "cpu")
    try:
        code = harness._run(again, cell, harness.load_module("drivers", "cli_pairs"), torch)
    finally:
        again.close()
    assert code != 0


def test_a_program_that_keeps_one_pair_gives_no_result(tmp_path, monkeypatch):
    from boinc_app_eah_brp_tpu_torch.runtime import cli

    parse = cli.parse_args
    monkeypatch.setattr(cli, "parse_args", lambda argv: types.SimpleNamespace(**vars(parse(argv)) | {"pairs": ()}))
    drv = harness.load_module("drivers", "cli_pairs")
    assert not drv.keeps_every_pair()
    cell = types.SimpleNamespace(config=TINY, traffic=harness.load_json(HERE, "traffic", "cli_pairs.json"),
                                 workload={"chips": 1})
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    run = harness.Run(cell, SEED, 1.0, False, "cpu")
    try:
        with pytest.raises(SystemExit):
            drv.setup(run)
    finally:
        run.close()


def test_the_tasks_load_bytecode_compiled_before_the_window(tmp_path, monkeypatch):
    """Set-up lets the children write bytecode into a cache in the
    checkout and fills it, so that a task finds torch's modules and the
    program's compiled where the environment forbids writing them."""
    import importlib.util
    import subprocess

    drv = harness.load_module("drivers", "cli_pairs")
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1", PYTHONPATH=harness.ROOT)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    run = harness.Run(types.SimpleNamespace(config=TINY, traffic={}, workload={"chips": 1}), SEED, 1.0, False, "cpu")
    try:
        drv.warm_bytecode(run, env)
    finally:
        run.close()
    prefix = env["PYTHONPYCACHEPREFIX"]
    assert "PYTHONDONTWRITEBYTECODE" not in env and prefix.startswith(harness.ROOT)
    from boinc_app_eah_brp_tpu_torch.runtime import driver

    # compiled by the warm-up, before any task ran
    monkeypatch.setattr(sys, "pycache_prefix", prefix)
    for mod in (torch, driver):
        assert os.path.isfile(importlib.util.cache_from_source(mod.__file__)), mod.__name__
    probe = ("import sys, torch, boinc_app_eah_brp_tpu_torch.runtime.driver as d\n"
             "print(sys.flags.dont_write_bytecode, d.__cached__.startswith(sys.pycache_prefix))")
    out = subprocess.run([sys.executable, "-c", probe], env=env, capture_output=True, text=True, check=True).stdout
    assert out.split() == ["0", "True"]
