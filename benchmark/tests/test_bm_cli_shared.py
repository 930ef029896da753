"""The shared-card command-line driver (``drivers/cli_shared.py``) at a
small size on the CPU: a sound run is correct and counts its completed
children, each child ran in a slot of its own and read its share there,
the window ends at the last exit, and a broken child is not correct or
gives no result.  On a card (``cuda``), the cell's tasks at once write
the rows one task alone writes.  ``test_bm_manifest.py`` holds the new
configuration, traffic, cell and metrics to the manifest's shape."""

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

TINY = json.load(open(os.path.join(HERE, "tests", "tiny.json")))
SEED = 2**31 + 977
TRAFFIC = harness.load_json(HERE, "traffic", "cli_shared.json")


def _config(tasks: int) -> dict:
    return dict(TINY, tasks_per_card=tasks, gpu_usage=0.25)


def _run(tmp_path, tasks=2, seconds=1.0, traced=False):
    cell = types.SimpleNamespace(config=_config(tasks), traffic=TRAFFIC, workload={"chips": 1})
    os.environ["TMPDIR"] = str(tmp_path)
    run = harness.Run(cell, SEED, seconds, traced, "cpu")
    drv = harness.load_module("drivers", "cli_shared")
    try:
        st = drv.setup(run)
        drv.window(run, st)
        correct, checks = drv.check(run, st)
    finally:
        run.close()
    return run, st, correct, {n: v for n, v, _ in checks}


def _overlap(a, b) -> bool:
    return a[2] < b[3] and b[2] < a[3]


@pytest.mark.parametrize("tasks", [2, 4])
def test_a_sound_shared_run_is_correct(tasks, tmp_path):
    run, st, correct, numbers = _run(tmp_path, tasks=tasks)
    assert correct, numbers
    assert run.failed == 0 and run.attempted == len(st["done"]) == len(st["ran"]) >= tasks
    assert run.metrics["cli_wu_per_hour"] == pytest.approx(len(st["done"]) * 3600.0 / run.obs["loop_s"])
    # every child read the share from its slot's init_data.xml
    assert len(st["reports"]) == run.attempted
    assert all(r["metrics"]["gauges"]["card.gpu_usage"]["value"] == 0.25 for r in st["reports"])
    assert all(r["metrics"]["gauges"]["rescore.workers"]["value"] >= 1 for r in st["reports"])
    # children that ran at the same time ran in different slots
    ran = st["ran"]
    assert {slot for _, slot, _, _ in ran} == set(st["slots"]) and len(st["slots"]) == tasks
    assert all(a[1] != b[1] for a in ran for b in ran if a is not b and _overlap(a, b))
    # the readers of the cell's per-layer metrics
    read = lambda name, **kw: harness.load_module("readers", name).read(run.obs, **kw)  # noqa: E731
    assert 1.0 <= read("in_flight") <= tasks + 1e-9
    assert read("counter_per_wu", counter="resilience.batch_halved") == 0
    assert read("startup") > 0 and read("phase_per_wu", phase="oracle rescore") > 0
    assert read("peak_memory") is None  # no card, no device peak in the reports


def test_the_window_keeps_the_slots_full_and_ends_at_the_last_exit(tmp_path):
    """Stand-in children that sleep 0.3 s and write their candidate file:
    each exit refills its slot until the window's seconds have passed, no
    child starts after that, and the rate's clock stops at the last exit."""
    drv = harness.load_module("drivers", "cli_shared")
    cell = types.SimpleNamespace(config=_config(2), traffic=TRAFFIC, workload={"chips": 1})
    run = harness.Run(cell, 1, 0.5, False, "cpu")
    stub = "import sys, time; time.sleep(0.3); open(sys.argv[1], 'w').close()"
    drv.CLI._argv = lambda run, st, idx, tag, traced: [sys.executable, "-c", stub,
                                                        os.path.join(run.dir, f"{tag}.cand")]
    try:
        st = dict(order=[0, 1, 2, 3], env=dict(os.environ), done=[], reports=[], ran=[],
                  slots=[os.path.join(run.dir, f"slot{k}") for k in range(2)])
        for s in st["slots"]:
            os.makedirs(s)
        drv.window(run, st)
    finally:
        run.close()
    ran = sorted(st["ran"], key=lambda r: r[2])
    t0, last = ran[0][2], max(r[3] for r in ran)
    assert all(r[2] - t0 < 0.5 for r in ran)
    assert any(r[3] - t0 >= 0.5 for r in ran)
    assert len(ran) == run.attempted == len(st["done"]) and len(ran) % 2 == 0 and len(ran) >= 4
    assert [r[0] for r in sorted(st["ran"], key=lambda r: r[0])] == list(range(len(ran)))
    assert run.obs["loop_s"] == pytest.approx(last - t0, abs=0.05)
    assert run.metrics["cli_wu_per_hour"] == pytest.approx(len(ran) * 3600.0 / run.obs["loop_s"])
    assert run.obs["children_s"] / run.obs["loop_s"] > 1.5


def _hook(tmp_path, monkeypatch, body: str) -> None:
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(body)
    monkeypatch.setenv("PYTHONPATH", f"{hook}{os.pathsep}{harness.ROOT}")


def test_printed_powers_planted_high_are_not_correct(tmp_path, monkeypatch):
    """Each child prints every line's power 0.1% high."""
    _hook(tmp_path, monkeypatch,
          "from boinc_app_eah_brp_tpu_torch.io import results\n"
          "_line = results.format_candidate_line\n"
          "def _high(cand, t_obs):\n"
          "    c = cand.copy(); c['power'] = c['power'] * 1.001\n"
          "    return _line(c, t_obs)\n"
          "results.format_candidate_line = _high\n")
    run, _, correct, numbers = _run(tmp_path)
    assert run.failed == 0 and not correct, numbers


def test_a_shared_child_that_loads_jax_gives_no_result(tmp_path, monkeypatch):
    _hook(tmp_path, monkeypatch, "import sys, types\nsys.modules['jax'] = types.ModuleType('jax')\n")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell = types.SimpleNamespace(config=_config(2), traffic=TRAFFIC, workload={"chips": 1},
                                 per_layer=[], end_to_end=[])
    run = harness.Run(cell, SEED, 1.0, False, "cpu")
    try:
        code = harness._run(run, cell, harness.load_module("drivers", "cli_shared"), torch)
    finally:
        run.close()
    assert code != 0
    assert run.forbidden and set(run.forbidden) == {"jax"}
    assert run.attempted >= 2 and run.failed == run.attempted


def test_the_cell_reads_its_configuration_and_traffic():
    manifest = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell = harness.Cell(manifest, "palfa200x4.cli_shared")
    assert cell.traffic["driver"] == "cli_shared" and cell.workload["chips"] == 1
    assert cell.config["tasks_per_card"] == 4 and cell.config["gpu_usage"] == 0.25
    assert {m["name"] for m in cell.end_to_end} == {"cli_wu_per_hour", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "tasks_in_flight.cli_shared", "task_peak_gb.cli_shared", "batch_halved_per_wu.cli_shared",
        "startup_s_per_wu.cli_shared", "rescore_s_per_wu.cli_shared"}
    # the workunit cells' limits, and their pool
    cli = harness.load_json(HERE, "traffic", "cli.json")
    assert cell.traffic["limits"] == cli["limits"]
    assert (cell.traffic["pool_seed"], cell.traffic["pool"]) == (cli["pool_seed"], cli["pool"])


@pytest.mark.cuda
def test_four_at_once_rows_equal_alone(tmp_path, monkeypatch):
    """On a card, at the cell's size: the pool's workunits as the cell's
    tasks at once, each told its share (batch 64, ``card-share``), then
    each alone without ``init_data.xml`` (the ``palfa200.cli`` path,
    batch 128): the candidate rows are equal byte for byte, and no task
    halved its batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell = harness.Cell(harness.load_json(harness.ROOT, "BENCHMARK.json"), "palfa200x4.cli_shared")
    run = harness.Run(cell, SEED, 0.0, False, "cuda")
    drv = harness.load_module("drivers", "cli_shared")
    rows = lambda path: [ln for ln in open(path).read().splitlines() if not ln.startswith("%")]  # noqa: E731
    try:
        st = drv.setup(run)
        n, order = len(st["slots"]), st["order"]
        running = [drv._start(run, st, k, slot, traced=False) for k, slot in enumerate(st["slots"])]
        shared_reports = {}
        while running:
            shared_reports.update({ch["idx"]: rep for ch, _, rep in drv._reap(run, st, running)})
        shared = {idx: rows(out) for idx, out, _ in st["done"]}
        st["done"] = []
        alone_reports = {order[i % len(order)]: drv.CLI._child(run, st, i, traced=False)[1] for i in range(n, 2 * n)}
        alone = {idx: rows(out) for idx, out, _ in st["done"]}
    finally:
        run.close()
    assert run.failed == 0 and set(shared) == set(alone) == set(range(cell.traffic["pool"]))
    for idx in shared:
        assert len(shared[idx]) > 10 and shared[idx] == alone[idx], idx
        for reports, batch, decision in ((shared_reports, 64, "card-share"), (alone_reports, 128, "memory-model")):
            m = reports[idx]["metrics"]
            assert (m["gauges"]["autobatch.batch_size"]["value"], m["gauges"]["autobatch.decision"]["value"]) == (
                batch, decision)
            assert "resilience.batch_halved" not in m["counters"]
