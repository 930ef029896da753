"""Runs of each driver at a small size on the CPU, past the harness's
look for a card: sound runs come out correct; with the timed path broken
underneath (half of each batch left out, an answer altered where it is
produced) and with the bfloat16 control in the program's place they do
not.  A test marked ``cuda`` holds the control at the cells' own size on
a card."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from bmlib import harness, judge  # noqa: E402

harness.import_program()
import control  # noqa: E402

TINY = json.load(open(os.path.join(HERE, "tests", "tiny.json")))
SEED = 2**31 + 977


def _run(traffic: str, tmp_path, traced=False, seconds=1.0, seed=SEED, config=TINY):
    tr = harness.load_json(HERE, "traffic", f"{traffic}.json")
    cell = types.SimpleNamespace(config=config, traffic=tr, workload={"chips": 1})
    os.environ["TMPDIR"] = str(tmp_path)
    run = harness.Run(cell, seed, seconds, traced, "cpu")
    drv = harness.load_module("drivers", tr["driver"])
    try:
        st = drv.setup(run)
        drv.window(run, st)
        correct, checks = drv.check(run, st)
    finally:
        run.close()
    return run, correct, {n: v for n, v, _ in checks}


@pytest.mark.parametrize("traffic, metric", [("search", "templates_per_s"), ("served", "wu_per_hour"),
                                             ("cli", "cli_wu_per_hour")])
def test_a_sound_run_is_correct(traffic, metric, tmp_path):
    run, correct, numbers = _run(traffic, tmp_path)
    assert correct, numbers
    assert run.attempted >= 1 and run.failed == 0 and run.metrics[metric] > 0


def test_a_traced_run_reads_the_program_phases(tmp_path):
    run, correct, _ = _run("served", tmp_path, traced=True)
    assert correct
    assert run.obs["trace"].window_s > 0 and run.obs["workunits"] == run.attempted
    assert {"whitening", "oracle rescore"} <= set(run.obs["phases"])


def _half_batch(monkeypatch):
    """Every batch merges only its first half of templates."""
    from boinc_app_eah_brp_tpu_torch.models import search

    merge = search.BankStep.merge

    def half(self, sums, t_offset, n_total):
        keep = sums.shape[0] // 2
        return merge(self, sums[:max(1, keep)], t_offset, min(n_total, t_offset + max(1, keep)))

    monkeypatch.setattr(search.BankStep, "merge", half)


def _altered_sums(monkeypatch):
    """The fold's sums come out 0.1% high."""
    from boinc_app_eah_brp_tpu_torch.models import search

    merge = search.BankStep.merge
    monkeypatch.setattr(search.BankStep, "merge", lambda self, sums, a, b: merge(self, sums * 1.001, a, b))


def _altered_power(monkeypatch):
    """Each candidate line's power printed 0.1% high."""
    from boinc_app_eah_brp_tpu_torch.io import results

    line = results.format_candidate_line

    def high(cand, t_obs):
        c = cand.copy()
        c["power"] = c["power"] * 1.001
        return line(c, t_obs)

    monkeypatch.setattr(results, "format_candidate_line", high)


def _dropped_level(monkeypatch):
    """The toplist keeps no single-harmonic (level 0) candidate."""
    from boinc_app_eah_brp_tpu_torch.runtime import session

    build = session.update_toplist_from_maxima

    def drop(*args):
        out = build(*args)
        out[:100] = np.zeros(100, dtype=out.dtype)
        return out

    monkeypatch.setattr(session, "update_toplist_from_maxima", drop)


def _high_threshold(monkeypatch):
    """The static thresholds set for a false-alarm rate 1e4 times lower."""
    from boinc_app_eah_brp_tpu_torch.runtime import session

    base = session.base_thresholds
    monkeypatch.setattr(session, "base_thresholds", lambda fA, fft_size: base(fA * 1e-4, fft_size))


def _false_alarm_dof(monkeypatch):
    """The output stage's fA taken with n_harm degrees of freedom, not 2 n_harm."""
    from boinc_app_eah_brp_tpu_torch.oracle import toplist

    Q = toplist.chisq_Q
    monkeypatch.setattr(toplist, "chisq_Q", lambda x, nu: Q(x, max(2, nu // 2)))


@pytest.mark.parametrize("traffic, fault", [
    ("search", _half_batch), ("search", _altered_sums), ("served", _half_batch), ("served", _altered_power),
    ("served", _dropped_level), ("served", _high_threshold), ("served", _false_alarm_dof),
])
def test_a_broken_timed_path_is_not_correct(traffic, fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    _, correct, numbers = _run(traffic, tmp_path)
    assert not correct, numbers


def test_a_broken_command_line_is_not_correct(tmp_path, monkeypatch):
    """The command line's children load the fault from a sitecustomize on
    their path: each line's power is printed 0.1% high."""
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(
        "from boinc_app_eah_brp_tpu_torch.io import results\n"
        "_line = results.format_candidate_line\n"
        "def _high(cand, t_obs):\n"
        "    c = cand.copy(); c['power'] = c['power'] * 1.001\n"
        "    return _line(c, t_obs)\n"
        "results.format_candidate_line = _high\n"
    )
    monkeypatch.setenv("PYTHONPATH", f"{hook}{os.pathsep}{harness.ROOT}")
    _, correct, numbers = _run("cli", tmp_path)
    assert not correct, numbers


def test_a_child_that_loads_jax_gives_no_result(tmp_path, monkeypatch):
    """A command-line child that loads a module named ``jax`` (planted by
    a sitecustomize on its path) is a failed workunit, and the run prints
    no result."""
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text("import sys, types\nsys.modules['jax'] = types.ModuleType('jax')\n")
    monkeypatch.setenv("PYTHONPATH", f"{hook}{os.pathsep}{harness.ROOT}")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    tr = harness.load_json(HERE, "traffic", "cli.json")
    cell = types.SimpleNamespace(config=TINY, traffic=tr, workload={"chips": 1}, per_layer=[], end_to_end=[])
    run = harness.Run(cell, SEED, 1.0, False, "cpu")
    try:
        code = harness._run(run, cell, harness.load_module("drivers", "cli"), torch)
    finally:
        run.close()
    assert code != 0
    assert run.forbidden and set(run.forbidden) == {"jax"}
    assert run.attempted >= 1 and run.failed == run.attempted


def test_a_missing_candidate_file_is_not_correct(tmp_path):
    p = control.inputs.make_problem(TINY, 5)
    ref = control.reference.Reference(p.geom, "cpu")
    for text in ("% header only\n", "", "1.0 2.0 3.0\n%DONE%\n"):
        numbers = judge.judge_candidates(text, p, ref, 8)
        assert set(numbers.values()) == {float("inf")}
        ok, _ = judge.verdict(numbers, {"power_gap": 1, "top_gap": 1})
        assert not ok


@pytest.mark.parametrize("traffic", ["search", "served"])
def test_the_control_fails_the_limits(traffic):
    tr = harness.load_json(HERE, "traffic", f"{traffic}.json")
    numbers = control.control_numbers(TINY, tr, SEED, "cpu")
    ok, rows = judge.verdict(numbers, tr["limits"])
    assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["palfa6662.search", "palfa200.served"])
def test_the_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.Cell(harness.load_json(harness.ROOT, "BENCHMARK.json"), workload)
    for seed in (1, 2, 3):
        ok, rows = judge.verdict(control.control_numbers(cell.config, cell.traffic, seed, "cuda"), cell.traffic["limits"])
        assert not ok, rows


@pytest.mark.parametrize("pool", [1, 3])
def test_the_window_ends_at_the_last_completion(pool, tmp_path, monkeypatch):
    """The served window with a stand-in server: completions every 50 ms,
    two in flight, submits stop once the window's seconds have passed and
    the pool's pass is whole; the rate is the completions over the time to
    the last one."""
    served = harness.load_module("drivers", "served")
    tr = harness.load_json(HERE, "traffic", "served.json")
    run = harness.Run(types.SimpleNamespace(config=TINY, traffic=tr, workload={}), 1, 0.3, False, "cpu")

    class Server:
        def __init__(self):
            self.n = 0

        def submit(self, args, corr_id):
            return corr_id

        def result(self, ticket, timeout):
            import time

            time.sleep(0.05)
            open(os.path.join(run.dir, f"{ticket}.cand"), "w").close()
            return types.SimpleNamespace(ok=True, code=0, error=None)

        def close(self):
            pass

    monkeypatch.setattr(served, "_args", lambda run, paths, i, tag: None)
    st = dict(server=Server(), paths=[None] * pool, order=list(range(pool)), done=[])
    try:
        served.window(run, st)
    finally:
        run.close()
    times = [t for _, _, t in st["done"]]
    assert run.attempted == len(times) and times == sorted(times)
    assert len(times) % pool == 0
    assert [i for i, _, _ in st["done"]] == list(range(pool)) * (len(times) // pool)
    # submits after 0.3 s only finish the pass; the one in flight behind the
    # last submit completes after 0.3 s
    late = [t for t in times[:-2] if t >= 0.3]
    assert len(late) < pool and times[-1] >= 0.3
    assert run.metrics["wu_per_hour"] == pytest.approx(len(times) * 3600.0 / times[-1], rel=0.02)
    assert np.all(np.diff(times) > 0.04)
