"""PyTorch port: a task of several (input, output) pairs searched in order
in one process (``runtime/driver.py``), as the reference's wrapper runs N
``-i``/``-o`` pairs (``erp_boinc_wrapper.cpp:430-474``).  The command
line's pairs; each pass's file against a run of its pair alone (byte for
byte, save the ``% Date:`` line) and against the benchmark's plain
reference (``benchmark/bmlib/reference.py``); isolation between passes;
pass-level resume after a quit; progress scaled across passes; what a
later pass finds warm; the failing pass's code."""

import copy
import json
import os
import sys
from types import SimpleNamespace

import pytest

from boinc_app_eah_brp_tpu_torch.io.checkpoint import read_checkpoint
from boinc_app_eah_brp_tpu_torch.runtime import autobatch
from boinc_app_eah_brp_tpu_torch.runtime.boinc import BoincAdapter
from boinc_app_eah_brp_tpu_torch.runtime.cli import parse_args
from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs, run_search
from boinc_app_eah_brp_tpu_torch.runtime.errors import RADPUL_EFILE, RADPUL_EIO, RADPUL_EVAL
from boinc_app_eah_brp_tpu_torch.runtime.metrics import validate_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmark"))

from bmlib import inputs, judge, reference  # noqa: E402

TINY = json.load(open(os.path.join(REPO, "benchmark", "tests", "tiny.json")))
LIMITS = json.load(open(os.path.join(REPO, "benchmark", "traffic", "cli_whole.json")))["limits"]
SEED = 2**31 + 4099
N_PASSES = 3
# 24 templates at batch 7: four batches a pass, the last one ragged
BATCH = 7


@pytest.mark.parametrize(
    "argv, pairs",
    [
        ("-i a.bin4 -o a.cand -t t", [("a.bin4", "a.cand")]),
        ("-i a.bin4 -o a.cand -i b.bin4 -o b.cand -t t", [("a.bin4", "a.cand"), ("b.bin4", "b.cand")]),
        ("-i a.bin4 -i b.bin4 -t t -o x -o y", [("a.bin4", "x"), ("b.bin4", "y")]),
        ("--input_file a.bin4 -o x -i b.binary --output_file y -i c.bin4 -o z -t t",
         [("a.bin4", "x"), ("b.binary", "y"), ("c.bin4", "z")]),
    ],
)
def test_pairs_are_kept_in_order(argv, pairs):
    got = parse_args(argv.split())
    assert isinstance(got, DriverArgs)
    assert got.task() == pairs
    assert (got.inputfile, got.outputfile) == pairs[0]


@pytest.mark.parametrize(
    "argv, want",
    [
        ("-i a.bin4 -i b.bin4 -o x -t t", RADPUL_EVAL),
        ("-i a.bin4 -o x -o y -t t", RADPUL_EVAL),
        ("-i a.bin4 -o x -i b.weird -o y -t t", RADPUL_EFILE),
        ("-o x -t t", RADPUL_EVAL),
    ],
)
def test_unequal_pairs_and_a_bad_input_are_refused(argv, want):
    assert parse_args(argv.split()) == want


def test_one_pair_is_a_task_of_one_pass():
    """A hand-made DriverArgs (no ``pairs``) and the command line's one
    pair are the same task."""
    parsed = parse_args("-i a.bin4 -o o.cand -t t".split())
    assert parsed.task() == DriverArgs(inputfile="a.bin4", outputfile="o.cand", templatebank="t").task()
    assert parsed.task() == [("a.bin4", "o.cand")]


@pytest.fixture(scope="module")
def wus(tmp_path_factory):
    """Three seeded workunits of the benchmark's tiny configuration, one
    bank and one zaplist, written once for the module."""
    d = tmp_path_factory.mktemp("wus")
    problems = [inputs.make_problem(TINY, SEED, i) for i in range(N_PASSES)]
    paths = [inputs.write_inputs(p, str(d), f"wu{i}") for i, p in enumerate(problems)]
    return SimpleNamespace(problems=problems, paths=paths, bank=paths[0]["bank"], zap=paths[0]["zap"])


def _args(wus, d, tag, wu_paths=None, batch=BATCH, **kw):
    """The task's parsed command line: one pair a workunit, outputs
    ``<tag><i>.cand`` in ``d``, one checkpoint ``<tag>.cpt``."""
    argv = []
    for i, p in enumerate(wu_paths or [p["wu"] for p in wus.paths]):
        argv += ["-i", p, "-o", str(d / f"{tag}{i}.cand")]
    argv += ["-t", wus.bank, "-l", wus.zap, "-c", str(d / f"{tag}.cpt"), *TINY["argv"], "--device", "cpu"]
    if batch is not None:
        argv += ["--batch", str(batch)]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    parsed = parse_args(argv)
    assert isinstance(parsed, DriverArgs)
    return parsed


def _body(path) -> str:
    """A candidate file without its ``% Date:`` provenance line."""
    with open(path) as f:
        return "".join(ln for ln in f if not ln.startswith("% Date:"))


def _report(args) -> dict:
    with open(args.metrics_file + ".report.json") as f:
        report = json.load(f)
    assert validate_report(report) == []
    return report


@pytest.fixture(scope="module")
def whole(wus, tmp_path_factory):
    """The three-pass task run once, uninterrupted, with its run report,
    and each pair run alone."""
    d = tmp_path_factory.mktemp("whole")
    args = _args(wus, d, "task", metrics_file=str(d / "m.jsonl"))
    assert run_search(args) == 0
    alone = []
    for i, p in enumerate(wus.paths):
        one = _args(wus, d, f"alone{i}-", wu_paths=[p["wu"]])
        assert run_search(one) == 0
        alone.append(one.outputfile)
    return SimpleNamespace(args=args, files=[o for _, o in args.task()], alone=alone, report=_report(args), dir=d)


@pytest.mark.parametrize("k", range(N_PASSES))
def test_each_pass_writes_what_its_pair_alone_writes(whole, k):
    assert _body(whole.files[k]) == _body(whole.alone[k])


@pytest.mark.parametrize("k", range(N_PASSES))
def test_each_pass_is_within_the_cells_limits_of_the_reference(whole, wus, k):
    p = wus.problems[k]
    with open(whole.files[k]) as f:
        numbers = judge.judge_candidates(f.read(), p, reference.Reference(p.geom, "cpu"), 16)
    ok, rows = judge.verdict(numbers, LIMITS)
    assert ok, rows


def test_the_run_report_lists_each_pass_and_totals_them(whole):
    report = whole.report
    counters = {k: v["value"] for k, v in report["metrics"]["counters"].items()}
    assert counters["task.passes"] == N_PASSES
    assert counters.get("task.passes_skipped", 0) == 0 and counters.get("task.passes_resumed", 0) == 0
    passes = report["passes"]
    assert [p["index"] for p in passes] == list(range(N_PASSES))
    assert [(p["inputfile"], p["outputfile"]) for p in passes] == whole.args.task()
    assert all(p["exit"] == 0 and p["finished"] and not p["resumed"] for p in passes)
    # the report's phases are the passes' summed
    for name, total in report["metrics"]["phases"].items():
        assert total["wall_s"] == pytest.approx(sum(p["phases"].get(name, 0.0) for p in passes), abs=1e-6)
    assert {"template loop", "oracle rescore"} <= set(passes[1]["phases"])


def test_a_finished_task_leaves_only_the_last_passs_checkpoint(whole, wus):
    """A finished pass's checkpoint goes before the next pass; the last
    pass's final checkpoint stays, as a one-pair run leaves it."""
    cp = read_checkpoint(whole.args.checkpointfile)
    assert cp.originalfile == wus.paths[-1]["wu"] and cp.n_template == TINY["templates"]


def test_a_noise_pass_after_a_pulse_pass_writes_none_of_its_rows(wus, tmp_path):
    loud = copy.deepcopy(TINY)
    loud["data"]["pulse_amp"] = 4.0
    quiet = copy.deepcopy(TINY)
    quiet["data"]["pulse_amp"] = 0.0
    paths = [inputs.write_inputs(inputs.make_problem(c, SEED, 7), str(tmp_path), name)["wu"]
             for c, name in ((loud, "loud"), (quiet, "quiet"))]
    task = _args(wus, tmp_path, "pair", wu_paths=paths)
    assert run_search(task) == 0
    alone = _args(wus, tmp_path, "alone", wu_paths=paths[1:])
    assert run_search(alone) == 0
    loud_file, quiet_file = (o for _, o in task.task())
    assert _body(quiet_file) == _body(alone.outputfile)
    rows = lambda path: {ln for ln in open(path) if ln.strip() and not ln.startswith("%")}  # noqa: E731
    assert rows(loud_file) and not rows(loud_file) & rows(quiet_file)


class _QuitInPass(BoincAdapter):
    """Checkpoints every batch; writes ``quit`` into the control file at
    pass ``k``'s first progress report."""

    def __init__(self, control: str, k: int):
        super().__init__(control_path=control, checkpoint_period_s=0.0)
        self.k = k

    def fraction_done(self, fraction):
        if self.pass_index == self.k:
            with open(self.control_path, "w") as f:
                f.write("quit\n")
        super().fraction_done(fraction)


def test_a_task_quit_in_pass_two_resumes_where_it_stopped(whole, wus, tmp_path):
    control = str(tmp_path / "control.txt")
    first = _args(wus, tmp_path, "split")
    assert run_search(first, _QuitInPass(control, 1)) == 0
    outs = [o for _, o in first.task()]
    assert os.path.exists(outs[0]) and not os.path.exists(outs[1]) and not os.path.exists(outs[2])
    cp = read_checkpoint(first.checkpointfile)
    assert cp.originalfile == wus.paths[1]["wu"] and cp.n_template == BATCH
    kept = (open(outs[0]).read(), os.stat(outs[0]).st_mtime_ns)

    os.remove(control)
    again = _args(wus, tmp_path, "split", metrics_file=str(tmp_path / "m.jsonl"))
    assert run_search(again) == 0
    assert (open(outs[0]).read(), os.stat(outs[0]).st_mtime_ns) == kept
    assert [_body(o) for o in outs] == [_body(f) for f in whole.files]
    report = _report(again)
    counters = {k: v["value"] for k, v in report["metrics"]["counters"].items()}
    assert (counters["task.passes_skipped"], counters["task.passes_resumed"], counters["task.passes"]) == (1, 1, 2)
    assert [(p["index"], p.get("skipped", False), p.get("resumed", False)) for p in report["passes"]] == [
        (0, True, False), (1, False, True), (2, False, False)]
    # no checkpoint of passes 1 and 2 is left; the last pass's final one is
    cp = read_checkpoint(again.checkpointfile)
    assert cp.originalfile == wus.paths[2]["wu"] and cp.n_template == TINY["templates"]
    assert not os.path.exists(again.checkpointfile + ".1") or (
        read_checkpoint(again.checkpointfile + ".1").originalfile == wus.paths[2]["wu"])


class _Recording(BoincAdapter):
    """Every progress report, as the pass saw it and as the task reports
    it, and every screensaver update's fraction."""

    def __init__(self, status_path):
        super().__init__(status_path=status_path, progress_min_delta=0.0)
        self.seen, self.shown = [], []

    def fraction_done(self, fraction):
        self.seen.append((self.pass_index, fraction, self.task_fraction(fraction)))
        super().fraction_done(fraction)

    def search_info_due(self):
        return True

    def update_shmem(self, search_info):
        self.shown.append(search_info["fraction_done"])
        super().update_shmem(search_info)


def test_progress_is_scaled_across_the_passes_and_monotone(wus, tmp_path):
    args = _args(wus, tmp_path, "prog")
    adapter = _Recording(str(tmp_path / "status.txt"))
    assert run_search(args, adapter) == 0
    assert {k for k, _, _ in adapter.seen} == set(range(N_PASSES))
    for k, f, v in adapter.seen:
        assert 0.0 < f <= 1.0 and v == pytest.approx((k + f) / N_PASSES, abs=0)
    told = [v for _, _, v in adapter.seen]
    assert told == sorted(told) and told[-1] == 1.0
    assert adapter.shown == sorted(adapter.shown) and set(adapter.shown) <= set(told)
    status = [float(ln.split()[1]) for ln in open(adapter.status_path) if ln.startswith("fraction_done")]
    assert status == sorted(status) and status[-1] == 1.0 and len(status) >= 4 * N_PASSES


def test_later_passes_load_nothing_cold_and_choose_the_batch_once(wus, tmp_path, monkeypatch):
    chosen = []

    def choose(nsamples, log=None, device=None, share=None):
        chosen.append(nsamples)
        return BATCH

    monkeypatch.delenv("ERP_BATCH", raising=False)
    monkeypatch.setattr(autobatch, "choose_batch", choose)
    trace = tmp_path / "trace.jsonl"
    monkeypatch.setenv("ERP_TRACE_FILE", str(trace))
    args = _args(wus, tmp_path, "warm", batch=None)
    assert run_search(args) == 0
    assert len(chosen) == 1
    spans = [r for r in map(json.loads, open(trace)) if r.get("kind") == "span"]
    passes = sorted((r for r in spans if r["name"] == "pass"), key=lambda r: r["ts_us"])
    assert [r["args"]["index"] for r in passes] == list(range(N_PASSES))
    assert [r["wu"] for r in passes] == [os.path.basename(p["wu"]) for p in wus.paths]
    later = [(r["ts_us"], r["end_us"]) for r in passes[1:]]
    cold = [r for r in spans if r["name"] in ("cuda-init", "kernel-load", "cufft-plan")
            and any(a <= r["ts_us"] <= b for a, b in later)]
    assert cold == []
    # each pass searched the whole bank in its own template loop
    loops = [r for r in spans if r["name"] == "dispatch"]
    assert len(loops) == N_PASSES * -(-TINY["templates"] // BATCH)


def test_a_failing_pass_ends_the_task_with_its_code(wus, tmp_path):
    paths = [p["wu"] for p in wus.paths]
    paths[1] = str(tmp_path / "missing.bin4")
    args = _args(wus, tmp_path, "fail", wu_paths=paths, metrics_file=str(tmp_path / "m.jsonl"))
    assert run_search(args) == RADPUL_EIO
    outs = [o for _, o in args.task()]
    assert os.path.exists(outs[0]) and not os.path.exists(outs[1]) and not os.path.exists(outs[2])
    report = _report(args)
    assert [(p["index"], p["exit"]) for p in report["passes"]] == [(0, 0), (1, RADPUL_EIO)]
