"""The program-span readers of the command-line cell (``span_s``,
``unspanned``) on a hand-built Chrome trace: the union of the named
ranges (nested and overlapping ones count once), ranges cut by the
window, and nothing read where a name is absent."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from bmlib import harness, spans, trace  # noqa: E402

span_s = harness.load_module("readers", "span_s")
unspanned = harness.load_module("readers", "unspanned")


def _ev(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": {}}


def _obs(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [_ev(trace.WINDOW, 1000, 10000)] + events}))
    return {"trace": trace.load(str(path))}


# window 1000-11000 us
EVENTS = [
    _ev("erp:startup", 1000, 3000),
    _ev("erp:import", 1100, 800),  # nested in startup
    _ev("erp:import", 1500, 1000),  # overlaps the first import: 1100-2500 once
    _ev("erp:cuda-init", 500, 1000),  # starts before the window: 1000-1500
    _ev("erp:input-read", 5000, 200),
    _ev("erp:result-write", 10900, 500),  # ends after the window: 10900-11000
    _ev("erp:input-read", 12000, 100),  # after the window
    _ev("erp:rescore.fft", 6000, 1000, tid=2),  # another thread
    _ev("erp.merge", 7500, 1000),  # a device scope, not a program span
    _ev("aten::copy_", 8000, 500, cat="cpu_op"),
]


@pytest.mark.parametrize("names, want_us", [
    (["erp:import"], 1400),
    (["erp:startup", "erp:import"], 3000),
    (["erp:cuda-init"], 500),
    (["erp:input-read", "erp:ckpt-write", "erp:result-write"], 300),
    (["erp:rescore.fft"], 1000),
])
def test_span_s_is_the_union_of_the_named_ranges_in_the_window(tmp_path, names, want_us):
    assert span_s.read(_obs(tmp_path, EVENTS), names=names) == pytest.approx(want_us * 1e-6)


def test_span_s_reads_nothing_where_the_name_is_absent(tmp_path):
    obs = _obs(tmp_path, EVENTS)
    assert span_s.read(obs, names=["erp:kernel-load"]) is None
    assert span_s.read(obs, names=["erp:rescore-finalize"]) is None
    assert span_s.read({}, names=["erp:import"]) is None
    # a range wholly outside the window is no reading either
    assert span_s.read(_obs(tmp_path, [_ev("erp:cufft-plan", 12000, 50)]), names=["erp:cufft-plan"]) is None


def test_unspanned_is_the_window_less_every_program_span(tmp_path):
    # erp: ranges cover 1000-4000, 5000-5200, 6000-7000, 10900-11000
    got = unspanned.read(_obs(tmp_path, EVENTS))
    assert got == pytest.approx((10000 - 3000 - 200 - 1000 - 100) * 1e-6)
    assert unspanned.read(_obs(tmp_path, [_ev("erp.merge", 2000, 100)])) is None
    assert unspanned.read({}) is None
    whole = unspanned.read(_obs(tmp_path, [_ev("erp:startup", 0, 20000)]))
    assert whole == pytest.approx(0.0, abs=1e-12)


def test_union_counts_each_stretch_once():
    assert spans.union_s([]) == 0.0
    assert spans.union_s([(0, 10), (5, 15), (2, 3), (20, 30)]) == pytest.approx(25e-6)
