"""The judge's own toplist and output stage (``bmlib/cands.py``): the
false-alarm figure against the upstream C's printed lines, the
thresholds against their defining tail, and the toplist's and the output
stage's rules on small hand-made cases."""

import math
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bmlib import cands  # noqa: E402

# (power in sigma, fA, n_harm) of the upstream C's candidate file for the
# 200-template test bank (its first lines, printed with %g)
C_LINES = [
    (12.7112, 8.45725, 16), (12.7969, 8.42117, 8), (12.6318, 8.35906, 16), (12.5762, 8.29047, 16),
    (12.5751, 8.28909, 16),
]


@pytest.mark.parametrize("power, fa, n", C_LINES)
def test_the_false_alarm_figure_matches_the_c(power, fa, n):
    # the printed power and fA carry six digits
    assert cands.false_alarm(power * math.sqrt(n), n) == pytest.approx(fa, rel=2e-5)


def test_the_tail_underflows_with_its_exponential():
    assert cands.false_alarm(745.0, 1) > 320.0
    assert cands.false_alarm(746.0, 1) == cands.FA_UNDERFLOW
    assert cands.false_alarm(746.0, 16) == cands.FA_UNDERFLOW
    assert cands.tail(0.0, 4) == 1.0


@pytest.mark.parametrize("k", range(5))
def test_a_threshold_is_where_the_tail_is_the_bin_probability(k):
    fft_size = 6_291_457
    prob = float(np.float32(1.0 - math.pow(1.0 - 0.08, 1.0 / fft_size)))
    thr = float(cands.thresholds(0.08, fft_size)[k])
    n = 1 << k
    assert cands.tail(thr * (1 - 1e-6), n) > prob > cands.tail(thr * (1 + 1e-6), n)


def _hits(**levels):
    out = [(np.zeros(0, np.int64), np.zeros(0, np.float32)) for _ in range(5)]
    for k, pairs in levels.items():
        bins, powers = zip(*pairs)
        out[int(k[1:])] = (np.array(bins), np.array(powers, np.float32))
    return out


def test_the_toplist_keeps_the_strongest_of_a_bin_and_drops_the_weakest():
    top = cands.Toplist(np.array([10, 10, 10, 10, 10], np.float32))
    top.template(0, _hits(k0=[(b, 20.0 + b) for b in range(100, 200)]))
    assert top.weakest(0) == 120.0 and top.threshold(0) == 120.0
    # a weaker power at a kept bin, one below the threshold, one that
    # replaces its bin, one that pushes out the weakest
    top.template(1, _hits(k0=[(150, 100.0), (300, 119.0), (160, 500.0), (400, 130.0)]))
    entries = {(e[3]): (e[1], e[2]) for e in top.entries() if e[0] == 0}
    assert entries[150] == (170.0, 0) and 300 not in entries and entries[160] == (500.0, 1)
    assert entries[400] == (130.0, 1) and 100 not in entries and len(entries) == 100
    # the threshold of a template is fixed at its start, the weakest is live
    assert top.threshold(0) == 121.0


def test_the_output_stage_writes_each_bin_once_in_order():
    bank = (np.array([1000.0, 700.0]), np.array([0.0, 0.1]), np.array([0.0, 1.0]))
    entries = [(0, 30.0, 0, 500), (1, 40.0, 1, 500), (2, 45.0, 1, 600), (0, 25.0, 0, 700)]
    rows = cands.emit(entries, bank)
    assert [int(r["f0"]) for r in rows] == sorted({500, 600, 700}, key=lambda f: -max(
        cands.false_alarm(p, 1 << k) for k, p, _, b in entries if b == f))
    assert list(rows["fA"]) == sorted(rows["fA"], reverse=True)
    at500 = rows[rows["f0"] == 500][0]
    assert at500["n_harm"] == 2 and at500["t"] == 1 and at500["power"] == pytest.approx(40.0 / math.sqrt(2))
    assert at500["P_b"] == float(np.float32(700.0))
