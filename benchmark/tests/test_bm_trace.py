"""The roofline's byte arithmetic, its group rule, and the reading of a
Chrome trace: kernels to stages by name and by the program span around
their launch, the busy union, the idle gaps."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from bmlib import harness, inputs, trace  # noqa: E402

PALFA = inputs.geometry(harness.load_json(HERE, "configs", "palfa6662.json"))


def _env(T, launches, g=PALFA):
    return dict(T=T, launches=launches, n_unpadded=g.n_unpadded, nsamples=g.nsamples, L=g.nsamples // 2 + 1,
                fund_hi=g.fund_hi, harm_hi=g.harm_hi)


def test_palfa_geometry():
    g = PALFA
    assert (g.n_unpadded, g.nsamples, g.fft_size, g.window_2, g.fund_hi, g.harm_hi) == (
        4194304, 12582912, 6291457, 500, 329551, 5272824)


# bytes of one batch of 128 templates at the palfa geometry (PERF.md, the
# layers' table)
@pytest.mark.parametrize("stages, want", [
    (["resample", "fftprep"], 16_777_216 + 2_048 + 6_442_450_944),
    (["rfft"], 6_442_450_944 + 6_442_451_968),
    (["fold"], 5_399_371_776 + 843_650_560),
    (["merge"], 843_650_560 + 2 * 13_182_040),
])
def test_stage_bytes_of_a_batch(stages, want):
    got, _ = trace.stage_bytes(stages, _env(128, 1))
    assert got == want


def test_the_rfft_is_bound_by_bytes_not_operations():
    b, f = trace.stage_bytes(["rfft"], _env(128, 1))
    peaks = trace.card_peaks("NVIDIA H100 80GB HBM3")
    assert f / peaks["fp32_flops_per_s"] < b / peaks["bytes_per_s"] / 2
    assert trace.least_time_s(["rfft"], _env(128, 1), peaks) == b / peaks["bytes_per_s"]


def test_a_group_counts_only_its_outside_tensors():
    env = _env(128, 1)
    fold, _ = trace.stage_bytes(["fold"], env)
    merge, _ = trace.stage_bytes(["merge"], env)
    fused, _ = trace.stage_bytes(["fold", "merge"], env)
    sums = 4 * 5 * PALFA.fund_hi * 128
    assert fused == fold + merge - 2 * sums
    whole, _ = trace.stage_bytes(["resample", "fftprep", "rfft", "fold", "merge"], env)
    # the whole step: the series and the bank in, the state in and out
    assert whole == 16_777_216 + 2_048 + 2 * 13_182_040
    # a fusion never reads above its parts' bound: the group's bytes are at most the sum
    assert fused <= fold + merge


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def _chrome(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_load_maps_kernels_by_name_and_by_span(tmp_path):
    events = [
        _ev("user_annotation", trace.WINDOW, 100, 1000),
        _ev("user_annotation", "erp.merge", 500, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 110, 2, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 510, 2, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 700, 2, correlation=3),
        _ev("kernel", "void stream_kernel<true>(float const*)", 120, 30, tid=7, correlation=1),
        _ev("kernel", "void at::native::elementwise_kernel<128>()", 520, 40, tid=7, correlation=2),
        _ev("kernel", "void at::native::reduce_kernel<512>()", 710, 20, tid=7, correlation=3),
        _ev("kernel", "regular_fft_factor<1024>", 200, 100, tid=7, correlation=9),
        _ev("kernel", "fold_kernel", 1050, 100, tid=7, correlation=10),  # runs past the window
        _ev("gpu_memcpy", "Memcpy HtoD", 40, 30, tid=7),  # before the window
    ]
    tr = trace.load(_chrome(tmp_path, events))
    assert tr.window_s == pytest.approx(1000e-6)
    stages = {st for _, st, _, _ in tr.ops}
    assert stages == {"resample", "merge", None, "rfft", "fold"}
    assert tr.stage_s(["merge"]) == pytest.approx(40e-6)
    assert tr.stage_s(["fold"]) == pytest.approx(50e-6)  # clipped at the window's end
    assert tr.stage_s(["median"]) is None
    assert tr.busy_s() == pytest.approx((30 + 100 + 40 + 20 + 50) * 1e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "rfft"
    assert len(bd["idle_gaps"]) <= 10 and all(g[1] > 0 for g in bd["idle_gaps"])
    assert sum(g[1] for g in bd["idle_gaps"]) == pytest.approx(tr.window_s - tr.busy_s())


def test_a_fused_kernel_counts_only_for_its_whole_group(tmp_path):
    kmap = {"kernels": [["fold_merge_kernel", "fold+merge"]], "scopes": []}
    events = [_ev("user_annotation", trace.WINDOW, 0, 100), _ev("kernel", "fold_merge_kernel", 10, 20, tid=7)]
    tr = trace.load(_chrome(tmp_path, events), kmap)
    assert tr.stage_s(["fold"]) is None and tr.stage_s(["merge"]) is None
    assert tr.stage_s(["fold", "merge"]) == pytest.approx(20e-6)


def test_a_trace_without_its_window_is_refused(tmp_path):
    with pytest.raises(ValueError):
        trace.load(_chrome(tmp_path, [_ev("kernel", "k", 0, 1)]))


def test_the_kernel_map_starts_from_the_programs():
    m = trace.stage_map()
    keys = [k for k, _ in m["kernels"]]
    # fftprep's kernel carries "fft" in its name: it must match first
    assert keys.index("fftprep_kernel") < keys.index("fft")
    assert dict(m["scopes"]) == {"erp.merge": "merge"}


def test_readers_return_nothing_without_a_reading():
    for name in ("roofline", "device_idle", "peak_memory", "phase_per_wu", "startup"):
        mod = harness.load_module("readers", name)
        args = {"roofline": {"stages": ["rfft"]}, "phase_per_wu": {"phase": "whitening"}}.get(name, {})
        assert mod.read({}, **args) is None


def test_an_added_data_file_adds_stages_kernels_and_cards(tmp_path, monkeypatch):
    import shutil

    for f in os.listdir(trace.DATA):
        shutil.copy(os.path.join(trace.DATA, f), tmp_path)
    (tmp_path / "stage_bytes.fused.json").write_text(json.dumps(
        {"stages": {"fold_merge": {"reads": {"spectrum": "8 * harm_hi * T"}, "writes": {"state_out": "8"}},
                    "fold": {"reads": {}, "writes": {}}}}))
    (tmp_path / "kernel_stages.fused.json").write_text(json.dumps({"kernels": [["fold_kernel_v2", "fold_merge"]]}))
    (tmp_path / "peaks.other.json").write_text(json.dumps({"cards": [["Other Card", {"bytes_per_s": 1.0}]]}))
    monkeypatch.setattr(trace, "DATA", str(tmp_path))
    env = _env(128, 1)
    assert trace.stage_bytes(["fold_merge"], env)[0] == 8 * PALFA.harm_hi * 128 + 8
    # an added file cannot change a stage that is there
    assert trace.stage_bytes(["fold"], env)[0] == 5_399_371_776 + 843_650_560
    assert trace.stage_map()["kernels"][0] == ["fold_kernel_v2", "fold_merge"]
    assert trace.card_peaks("Other Card") == {"bytes_per_s": 1.0}
    assert trace.card_peaks("NVIDIA H100 80GB HBM3")["bytes_per_s"] == 3.35e12
