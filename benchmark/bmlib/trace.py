"""The traced run's readings: a ``torch.profiler`` capture of a steady
sub-window, and what the readers take from its Chrome trace.

:class:`Capture` profiles a window inside a ``bench.window`` range and
writes the Chrome trace.  :func:`load` reads it into a :class:`Trace`:
the device operations inside the window, each with the stage the
kernel-to-stage map (``data/kernel_stages.json``) gives it, the busy
time (the union of their intervals) and the window's length.
:func:`stage_bytes` is the byte arithmetic of ``data/stage_bytes.json``,
with the group rule: a tensor written and read inside the group is
counted by neither stage.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
import os

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
WINDOW = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def data(name: str) -> dict:
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def data_files(stem: str) -> list[dict]:
    """``data/<stem>.json`` and every ``data/<stem>.<more>.json`` beside it,
    the added files first: a later change adds a stage, a kernel name or
    a card in a file of its own."""
    names = sorted(f for f in os.listdir(DATA) if f.startswith(stem + ".") and f.endswith(".json"))
    return [data(f) for f in sorted(names, key=lambda f: f == stem + ".json")]


def stage_map() -> dict:
    """The kernel-to-stage map of every ``kernel_stages`` file."""
    files = data_files("kernel_stages")
    return {"kernels": [e for d in files for e in d.get("kernels", [])],
            "scopes": [e for d in files for e in d.get("scopes", [])]}


class Capture:
    """A ``torch.profiler`` session (CPU and CUDA activity) whose window
    is a ``bench.window`` range, opened once the session has started (a
    start takes seconds and stalls the process's other threads);
    :meth:`stop` drains the card, closes the range, ends the session and
    writes the Chrome trace to ``path``."""

    def __init__(self, path: str):
        import torch

        self.path = path
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.rf = torch.profiler.record_function(WINDOW)
        self.rf.__enter__()

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)


def capture(fn, path: str):
    """``fn()`` inside a :class:`Capture` to ``path``; returns its result."""
    cap = Capture(path)
    try:
        return fn()
    finally:
        cap.stop()


@dataclasses.dataclass
class Trace:
    window_us: tuple[float, float]
    ops: list  # (name, stage or None, start_us, end_us), device operations in the window
    annotations: list  # (name, start_us, end_us), host ranges

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) * 1e-6

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of their
        intervals inside the window."""
        total, end = 0.0, -math.inf
        for _, _, a, b in sorted(self.ops, key=lambda o: o[2]):
            if b <= end:
                continue
            total += b - max(a, end)
            end = b
        return total * 1e-6

    def stage_s(self, stages) -> float | None:
        """Device seconds of the operations of ``stages`` (a set of stage
        names; a group's '+'-joined name counts where all its members are
        asked for); None when none ran."""
        want = set(stages)
        got = [b - a for _, st, a, b in self.ops if st is not None and set(st.split("+")) <= want]
        return sum(got) * 1e-6 if got else None

    def gaps(self) -> list:
        """Idle intervals of the device inside the window, (start, end) us."""
        out, end = [], self.window_us[0]
        for _, _, a, b in sorted(self.ops, key=lambda o: o[2]):
            if a > end:
                out.append((end, a))
            end = max(end, b)
        if self.window_us[1] > end:
            out.append((end, self.window_us[1]))
        return out

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time (by stage, else a
        short kernel name) and the longest idle gaps, named by the
        innermost host range around each gap's middle."""
        by: dict[str, float] = {}
        for name, st, a, b in self.ops:
            key = st or _short(name)
            by[key] = by.get(key, 0.0) + (b - a) * 1e-6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            around = [(e - s, nm) for nm, s, e in self.annotations if s <= mid <= e and nm != WINDOW]
            named.append([min(around)[1] if around else "host", (b - a) * 1e-6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def _short(name: str) -> str:
    base = name.split("(")[0].split("<")[0].strip()
    return base.split()[-1][:48] if base else name[:48]


def load(path: str, kmap: dict | None = None) -> Trace:
    """The Chrome trace at ``path`` read into a :class:`Trace`; raises
    ``ValueError`` when it holds no ``bench.window`` range."""
    kmap = kmap or stage_map()
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not windows:
        raise ValueError(f"{path}: no {WINDOW} range")
    w0 = min(float(e["ts"]) for e in windows)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in windows)
    launch = {}
    for e in events:
        if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
    scoped = {nm for nm, _ in kmap["scopes"]}
    scope_stage = dict(kmap["scopes"])
    ranges: dict = {}
    annotations = []
    for e in events:
        if e.get("cat") in ("user_annotation", "cpu_op"):
            s, d = float(e["ts"]), float(e["dur"])
            annotations.append((e["name"], s, s + d))
            if e["name"] in scoped:
                ranges.setdefault(e.get("tid"), []).append((s, s + d, e["name"]))
    starts = {tid: sorted(v) for tid, v in ranges.items()}
    keys = {tid: [r[0] for r in v] for tid, v in starts.items()}
    ops = []
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        name = e.get("name", "")
        stage = next((st for key, st in kmap["kernels"] if key in name), None)
        if stage is None and e.get("cat") == "kernel":
            tid, t = launch.get(e.get("args", {}).get("correlation"), (None, None))
            if tid in starts:
                i = bisect.bisect_right(keys[tid], t)
                inside = [r for r in starts[tid][:i] if r[1] >= t]
                if inside:
                    stage = scope_stage[max(inside)[2]]
        ops.append((name, stage, a, b))
    return Trace((w0, w1), ops, annotations)


def _eval(expr: str, env: dict) -> float:
    return float(eval(expr, {"__builtins__": {}, "log2": math.log2}, env))  # noqa: S307 - data files of this folder


def stage_bytes(stages, env: dict) -> tuple[float, float]:
    """(bytes, flops) of the group ``stages`` under ``env`` (T, launches
    and the geometry): each member's reads of tensors no member writes,
    and writes of tensors no member reads."""
    table = {k: v for d in data_files("stage_bytes") for k, v in d["stages"].items()}
    members = [table[s] for s in stages]
    written = {t for m in members for t in m["writes"]}
    read = {t for m in members for t in m["reads"]}
    total = 0.0
    flops = 0.0
    for m in members:
        total += sum(_eval(x, env) for t, x in m["reads"].items() if t not in written)
        total += sum(_eval(x, env) for t, x in m["writes"].items() if t not in read)
        if "flops" in m:
            flops += _eval(m["flops"], env)
    return total, flops


def card_peaks(name: str) -> dict | None:
    for key, peaks in (c for d in data_files("peaks") for c in d["cards"]):
        if key in name:
            return peaks
    return None


def least_time_s(stages, env: dict, peaks: dict) -> float:
    """The least time of the group on the card: the larger of its bytes at
    the memory bandwidth and its operations at the float32 peak."""
    b, f = stage_bytes(stages, env)
    return max(b / peaks["bytes_per_s"], f / peaks["fp32_flops_per_s"])
