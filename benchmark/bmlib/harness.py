"""One run of one cell: ``run.py --workload W --seed N --seconds S
--trace 0|1``.

The manifest (``BENCHMARK.json``) names the cell; the cell names its
configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``), whose ``driver`` names the module under
``drivers/`` that runs it; each per-layer metric the cell reports is
``metrics/<name>.json``, whose ``reader`` names the module under
``readers/`` that computes it.  Nothing here knows a cell by name.

A run: set-up (timed as ``setup_s``), the measured window, the check that
the program loaded no JAX, the device's peak, the per-layer readings of a
traced run, then the comparison with the reference once the program's
state is freed.  The result is the last line of standard output; the
compared numbers, each beside its limit, are the last lines of standard
error and the result's last key.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
PROGRAM = "boinc_app_eah_brp_tpu_torch"
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "boinc_app_eah_brp_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of this folder as a module."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    the name before the first dot compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


class Cell:
    """What the manifest and the data files say of one cell."""

    def __init__(self, manifest: dict, workload: str):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; the manifest has {sorted(cells)}")
        self.workload = cells[workload]
        self.name = workload
        self.config = load_json(HERE, "configs", f"{self.workload['config']}.json")
        self.traffic = load_json(HERE, "traffic", f"{self.workload['traffic']}.json")
        self.end_to_end = [m for m in manifest["end_to_end"] if self._reports(m)]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"] if self._reports(m, m["moves"] in moved)]

    def _reports(self, metric: dict, default: bool = True) -> bool:
        """Whether this cell reports ``metric``: its ``workloads`` name
        the cell, or, without that key, ``default``."""
        return self.name in metric["workloads"] if "workloads" in metric else default


class Run:
    """The state of one run that the drivers share with the harness:
    the cell, the seed, the window's length, whether it is traced, the
    device, and a fresh directory under ``TMPDIR`` for its files."""

    def __init__(self, cell: Cell, seed: int, seconds: float, traced: bool, device: str):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.seconds = seconds
        self.traced = traced
        self.device = device
        self.dir = tempfile.mkdtemp(prefix="bench-run-", dir=os.environ.get("TMPDIR") or None)
        # filled by the driver
        self.metrics: dict = {}  # end-to-end values
        self.obs: dict = {}  # what the per-layer readers read
        self.attempted = 0
        self.failed = 0
        self.peak_bytes = 0
        self.forbidden: list[str] = []  # what the program's children found loaded

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


def cache_env() -> dict:
    """The environment of this process and the program's children: fixed
    cache directories inside the checkout for Triton and PyTorch's
    extension builds, which the program does not use today but a later
    kernel may (its own kernels build in its package's ``build/``), and
    no JAX from a library that would load it by itself."""
    base = os.path.join(ROOT, ".bench_cache")
    return {
        "TRITON_CACHE_DIR": os.path.join(base, "triton"),
        "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
        "USE_FLAX": "0",
    }


def import_program():
    """The program, from this checkout and nowhere else."""
    if ROOT not in sys.path[:1]:
        sys.path.insert(0, ROOT)
    mod = __import__(PROGRAM)
    where = os.path.dirname(os.path.dirname(os.path.abspath(mod.__file__)))
    if os.path.realpath(where) != os.path.realpath(ROOT):
        raise SystemExit(f"{PROGRAM} imported from {where}, not from this checkout {ROOT}")
    return mod


def card_name() -> tuple[str, str | None]:
    import torch

    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    return name, out or None


def per_layer(run: Run, cell: Cell) -> dict:
    """Each per-layer metric of the cell that its reader can read."""
    out = {}
    for m in cell.per_layer:
        spec = load_json(HERE, "metrics", f"{m['name']}.json")
        value = load_module("readers", spec["reader"]).read(run.obs, **spec.get("args", {}))
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = load_json(ROOT, "BENCHMARK.json")
    cell = Cell(manifest, args.workload)
    os.environ.update(cache_env())
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no result: the cell needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import_program()
    driver = load_module("drivers", cell.traffic["driver"])
    run = Run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    try:
        return _run(run, cell, driver, torch)
    finally:
        run.close()


def _run(run: Run, cell: Cell, driver, torch) -> int:
    # a driver whose program runs in child processes leaves this process
    # off the card until its window has closed
    in_process = getattr(driver, "IN_PROCESS", True)
    t0 = time.perf_counter()
    state = driver.setup(run)
    if in_process:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"setup {setup_s:.3f} s")
    driver.window(run, state)
    found = sorted(set(forbidden_modules()) | set(run.forbidden))
    if found:
        log("no result: JAX or the JAX package is loaded: " + ", ".join(found))
        return 3
    peak = max(run.peak_bytes, torch.cuda.max_memory_allocated() if in_process else 0)
    name, power_limit = card_name()
    device = {"platform": "gpu", "kind": name, "count": int(cell.workload["chips"]), "memory_peak_bytes": int(peak)}
    metrics = {}
    breakdown = None
    if run.traced:
        tr = run.obs.get("trace")
        if tr is None:
            log("no result: the traced run captured no trace")
            return 4
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        from bmlib import trace as trace_mod

        run.obs["peaks"] = trace_mod.card_peaks(name)
        metrics = per_layer(run, cell)
        breakdown = tr.breakdown()
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] in run.metrics:
                metrics[m["name"]] = {"value": float(run.metrics[m["name"]]), "unit": m["unit"]}
    t1 = time.perf_counter()
    correct, checks = driver.check(run, state)
    log(f"reference check {time.perf_counter() - t1:.3f} s")
    missing = [m["name"] for m in (cell.per_layer if run.traced else cell.end_to_end) if m["name"] not in metrics]
    if missing:
        log("not measured: " + ", ".join(missing))
    result = {
        "correct": bool(correct),
        "attempted": int(run.attempted),
        "failed": int(run.failed),
        "metrics": metrics,
        "device": device,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["power_limit"] = power_limit
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        log(f"check {n} {v!r} limit {lim!r}")
    print(json.dumps(result), flush=True)
    return 0
