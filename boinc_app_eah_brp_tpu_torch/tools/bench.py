"""Benchmark: orbital templates/sec of the port on one CUDA card.

The port's twin of the repository's ``bench.py``, on its protocol, so the
two packages bench one problem: a 2^22-sample workunit with the
6,662-template bank under ``-A 0.08 -P 3.0 -f 400.0 -W`` (whitening and a
zaplist), window 1000, and the batched search step timed in steady state.
Without the shipped test workunit (``$BENCH_TESTWU``, a directory holding
it under the reference's file names) the problem is the JAX bench's
seeded synthetic one (:func:`synthetic_problem`), bit for bit.  The
baseline is the reference's only citable rate, ~2 templates/s
(``BASELINE.md``).

Run it as ``python -m boinc_app_eah_brp_tpu_torch.tools.bench``.  It
prints exactly one JSON line:
    {"metric": ..., "value": N, "unit": "templates/sec", "vs_baseline": N, ...}

The default entry point is an orchestrator that runs the bench body in a
child process under a watchdog timeout, after a cheap liveness probe
(``--probe``: a CUDA card and one launch on it).  It retries a probe or a
child that hangs or crashes; when no attempt succeeds it prints the error
payload (``value`` null, ``error`` naming each failure, the child's stderr
tail included) and exits 1.  There is no CPU fallback and no replay of an
earlier artifact: every number it prints was measured on this card in this
call.

The body (:func:`run_bench`) whitens, uploads the bank, runs the first
batch (the kernel build, when the libraries are not built yet, and the
cuFFT plan), then the timed loop over ``BENCH_TEMPLATES`` templates in
whole batches, queued ahead on the CUDA stream and drained once, then the
same steps drained after each (``feed_split``: what the host costs a
batch).  The batch is ``BENCH_BATCH``, else ``runtime/autobatch.py``'s
choice.  ``ERP_BENCH_JSON_COPY`` receives the full payload (with the
roofline table and the whole run report) of a ``cuda`` run; with
``ERP_TRACE_FILE`` set the payload carries the trace's stall table
(``tools/trace_report.py``).

Fields of the JAX bench's payload that the port does not carry
(:data:`DROPPED_FIELDS`):

* ``mfu``: the port's roofline (``runtime/roofline.py``) models no matrix
  unit; the payload carries ``fraction_of_attainable`` and
  ``hbm_utilization`` instead;
* ``compiler_bound_templates_per_sec``: it needs ``COST_LEDGER.json``,
  which XLA's compiler writes;
* ``hlo_attrib_file``: it names an artifact of XLA's HLO;
* ``cache_warm``: there is no compilation cache; ``kernels_built`` says
  how many kernel sources this run compiled (0: built before, or shipped
  in ``$ERP_KERNEL_DIR``), from ``ops/kernels.py::build_listeners``;
* ``same_host_full_bank`` and ``note``: they belong to the CPU fallback
  and the replay, which the port does not have.

Env knobs: BENCH_BATCH, BENCH_TEMPLATES (timed templates, default 256),
BENCH_TESTWU, BENCH_TOTAL_BUDGET (overall deadline seconds, default
2700), BENCH_CHILD_TIMEOUT (cap per attempt, default 1200),
BENCH_PROBE_TIMEOUT (default 180), BENCH_RETRIES (attempts, default 2).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)

# the shipped test workunit's file names (debian/extra/einstein_bench/testwu)
TESTWU_ENV = "BENCH_TESTWU"
WU_NAME = "p2030.20151015.G187.41-00.88.N.b2s0g0.00000_1099.bin4"
BANK_NAME = "stochastic_full.bank"
ZAP_NAME = "p2030.20151015.G187.41-00.88.N.b2s0g0.00000.zap"

BASELINE_TEMPLATES_PER_SEC = 2.0  # debian/rules:162-163 implied CPU rate

METRIC = "orbital templates/sec/chip (2^22-sample WU, -A 0.08 -P 3.0 -f 400.0 -W)"

# the synthetic problem: what the JAX bench builds without the test workunit
SYNTH_SAMPLES = 1 << 22
SYNTH_TEMPLATES = 6662
SYNTH_TSAMPLE_US = 65.476
ZAP_RANGES = ((60.0, 60.2), (119.9, 120.1))

DROPPED_FIELDS = (
    "mfu", "compiler_bound_templates_per_sec", "hlo_attrib_file", "cache_warm", "same_host_full_bank", "note",
)

# the provenance-stamped surface of the ``git_head`` stamp
_MEASURED_SURFACES = ("boinc_app_eah_brp_tpu_torch",)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class Problem:
    """One bench problem: the workunit's samples (float32 nibble values),
    the bank, the zap ranges, the search configuration and the geometry
    derived from them, and the 4-bit payload the workunit ships as."""

    samples: np.ndarray
    tsample_us: float
    P: np.ndarray
    tau: np.ndarray
    psi: np.ndarray
    zap_ranges: np.ndarray
    cfg: object
    derived: object
    packed: tuple | None


def bench_config():
    from ..oracle.pipeline import SearchConfig

    return SearchConfig(f0=400.0, padding=3.0, fA=0.08, window=1000, white=True)


def synthetic_problem(n_samples: int = SYNTH_SAMPLES, n_templates: int = SYNTH_TEMPLATES) -> Problem:
    """The JAX bench's synthetic workunit and bank from ``default_rng(0)``:
    N(4, 1.5) nibbles at 65.476 us, bank row 0 the null template (1000, 0,
    0), the rest P 3,000-50,000 s, tau 0-3 s, psi uniform; at the default
    sizes, the production problem.  Smaller sizes make the fixture of the
    tests (the same draws, fewer of them)."""
    from ..io.workunit import pack_4bit
    from ..oracle.pipeline import DerivedParams

    rng = np.random.default_rng(0)
    samples = np.clip(rng.normal(4.0, 1.5, n_samples).round(), 0, 15).astype(np.float32)
    nb = n_templates
    P = np.concatenate([[1000.0], rng.uniform(3000.0, 50000.0, nb - 1)])
    tau = np.concatenate([[0.0], rng.uniform(0.0, 3.0, nb - 1)])
    psi = np.concatenate([[0.0], rng.uniform(0.0, 2 * np.pi, nb - 1)])
    cfg = bench_config()
    return Problem(
        samples=samples,
        tsample_us=SYNTH_TSAMPLE_US,
        P=P,
        tau=tau,
        psi=psi,
        zap_ranges=np.array(ZAP_RANGES, dtype=np.float64),
        cfg=cfg,
        derived=DerivedParams.derive(n_samples, SYNTH_TSAMPLE_US, cfg),
        packed=(np.frombuffer(pack_4bit(samples, 1.0), dtype=np.uint8), 1.0),
    )


def load_problem(testwu: str | None = None) -> Problem:
    """The shipped test workunit of ``testwu`` (default ``$BENCH_TESTWU``)
    when it is there, else :func:`synthetic_problem` at production size."""
    testwu = testwu if testwu is not None else os.environ.get(TESTWU_ENV)
    wu_path = os.path.join(testwu, WU_NAME) if testwu else None
    if not wu_path or not os.path.exists(wu_path):
        log("bench: test workunit unavailable, using the synthetic 2^22 workunit")
        return synthetic_problem()
    from ..io.templates import read_template_bank
    from ..io.workunit import read_workunit
    from ..io.zaplist import read_zaplist
    from ..oracle.pipeline import DerivedParams

    wu = read_workunit(wu_path)
    bank = read_template_bank(os.path.join(testwu, BANK_NAME))
    cfg = bench_config()
    tsample_us = float(wu.header["tsample"])
    return Problem(
        samples=wu.samples,
        tsample_us=tsample_us,
        P=bank.P,
        tau=bank.tau,
        psi=bank.psi0,
        zap_ranges=read_zaplist(os.path.join(testwu, ZAP_NAME)),
        cfg=cfg,
        derived=DerivedParams.derive(wu.nsamples, tsample_us, cfg),
        packed=(wu.raw, float(wu.header["scale"])) if wu.raw is not None else None,
    )


def write_problem(problem: Problem, directory: str) -> dict:
    """The problem as the files the command line reads: the 4-bit
    workunit, the template bank and the zaplist in ``directory``.  Returns
    their paths (``wu``, ``bank``, ``zap``) and the command line's search
    options (``args``)."""
    from ..io import TemplateBank, write_template_bank, write_workunit

    os.makedirs(directory, exist_ok=True)
    paths = {k: os.path.join(directory, v) for k, v in (("wu", "bench.bin4"), ("bank", "bench.bank"), ("zap", "bench.zap"))}
    scale = problem.packed[1] if problem.packed else 1.0
    write_workunit(paths["wu"], problem.samples, tsample_us=problem.tsample_us, scale=scale)
    write_template_bank(paths["bank"], TemplateBank(problem.P, problem.tau, problem.psi))
    with open(paths["zap"], "w") as f:
        f.writelines(f"{float(lo)!r} {float(hi)!r}\n" for lo, hi in problem.zap_ranges)
    cfg = problem.cfg
    paths["args"] = [
        "-A", repr(float(cfg.fA)), "-P", repr(float(cfg.padding)), "-f", repr(float(cfg.f0)), "-B", str(cfg.window), "-W"
    ]
    return paths


def ensure_median(device, log=log) -> str:
    """Resolve the whitening's median on ``device`` before the bench
    starts, and return it: the bench times the path a whitening there takes
    by default (``ops/whiten.py::check_median``) and no other, the device
    median (``csrc/median.cu``) on a card and the native ``rngmed`` on the
    CPU.  An ``ERP_MEDIAN`` that takes the other path exits; on the CPU a
    native library that does not load raises ``RadpulError(RADPUL_EVAL)``,
    naming it."""
    import torch

    from ..ops import native_median
    from ..ops.whiten import check_median, default_median

    # on the CPU the bench times the native median and no fallback
    library = "csrc/median.cu" if torch.device(device).type == "cuda" else native_median.load()
    default = default_median(device)
    path = check_median(device)
    if path != default:
        raise SystemExit(
            f"bench: ERP_MEDIAN={os.environ.get('ERP_MEDIAN')} would time the {path} median, not the {default} "
            f"one a whitening on {device} takes; unset it"
        )
    log(f"bench: {path} median {library}")
    return path


def card_and_power_limit(index: int = 0) -> tuple[str | None, str | None]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None, None
    name, _, limit = out.stdout.strip().partition(", ")
    return (name or None), (limit or None)


def run_bench(problem: Problem, device: str = "cuda", batch: int | None = None, n_timed: int = 256, log=log) -> dict:
    """The bench body on ``problem``: whitening, the bank feed, the first
    batch, the timed loop queued ahead over ``n_timed`` templates in whole
    batches (its start wrapping inside the bank) and the forced-sync loop.
    ``batch`` None takes ``runtime/autobatch.py``'s choice.  Returns
    ``payload`` (the compact line), ``full`` (with the roofline and the
    whole run report), ``state`` (the timed loop's (M, T), which covers
    templates ``[0, batch + n_timed)`` when no start wrapped) and
    ``sync_state`` (the forced-sync loop's, over ``[0, n_timed)``)."""
    import torch

    from ..device import resolve_device
    from ..models.search import (
        BankStep, SearchGeometry, bank_params_host, init_state, lut_step_for_bank, lut_tiles_for_bank,
        max_slope_for_bank, upload_bank,
    )
    from ..ops import kernels
    from ..ops.whiten import whiten_and_zap
    from ..runtime import metrics, tracing
    from ..runtime.roofline import roofline_report

    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    ensure_median(dev, log)
    # in-memory metrics: the payload carries a run report (phase walls,
    # kernel builds, cuFFT plans, the autobatch decision)
    metrics.configure(force=True)
    trace_armed = tracing.configure()
    if trace_armed:
        metrics.note_host_trace(os.environ.get(tracing.TRACE_FILE_ENV, ""))
    built: list = []

    def on_build(n, seconds):
        built.append((n, seconds))

    kernels.build_listeners.append(on_build)
    try:
        P, tau, psi = problem.P, problem.tau, problem.psi
        derived, cfg = problem.derived, problem.cfg
        log(
            f"bench: device={dev} nsamples={derived.nsamples} fft_size={derived.fft_size} "
            f"fund_hi={derived.fundamental_idx_hi} harm_hi={derived.harmonic_idx_hi} bank={len(P)}"
        )
        t0 = time.perf_counter()
        with tracing.span("whitening"):
            ts = whiten_and_zap(problem.samples, derived, cfg, problem.zap_ranges, device=dev)
            sync()
        whitening_s = time.perf_counter() - t0
        metrics.record_phase("whitening", whitening_s)
        log(f"bench: whitening {whitening_s:.2f}s (once per WU, untimed)")

        geom = SearchGeometry.from_derived(
            derived,
            max_slope=max_slope_for_bank(P, tau),
            lut_step=lut_step_for_bank(P, derived.dt),
            lut_tiles=lut_tiles_for_bank(P, psi, derived.n_unpadded, derived.dt),
        )
        if batch is None:
            from ..runtime.autobatch import choose_batch

            batch = choose_batch(geom.nsamples, log=lambda m: log("bench: " + m.rstrip()), device=dev)
        batch = min(int(batch), len(P))
        n_timed = min(int(n_timed), len(P))
        n_timed = max(batch, (n_timed // batch) * batch)  # whole batches, >= 1
        n_total = len(P)

        t0 = time.perf_counter()
        with tracing.span("feed-setup"):
            bank = upload_bank(bank_params_host(P, tau, psi, geom.dt), batch, dev)
            sync()
        feed_setup_s = time.perf_counter() - t0
        metrics.record_phase("feed setup", feed_setup_s)
        log(f"bench: bank feed setup (derive {len(P)} params + upload) {feed_setup_s:.3f}s, once per WU")

        # the first batch: the kernel build (when not built yet) and the cuFFT plan
        step = BankStep(geom, bank, batch, state=init_state(geom, dev))
        t0 = time.perf_counter()
        with tracing.span("compile-first-batch"):
            step(ts, 0, n_total)
            sync()
        compile_s = time.perf_counter() - t0
        metrics.record_phase("compile+first batch", compile_s)
        kernels_built = sum(n for n, _ in built)
        log(f"bench: compile+first batch {compile_s:.2f}s (kernel sources compiled: {kernels_built})")

        # the timed loop, the production schedule: the CUDA stream queues
        # the steps ahead of the card, one drain at the end
        n_batches = n_timed // batch
        done = batch
        t0 = time.perf_counter()
        with tracing.span("dispatch", n_templates=n_timed):
            while done < batch + n_timed:
                step(ts, done % (len(P) - batch + 1), n_total)
                done += batch
        with tracing.span("drain"):
            sync()
        elapsed = time.perf_counter() - t0
        metrics.record_phase("timed async loop", elapsed)

        # the same steps drained after each: the per-batch difference is
        # the host feed and dispatch the queued schedule hides
        sync_step = BankStep(geom, bank, batch, state=init_state(geom, dev))
        done = 0
        t0 = time.perf_counter()
        with tracing.span("forced-sync-loop", n_templates=n_timed):
            while done < n_timed:
                sync_step(ts, done % (len(P) - batch + 1), n_total)
                sync()
                done += batch
        sync_elapsed = time.perf_counter() - t0
        metrics.record_phase("timed sync loop", sync_elapsed)

        async_ms = elapsed / n_batches * 1e3
        sync_ms = sync_elapsed / n_batches * 1e3
        feed_split = {
            "async_wall_per_batch_ms": round(async_ms, 3),
            "forced_sync_wall_per_batch_ms": round(sync_ms, 3),
            "overhead_per_batch_ms": round(sync_ms - async_ms, 3),
            "feed_setup_s": round(feed_setup_s, 3),
        }
        log(f"bench: feed split per batch: async {async_ms:.1f} ms, forced-sync {sync_ms:.1f} ms, "
            f"overhead {sync_ms - async_ms:.1f} ms")

        rate = n_timed / elapsed
        log(f"bench: {n_timed} templates ({n_batches} batches of {batch}) in {elapsed:.2f}s -> {rate:.2f} templates/s")
        full_wu_min = len(P) / rate / 60.0
        log(f"bench: full {len(P)}-template WU projected {full_wu_min:.1f} min")
        # a completed WU emits <= 100 candidates (demod_binary.c:1630-1671)
        candidates_per_hr = 100.0 / (full_wu_min / 60.0)

        roof = roofline_report(
            geom.nsamples, geom.n_unpadded, geom.fund_hi, geom.harm_hi, batch=batch,
            measured_templates_per_sec=rate,
        )
        log(
            f"bench: roofline card={roof['card']} attainable={roof['attainable_templates_per_sec']} t/s "
            f"fraction={roof.get('fraction_of_attainable')} hbm_util={roof.get('hbm_utilization')} "
            f"bound={roof.get('bound')}"
        )
        card, power_limit = card_and_power_limit(dev.index or 0) if on_card else (None, None)
        payload = {
            "metric": METRIC,
            "value": round(rate, 3),
            "unit": "templates/sec",
            "vs_baseline": round(rate / BASELINE_TEMPLATES_PER_SEC, 3),
            "backend": dev.type,
            "card": card,
            "power_limit": power_limit,
            "batch": batch,
            "n_templates": len(P),
            "n_timed": n_timed,
            "n_batches": n_batches,
            "projected_wu_min": round(full_wu_min, 3),
            "candidates_per_hr": round(candidates_per_hr, 1),
            "whitening_s": round(whitening_s, 2),
            "compile_first_batch_s": round(compile_s, 2),
            "feed_split": feed_split,
            "kernels_built": kernels_built,
            "fraction_of_attainable": roof.get("fraction_of_attainable"),
            "hbm_utilization": roof.get("hbm_utilization"),
            "bound": roof.get("bound"),
            "attainable_templates_per_sec": roof["attainable_templates_per_sec"],
            "git_head": _git_head(),
        }
    finally:
        kernels.build_listeners.remove(on_build)

    trace_summary = tracing.finish(0) if trace_armed else None
    if trace_summary and trace_summary.get("trace_file"):
        payload["trace_file"] = trace_summary["trace_file"]
        try:
            from . import trace_report

            payload["trace_stalls"] = trace_report.stall_table(trace_report.load_trace(trace_summary["trace_file"]))
        except Exception as e:  # the bench number outranks its telemetry
            log(f"bench: trace stall table unavailable: {e}")
    report = metrics.finish(0, context={"program": "bench", "batch": batch})
    if report is not None:
        payload["run_report"] = metrics.compact_report(report)
    full = dict(payload, roofline=roof)
    if report is not None:
        full["run_report"] = report
    return {"payload": payload, "full": full, "state": (step.M, step.T), "sync_state": (sync_step.M, sync_step.T)}


def _git_head(cwd: str | None = None) -> str | None:
    """HEAD sha for the payload's provenance stamp, suffixed ``-dirty``
    when the measured surface (the port's package) has uncommitted edits
    or untracked files; None outside a git checkout."""
    cwd = cwd or _REPO
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, timeout=10
        )
        head = out.stdout.decode().strip() or None
        if head is None:
            return None
        # status --porcelain, not diff: an untracked module changes the
        # measured behaviour as much as an edit does
        status = subprocess.run(
            ["git", "status", "--porcelain", "-uall", "--", *_MEASURED_SURFACES],
            cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, timeout=10,
        )
        dirty = status.returncode != 0 or bool(status.stdout.strip())
        return head + "-dirty" if dirty else head
    except (OSError, subprocess.TimeoutExpired):
        return None


def run_child_body() -> int:
    """``--run``: the body on the card on :func:`load_problem`'s problem,
    the compact line on stdout, the full payload to
    ``$ERP_BENCH_JSON_COPY``."""
    batch = int(os.environ["BENCH_BATCH"]) if os.environ.get("BENCH_BATCH") else None
    n_timed = int(os.environ.get("BENCH_TEMPLATES", "256"))
    # stdout is the machine-read channel: the worker log's debug lines
    # (stdout in the reference's convention) go to stderr meanwhile
    with contextlib.redirect_stdout(sys.stderr):
        out = run_bench(load_problem(), device="cuda", batch=batch, n_timed=n_timed)
    copy = os.environ.get("ERP_BENCH_JSON_COPY")
    if copy and out["payload"]["backend"] == "cuda":
        try:
            with open(copy, "w") as f:
                f.write(json.dumps(out["full"]) + "\n")
        except OSError as e:
            log(f"bench: could not write {copy}: {e}")
    print(json.dumps(out["payload"]), flush=True)
    return 0


def run_probe() -> int:
    """``--probe``: a CUDA card and one launch on it.  Exit 0 live, 1
    when there is no card (the orchestrator stops retrying), 2 when the
    launch gave a wrong answer."""
    import torch

    if not torch.cuda.is_available():
        log("bench[probe]: no CUDA device (torch.cuda.is_available() is false)")
        return 1
    x = torch.ones((256, 256), device="cuda")
    val = float((x @ x)[0, 0].item())
    ok = val == 256.0
    print(json.dumps({"metric": "probe", "ok": ok, "backend": "cuda", "card": torch.cuda.get_device_name(0)}))
    return 0 if ok else 2


def _stderr_tail(raw: bytes | None, limit: int = 500) -> str:
    if not raw:
        return ""
    text = raw.decode(errors="replace")
    tail = " | ".join(line for line in text.splitlines()[-6:] if line.strip())
    return tail[-limit:]


def _scan_for_payload(stdout: bytes | None) -> dict | None:
    if not stdout:
        return None
    for line in reversed(stdout.decode(errors="replace").splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                payload = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(payload, dict) and "metric" in payload:
                return payload
    return None


def _child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _run_child(timeout: float) -> tuple[dict | None, str]:
    """The body in a child under a watchdog; returns (payload, failure
    reason).  The child's stderr is relayed to ours and its tail folded
    into the reason."""
    cmd = [sys.executable, "-m", "boinc_app_eah_brp_tpu_torch.tools.bench", "--run"]
    try:
        proc = subprocess.run(cmd, env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, timeout=timeout)
    except subprocess.TimeoutExpired as exc:
        tail = _stderr_tail(exc.stderr)
        if tail:
            sys.stderr.write(tail + "\n")
        # a child that measured and then wedged in teardown still answered
        payload = _scan_for_payload(exc.stdout)
        if payload is not None:
            return payload, ""
        return None, f"timed out after {timeout:.0f}s" + (f"; stderr tail: {tail}" if tail else "")
    except OSError as exc:
        return None, f"failed to spawn child: {exc}"
    if proc.stderr:
        sys.stderr.buffer.write(proc.stderr)
        sys.stderr.flush()
    payload = _scan_for_payload(proc.stdout)
    if payload is not None:
        return payload, ""
    tail = _stderr_tail(proc.stderr)
    return None, f"child exited rc={proc.returncode} without a JSON result" + (f"; stderr tail: {tail}" if tail else "")


def orchestrate() -> int:
    """Attempts with backoff, each a probe and then the body in a child;
    then the error payload.  Exactly one JSON line on stdout; exit 0 with
    a measured payload, 1 without one."""
    t_start = time.monotonic()
    total_budget = float(os.environ.get("BENCH_TOTAL_BUDGET", "2700"))
    child_timeout = float(os.environ.get("BENCH_CHILD_TIMEOUT", "1200"))
    probe_timeout = float(os.environ.get("BENCH_PROBE_TIMEOUT", "180"))
    retries = int(os.environ.get("BENCH_RETRIES", "2"))
    failures: list[str] = []

    def remaining() -> float:
        return total_budget - (time.monotonic() - t_start)

    for attempt in range(retries):
        budget = min(child_timeout, remaining())
        if budget < 60.0:
            failures.append(f"attempt {attempt + 1}: skipped (deadline: {remaining():.0f}s left)")
            break
        eff_timeout = min(probe_timeout, budget)
        probe_cmd = [sys.executable, "-m", "boinc_app_eah_brp_tpu_torch.tools.bench", "--probe"]
        try:
            probe = subprocess.run(
                probe_cmd, env=_child_env(), timeout=eff_timeout, stdout=subprocess.PIPE, stderr=subprocess.PIPE
            )
            probe_rc: int | None = probe.returncode
            probe_err = _stderr_tail(probe.stderr)
        except subprocess.TimeoutExpired as exc:
            probe_rc = None
            probe_err = _stderr_tail(exc.stderr)
        if probe_rc != 0:
            what = f"hung past {eff_timeout:.0f}s" if probe_rc is None else f"failed rc={probe_rc}"
            failures.append(
                f"attempt {attempt + 1}: device probe {what}" + (f"; stderr tail: {probe_err}" if probe_err else "")
            )
            log(f"bench[orchestrator]: probe {what}, skipping the attempt")
            if probe_rc == 1:
                break  # no card: retrying cannot help
            if attempt + 1 < retries:
                time.sleep(10.0 * (attempt + 1))
            continue
        budget = min(child_timeout, remaining())
        if budget < 60.0:
            failures.append(f"attempt {attempt + 1}: skipped after probe (deadline: {remaining():.0f}s left)")
            break
        log(f"bench[orchestrator]: attempt {attempt + 1}/{retries} (timeout {budget:.0f}s)")
        payload, reason = _run_child(budget)
        if payload is not None:
            print(json.dumps(payload), flush=True)
            return 0
        failures.append(f"attempt {attempt + 1}: {reason}")
        log(f"bench[orchestrator]: {reason}")
        if attempt + 1 < retries:
            time.sleep(10.0 * (attempt + 1))

    print(json.dumps({
        "metric": METRIC,
        "value": None,
        "unit": "templates/sec",
        "vs_baseline": None,
        "error": "all device attempts failed: " + "; ".join(failures),
    }), flush=True)
    return 1


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--probe" in argv:
        return run_probe()
    if "--run" in argv:
        return run_child_body()
    return orchestrate()


if __name__ == "__main__":
    sys.exit(main())
