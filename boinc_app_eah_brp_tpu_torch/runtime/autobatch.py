"""Batch-size auto-selection for the batched search step.

The port's counterpart of the JAX package's ``runtime/autobatch.py``, with
the same selection order, clamps, log lines and ``autobatch.*`` metrics:

1. ``ERP_BATCH`` env override (operator knob);
2. the port's own sweep artifact (:func:`sweep` writes it; the path is
   ``$ERP_TORCH_BATCH_SWEEP``, default ``build/TORCH_BATCHSWEEP.json`` in
   the package), its ``best_batch`` taken as proven when it was measured on
   this card's kind at this ``nsamples``, else only when it fits the
   memory model; an artifact from another card kind is ignored.  The JAX
   package's ``BATCHSWEEP_r*.json`` is never read: it carries no schema
   this module accepts;
3. the memory model: the largest power-of-two batch whose estimated
   working set fits 60% of the card's budget, clamped to [8, 128].

The budget is the card's free memory (``torch.cuda.mem_get_info``) plus
what the caching allocator holds reserved but unused: ``mem_get_info``
alone does not count memory torch has cached for reuse.  A task given a
share of the card (BOINC's ``gpu_usage`` in ``init_data.xml``: 0.25 runs
four tasks on one card, all starting with the whole card free) budgets at
most that share of the card's total memory, and a sweep rung, which
proved a fit on a whole card, is held to that budget too.
"""

from __future__ import annotations

import json
import os
import time

from . import flightrec, metrics

# float32 arrays of length nsamples live per template.  Anchored on the
# card when the batch's R2C was cuFFT's, whose work area took a third
# array: the whitened production search (2^22 samples padded 3x, nsamples
# 12,582,912) peaked at 4.895 GB at batch 32 on an NVIDIA H100 80GB HBM3
# (chip_smoke.py), 4.895e9 / 32 / (12,582,912 * 4) = 3.04.  The port's own
# R2C (csrc/rfft.cu) works in place over the series, so the factor now
# overstates the working set: a margin, not a measurement.
_WORKING_SET_FACTOR = 3.04
_MIN_BATCH = 8
_MAX_BATCH = 128

SWEEP_ENV = "ERP_TORCH_BATCH_SWEEP"
SWEEP_SCHEMA = "erp-torch-batchsweep/1"
SWEEP_BATCHES = (8, 16, 32, 64, 128)


def default_sweep_path() -> str:
    from ..ops.kernels import BUILD_DIR

    return os.path.join(BUILD_DIR, "TORCH_BATCHSWEEP.json")


def _device(device):
    import torch

    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_memory_budget(device=None) -> int | None:
    """Bytes the search may still take on the card: free memory plus the
    caching allocator's reserved-but-unused bytes; None on the CPU or when
    unknown."""
    try:
        import torch

        dev = _device(device)
        if dev.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(dev)
        cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
        return int(free) + int(cached)
    except Exception:
        return None


def device_total_memory(device=None) -> int | None:
    """The card's total memory in bytes; None on the CPU or when unknown."""
    try:
        import torch

        dev = _device(device)
        if dev.type != "cuda":
            return None
        return int(torch.cuda.get_device_properties(dev).total_memory)
    except Exception:
        return None


def _current_device_kind(device=None) -> str | None:
    try:
        import torch

        dev = _device(device)
        if dev.type != "cuda":
            return None
        return str(torch.cuda.get_device_name(dev))
    except Exception:  # noqa: BLE001 - diagnostics-only probe
        return None


def _sweep_best_batch() -> tuple[int, str | None, int | None] | None:
    """(best_batch, device_kind, nsamples) from the port's sweep artifact,
    or None when there is none or it is not the port's."""
    path = os.environ.get(SWEEP_ENV) or default_sweep_path()
    try:
        with open(path) as f:
            art = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(art, dict) or art.get("schema") != SWEEP_SCHEMA or not art.get("best_batch"):
        return None
    kind, swept_n = art.get("device_kind"), art.get("nsamples")
    return int(art["best_batch"]), (str(kind) if kind else None), (int(swept_n) if swept_n else None)


def model_batch(nsamples: int, budget_bytes: int | None) -> int:
    """Largest power-of-two batch fitting the memory model, with a 0.6
    headroom on top of the factor (free memory at start can be below the
    card's size: other buffers, fragmentation).  A sweep rung measured on
    this card kind bypasses this model (see :func:`choose_batch`)."""
    if budget_bytes is None:
        # unknown budget (the CPU): a safe middle rung
        return 16
    per_template = _WORKING_SET_FACTOR * nsamples * 4.0
    fit = max(1.0, 0.6 * budget_bytes / per_template)
    b = _MIN_BATCH
    while b * 2 <= min(fit, _MAX_BATCH):
        b *= 2
    return b


def _record(batch: int, decision: str) -> int:
    """The decision into the metrics registry and the flight-recorder ring
    (a crash dump must show what batch size the run was using)."""
    metrics.gauge("autobatch.batch_size").set(int(batch))
    metrics.gauge("autobatch.decision").set(decision)
    flightrec.record("autobatch", batch=int(batch), decision=decision)
    return batch


def choose_batch(nsamples: int, log=None, device=None, share: float | None = None) -> int:
    """The driver's batch size for a search on ``device``; logs the
    decision path when ``log`` is a callable.  ``share`` is the task's
    share of the card (``init_data.xml``'s ``gpu_usage``; None: the whole
    card): the budget is then at most that share of the card's total
    memory, and where that is what binds the decision is ``card-share``."""
    env = os.environ.get("ERP_BATCH")
    if env:
        b = max(1, int(env))
        if log:
            log(f"Batch size {b} (ERP_BATCH override).\n")
        return _record(b, "env-override")
    budget = device_memory_budget(device)
    shared = share is not None and share < 1.0
    share_binds = False
    if shared and budget is not None:
        total = device_total_memory(device)
        if total is not None and share * total < budget:
            budget, share_binds = int(share * total), True
    if budget is not None:
        metrics.gauge("card.budget_bytes").set(int(budget))
    fit = model_batch(nsamples, budget)
    sweep_art = _sweep_best_batch()
    if sweep_art is not None:
        swept, sweep_kind, sweep_n = sweep_art
        # a rung that ran in the sweep proved it fits on the card kind it
        # ran on, at the size it swept, with the whole card to itself;
        # anything less proven, or a task sharing the card, is held to the
        # memory model, and a sweep of another card kind is refused
        kind = _current_device_kind(device)
        mismatch = sweep_kind is not None and kind is not None and sweep_kind != kind
        proven = (not shared and sweep_kind is not None and kind == sweep_kind
                  and sweep_n is not None and sweep_n == int(nsamples))
        if not mismatch and (proven or budget is None or swept <= fit):
            if log:
                log(
                    f"Batch size {swept} (measured sweep"
                    + (f" on this device kind [{sweep_kind}] at nsamples={sweep_n}" if proven else "")
                    + ").\n"
                )
            return _record(swept, "sweep-proven" if proven else "sweep-model-gated")
        if log:
            log(
                f"Sweep batch {swept} ignored (taken on "
                f"{sweep_kind or 'unknown device'} at nsamples="
                f"{sweep_n or 'unknown'}, this is {kind or 'unknown'} at "
                f"nsamples={nsamples}"
                + (f" with a card share of {share:g}" if shared else "")
                + f"; model fit {fit}).\n"
            )
    if log:
        budget_s = f"{budget / 1e9:.1f} GB" if budget else "unknown"
        share_s = f", card share {share:g}" if share_binds else ""
        log(f"Batch size {fit} (memory model, HBM budget {budget_s}{share_s}).\n")
    return _record(fit, "card-share" if share_binds else "memory-model")


def sweep(ts, bank_P, bank_tau, bank_psi0, geom, batches=SWEEP_BATCHES, runs: int = 2, path: str | None = None) -> dict:
    """Time the search loop (``models/search.py::run_bank`` over the whole
    bank) at each batch size, ``runs`` times each after one warm-up run,
    and write the artifact :func:`choose_batch` reads (to ``path``, else
    the default path).  Each rung records its loop times, the bank's
    templates/s, the batch slots searched a second (padding included) and
    the allocator's peak.  ``best_batch`` is the rung with the most slots
    a second: the throughput of a bank much larger than the batch, as a
    production bank is, where the last batch's padding does not count.
    A rung that fails (out of memory) is recorded and ends the ladder.
    Returns the artifact."""
    import torch

    from ..models.search import run_bank

    dev = ts.device
    on_card = dev.type == "cuda"
    n = len(bank_P)
    rungs, best = [], None
    for batch in batches:
        rung: dict = {"batch": int(batch)}
        try:
            # recover=False: an out-of-memory rung must fail, not halve
            run_bank(ts, bank_P, bank_tau, bank_psi0, geom, batch_size=batch, recover=False)  # warm-up
            if on_card:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            walls = []
            for _ in range(runs):
                t0 = time.perf_counter()
                M, _T = run_bank(ts, bank_P, bank_tau, bank_psi0, geom, batch_size=batch, recover=False)
                if on_card:
                    torch.cuda.synchronize(dev)
                walls.append(time.perf_counter() - t0)
            rung["loop_s"] = walls
            rung["templates_per_sec"] = n / min(walls)
            rung["slots_per_sec"] = -(-n // batch) * batch / min(walls)
            rung["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) if on_card else None
            del M, _T
        except Exception as e:  # out of memory: record it and stop the ladder
            rung["error"] = f"{type(e).__name__}: {e}"[:300]
            rungs.append(rung)
            break
        rungs.append(rung)
        if best is None or rung["slots_per_sec"] > best[1]:
            best = (int(batch), rung["slots_per_sec"])
    art = {
        "schema": SWEEP_SCHEMA,
        "what": "search loop (run_bank over the whole bank) at each batch size",
        "device_kind": _current_device_kind(dev),
        "nsamples": int(geom.nsamples),
        "n_templates": n,
        "runs": runs,
        "rungs": rungs,
        "best_batch": best[0] if best else None,
        "generated_unix": time.time(),
    }
    out = path or default_sweep_path()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(art, f, indent=1)
    os.replace(tmp, out)
    return art
