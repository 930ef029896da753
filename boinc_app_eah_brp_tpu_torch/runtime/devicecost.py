"""Device-cost observatory: the stage registry, the kernel -> stage map
and the estimated device lane.

Counterpart of the reference package's ``runtime/devicecost.py``.  There,
every stage wraps its ops in a ``jax.named_scope`` so XLA's op metadata
carries the stage into the optimized HLO; here a stage is a
``torch.profiler.record_function("erp.<stage>")`` range (plus the NVTX
range ``profiling.annotate`` makes), so a ``torch.profiler`` trace and an
NVTX timeline show which stage each CUDA kernel ran under, and the
kernels of ``csrc/`` and cuFFT map to stages by name
(:func:`stage_of_kernel`).

Design rules (same contract as ``metrics`` / ``tracing``):

* **Zero numeric effect.**  A scope only names a range; the ops, shapes
  and dtypes under it are untouched, and it adds no kernel build and no
  cuFFT plan (``tests/test_torch_devicecost.py``).
* **No torch import at module import.**  The registry, the kernel map and
  the estimated lane are plain Python; :func:`stage_scope` imports torch
  on first use inside code that already runs torch.

Not carried over: ``decode_profile_planes``/``parse_plane_dicts`` and
``stage_of_op_name`` (the xplane protos of ``jax.profiler`` and XLA's op
metadata; the port reads ``torch.profiler``'s Chrome trace and maps
kernels by name instead).  Left for the port's twins of the tools that
read them: ``ledger_stage`` and the profiler's measured records
(``ProfilerRecords``/``collect_profiler_device_records``; the port's
``steptime.device_records_from_chrome`` reads the ``torch.profiler``
trace meanwhile) and the validators of the XLA tool artifacts
(``validate_hlo_attrib``, ``validate_cost_ledger``).
"""

from __future__ import annotations

SCOPE_PREFIX = "erp."

# The single stage registry: scope name (without prefix) -> the stage
# bucket its cost lands in, in pipeline order.  The first thirteen are the
# reference package's; the last three name the port's kernels that have
# no scope of their own there (the exact mean was a host pass; the fold
# and the rfft ran inside the sumspec and fft scopes).
STAGES: dict[str, str] = {
    "unpack": "unpack",  # io/workunit.py 4-bit nibble split (host)
    "resample": "resample",  # ops/resample.py, kernel A
    "fftprep": "resample",  # ops/resample.py, kernel B
    "fft": "fft+power",  # torch.fft (cuFFT)
    "power": "fft+power",  # ops/spectrum.py |X|^2 epilogue
    "whiten": "whiten",  # ops/whiten.py scale/zap/edge device ops
    "median": "whiten",  # ops/native_median.py host running median
    "harmonic": "harmonic-sum",  # ops/harmonic.py plain fold
    "sumspec": "harmonic-sum",  # ops/harmonic.py, kernel C
    "bank-slice": "bank-slice",  # models/search.py bank slicing
    "merge": "merge",  # (M, T) max/argmax/where fold
    "allreduce": "merge",  # the sharded max-merge (parallel/sharded_search.py)
    "health": "health",  # models/search.py batch_health_vec
    "serial_mean": "resample",  # the exact mean, csrc/resample.cu
    "fold": "harmonic-sum",  # kernel C's CUDA kernel
    "rfft": "fft+power",  # cuFFT's kernels
}

# the kernel -> stage map: a substring of a kernel's name -> its stage,
# first match wins (``fftprep_kernel`` before cuFFT's ``*fft*`` kernels)
KERNEL_STAGES = (
    ("exact_mean_kernel", "serial_mean"),
    ("stream_kernel", "resample"),
    ("stats_kernel", "resample"),
    ("fftprep_kernel", "fftprep"),
    ("fold_kernel", "fold"),
    ("fft", "rfft"),
)

def scope_name(stage: str) -> str:
    """The full scope string for a registered stage."""
    if stage not in STAGES:
        raise KeyError(
            f"unregistered device-cost stage {stage!r}; add it to "
            "runtime/devicecost.py::STAGES"
        )
    return SCOPE_PREFIX + stage


def stage_scope(stage: str):
    """A ``torch.profiler.record_function`` range (and an NVTX range) named
    ``erp.<stage>`` around the ops of one stage.  Raises KeyError for
    names not in :data:`STAGES`: attribution silently losing a stage to a
    typo would defeat the registry."""
    name = scope_name(stage)  # validate before importing torch
    from . import profiling

    return profiling.annotate(name)


def scoped(stage: str):
    """Decorator form of :func:`stage_scope` for a function that is one
    stage end to end."""
    name = scope_name(stage)

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            from . import profiling

            with profiling.annotate(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def stage_of_kernel(name) -> str | None:
    """The stage a CUDA kernel belongs to: the kernels of ``csrc/`` by
    their symbols, cuFFT's by their names (``regular_fft``,
    ``vector_fft``, ...); None for anything else (the merge's elementwise
    kernels, copies)."""
    if not isinstance(name, str):
        return None
    for key, stage in KERNEL_STAGES:
        if key in name:
            return stage
    return None


# ---------------------------------------------------------------------------
# the estimated device lane (runs off the card)


def stage_time_model(
    nsamples: int,
    n_unpadded: int,
    fund_hi: int,
    harm_hi: int,
    batch: int = 32,
    card: str | None = None,
) -> list[dict]:
    """The roofline's least device time of each stage of one batch
    (``runtime/roofline.py``): ``[{stage, scope, t_ms, fraction, bound},
    ...]`` in pipeline order, the fractions splitting a dispatch window's
    device time across stages.  Raises ``ValueError`` for a card the
    roofline does not model."""
    from .roofline import CARDS, card_name, peaks_key, pipeline_costs

    card = card or card_name()
    key = peaks_key(card)
    if key is None:
        raise ValueError(f"no roofline rates for {card!r}")
    peaks = CARDS[key]
    rows = []
    for c in pipeline_costs(nsamples, n_unpadded, fund_hi, harm_hi, batch):
        b = c.bound(peaks)
        rows.append({"stage": c.name, "scope": c.scope, "t_ms": c.t_ms(peaks), "bound": b["limit"]})
    total = sum(r["t_ms"] for r in rows)
    for r in rows:
        r["fraction"] = r["t_ms"] / total if total > 0 else 0.0
    return rows


def estimate_device_records(
    windows: list[tuple],
    model: list[dict],
    lane: str = "device:estimated",
) -> list[dict]:
    """Synthesized device-lane span records for ``tracing``'s Chrome
    export: each ``(ctx, ts_us, end_us)`` dispatch window is filled with
    one span per stage, widths proportional to the fractions in ``model``
    (:func:`stage_time_model`).  Every span carries ``estimated: True``
    and the lane says so, so a trace reader cannot mistake it for a
    measured profile."""
    records = []
    for ctx, ts_us, end_us in windows:
        span = max(0.0, float(end_us) - float(ts_us))
        if span <= 0.0:
            continue
        t = float(ts_us)
        for row in model:
            dur = round(span * row["fraction"], 1)
            if dur < 0.1:  # sub-us stage: a 0-width B/E pair helps nobody
                continue
            records.append(
                {
                    "name": SCOPE_PREFIX + row["scope"],
                    "tid": lane,
                    "ctx": ctx,
                    "ts_us": round(t, 1),
                    "dur_us": dur,
                    "end_us": round(t + dur, 1),
                    "args": {"estimated": True, "bound": row["bound"]},
                }
            )
            t += dur
    return records


def dispatch_windows(spans: list[dict]) -> list[tuple]:
    """(ctx, ts_us, end_us) device-occupancy windows from a host span
    list: each dispatch span opens its window, the next drain span (or the
    next dispatch, when the stream keeps the device busy) closes it."""
    timeline = sorted(
        (s for s in spans if s.get("name") in ("dispatch", "drain")),
        key=lambda s: s.get("ts_us", 0.0),
    )
    out = []
    open_win = None  # (ctx, start_us)
    for s in timeline:
        if s.get("name") == "dispatch":
            if open_win is not None:
                out.append((open_win[0], open_win[1], s.get("ts_us", 0.0)))
            open_win = (s.get("ctx"), s.get("ts_us", 0.0))
        else:  # drain: the device caught up; close the open window
            if open_win is not None:
                out.append((open_win[0], open_win[1], s.get("end_us", s.get("ts_us", 0.0))))
                open_win = None
    if open_win is not None:
        last = max((s.get("end_us", 0.0) for s in timeline), default=0.0)
        if last > open_win[1]:
            out.append((open_win[0], open_win[1], last))
    return [(c, a, b) for c, a, b in out if b > a]


def emit_estimated_timeline(geom, batch_size: int) -> int:
    """Derive dispatch windows from the live trace ring, split them by the
    roofline stage model, and register the synthesized device lane with
    ``tracing`` for the Chrome export.  Returns the number of records
    added (0 when tracing is off or no window exists).  The Session calls
    it after a search that ran on the CPU; on the card the profiler's
    measured records take this lane's place."""
    from . import tracing

    if not tracing.enabled():
        return 0
    spans = [r for r in tracing.events() if r.get("kind") == "span"]
    windows = dispatch_windows(spans)
    if not windows:
        return 0
    # the search ran on the CPU, whatever card this process may also hold
    model = stage_time_model(geom.nsamples, geom.n_unpadded, geom.fund_hi, geom.harm_hi, batch_size, card="cpu")
    records = estimate_device_records(windows, model)
    tracing.add_device_records(records)
    return len(records)
