"""Byte and instruction accounting, and the roofline model, of the port's
search on an NVIDIA H100.

Counterpart of the reference package's ``runtime/roofline.py``, which
models the TPU's MXU matmul cascade; here the model is of the port's own
pipeline, one batch of ``batch`` templates at a time:

* kernel A (``csrc/resample.cu``) with its statistics (n_steps, mean),
  with the LUT sine or, with ``exact_sin`` (``--exact-sin``), CUDA's
  ``sinf``;
* kernel B (``csrc/fftprep.cu``), the mean-padded interleaved series;
* the rfft (cuFFT) at one pass: the real input read once, the complex
  output written once (cuFFT's own passes at this size are not modelled);
* kernel C (``csrc/fold.cu``) on the complex spectrum, with the |X|^2/N
  epilogue inside it (``fold_spectrum``), or on float power (``fold``);
* the max/argmax merge into (M, T);
* per ``run_bank`` call on unwhitened runs, the exact mean of every
  template (``erp_exact_mean``), with its chain of dependent float32 adds.

Each stage's least time is the largest of its bytes at the card's memory
rate, its float32 instructions and its conversions at their issue rates,
and for the exact mean the chain of its longest template's adds, one
after another.  Bytes count each input read once and each output written
once.  The counts are the ones ``chip_smoke.py`` prints in its ``bounds``
line, which it takes from this module.

Not carried over from the reference package: the TPU-generation
``projection`` (the port runs on one card kind) and
``compiler_bound_templates_per_sec``, which reads XLA's
``COST_LEDGER.json`` (there is no compiler ledger behind eager PyTorch
and hand-written kernels).  There is no ``mfu``: the port runs no
tensor-core work.

Import-light: no torch at import; :func:`card_name` reads torch only
where the caller already initialised CUDA.
"""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass

F32 = 4  # bytes
C64 = 8


@dataclass(frozen=True)
class Peaks:
    """One card's rates: memory bytes/s, float32 instructions/s outside
    the tensor cores, float<->int conversions/s, and the latency of one
    dependent float32 add (s)."""

    bytes_s: float
    f32_instr_s: float
    cvt_s: float
    add_latency_s: float


# H100 SXM: HBM bandwidth (NVIDIA data sheet); float32 instructions at
# 132 SMs x 128 lanes x 1.98 GHz (the data sheet's 67 TFLOP/s counts a
# fused multiply-add as two, and every kernel here is built with
# -fmad=false, so each multiply and add is one instruction); conversions
# at 16 a clock per SM (CUDA Programming Guide, arithmetic instruction
# throughput, compute capability 9.0); a dependent add every 4 cycles.
# "cpu" is a placeholder so a run off the card still gets a labelled
# model, as in the reference package.
CARDS = {
    "h100": Peaks(3.35e12, 132 * 128 * 1.98e9, 132 * 16 * 1.98e9, 4 / 1.98e9),
    "cpu": Peaks(50e9, 1e11, 1e10, 1e-9),
}

# kernel A's float32 instructions a sample, counted from csrc/resample.cu's
# interior path: the phase and LUT argument 6, the LUT index by the 2^23
# add 2, the Taylor sine 9, del_t 3, the nearest index 3, the add into its
# lane's sum 1; it has no conversions there (one a lane per run of 8)
RESAMPLE_F32_PER_SAMPLE = 24
# the exact-sine instantiation: the LUT argument (3), the LUT index (2) and
# the Taylor sine (9) give way to CUDA's sinf, whose fast path (libdevice's
# Cody-Waite reduction in three parts and the sine/cosine minimax pair,
# both polynomials evaluated and one selected) is 2 multiplies, 9 fused
# multiply-adds and ~7 compares and selects a sample, counted at the
# float32 rate, and 2 conversions (the quadrant's round to int and back);
# counted from the algorithm's steps, not from the compiled code
SINF_F32 = 18
SINF_CONVERSIONS = 2
RESAMPLE_EXACT_F32_PER_SAMPLE = RESAMPLE_F32_PER_SAMPLE - 3 - 2 - 9 + SINF_F32
# above |phase| > SINF_SLOW_PHASE sinf reduces by Payne-Hanek: 2/pi in six
# 32-bit words, a wide integer product and add a word, the normalisation
# and the conversion back: ~50 instructions more a sample (estimated from
# the same algorithm's steps)
SINF_SLOW_PHASE = 105615.0
SINF_SLOW_F32 = 50
# kernel C, per output column: 15 multipliers x 16 rows of adds, 16 masks,
# ~31 maxima; the complex entry adds 3 multiplies and an add a bin read
FOLD_F32_PER_COLUMN = 15 * 16 + 16 + 31
POWER_F32_PER_BIN = 4


def card_name() -> str:
    """``torch.cuda.get_device_name`` of the current card where this
    process already initialised CUDA, else ``"cpu"``."""
    torch = sys.modules.get("torch")
    try:
        if torch is not None and torch.cuda.is_initialized():
            return torch.cuda.get_device_name(torch.cuda.current_device())
    except Exception:
        pass
    return "cpu"


def peaks_key(name: str) -> str | None:
    """The :data:`CARDS` row of a card name: ``h100`` for an H100, ``cpu``
    for the ``"cpu"`` label of a run off the card, and None for any other
    card, whose rates are not modelled."""
    if "h100" in name.lower():
        return "h100"
    return "cpu" if name == "cpu" else None


def state_width(fund_hi: int) -> int:
    """Row width W of the phase-major (5, W) state (``ops/harmonic.py``)."""
    return max(n_ph * -(-fund_hi // n_ph) for n_ph in (1, 8, 4, 2, 1))


def _fold_read(L: int, W: int) -> int:
    """Spectrum prefix the fold of W columns reads (``ops/harmonic.py``)."""
    return min(L, 16 * W + 16)


@dataclass(frozen=True)
class StageCost:
    """One stage's work: ``name`` (its kernel-table name), ``scope`` (its
    ``runtime/devicecost.py`` stage), bytes moved, float32 instructions,
    conversions and, for a serial chain, its dependent adds; ``per`` is
    ``"batch"`` or ``"run"`` (once a ``run_bank`` call)."""

    name: str
    scope: str
    bytes: float
    f32_instr: float = 0.0
    conversions: float = 0.0
    chain_adds: float = 0.0
    per: str = "batch"

    def bound(self, peaks: Peaks = CARDS["h100"]) -> dict:
        """The least time, ms: the largest of bytes, float32 instructions
        and conversions at their rates (``bound_by`` "bytes" or
        "operations", ``limit`` which of the three), and the chain of
        dependent adds where there is one (``limit`` "chain" where it is
        the longest)."""
        t = {
            "bytes": self.bytes / peaks.bytes_s * 1e3,
            "fp32": self.f32_instr / peaks.f32_instr_s * 1e3,
            "conversions": self.conversions / peaks.cvt_s * 1e3,
        }
        by = max(t, key=t.get)
        out = dict(
            bound_ms=t[by],
            bound_by="bytes" if by == "bytes" else "operations",
            limit=by,
            **{f"{k}_ms": v for k, v in t.items()},
        )
        if self.chain_adds:
            out["chain_ms"] = self.chain_adds * peaks.add_latency_s * 1e3
            if out["chain_ms"] > out["bound_ms"]:
                out["limit"] = "chain"
        return out

    def t_ms(self, peaks: Peaks = CARDS["h100"]) -> float:
        """The stage's least time including its chain."""
        b = self.bound(peaks)
        return max(b["bound_ms"], b.get("chain_ms", 0.0))


def sine_slow_samples(omega, psi0, n_samples: int, dt: float) -> int:
    """How many of ``n_samples`` samples of the templates ``(omega,
    psi0)`` (float sequences, omega > 0) have a phase ``omega * i * dt +
    psi0`` at or above :data:`SINF_SLOW_PHASE`, where ``sinf`` takes its
    slow reduction: what this run's data needs of it."""
    total = 0
    for om, ps in zip(omega, psi0):
        first = math.ceil((SINF_SLOW_PHASE - float(ps)) / (float(om) * float(dt)))
        total += max(0, n_samples - max(first, 0))
    return total


def resample_cost(T: int, n_unpadded: int, exact_sin: bool = False, slow_samples: int = 0) -> StageCost:
    """Kernel A at ``T`` templates: the series read once, the parameters
    read, the samples and (n_steps, mean) written; with ``exact_sin`` its
    exact-sine instantiation, ``slow_samples`` of whose samples
    (:func:`sine_slow_samples`) take sinf's slow reduction."""
    n = n_unpadded
    per = RESAMPLE_EXACT_F32_PER_SAMPLE if exact_sin else RESAMPLE_F32_PER_SAMPLE
    return StageCost(
        ("resample" if T > 1 else "resample_t1") + ("_exact" if exact_sin else ""), "resample",
        bytes=n * F32 + T * 16 + T * n * F32 + T * 8,
        f32_instr=T * n * per + (slow_samples * SINF_SLOW_F32 if exact_sin else 0),
        conversions=T * n * SINF_CONVERSIONS if exact_sin else 0,
    )


def fftprep_cost(T: int, n_unpadded: int, nsamples: int) -> StageCost:
    """Kernel B: A's samples and (n_steps, mean) read, the padded series
    written."""
    return StageCost("fftprep", "fftprep", bytes=T * n_unpadded * F32 + T * 8 + T * nsamples * F32)


def rfft_cost(T: int, nsamples: int) -> StageCost:
    """The rfft at one pass: the real input read once, the complex output
    written once."""
    return StageCost("rfft", "fft", bytes=T * nsamples * F32 + T * (nsamples // 2 + 1) * C64)


def fold_cost(T: int, nsamples: int, fund_hi: int, complex_input: bool = True) -> StageCost:
    """Kernel C: the spectrum prefix it reads (complex64 with the power
    epilogue inside, ``fold_spectrum``; or float power, ``fold``) and the
    (T, 5, W) run maxima written."""
    W = state_width(fund_hi)
    read = _fold_read(nsamples // 2 + 1, W)
    ops = T * W * FOLD_F32_PER_COLUMN
    if complex_input:
        return StageCost(
            "fold_spectrum", "sumspec",
            bytes=T * read * C64 + T * 5 * W * F32, f32_instr=ops + T * read * POWER_F32_PER_BIN,
        )
    return StageCost("fold", "sumspec", bytes=T * read * F32 + T * 5 * W * F32, f32_instr=ops)


def merge_cost(T: int, fund_hi: int) -> StageCost:
    """The merge: the (T, 5, W) sums read, (M, T) read and written; a
    maximum and a comparison a slot."""
    W = state_width(fund_hi)
    return StageCost("merge", "merge", bytes=T * 5 * W * F32 + 4 * 5 * W * F32, f32_instr=2 * T * 5 * W)


def exact_mean_cost(n_unpadded: int, n_steps, exact_sin: bool = False, slow_samples: int = 0) -> StageCost:
    """The exact mean of the templates whose kernel-A n_steps are
    ``n_steps`` (what this run's data needs): the series read once, each
    template's parameters read and (n_steps, mean) written, A's
    instructions for every sample below n_steps (its exact-sine
    instantiation's with ``exact_sin``, ``slow_samples`` of them on sinf's
    slow reduction), and the longest template's chain of dependent adds."""
    steps = [max(int(s), 0) for s in n_steps]
    per = RESAMPLE_EXACT_F32_PER_SAMPLE if exact_sin else RESAMPLE_F32_PER_SAMPLE
    return StageCost(
        "serial_mean_exact" if exact_sin else "serial_mean", "serial_mean",
        bytes=n_unpadded * F32 + len(steps) * 24,
        f32_instr=float(sum(steps)) * per + (slow_samples * SINF_SLOW_F32 if exact_sin else 0),
        conversions=float(sum(steps)) * SINF_CONVERSIONS if exact_sin else 0.0,
        chain_adds=float(max(steps, default=0)),
        per="run",
    )


def median_cost(n: int, window: int) -> StageCost:
    """The whitening's device running median (``csrc/median.cu``) over a
    spectrum of ``n`` bins: the spectrum read once and the ``n - window +
    1`` medians written.  Its work is compares and counts, no float32
    arithmetic but the midpoint, so the bound is the bytes;
    :func:`median_steps` counts the kernel's own steps beside it."""
    return StageCost("median", "median", bytes=(n + n - window + 1) * F32, per="run")


def median_steps(n: int, window: int, tile: int = 1024, run: int = 16) -> dict:
    """The median kernel's steps at this size (the model of
    ``csrc/median.cu`` on independent draws, not a count of the run), for
    tiles of ``tile`` outputs and runs of ``run`` outputs a thread (the
    shared instantiation's sizes by default; the device-memory one above
    window 15,361 takes tiles of 8,192): ``compare_exchanges``, the
    bitonic sorts of each tile's union of ``next_pow2(tile + window - 1)``
    entries; ``first_walk``, each tile's ``U = tile + window - 1`` ranks
    read to count the entries below the walk's start J, and each run's
    first output's walk from J to its central entry, ``|j - J|`` (the
    union's ``tile - 1`` entries outside the window and the window's own
    median both spread it) and about 12.5 reads of the groups of eight it
    ends in; ``slide``, the entries read moving the central entry along a
    run, ``U / (2 window)`` an output (it moves half the time, and
    in-window entries lie ``U / window`` apart), and an even window's
    upper entry, ``U / window`` an output."""
    n_out = n - window + 1
    U = tile + window - 1
    P = 1 << (U - 1).bit_length()
    levels = P.bit_length() - 1
    tiles = -(-n_out // tile)
    last = n_out - (tiles - 1) * tile
    runs = (tiles - 1) * -(-tile // run) + -(-last // run)
    spread = math.sqrt((tile - 1) / 4 * (1 + (tile - 1) / window) * 2 / math.pi)
    return dict(
        tile=tile, run=run,
        compare_exchanges=float(tiles) * (P // 2) * levels * (levels + 1) // 2,
        first_walk=float(tiles) * U + runs * (spread + 12.5),
        slide=float(n_out - runs) * U / (2 * window) + (0.0 if window % 2 else float(n_out) * U / window),
    )


def pipeline_costs(
    nsamples: int,
    n_unpadded: int,
    fund_hi: int,
    harm_hi: int,
    batch: int,
    n_steps=None,
    exact_sin: bool = False,
) -> list[StageCost]:
    """The stages of one batch of ``batch`` templates of the main path, in
    pipeline order, and with ``n_steps`` (kernel A's n_steps of every
    template of an unwhitened run) the exact mean of the run; ``exact_sin``
    takes the exact-sine instantiations (their fast path).  ``harm_hi``
    is part of the reference package's signature; the fold reads its own
    prefix of 16 W + 16 bins, which covers it."""
    if harm_hi > nsamples // 2 + 1:
        raise ValueError("harm_hi beyond the spectrum")
    T = int(batch)
    costs = [
        resample_cost(T, n_unpadded, exact_sin=exact_sin),
        fftprep_cost(T, n_unpadded, nsamples),
        rfft_cost(T, nsamples),
        fold_cost(T, nsamples, fund_hi),
        merge_cost(T, fund_hi),
    ]
    if n_steps is not None:
        costs.append(exact_mean_cost(n_unpadded, n_steps, exact_sin=exact_sin))
    return costs


def roofline_report(
    nsamples: int,
    n_unpadded: int,
    fund_hi: int,
    harm_hi: int,
    batch: int = 32,
    n_steps=None,
    measured_templates_per_sec: float | None = None,
    card: str | None = None,
    exact_sin: bool = False,
) -> dict:
    """The model as a JSON-serialisable dict: each stage's bytes,
    instructions and least time, the attainable templates/s (a batch's
    stages summed; with ``n_steps`` the exact mean spread over its
    templates) and the binding stage.  Given a measured rate it adds
    ``hbm_utilization`` (the model's bytes at that rate over the memory
    rate) and ``fraction_of_attainable``.

    A card other than an H100 is not modelled: its report has
    ``"peaks": None``, no stages and no attainable rate, rather than
    another card's rates under its name."""
    card = card or card_name()
    key = peaks_key(card)
    if key is None:
        out = {"card": card, "peaks": None, "batch": int(batch), "stages": [],
               "attainable_templates_per_sec": None, "model_bound": "unmodelled"}
        if measured_templates_per_sec:
            out["measured_templates_per_sec"] = float(measured_templates_per_sec)
        return out
    peaks = CARDS[key]
    costs = pipeline_costs(nsamples, n_unpadded, fund_hi, harm_hi, batch, n_steps=n_steps, exact_sin=exact_sin)
    stages = []
    for c in costs:
        b = c.bound(peaks)
        stages.append(
            {
                "stage": c.name,
                "scope": c.scope,
                "per": c.per,
                "mbytes": c.bytes / 1e6,
                "f32_ginstr": c.f32_instr / 1e9,
                "t_ms": c.t_ms(peaks),
                **b,
            }
        )
    t_batch = sum(c.t_ms(peaks) for c in costs if c.per == "batch") / 1e3
    bytes_batch = sum(c.bytes for c in costs if c.per == "batch")
    n_run = len(n_steps) if n_steps is not None else 0
    t_run = sum(c.t_ms(peaks) for c in costs if c.per == "run") / 1e3
    bytes_run = sum(c.bytes for c in costs if c.per == "run")
    # per template: a batch's share, plus the run's stages spread over
    # the run's templates
    t_tpl = t_batch / batch + (t_run / n_run if n_run else 0.0)
    bytes_tpl = bytes_batch / batch + (bytes_run / n_run if n_run else 0.0)
    attainable = 1.0 / t_tpl if t_tpl > 0 else None
    out = {
        "card": card,
        "peaks": key,
        "hbm_gbytes_per_s": peaks.bytes_s / 1e9,
        "f32_tinstr_per_s": peaks.f32_instr_s / 1e12,
        "batch": int(batch),
        "stages": stages,
        "attainable_templates_per_sec": attainable,
        "model_bound": max(stages, key=lambda s: s["t_ms"] if s["per"] == "batch" else -1.0)["stage"],
    }
    if measured_templates_per_sec:
        r = float(measured_templates_per_sec)
        out["measured_templates_per_sec"] = r
        out["hbm_utilization"] = r * bytes_tpl / peaks.bytes_s
        out["fraction_of_attainable"] = r / attainable if attainable else None
        # far below the model bound, the gap is neither bytes nor
        # instructions: launch gaps, host work, or a stage's passes
        out["bound"] = (
            out["model_bound"]
            if attainable and r > 0.5 * attainable
            else "overhead (measured < 50% of model bound)"
        )
    return out
