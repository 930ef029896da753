#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and measure its kernels.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases:
1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``boinc_app_eah_brp_tpu_torch/csrc``;
3. hold each kernel against its plain version on the card at the
   production width (a 2^22-sample workunit at 65.476 us, padding 3,
   f0 400 Hz, a batch of 32 templates of ``tests/golden/bank200.txt``):
   the resampler with its statistics (gathered samples, n_steps and mean,
   at 32 templates and in its single-template launch), FFT-prep, the fold
   of float power and the fold of the complex spectrum must agree bitwise;
   the exact (serial) mean of the unwhitened workunit, all 200 templates
   in one launch, must agree bitwise with the host oracle, give kernel A's
   n_steps, give the serial mean of A's samples of one batch, and give the
   same results for the bank tiled TILE times; each is timed beside its
   plain version and its bound (bytes, float32 instructions and
   conversions, each at its own rate; for the exact mean also its chain
   of dependent adds, and its time at the tiled bank), and a copy of the
   first port's eager statistics, the rfft (``csrc/rfft.cu``, held to
   1e-5 of max |F| against cuFFT's, which is timed beside it as its
   library yardstick, against its plain version, and, template by
   template at each sector phase of F, against the float64 transform
   with cuFFT's distance beside it), the rfft with its power pass
   (``search_power``: bitwise the power of the complex pass's spectrum,
   timed at 32 templates and, beside the complex pass and both fold
   entries, at 128), the eager power epilogue and a
   whole batch step, whitened and unwhitened (its means computed ahead),
   are timed alone, and the merge into (M, T) and the device and host
   running medians over one spectrum (the stages of
   ``tools/stagebench.py``);
4. run the search end to end through the command line on a seeded
   synthetic 4-bit workunit with a binary-pulsar signal injected at one
   bank template, whitened, with a checkpoint file and oracle rescoring,
   with the kernel launch counts reset just before, and check the
   candidate file and that every kernel of the main path ran, the
   whitening's device median once and the R2C kernel once a batch, with
   no cuFFT plan of a batch's R2C; then time
   its stages alone (rescoring and the checkpoint write among them);
5. the same workunit unwhitened (the JAX driver's default), counts reset
   just before: the injected template must be among the candidates and
   the exact mean must have run once, ahead of the main path's kernels;
   then the same run quit after 3 batches and resumed must give the same
   candidate rows, each of the two runs launching the exact mean once;
6. the default command line (a): the same workunit unwhitened with no
   ``--batch``, with ``--metrics-file``, ``ERP_TRACE_FILE`` and
   ``--profile-dir``, counts reset just before: the batch must be chosen
   and logged by ``runtime/autobatch.py``, the run report must validate,
   the candidate rows must equal phase 5's, and the main path's kernels
   must have run; prints the batch, the loop's templates/s and device
   idle share on the card's clock (first to last kernel of the profile)
   and the peak memory;
7. the batch sweep (b): the whitened search loop at batches 8 to 128, two
   runs each with its peak memory, written to the artifact phase (a)
   reads on the next run; then the loop at batch 32 with the metrics and
   the host tracer off and on, in turns;
8. the out-of-memory ladder (c), against a whitened ``--no-rescore``
   baseline at batch 32: a batch this card cannot hold (2048) and an
   injected ``dispatch:oom@n=2`` must both finish with
   ``resilience.batch_halved`` >= 1 and the baseline's rows;
9. a supervised restart (d): ``--supervised 2`` with
   ``dispatch:hang@n=3``, a short dispatch deadline and a checkpoint
   every batch must exit 0 after one restart with the baseline's rows,
   and its incident log must validate;
10. serving (e): one resident ``FleetServer`` warmed for the unwhitened
   class at ``--batch 32`` serves phase 5's workunit, a missing input
   file, a second workunit with another injected template, and phase 5's
   workunit again, counts reset just before and read per workunit: every
   good workunit must run with no kernel build and no new cuFFT plan, hit
   the one step cache entry, launch kernels A, B, C and the exact mean,
   and give device memory back to the post-warm value within 64 MB; the
   copies of phase 5's workunit must give phase 5's rows, the other its
   injected template in the top 5, the missing file RADPUL_EIO;
11. health and precision (f): (1) phase 5's command line with
   ``ERP_HEALTH_EVERY=32`` and a checkpoint every batch, counts reset just
   before: rows equal to phase 5's, batch checks >= 1, no violation, a
   sentinel probe at every checkpoint within ``ERP_HEALTH_TOL`` of the
   oracle, kernel A's single-template launch counted; the batch step and
   the loop with health on against off, in turns, and the step's peak
   memory; (2) the same with a NaN-poisoned fold under
   ``ERP_HEALTH_ACTION=abort``: exit 4 (RADPUL_EVAL) and a black-box dump
   holding the violation; (3) the precision audit with the port's kernels
   as its taps, on the CI fixture (gated on ``PRECISION_BASELINE.json``)
   and at 2^20 samples: per-stage errors against the f64 oracle, recall,
   the tap proof, counts reset just before (kernel C's float-power entry
   is the harmonic-sum tap); (4) the roofline model's report with the
   whitened loop's fraction of its attainable rate;
12. the exact sine and ``parallel/`` (g): (1) the exact-sine
   instantiations of kernel A (T = 32 and 1) and of the exact mean against
   their plain versions (bitwise expected; else the differing samples are
   counted and held to the CPU tests' tie rule), timed beside the LUT
   launches with their bounds, on bank200 and on a bank of orbits of
   4-15 ms (sinf's slow reduction); phase 5's command line with
   ``--exact-sin`` and the health checks (so A1 runs in the sentinel
   probe), counts reset just before: the injected template's rank and how
   many rows differ from phase 5's; (2) ``run_bank_sharded`` over one and
   over SHARDS shards on cuda:0, whitened and unwhitened, bitwise
   ``run_bank``'s, with each loop's templates/s; ``--mesh 1`` gives phase
   5's rows and ``--mesh 2`` RADPUL_EVAL; (3) N_HOSTS processes of one
   elastic search on the card, one SIGKILLed after its first shard commit:
   the survivors adopt its shard, one writes phase 5's rows;
13. the fabric and crash-resume (h): (1) a ``fabric.ServerBackend`` on
   the card, warmed for the unwhitened class at ``--batch 32``, computes
   the volunteer fabric's two references, phase 5's workunit and phase
   (e)'s second one, counts reset just before: their rows must be phase
   5's and phase (e)'s, with no build and no plan after warm-up and A, B,
   C and the exact mean launched; then one ``Fabric`` runs 32 volunteer
   streams with every adversary kind over 16 workunits, with result
   corruption and validator crashes armed, held to every gate of
   ``tools/fabric_soak.py`` (all granted, byte-identical to the
   references, no lie credited, every liar caught, the replica overhead
   and ``FLEET_BASELINE.json``'s SLOs, every verdict and report
   validated); (2) ``tools/chaos_soak.py``'s kill/resume soak on phase
   5's workunit at ``--batch 4``: four SIGKILL/SIGTERM cycles with
   checkpoint-write EIO armed, a corrupted checkpoint that the resume
   must skip for the generation before, and a final file byte-identical
   to the uninterrupted run's;
14. the port's bench, the production problem and the bundle (i): (1)
   ``python -m boinc_app_eah_brp_tpu_torch.tools.bench`` through its
   orchestrator (probe, child) at the autobatch's batch and at
   ``BENCH_BATCH=32``: one JSON line each, backend ``cuda``, a rate above
   0 and the card's name; (2) the bench's problem (the seeded 2^22-sample
   workunit and 6,662-template bank) written to disk and run by the
   command line in a subprocess at the default batch, whitened and then
   unwhitened, with ``--metrics-file`` and ``ERP_TRACE_FILE``: ``%DONE%``,
   7 columns, at most 100 candidates, every winner's spectrum taken on
   the card (the run report's ``rescore.device_ffts`` equals its
   ``rescore.templates``); the wall, the loop's templates/s (from the
   trace) and the end-of-run pass's time (the run report); (3) ``tools/make_bundle.py`` into a directory
   outside the repository, and the bundle's ``erp_wrapper`` running
   ``python3 eah_brp_worker.pyz`` there with no ``PYTHONPATH`` on phase
   4's whitened command line: phase 4's candidate rows byte for byte, no
   kernel built in the worker (its run report's ``torch.kernel_builds``
   0), kernels A, B and C launched, the whitening's median the bundle's
   kernel (launched once, one ``whiten.device_medians``); then the same
   run under ``ERP_MEDIAN=native``: phase 4's rows byte for byte, the
   median the bundle's ``liberp_rngmed.so``, no median launch;
15. the port's last tools (j): (1) ``tools/smoke.py``'s default gate on
   phase 4's workunit and bank200 at the production width (unwhitened,
   window 1000, batch 32) on the card, every check green (exit 0, the
   artifacts' schemas, >= 95% of the wall in named spans, the checkpoint
   audit, health checks every batch with no violation, no black box, the
   precision artifacts) and A, B, C and the exact mean launched (its run
   report); (2) ``tools/step_report.py`` on the same problem, counts
   reset just before, inside ``torch.profiler``: ``device_lane``
   "measured", each stage's measured ms beside phase 3's, the rfft
   stage's kernels with their launches and ms a window; (3) the
   readers through their command lines: ``metrics_report`` renders and
   diffs (i2)'s run reports, ``blackbox_report --check`` (f)'s dump,
   ``fleet_timeline --check --min-coverage 0.95 --require-adoption`` the
   elastic run of (g3) (each process traced), ``bench_history`` (i1)'s
   bench lines and (2)'s report; (4) ``tools/smoke.py --hosts 2`` and
   ``--fabric`` on the card at the smoke's fixture size, A, B, C and the
   exact mean launched (the hosts' and the fabric reference's run
   reports);
16. the operator knobs (k), in-process on phase 4's whitened command line
   with the metrics report and the host trace, counts reset just before
   each run: (1) ``ERP_RESCORE=off`` reaches ``%DONE%`` with no
   rescoring span, no ``oracle rescore`` phase, the ``rescore.*``
   counters 0, and rows equal to phase 4's unrescored toplist; (2)
   ``ERP_PRECISION=bf16`` (``RADPUL_EMISC``, as the JAX package's
   command line exits) and ``ERP_PRECISION=xx`` (``RADPUL_EVAL``), each
   with cuFFT's plan cache emptied first, launch no kernel, make no plan
   and write no result; each wall beside phase 4's;
17. the golden diff (l), which reads phase 4's and (k1)'s files and runs
   no search: (1) the sha256 of phase 4's workunit (its decompressed
   content), bank and zaplist equal ``tests/golden/jax_synth200.json``'s,
   the inputs the JAX package's command line searched on the CPU to
   write ``jax_synth200.cand`` and ``.cpt`` (``tests/torch_golden_make.py``);
   (2) ``tools/golden_ref.py::compare`` of that file against phase 4's:
   ``ok``, 0 mismatches, 0 missing, 0 extra, and the injected template's
   top row matched; (3) ``tools/boundary_analysis.py::analyse`` of the
   same pair with both checkpoints: every boundary row ``cap-cutoff`` or
   ``dedup``, counted by cause; (4) ``analyse`` of phase 4's file against
   (k1)'s unrescored one, each row that differs with its cause (a row of
   both files whose values moved is ``rescored``): no ``threshold``.  A
   missing golden file or a differing digest fails the phase;
18. the device running median (m) on phase 4's workunit
   (``ops/median.py``, ``csrc/median.cu``): (1) the kernel bitwise
   against its plain version over phase 4's spectrum at windows 1000 and
   999 and at a window above one block's shared memory over its first
   bins, each timed beside its plain version (and at 1000 and 999 beside
   the kernel's step model), and ``torch.median`` of
   every odd window as the yardstick; (2) its outputs against the native
   rngmed's: none may differ; (3) phase 4's command line under
   ``ERP_MEDIAN=native`` (the host median once, no median launch) and
   with the knob unset and ``$ERP_RNGMED_LIB`` naming a missing file (the
   median launched once, no host median), counts reset just before each,
   each file held against phase 4's by ``tools/golden_ref.py``'s compare
   (``ok``) and its rows byte for byte; (4)
   ``ERP_MEDIAN=native`` with the missing file exits ``RADPUL_EVAL`` with
   no launch, no cuFFT plan and no result;
19. print the kernel table as one JSON line (launches from the whitened
   run; the serial mean's from the unwhitened one, A1's from the health
   run, the exact-sine ones from
   the ``--exact-sin`` run), the `bounds` line of the package's roofline
   model (``runtime/roofline.py``), the runs' numbers, and last
   ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero; so does a machine without a CUDA card.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BANK = os.path.join(REPO, "tests", "golden", "bank200.txt")
N_UNPADDED = 1 << 22
TSAMPLE_US = 65.476
PADDING = 3.0
F0 = 400.0
FA = 0.08
WINDOW = 1000
BATCH = 32
INJECT2 = 131  # the serving phase's second workunit follows this row
sys.path.insert(0, REPO)
try:
    # the production workunit's one definition (bank200 row INJECT's orbit
    # from SEED, zapped with ZAPLIST), which tests/golden/jax_synth200.* was
    # made from; main reports a missing package
    from boinc_app_eah_brp_tpu_torch.tools._inputs import INJECT, SEED, ZAPLIST
except ImportError:
    INJECT = SEED = ZAPLIST = None
DEVICE = "cuda"

KERNEL_ROWS = {
    "resample": ("boinc_app_eah_brp_tpu/ops/pallas_resample.py:352", "resample.cu"),
    "resample_t1": ("boinc_app_eah_brp_tpu/ops/pallas_resample.py:322", "resample.cu"),
    "fftprep": ("boinc_app_eah_brp_tpu/ops/pallas_resample.py:772", "fftprep.cu"),
    "fold": ("boinc_app_eah_brp_tpu/ops/pallas_sumspec.py:126", "fold.cu"),
    "fold_spectrum": ("boinc_app_eah_brp_tpu/ops/pallas_sumspec.py:126", "fold.cu"),
    # no Pallas kernel: the JAX package's host pass host_exact_mean_params
    "serial_mean": ("boinc_app_eah_brp_tpu/models/search.py:413", "resample.cu"),
    # the exact-sine instantiations (--exact-sin): XLA's jnp.sin branch of
    # _del_t and the host pass's np.sin branch, no Pallas kernel either
    "resample_exact": ("boinc_app_eah_brp_tpu/ops/resample.py:48", "resample.cu"),
    "resample_t1_exact": ("boinc_app_eah_brp_tpu/ops/resample.py:48", "resample.cu"),
    "serial_mean_exact": ("boinc_app_eah_brp_tpu/models/search.py:442", "resample.cu"),
    # no Pallas kernel: the JAX package's device running median, a blocked
    # sort that XLA runs
    "median": ("boinc_app_eah_brp_tpu/ops/median.py:57", "median.cu"),
    # no Pallas kernel: the JAX package's rfft_packed_split, matrix products
    # that XLA runs; with its power pass, also the |X|^2/N epilogue of C's
    # producer _deinterleave
    "fft_r2c": ("boinc_app_eah_brp_tpu/ops/fft.py:268", "rfft.cu"),
    "fft_r2c_power": ("boinc_app_eah_brp_tpu/ops/fft.py:268 + ops/pallas_sumspec.py:96", "rfft.cu"),
}
# the kernels the search's loop launches at the production length; the
# whitened command line (the main path) launches these and the median, the
# unwhitened one these and the serial mean
# (the rfft's second pass writes the fold's power, C takes its float entry)
SEARCH_PATH = ("resample", "fftprep", "fft_r2c_power", "fold")
MAIN_PATH = SEARCH_PATH + ("median",)
UNWHITENED_PATH = SEARCH_PATH + ("serial_mean",)
# the phase whose launches a kernel's row reports: the sentinel probe runs
# kernel A at T = 1 (phase f, health)
LAUNCHES_FROM = {
    "serial_mean": "unwhitened", "resample_t1": "health",
    "resample_exact": "exact_sin", "resample_t1_exact": "exact_sin", "serial_mean_exact": "exact_sin",
}
EXACT_SIN = ("resample_exact", "resample_t1_exact", "serial_mean_exact")
EXACT_SIN_PATH = ("resample_exact", "resample_t1_exact", "fftprep", "fft_r2c_power", "fold", "serial_mean_exact")
QUIT_AFTER = 3  # batches before the interrupted run quits
TILE = 33  # the exact mean is also run on bank200 tiled this often: 6,600 templates
OOM_BATCH = 2048  # a batch the card cannot hold at this width (~72 MB a template: the series and the fold's power)
HANG_DEADLINE_S = 10  # the supervised run's dispatch deadline
SERVE_MEM_SLACK = 64 << 20  # device memory a served workunit may leave above the post-warm value
SHARDS = 3  # the mesh of phase (g) repeats cuda:0 this often
N_HOSTS, VICTIM = 3, 1  # the elastic processes of phase (g), and the one killed
# longer than the merge winner's rescoring and result write (seconds at this
# width), during which it writes no heartbeat: a shorter one lets a survivor
# adopt the merge
LEASE_TIMEOUT_S = 20
FABRIC_STREAMS, FABRIC_WUS = 32, 16  # the fabric of phase (h1)
# phase (h2)'s batch: 50 batches of bank200, each followed by a checkpoint
# (~40 ms of host toplist and write a checkpoint), so the loop outlasts
# dozens of the soak's 50 ms checkpoint polls
KILL_BATCH, KILL_CYCLES = 4, 4
# phase (m1)'s window above one block's shared memory (ops/median.py: up to
# 15,361), over the first bins of phase 4's spectrum
MEDIAN_WIDE, MEDIAN_WIDE_BINS = 40001, 400_000
# phase (i3)'s worker command, as the bundle's app_info.xml gives it to the wrapper
BUNDLE_WORKER = "python3 eah_brp_worker.pyz"


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def time_ms(torch, fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up, by CUDA
    events around the whole run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def eager_stats(raw, n_steps, lf):
    """A copy of the eager statistics that ran between kernels A and B
    before A computed them (``ops/resample.py::batch_stats`` up to
    553471c): the trailing-run maxima, two masked passes over the samples,
    their sums and the division.  Timed as a yardstick only, on kernel A's
    outputs here, with a zeroed ``lf`` of the old kernel's shape."""
    import torch

    half = raw.shape[2]
    lf_glob = lf.amax(dim=2)
    n = torch.maximum(2 * lf_glob[:, 0], 2 * lf_glob[:, 1] + 1).to(torch.int32)
    m2 = torch.arange(half, dtype=torch.int32, device=raw.device) * 2
    zero = torch.zeros((), dtype=raw.dtype, device=raw.device)
    total = torch.where(m2[None, :] < n_steps[:, None], raw[:, 0], zero).sum(dim=1) + torch.where(
        (m2 + 1)[None, :] < n_steps[:, None], raw[:, 1], zero
    ).sum(dim=1)
    return n, total / n_steps.to(torch.float32)


def direct_health_vec(sums, valid, M):
    """A direct transcription of the JAX package's ``batch_health_vec``
    (``torch.isfinite`` masks, two full ``where`` copies, boolean sums):
    timed beside the port's formulation as a yardstick only."""
    import torch

    from boinc_app_eah_brp_tpu_torch.models.search import NEG_SENTINEL

    validb = valid[:, None, None]
    fin = torch.isfinite(sums)
    ok = validb & fin
    return torch.stack([
        (validb & ~fin).sum().to(torch.float32),
        (~torch.isfinite(M)).sum().to(torch.float32),
        torch.where(ok, sums, NEG_SENTINEL).amax(),
        torch.where(ok, sums, -NEG_SENTINEL).amin(),
    ])


def production_geometry():
    from boinc_app_eah_brp_tpu_torch.io import read_template_bank
    from boinc_app_eah_brp_tpu_torch.models import search
    from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig

    cfg = SearchConfig(f0=F0, padding=PADDING, fA=FA, window=WINDOW, white=True)
    derived = DerivedParams.derive(N_UNPADDED, TSAMPLE_US, cfg)
    bank = read_template_bank(BANK)
    geom = search.SearchGeometry.from_derived(
        derived,
        max_slope=search.max_slope_for_bank(bank.P, bank.tau),
        lut_step=search.lut_step_for_bank(bank.P, derived.dt),
        lut_tiles=search.lut_tiles_for_bank(bank.P, bank.psi0, N_UNPADDED, derived.dt),
    )
    return geom, bank


def check_kernels(torch, dev, geom, bank, samples) -> dict:
    """Phase 3: every kernel against its plain version at the production
    width; ``samples`` is the unwhitened workunit, for the serial mean.
    Returns the per-kernel measurements and the stage times; each bound is
    the package's roofline model (``runtime/roofline.py``) of this call."""
    from boinc_app_eah_brp_tpu_torch.models import search
    from boinc_app_eah_brp_tpu_torch.ops import harmonic, kernels, resample
    from boinc_app_eah_brp_tpu_torch.ops.spectrum import (
        power_from_rfft, rfft_fourstep_plain, search_power, search_rfft,
    )
    from boinc_app_eah_brp_tpu_torch.runtime import roofline

    n, nsamples, half = geom.n_unpadded, geom.nsamples, geom.n_unpadded // 2
    rng = np.random.default_rng(SEED)
    ts = torch.from_numpy(rng.normal(0.0, 1.0, n).astype(np.float32)).to(dev)
    params = resample.stream_params(
        *search.bank_params_host(bank.P[:BATCH], bank.tau[:BATCH], bank.psi0[:BATCH], geom.dt), device=dev
    )
    T = params.shape[0]
    kw = dict(n_unpadded=n, dt=geom.dt)
    out = {}

    # A: the resampler with its statistics (n_steps, mean), at T = 32 and
    # in its single-template launch A1
    for name, p_ in (("resample", params), ("resample_t1", params[17:18].contiguous())):
        t_ = p_.shape[0]
        got = resample.resample_stream(ts, p_, **kw)
        want = resample.resample_stream_plain(ts, p_, **kw)
        torch.cuda.synchronize()
        for what, a, b in zip(("gathered samples", "n_steps", "mean"), got, want):
            check(torch.equal(a, b), f"{name} kernel != plain version ({what})")
        out[name] = dict(
            max_abs_err=max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want)),
            ms=time_ms(torch, lambda: resample.resample_stream(ts, p_, **kw), 20 if t_ > 1 else 50),
            plain_ms=time_ms(torch, lambda: resample.resample_stream_plain(ts, p_, **kw), 3),
            library_ms=None,
            **roofline.resample_cost(t_, n).bound(),
        )
        del got, want
    # the exact mean of the unwhitened workunit, the whole bank in one
    # launch as the main path takes it
    ts_u = torch.from_numpy(samples).to(dev)
    N = len(bank)
    bank_params = resample.stream_params(
        *search.bank_params_host(bank.P, bank.tau, bank.psi0, geom.dt), device=dev
    )
    before = kernels.launch_counts["serial_mean"]
    ns_u, mean_u = resample.exact_mean_params(ts_u, bank_params, **kw)
    check(kernels.launch_counts["serial_mean"] == before + 1, "the exact mean did not launch once")
    t0 = time.perf_counter()
    ns_p, mean_p = resample.exact_mean_params_plain(ts_u, bank_params, **kw)
    exact_plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(ns_u, ns_p), "exact mean kernel != plain version (n_steps)")
    check(torch.equal(mean_u.view(torch.int32), mean_p.view(torch.int32)), "exact mean kernel != plain version (mean)")
    ns_a = torch.cat([
        resample.resample_stream(ts_u, bank_params[s : s + BATCH].contiguous(), **kw)[1]
        for s in range(0, N, BATCH)
    ])
    check(torch.equal(ns_u, ns_a), "exact mean n_steps != kernel A's")
    raw_u, ns_b, _ = resample.resample_stream(ts_u, params, **kw)
    check(
        torch.equal(resample.serial_mean_plain(raw_u, ns_b).view(torch.int32), mean_u[:T].view(torch.int32)),
        "exact mean != the serial mean of kernel A's samples",
    )
    del raw_u
    tiled = bank_params.repeat(TILE, 1)
    ns_t, mean_t = resample.exact_mean_params(ts_u, tiled, **kw)
    check(
        torch.equal(ns_t, ns_u.repeat(TILE)) and torch.equal(mean_t.view(torch.int32), mean_u.repeat(TILE).view(torch.int32)),
        f"the exact mean of bank200 tiled {TILE} times differs from bank200's",
    )
    def exact_bound(copies: int) -> dict:
        return roofline.exact_mean_cost(n, np.tile(ns_u.cpu().numpy(), copies)).bound()

    out["serial_mean"] = dict(
        max_abs_err=float((mean_u - mean_p).abs().max()),
        ms=time_ms(torch, lambda: resample.exact_mean_params(ts_u, bank_params, **kw), 5),
        plain_ms=exact_plain_ms,
        library_ms=None,
        **exact_bound(1),
    )
    out[f"serial_mean_x{TILE}"] = exact_bound(TILE)
    tiled_ms = time_ms(torch, lambda: resample.exact_mean_params(ts_u, tiled, **kw), 2)
    del tiled, ns_t, mean_t

    raw, n_steps, mean = resample.resample_stream(ts, params, **kw)
    # a copy of the first port's eager statistics, timed alone on these outputs
    lf = torch.zeros((T, 2, -(-(n // 2) // 256)), dtype=torch.int32, device=dev)
    stats_eager_ms = time_ms(torch, lambda: eager_stats(raw, n_steps, lf), 10)
    del lf

    # B: FFT-prep
    x = resample.fftprep(raw, n_steps, mean, nsamples=nsamples)
    x_p = resample.fftprep_plain(raw, n_steps, mean, nsamples=nsamples)
    torch.cuda.synchronize()
    check(torch.equal(x, x_p), "fftprep kernel != plain version")
    i = torch.arange(nsamples, device=dev)
    mask = i[None, :] < n_steps[:, None]
    src = torch.zeros((T, nsamples), dtype=torch.float32, device=dev)
    src[:, :n] = raw.transpose(1, 2).reshape(T, n)
    out["fftprep"] = dict(
        max_abs_err=float((x - x_p).abs().max()),
        ms=time_ms(torch, lambda: resample.fftprep(raw, n_steps, mean, nsamples=nsamples), 20),
        plain_ms=time_ms(torch, lambda: resample.fftprep_plain(raw, n_steps, mean, nsamples=nsamples), 3),
        library_ms=time_ms(torch, lambda: torch.where(mask, src, mean[:, None]), 20),
        **roofline.fftprep_cost(T, n, nsamples).bound(),
    )
    del x_p, src, mask, i

    # the rfft (the step's: csrc/rfft.cu's two passes) against cuFFT's
    # through torch.fft.rfft, its library yardstick, and its plain version,
    # each to 1e-5 of max |F|; template by template, the kernel's and
    # cuFFT's distance from the float64 transform, of max |F| and of rms |F|,
    # at each template's sector phase in F (the rows pass 2 takes follow
    # it).  The kernel's first pass overwrites x, so every other transform
    # of x comes first; then it and the eager power epilogue, each alone
    F_lib = torch.fft.rfft(x)
    library_ms = time_ms(torch, lambda: torch.fft.rfft(x), 5)
    x_power = x.clone()  # the power pass's own series
    F64 = torch.fft.rfft(x.double())
    F_plain = rfft_fourstep_plain(x)
    plain_ms = time_ms(torch, lambda: rfft_fourstep_plain(x), 2)
    F = search_rfft(x)
    torch.cuda.synchronize()
    rfft_gap = float((F - F_lib).abs().max() / F_lib.abs().max())
    plain_gap = float((F - F_plain).abs().max() / F_plain.abs().max())
    del F_plain
    per_template = []
    for t in range(T):
        ref = F64[t]
        scale, rms = float(ref.abs().max()), float(ref.abs().square().mean().sqrt())
        dk, dc = (F[t].to(torch.complex128) - ref).abs(), (F_lib[t].to(torch.complex128) - ref).abs()
        k = int(dk.argmax())
        per_template.append(dict(
            t=t, sector_phase=F[t].data_ptr() // F.element_size() % 4,
            vs_cufft=float((F[t] - F_lib[t]).abs().max() / F_lib[t].abs().max()),
            kernel_vs_f64=float(dk.max()) / scale, cufft_vs_f64=float(dc.max()) / scale,
            kernel_vs_f64_of_rms=float(dk.max()) / rms, cufft_vs_f64_of_rms=float(dc.max()) / rms,
            worst_bin=k, worst_bin_of_max=float(ref[k].abs()) / scale, max_over_rms=scale / rms,
        ))
        del dk, dc
    del F64, F_lib
    print(json.dumps({"rfft_accuracy": per_template}), flush=True)
    check(rfft_gap <= 1e-5, f"rfft kernel off cuFFT by {rfft_gap:.3g} of max |F|")
    check(plain_gap <= 1e-5, f"rfft kernel off its plain version by {plain_gap:.3g} of max |F|")
    # against the float64 transform both float32 transforms err most in
    # bins 0-2 of these mean-padded noise series (a template's max |F| is
    # only ~4 rms |F|): the kernel is held to twice cuFFT's largest distance
    k64, c64 = (max(r[k] for r in per_template) for k in ("kernel_vs_f64", "cufft_vs_f64"))
    check(k64 <= 2 * c64, f"rfft kernel off the float64 transform by {k64:.3g} of max |F|, cuFFT by {c64:.3g}")
    stages = dict(
        stats_eager_ms=stats_eager_ms,
        # x holds the kernel's intermediate now: the time does not depend on
        # the values
        rfft_ms=time_ms(torch, lambda: search_rfft(x), 5),
        power_ms=time_ms(torch, lambda: power_from_rfft(F, nsamples=nsamples), 5),
    )
    # its bound is one pass, the real input read once and the complex
    # output written once; "passes" is how many such passes its measured
    # time is worth
    out["fft_r2c"] = dict(
        max_rel_err=rfft_gap, plain_rel_err=plain_gap, f64_rel_err=k64, library_f64_rel_err=c64,
        ms=stages["rfft_ms"], plain_ms=plain_ms,
        library_ms=library_ms, **roofline.rfft_cost(T, nsamples).bound(),
    )
    out["fft_r2c"]["passes"] = stages["rfft_ms"] / out["fft_r2c"]["bound_ms"]
    fold_kw = dict(fund_hi=geom.fund_hi, harm_hi=geom.harm_hi)

    # the main path's R2C: the same passes, the second writing the fold's
    # power at the bins it reads, bitwise the power of F; its library
    # yardstick cuFFT and the eager epilogue, its plain version the plain
    # transform's power
    read = harmonic.fold_read(nsamples // 2 + 1, harmonic.state_width(geom.fund_hi))
    ps_kernel = search_power(x_power, read=read)
    ps_want = power_from_rfft(F[:, :read], nsamples=nsamples)
    torch.cuda.synchronize()
    check(torch.equal(ps_kernel.view(torch.int32), ps_want.view(torch.int32)),
          "rfft power pass != the power of the complex pass's spectrum")
    del ps_want
    out["fft_r2c_power"] = dict(
        max_abs_err=0.0,
        ms=time_ms(torch, lambda: search_power(x_power, read=read), 5),
        plain_ms=time_ms(torch, lambda: power_from_rfft(rfft_fourstep_plain(x)[:, :read], nsamples=nsamples), 2),
        library_ms=time_ms(torch, lambda: power_from_rfft(torch.fft.rfft(x)[:, :read], nsamples=nsamples), 5),
        **roofline.rfft_power_cost(T, nsamples, geom.fund_hi).bound(),
    )
    # the same at the benchmark's batch of 128 (the series tiled): the
    # complex pass and the power pass, then C's complex and float entries
    # on their outputs
    x128 = x.repeat(4, 1)
    stages["rfft_ms_t128"] = time_ms(torch, lambda: search_rfft(x128), 3)
    stages["rfft_power_ms_t128"] = time_ms(torch, lambda: search_power(x128, read=read), 3)
    del x128
    F128 = F.repeat(4, 1)
    stages["fold_spectrum_ms_t128"] = time_ms(
        torch, lambda: harmonic.sumspec_spectrum(F128, nsamples=nsamples, **fold_kw), 3
    )
    del F128
    ps128 = ps_kernel.repeat(4, 1)
    stages["fold_ms_t128"] = time_ms(torch, lambda: harmonic.sumspec_batch(ps128, **fold_kw), 3)
    del ps128, ps_kernel, x_power, x

    # C on float power spectra (the counterpart of sumspec_pallas_batch)
    ps = power_from_rfft(F, nsamples=nsamples)
    before = kernels.launch_counts["fold"]
    sums = harmonic.sumspec_batch(ps, **fold_kw)
    check(kernels.launch_counts["fold"] == before + 1, "the float-input fold did not launch")
    sums_p = harmonic.sumspec_batch_plain(ps, **fold_kw)
    torch.cuda.synchronize()
    check(torch.equal(sums, sums_p), "fold kernel != plain version")
    out["fold"] = dict(
        max_abs_err=float((sums - sums_p).abs().max()),
        ms=time_ms(torch, lambda: harmonic.sumspec_batch(ps, **fold_kw), 20),
        plain_ms=time_ms(torch, lambda: harmonic.sumspec_batch_plain(ps, **fold_kw), 2),
        library_ms=None,
        **roofline.fold_cost(T, nsamples, geom.fund_hi, complex_input=False).bound(),
    )
    # the whitening's running median over one spectrum, alone: the device
    # median and the host one (tools/stagebench.py's running_median_ms and
    # running_median_native_ms)
    from boinc_app_eah_brp_tpu_torch.ops import median, native_median

    spectrum = ps[0].contiguous()
    stages["running_median_ms"] = time_ms(torch, lambda: median.running_median(spectrum, bsize=WINDOW), 5)
    host = spectrum.cpu().numpy()
    native_median.load()  # its first use builds the library: not the median's time
    t0 = time.perf_counter()
    native_median.running_median(host, WINDOW)
    stages["running_median_native_ms"] = (time.perf_counter() - t0) * 1e3
    del ps, sums, sums_p, spectrum, host

    # C on the complex spectrum, the entry of lengths without a split of the
    # port's R2C: the power epilogue (3 multiplies and an add a bin) inside
    # the fold
    sk = dict(nsamples=nsamples, **fold_kw)
    sums = harmonic.sumspec_spectrum(F, **sk)
    sums_p = harmonic.sumspec_spectrum_plain(F, **sk)
    torch.cuda.synchronize()
    check(torch.equal(sums, sums_p), "complex-input fold kernel != plain version")
    out["fold_spectrum"] = dict(
        max_abs_err=float((sums - sums_p).abs().max()),
        ms=time_ms(torch, lambda: harmonic.sumspec_spectrum(F, **sk), 20),
        plain_ms=time_ms(torch, lambda: harmonic.sumspec_spectrum_plain(F, **sk), 2),
        library_ms=None,
        **roofline.fold_cost(T, nsamples, geom.fund_hi).bound(),
    )
    # the merge into (M, T) alone, on these sums (tools/stagebench.py's merge_ms)
    merge_step = search.BankStep(geom, torch.zeros((2 * T, 4), device=dev), T)
    stages["merge_ms"] = time_ms(torch, lambda: merge_step.merge(sums, 0, len(bank)), 20)
    del F, sums, sums_p, merge_step

    # one whole batch step (A with its statistics, B, rfft, power + C, merge)
    bank_dev = search.upload_bank(
        search.bank_params_host(bank.P, bank.tau, bank.psi0, geom.dt), BATCH, dev
    )
    step = search.BankStep(geom, bank_dev, BATCH, state=search.init_state(geom, dev))
    stages["batch_step_ms"] = time_ms(torch, lambda: step(ts, 0, len(bank)), 3)
    # and of the unwhitened workunit, its exact means computed ahead and
    # resident beside the bank, as run_bank holds them
    geom_u = dataclasses.replace(geom, exact_mean=True)
    mean_dev = torch.zeros(bank_dev.shape[0], dtype=torch.float32, device=dev)
    mean_dev[:N] = mean_u
    step = search.BankStep(geom_u, bank_dev, BATCH, state=search.init_state(geom_u, dev), mean=mean_dev)
    before = kernels.launch_counts["serial_mean"]
    stages["batch_step_unwhitened_ms"] = time_ms(torch, lambda: step(ts_u, 0, len(bank)), 3)
    check(kernels.launch_counts["serial_mean"] == before, "an unwhitened step with resident means took the exact mean")
    stages[f"serial_mean_x{TILE}_ms"] = tiled_ms
    out["stages"] = stages
    return out


def synthetic_workunit(path: str, geom, bank, inject: int = INJECT, seed: int = SEED) -> tuple[float, float]:
    """A 4-bit workunit of N_UNPADDED samples at TSAMPLE_US: N(4, 1) noise
    plus a pulse train whose arrival times follow bank row ``inject``'s
    orbit, made from ``seed`` (``tools/_inputs.py::production_workunit``).
    Returns the template's (P, tau)."""
    from boinc_app_eah_brp_tpu_torch.tools import _inputs

    return _inputs.production_workunit(path, bank, inject, seed, n_samples=N_UNPADDED)


def _remove_checkpoints(cp: str) -> None:
    """A fresh start: every generation of checkpoint ``cp`` and its sidecars."""
    for path in glob.glob(glob.escape(cp) + "*"):
        os.remove(path)


def _candidate_rows(cand: str) -> np.ndarray:
    from boinc_app_eah_brp_tpu_torch.io import parse_result_file

    text = open(cand).read()
    check(text.endswith("%DONE%\n"), f"{cand} does not end with %DONE%")
    lines = [ln for ln in text.splitlines() if ln and not ln.startswith("%")]
    check(len(lines) > 0 and all(len(ln.split()) == 7 for ln in lines), f"malformed candidate lines in {cand}")
    return parse_result_file(cand).lines


def _injected_rank(rows, P_inj: float, tau_inj: float) -> int | None:
    """1-based rank of the first candidate on the injected template."""
    for k, r in enumerate(rows):
        if abs(r[1] - P_inj) < 1e-6 * P_inj and abs(r[2] - tau_inj) < 1e-6:
            return k + 1
    return None


def run_main_path(torch, geom, bank, workdir: str, wu: str, P_inj: float, tau_inj: float) -> dict:
    """Phase 4: the whitened search through the command line with a
    checkpoint file and rescoring, counts reset just before and read just
    after; then its stages alone."""
    from boinc_app_eah_brp_tpu_torch.io.checkpoint import Checkpoint, read_checkpoint, write_checkpoint
    from boinc_app_eah_brp_tpu_torch.ops import kernels
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main as cli_main

    zap = os.path.join(workdir, "smoke.zap")
    cand = os.path.join(workdir, "smoke.cand")
    cp = os.path.join(workdir, "smoke.cpt")
    with open(zap, "w") as f:
        f.write(ZAPLIST)
    argv = (
        f"-i {wu} -o {cand} -t {BANK} -c {cp} -l {zap} -W -P {PADDING} -f {F0} -A {FA} "
        f"-B {WINDOW} --batch {BATCH} --device {DEVICE}"
    ).split()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    # cuFFT plans of a batch's R2C, (templates, nsamples) in float32, that
    # the process has made through planned_fft: none, the kernel takes it
    search_plans = [k for k in kernels.planned_keys
                    if k[3] is torch.fft.rfft and len(k[1]) == 2 and k[1][1] == geom.nsamples]

    check(rc == 0, f"search exited with {rc}")
    rows = _candidate_rows(cand)
    check(read_checkpoint(cp).n_template == len(bank), "the final checkpoint does not cover the bank")
    top = rows[:5]
    check(
        _injected_rank(top, P_inj, tau_inj) is not None,
        f"injected template (P={P_inj}, tau={tau_inj}) not among the top 5 candidates: {top.tolist()}",
    )
    for name in MAIN_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched by the search")
    check(launches["median"] == 1, f"the whitened search launched the median {launches['median']} times")
    batches = -(-len(bank) // BATCH)
    for name in ("fft_r2c_power", "fold"):
        check(launches[name] == batches,
              f"the search launched {name} {launches[name]} times for {batches} batches")
    check(not search_plans, f"the search's R2C made cuFFT plans: {search_plans}")
    check(launches["fft_r2c"] == 0 and launches["fold_spectrum"] == 0,
          "the search stored and folded a complex spectrum")
    check(launches["serial_mean"] == 0, "the whitened search took the serial mean")

    # The same run again from scratch, now that cuFFT plans and the median
    # kernel are loaded, and then its stages one at a time in the
    # driver's order.
    from boinc_app_eah_brp_tpu_torch.io import (
        ResultFile, empty_candidates, read_template_bank, read_workunit, read_zaplist,
        write_result_file,
    )
    from boinc_app_eah_brp_tpu_torch.models.search import run_bank, state_to_natural
    from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
    from boinc_app_eah_brp_tpu_torch.oracle.rescore import rescore_winners, unique_winner_count
    from boinc_app_eah_brp_tpu_torch.oracle.stats import base_thresholds
    from boinc_app_eah_brp_tpu_torch.oracle.toplist import (
        finalize_candidates, update_toplist_from_maxima,
    )
    from boinc_app_eah_brp_tpu_torch.ops.whiten import whiten_and_zap

    _remove_checkpoints(cp)
    t0 = time.perf_counter()
    check(cli_main(argv) == 0, "second search run failed")
    torch.cuda.synchronize()
    wall_warm = time.perf_counter() - t0

    stages = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    cfg = SearchConfig(f0=F0, padding=PADDING, fA=FA, window=WINDOW, white=True)
    wu_data = timed("read_s", lambda: (read_workunit(wu), read_template_bank(BANK)))[0]
    derived = DerivedParams.derive(wu_data.nsamples, float(wu_data.header["tsample"]), cfg)
    ts = timed(
        "whiten_s",
        lambda: whiten_and_zap(wu_data.samples, derived, cfg, read_zaplist(zap), device=DEVICE),
    )
    M, T = timed(
        "search_loop_s", lambda: run_bank(ts, bank.P, bank.tau, bank.psi0, geom, batch_size=BATCH)
    )
    def toplist():
        cands = update_toplist_from_maxima(
            empty_candidates(), state_to_natural(M, geom), state_to_natural(T, geom),
            bank.P.astype(np.float32), bank.tau.astype(np.float32),
            bank.psi0.astype(np.float32), base_thresholds(cfg.fA, derived.fft_size),
            geom.window_2,
        )
        return cands, finalize_candidates(cands, derived.t_obs)

    cands, emitted = timed("toplist_s", toplist)
    # the unrescored rows, which phase (k1)'s ERP_RESCORE=off run must write
    write_result_file(os.path.join(workdir, "unrescored.cand"), ResultFile(candidates=emitted, t_obs=derived.t_obs))
    timed(
        "checkpoint_s",
        lambda: write_checkpoint(
            os.path.join(workdir, "stages.cpt"),
            Checkpoint(n_template=len(bank), originalfile=wu, candidates=cands),
            bank=(BANK, len(bank)),
        ),
    )
    emitted = timed(
        "rescore_s",
        lambda: finalize_candidates(
            rescore_winners(ts, cands, emitted, derived)[0], derived.t_obs
        ),
    )
    timed(
        "write_s",
        lambda: write_result_file(
            os.path.join(workdir, "stages.cand"), ResultFile(candidates=emitted, t_obs=derived.t_obs)
        ),
    )
    return dict(
        **stages,
        rescored_templates=unique_winner_count(emitted),
        search_loop_templates_per_s=len(bank) / stages["search_loop_s"],
        wall_first_s=wall,
        wall_s=wall_warm,
        unattributed_s=wall_warm - sum(stages.values()),
        templates_per_s=len(bank) / wall_warm,
        peak_device_bytes=int(peak),
        n_candidates=len(rows),
        top_candidate=[float(v) for v in rows[0]],
        launches=launches,
    )


def run_unwhitened(torch, geom, bank, workdir: str, wu: str, P_inj: float, tau_inj: float) -> dict:
    """Phase 5: the unwhitened search (the JAX driver's default) through
    the command line with a checkpoint file and rescoring, counts reset
    just before and read just after; its search loop alone; then the same
    run quit after QUIT_AFTER batches at checkpoint period 0 and resumed,
    which must give the same candidate rows."""
    from boinc_app_eah_brp_tpu_torch.io import read_workunit
    from boinc_app_eah_brp_tpu_torch.io.checkpoint import read_checkpoint
    from boinc_app_eah_brp_tpu_torch.models.search import run_bank
    from boinc_app_eah_brp_tpu_torch.ops import kernels
    from boinc_app_eah_brp_tpu_torch.runtime.boinc import BoincAdapter
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main as cli_main
    from boinc_app_eah_brp_tpu_torch.runtime.cli import parse_args
    from boinc_app_eah_brp_tpu_torch.runtime.driver import run_search

    def argv(name):
        return (
            f"-i {wu} -o {os.path.join(workdir, name + '.cand')} -t {BANK} -c {os.path.join(workdir, name + '.cpt')} "
            f"-P {PADDING} -f {F0} -A {FA} -B {WINDOW} --batch {BATCH} --device {DEVICE}"
        ).split()

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli_main(argv("unwhitened"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    check(rc == 0, f"unwhitened search exited with {rc}")
    rows = _candidate_rows(os.path.join(workdir, "unwhitened.cand"))
    rank = _injected_rank(rows, P_inj, tau_inj)
    check(rank is not None, f"injected template (P={P_inj}, tau={tau_inj}) not among the unwhitened candidates")
    for name in UNWHITENED_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched by the unwhitened search")
    check(launches["serial_mean"] == 1, f"the unwhitened search took the exact mean {launches['serial_mean']} times")

    ts = torch.from_numpy(read_workunit(wu).samples).to(DEVICE)
    geom_u = dataclasses.replace(geom, exact_mean=True)
    t0 = time.perf_counter()
    run_bank(ts, bank.P, bank.tau, bank.psi0, geom_u, batch_size=BATCH)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0

    class QuitAfter(BoincAdapter):
        def __init__(self):
            super().__init__(checkpoint_period_s=0.0)  # checkpoint every batch
            self.batches = 0

        def quit_requested(self):
            self.batches += 1
            return self.batches >= QUIT_AFTER

    kernels.reset_launch_counts()
    check(run_search(parse_args(argv("resumed")), QuitAfter()) == 0, "the interrupted run failed")
    check(kernels.launch_counts["serial_mean"] == 1, "the interrupted run did not take the exact mean once")
    check(not os.path.exists(os.path.join(workdir, "resumed.cand")), "the interrupted run wrote a result")
    n_done = read_checkpoint(os.path.join(workdir, "resumed.cpt")).n_template
    check(n_done == QUIT_AFTER * BATCH, f"the interrupted run checkpointed {n_done} templates")
    kernels.reset_launch_counts()
    check(cli_main(argv("resumed")) == 0, "the resumed run failed")
    check(kernels.launch_counts["serial_mean"] == 1, "the resumed run did not take the exact mean once")
    resumed = _candidate_rows(os.path.join(workdir, "resumed.cand"))
    check(np.array_equal(resumed, rows), "the resumed run's candidate rows differ from the uninterrupted run's")
    return dict(
        wall_s=wall,
        search_loop_s=loop_s,
        search_loop_templates_per_s=len(bank) / loop_s,
        injected_rank=rank,
        n_candidates=len(rows),
        resumed_from=n_done,
        resume_rows_equal=True,
        launches=launches,
    )


class _Tee:
    """stderr that also keeps what was written (the driver's log lines)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _report(path: str) -> dict:
    with open(path + ".report.json") as f:
        return json.load(f)


def run_default_cli(torch, bank, workdir: str, wu: str, unwhite_rows) -> dict:
    """Phase (a): the default command line (unwhitened, no --batch) with
    the metrics stream, the host trace and a profiler trace of the loop,
    counts reset just before and read just after."""
    import contextlib

    from boinc_app_eah_brp_tpu_torch.ops import kernels
    from boinc_app_eah_brp_tpu_torch.runtime import metrics, steptime, tracing
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main as cli_main

    cand, mfile = os.path.join(workdir, "default.cand"), os.path.join(workdir, "default.metrics.jsonl")
    prof, trace = os.path.join(workdir, "default.prof"), os.path.join(workdir, "default.trace.jsonl")
    argv = (
        f"-i {wu} -o {cand} -t {BANK} -c {os.path.join(workdir, 'default.cpt')} -P {PADDING} -f {F0} -A {FA} "
        f"-B {WINDOW} --device {DEVICE} --metrics-file {mfile} --profile-dir {prof}"
    ).split()
    os.environ[tracing.TRACE_FILE_ENV] = trace
    tee = _Tee(sys.stderr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    try:
        with contextlib.redirect_stderr(tee):
            t0 = time.perf_counter()
            rc = cli_main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del os.environ[tracing.TRACE_FILE_ENV]
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"the default command line exited with {rc}")
    for name in UNWHITENED_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched by the default command line")
    decision = [ln.strip() for ln in "".join(tee.lines).splitlines() if "Batch size" in ln]
    check(len(decision) == 1 and "(--batch)" not in decision[0], f"no autobatch decision logged: {decision}")
    report = _report(mfile)
    problems = metrics.validate_report(report)
    check(not problems, f"the run report does not validate: {problems}")
    gauges = report["metrics"]["gauges"]
    batch = gauges["autobatch.batch_size"]["value"]
    check(batch in (8, 16, 32, 64, 128), f"autobatch chose {batch}")
    rows = _candidate_rows(cand)
    check(np.array_equal(rows, unwhite_rows), f"the default command line's rows (batch {batch}) differ from phase 5's")
    with open(trace) as f:
        spans = [json.loads(ln) for ln in f if ln.strip()]
    check(tracing.validate_stream(spans) == [], "the host trace stream does not validate")
    # the loop on the card: from its first kernel to its last in the
    # profile (the host's loop phase ends once the card has run the last batch)
    records = steptime.device_records_from_chrome(os.path.join(prof, "trace.json"))
    idle = steptime.device_idle_share(records)
    check(idle["n"] > 0, "the profile holds no device records")
    stage_ms = {}
    for r in steptime.stage_records(records):
        stage_ms[r["args"]["stage"]] = stage_ms.get(r["args"]["stage"], 0.0) + r["dur_us"] / 1e3
    return dict(
        batch=batch,
        decision=decision[0],
        autobatch=gauges["autobatch.decision"]["value"],
        wall_s=wall,
        loop_phase_s=report["metrics"]["phases"]["template loop"]["wall_s"],
        loop_templates_per_s=len(bank) / (idle["span_us"] * 1e-6),
        peak_device_bytes=int(peak),
        device_records=idle["n"],
        device_span_ms=idle["span_us"] / 1e3,
        device_busy_ms=idle["busy_us"] / 1e3,
        device_idle_share=idle["idle_share"],
        device_gaps=idle["gaps"],
        stage_ms=stage_ms,
        counters={k: v["value"] for k, v in report["metrics"]["counters"].items()},
        launches=launches,
    )


def run_batch_sweep(torch, geom, bank, wu: str, zap: str) -> dict:
    """Phase (b): the whitened search loop at each batch of the sweep, two
    runs each, written to the artifact the default command line reads."""
    from boinc_app_eah_brp_tpu_torch.io import read_workunit, read_zaplist
    from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
    from boinc_app_eah_brp_tpu_torch.ops.whiten import whiten_and_zap
    from boinc_app_eah_brp_tpu_torch.runtime import autobatch

    cfg = SearchConfig(f0=F0, padding=PADDING, fA=FA, window=WINDOW, white=True)
    wu_data = read_workunit(wu)
    derived = DerivedParams.derive(wu_data.nsamples, float(wu_data.header["tsample"]), cfg)
    ts = whiten_and_zap(wu_data.samples, derived, cfg, read_zaplist(zap), device=DEVICE)
    art = autobatch.sweep(ts, bank.P, bank.tau, bank.psi0, geom, runs=2)
    check(art["device_kind"] == torch.cuda.get_device_name(0), "the sweep artifact lacks the card's kind")
    check(all("error" not in r for r in art["rungs"]), f"a sweep rung failed: {art['rungs']}")
    # what the next run's autobatch makes of the artifact
    lines = []
    batch = autobatch.choose_batch(geom.nsamples, log=lines.append, device=DEVICE)
    check(batch == art["best_batch"] and "on this device kind" in lines[0], f"the sweep was not taken: {lines}")
    art["next_run_decision"] = lines[0].strip()
    # the loop at batch 32 with the metrics and the host tracer off and on
    # (in memory), in turns: what the instrumentation costs
    from boinc_app_eah_brp_tpu_torch.models.search import run_bank
    from boinc_app_eah_brp_tpu_torch.runtime import metrics, tracing

    def loop_s():
        t0 = time.perf_counter()
        run_bank(ts, bank.P, bank.tau, bank.psi0, geom, batch_size=BATCH)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    overhead = {"off": [], "on": []}
    for knobs in ("off", "on", "on", "off", "off", "on"):
        if knobs == "on":
            metrics.configure(force=True, interval=0)
            tracing.configure(force=True)
        overhead[knobs].append(loop_s())
        if knobs == "on":
            tracing.finish(0)
            metrics.finish(0)
    art["loop_s_knobs"] = overhead
    del ts
    torch.cuda.empty_cache()
    return art


def run_oom_ladder(torch, workdir: str, wu: str, zap: str) -> dict:
    """Phase (c): a whitened --no-rescore baseline at batch 32, then a
    batch the card cannot hold and an injected out-of-memory; both must
    halve the batch and write the baseline's rows."""
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main as cli_main

    def run(name, batch, env=None):
        argv = (
            f"-i {wu} -o {os.path.join(workdir, name + '.cand')} -t {BANK} -l {zap} -W -P {PADDING} -f {F0} "
            f"-A {FA} -B {WINDOW} --batch {batch} --no-rescore --device {DEVICE} "
            f"--metrics-file {os.path.join(workdir, name + '.jsonl')}"
        ).split()
        os.environ.update(env or {})
        try:
            t0 = time.perf_counter()
            rc = cli_main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for k in env or {}:
                del os.environ[k]
        check(rc == 0, f"the {name} run exited with {rc}")
        report = _report(os.path.join(workdir, name + ".jsonl"))
        counters = {k: v["value"] for k, v in report["metrics"]["counters"].items()}
        gauges = {k: v["value"] for k, v in report["metrics"]["gauges"].items()}
        torch.cuda.empty_cache()
        return _candidate_rows(os.path.join(workdir, name + ".cand")), dict(
            wall_s=wall,
            batch_halved=counters.get("resilience.batch_halved", 0),
            retries=counters.get("resilience.retries", 0),
            final_batch=gauges.get("resilience.batch_size", batch),
            templates_dispatched=counters["search.templates"],
        )

    base_rows, base = run("baseline", BATCH)
    out = {"baseline": base}
    for name, batch, env in (
        ("real_oom", OOM_BATCH, None),
        ("injected_oom", BATCH, {"ERP_FAULT_SPEC": "dispatch:oom@n=2"}),
    ):
        rows, out[name] = run(name, batch, env)
        check(out[name]["batch_halved"] >= 1, f"the {name} run did not halve its batch: {out[name]}")
        check(np.array_equal(rows, base_rows), f"the {name} run's rows differ from the baseline's")
    out["baseline_rows"] = base_rows
    return out


def run_supervised(workdir: str, wu: str, zap: str, base_rows) -> dict:
    """Phase (d): --supervised 2 with a dispatch hang at the third batch, a
    short dispatch deadline and a checkpoint every batch; the watchdog
    ends the wedged worker with rc 99 and the supervisor resumes it."""
    from boinc_app_eah_brp_tpu_torch.runtime import watchdog

    cand, cp = os.path.join(workdir, "supervised.cand"), os.path.join(workdir, "supervised.cpt")
    env = dict(
        os.environ,
        PYTHONPATH=REPO,
        ERP_FAULT_SPEC="dispatch:hang@n=3",
        ERP_FAULT_STATE=os.path.join(workdir, "supervised.faults.json"),
        ERP_WATCHDOG_SPEC=f"dispatch={HANG_DEADLINE_S}",
        ERP_WATCHDOG_GRACE_S="2",
        ERP_CHECKPOINT_PERIOD="0",
        ERP_SUPERVISE_BACKOFF_S="0",
        ERP_LOGLEVEL="info",
    )
    argv = (
        f"--supervised 2 -i {wu} -o {cand} -t {BANK} -c {cp} -l {zap} -W -P {PADDING} -f {F0} -A {FA} "
        f"-B {WINDOW} --batch {BATCH} --no-rescore --device {DEVICE}"
    ).split()
    t0 = time.perf_counter()
    # a session of its own: on a timeout the supervisor's worker goes too
    proc = subprocess.Popen(
        [sys.executable, "-m", "boinc_app_eah_brp_tpu_torch", *argv], env=env, cwd=workdir,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True,
    )
    try:
        _, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise CheckFailed("the supervised run did not finish in 600 s")
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the supervised run exited with {proc.returncode}: {stderr[-2000:]}")
    check("exited rc 99 (pass 1)" in stderr and "after 2 pass(es)" in stderr, "the supervised run did not restart once")
    check(np.array_equal(_candidate_rows(cand), base_rows), "the supervised run's rows differ from the baseline's")
    doc = watchdog.IncidentLog(cp + ".incidents.json").read()
    check(watchdog.validate_incident_log(doc) == [] and len(doc["incidents"]) == 1, f"bad incident log: {doc}")
    return dict(wall_s=wall, incidents=[(i["stage"], i["window"]) for i in doc["incidents"]])


def run_serving(torch, workdir: str, wu: str, unwhite_rows, geom, bank) -> dict:
    """Phase (e): one resident FleetServer, warmed for the unwhitened class
    at BATCH, serves phase 5's workunit, a missing input file, a second
    workunit with another injected template and phase 5's workunit again,
    all queued at once (so each workunit's prep overlaps the one before).
    The launch counts are reset just before the first submit; each
    session's launches, steps and device memory are read around its
    execution, which the scheduler serializes."""
    from boinc_app_eah_brp_tpu_torch.ops import kernels
    from boinc_app_eah_brp_tpu_torch.runtime import steptime
    from boinc_app_eah_brp_tpu_torch.runtime.cli import parse_args
    from boinc_app_eah_brp_tpu_torch.runtime.errors import RADPUL_EIO
    from boinc_app_eah_brp_tpu_torch.runtime.percentiles import latency_block
    from boinc_app_eah_brp_tpu_torch.runtime.scheduler import WarmSpec
    from boinc_app_eah_brp_tpu_torch.runtime.session import Session
    from boinc_app_eah_brp_tpu_torch.serving import FleetServer

    wu2 = os.path.join(workdir, "serve2.bin4")
    P2, tau2 = synthetic_workunit(wu2, geom, bank, inject=INJECT2, seed=SEED + 1)

    def args(path, name):
        return parse_args(
            f"-i {path} -o {os.path.join(workdir, name + '.cand')} -t {BANK} -c {os.path.join(workdir, name + '.cpt')} "
            f"-P {PADDING} -f {F0} -A {FA} -B {WINDOW} --batch {BATCH} --device {DEVICE}".split()
        )

    requests = [
        ("serve_a", args(wu, "serve_a")),
        ("serve_missing", args(os.path.join(workdir, "missing.bin4"), "serve_missing")),
        ("serve_b", args(wu2, "serve_b")),
        ("serve_c", args(wu, "serve_c")),
    ]
    # the class's geometry, as a session of it builds it
    probe = Session(args(wu, "serve_probe")).prepare()
    spec = WarmSpec(probe.geom, BATCH)
    probe.release()
    del probe
    steptime.configure(force=True)
    t0 = time.perf_counter()
    server = FleetServer(name="smoke", warm_specs=[spec], device=DEVICE)
    warm_s = time.perf_counter() - t0
    per_wu = {}
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        execute = server.scheduler.execute

        def counted(session, prep_future=None):
            before, step0 = dict(kernels.launch_counts), steptime.count()
            res = execute(session, prep_future)
            torch.cuda.synchronize()
            steps = [r["ms"] for r in steptime.records(since=step0)]
            per_wu[res.name] = dict(
                launches={k: v - before[k] for k, v in kernels.launch_counts.items()},
                mem_delta_bytes=torch.cuda.memory_allocated() - base,
                first_step_ms=steps[0] if steps else None,
                median_step_ms=float(np.median(steps)) if steps else None,
            )
            return res

        server.scheduler.execute = counted
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tickets = [server.submit(a, corr_id=name) for name, a in requests]
        results = [server.result(t, timeout=600) for t in tickets]
        served_s = time.perf_counter() - t0
        stats = server.stats()
        gaps = latency_block(server.scheduler.inter_wu_gaps_s, digits=6)
    finally:
        server.close()
        steptime.finish(0)
    torch.cuda.synchronize()
    end_delta = torch.cuda.memory_allocated() - base

    wus = []
    for (name, a), r in zip(requests, results):
        w = per_wu[r.name]
        wus.append(dict(
            request=name, code=r.code, wall_s=r.wall_s, prepare_s=r.prepare_s, recompiles=r.recompiles,
            step_cache_hits=r.step_cache_hits, step_cache_misses=r.step_cache_misses, **w,
        ))
        if name == "serve_missing":
            check(r.code == RADPUL_EIO, f"the missing input gave {r.code}, not RADPUL_EIO: {r.error}")
            continue
        check(r.ok, f"served {name} failed: {r.code} {r.error}")
        check(r.recompiles == 0, f"served {name} built kernels or planned cuFFT after warm-up: {r.recompiles}")
        check(r.step_cache_hits >= 1 and r.step_cache_misses == 0, f"served {name} missed the step cache")
        for k in UNWHITENED_PATH:
            check(w["launches"][k] > 0, f"kernel {k} was not launched by served {name}")
        check(w["launches"]["serial_mean"] == 1, f"served {name} took the exact mean {w['launches']['serial_mean']} times")
        check(abs(w["mem_delta_bytes"]) <= SERVE_MEM_SLACK, f"served {name} left {w['mem_delta_bytes']} bytes on the card")
        rows = _candidate_rows(a.outputfile)
        if name in ("serve_a", "serve_c"):
            check(np.array_equal(rows, unwhite_rows), f"served {name}'s rows differ from phase 5's")
        else:
            rank = _injected_rank(rows[:5], P2, tau2)
            check(rank is not None, f"served {name}: injected template row {INJECT2} not in the top 5")
            wus[-1]["injected_rank"] = rank
    check(stats["step_cache"]["entries"] == 1, f"the step cache holds {stats['step_cache']['entries']} entries")
    check(stats["recompiles_after_warmup"] == 0, "the server built or planned after warm-up")
    check(abs(end_delta) <= SERVE_MEM_SLACK, f"the server left {end_delta} bytes on the card")
    return dict(
        warm=server.warm_report,
        warm_s=warm_s,
        served_s=served_s,
        workunits=wus,
        end_mem_delta_bytes=end_delta,
        wus_per_hour_per_chip=stats["wus_per_hour_per_chip"],
        inter_wu_gap_s={k: gaps[k] for k in ("n", "p50", "p95")},
        stats=stats,
        launches=dict(kernels.launch_counts),
    )


@contextlib.contextmanager
def _env(values: dict):
    """``os.environ`` updated with ``values`` inside the block (a None
    value unsets its variable)."""
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _audit_summary(doc: dict) -> dict:
    """Per lane: each stage's cumulative and introduced max relative error
    against f64, the candidate scores and (f32) the tap proof."""
    out = {}
    for lane, ld in doc["lanes"].items():
        out[lane] = dict(
            stages={
                s["stage"]: {"cumulative": s["max_rel_err"], "introduced": s["introduced_rel_err"],
                             "mean": s["mean_rel_err"]}
                for s in ld["stages"]
            },
            worst_stage=ld["attribution"]["worst_stage"],
            candidates={k: ld["candidates"][k] for k in (
                "recall_at_tol", "jaccard", "rank_stability", "oracle_n", "matched", "boundary", "max_power_rel_err")},
            tap=ld.get("tap"),
        )
    return dict(geometry=doc["geometry"], backend=doc["backend"], lanes=out)


def run_health_precision(torch, geom, bank, workdir: str, wu: str, unwhite_rows, loop_templates_per_s: float) -> dict:
    """Phase (f): numerical health on the command line (batch checks and the
    sentinel probe), its abort on a poisoned fold, its cost, the precision
    audit on the card, and the roofline's attainable rate."""
    from boinc_app_eah_brp_tpu_torch.models import search
    from boinc_app_eah_brp_tpu_torch.ops import kernels
    from boinc_app_eah_brp_tpu_torch.runtime import flightrec, health, precision, roofline
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main as cli_main
    from boinc_app_eah_brp_tpu_torch.runtime.errors import RADPUL_EVAL
    from boinc_app_eah_brp_tpu_torch.tools import precision_audit

    def argv(name, extra=""):
        return (
            f"-i {wu} -o {os.path.join(workdir, name + '.cand')} -t {BANK} -c {os.path.join(workdir, name + '.cpt')} "
            f"-P {PADDING} -f {F0} -A {FA} -B {WINDOW} --batch {BATCH} --device {DEVICE} {extra}"
        ).split()

    out = {}
    # (1) phase 5's run with the batch checks every batch and a checkpoint,
    # so a sentinel probe, after every batch; each probe's records kept
    probes = []
    real_probe = health.SentinelProbe.probe

    def recording(self, where="checkpoint"):
        res = real_probe(self, where)
        probes.append([{k: r[k] for k in ("template", "harmonics", "f0", "rel_err")} for r in res])
        return res

    mfile = os.path.join(workdir, "health.jsonl")
    health.SentinelProbe.probe = recording
    try:
        with _env({health.HEALTH_EVERY_ENV: str(BATCH), "ERP_CHECKPOINT_PERIOD": "0"}):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = cli_main(argv("health", f"--metrics-file {mfile}"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(kernels.launch_counts)
    finally:
        health.SentinelProbe.probe = real_probe
    check(rc == 0, f"the health-on run exited with {rc}")
    check(np.array_equal(_candidate_rows(os.path.join(workdir, "health.cand")), unwhite_rows),
          "the health-on run's rows differ from phase 5's")
    rep = _report(mfile)["metrics"]
    counters = {k: v["value"] for k, v in rep["counters"].items() if k.startswith("health.")}
    gauges = {k: v["value"] for k, v in rep["gauges"].items() if k.startswith("health.")}
    check(counters.get("health.checks", 0) >= 1, f"no batch check ran: {counters}")
    check(counters.get("health.violations", 0) == 0, f"the healthy run raised violations: {counters}")
    check(len(probes) >= 1 and counters.get("health.sentinel_probes") == len(probes), f"probes: {counters}")
    worst = max(r["rel_err"] for p in probes for r in p)
    check(worst < health.tolerance(), f"a sentinel drifted on a healthy card: {worst}")
    check(launches["resample_t1"] > 0, "the sentinel probe did not launch kernel A at T = 1")
    for name in UNWHITENED_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched by the health-on run")
    out["health_run"] = dict(
        wall_s=wall, counters=counters, gauges=gauges, probes=probes, sentinel_max_rel_err=worst,
        rel_err_hist=rep["histograms"].get("health.sentinel_rel_err"), launches=launches,
    )

    # the batch step and the loop with health on against off, in turns
    ts = torch.from_numpy(np.random.default_rng(SEED).normal(0.0, 1.0, geom.n_unpadded).astype(np.float32)).to(DEVICE)
    bank_dev = search.upload_bank(search.bank_params_host(bank.P, bank.tau, bank.psi0, geom.dt), BATCH, DEVICE)
    steps = {
        on: search.BankStep(geom, bank_dev, BATCH, state=search.init_state(geom, DEVICE), with_health=on)
        for on in (False, True)
    }
    step_ms = {"off": [], "on": []}
    for on in (False, True, True, False, False, True):
        step_ms["on" if on else "off"].append(time_ms(torch, lambda: steps[on](ts, 0, len(bank)), 10))
    peak = {}
    for on in (False, True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        steps[on](ts, 0, len(bank))
        torch.cuda.synchronize()
        peak["on" if on else "off"] = torch.cuda.max_memory_allocated() - base
    # the health vector alone, against the direct transcription, on the
    # step's sums shape: bitwise equal (with non-finite and padded slots),
    # and each timed with CUDA events
    W = steps[False].M.shape[1]
    sums = torch.empty((BATCH, 5, W), device=DEVICE).exponential_(generator=torch.Generator(DEVICE).manual_seed(SEED))
    valid = torch.arange(BATCH, device=DEVICE) < BATCH - 3
    poisoned = sums.clone()
    poisoned[1, 2, 7], poisoned[2, 0, 3], poisoned[5, 4, 100] = float("nan"), float("inf"), -float("inf")
    for s_, v_ in ((sums, valid), (poisoned, valid), (poisoned, torch.ones_like(valid))):
        check(
            torch.equal(search.batch_health_vec(s_, v_, steps[False].M), direct_health_vec(s_, v_, steps[False].M)),
            "the health vector differs from its direct transcription",
        )
    vec_ms = {
        "port": time_ms(torch, lambda: search.batch_health_vec(sums, valid, steps[False].M), 20),
        "direct": time_ms(torch, lambda: direct_health_vec(sums, valid, steps[False].M), 20),
    }
    del steps, sums, poisoned
    loop_s = {"off": [], "on": []}
    for on in (False, True, True, False):
        with _env({health.HEALTH_EVERY_ENV: str(BATCH if on else 0)}):
            t0 = time.perf_counter()
            search.run_bank(ts, bank.P, bank.tau, bank.psi0, geom, batch_size=BATCH)
            torch.cuda.synchronize()
            loop_s["on" if on else "off"].append(time.perf_counter() - t0)
    del ts, bank_dev
    torch.cuda.empty_cache()
    out["cost"] = dict(
        step_ms=step_ms, step_peak_bytes=peak, loop_s=loop_s, health_vec_ms=vec_ms,
        # autobatch's memory model of a step: 3.04 x nsamples x 4 bytes a template
        autobatch_model_bytes=3.04 * geom.nsamples * 4 * BATCH,
    )

    # (2) a NaN-poisoned fold under abort: RADPUL_EVAL and a black box
    bb = os.path.join(workdir, "blackbox")
    os.makedirs(bb)
    real_fold = search.fold_batch
    search.fold_batch = lambda *a, **k: real_fold(*a, **k) * float("nan")
    try:
        env = {health.HEALTH_EVERY_ENV: str(BATCH), health.HEALTH_ACTION_ENV: "abort", "ERP_BLACKBOX_DIR": bb}
        with _env(env):
            rc = cli_main(argv("poisoned"))
    finally:
        search.fold_batch = real_fold
    check(rc == RADPUL_EVAL, f"the poisoned run exited with {rc}, not RADPUL_EVAL")
    check(not os.path.exists(os.path.join(workdir, "poisoned.cand")), "the poisoned run wrote a result")
    dumps = sorted(glob.glob(os.path.join(bb, "erp-blackbox-*.json")))
    check(len(dumps) >= 1, "the health abort left no black-box dump")
    with open(dumps[-1]) as f:
        doc = json.load(f)
    check(flightrec.validate_dump(doc) == [], "the black-box dump does not validate")
    violations = [e for e in flightrec.events_from_dump(doc) if e.get("kind") == "health-violation"]
    check(violations, "the black-box dump holds no health-violation event")
    out["abort"] = dict(rc=rc, dump=os.path.basename(dumps[-1]), violation=violations[0])

    # (3) the precision audit on the card: the CI fixture, gated on the
    # committed baseline (it names the CPU backend; its ceilings and floors
    # are applied to the card's audit without that key), and 2^20 samples
    with open(os.path.join(REPO, "PRECISION_BASELINE.json")) as f:
        baseline = json.load(f)
    baseline.pop("backend")
    audits = {}
    kernels.reset_launch_counts()
    for name, n in (("ci", precision.CI_SAMPLES), ("n2e20", 1 << 20)):
        t0 = time.perf_counter()
        doc = precision_audit.fresh_audit(("f32", "bf16"), DEVICE, n)
        audit_s = time.perf_counter() - t0
        check(precision.validate_precision_audit(doc) == [], f"the {name} audit does not validate")
        tap = doc["lanes"]["f32"]["tap"]
        check(tap["byte_identical"] and tap["recompiles_in_window"] == 0, f"the {name} audit's tap proof failed: {tap}")
        if name == "ci":
            problems = precision.evaluate_baseline(doc, baseline)
            check(not problems, f"the card's audit fails PRECISION_BASELINE.json: {problems}")
        audits[name] = dict(seconds=audit_s, **_audit_summary(doc))
    audit_launches = dict(kernels.launch_counts)
    check(audit_launches["fold"] > 0, "the audit did not launch kernel C's float-power entry")
    out["audits"] = audits
    out["audit_launches"] = audit_launches

    # (4) the roofline's attainable rate against the whitened loop at batch 32
    out["roofline"] = roofline.roofline_report(
        geom.nsamples, geom.n_unpadded, geom.fund_hi, geom.harm_hi, batch=BATCH,
        measured_templates_per_sec=loop_templates_per_s, card=torch.cuda.get_device_name(0),
    )
    return out


def _hold_exact_sin(torch, name, got, want, params, n, dt) -> int:
    """Kernel against plain version, exact-sine: bitwise expected; else the
    count of differing samples, each of which must lie in the tie band of
    the CPU tests (``ops/resample.py::sine_ties``).  Returns the count."""
    if all(torch.equal(a, b) for a, b in zip(got, want)):
        return 0
    from boinc_app_eah_brp_tpu_torch.ops.resample import sine_ties

    flips = (got[0] != want[0]).cpu().numpy()
    band = sine_ties([p.cpu().numpy() for p in params.T], n, dt)
    print(json.dumps({"exact_sin_flips": {"kernel": name, "samples": int(flips.sum()), "band": int(band.sum())}}))
    check(not (flips & ~band).any(), f"{name}: samples differ from the plain version outside the sine ties")
    return int(flips.sum())


def check_exact_sin(torch, dev, geom, bank, samples, measured: dict) -> dict:
    """Phase (g1): the exact-sine instantiations of kernel A (T = 32 and 1)
    and of the exact mean against their plain versions at the production
    width, timed beside the LUT launches of phase 3, with their bounds;
    then the same launches on a bank of orbits below 16 ms, whose phases
    pass sinf's slow-reduction threshold.  Adds the three kernel rows to
    ``measured``."""
    from boinc_app_eah_brp_tpu_torch.models import search
    from boinc_app_eah_brp_tpu_torch.ops import resample
    from boinc_app_eah_brp_tpu_torch.runtime import roofline

    n = geom.n_unpadded
    kw = dict(n_unpadded=n, dt=geom.dt, exact_sin=True)
    ts = torch.from_numpy(np.random.default_rng(SEED).normal(0.0, 1.0, n).astype(np.float32)).to(dev)
    ts_u = torch.from_numpy(samples).to(dev)
    rng = np.random.default_rng(SEED + 2)
    banks = {
        "bank200": (bank.P, bank.tau, bank.psi0),
        # orbits of 4-15 ms (light companions): every phase past 105,615 rad
        # after 67-250 s of the 274.6 s series
        "short_P": (np.linspace(4e-3, 15e-3, BATCH), np.linspace(1e-5, 3e-4, BATCH), rng.uniform(0, 2 * np.pi, BATCH)),
    }
    out, flips = {}, {}
    for bname, (P, tau, psi0) in banks.items():
        allp = resample.stream_params(*search.bank_params_host(P, tau, psi0, geom.dt), device=dev)
        for name, p_ in (("resample_exact", allp[:BATCH]), ("resample_t1_exact", allp[17:18].contiguous())):
            got = resample.resample_stream(ts, p_, **kw)
            want = resample.resample_stream_plain(ts, p_, **kw)
            torch.cuda.synchronize()
            flips[f"{bname}/{name}"] = _hold_exact_sin(torch, name, got, want, p_, n, geom.dt)
            slow = roofline.sine_slow_samples(p_[:, 1].cpu().numpy(), p_[:, 2].cpu().numpy(), n, geom.dt)
            row = dict(
                max_abs_err=max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want)),
                ms=time_ms(torch, lambda: resample.resample_stream(ts, p_, **kw), 20 if p_.shape[0] > 1 else 50),
                plain_ms=time_ms(torch, lambda: resample.resample_stream_plain(ts, p_, **kw), 3),
                library_ms=None,
                slow_samples=slow,
                **roofline.resample_cost(p_.shape[0], n, exact_sin=True, slow_samples=slow).bound(),
            )
            del got, want
            out[f"{bname}/{name}"] = row
        # the exact mean of the unwhitened workunit: bank200's 200 templates
        # (as the main path takes them, in one launch), the short orbits' 32
        got = resample.exact_mean_params(ts_u, allp, **kw)
        t0 = time.perf_counter()
        want = resample.exact_mean_params_plain(ts_u, allp, **kw)
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(got[0], want[0]), f"exact-sine exact mean kernel != plain version (n_steps, {bname})")
        check(
            torch.equal(got[1].view(torch.int32), want[1].view(torch.int32)),
            f"exact-sine exact mean kernel != plain version (mean, {bname})",
        )
        ns_a = torch.cat([resample.resample_stream(ts_u, allp[s : s + BATCH].contiguous(), **kw)[1]
                          for s in range(0, allp.shape[0], BATCH)])
        check(torch.equal(got[0], ns_a), f"exact-sine exact mean n_steps != kernel A's ({bname})")
        slow = roofline.sine_slow_samples(allp[:, 1].cpu().numpy(), allp[:, 2].cpu().numpy(), n, geom.dt)
        out[f"{bname}/serial_mean_exact"] = dict(
            max_abs_err=float((got[1] - want[1]).abs().max()),
            ms=time_ms(torch, lambda: resample.exact_mean_params(ts_u, allp, **kw), 3),
            plain_ms=plain_ms,
            library_ms=None,
            slow_samples=slow,
            **roofline.exact_mean_cost(n, got[0].cpu().numpy(), exact_sin=True, slow_samples=slow).bound(),
        )
    for name in EXACT_SIN:
        measured[name] = out[f"bank200/{name}"]
    lut = {"resample_exact": "resample", "resample_t1_exact": "resample_t1", "serial_mean_exact": "serial_mean"}
    return dict(
        flips=flips,
        ms={k: v["ms"] for k, v in out.items()},
        bound_ms={k: v["bound_ms"] for k, v in out.items()},
        slow_samples={k: v["slow_samples"] for k, v in out.items()},
        lut_ms={v: measured[v]["ms"] for v in lut.values()},
    )


def run_exact_sin_cli(torch, workdir: str, wu: str, P_inj: float, tau_inj: float, unwhite_rows) -> dict:
    """Phase (g1): phase 5's command line with ``--exact-sin``, the batch
    checks and a checkpoint (so a sentinel probe, whose one-template search
    is A1) every batch, counts reset just before and read just after: the
    exact-sine kernels run and the LUT ones do not; the injected template
    is among the candidates."""
    from boinc_app_eah_brp_tpu_torch.ops import kernels
    from boinc_app_eah_brp_tpu_torch.runtime import health
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main as cli_main

    cand = os.path.join(workdir, "exact_sin.cand")
    argv = (
        f"-i {wu} -o {cand} -t {BANK} -c {os.path.join(workdir, 'exact_sin.cpt')} -P {PADDING} -f {F0} -A {FA} "
        f"-B {WINDOW} --batch {BATCH} --device {DEVICE} --exact-sin"
    ).split()
    with _env({health.HEALTH_EVERY_ENV: str(BATCH), "ERP_CHECKPOINT_PERIOD": "0"}):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
    check(rc == 0, f"the --exact-sin run exited with {rc}")
    for name in EXACT_SIN_PATH:
        check(launches[name] > 0, f"kernel {name} was not launched by the --exact-sin run")
    for name in ("resample", "resample_t1", "serial_mean"):
        check(launches[name] == 0, f"the --exact-sin run launched the LUT kernel {name}")
    rows = _candidate_rows(cand)
    rank = _injected_rank(rows, P_inj, tau_inj)
    check(rank is not None, f"injected template (P={P_inj}, tau={tau_inj}) not among the --exact-sin candidates")
    n = min(len(rows), len(unwhite_rows))
    differ = int((rows[:n] != unwhite_rows[:n]).any(axis=1).sum()) + abs(len(rows) - len(unwhite_rows))
    return dict(wall_s=wall, injected_rank=rank, n_candidates=len(rows), rows_differing_from_lut=differ,
                launches=launches)


def run_sharded(torch, geom, bank, workdir: str, wu: str, zap: str, unwhite_rows) -> dict:
    """Phase (g2): run_bank_sharded over one and over SHARDS shards on
    cuda:0 (a mesh that repeats the card) on the production workunit,
    whitened and unwhitened: (M, T) bitwise run_bank's, each loop's
    templates/s beside run_bank's, counts reset just before each; then the
    command line with --mesh 1 (phase 5's rows) and --mesh 2 (RADPUL_EVAL
    on a one-card machine)."""
    from boinc_app_eah_brp_tpu_torch.io import read_workunit, read_zaplist
    from boinc_app_eah_brp_tpu_torch.models.search import run_bank
    from boinc_app_eah_brp_tpu_torch.ops import kernels
    from boinc_app_eah_brp_tpu_torch.ops.whiten import whiten_and_zap
    from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
    from boinc_app_eah_brp_tpu_torch.parallel import make_mesh, run_bank_sharded
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main as cli_main
    from boinc_app_eah_brp_tpu_torch.runtime.errors import RADPUL_EVAL

    wu_data = read_workunit(wu)
    cfg = SearchConfig(f0=F0, padding=PADDING, fA=FA, window=WINDOW, white=True)
    derived = DerivedParams.derive(wu_data.nsamples, float(wu_data.header["tsample"]), cfg)
    series = {
        "whitened": (geom, whiten_and_zap(wu_data.samples, derived, cfg, read_zaplist(zap), device=DEVICE)),
        "unwhitened": (dataclasses.replace(geom, exact_mean=True), torch.from_numpy(wu_data.samples).to(DEVICE)),
    }
    out = {}
    for kind, (g, ts) in series.items():
        runs = {"run_bank": lambda: run_bank(ts, bank.P, bank.tau, bank.psi0, g, batch_size=BATCH)}
        for k in (1, SHARDS):
            mesh = make_mesh(devices=[DEVICE] * k)
            runs[f"mesh{k}"] = lambda mesh=mesh: run_bank_sharded(
                ts, bank.P, bank.tau, bank.psi0, g, mesh, per_device_batch=BATCH
            )
        ref, res = None, {}
        for name in ("run_bank", "mesh1", f"mesh{SHARDS}", f"mesh{SHARDS}", "mesh1", "run_bank"):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            M, T = runs[name]()
            torch.cuda.synchronize()
            dt_s = time.perf_counter() - t0
            if ref is None:
                ref = (M.clone(), T.clone())
            check(torch.equal(M, ref[0]) and torch.equal(T, ref[1]), f"{kind} {name}: (M, T) differs from run_bank's")
            r = res.setdefault(name, {"templates_per_s": [], "launches": dict(kernels.launch_counts)})
            r["templates_per_s"].append(len(bank) / dt_s)
        for name, r in res.items():
            for k in (UNWHITENED_PATH if kind == "unwhitened" else SEARCH_PATH):
                check(r["launches"][k] > 0, f"{kind} {name} did not launch {k}")
        out[kind] = res
        del ts
    torch.cuda.empty_cache()

    def cli(name, extra):
        return cli_main((
            f"-i {wu} -o {os.path.join(workdir, name + '.cand')} -t {BANK} -c {os.path.join(workdir, name + '.cpt')} "
            f"-P {PADDING} -f {F0} -A {FA} -B {WINDOW} --batch {BATCH} --device {DEVICE} {extra}"
        ).split())

    check(cli("mesh1", "--mesh 1") == 0, "the --mesh 1 run failed")
    check(np.array_equal(_candidate_rows(os.path.join(workdir, "mesh1.cand")), unwhite_rows),
          "the --mesh 1 run's rows differ from phase 5's")
    rc = cli("mesh2", "--mesh 2")
    check(rc == RADPUL_EVAL, f"--mesh 2 on a one-card machine exited with {rc}, not RADPUL_EVAL")
    out["cli"] = {"mesh1_rows_equal": True, "mesh2_rc": rc}
    return out


def _wait_for_shard_commit(shard_dir: str, shard: int, proc, timeout_s: float) -> None:
    """Until ``lease-<shard>.json`` records committed progress inside its
    range; fails if the owner exits first or the time runs out."""
    path = os.path.join(shard_dir, f"lease-{shard}.json")
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                doc = json.load(f)
            if not doc["complete"] and doc.get("state_path") and doc["n_done"] > doc["start"]:
                return
        except (OSError, ValueError, KeyError):
            pass
        check(proc.poll() is None, f"process {shard} exited ({proc.returncode}) before its first shard commit")
        time.sleep(0.05)
    raise CheckFailed(f"process {shard} made no shard commit in {timeout_s} s")


def run_elastic(workdir: str, wu: str, unwhite_rows) -> dict:
    """Phase (g3): N_HOSTS ``python -m boinc_app_eah_brp_tpu_torch``
    processes on the one card run phase 5's command line as one elastic
    search (one shard board, commits every batch); process VICTIM wedges at
    its second batch (an injected dispatch hang) after its first shard
    commit and is killed with SIGKILL.  The survivors must adopt its shard
    and exit 0, exactly one must write the candidate file, with phase 5's
    rows.  Prints each process's wall, kernel launches, adoptions and peak
    device memory from its run report."""
    # the run directory phase (j3)'s fleet timeline assembles: the shard
    # board and each process's host trace
    edir = os.path.join(workdir, "elastic")
    shard_dir = os.path.join(edir, "shards")
    os.makedirs(edir)
    base = dict(
        os.environ, PYTHONPATH=REPO, ERP_NUM_PROCESSES=str(N_HOSTS), ERP_SHARD_DIR=shard_dir,
        ERP_LEASE_TIMEOUT_S=str(LEASE_TIMEOUT_S), ERP_LEASE_GRACE_S="120", ERP_SHARD_COMMIT_S="0",
        ERP_ELASTIC_WAIT_S="600",
    )
    procs, logs, t_start, t_end = {}, [], {}, {}
    try:
        for h in range(N_HOSTS):
            env = dict(base, ERP_PROCESS_ID=str(h), ERP_METRICS_FILE=os.path.join(workdir, f"elastic{h}.jsonl"),
                       ERP_TRACE_FILE=os.path.join(edir, f"trace-host{h}.jsonl"))
            if h == VICTIM:
                env.update(ERP_FAULT_SPEC="dispatch:hang@n=2", ERP_FAULT_HANG_S="900")
            argv = (
                f"-i {wu} -o {os.path.join(workdir, f'elastic{h}.cand')} -t {BANK} "
                f"-c {os.path.join(workdir, f'elastic{h}.cpt')} -P {PADDING} -f {F0} -A {FA} -B {WINDOW} "
                f"--batch {BATCH} --device {DEVICE}"
            ).split()
            logs.append(open(os.path.join(workdir, f"elastic{h}.log"), "w"))
            t_start[h] = time.perf_counter()
            procs[h] = subprocess.Popen(
                [sys.executable, "-m", "boinc_app_eah_brp_tpu_torch", *argv], env=env, cwd=workdir,
                stdout=subprocess.DEVNULL, stderr=logs[-1], start_new_session=True,
            )
        _wait_for_shard_commit(shard_dir, VICTIM, procs[VICTIM], 300)
        os.killpg(procs[VICTIM].pid, signal.SIGKILL)
        procs[VICTIM].wait(timeout=60)
        t_end[VICTIM] = time.perf_counter()
        deadline = time.monotonic() + 600
        while len(t_end) < N_HOSTS and time.monotonic() < deadline:
            for h, p in procs.items():
                if h not in t_end and p.poll() is not None:
                    t_end[h] = time.perf_counter()
            time.sleep(0.05)
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        for f in logs:
            f.close()
    for h, p in procs.items():
        if h != VICTIM:
            check(p.returncode == 0, f"elastic process {h} exited with {p.returncode}: "
                  + open(os.path.join(workdir, f"elastic{h}.log")).read()[-2000:])
    written = [h for h in range(N_HOSTS) if os.path.exists(os.path.join(workdir, f"elastic{h}.cand"))]
    check(len(written) == 1 and written[0] != VICTIM, f"candidate files written by {written}, not by one survivor")
    check(np.array_equal(_candidate_rows(os.path.join(workdir, f"elastic{written[0]}.cand")), unwhite_rows),
          "the elastic run's rows differ from phase 5's")
    per = {}
    for h in range(N_HOSTS):
        row = {"wall_s": t_end[h] - t_start[h], "killed": h == VICTIM}
        if h != VICTIM:
            rep = _report(os.path.join(workdir, f"elastic{h}.jsonl"))
            counters = {k: v["value"] for k, v in rep["metrics"]["counters"].items()}
            gauges = {k: v["value"] for k, v in rep["metrics"]["gauges"].items()}
            row.update(
                launches={
                    k.rsplit(".", 1)[1]: int(v) for k, v in gauges.items() if k.startswith("torch.kernel_launches.")
                },
                adoptions=counters.get("resilience.rebalance", 0),
                shards_run=counters.get("elastic.shards_run", 0),
                peak_device_bytes=[d["peak_bytes_in_use"] for d in rep.get("devices", [])],
            )
            for k in UNWHITENED_PATH:
                check(row["launches"].get(k, 0) > 0, f"elastic process {h} did not launch {k}")
        per[h] = row
    adoptions = sum(r.get("adoptions", 0) for r in per.values())
    check(adoptions >= 1, "no survivor adopted the killed process's shard")
    return dict(writer=written[0], adoptions=adoptions, processes=per)


def run_fabric(torch, workdir: str, wu: str, unwhite_rows, serve_b_rows) -> dict:
    """Phase (h1): a ServerBackend on the card, warmed for the unwhitened
    class at BATCH, computes the fabric's two payload references: phase
    5's workunit and phase (e)'s second one.  Counts reset just before.
    Their rows must be phase 5's and phase (e)'s; the backend must make no
    build and no plan after warm-up.  Then one Fabric runs FABRIC_STREAMS
    volunteer streams (every adversary kind, result-report corruption
    and validator crashes armed) over FABRIC_WUS workunits, held to every
    gate of ``tools/fabric_soak.py``."""
    from boinc_app_eah_brp_tpu_torch.fabric import ServerBackend
    from boinc_app_eah_brp_tpu_torch.ops import kernels
    from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
    from boinc_app_eah_brp_tpu_torch.runtime.cli import parse_args
    from boinc_app_eah_brp_tpu_torch.runtime.scheduler import WarmSpec
    from boinc_app_eah_brp_tpu_torch.runtime.session import Session
    from boinc_app_eah_brp_tpu_torch.tools import fabric_soak

    fdir = os.path.join(workdir, "fabric")
    os.makedirs(fdir)

    def args(path, name):
        return parse_args(
            f"-i {path} -o {os.path.join(fdir, name + '.cand')} -t {BANK} -c {os.path.join(fdir, name + '.cpt')} "
            f"-P {PADDING} -f {F0} -A {FA} -B {WINDOW} --batch {BATCH} --device {DEVICE}".split()
        )

    probe = Session(args(wu, "probe")).prepare()
    spec = WarmSpec(probe.geom, BATCH)
    probe.release()
    del probe
    t0 = time.perf_counter()
    backend = ServerBackend(name="smoke-fabric", warm_specs=[spec], device=DEVICE)
    warm_s = time.perf_counter() - t0
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        refs = {
            "A": backend.compute(args(wu, "refA"), corr_id="ref-A"),
            "B": backend.compute(args(os.path.join(workdir, "serve2.bin4"), "refB"), corr_id="ref-B"),
        }
        refs_s = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        stats = backend.stats()
    finally:
        backend.close()
    check(np.array_equal(_candidate_rows(os.path.join(fdir, "refA.cand")), unwhite_rows),
          "the fabric's reference A differs from phase 5's rows")
    check(np.array_equal(_candidate_rows(os.path.join(fdir, "refB.cand")), serve_b_rows),
          "the fabric's reference B differs from phase (e)'s second workunit's rows")
    check(stats["ok"] == 2 and stats["recompiles_after_warmup"] == 0,
          f"the backend built or planned after warm-up, or failed: {stats}")
    for k in UNWHITENED_PATH:
        check(launches[k] > 0, f"kernel {k} was not launched by the fabric's references")
    check(launches["serial_mean"] == 2, f"the references took the exact mean {launches['serial_mean']} times")

    derived = DerivedParams.derive(N_UNPADDED, TSAMPLE_US, SearchConfig(f0=F0, padding=PADDING, fA=FA, window=WINDOW))
    with _env({"ERP_QUORUM_KEY": f"chip-smoke-{os.urandom(8).hex()}"}):
        try:
            soak = fabric_soak.soak(fdir, refs, t_obs=derived.t_obs, streams=FABRIC_STREAMS, n_wus=FABRIC_WUS,
                                    seed=SEED % 1000)
        except fabric_soak.SoakFailed as e:
            raise CheckFailed(f"fabric: {e}") from e
    fleet = soak["fleet"]
    return dict(
        warm_s=warm_s,
        references_s=refs_s,
        launches=launches,
        backend_recompiles_after_warmup=stats["recompiles_after_warmup"],
        backend_wus_per_hour_per_chip=stats["wus_per_hour_per_chip"],
        fabric_wall_s=soak["wall_s"],
        granted_wus_per_hour_per_chip=FABRIC_WUS / (refs_s + soak["wall_s"]) * 3600.0,
        grant_latency_s={k: fleet["grant_latency_s"][k] for k in ("n", "p50", "p95", "max")},
        validation_latency_s={k: fleet["validation_latency_s"][k] for k in ("p50", "p95")},
        replica_overhead=fleet["reissue_overhead"],
        adversaries=fleet["adversaries"],
        summary=soak["summary"],
        verdicts=soak["verdicts"],
        backend=stats,
    )


def run_kill_resume(workdir: str, wu: str) -> dict:
    """Phase (h2): ``tools/chaos_soak.py``'s kill/resume soak on phase 5's
    workunit at KILL_BATCH with a checkpoint every batch: KILL_CYCLES
    SIGKILL/SIGTERM cycles with checkpoint-write EIO armed, the live
    checkpoint corrupted once (the resume must fall back a generation),
    and a final run byte-identical to the uninterrupted one."""
    from boinc_app_eah_brp_tpu_torch.tools import _inputs, chaos_soak

    kdir = os.path.join(workdir, "kill_resume")
    os.makedirs(kdir)

    def make(out, cp):
        return _inputs.cli_cmd(wu, BANK, out, cp, "-P", str(PADDING), "-f", str(F0), "-A", str(FA), "-B",
                               str(WINDOW), "--batch", str(KILL_BATCH), "--device", DEVICE)

    t0 = time.perf_counter()
    try:
        out = chaos_soak.kill_resume(kdir, make, cycles=KILL_CYCLES, seed=SEED % 1000, timeout_s=300)
    except chaos_soak.SoakFailed as e:
        raise CheckFailed(f"kill/resume: {e}") from e
    check(out["corrupted"] and out["fallback_seen"], "the corrupt-checkpoint fallback was not exercised")
    check(sum(1 for r in out["runs"] if r["resumed_at"]) >= KILL_CYCLES - 1 and out["final"]["resumed_at"],
          f"the runs did not resume from their checkpoints: {out['runs']}, {out['final']}")
    return dict(batch=KILL_BATCH, wall_s=time.perf_counter() - t0, **out)


def run_bench_tool(workdir: str) -> dict:
    """Phase (i1): the port's bench through its orchestrator, at the
    autobatch's batch (with the host trace, so the payload carries its
    stall table) and at BENCH_BATCH=32."""
    import torch

    out = {}
    for name, env in (
        ("autobatch", {"ERP_TRACE_FILE": os.path.join(workdir, "bench.trace.jsonl")}),
        ("batch32", {"BENCH_BATCH": "32"}),
    ):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "boinc_app_eah_brp_tpu_torch.tools.bench"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, **env), capture_output=True, text=True, timeout=900,
        )
        wall = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
        check(proc.returncode == 0 and len(lines) == 1,
              f"the bench ({name}) exited {proc.returncode} with {len(lines)} lines: {proc.stdout[-500:]} {proc.stderr[-2000:]}")
        payload = json.loads(lines[0])
        with open(os.path.join(workdir, "bench_lines.jsonl"), "a") as f:  # phase (j3)'s bench_history reads them
            f.write(lines[0] + "\n")
        check(payload.get("backend") == "cuda" and (payload.get("value") or 0) > 0
              and payload.get("card") == torch.cuda.get_device_name(0),
              f"the bench's payload ({name}) is not a measurement on this card: {lines[0][:500]}")
        check(payload["unit"] == "templates/sec" and payload["metric"].startswith("orbital templates/sec/chip"),
              f"the bench's metric ({name}) is not the JAX bench's: {payload['metric']}")
        out[name] = dict(payload, orchestrator_wall_s=wall)
        print(json.dumps({f"bench_{name}": out[name]}), flush=True)
    check(out["batch32"]["batch"] == 32, f"BENCH_BATCH=32 ran batch {out['batch32']['batch']}")
    return out


def _first_drain_after(spans, t_us: float):
    """The first main-lane ``drain`` span that starts at or after ``t_us``."""
    drains = [s for s in spans if s["name"] == "drain" and s.get("tid") == "MainThread" and s["ts_us"] >= t_us]
    return min(drains, key=lambda s: s["ts_us"]) if drains else None


def _production_run(files: dict, templates: int, name: str, white: bool) -> dict:
    """One run of the bench's production problem (``files``, from
    ``bench.write_problem``, ``templates`` of them) by the command line in a subprocess at the
    default batch, with the metrics report and the host trace; the
    rescoring split from the trace (``tools/trace_report.py``) and the run
    report.  A card session takes every winner's spectrum on the card."""
    from boinc_app_eah_brp_tpu_torch.tools import trace_report

    pdir = os.path.dirname(files["wu"])
    cand, mfile = os.path.join(pdir, f"{name}.cand"), os.path.join(pdir, f"{name}.metrics.jsonl")
    trace = os.path.join(pdir, f"{name}.trace.jsonl")
    args = [a for a in files["args"] if white or a != "-W"] + (["-l", files["zap"]] if white else [])
    argv = [sys.executable, "-m", "boinc_app_eah_brp_tpu_torch", "-i", files["wu"], "-o", cand, "-t", files["bank"],
            "-c", os.path.join(pdir, f"{name}.cpt"), *args, "--metrics-file", mfile, "--device", DEVICE]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=pdir, env=dict(os.environ, PYTHONPATH=REPO, ERP_TRACE_FILE=trace),
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    check(proc.returncode == 0, f"the production run ({name}) exited {proc.returncode}: {log[-3000:]}")
    text = open(cand).read()
    lines = [ln for ln in text.splitlines() if ln and not ln.startswith("%")]
    check(text.endswith("%DONE%\n") and all(len(ln.split()) == 7 for ln in lines),
          f"the production run's ({name}) candidate file is malformed")
    # the synthetic workunit is noise: unwhitened, no template clears
    # the threshold (so on the CPU at 2^16 samples too); an empty
    # candidate file is a valid result
    check(len(lines) <= 100 and (len(lines) > 0 or not white),
          f"the production run ({name}) wrote {len(lines)} candidates")
    report = _report(mfile)
    phases = report["metrics"]["phases"]
    counters = {k: v["value"] for k, v in report["metrics"]["counters"].items()}
    check(counters.get("rescore.device_ffts", 0) == counters.get("rescore.templates", 0),
          f"the production run ({name}) took a spectrum off the card: {counters}")
    loaded = trace_report.load_trace(trace)
    table = trace_report.stall_table(loaded)
    # the loop on the card: from the loop's first enqueue to the end of
    # the first drain after the last one (the final checkpoint's copy)
    loop = next(s for s in loaded["spans"] if s["name"] == "template loop")
    drain = _first_drain_after(loaded["spans"], loop["end_us"])
    check(drain is not None, f"no drain after the production run's ({name}) loop")
    loop_s = (drain["end_us"] - loop["ts_us"]) / 1e6
    rescored = [ln.strip() for ln in log.splitlines() if "winning templates through the oracle" in ln]
    return dict(
        wall_s=wall,
        batch=report["metrics"]["gauges"]["autobatch.batch_size"]["value"],
        loop_s=loop_s,
        loop_templates_per_s=templates / loop_s,
        n_candidates=len(lines),
        rescore_end_pass_s=phases.get("oracle rescore", {}).get("wall_s", 0.0),
        rescored_line=rescored[-1] if rescored else None,
        whitening_s=phases.get("whitening", {}).get("wall_s"),
        trace_coverage=table["coverage"],
        stall_categories={k: v["self_s"] for k, v in table["categories"].items()},
    )


def run_production(workdir: str) -> dict:
    """Phase (i2): the bench's production problem written to disk and run
    by the command line, whitened and unwhitened (:func:`_production_run`)."""
    from boinc_app_eah_brp_tpu_torch.tools import bench

    pdir = os.path.join(workdir, "production")
    t0 = time.perf_counter()
    problem = bench.synthetic_problem()
    files = bench.write_problem(problem, pdir)
    out = {"problem_s": time.perf_counter() - t0, "templates": len(problem.P), "cpu_count": os.cpu_count(),
           "files": files}
    for name, white in (("whitened", True), ("unwhitened", False)):
        out[name] = _production_run(files, len(problem.P), name, white)
        print(json.dumps({f"production_{name}": out[name]}), flush=True)
    return out


def run_bundle(workdir: str) -> dict:
    """Phase (i3): the deployment bundle built from this run's kernel
    libraries into a directory outside the repository, and its
    ``erp_wrapper`` running the zipapp worker there on phase 4's whitened
    command line, with no ``PYTHONPATH`` and no kernel or median
    directory in the environment: with ``ERP_MEDIAN`` unset (the bundle's
    median kernel), then under ``ERP_MEDIAN=native`` (the bundle's
    ``liberp_rngmed.so``)."""
    import tempfile

    from boinc_app_eah_brp_tpu_torch.tools import make_bundle

    bdir = tempfile.mkdtemp(prefix="erp-bundle-")
    try:
        t0 = time.perf_counter()
        names = make_bundle.make_bundle(bdir)
        bundle_s = time.perf_counter() - t0
        base = {k: v for k, v in os.environ.items()
                if k not in ("PYTHONPATH", "ERP_KERNEL_DIR", "ERP_RNGMED_LIB", "ERP_MEDIAN")}

        def row_text(path):
            return [ln for ln in open(path).read().splitlines() if ln and not ln.startswith("%")]

        def worker(name: str, extra: dict):
            env = {**base, **extra, "ERP_METRICS_FILE": os.path.join(bdir, f"{name}.metrics.jsonl")}
            stderr_file = os.path.join(bdir, f"{name}.stderr.txt")  # the wrapper's, relative to bdir
            argv = [
                os.path.join(bdir, "erp_wrapper"), "--worker", BUNDLE_WORKER,
                "-i", os.path.join(workdir, "smoke.bin4"), "-o", f"{name}.cand", "-c", f"{name}.cpt", "-t", BANK,
                "-l", os.path.join(workdir, "smoke.zap"), "-W", "-P", str(PADDING), "-f", str(F0), "-A", str(FA),
                "-B", str(WINDOW), "--batch", str(BATCH), "--stderr-file", f"{name}.stderr.txt",
                "--shmem", os.path.join(bdir, f"{name}.shm"),
            ]
            t0 = time.perf_counter()
            proc = subprocess.run(argv, cwd=bdir, env=env, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            archive = open(stderr_file).read() if os.path.exists(stderr_file) else ""
            check(proc.returncode == 0,
                  f"the bundle's wrapper ({name}) exited {proc.returncode}: {proc.stderr[-2000:]} {archive[-2000:]}")
            cand = os.path.join(bdir, f"{name}.cand")
            _candidate_rows(cand)
            check(row_text(cand) == row_text(os.path.join(workdir, "smoke.cand")),
                  f"the bundle's candidate rows ({name}) differ from phase 4's")
            report = _report(env["ERP_METRICS_FILE"])
            counters = {k: v["value"] for k, v in report["metrics"]["counters"].items()}
            gauges = {k: v["value"] for k, v in report["metrics"]["gauges"].items()}
            check(counters.get("torch.kernel_builds") == 0,
                  f"the bundle's worker ({name}) did not record 0 kernel builds: {counters.get('torch.kernel_builds')}")
            return wall, archive + proc.stdout, counters, gauges

        wall, _, counters, gauges = worker("out", {})
        launches = {k: gauges.get(f"torch.kernel_launches.{k}", 0) for k in MAIN_PATH}
        for k, n in launches.items():
            check(n > 0, f"kernel {k} was not launched by the bundle's worker")
        # on the card the whitening takes the bundle's median kernel, not the host median
        check(gauges.get("torch.kernel_launches.median") == 1 and counters.get("whiten.device_medians") == 1,
              f"the bundle's worker did not whiten with the bundle's median kernel: launches "
              f"{gauges.get('torch.kernel_launches.median')}, whiten.device_medians {counters.get('whiten.device_medians')}")
        # ERP_MEDIAN=native takes the host median from the bundle's library
        native_wall, log, counters, gauges = worker("native", {"ERP_MEDIAN": "native"})
        check(f"Running median library: {os.path.join(bdir, 'liberp_rngmed.so')}" in log,
              "the bundle's worker under ERP_MEDIAN=native did not load the bundle's median")
        check(not gauges.get("torch.kernel_launches.median") and not counters.get("whiten.device_medians"),
              f"the bundle's worker under ERP_MEDIAN=native launched the median kernel: launches "
              f"{gauges.get('torch.kernel_launches.median')}, whiten.device_medians {counters.get('whiten.device_medians')}")
        return dict(bundle_s=bundle_s, files=names, wall_s=wall, native_wall_s=native_wall, kernel_builds=0,
                    launches=launches, rows_equal_phase4=True)
    finally:
        shutil.rmtree(bdir, ignore_errors=True)


def _tool(argv: list, name: str, out_dir: str) -> subprocess.CompletedProcess:
    """``python -m boinc_app_eah_brp_tpu_torch.tools.<argv[0]> argv[1:]``,
    its output kept in ``out_dir/<name>.out``; fails on a non-zero exit."""
    proc = subprocess.run([sys.executable, "-m", f"boinc_app_eah_brp_tpu_torch.tools.{argv[0]}", *argv[1:]],
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=600)
    with open(os.path.join(out_dir, f"{name}.out"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f"{' '.join(argv)} exited {proc.returncode}: {proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    return proc


def run_smoke_gate(workdir: str, wu: str) -> dict:
    """Phase (j1): ``tools/smoke.py``'s default gate on phase 4's workunit
    and bank200 at the production width (padding 3, f0 400 Hz, ``-A
    0.08``, window 1000, batch 32), on the card: every check of the gate,
    and A, B, C and the exact mean launched (the run report's gauges)."""
    from boinc_app_eah_brp_tpu_torch.tools import smoke

    gdir = os.path.join(workdir, "smoke_gate")
    os.makedirs(gdir)
    try:
        res = smoke.gate(gdir, wu, BANK, window=WINDOW, batch=BATCH, device=DEVICE,
                         search_args=("-P", str(PADDING), "-f", str(F0), "-A", str(FA)))
    except smoke.SmokeFailed as e:
        raise CheckFailed(f"(j1) the smoke gate: {e}") from None
    for k in UNWHITENED_PATH:
        check(res["launches"].get(k, 0) > 0, f"(j1) the smoke gate's run did not launch {k}")
    return res


def run_step_report(workdir: str, wu: str, measured: dict) -> dict:
    """Phase (j2): ``tools/step_report.py`` on the production problem
    (phase 4's workunit, bank200, unwhitened, window 1000, batch 32) with
    the measured lane, counts reset just before: ``device_lane``
    "measured", each of resample, fftprep, rfft and fold measured above
    0, the document valid under ``report_check``; its stage table beside
    phase 3's ms of A, B, C and the rfft, and the rfft stage's kernels
    (``csrc/rfft.cu``'s two passes)."""
    from boinc_app_eah_brp_tpu_torch.ops import kernels
    from boinc_app_eah_brp_tpu_torch.runtime.driver import DriverArgs
    from boinc_app_eah_brp_tpu_torch.tools import report_check, step_report

    sdir = os.path.join(workdir, "step_report")
    os.makedirs(sdir)

    def args(prefix):
        return DriverArgs(
            inputfile=wu, outputfile=os.path.join(sdir, f"{prefix}.cand"), templatebank=BANK,
            checkpointfile=os.path.join(sdir, f"{prefix}.cpt"), f0=F0, padding=PADDING, fA=FA, window=WINDOW,
            batch_size=BATCH, device=DEVICE,
        )

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        doc = step_report.run(args("warm"), args("wu"), sdir)
    except RuntimeError as e:
        raise CheckFailed(f"(j2) step_report: {e}") from None
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    for k in UNWHITENED_PATH:
        check(launches.get(k, 0) > 0, f"(j2) the step report's sessions did not launch {k}")
    path = os.path.join(sdir, "step_report.json")
    step_report.write_json(path, doc)
    check(report_check.check_path(path) == (step_report.REPORT_SCHEMA, []),
          f"(j2) the step report does not validate: {report_check.check_path(path)}")
    check(doc["device_lane"] == "measured", f"(j2) device_lane is {doc['device_lane']!r}")
    stages = {s["stage"]: s for s in doc["stages"]}
    for name in ("resample", "fftprep", "rfft", "fold_spectrum"):
        check(stages[name]["measured_ms_per_window"] > 0, f"(j2) no measured time for stage {name}")
    device = doc.get("device") or {}
    rfft_kernels = [k for k in device.get("kernels", []) if k["stage"] == "rfft"]
    check(rfft_kernels, "(j2) the rfft stage holds no kernel")
    other = sorted((k for k in device.get("kernels", []) if k["stage"] == "other"), key=lambda k: -k["ms"])
    print(json.dumps({"rfft_kernels": rfft_kernels, "other_kernels": other[:10]}), flush=True)
    print(step_report.render(doc), flush=True)
    # the roofline's stage names; the step's rfft is the power pass and its
    # fold C's float entry
    phase3 = {
        "resample": measured["resample"]["ms"], "fftprep": measured["fftprep"]["ms"],
        "rfft": measured["fft_r2c_power"]["ms"], "fold_spectrum": measured["fold"]["ms"],
    }
    for name, ms in phase3.items():
        print(f"(j2) {name}: measured {stages[name]['measured_ms_per_window']} ms a window "
              f"({doc['measured']['step_ms']['mean']} ms mean step), phase 3 {ms:.4f} ms a call at T = {BATCH}; "
              f"{stages[name]['measured_gb_per_sec']} GB/s at the roofline's bytes", flush=True)
    return dict(
        path=path, wall_s=wall, launches=launches, device_lane=doc["device_lane"], measured=doc["measured"],
        modeled=doc["modeled"], stages=doc["stages"], device={k: v for k, v in device.items() if k != "kernels"},
        rfft_kernels=rfft_kernels, phase3_ms=phase3,
    )


def run_readers(workdir: str, step_json: str) -> dict:
    """Phase (j3): the host readers on what the earlier phases left, each
    through its command line: ``metrics_report`` renders (i2)'s whitened
    run report and diffs it against the unwhitened one,
    ``blackbox_report --check`` the NaN-abort dump of (f),
    ``fleet_timeline --check --min-coverage 0.95 --require-adoption`` the
    elastic run of (g3), and ``bench_history`` (i1)'s bench lines and
    (j2)'s step report."""
    rdir = os.path.join(workdir, "readers")
    os.makedirs(rdir)
    pdir = os.path.join(workdir, "production")
    white, unwhite = (os.path.join(pdir, f"{n}.metrics.jsonl.report.json") for n in ("whitened", "unwhitened"))
    out = {}
    t0 = time.perf_counter()
    text = _tool(["metrics_report", white], "metrics_render", rdir).stdout
    check("Phases:" in text and "template loop" in text, "(j3) metrics_report rendered no phase table")
    out["metrics_render_lines"] = len(text.splitlines())
    text = _tool(["metrics_report", "--diff", white, unwhite], "metrics_diff", rdir).stdout
    out["metrics_diff_rows"] = len(text.splitlines()) - 3
    dumps = sorted(glob.glob(os.path.join(workdir, "blackbox", "erp-blackbox-*.json")))
    check(dumps, "(j3) phase (f) left no black-box dump")
    text = _tool(["blackbox_report", "--check", dumps[-1]], "blackbox_check", rdir).stdout
    _tool(["blackbox_report", dumps[-1]], "blackbox_render", rdir)
    out["blackbox_check"] = text.strip().splitlines()[-1]
    edir = os.path.join(workdir, "elastic")
    text = _tool(["fleet_timeline", edir, "--check", "--min-coverage", "0.95", "--require-adoption"],
                 "fleet_timeline", rdir).stdout
    with open(os.path.join(edir, "fleet-timeline.json")) as f:
        side = json.load(f)
    out["fleet_timeline"] = dict(
        hosts={h: {k: v[k] for k in ("clean", "coverage", "events", "clock_offset_s")} for h, v in side["hosts"].items()},
        adoptions=[{k: a[k] for k in ("shard", "epoch", "from_host", "to_host", "latency_s")} for a in side["adoptions"]],
        gaps=len(side["gaps"]),
    )
    text = _tool(["bench_history", "--bench-lines", os.path.join(workdir, "bench_lines.jsonl"),
                  "--step-reports", step_json, "--json", os.path.join(rdir, "bench_history.json")],
                 "bench_history", rdir).stdout
    check("Port bench lines" in text and "Step reports" in text, "(j3) bench_history showed no port rows")
    out["readers_s"] = time.perf_counter() - t0
    return out


def run_smoke_modes(workdir: str) -> dict:
    """Phase (j4): ``tools/smoke.py --hosts 2`` and ``--fabric`` on the card
    at the smoke's own fixture size, each through its command line; A, B,
    C and the exact mean launched by the hosts (their run reports) and by
    the fabric's reference run (its run report), and the R2C kernel not
    (the fixture's length has no split)."""
    from boinc_app_eah_brp_tpu_torch.tools import smoke

    mdir = os.path.join(workdir, "smoke_modes")
    os.makedirs(mdir)
    out = {}
    for name, argv, reports in (
        ("hosts", ["--hosts", "2"], ["metrics-host0.jsonl", "metrics-host1.jsonl"]),
        ("fabric", ["--fabric"], ["reference.metrics.jsonl"]),
    ):
        t0 = time.perf_counter()
        proc = _tool(["smoke", *argv, "--device", DEVICE, "--workdir", os.path.join(mdir, name)], f"smoke_{name}", mdir)
        last = proc.stdout.strip().splitlines()[-1]
        check(last.startswith("smoke: PASS"), f"(j4) smoke {' '.join(argv)}: {last}")
        launches = {}
        for r in reports:
            for k, n in smoke._launches(_report(os.path.join(mdir, name, r))).items():
                launches[k] = launches.get(k, 0) + n
        # the fixture's 4,096 samples have no split of the port's R2C: its
        # transform is cuFFT's, folded by C's complex entry
        check(not launches.get("fft_r2c") and not launches.get("fft_r2c_power"),
              f"(j4) smoke {' '.join(argv)} launched the R2C kernel")
        for k in ("resample", "fftprep", "fold_spectrum", "serial_mean"):
            check(launches.get(k, 0) > 0, f"(j4) smoke {' '.join(argv)} did not launch {k}")
        out[name] = dict(wall_s=time.perf_counter() - t0, result=last, launches=launches)
    return out


def run_knobs(torch, workdir: str, wu: str, main_run: dict) -> dict:
    """Phase (k): the operator knobs on the card, in-process on phase 4's
    whitened command line (own output and checkpoint files, the metrics
    report and the host trace), counts reset just before each run and read
    just after.  (1) ``ERP_RESCORE=off``: the rows of phase 4's
    unrescored toplist, no rescoring span, phase or counter; (2)
    ``ERP_PRECISION=bf16``
    (``RADPUL_EMISC``: its ``NotImplementedError`` is unmapped, and the
    command line of either package exits so) and ``ERP_PRECISION=xx``
    (``RADPUL_EVAL``) with cuFFT's plan cache emptied first: no kernel
    launch, no plan, no result.  (``ERP_MEDIAN`` is phase (m)'s.)"""
    from boinc_app_eah_brp_tpu_torch.ops import kernels
    from boinc_app_eah_brp_tpu_torch.runtime import tracing
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main as cli_main
    from boinc_app_eah_brp_tpu_torch.runtime.errors import RADPUL_EMISC, RADPUL_EVAL

    zap = os.path.join(workdir, "smoke.zap")
    blackbox = os.path.join(workdir, "knobs.blackbox")
    os.makedirs(blackbox, exist_ok=True)

    def run(name: str, env: dict) -> dict:
        path = os.path.join(workdir, f"knob_{name}")
        argv = (
            f"-i {wu} -o {path}.cand -t {BANK} -c {path}.cpt -l {zap} -W -P {PADDING} -f {F0} -A {FA} "
            f"-B {WINDOW} --batch {BATCH} --device {DEVICE} --metrics-file {path}.metrics.jsonl"
        ).split()
        env = {**env, tracing.TRACE_FILE_ENV: f"{path}.trace.jsonl", "ERP_BLACKBOX_DIR": blackbox}
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with _env(env):
            rc = cli_main(argv)
        torch.cuda.synchronize()
        return dict(rc=rc, wall_s=time.perf_counter() - t0, launches=dict(kernels.launch_counts), path=path)

    def spans(r: dict) -> set:
        with open(r["path"] + ".trace.jsonl") as f:
            return {json.loads(ln).get("name") for ln in f if ln.strip()}

    out = {}
    # (1) ERP_RESCORE=off
    r = run("rescore_off", {"ERP_RESCORE": "off"})
    check(r["rc"] == 0, f"(k1) ERP_RESCORE=off exited {r['rc']}")
    for name in MAIN_PATH:
        check(r["launches"][name] > 0, f"(k1) kernel {name} was not launched")
    names = spans(r)
    check(not any(str(n).startswith("rescore") for n in names), f"(k1) a rescoring span ran: {names}")
    report = _report(r["path"] + ".metrics.jsonl")
    check("oracle rescore" not in report["metrics"]["phases"], "(k1) the oracle rescore phase ran")
    counters = {k: v["value"] for k, v in report["metrics"]["counters"].items() if k.startswith("rescore.")}
    check(not any(counters.values()), f"(k1) rescoring counters moved: {counters}")
    rows = _candidate_rows(r["path"] + ".cand")
    unrescored = _candidate_rows(os.path.join(workdir, "unrescored.cand"))
    check(np.array_equal(rows, unrescored), "(k1) the rows are not phase 4's unrescored toplist")
    rescored = _candidate_rows(os.path.join(workdir, "smoke.cand"))
    same_shape = rows.shape == rescored.shape
    out["rescore_off"] = dict(
        wall_s=r["wall_s"], phase4_wall_s=main_run["wall_s"], phase4_rescore_s=main_run["rescore_s"],
        n_candidates=len(rows), rows_differing_from_phase4=int((rows != rescored).any(axis=1).sum()) if same_shape
        else None, launches=r["launches"],
    )
    # (2) refused modes: nothing launched, nothing planned, no result
    plans = torch.backends.cuda.cufft_plan_cache[0]
    for name, env, want in (
        ("precision_bf16", {"ERP_PRECISION": "bf16"}, RADPUL_EMISC),
        ("precision_xx", {"ERP_PRECISION": "xx"}, RADPUL_EVAL),
    ):
        plans.clear()
        r = run(name, env)
        check(r["rc"] == want, f"(k2) {env} exited {r['rc']}, not {want}")
        check(not any(r["launches"].values()), f"(k2) {env} launched kernels: {r['launches']}")
        check(plans.size == 0, f"(k2) {env} made {plans.size} cuFFT plans")
        check(not os.path.exists(r["path"] + ".cand"), f"(k2) {env} wrote a result")
        out[name] = dict(exit=r["rc"], wall_s=r["wall_s"], plans=0, launches=0)
    return out


GOLDEN = os.path.join(REPO, "tests", "golden")


def run_golden_diff(workdir: str, wu: str, P_inj: float, tau_inj: float) -> dict:
    """Phase (l): phase 4's candidate file held against the JAX package's
    for the same workunit, bank and zaplist, and phase 4's rows against
    (k1)'s unrescored ones, each boundary row with its cause."""
    from boinc_app_eah_brp_tpu_torch.io.validate import _key, compare_candidate_files
    from boinc_app_eah_brp_tpu_torch.tools import _inputs, boundary_analysis, golden_ref

    t0 = time.perf_counter()
    paths = {ext: os.path.join(GOLDEN, f"jax_synth200.{ext}") for ext in ("json", "cand", "cpt")}
    for path in paths.values():
        check(os.path.exists(path), f"(l) the JAX golden {path} is missing")
    with open(paths["json"]) as f:
        side = json.load(f)
    # (1) the inputs are the golden's
    zap = os.path.join(workdir, "smoke.zap")
    digests = {"workunit": _inputs.content_sha256(wu), "bank": _inputs.content_sha256(BANK),
               "zaplist": _inputs.content_sha256(zap)}
    for name, digest in digests.items():
        check(digest == side[name]["sha256"],
              f"(l1) phase 4's {name} has sha256 {digest}, the JAX golden's {side[name]['sha256']}")
    t_obs = golden_ref.padded_t_obs(wu)
    check(t_obs == side["t_obs"], f"(l1) t_obs {t_obs} differs from the golden's {side['t_obs']}")
    # (2) the golden diff
    cand, cp = os.path.join(workdir, "smoke.cand"), os.path.join(workdir, "smoke.cpt")
    summary = golden_ref.compare(paths["cand"], cand, t_obs, bank=BANK)
    diff = compare_candidate_files(paths["cand"], cand, t_obs=t_obs)
    check(summary["ok"] and not (summary["mismatches"] or summary["missing"] or summary["extra"]),
          f"(l2) the golden diff failed: {summary}\n{diff.report()}")
    golden_rows, port_rows = _candidate_rows(paths["cand"]), _candidate_rows(cand)
    rank = _injected_rank(golden_rows, P_inj, tau_inj)
    check(rank is not None, "(l2) the JAX golden holds no row of the injected template")
    inj_key = _key(golden_rows[rank - 1], t_obs)
    golden_by_key = {_key(r, t_obs): r for r in golden_rows}
    port_by_key = {_key(r, t_obs): r for r in port_rows}
    check(inj_key in port_by_key, f"(l2) the injected template's top row {inj_key} is not matched")
    pairs = [(golden_by_key[k], port_by_key[k]) for k in golden_by_key.keys() & port_by_key.keys()]
    closeness = dict(
        rows_equal=sum(bool(np.array_equal(a, b)) for a, b in pairs),
        max_rel_power=float(max(abs(a[4] - b[4]) / max(abs(a[4]), abs(b[4])) for a, b in pairs)),
        max_abs_fA=float(max(abs(a[5] - b[5]) for a, b in pairs)),
    )
    # (3) the boundary rows' causes
    l3 = boundary_analysis.analyse(paths["cand"], cand, paths["cpt"], cp, t_obs)
    l3_causes = _count_causes(l3["boundary"])
    check(set(l3_causes) <= {"cap-cutoff", "dedup"}, f"(l3) boundary causes {l3_causes}: {l3['boundary']}")
    # (4) phase 4's rows against (k1)'s unrescored rows
    k1 = os.path.join(workdir, "knob_rescore_off")
    l4 = boundary_analysis.analyse(cand, k1 + ".cand", cp, k1 + ".cpt", t_obs)
    k1_rows = _candidate_rows(k1 + ".cand")
    rescored = port_by_key
    unrescored = {_key(r, t_obs): r for r in k1_rows}
    boundary = {(e["bin"], e["n_harm"]): e for e in l4["boundary"]}
    d4 = compare_candidate_files(cand, k1 + ".cand", t_obs=t_obs)
    differing = []
    for key in sorted(set(rescored) | set(unrescored)):
        if key in rescored and key in unrescored:
            a, b = rescored[key], unrescored[key]
            if not np.array_equal(a, b):
                moved = {name: [float(a[col]), float(b[col])] for name, col in
                         (("P_b", 1), ("tau", 2), ("psi", 3), ("power", 4), ("fA", 5)) if a[col] != b[col]}
                differing.append(dict(bin=key[0], n_harm=key[1], side="both", cause="rescored", detail=moved,
                                      beyond_tolerance=[m[1] for m in d4.mismatches if m[0] == key]))
            continue
        if key in boundary:
            e = boundary[key]
        else:  # one-sided beyond the validator's tail margin: classified the same way
            here, other, other_cpt = (rescored, unrescored, k1 + ".cpt") if key in rescored else (unrescored, rescored, cp)
            e = dict(bin=key[0], n_harm=key[1], side="outside the tail margin",
                     **boundary_analysis.classify_boundary(key, here, other, t_obs, other_cpt=other_cpt))
        differing.append(dict(bin=key[0], n_harm=key[1], side=e["side"], cause=e["cause"], detail=e["detail"]))
    l4_causes = _count_causes(differing)
    check("threshold" not in l4_causes, f"(l4) a threshold cause between the rescored and unrescored rows: {differing}")
    return dict(
        digests=digests, t_obs=t_obs, golden_versions=side["versions"], golden_median=side["median"],
        numpy=np.__version__, summary=summary, closeness=closeness, boundary_by_cause=l3_causes, boundary=l3["boundary"],
        injected_key=list(inj_key), injected_rank_golden=rank, injected_rank_port=_injected_rank(port_rows, P_inj, tau_inj),
        rescored_vs_unrescored=dict(
            matched=l4["matched"],
            rows_differing_by_position=int((port_rows != k1_rows).any(axis=1).sum())
            if port_rows.shape == k1_rows.shape else None,
            differing=differing, by_cause=l4_causes, boundary_summary=l4["summary"],
        ),
        wall_s=time.perf_counter() - t0,
    )


def phase4_spectrum(torch, wu: str):
    """The power spectrum that phase 4's whitening takes the median of:
    the zero-padded workunit's rfft, |X|^2, DC 0 (``ops/whiten.py``)."""
    from boinc_app_eah_brp_tpu_torch.io import read_workunit
    from boinc_app_eah_brp_tpu_torch.oracle import DerivedParams, SearchConfig
    from boinc_app_eah_brp_tpu_torch.ops.whiten import _forward

    cfg = SearchConfig(f0=F0, padding=PADDING, fA=FA, window=WINDOW, white=True)
    wu_data = read_workunit(wu)
    derived = DerivedParams.derive(wu_data.nsamples, float(wu_data.header["tsample"]), cfg)
    padded = torch.zeros(derived.nsamples, dtype=torch.float32, device=DEVICE)
    padded[: derived.n_unpadded] = torch.from_numpy(np.asarray(wu_data.samples, dtype=np.float32)).to(DEVICE)
    F = _forward(padded)
    ps = F.real * F.real + F.imag * F.imag
    ps[0] = 0.0
    return ps


def _plain_block(window: int) -> int:
    """Outputs a block of the plain median on the card: ~2^26 window entries."""
    return max(1, (1 << 26) // window)


def run_median(torch, workdir: str, wu: str) -> dict:
    """Phase (m): the device running median on phase 4's workunit.  (1)
    the kernel bitwise against its plain version over phase 4's spectrum
    (production width) at windows WINDOW and WINDOW - 1, and at
    MEDIAN_WIDE, above one block's shared memory, over its first
    MEDIAN_WIDE_BINS bins, each timed beside its plain version; the
    library yardstick ``torch.median`` of every odd window (WINDOW - 1) in
    blocks; (2) the kernel against the native rngmed at WINDOW: no output
    differs; (3) phase 4's command line, which took the device median,
    under ``ERP_MEDIAN=native``, then with the knob unset and
    ``$ERP_RNGMED_LIB`` naming a missing file, counts reset just before
    and read just after: exit 0, the search's kernels launched, the host
    median run once and the median kernel not at all (native) or the
    other way round (no library), and each file held against phase 4's by
    ``tools/golden_ref.py::compare`` (``ok``) and its candidate rows byte
    for byte; (4) ``ERP_MEDIAN=native``
    with the missing file: ``RADPUL_EVAL``, no launch, no cuFFT plan, no
    result."""
    from boinc_app_eah_brp_tpu_torch.ops import kernels, median, native_median
    from boinc_app_eah_brp_tpu_torch.runtime import roofline
    from boinc_app_eah_brp_tpu_torch.runtime.cli import main as cli_main
    from boinc_app_eah_brp_tpu_torch.runtime.errors import RADPUL_EVAL
    from boinc_app_eah_brp_tpu_torch.tools import boundary_analysis, golden_ref
    from boinc_app_eah_brp_tpu_torch.tools.median_study import ulp_diff

    t_start = time.perf_counter()
    ps = phase4_spectrum(torch, wu)
    n = ps.shape[0]
    out = {"bins": n}

    # (1) the kernel against its plain version
    def hold(x, w: int, reps: int):
        got = median.running_median(x, bsize=w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = median.running_median_plain(x, bsize=w, block=_plain_block(w))
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"(m1) median kernel != plain version at window {w} over {x.shape[0]} bins")
        return got, dict(
            window=w, bins=int(x.shape[0]), instantiation="shared" if median.scratch_entries(x.device, x.shape[0], w) == 0 else "global",
            max_abs_err=float((got - want).abs().max()),
            ms=time_ms(torch, lambda: median.running_median(x, bsize=w), reps), plain_ms=plain_ms,
        )

    rm, m1 = hold(ps, WINDOW, 10)
    rm_odd, m1_odd = hold(ps, WINDOW - 1, 10)
    # the kernel's step model beside its time: sort, first walks, slide
    for m, w in ((m1, WINDOW), (m1_odd, WINDOW - 1)):
        m["steps"] = roofline.median_steps(n, w)
    _, m1_wide = hold(ps[:MEDIAN_WIDE_BINS].contiguous(), MEDIAN_WIDE, 3)
    check(m1["instantiation"] == "shared" and m1_wide["instantiation"] == "global",
          f"(m1) instantiations {m1['instantiation']} / {m1_wide['instantiation']}")
    block = _plain_block(WINDOW - 1)

    def library():
        return torch.cat([
            ps[s : min(s + block, n - WINDOW + 2) + WINDOW - 2].unfold(0, WINDOW - 1, 1).median(dim=1).values
            for s in range(0, n - WINDOW + 2, block)
        ])

    lib_out = library()
    out["library_equal_odd"] = bool(torch.equal(lib_out.view(torch.int32), rm_odd.view(torch.int32)))
    library_ms = time_ms(torch, library, 2)
    del lib_out, rm_odd
    out["m1"] = {"production": m1, "production_odd": m1_odd, "wide": m1_wide, "library_ms_odd": library_ms}
    out["row"] = dict(
        max_abs_err=m1["max_abs_err"], ms=m1["ms"], plain_ms=m1["plain_ms"], library_ms=library_ms,
        steps=m1["steps"], **roofline.median_cost(n, WINDOW).bound(),
    )

    # (2) against the native rngmed
    host = ps.cpu().numpy()
    t0 = time.perf_counter()
    native = native_median.running_median(host, WINDOW)
    native_ms = (time.perf_counter() - t0) * 1e3
    differing, max_ulp = ulp_diff(rm.cpu().numpy(), native)
    out["m2"] = dict(window=WINDOW, differing=differing, max_ulp=max_ulp, native_ms=native_ms, outputs=len(native))
    check(differing == 0, f"(m2) {differing} of {len(native)} device medians differ from the native rngmed's, "
                          f"max {max_ulp} ulp")
    del ps, rm, host, native

    # (3) the command line under the host median, and without its library
    zap = os.path.join(workdir, "smoke.zap")
    base_cand, base_cp = os.path.join(workdir, "smoke.cand"), os.path.join(workdir, "smoke.cpt")
    t_obs = golden_ref.padded_t_obs(wu)
    absent = os.path.join(workdir, "absent", "liberp_rngmed.so")

    def run(name: str, env: dict) -> dict:
        path = os.path.join(workdir, f"median_{name}")
        argv = (
            f"-i {wu} -o {path}.cand -t {BANK} -c {path}.cpt -l {zap} -W -P {PADDING} -f {F0} -A {FA} "
            f"-B {WINDOW} --batch {BATCH} --device {DEVICE}"
        ).split()
        native_median._lib = None  # the run loads (or fails to load) the library its env names
        host_calls, real = [], native_median.running_median
        native_median.running_median = lambda *a, **k: host_calls.append(1) or real(*a, **k)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            with _env(env):
                rc = cli_main(argv)
            torch.cuda.synchronize()
        finally:
            native_median.running_median = real
            native_median._lib = None  # the next user loads the real library again
        return dict(rc=rc, wall_s=time.perf_counter() - t0, launches=dict(kernels.launch_counts), path=path,
                    host_medians=len(host_calls))

    def rows_of(cand: str) -> list:
        with open(cand) as f:
            return [ln for ln in f.read().splitlines() if ln and not ln.startswith("%")]

    out["m3"] = {}
    # (name, env, host medians, median launches)
    for name, env, host, launched in (("native", {"ERP_MEDIAN": "native"}, 1, 0),
                                      ("no_library", {"ERP_MEDIAN": None, "ERP_RNGMED_LIB": absent}, 0, 1)):
        r = run(name, env)
        check(r["rc"] == 0, f"(m3) {name} exited {r['rc']}")
        check(r["host_medians"] == host and r["launches"]["median"] == launched,
              f"(m3) {name} ran the host median {r['host_medians']} times and launched the median "
              f"{r['launches']['median']} times, not {host} and {launched}")
        for k in SEARCH_PATH:
            check(r["launches"][k] > 0, f"(m3) {name}: kernel {k} was not launched")
        cand = r["path"] + ".cand"
        summary = golden_ref.compare(base_cand, cand, t_obs, bank=BANK)
        check(summary["ok"], f"(m3) {name}'s file against phase 4's: {summary}")
        rows_equal = rows_of(cand) == rows_of(base_cand)
        causes = {}
        if not rows_equal:
            l3 = boundary_analysis.analyse(base_cand, cand, base_cp, r["path"] + ".cpt", t_obs)
            causes = _count_causes(l3["boundary"])
        check(rows_equal, f"(m3) {name}'s rows differ from phase 4's: {causes}")
        out["m3"][name] = dict(wall_s=r["wall_s"], launches=r["launches"], host_medians=r["host_medians"],
                               summary=summary, rows_byte_equal=rows_equal)

    # (4) an explicit native request without its library
    plans = torch.backends.cuda.cufft_plan_cache[0]
    plans.clear()
    r = run("native_absent", {"ERP_MEDIAN": "native", "ERP_RNGMED_LIB": absent})
    check(r["rc"] == RADPUL_EVAL, f"(m4) ERP_MEDIAN=native with no library exited {r['rc']}, not {RADPUL_EVAL}")
    check(not any(r["launches"].values()), f"(m4) launched kernels: {r['launches']}")
    check(plans.size == 0, f"(m4) made {plans.size} cuFFT plans")
    check(not os.path.exists(r["path"] + ".cand"), "(m4) wrote a result")
    out["m4"] = dict(exit=r["rc"], wall_s=r["wall_s"], plans=0, launches=0)
    out["wall_s"] = time.perf_counter() - t_start
    return out


def _count_causes(entries) -> dict:
    return dict(collections.Counter(e["cause"] for e in entries))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from boinc_app_eah_brp_tpu_torch.io import read_workunit
        from boinc_app_eah_brp_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    build_s = kernels.build()
    for name in kernels.SOURCES:
        kernels.library(name)
    print(json.dumps({"build_s": build_s, "ptxas": kernels.ptxas_report}))

    workdir = os.path.join(kernels.BUILD_DIR, "chip_smoke")  # git-ignored
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        geom, bank = production_geometry()
        wu = os.path.join(workdir, "smoke.bin4")
        P_inj, tau_inj = synthetic_workunit(wu, geom, bank)
        measured = check_kernels(torch, dev, geom, bank, read_workunit(wu).samples)
        torch.cuda.empty_cache()
        run = run_main_path(torch, geom, bank, workdir, wu, P_inj, tau_inj)
        torch.cuda.empty_cache()
        unwhite = run_unwhitened(torch, geom, bank, workdir, wu, P_inj, tau_inj)
        torch.cuda.empty_cache()
        default = run_default_cli(torch, bank, workdir, wu, _candidate_rows(os.path.join(workdir, "unwhitened.cand")))
        torch.cuda.empty_cache()
        zap = os.path.join(workdir, "smoke.zap")
        sweep = run_batch_sweep(torch, geom, bank, wu, zap)
        ladder = run_oom_ladder(torch, workdir, wu, zap)
        supervised = run_supervised(workdir, wu, zap, ladder.pop("baseline_rows"))
        torch.cuda.empty_cache()
        serving = run_serving(
            torch, workdir, wu, _candidate_rows(os.path.join(workdir, "unwhitened.cand")), geom, bank
        )
        torch.cuda.empty_cache()
        health_f = run_health_precision(
            torch, geom, bank, workdir, wu, _candidate_rows(os.path.join(workdir, "unwhitened.cand")),
            run["search_loop_templates_per_s"],
        )
        torch.cuda.empty_cache()
        unwhite_rows = _candidate_rows(os.path.join(workdir, "unwhitened.cand"))
        exact = check_exact_sin(torch, dev, geom, bank, read_workunit(wu).samples, measured)
        torch.cuda.empty_cache()
        exact["cli"] = run_exact_sin_cli(torch, workdir, wu, P_inj, tau_inj, unwhite_rows)
        torch.cuda.empty_cache()
        sharded = run_sharded(torch, geom, bank, workdir, wu, zap, unwhite_rows)
        elastic = run_elastic(workdir, wu, unwhite_rows)
        t0 = time.perf_counter()
        fabric = run_fabric(torch, workdir, wu, unwhite_rows, _candidate_rows(os.path.join(workdir, "serve_b.cand")))
        torch.cuda.empty_cache()
        kill = run_kill_resume(workdir, wu)
        phase_h_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        bench_i = run_bench_tool(workdir)
        production = run_production(workdir)
        bundle = run_bundle(workdir)
        phase_i_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        gate_j = run_smoke_gate(workdir, wu)
        torch.cuda.empty_cache()
        step_j = run_step_report(workdir, wu, measured)
        torch.cuda.empty_cache()
        readers_j = run_readers(workdir, step_j["path"])
        modes_j = run_smoke_modes(workdir)
        phase_j_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        knobs_k = run_knobs(torch, workdir, wu, run)
        phase_k_s = time.perf_counter() - t0
        golden_l = run_golden_diff(workdir, wu, P_inj, tau_inj)
        torch.cuda.empty_cache()
        median_m = run_median(torch, workdir, wu)
        measured["median"] = median_m.pop("row")
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    print(json.dumps({"stages": measured.pop("stages")}))
    detail = ("limit", "bound_ms", "bytes_ms", "fp32_ms", "conversions_ms", "chain_ms", "passes", "steps")
    print(json.dumps({"bounds": {k: {d: m[d] for d in detail if d in m} for k, m in measured.items()}}))
    rows = []
    path_launches = {
        "unwhitened": unwhite["launches"],
        "health": health_f["health_run"]["launches"],
        "audit": health_f["audit_launches"],
        "exact_sin": exact["cli"]["launches"],
    }
    for name, (replaces, src) in KERNEL_ROWS.items():
        m = measured[name]
        rows.append(
            dict(
                name=name,
                route="cuda",
                source=f"boinc_app_eah_brp_tpu_torch/csrc/{src}",
                replaces=replaces,
                launches=path_launches.get(LAUNCHES_FROM.get(name), run["launches"])[name],
                max_abs_err=m.get("max_abs_err"),
                **{k: m[k] for k in ("max_rel_err",) if k in m},
                ms=m["ms"],
                plain_ms=m["plain_ms"],
                bound_ms=m["bound_ms"],
                bound_by=m["bound_by"],
                library_ms=m["library_ms"],
            )
        )
    print(json.dumps({"main_path": {k: v for k, v in run.items() if k != "launches"}}))
    print(json.dumps({"unwhitened": unwhite}))
    print(json.dumps({"default_cli": default}))
    print(json.dumps({"batch_sweep": sweep}))
    print(json.dumps({"oom_ladder": ladder}))
    print(json.dumps({"supervised": supervised}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"roofline": health_f.pop("roofline")}))
    print(json.dumps({"health_precision": health_f}))
    print(json.dumps({"exact_sin": exact}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"elastic": elastic}))
    print(json.dumps({"fabric": fabric}))
    print(json.dumps({"kill_resume": kill, "phase_h_s": phase_h_s}))
    print(
        f"fabric: backend recompiles after warm-up {fabric['backend_recompiles_after_warmup']}, "
        f"{fabric['backend_wus_per_hour_per_chip']} WUs/hour/chip (backend), "
        f"{fabric['granted_wus_per_hour_per_chip']:.1f} granted WUs/hour/chip (references + fabric), "
        f"grant latency p50 {fabric['grant_latency_s']['p50']} s p95 {fabric['grant_latency_s']['p95']} s, "
        f"replica overhead {fabric['replica_overhead']['ratio']}x"
    )
    print(
        f"kill/resume: batch {kill['batch']}, {len(kill['runs'])} cycles, resumes "
        + ", ".join(f"{r['signal']} at {r['killed_at']} after {r['wall_s']:.2f} s (from {r['resumed_at']})"
                    for r in kill["runs"])
        + f", final from {kill['final']['resumed_at']} in {kill['final']['wall_s']:.2f} s, byte-identical"
    )
    print(json.dumps({"bundle": bundle, "phase_i_s": phase_i_s}))
    for name in ("whitened", "unwhitened"):
        r = production[name]
        print(
            f"production {name}: {production['templates']} templates at batch {r['batch']} "
            f"({production['cpu_count']} cores): wall {r['wall_s']:.2f} s, loop {r['loop_s']:.3f} s = "
            f"{r['loop_templates_per_s']:.1f} templates/s; end-of-run rescoring {r['rescore_end_pass_s']:.3f} s"
        )
    print(
        f"bench: {bench_i['autobatch']['value']} templates/s at batch {bench_i['autobatch']['batch']} "
        f"({bench_i['autobatch']['n_batches']} batches), {bench_i['batch32']['value']} at batch 32; "
        f"bundle: rows equal phase 4's, 0 kernel builds, launches {bundle['launches']}; under ERP_MEDIAN=native "
        f"rows equal phase 4's, the bundle's liberp_rngmed.so, no median launch; phase (i) {phase_i_s:.1f} s"
    )
    print(json.dumps({"smoke_gate": gate_j}))
    print(json.dumps({"step_report": step_j}))
    print(json.dumps({"readers": readers_j}))
    print(json.dumps({"smoke_modes": modes_j, "phase_j_s": phase_j_s}))
    print(
        f"smoke gate (j1): wall {gate_j['wall_s']:.2f} s, trace coverage {gate_j['coverage']:.4f}, health checks "
        f"{gate_j['health_checks']}, launches " + ", ".join(f"{k} {gate_j['launches'].get(k, 0)}" for k in UNWHITENED_PATH)
        + f"; step report (j2) {step_j['wall_s']:.2f} s, {step_j['device_lane']}, "
        f"{step_j['measured']['templates_per_sec']} templates/s over {step_j['measured']['windows']} windows; "
        f"--hosts 2 {modes_j['hosts']['wall_s']:.1f} s, --fabric {modes_j['fabric']['wall_s']:.1f} s; "
        f"phase (j) {phase_j_s:.1f} s"
    )
    print(json.dumps({"knobs": knobs_k, "phase_k_s": phase_k_s}))
    k1 = knobs_k["rescore_off"]
    print(
        f"knobs (k): ERP_RESCORE=off wall {k1['wall_s']:.2f} s beside phase 4's {k1['phase4_wall_s']:.2f} s "
        f"(its rescoring alone {k1['phase4_rescore_s']:.2f} s), {k1['n_candidates']} unrescored rows, "
        f"{k1['rows_differing_from_phase4']} differing from phase 4's; ERP_PRECISION=bf16 exit "
        f"{knobs_k['precision_bf16']['exit']}, ERP_PRECISION=xx exit {knobs_k['precision_xx']['exit']}, "
        f"no launch and no cuFFT plan each; "
        f"phase (k) {phase_k_s:.1f} s"
    )
    print(json.dumps({"golden_diff": golden_l}))
    s4, r4 = golden_l["summary"], golden_l["rescored_vs_unrescored"]
    print(
        f"golden diff (l): inputs' sha256 the JAX golden's (numpy {golden_l['numpy']} here, "
        f"{golden_l['golden_versions']['numpy']} for the golden); phase 4 against the JAX package's file: "
        f"ok {s4['ok']}, matched {s4['matched']}, missing {s4['missing']}, extra {s4['extra']}, boundary "
        f"{s4['boundary']} {golden_l['boundary_by_cause']}, mismatches {s4['mismatches']}, injected row "
        f"{golden_l['injected_key']} rank {golden_l['injected_rank_golden']} there, {golden_l['injected_rank_port']} "
        f"here, {golden_l['closeness']['rows_equal']} matched rows equal, the rest within "
        f"{golden_l['closeness']['max_rel_power']:.3g} of power and {golden_l['closeness']['max_abs_fA']:.3g} of fA; "
        f"phase 4 against (k1)'s unrescored rows: matched {r4['matched']}, "
        f"{r4['rows_differing_by_position']} rows differing by position, {len(r4['differing'])} by key "
        f"{r4['by_cause']}; phase (l) {golden_l['wall_s']:.2f} s"
    )
    for e in r4["differing"]:
        print(f"  (l4) bin {e['bin']} n_harm {e['n_harm']} {e['side']}: {e['cause']} {e['detail']}")
    print(json.dumps({"median": median_m}))
    m1, m2, m3 = median_m["m1"], median_m["m2"], median_m["m3"]
    print(
        f"median (m): kernel bitwise its plain version over {median_m['bins']} bins at window {WINDOW} "
        f"({m1['production']['ms']:.4f} ms, plain {m1['production']['plain_ms']:.1f} ms; step model "
        f"{m1['production']['steps']['compare_exchanges']:.3g} compare-exchanges, "
        f"{m1['production']['steps']['first_walk']:.3g} first-walk and {m1['production']['steps']['slide']:.3g} "
        f"slide reads), {WINDOW - 1} "
        f"({m1['production_odd']['ms']:.4f} ms; torch.median {m1['library_ms_odd']:.1f} ms, equal "
        f"{median_m['library_equal_odd']}) and {MEDIAN_WIDE} over {MEDIAN_WIDE_BINS} bins "
        f"({m1['wide']['ms']:.4f} ms, plain {m1['wide']['plain_ms']:.1f} ms); against the native rngmed "
        f"({m2['native_ms']:.1f} ms): {m2['differing']} of {m2['outputs']} outputs differ, max {m2['max_ulp']} ulp; "
        + "; ".join(
            f"{name}: wall {r['wall_s']:.2f} s (phase 4's {run['wall_s']:.2f} s), host median {r['host_medians']}, "
            f"median launched {r['launches']['median']}, golden compare ok {r['summary']['ok']} matched "
            f"{r['summary']['matched']}, rows byte for byte {r['rows_byte_equal']}"
            for name, r in m3.items()
        )
        + f"; ERP_MEDIAN=native without the library exit {median_m['m4']['exit']}, no launch, no plan; "
        f"phase (m) {median_m['wall_s']:.1f} s"
    )
    print(json.dumps({"kernels": rows}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
