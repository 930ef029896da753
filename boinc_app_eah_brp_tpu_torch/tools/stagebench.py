"""Per-stage timing of the port's production search step.

The port's twin of the repository's ``tools/stagebench.py``: each stage of
one batch step (``models/search.py::BankStep``) timed alone on the bench's
problem (``tools/bench.py``: the whitened 2^22-sample workunit and the
first templates of its bank) at the bench's batch, to show where a
template's milliseconds go.  On a card every stage is timed with CUDA
events around ``--repeat`` calls after one warm-up; on the CPU
(``--device cpu``) with the host's clock.  The stages carry the names of
``chip_smoke.py``'s kernel rows and ``stages`` line:

* ``resample_ms``: kernel A with its statistics (``ops/resample.py::
  resample_stream``);
* ``fftprep_ms``: kernel B (``fftprep``);
* ``rfft_ms``: the step's R2C (``models/search.py::fold_input``: on a card
  at the production length the kernel pair of ``csrc/rfft.cu`` with the
  power epilogue in its second pass; ``chip_smoke.py`` times cuFFT's
  beside it);
* ``fold_spectrum_ms``: kernel C on what the R2C gave
  (``models/search.py::fold_batch``: its float entry on that power; on the
  complex spectrum of cuFFT or the CPU, its complex entry with the power
  epilogue inside);
* ``merge_ms``: the max/argmax merge into (M, T) (``BankStep.merge``);
* ``batch_step_ms``: the whole step;
* ``running_median_ms``: the device running median over one spectrum
  (``ops/median.py``, ``csrc/median.cu`` on a card), with ``--median``,
  as the JAX tool's ``--median`` times its device median; beside it
  ``running_median_native_ms``, the host median (``ops/native_median.py``,
  the whitening's median on the CPU and under ``ERP_MEDIAN=native``) once
  over the same spectrum.

The artifact (``--json``) also carries the JAX tool's keys: ``resample_s``
(A and B: the padded series the FFT reads), ``rfft_power_s`` (the rfft, with
the power where the step forms it there), ``harmonic_sum_s`` (C), ``total_s`` (the five
stages) and ``templates_per_sec_pipeline``.

``--whiten`` decomposes the whitening pass instead (``ops/whiten.py``),
one cold pass and ``--repeat`` warm ones, each stage synchronized: the
forward rfft, the power, the running median of the path the whitening
takes on the device (``ops/whiten.py::check_median``: on a card the device
median, unless ``ERP_MEDIAN=native`` asks for the host median with its copy
to the host and back), the scale, the zap noise and its
scatter, the inverse rfft; ``TOTAL`` is ``whiten_and_zap`` itself.  ``warm_device_split_total_s`` is a warm
``whiten_and_zap`` timed alone: the port's production path, whose output
stays on the card.

Usage: python -m boinc_app_eah_brp_tpu_torch.tools.stagebench [--batch N]
           [--repeat 5] [--median] [--whiten] [--json PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


class _Timer:
    """ms per call of ``fn`` over ``repeat`` calls after one warm-up: CUDA
    events on a card, the host clock on the CPU."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def __call__(self, fn, repeat: int) -> float:
        torch = self.torch
        fn()
        self.sync()
        if self.dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(repeat):
                fn()
            return (time.perf_counter() - t0) / repeat * 1e3
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeat):
            fn()
        stop.record()
        torch.cuda.synchronize(self.dev)
        return start.elapsed_time(stop) / repeat


def stage_times(problem, device: str = "cuda", batch: int | None = None, repeat: int = 5,
                median: bool = False, log=print) -> dict:
    """Each stage of the batch step alone on ``problem``'s whitened series
    and its first ``batch`` templates (the autobatch's choice when None);
    returns the artifact."""
    import torch

    from ..device import resolve_device
    from ..models.search import (
        BankStep, SearchGeometry, bank_params_host, fold_batch, fold_input, init_state, lut_step_for_bank,
        lut_tiles_for_bank, max_slope_for_bank, upload_bank,
    )
    from ..ops import native_median, resample
    from ..ops.median import running_median
    from ..ops.whiten import whiten_and_zap

    dev = resolve_device(device)
    timed = _Timer(torch, dev)
    d = problem.derived
    ts = whiten_and_zap(problem.samples, d, problem.cfg, problem.zap_ranges, device=dev)
    P, tau, psi = problem.P, problem.tau, problem.psi
    geom = SearchGeometry.from_derived(
        d,
        max_slope=max_slope_for_bank(P, tau),
        lut_step=lut_step_for_bank(P, d.dt),
        lut_tiles=lut_tiles_for_bank(P, psi, d.n_unpadded, d.dt),
    )
    if batch is None:
        from ..runtime.autobatch import choose_batch

        batch = choose_batch(geom.nsamples, device=dev)
    B = min(int(batch), len(P))
    log(f"nsamples={geom.nsamples} fft_size={d.fft_size} fund_hi={geom.fund_hi} harm_hi={geom.harm_hi} batch={B}")
    host_params = bank_params_host(P[:B], tau[:B], psi[:B], geom.dt)
    params = resample.stream_params(*host_params, device=dev)
    kw = dict(n_unpadded=geom.n_unpadded, dt=geom.dt)

    stages = {}
    stages["resample_ms"] = timed(lambda: resample.resample_stream(ts, params, **kw), repeat)
    raw, n_steps, mean = resample.resample_stream(ts, params, **kw)
    stages["fftprep_ms"] = timed(lambda: resample.fftprep(raw, n_steps, mean, nsamples=geom.nsamples), repeat)
    x = resample.fftprep(raw, n_steps, mean, nsamples=geom.nsamples)
    del raw
    # the kernel's first pass overwrites x: the spectrum the later stages
    # read comes first, and the timed calls run on what it left there
    S = fold_input(x, geom)
    stages["rfft_ms"] = timed(lambda: fold_input(x, geom), repeat)
    del x
    stages["fold_spectrum_ms"] = timed(lambda: fold_batch(S, geom), repeat)
    sums = fold_batch(S, geom)
    del S
    bank = upload_bank(host_params, B, dev)
    step = BankStep(geom, bank, B, state=init_state(geom, dev))
    stages["merge_ms"] = timed(lambda: step.merge(sums, 0, B), repeat)
    del sums
    stages["batch_step_ms"] = timed(lambda: step(ts, 0, B), repeat)
    if median:
        F = torch.fft.rfft(torch.nn.functional.pad(ts, (0, geom.nsamples - geom.n_unpadded)))
        ps = F.real * F.real + F.imag * F.imag
        del F
        window = problem.cfg.window
        stages["running_median_ms"] = timed(lambda: running_median(ps, bsize=window), repeat)
        host = ps.cpu().numpy()
        native_median.load()  # its first use builds the library: not the median's time
        t0 = time.perf_counter()
        native_median.running_median(host, window)
        stages["running_median_native_ms"] = (time.perf_counter() - t0) * 1e3
    for k, v in stages.items():
        log(f"{k:28s} {v:10.3f} ms")
    pipeline = ("resample_ms", "fftprep_ms", "rfft_ms", "fold_spectrum_ms", "merge_ms")
    total_s = sum(stages[k] for k in pipeline) / 1e3
    log(f"{'total per batch':28s} {total_s * 1e3:10.3f} ms -> {B / total_s:.2f} templates/s (stages alone)")
    return {
        "what": "search step per-stage wall (s/batch), production geometry 2^22 samples padding 3.0",
        "backend": dev.type,
        "batch": B,
        "stages": stages,
        "resample_s": (stages["resample_ms"] + stages["fftprep_ms"]) / 1e3,
        "rfft_power_s": stages["rfft_ms"] / 1e3,
        "harmonic_sum_s": stages["fold_spectrum_ms"] / 1e3,
        "total_s": total_s,
        "templates_per_sec_pipeline": B / total_s,
    }


def whiten_decompose(problem, device: str = "cuda", repeat: int = 3, log=print) -> dict:
    """The whitening pass stage by stage, one cold pass and ``repeat``
    warm ones; returns the artifact."""
    import torch

    from ..device import resolve_device
    from ..oracle.whiten import seed_from_samples, zap_noise
    from ..ops import native_median
    from ..ops.median import running_median
    from ..ops.whiten import _forward, _inverse, check_median, whiten_and_zap

    dev = resolve_device(device)
    timer = _Timer(torch, dev)
    d, cfg = problem.derived, problem.cfg
    window_2 = int(0.5 * cfg.window + 0.5)
    if check_median(dev) == "native":
        def median(ps):
            return torch.from_numpy(native_median.running_median(ps.cpu().numpy(), cfg.window)).to(dev)
    else:
        def median(ps):
            return running_median(ps, bsize=cfg.window)

    def one_pass() -> dict:
        t = {}

        def stage(name, fn):
            t0 = time.perf_counter()
            out = fn()
            timer.sync()
            t[name] = time.perf_counter() - t0
            return out

        padded = stage("upload", lambda: torch.nn.functional.pad(
            torch.from_numpy(problem.samples).to(dev), (0, d.nsamples - d.n_unpadded)))
        F = stage("rfft", lambda: _forward(padded))
        ps = stage("power", lambda: F.real * F.real + F.imag * F.imag)
        rm = stage("median", lambda: median(ps))

        def scale():
            factor = torch.sqrt(torch.tensor(np.float32(np.log(2.0)), device=dev) / rm)
            sc = torch.ones(d.fft_size, dtype=torch.float32, device=dev)
            sc[window_2 : window_2 + len(rm)] = factor
            return F.real * sc, F.imag * sc

        re, im = stage("scale", scale)

        def zap():
            bins = (np.asarray(problem.zap_ranges) * d.t_obs + 0.5).astype(np.uint32)
            idx, vals = zap_noise(seed_from_samples(problem.samples), bins,
                                  float(np.sqrt(0.5) * np.sqrt(cfg.padding)), d.fft_size)
            if len(idx):
                i = torch.from_numpy(idx).to(dev)
                re[i] = torch.from_numpy(np.real(vals).astype(np.float32)).to(dev)
                im[i] = torch.from_numpy(np.imag(vals).astype(np.float32)).to(dev)

        stage("zap", zap)
        re[:window_2] = 0.0
        stage("irfft", lambda: _inverse(re, im, d.nsamples))
        stage("TOTAL", lambda: whiten_and_zap(problem.samples, d, cfg, problem.zap_ranges, device=dev))
        return t

    passes = []
    for i in range(repeat + 1):
        t = one_pass()
        passes.append(t)
        log(f"-- {'cold' if i == 0 else f'warm {i}'}")
        for k, v in t.items():
            log(f"   {k:20s} {v * 1e3:10.1f} ms")
    t0 = time.perf_counter()
    whiten_and_zap(problem.samples, d, cfg, problem.zap_ranges, device=dev)
    timer.sync()
    production_s = time.perf_counter() - t0
    log(f"-- warm whiten_and_zap (production path) {production_s * 1e3:10.1f} ms")
    warm = passes[1:] or passes
    return {
        "what": "whitening per-stage wall (s), production geometry 2^22 samples padding 3.0 window 1000; "
        "stages synced",
        "backend": dev.type,
        "cold_s": passes[0],
        "warm_avg_s": {k: sum(p[k] for p in warm) / len(warm) for k in warm[0]},
        "warm_passes": len(warm),
        "warm_device_split_total_s": production_s,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None, help="templates a batch (default: the autobatch's)")
    ap.add_argument("--repeat", type=int, default=5)
    ap.add_argument("--median", action="store_true",
                    help="include the device running median (and the host one beside it)")
    ap.add_argument("--whiten", action="store_true", help="decompose the whitening pass instead")
    ap.add_argument("--json", default=None, help="write the artifact here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from .bench import load_problem

    problem = load_problem()
    if args.whiten:
        art = whiten_decompose(problem, device=args.device, repeat=args.repeat)
    else:
        art = stage_times(problem, device=args.device, batch=args.batch, repeat=args.repeat, median=args.median)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(art, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
