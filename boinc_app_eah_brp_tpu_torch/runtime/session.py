"""One workunit's search, from the checkpoint it resumes to its result file.

:meth:`Session.prepare` parses the bank, finds a resumable checkpoint and
the quarantined template ranges (``runtime/watchdog.py``), reads the
workunit, builds the geometry, whitens (``-W``) or uploads the raw series,
chooses the batch (``--batch``, else ``runtime/autobatch.py``) and seeds
the checkpoint's candidates into (M, T) as virtual templates past the
bank.  :meth:`Session.execute` runs the batched search over the runnable
segments with the BOINC progress callback (checkpoint cadence,
screensaver, suspend, quit, the watchdog's abort), writes the final
checkpoint, turns (M, T) into the toplist, rescores the winners through
the host oracle and writes the result file.  Counterpart of the JAX
package's ``runtime/session.py``, with its spans, metrics, flight-recorder
events, watchdog guards and retried writes under the same names.  The
search runs on one device, or with ``n_mesh > 1`` sharded over a mesh of
devices (``parallel/sharded_search.py``), or with a multi-process ``dist``
config as one process of an elastic search (``parallel/elastic.py``):
there only the merge winner writes the checkpoint and the result and
rescores, and the committed shard states on the board are the durable
resume point.

A resident server (``runtime/scheduler.py``) builds one Session per
workunit with a :class:`SessionEnv` snapshot of the env knobs, a scoped
``runtime/obs.ObsContext`` and a correlation id, prepares it on its prep
thread and executes it with its step cache; :meth:`Session.release` then
drops the session's tensors.  The prep thread queues its device work
(the series' upload, whitening's FFTs, the zeroed state) on the default
stream that the executing session also uses, so it runs after the work
already queued there and needs no stream synchronisation of its own; its
copies between host and card (the pageable upload, whitening's power
spectrum) wait for that queue.

The search loop never waits on the card between batches; the host waits
only where it copies the state: the checkpoint's copy, the screensaver's
row and the final copy.  Those are the ``drain`` points: each runs under
the watchdog's ``drain`` guard (the only guards that can see a wedged
kernel) and refreshes the dispatch loop's recovery snapshot.  With
``ERP_HEALTH_EVERY`` set (``runtime/health.py``) the loop also waits where
the health watchdog copies its vectors, and each checkpoint runs the
sentinel probe.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..io import (
    N_CAND,
    ResultFile,
    ResultHeader,
    TemplateBank,
    empty_candidates,
    read_template_bank,
    read_workunit,
    read_zaplist,
    write_result_file,
)
from ..io.checkpoint import Checkpoint, load_resumable_checkpoint, topology_record, write_checkpoint
from ..io.formats import N_BINS_SS
from ..oracle.pipeline import DerivedParams, SearchConfig
from ..oracle.stats import base_thresholds
from ..oracle.toplist import finalize_candidates, update_toplist_from_maxima
from . import devicecost, flightrec, metrics, profiling, resilience, steptime, tracing, watchdog
from . import logging as erplog
from .boinc import BoincAdapter, _default_checkpoint_period, _default_progress_min_delta
from .errors import RADPUL_EFILE, RADPUL_TEMPORARY_EXIT, RadpulError
from .errors import exit_code_for  # noqa: F401  (re-exported, as the JAX package's session does)
from .roofline import roofline_report

EXEC_NAME = "eah_brp_tpu_torch"


def sky_position_radians(header) -> tuple[float, float]:
    """HHMMSS.S / DDMMSS.S -> radians (``demod_binary.c:746-771``)."""
    ra = float(header["RA"])
    hrs = math.floor(ra / 10000.0)
    mins = math.floor((ra - 10000.0 * hrs) / 100.0)
    sec = ra - 10000.0 * hrs - 100.0 * mins
    rac = math.pi * (hrs / 12.0 + mins / 720.0 + sec / 43200.0)

    dec = float(header["DEC"])
    sign = -1.0 if dec < 0.0 else 1.0
    dec = abs(dec)
    hrs = math.floor(dec / 10000.0)
    mins = math.floor((dec - 10000.0 * hrs) / 100.0)
    sec = dec - 10000.0 * hrs - 100.0 * mins
    decr = sign * math.pi * (hrs / 180.0 + mins / 10800.0 + sec / 648000.0)
    return rac, decr


def binned_spectrum(sumspec4: np.ndarray, fund_hi: int) -> bytes:
    """40-bin screensaver downsample of the 4-harmonic spectrum
    (``demod_binary.c:1383-1393``)."""
    powerscale = 100.0 / 255.0
    stepscale = float(N_BINS_SS) / float(fund_hi)
    bins = (stepscale * np.arange(len(sumspec4))).astype(np.int32)
    # bins is nondecreasing: one segmented max per screensaver bin
    boundaries = np.searchsorted(bins, np.arange(N_BINS_SS), side="left")
    valid = boundaries < len(sumspec4)
    seg_max = np.zeros(N_BINS_SS, dtype=np.float32)
    if valid.any():
        seg_max[valid] = np.maximum.reduceat(sumspec4, boundaries[valid])
    return np.minimum(seg_max / powerscale, 255.0).astype(np.uint8).tobytes()


def _dump_header(h) -> None:
    """Debug header dump (``demod_binary.c:706-737``)."""
    erplog.info("Header contents:\n")
    for label, key in [
        ("Original WAPP file: %s", "originalfile"),
        ("Sample time in microseconds: %g", "tsample"),
        ("Observation time in seconds: %.8g", "tobs"),
        ("Time stamp (MJD): %.17g", "timestamp"),
        ("Center freq in MHz: %.10g", "fcenter"),
        ("RA (J2000): %.12g", "RA"),
        ("DEC (J2000): %.12g", "DEC"),
        ("Number of samples: %d", "nsamples"),
        ("Trial dispersion measure: %g cm^-3 pc", "DM"),
        ("Scale factor: %g", "scale"),
    ]:
        value = h[key]
        if value.dtype.kind == "S":
            value = bytes(value).split(b"\x00", 1)[0].decode("latin-1")
        elif "%d" in label:
            value = int(value)
        else:
            value = float(value)
        erplog.log_message(erplog.Level.INFO, False, label + "\n", value)


def _dump_thresholds(fA: float, fft_size: int) -> None:
    """Debug threshold dump (``demod_binary.c:1155-1166``)."""
    from ..oracle.stats import chisq_Qinv, single_bin_prob

    prob = float(single_bin_prob(fA, fft_size))
    erplog.info("Derived global search parameters:\n")
    erplog.log_message(erplog.Level.INFO, False, "f_A probability = %g\n", fA)
    erplog.log_message(erplog.Level.INFO, False, "single bin prob(P_noise > P_thr) = %g\n", prob)
    for label, nu in [("thr1", 2), ("thr2", 4), ("thr4", 8), ("thr8", 16), ("thr16", 32)]:
        erplog.log_message(erplog.Level.INFO, False, "%s = %g\n", label, 0.5 * chisq_Qinv(prob, nu))


@dataclass(frozen=True)
class SessionEnv:
    """Per-Session snapshot of the env knobs a resident server must re-read
    between workunits: the checkpoint cadence (``ERP_CHECKPOINT_PERIOD``)
    and the progress threshold (``ERP_PROGRESS_MIN_DELTA``), read through
    ``runtime/boinc.py`` with its fallbacks for bad values.  Captured once
    per Session: a knob changed while a server runs applies from the next
    workunit on, never in the middle of one."""

    checkpoint_period_s: float = 60.0
    progress_min_delta: float = 0.001

    @classmethod
    def capture(cls) -> "SessionEnv":
        return cls(
            checkpoint_period_s=_default_checkpoint_period(),
            progress_min_delta=_default_progress_min_delta(),
        )

    def make_adapter(self) -> BoincAdapter:
        """A fresh BOINC adapter honouring this snapshot's cadence."""
        return BoincAdapter(
            checkpoint_period_s=self.checkpoint_period_s,
            progress_min_delta=self.progress_min_delta,
        )


class Session:
    """One workunit's search.  ``args`` is a ``runtime/driver.DriverArgs``
    whose ``device`` is already chosen; ``adapter`` defaults to a fresh
    :class:`BoincAdapter` built from ``env`` (a :class:`SessionEnv`,
    captured now when None); ``init_data`` (``runtime/initdata.py``) gives
    the result file its provenance.  ``obs`` is an optional scoped
    ``ObsContext`` (the serving tier's per-Session black box; the driver
    leaves it None and uses the process-global layers), ``corr_id`` the
    workunit's correlation id (default ``$ERP_CORR_ID``).  ``batch_for(geom,
    device)``, when given, chooses the batch of a run without ``--batch``
    in place of ``runtime/autobatch.py`` (a resident scheduler holds one
    batch per geometry class)."""

    def __init__(
        self,
        args,
        adapter: BoincAdapter | None = None,
        *,
        env: SessionEnv | None = None,
        obs=None,
        corr_id: str | None = None,
        init_data=None,
        batch_for=None,
    ):
        self.args = args
        self.env = env or SessionEnv.capture()
        self.adapter = adapter or self.env.make_adapter()
        self.obs = obs
        self.corr_id = corr_id or os.environ.get(metrics.CORR_ID_ENV) or None
        # the workunit every span of this session carries
        # (tracing.for_workunit): the caller's correlation id, a server's
        # ticket (its scoped bundle's name), else $ERP_CORR_ID or the
        # workunit file's name
        self.wu_id = (
            corr_id or (obs.name if obs is not None else None) or self.corr_id
            or os.path.basename(args.inputfile)
        )
        self.init_data = init_data
        self.batch_for = batch_for
        self.prepared = False

    def _obs_record(self, event: str, **fields) -> None:
        """A lifecycle breadcrumb into the Session's own black box (a no-op
        without a scoped bundle: the driver's flight recorder keeps its
        record points)."""
        if self.obs is None:
            return
        if self.corr_id:
            fields.setdefault("corr_id", self.corr_id)
        self.obs.flightrec.record(event, **fields)

    def prepare(self, n_mesh: int = 1, dist=None) -> "Session":
        """Parse, upload and (with ``-W``) whiten the workunit, read the
        bank and the checkpoint, and choose the batch, on one timeline span
        closed on the thread that opened it (a server prepares on its prep
        thread); a failure closes it with its error.  ``n_mesh`` is the
        width of the device mesh (1: one device) and ``dist`` the
        multi-process config (``parallel/distributed.py``; None: one
        process), both from the driver."""
        self._n_mesh, self._dist = int(n_mesh), dist
        with tracing.for_workunit(self.wu_id), tracing.span("setup"):
            return self._prepare()

    def _prepare(self) -> "Session":
        from ..models.search import (
            SearchGeometry,
            erp_precision,
            init_state,
            lut_step_for_bank,
            lut_tiles_for_bank,
            max_slope_for_bank,
            normalize_psi0,
            state_from_natural,
            state_to_natural,
        )

        args, dist = self.args, self._dist
        self._obs_record("session-prepare", inputfile=args.inputfile, templatebank=args.templatebank)
        self.dev = resolve_device(args.device)

        # template bank: the full parse is its validation (demod_binary.c:507-544)
        with tracing.span("input-read", what="bank"):
            bank = read_template_bank(args.templatebank)
        template_total = len(bank)
        erplog.debug("Total amount of templates: %d\n", template_total)
        psi0_n = normalize_psi0(bank.psi0)
        if not np.array_equal(psi0_n, bank.psi0):
            erplog.info("Template bank psi0 values outside [0, 2pi) folded into range.\n")
            bank = TemplateBank(bank.P, bank.tau, psi0_n)
        self.bank = bank
        self.template_total = template_total

        # checkpoint resume (demod_binary.c:546-652), newest good generation
        self.process_count = dist.num_processes if dist is not None else 1
        resumed = None
        if args.checkpointfile:
            with tracing.span("input-read", what="checkpoint"):
                resumed = load_resumable_checkpoint(
                    args.checkpointfile, template_total, args.inputfile,
                    bank_path=args.templatebank, process_count=self.process_count,
                )
        seed_cands = None
        self.start_template = 0
        if resumed is not None:
            cp, used_path, generation = resumed
            flightrec.record("resume", n_template=cp.n_template, path=used_path, generation=generation)
            if cp.n_template == template_total:
                erplog.info("Thank you but this work unit has already been processed completely...\n")
            else:
                erplog.info("Continuing work on %s at template no. %d\n", cp.originalfile, cp.n_template)
            self.start_template = cp.n_template
            seed_cands = cp.candidates
        else:
            erplog.info("Checkpoint file unavailable: %s\n", args.checkpointfile)
            erplog.log_message(erplog.Level.INFO, False, "Starting from scratch...\n")

        # poison-range quarantine (runtime/watchdog.py): template windows
        # that wedged or crashed the worker K times are skipped, loudly,
        # and named in the checkpoint and result provenance.  One process
        # only: in an elastic run the survivors adopt a wedged range, and a
        # per-process tally would punch gaps the others would have filled
        quarantined: list[tuple[int, int]] = []
        incident_path = watchdog.default_incident_path(args.checkpointfile)
        if incident_path and dist is None:
            quarantined = [
                (max(0, a), min(template_total, b))
                for a, b in watchdog.IncidentLog(incident_path).quarantined()
                if a < template_total and b > 0 and max(0, a) < min(template_total, b)
            ]
        if quarantined:
            n_quarantined = sum(b - a for a, b in quarantined)
            metrics.counter("resilience.quarantined").inc(n_quarantined)
            flightrec.record("quarantine", ranges=[[a, b] for a, b in quarantined])
            erplog.warn(
                "Quarantined %d poison template(s) after repeated incidents: %s — skipping them, the gap is "
                "recorded in checkpoint and result provenance.\n",
                n_quarantined, ", ".join(f"[{a}, {b})" for a, b in quarantined),
            )
        self.quarantined = quarantined

        with tracing.span("input-read", what="workunit"):
            wu = read_workunit(args.inputfile)
        if args.debug:
            _dump_header(wu.header)
        cfg = SearchConfig(f0=args.f0, padding=args.padding, fA=args.fA, window=args.window, white=args.white)
        derived = DerivedParams.derive(wu.nsamples, float(wu.header["tsample"]), cfg)
        geom = SearchGeometry.from_derived(
            derived,
            max_slope=max_slope_for_bank(bank.P, bank.tau),
            lut_step=lut_step_for_bank(bank.P, derived.dt),
            lut_tiles=lut_tiles_for_bank(bank.P, bank.psi0, derived.n_unpadded, derived.dt),
            # unwhitened data: the reference's serial float32 pad mean, on
            # the card for the whole bank ahead (ops/resample.py::
            # exact_mean_params, from models/search.py::run_bank)
            exact_mean=not cfg.white,
            use_lut=args.use_lut,
        )

        # a refused ERP_PRECISION fails here, before whitening makes a cuFFT
        # plan (BankStep checks it again for its other callers)
        erp_precision()

        # whitening + RFI zapping (demod_binary.c:856-1079), or the raw series
        if args.white:
            from ..ops.whiten import whiten_and_zap

            if not args.zaplistfile:
                raise RadpulError(RADPUL_EFILE, "Whitening requires a zaplist file (-l).")
            with tracing.span("input-read", what="zaplist"):
                zaplist = read_zaplist(args.zaplistfile)
            with profiling.phase("whitening"):
                self.ts = whiten_and_zap(wu.samples, derived, cfg, zaplist, device=self.dev)
        else:
            self.ts = torch.from_numpy(np.ascontiguousarray(wu.samples, dtype=np.float32)).to(self.dev)
        self.wu, self.cfg, self.derived, self.geom = wu, cfg, derived, geom
        self.base_thr = base_thresholds(cfg.fA, derived.fft_size)
        if args.debug:
            _dump_thresholds(cfg.fA, derived.fft_size)

        # batch size: pinned by --batch, else the measured sweep or the
        # memory model (runtime/autobatch.py) within the task's share of the
        # card (init_data.xml's gpu_usage); the choice is logged either way
        share = self.init_data.gpu_usage if self.init_data is not None else None
        metrics.gauge("card.gpu_usage").set(1.0 if share is None else share)
        if args.batch_size is not None:
            self.batch_size = int(args.batch_size)
            erplog.info("Batch size %d (--batch).\n", self.batch_size)
        elif self.batch_for is not None:
            self.batch_size = int(self.batch_for(geom, self.dev))
        else:
            from .autobatch import choose_batch

            self.batch_size = choose_batch(geom.nsamples, log=erplog.info, device=self.dev, share=share)

        # the checkpoint's candidates re-enter (M, T) as virtual templates
        # past the bank, so the toplist conversion treats them uniformly
        params_P = bank.P.astype(np.float32)
        params_tau = bank.tau.astype(np.float32)
        params_psi = bank.psi0.astype(np.float32)
        M, T = init_state(geom, self.dev)
        if seed_cands is not None:
            params_P = np.concatenate([params_P, seed_cands["P_b"].astype(np.float32)])
            params_tau = np.concatenate([params_tau, seed_cands["tau"].astype(np.float32)])
            params_psi = np.concatenate([params_psi, seed_cands["Psi"].astype(np.float32)])
            Mn, Tn = state_to_natural(M, geom), state_to_natural(T, geom)
            for idx in range(N_CAND):
                n_harm = int(seed_cands["n_harm"][idx])
                if n_harm == 0:
                    continue
                k = n_harm.bit_length() - 1
                f0_bin = int(seed_cands["f0"][idx])
                power = np.float32(seed_cands["power"][idx])
                if f0_bin < geom.fund_hi and power > Mn[k, f0_bin]:
                    Mn[k, f0_bin] = power
                    Tn[k, f0_bin] = template_total + idx
            M = torch.from_numpy(state_from_natural(Mn, geom)).to(self.dev)
            T = torch.from_numpy(state_from_natural(Tn, geom)).to(self.dev)
        self.params = (params_P, params_tau, params_psi)
        self.state = (M, T)

        rac, decr = sky_position_radians(wu.header)
        self.search_info = {"skypos_rac": rac, "skypos_dec": decr, "dispersion_measure": float(wu.header["DM"])}
        self.prepared = True
        return self

    def release(self) -> None:
        """Drop the prepared tensors (the series and the (M, T) state), so a
        resident server's device memory returns to its baseline between
        workunits; the session must be prepared again to run."""
        for name in ("ts", "state"):
            self.__dict__.pop(name, None)
        self.prepared = False

    def _candidates(self, M_host: np.ndarray, T_host: np.ndarray) -> np.ndarray:
        from ..models.search import state_to_natural

        return update_toplist_from_maxima(
            empty_candidates(),
            state_to_natural(M_host, self.geom),
            state_to_natural(T_host, self.geom),
            *self.params,
            self.base_thr,
            self.geom.window_2,
        )

    def execute(self, step_cache=None) -> int:
        """Run the prepared search to its result file; returns 0 (also
        after a quit, once the checkpoint is written) or raises one of the
        exceptions ``runtime/errors.py::exit_code_for`` maps (the
        watchdog's abort as ``RADPUL_TEMPORARY_EXIT``).  ``step_cache``
        (``runtime/scheduler.StepCache``) is handed to ``run_bank``, which
        counts its hits and misses; None (the driver) changes nothing."""
        if not self.prepared:
            self.prepare()
        with tracing.for_workunit(self.wu_id):
            return self._execute(step_cache)

    def _execute(self, step_cache) -> int:
        from ..models.search import run_bank
        from ..ops.harmonic import row_to_natural
        from ..oracle.rescore import rescore_enabled, rescore_winners, unique_winner_count

        args, adapter, bank, geom, derived = self.args, self.adapter, self.bank, self.geom, self.derived
        template_total, quarantined, batch_size = self.template_total, self.quarantined, self.batch_size
        n_mesh, dist = self._n_mesh, self._dist
        from ..parallel.distributed import shard_ranges

        # rescoring at all: --no-rescore or ERP_RESCORE=off turn it off
        rescore = args.rescore and rescore_enabled()

        # sentinel drift probe (runtime/health.py): K fixed templates re-run
        # on the card and through the host oracle at each checkpoint, armed
        # only when the health watchdog itself is on (ERP_HEALTH_EVERY > 0)
        from .health import SentinelProbe, sentinel_count
        from .health import watchdog as make_watchdog

        sentinel = None
        sentinel_wd = make_watchdog()
        if sentinel_wd is not None and sentinel_count() > 0 and template_total > 0:
            sentinel = SentinelProbe(
                lambda: self.ts, bank.P, bank.tau, bank.psi0, geom, derived, sentinel_wd, device=self.dev
            )
            erplog.debug("Sentinel drift probe armed: templates %s.\n", sentinel.indices.tolist())

        ckpt_count = metrics.counter("checkpoint.count")
        ckpt_bytes = metrics.counter("checkpoint.bytes", unit="B")
        d2h_bytes = metrics.counter("search.d2h_bytes", unit="B")
        stall_s = metrics.counter("search.drain_stall_s", unit="s")
        stall_ms = metrics.histogram("search.drain_stall_ms", metrics.LATENCY_BUCKETS_MS, unit="ms")
        # an elastic run's progress lives in the shard states on the board;
        # the global checkpoint is written only by the merge winner, after
        # the merge, so processes never race on one checkpoint path
        allow_global_ckpt = dist is None
        shard_layout = shard_ranges(template_total, dist.num_processes) if dist is not None else None
        topology = topology_record(self.process_count, shard_layout, quarantined=quarantined)
        snap = None  # the current segment's recovery point (resilience.DispatchSnapshot)

        def drain(fetch, stop: int):
            """``fetch()`` copies from the card, so the host waits there for
            every batch queued before it: the watchdog's ``drain`` guard."""
            t0 = time.perf_counter()
            with watchdog.guard("drain", stop=stop), tracing.span("drain", stop=stop):
                out = fetch()
            dt = time.perf_counter() - t0
            stall_s.inc(dt)
            stall_ms.observe(dt * 1e3)
            flightrec.record("drain", stop=stop, stall_ms=round(dt * 1e3, 3))
            return out

        def host_state(M_now, T_now, stop: int):
            M_host, T_host = drain(lambda: (M_now.cpu().numpy(), T_now.cpu().numpy()), stop)
            d2h_bytes.inc(M_host.nbytes + T_host.nbytes)
            return M_host, T_host

        def checkpoint_now(n_done: int, M_now, T_now) -> None:
            if not (allow_global_ckpt and args.checkpointfile):
                return
            with tracing.span("checkpoint", n_done=n_done):
                # host copies now: the next batch overwrites the device state
                M_host, T_host = host_state(M_now, T_now, n_done)
                if snap is not None:
                    snap.maybe_commit(M_host, T_host, n_done)
                write_now(n_done, M_host, T_host)
                if sentinel is not None:
                    with tracing.span("sentinel-probe"):
                        sentinel.probe("checkpoint")

        def write_now(n_done: int, M_host, T_host) -> None:
            cands = self._candidates(M_host, T_host)
            # transient write failures spend the shared retry budget; a
            # wedged write trips the watchdog
            with watchdog.guard("ckpt_write", n_done=n_done):
                resilience.call_with_retry(
                    lambda: write_checkpoint(
                        args.checkpointfile,
                        Checkpoint(n_template=n_done, originalfile=args.inputfile, candidates=cands),
                        bank=(args.templatebank, template_total),
                        topology=topology,
                    ),
                    site="ckpt_write",
                )
            ckpt_count.inc()
            try:
                ckpt_bytes.inc(os.path.getsize(args.checkpointfile))
            except OSError:
                pass

        interrupted = False
        last_done = self.start_template
        search_info = self.search_info
        metrics.gauge("driver.template_total").set(int(template_total))
        metrics.gauge("driver.start_template").set(int(self.start_template))
        fraction_g = metrics.gauge("driver.fraction_done")

        def progress_cb(done: int, total: int, M_now, T_now) -> bool:
            nonlocal interrupted, last_done
            last_done = done
            # the reference reports (counter+1)/total per template
            # (demod_binary.c:1420); a batch reports its exact fraction
            adapter.fraction_done(done / total)
            fraction_g.set(done / total)
            if adapter.time_to_checkpoint():
                erplog.log_message(erplog.Level.DEBUG, False, "Committing checkpoint.\n")
                checkpoint_now(done, M_now, T_now)
                adapter.checkpoint_completed()
                erplog.info("Checkpoint committed!\n")
            if adapter.search_info_due():
                # the 4-harmonic row only, and only when something listens
                row = drain(lambda: M_now[2].cpu().numpy(), done)
                if snap is not None:
                    snap.maybe_commit(M_now, T_now, done)
                search_info["power_spectrum"] = binned_spectrum(row_to_natural(row, 2, geom.fund_hi), geom.fund_hi)
                search_info["fraction_done"] = done / total
                # the current template's orbit (demod_binary.c:1213-1215)
                t_cur = min(done, template_total) - 1
                if t_cur >= 0:
                    search_info["orbital_radius"] = float(bank.tau[t_cur])
                    search_info["orbital_period"] = float(bank.P[t_cur])
                    search_info["orbital_phase"] = float(bank.psi0[t_cur])
                adapter.update_shmem(search_info)
            # a client-requested suspension parks here, between batches,
            # with the state resident on the card
            adapter.wait_while_suspended()
            # the watchdog's cooperative abort stops dispatching too, so
            # the run checkpoints and exits for a supervised restart
            if adapter.quit_requested() or watchdog.abort_requested():
                interrupted = True
                return False
            return True

        erplog.info(
            "Search on %s: %d templates from no. %d, batch %d.\n",
            self.dev, template_total, self.start_template, batch_size,
        )
        profiling.device_memory_status("search setup")
        # the card's attainable bound (runtime/roofline.py; the reference
        # logs its GFLOPS estimate the same way, cuda_utilities.c:163-182)
        roof = roofline_report(
            geom.nsamples, geom.n_unpadded, geom.fund_hi, geom.harm_hi, batch=batch_size, exact_sin=not geom.use_lut
        )
        if roof["peaks"] is None:
            erplog.debug("Roofline (%s): card not modelled.\n", roof["card"])
        else:
            erplog.debug(
                "Roofline (%s): attainable %.0f templates/s, model bound %s.\n",
                roof["card"], roof["attainable_templates_per_sec"], roof["model_bound"],
            )
        metrics.gauge("search.batch_size").set(int(batch_size))
        flightrec.record(
            "run-config", template_total=int(template_total), start_template=int(self.start_template),
            batch_size=int(batch_size), n_mesh=int(n_mesh),
        )
        self._obs_record(
            "session-search", template_total=int(template_total), start_template=int(self.start_template),
            batch_size=int(batch_size),
        )
        # quarantined windows carve the bank into runnable segments, each a
        # bounded [start, stop) window (templates >= stop are masked)
        segments = watchdog.runnable_segments(template_total, quarantined, start=self.start_template)
        state = self.state
        elastic_result = None
        # ERP_STEPTIME_PROFILE=<dir> or --profile-dir/ERP_PROFILE_DIR
        # capture the loop with torch.profiler
        with steptime.maybe_capture_profile(), profiling.trace(args.profile_dir), profiling.phase("template loop"):
            if dist is not None:
                # one process of an elastic search: it runs (and, when a
                # peer dies, adopts) template-range shards under leases;
                # whichever process wins the merge lease merges
                from ..parallel import make_mesh, run_bank_elastic
                from ..parallel.elastic import board_identity

                erplog.info(
                    "Elastic search: host %s of %d, %d-device local mesh, shard board at %s.\n",
                    dist.host_id, dist.num_processes, n_mesh, dist.shard_dir,
                )
                max_shard = max([b - a for a, b in shard_layout] or [1])
                per_dev = max(1, min(batch_size, -(-max(1, max_shard) // n_mesh)))
                elastic_result = run_bank_elastic(
                    self.ts, bank.P, bank.tau, bank.psi0, geom, make_mesh(n_mesh, platform=self.dev.type), dist,
                    board_identity(args.inputfile, args.templatebank, template_total),
                    per_device_batch=per_dev, state=state, progress_cb=progress_cb,
                )
                if elastic_result.state is not None:
                    state = tuple(torch.from_numpy(a).to(self.dev) for a in elastic_result.state)
            elif n_mesh > 1:
                # the bank sharded over the mesh; checkpoints, progress,
                # screensaver and resume through the same state and
                # callback (bitwise run_bank's, tests/test_torch_parallel.py)
                from ..parallel import make_mesh, run_bank_sharded

                erplog.info("Sharding template bank over a %d-device mesh.\n", n_mesh)
                # a global batch (n_mesh x per_dev) no larger than the
                # remaining bank, so a small bank is not mostly padding
                per_dev = min(batch_size, -(-max(1, template_total - self.start_template) // n_mesh))
                mesh = make_mesh(n_mesh, platform=self.dev.type)
                for seg_a, seg_b in segments:
                    if resilience.policy() is not None:
                        snap = resilience.DispatchSnapshot(state, seg_a)
                    state = run_bank_sharded(
                        self.ts, bank.P, bank.tau, bank.psi0, geom, mesh, per_device_batch=per_dev, state=state,
                        start_template=seg_a, stop_template=seg_b, progress_cb=progress_cb, snapshot=snap,
                    )
                    if interrupted:
                        break
            else:
                for seg_a, seg_b in segments:
                    if resilience.policy() is not None:
                        snap = resilience.DispatchSnapshot(state, seg_a)
                    state = run_bank(
                        self.ts, bank.P, bank.tau, bank.psi0, geom, batch_size=batch_size, state=state,
                        start_template=seg_a, stop_template=seg_b, progress_cb=progress_cb, snapshot=snap,
                        step_cache=step_cache,
                    )
                    if interrupted:
                        break
        # a search on the CPU: the per-stage device lane of the Chrome
        # export is estimated from the dispatch windows and the roofline
        # (runtime/devicecost.py); on the card the profiler measures it
        if tracing.enabled() and self.dev.type == "cpu":
            n_dev = devicecost.emit_estimated_timeline(geom, batch_size)
            if n_dev:
                erplog.debug("Synthesized %d estimated device-lane records.\n", n_dev)
        if interrupted or (elastic_result is not None and elastic_result.interrupted):
            erplog.warn("Quit requested! Exiting prematurely...\n")
            # elastic: no global checkpoint, the committed shard states
            # on the board are the resume point
            checkpoint_now(last_done, *state)
            if watchdog.abort_requested():
                # the checkpoint is committed: exit with the temporary-exit
                # code so --supervised (or BOINC) restarts from it
                raise RadpulError(
                    RADPUL_TEMPORARY_EXIT, "Watchdog stall: checkpointed and exiting for a supervised restart."
                )
            self._obs_record("session-interrupted", last_done=last_done)
            return 0
        if elastic_result is not None and not elastic_result.merged:
            # another process won the merge lease and writes the result
            erplog.info("Host %s done: all shards committed; the merge winner writes the result.\n", dist.host_id)
            return 0
        # the merge winner is the only writer from here on
        allow_global_ckpt = True

        # final checkpoint (demod_binary.c:1495-1499), then the toplist
        erplog.debug("Search done!\n")
        checkpoint_now(template_total, *state)
        with tracing.span("finalize"):
            cands = self._candidates(*host_state(*state, template_total))
            emitted = finalize_candidates(cands, derived.t_obs)

        if rescore and len(emitted):
            with profiling.phase("oracle rescore"):
                t0 = time.perf_counter()
                n_winners = unique_winner_count(emitted)
                # the card is idle now: each pass takes its resampled series
                # and its spectrum from it, and the host sums the harmonics
                patched, n_eval = rescore_winners(self.ts, cands, emitted, derived)
                emitted = finalize_candidates(patched, derived.t_obs)
            erplog.info(
                "Rescored %d of %d winning templates through the oracle (resampled and transformed on %s) in %.1f s.\n",
                n_eval, n_winners, self.dev, time.perf_counter() - t0,
            )

        header = ResultHeader(exec_name=EXEC_NAME)
        # quarantine gaps are named in the result header, so a validator
        # comparing against another host's file knows the coverage differs
        header.quarantined = quarantined
        if self.init_data is not None:
            # provenance from the BOINC slot (demod_binary.c:1591-1602)
            header.user_id = self.init_data.userid
            header.user_name = self.init_data.user_name
            header.host_id = self.init_data.hostid
            header.host_cpid = self.init_data.host_cpid
        result = ResultFile(candidates=emitted, t_obs=derived.t_obs, header=header)
        with tracing.span("result-write"), watchdog.guard("result_write"):
            resilience.call_with_retry(lambda: write_result_file(args.outputfile, result), site="result_write")
        if elastic_result is not None:
            # the result is durable: completing the merge lease tells the
            # waiting processes, and any later adopter, the search is done
            elastic_result.finalize_done()
        erplog.info("Data processing finished successfully!\n")
        self._obs_record("session-done", outputfile=args.outputfile)
        return 0

    def run(self, n_mesh: int = 1, dist=None) -> int:
        """prepare + execute."""
        return self.prepare(n_mesh=n_mesh, dist=dist).execute()
