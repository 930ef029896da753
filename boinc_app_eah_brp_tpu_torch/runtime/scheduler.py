"""Resident Scheduler: the card, the built kernels, the cuFFT plans and
the step cache, owned for the life of a serving process.

The one-process-per-workunit driver pays for every workunit the CUDA
context, loading the kernel libraries (``nvcc`` on a cold build
directory) and a cuFFT plan for each new transform size.  The serving tier
(``serving/server.py``) pays them once: ONE Scheduler holds

* the device (chosen once; ``"cuda"`` unless the caller asks for the CPU,
  and a Scheduler on ``cuda`` without a card raises);
* a :class:`StepCache` of the ``models/search.py::step_cache_key`` keys
  the process has warmed or run: a same-geometry workunit finds its
  kernels loaded and its plan made, so after warm-up the scoped
  ``torch.kernel_builds`` and ``torch.cufft_plans`` counters stay flat
  (a :class:`SessionResult`'s ``recompiles``, under the JAX package's
  name);
* :meth:`warm`, which builds and loads every kernel and plans cuFFT per
  :class:`WarmSpec` before the first workunit, counting ``fleet.aot_hit``
  (nothing to build or plan) and ``fleet.aot_miss``;
* one batch per geometry class, so a session without ``--batch`` does not
  size its batch from the memory its neighbour holds at that moment (a
  new batch would be a new plan);
* a one-thread prep pool, so workunit k+1's
  :meth:`~.session.Session.prepare` (parse, upload, whitening) overlaps
  workunit k's execution.  One thread, so at most one series is uploaded
  and whitened beside the executing session.  Each thread is charged to
  its own session (``metrics.charged_to``), so a kernel build or cuFFT
  plan of the overlapped prep counts in the session it prepares.

A session's wait for the card (the served queue) is an ``exec-wait`` span
of its workunit (``runtime/tracing.py``).

Per-Session isolation: every :meth:`execute` arms the hang watchdog with
THAT session's incident log, starts a fresh retry budget and fault
schedule, maps the driver's error classes to a failed
:class:`SessionResult` (the server lives on), and releases the session's
tensors when it returns.  No fallback: a kernel that fails to build or
launch fails the session.

Imports no torch at module import, like the runtime layers it drives.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

from . import faultinject, metrics, resilience, steptime, tracing, watchdog
from . import logging as erplog
from .errors import exit_code_for
from .obs import ObsContext


class StepCache:
    """The ``models/search.py::step_cache_key`` keys this process has warmed
    or run, with hit/miss accounting into the ``fleet.*`` metrics family.
    What a key stands for (the loaded kernel libraries, cuFFT's plans) is
    held by the process, so the cache holds the keys alone; they are never
    evicted: a serving process sees a handful of geometries."""

    def __init__(self):
        self._keys: set = set()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def touch(self, key) -> bool:
        """Count a hit (True) or a miss, which enters ``key``."""
        with self._lock:
            hit = key in self._keys
            if hit:
                self.hits += 1
            else:
                self.misses += 1
                self._keys.add(key)
        metrics.counter("fleet.step_cache_hit" if hit else "fleet.step_cache_miss").inc()
        return hit

    def add(self, key) -> None:
        with self._lock:
            self._keys.add(key)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._keys

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys)

    def keys(self):
        with self._lock:
            return list(self._keys)


class ClassBatches:
    """One batch per (geometry, device) class: the first one set (by a
    :class:`WarmSpec`, or chosen by ``runtime/autobatch.py`` for the
    class's first session) holds for every later session.  ``share`` is
    the task's share of the card (``init_data.xml``'s ``gpu_usage``;
    None: the whole card) that first choice is sized for.  A Session's
    ``batch_for``: the scheduler's, and the driver's over a task's
    passes."""

    def __init__(self, share: float | None = None):
        self.share = share
        self._batches: dict = {}
        self._lock = threading.Lock()

    def __call__(self, geom, device, batch: int | None = None) -> int:
        key = (geom, str(device))
        with self._lock:
            if key not in self._batches:
                if batch is None:
                    from .autobatch import choose_batch

                    batch = choose_batch(geom.nsamples, log=erplog.info, device=device, share=self.share)
                self._batches[key] = int(batch)
            elif batch is None:
                erplog.info("Batch size %d (held for this geometry class).\n", self._batches[key])
            return self._batches[key]


@dataclass
class SessionResult:
    """Outcome of one Session through the resident scheduler: the
    queue-out half of the serving API.  ``recompiles`` counts the kernel
    builds and new cuFFT plans of the session's prep and execution."""

    name: str
    code: int
    outputfile: str | None = None
    corr_id: str | None = None
    error: str | None = None
    wall_s: float = 0.0
    prepare_s: float = 0.0
    recompiles: int = 0
    step_cache_hits: int = 0
    step_cache_misses: int = 0

    @property
    def ok(self) -> bool:
        return self.code == 0


@dataclass
class WarmSpec:
    """One workunit class to warm at server start: its geometry
    (``models/search.SearchGeometry``) and batch.  Sessions of that
    geometry without ``--batch`` take this batch."""

    geom: object
    batch_size: int


def plan_packing(requests: list) -> list:
    """Order queued requests so same-geometry workunits run back to back.

    ``requests`` is a list of (key, request) pairs where ``key`` is the
    request's ``step_cache_key`` (or any hashable geometry proxy).  A
    stable grouping (first-seen key order, FIFO within a key) keeps the
    resident step hot across consecutive workunits and bounds a request's
    queue delay by the backlog of its own class plus earlier classes (no
    starvation: groups are not re-sorted by size)."""
    order: dict = {}
    for key, _ in requests:
        if key not in order:
            order[key] = len(order)
    return [
        pair[1] for _, pair in sorted(
            enumerate(requests), key=lambda e: (order[e[1][0]], e[0])
        )
    ]


class Scheduler:
    """Owns what must outlive any single workunit; executes Sessions
    serially on the device while overlapping the next Session's prep."""

    def __init__(
        self,
        *,
        device: str = "cuda",
        artifacts_dir: str | None = None,
    ):
        from ..device import resolve_device

        self.device = resolve_device(device)
        self.step_cache = StepCache()
        self.artifacts_dir = artifacts_dir
        self._exec_lock = threading.Lock()
        self._prep_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="erp-fleet-prep",
        )
        self._seq = 0
        self._seq_lock = threading.Lock()
        # one batch per (geometry, device) class, from a WarmSpec or the
        # class's first session
        self._class_batch = ClassBatches()
        self._last_exec_end: float | None = None
        self.inter_wu_gaps_s: list[float] = []
        self.warmed = False
        self.slo = None  # serving/slo.SLOMonitor, attached via arm_slo
        self._closed = False

    def arm_slo(self, monitor) -> None:
        """Attach a live serving-SLO monitor (``serving/slo.SLOMonitor``):
        every executed Session feeds it its inter-WU gap, recompile count
        and measured step latencies.  The monitor's warm-up boundary
        follows this scheduler's."""
        self.slo = monitor
        if monitor is not None:
            monitor.warmed = self.warmed

    # -- device view ------------------------------------------------------

    def n_devices(self) -> int:
        """Cards in this process (``torch.cuda.device_count()``), 1 on the
        CPU."""
        if self.device.type != "cuda":
            return 1
        import torch

        return torch.cuda.device_count()

    # -- warm-up ----------------------------------------------------------

    def warm(self, specs) -> dict:
        """Build and load the kernels and plan cuFFT for the expected
        workunit classes before the first workunit is queued
        (``models/search.py::warm_step``), and fix each class's batch.
        ``fleet.aot_hit`` counts a spec that needed no ``nvcc`` and no new
        plan (or was already in the step cache), ``fleet.aot_miss`` the
        rest.  Returns ``{"aot_hit": .., "aot_miss": .., "steps": ..}``."""
        from ..models.search import step_cache_key, warm_step

        hit_c = metrics.counter("fleet.aot_hit")
        miss_c = metrics.counter("fleet.aot_miss")
        hits = misses = built = 0
        for spec in specs:
            self._class_batch(spec.geom, self.device, spec.batch_size)
            key = step_cache_key(spec.geom, spec.batch_size, self.device)
            if key in self.step_cache:
                hits += 1
                hit_c.inc()
                continue
            # a window of its own tells a warm spec (libraries on disk and
            # plan cached) from a cold one
            probe = metrics.MetricsContext(name="fleet-warm-probe")
            probe.configure(force=True)
            t0 = time.perf_counter()
            try:
                warm_step(spec.geom, spec.batch_size, self.device)
                self.step_cache.add(key)
                made = (
                    probe.registry().counter("torch.kernel_builds").value
                    + probe.cufft_plans()
                )
            finally:
                probe.finish(0)
            built += 1
            if made == 0:
                hits += 1
                hit_c.inc()
            else:
                misses += 1
                miss_c.inc()
            erplog.debug(
                "Warm step %s batch %d in %.2fs (%d builds and plans).\n",
                "hit" if made == 0 else "miss", spec.batch_size,
                time.perf_counter() - t0, made,
            )
        self.warmed = True
        if self.slo is not None:
            self.slo.warmed = True
        metrics.gauge("fleet.warm_steps").set(len(self.step_cache))
        return {"aot_hit": hits, "aot_miss": misses, "steps": built}

    # -- session lifecycle ------------------------------------------------

    def build_session(self, args, *, corr_id: str | None = None, name: str | None = None):
        """A Session wearing its own scoped ObsContext, wired for this
        scheduler.  Env knobs (checkpoint cadence, progress threshold) are
        snapshotted NOW: per Session, never per server process."""
        from .session import Session, SessionEnv

        with self._seq_lock:
            self._seq += 1
            seq = self._seq
        sname = name or f"session-{seq}"
        obs = ObsContext(name=sname)
        dump_dir = self.artifacts_dir
        if dump_dir is None:
            for p in (args.checkpointfile, args.outputfile):
                if p:
                    dump_dir = os.path.dirname(os.path.abspath(p))
                    break
        obs.configure(
            force_metrics=True,
            dump_dir=dump_dir,
            context={
                "session": sname,
                "inputfile": args.inputfile,
                **({"corr_id": corr_id} if corr_id else {}),
            },
        )
        env = SessionEnv.capture()
        return Session(
            args, env.make_adapter(), env=env, obs=obs, corr_id=corr_id,
            batch_for=self._class_batch,
        )

    def prepare_async(self, session) -> Future:
        """Stage the session's prep on the prep pool: called for workunit
        k+1 while workunit k still runs."""
        return self._prep_pool.submit(self._prepare, session)

    @staticmethod
    def _prepare(session):
        with metrics.charged_to(_window(session)):
            return session.prepare()

    @contextlib.contextmanager
    def _exec_slot(self, session):
        """The card for ``session`` alone (``_exec_lock``); the wait for it
        is an ``exec-wait`` span of the session's workunit."""
        with tracing.for_workunit(session.wu_id), tracing.span("exec-wait"):
            self._exec_lock.acquire()
        try:
            yield
        finally:
            self._exec_lock.release()

    def execute(self, session, prep_future: Future | None = None) -> SessionResult:
        """Run one (possibly pre-prepared) Session on the device,
        serialized against every other Session, and release its tensors.
        Never raises for the driver's mapped error classes: a poisoned
        workunit yields a failed SessionResult and the server lives on."""
        args = session.args
        name = session.obs.name if session.obs is not None else "session"
        corr_id = session.corr_id
        prep_s = 0.0
        code: int | None = None
        err: str | None = None
        gap_s: float | None = None
        step_cursor = steptime.count()
        with self._exec_slot(session):
            t0 = time.perf_counter()
            if self._last_exec_end is not None:
                gap_s = t0 - self._last_exec_end
                self.inter_wu_gaps_s.append(gap_s)
                metrics.histogram(
                    "fleet.inter_wu_gap_ms", metrics.LATENCY_BUCKETS_MS,
                    unit="ms",
                ).observe(gap_s * 1e3)
            # per-Session attach: fresh retry budget, fresh fault schedule,
            # THIS session's incident log on the hang watchdog; quarantine
            # state stays per workunit, not per server
            faultinject.configure()
            resilience.begin_run()
            incident_path = watchdog.default_incident_path(args.checkpointfile)
            watchdog.arm(
                incident_log=(
                    watchdog.IncidentLog(incident_path)
                    if incident_path else None
                )
            )
            hits0, misses0 = self.step_cache.hits, self.step_cache.misses
            try:
                try:
                    with metrics.charged_to(_window(session)):
                        if prep_future is not None:
                            t_p = time.perf_counter()
                            prep_future.result()
                            prep_s = time.perf_counter() - t_p
                        elif not session.prepared:
                            t_p = time.perf_counter()
                            session.prepare()
                            prep_s = time.perf_counter() - t_p
                        code = session.execute(step_cache=self.step_cache)
                except Exception as e:  # mapped driver errors -> result
                    mapped = exit_code_for(e)
                    if mapped is None:
                        raise
                    erplog.error("%s\n", str(e))
                    if session.obs is not None and session.obs.flightrec.armed():
                        session.obs.flightrec.dump(
                            f"session-exit-{mapped}", exc=e
                        )
                    code = mapped
                    err = f"{type(e).__name__}: {e}"
            finally:
                session.release()
                watchdog.disarm()
                self._last_exec_end = time.perf_counter()
            wall = self._last_exec_end - t0
        recompiles = self._session_recompiles(session)
        metrics.counter("fleet.sessions").inc()
        if code != 0:
            metrics.counter("fleet.sessions_failed").inc()
        metrics.counter("fleet.session_wall_s", unit="s").inc(wall)
        if session.obs is not None:
            session.obs.close(
                code, context={
                    "session": name,
                    **({"corr_id": corr_id} if corr_id else {}),
                },
            )
        result = SessionResult(
            name=name,
            code=int(code) if code is not None else -1,
            outputfile=args.outputfile,
            corr_id=corr_id,
            error=err,
            wall_s=wall,
            prepare_s=prep_s,
            recompiles=recompiles,
            step_cache_hits=self.step_cache.hits - hits0,
            step_cache_misses=self.step_cache.misses - misses0,
        )
        if self.slo is not None:
            try:  # monitoring must never take down serving
                from ..serving.slo import slo_key

                self.slo.observe_session(
                    slo_key(args), result,
                    step_ms=[
                        r["ms"] for r in steptime.records(since=step_cursor)
                    ],
                    gap_s=gap_s,
                )
            except Exception:
                pass
        return result

    def process(self, args, *, corr_id: str | None = None) -> SessionResult:
        """build + prepare + execute, blocking: the in-process
        equivalent of one driver subprocess."""
        return self.execute(self.build_session(args, corr_id=corr_id))

    @staticmethod
    def _session_recompiles(session) -> int:
        """Kernel builds plus new cuFFT plans in the session's scoped
        window: those of its prep and its execution, each on a thread
        charged to the session."""
        m = _window(session)
        if m is None:
            return 0
        return int(m.registry().counter("torch.kernel_builds").value) + m.cufft_plans()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._prep_pool.shutdown(wait=True, cancel_futures=True)


def _window(session):
    """The session's scoped metrics window, or None (no scoped bundle, or
    metrics off)."""
    if session.obs is None or not session.obs.metrics.enabled():
        return None
    return session.obs.metrics
