"""Template-bank sharding over the devices of a mesh.

Counterpart of the JAX package's ``parallel/sharded_search.py``.  A global
step covers ``n_shards * per_device_batch`` contiguous templates: shard
``i`` takes block ``i`` and runs the port's :class:`BankStep` on its own
device (kernels A, B, the rfft and C, and on unwhitened runs the pad means
of its slice of the bank, computed ahead by the exact-mean kernel), into a
(M, T) state of its own.  Template indices in every T are global.  Padded
slots and templates past ``stop_template`` can never claim a bin: the
step masks them as it masks a last batch's padding.

The shards' states are folded with ``_merge_take`` only where the host
needs (M, T): at each progress callback, where the health watchdog reads
its vector, and at the end.  Strictly greater power wins; equal power
keeps the smaller global template index.  Inside a shard the templates
arrive in ascending order, so its strict ``>`` keeps the earliest; across
shards the indices must be compared.  The fold is idempotent and
order-free (``parallel/elastic.py::merge_states`` is the same fold on the
host), so merging late gives what merging every step would.  It is plain
``torch.where`` ops, as the JAX package's is ``jnp`` ops.

Shards that share a device share its current stream, so the merge, queued
after them on that stream, reads every shard's last state.  A shard on
another card is copied to the first shard's card by ``Tensor.to``, which
orders the copy after the source stream's work with events.  The loop
never waits on the host: the stream queues ahead as in ``run_bank``.

The recovery ladder is ``run_bank``'s: a transient failure re-enters the
loop from the last host snapshot under the shared retry budget, and a
device out-of-memory halves the per-device batch.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..models.search import (
    BankStep,
    bank_params_host,
    init_state,
    upload_bank,
    validate_bank_bounds,
)
from ..ops.resample import exact_mean_params
from ..runtime.devicecost import stage_scope
from .distributed import shard_ranges
from .mesh import Mesh


def _merge_take(oM, oT, M, T):
    """Elementwise lexicographic (power desc, template index asc) merge."""
    take = (oM > M) | ((oM == M) & (oT < T))
    return torch.where(take, oM, M), torch.where(take, oT, T)


def merge_shard_states(states, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The fold of per-shard (M, T) states on ``device`` (a single state
    comes back as it is: the live tensors of a one-shard mesh)."""
    with stage_scope("allreduce"):
        M, T = (a.to(device) for a in states[0])
        for oM, oT in states[1:]:
            M, T = _merge_take(oM.to(device), oT.to(device), M, T)
        return M, T


def _on(device: torch.device):
    """Make ``device`` current for a shard's launches (the kernels' C
    entries set the current card), and restore the caller's after."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class ShardedBankStep:
    """One global step over a mesh: a :class:`BankStep` per shard, each
    with its own resident copy of the bank (one upload per distinct
    device), its (M, T) state seeded from ``state`` and, on unwhitened
    geometries, the resident pad means ``means`` (float32 of the templates
    ``[means_from, means_from + len)``, on any device)."""

    def __init__(
        self, geom, mesh: Mesh, per_device_batch: int, params, state=None, means=None, means_from: int = 0,
        with_health: bool = False,
    ):
        self.mesh = mesh
        self.per_dev = int(per_device_batch)
        self.with_health = bool(with_health)
        B = mesh.size * self.per_dev
        banks, mean_bufs = {}, {}
        self.steps = []
        for d in mesh.devices:
            key = str(d)
            if key not in banks:
                banks[key] = upload_bank(params, B, d)
                if means is not None:
                    buf = torch.zeros(banks[key].shape[0], dtype=torch.float32, device=d)
                    buf[means_from : means_from + means.shape[0]] = means.to(d)
                    mean_bufs[key] = buf
            seed = init_state(geom, d) if state is None else tuple(a.to(d, copy=True) for a in state)
            self.steps.append(
                BankStep(geom, banks[key], self.per_dev, state=seed, mean=mean_bufs.get(key), with_health=with_health)
            )
        self.bank_bytes = sum(b.nbytes for b in banks.values())

    def __call__(self, series: dict, t_offset: int, n_total: int):
        """Queue the global step at ``t_offset`` (``series``: the time
        series on each shard's device, keyed by ``str(device)``); returns
        the health vectors of the shards that ran (empty without health)."""
        vecs = []
        for i, step in enumerate(self.steps):
            off = t_offset + i * self.per_dev
            if off >= n_total:
                break  # every later slot is masked: nothing to add
            d = self.mesh.devices[i]
            with _on(d):
                out = step(series[str(d)], off, n_total)
            if self.with_health:
                vecs.append(out[2])
        return vecs

    def merged(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The fold of every shard's (M, T), on the first shard's device."""
        return merge_shard_states([(s.M, s.T) for s in self.steps], self.mesh.devices[0])

    def health_vec(self, vecs, M: torch.Tensor) -> torch.Tensor:
        """The mesh-wide health vector of one global step from the shards'
        vectors: non-finite counts summed, finite max and min over the
        shards, and the merged state's non-finite count."""
        v = torch.stack([x.to(M.device) for x in vecs])
        nf_state = (~torch.isfinite(M)).sum().to(torch.float32)
        return torch.stack([v[:, 0].sum(), nf_state, v[:, 2].amax(), v[:, 3].amin()])


# the JAX package's name for the sharded twin of a batch step
make_sharded_batch_step = ShardedBankStep


def _exact_means(series: dict, params, geom, mesh: Mesh, start: int, n_stop: int) -> torch.Tensor:
    """The pad means of templates ``[start, n_stop)``: shard ``i`` takes
    the ``i``-th contiguous slice in one exact-mean launch on its device;
    the slices meet on the first shard's device."""
    rows = np.stack([np.asarray(a, dtype=np.float32) for a in params], axis=1)[start:n_stop]
    parts = []
    for i, (a, b) in enumerate(shard_ranges(n_stop - start, mesh.size)):
        if a == b:
            continue
        d = mesh.devices[i]
        with _on(d), stage_scope("serial_mean"):
            mean = exact_mean_params(
                series[str(d)], torch.from_numpy(rows[a:b]).to(d),
                n_unpadded=geom.n_unpadded, dt=geom.dt, exact_sin=not geom.use_lut,
            )[1]
        parts.append(mean.to(mesh.devices[0]))
    return torch.cat(parts)


def run_bank_sharded(
    ts: torch.Tensor,
    bank_P: np.ndarray,
    bank_tau: np.ndarray,
    bank_psi0: np.ndarray,
    geom,
    mesh: Mesh,
    per_device_batch: int = 16,
    state=None,
    start_template: int = 0,
    stop_template: int | None = None,
    progress_cb=None,
    snapshot=None,
    recover: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Search templates ``[start_template, stop_template)`` of the bank
    over ``ts`` on every shard of ``mesh``, merging into ``state`` (zeroed
    when None); returns the merged (M, T) on the first shard's device.
    The contract is ``models.search.run_bank``'s with global steps of
    ``mesh.size * per_device_batch`` templates: ``progress_cb(done, total,
    M, T)`` sees the merged state after each global step and may stop the
    loop with ``False``; ``snapshot`` is the recovery point the caller
    refreshes, and without one the loop restarts from ``state``.
    ``ERP_RETRY_BUDGET=0`` or ``recover=False`` runs one attempt.

    ``stop_template`` bounds the window, as the multi-process search runs
    one such window per shard lease (``parallel/elastic.py``)."""
    from ..runtime import flightrec, resilience

    validate_bank_bounds(geom, bank_P, bank_tau, bank_psi0)
    n = len(bank_P)
    n_stop = n if stop_template is None else min(n, int(stop_template))
    params = bank_params_host(bank_P, bank_tau, bank_psi0, geom.dt)
    ts = ts.contiguous()
    series = {}
    for d in mesh.devices:
        series.setdefault(str(d), ts if ts.device == d else ts.to(d))
    means = None
    if geom.exact_mean and start_template < n_stop:
        means = (start_template, _exact_means(series, params, geom, mesh, start_template, n_stop))
    attempt = dict(
        series=series, params=params, geom=geom, mesh=mesh, n=n, n_stop=n_stop, means=means, progress_cb=progress_cb
    )
    pol = resilience.policy() if recover else None
    if pol is None:
        return _run_bank_sharded_attempt(per_dev=per_device_batch, state=state, start=start_template, **attempt)
    snap = snapshot if snapshot is not None else resilience.DispatchSnapshot(state, start_template)
    ladder = resilience.DegradationLadder(pol, per_device_batch)
    cur_state, cur_start = state, start_template
    while True:
        try:
            return _run_bank_sharded_attempt(per_dev=ladder.batch_size, state=cur_state, start=cur_start, **attempt)
        except Exception as e:
            if not ladder.record_failure("dispatch", e):
                raise
            oom = resilience.is_oom(e)
        # out of the except block: the failed attempt's tensors are gone
        if oom:
            resilience.release_device_memory()
        ladder.sleep()
        host_state, cur_start = snap.restore()
        cur_state = None if host_state is None else tuple(torch.from_numpy(np.array(a)) for a in host_state)
        flightrec.record(
            "redispatch", start=cur_start, per_device_batch=ladder.batch_size, attempt=ladder.attempt,
        )


def _run_bank_sharded_attempt(series, params, geom, mesh, n, n_stop, means, progress_cb, per_dev, state, start):
    """One pass of the sharded loop over ``[start, n_stop)`` at ``per_dev``
    templates a shard: build the shards' steps, then one global step per
    ``mesh.size * per_dev`` templates, bracketed for the metrics, the
    trace, the flight recorder, the watchdog (``dispatch``) and the fault
    points ``h2d`` and ``dispatch``, as in ``run_bank``."""
    from ..runtime import faultinject, flightrec, metrics, steptime, tracing, watchdog
    from ..runtime.health import watchdog as health_watchdog

    wd = health_watchdog()
    home = mesh.devices[0]
    B = mesh.size * per_dev
    faultinject.fault_point("h2d", loop="run_bank_sharded")
    mean_kw = {} if means is None else dict(means=means[1], means_from=means[0])
    step = ShardedBankStep(geom, mesh, per_dev, params, state=state, with_health=wd is not None, **mean_kw)

    metrics.gauge("sharded.mesh_devices").set(int(mesh.size))
    metrics.gauge("sharded.per_device_batch").set(int(per_dev))
    m_batches = metrics.counter("search.batches")
    m_templates = metrics.counter("search.templates")
    m_dispatch_s = metrics.counter("search.dispatch_wall_s", unit="s")
    m_batch_ms = metrics.histogram("sharded.batch_ms", metrics.LATENCY_BUCKETS_MS, unit="ms")
    metrics.counter("search.h2d_bytes", unit="B").inc(step.bank_bytes)
    metrics.counter("search.prefetch_wait_s", unit="s")
    # the bracket of the first shard's card (its stream carries every
    # shard that shares it)
    st = steptime.recorder(home)
    for start_b in range(start, n_stop, B):
        stop = min(start_b + B, n_stop)
        tracing.new_context()
        st.begin()
        t0 = time.perf_counter()
        with watchdog.guard("dispatch", start=start_b, stop=stop):
            faultinject.fault_point("dispatch", start=start_b, stop=stop)
            with tracing.span("dispatch", start=start_b, stop=stop):
                vecs = step(series, start_b, n_stop)
                if wd is not None:
                    M, T = step.merged()
                    wd.push(start_b, stop, step.health_vec(vecs, M))
        dt = time.perf_counter() - t0
        st.observe(step.steps[0].M, start_b, stop)
        m_dispatch_s.inc(dt)
        m_batch_ms.observe(dt * 1e3)
        m_batches.inc()
        m_templates.inc(stop - start_b)
        flightrec.record("dispatch", start=start_b, stop=stop, ms=round(dt * 1e3, 3))
        flightrec.note_dispatch(
            loop="run_bank_sharded", start=start_b, stop=stop, n_total=n, mesh_devices=mesh.size,
            per_device_batch=per_dev,
        )
        if wd is not None:
            wd.maybe_check("run_bank_sharded")
        if progress_cb is not None:
            M, T = step.merged()
            if progress_cb(stop, n, M, T) is False:
                break
    if wd is not None:
        wd.check("run_bank_sharded")
    st.flush()
    return step.merged()
