"""Multi-host elastic search: shard leases, adoption, and the final merge.

Counterpart of the JAX package's ``parallel/elastic.py``, with its file
formats (``erp-shard-state/1`` beside the ``runtime/resilience.py``
board), so a board and the shard states one package writes the other
joins and loads.  ``run_bank_elastic`` is the host-level twin of
``run_bank_sharded``'s snapshot/attempt/recover loop: where that loop
retries BATCHES inside one process, this one runs a claim/run/commit loop
over (host, template-range) LEASES so an entire dead host becomes a
recoverable fault.  Mechanics:

* The bank is cut into ``num_processes`` contiguous ranges
  (``distributed.shard_ranges``); each host prefers its own shard but any
  host can adopt any incomplete shard whose owner's heartbeat went stale
  (``runtime.resilience.LeaseBoard`` — the new host-loss rung of the
  degradation ladder).
* Inside a shard the work is exactly ``run_bank_sharded`` over this
  process's mesh with ``start_template``/``stop_template`` bounding the
  window — nothing crosses processes but files, so a dead host cannot hang
  a survivor.
* Progress commits at checkpoint cadence: the (M, T) maxima state goes to
  an npz + ``erp-shard-state/1`` sidecar (sha256, range, layout) on the
  shared shard dir, then the lease's ``n_done`` advances.  A commit that
  discovers a higher lease epoch means this host was presumed dead and the
  shard was adopted — it abandons the shard instead of double-writing.
* When every shard is complete the hosts race for the ``merge`` pseudo-
  lease; the winner folds all shard states with the same idempotent
  (power desc, template index asc) merge the sharded search uses, so the
  result is byte-identical to an uninterrupted single-process run no
  matter how many times ranges were re-run or re-adopted.  The merge
  lease is marked complete only after the driver finishes the result
  write (``ElasticResult.finalize_done``), so losing the winner mid-
  finalize is survivable too.

No collective: the cross-host "merge at checkpoint boundaries" is
host-side numpy over tiny (5, W) states.
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass

import numpy as np

from ..runtime import faultinject, flightrec, metrics, resilience, tracing, watchdog
from ..runtime import logging as erplog
from ..runtime.resilience import MERGE_SHARD, LeaseBoard, ShardLease, _host_copy
from .distributed import DistributedConfig, shard_ranges
from .sharded_search import run_bank_sharded

SHARD_STATE_SCHEMA = "erp-shard-state/1"

ENV_COMMIT_S = "ERP_SHARD_COMMIT_S"  # shard-state commit cadence; 0 = every cb
ENV_WAIT_S = "ERP_ELASTIC_WAIT_S"  # bound on waiting for other hosts


class ShardStateError(RuntimeError):
    """A shard state file failed integrity or layout validation."""


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_shard_state(
    root: str,
    lease: ShardLease,
    M: np.ndarray,
    T: np.ndarray,
    n_done: int,
    n_templates: int,
) -> str:
    """Persist a shard's (M, T) maxima at ``n_done`` templates into the
    shard dir; returns the state path for the lease.  The file is named by
    (shard, owner, epoch) so a slow not-actually-dead former owner can
    never clobber an adopter's state, and written tmp+fsync+rename so a
    kill mid-write leaves the previous commit intact."""
    name = f"state-s{lease.shard}.{lease.owner}.e{lease.epoch}.npz"
    path = os.path.join(root, name)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            M=np.asarray(M, dtype=np.float32),
            T=np.asarray(T, dtype=np.int32),
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    doc = {
        "schema": SHARD_STATE_SCHEMA,
        "shard": lease.shard,
        "start": lease.start,
        "stop": lease.stop,
        "n_done": int(n_done),
        "n_templates": int(n_templates),
        "owner": lease.owner,
        "epoch": lease.epoch,
        "sha256": _sha256(path),
        "shape_M": list(np.asarray(M).shape),
    }
    resilience._write_json_atomic(path + ".json", doc)
    return path


def load_shard_state(
    path: str, shard: int, n_templates: int
) -> tuple[np.ndarray, np.ndarray, dict]:
    """Load + validate a committed shard state: sidecar present, digest
    matches, and the record describes the same shard of the same bank —
    anything else raises :class:`ShardStateError` rather than silently
    merging a foreign or torn state."""
    doc = resilience._read_json(path + ".json")
    if doc is None:
        raise ShardStateError(f"Shard state sidecar missing: {path}.json")
    if doc.get("schema") != SHARD_STATE_SCHEMA:
        raise ShardStateError(
            f"Bad shard state schema in {path}.json: {doc.get('schema')!r}"
        )
    if int(doc.get("shard", -2)) != shard:
        raise ShardStateError(
            f"{path} records shard {doc.get('shard')}, expected {shard}."
        )
    if int(doc.get("n_templates", -1)) != n_templates:
        raise ShardStateError(
            f"{path} was written for a {doc.get('n_templates')}-template "
            f"bank, this run has {n_templates} — refusing to merge across "
            f"different banks."
        )
    digest = _sha256(path)
    if digest != doc.get("sha256"):
        raise ShardStateError(
            f"Shard state digest mismatch for {path}: sidecar has "
            f"{doc.get('sha256')}, file is {digest}."
        )
    with np.load(path) as z:
        M = np.array(z["M"], dtype=np.float32)
        T = np.array(z["T"], dtype=np.int32)
    if not np.all(np.isfinite(M) | (M <= np.float32(-3.0e38))):
        raise ShardStateError(f"Non-finite powers in shard state {path}.")
    return M, T, doc


def merge_states(
    states: list[tuple[np.ndarray, np.ndarray]],
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side fold of per-shard (M, T) maxima with the exact semantics
    of the sharded search's fold (``sharded_search._merge_take``): strictly
    greater power wins, ties keep the smaller global template index.
    Idempotent — overlapping or re-run coverage merges to the same state,
    which is what makes adoption replay byte-safe."""
    if not states:
        raise ValueError("merge_states needs at least one state")
    M, T = (np.array(a, copy=True) for a in states[0])
    for oM, oT in states[1:]:
        take = (oM > M) | ((oM == M) & (oT < T))
        M = np.where(take, oM, M)
        T = np.where(take, oT, T)
    return M, T


@dataclass
class ElasticResult:
    """Outcome of one host's ``run_bank_elastic`` participation."""

    state: tuple | None  # merged (M, T); None for non-winners
    merged: bool  # this host won the merge lease (writes the result)
    interrupted: bool  # quit requested; shard states are the durable state
    board: LeaseBoard | None = None
    merge_lease: ShardLease | None = None

    def finalize_done(self) -> None:
        """Mark the merge complete — called by the driver AFTER the result
        file is durably written, so a winner dying mid-finalize leaves the
        merge lease adoptable by a survivor."""
        if self.board is not None and self.merge_lease is not None:
            self.board.update(self.merge_lease, complete=True)


def board_identity(
    inputfile: str, bank_path: str, n_templates: int
) -> dict:
    """What every host must agree on before sharing a shard dir."""
    return {
        "inputfile": os.path.basename(inputfile),
        "bank": os.path.basename(bank_path),
        "n_templates": int(n_templates),
    }


def run_bank_elastic(
    ts,
    bank_P,
    bank_tau,
    bank_psi0,
    geom,
    mesh,
    dist: DistributedConfig,
    identity: dict,
    per_device_batch: int = 16,
    state=None,
    progress_cb=None,
    board: LeaseBoard | None = None,
) -> ElasticResult:
    """Claim/run/commit loop over shard leases; see the module docstring.

    ``state`` seeds every shard window (resume "virtual templates" ride
    along; the idempotent merge makes re-seeding per shard harmless).
    ``progress_cb(done, total, M, T)`` is the driver's callback — it sees
    GLOBAL progress summed over the board and may return False to quit.
    The merged state comes back as host numpy arrays.
    """
    import torch

    n = len(bank_P)
    ranges = shard_ranges(n, dist.num_processes)
    if board is None:
        board = LeaseBoard(
            dist.shard_dir
            if dist.shard_dir is not None
            else os.path.join(".", "erp-shards"),
            dist.host_id,
        )
    board.publish_board(n, ranges, identity)
    board.heartbeat()
    commit_s = max(0.0, _env_float(ENV_COMMIT_S, 30.0))
    wait_s = max(1.0, _env_float(ENV_WAIT_S, 3600.0))
    seed_host = None if state is None else (_host_copy(state[0]), _host_copy(state[1]))
    metrics.gauge("elastic.num_processes").set(dist.num_processes)
    m_shards = metrics.counter("elastic.shards_run")
    m_commits = metrics.counter("elastic.state_commits")

    def global_done() -> int:
        done = 0
        for k, (a, b) in enumerate(ranges):
            lease = board.read_lease(k)
            if lease is None:
                continue
            done += (b - a) if lease.complete else (lease.n_done - a)
        return done

    interrupted = False

    def run_lease(lease: ShardLease) -> None:
        """Run one shard window to completion (or quit/abandonment),
        committing state + lease at ``commit_s`` cadence."""
        nonlocal lease_ref, interrupted
        lease_ref = lease
        a, b = lease.start, lease.stop
        if seed_host is not None:
            shard_state = (np.array(seed_host[0], copy=True),
                           np.array(seed_host[1], copy=True))
        else:
            shard_state = None
        resume_at = a
        if lease.state_path is not None:
            M0, T0, doc = load_shard_state(lease.state_path, lease.shard, n)
            resume_at = int(doc["n_done"])
            shard_state = (
                (M0, T0)
                if shard_state is None
                else merge_states([shard_state, (M0, T0)])
            )
            erplog.info(
                "Resuming shard %d at template %d (committed by %s, "
                "epoch %d).\n",
                lease.shard, resume_at, doc["owner"], doc["epoch"],
            )
        m_shards.inc()
        flightrec.record(
            "shard-run", shard=lease.shard, start=a, stop=b,
            resume_at=resume_at, epoch=lease.epoch,
        )
        if resume_at >= b:
            # nothing left (empty shard or fully committed): just complete
            if shard_state is None:
                Mh = Th = None
            else:
                Mh, Th = shard_state
            finish_lease(lease, Mh, Th, b)
            return
        home = mesh.devices[0]
        dev_state = (
            None
            if shard_state is None
            else tuple(torch.from_numpy(np.array(a)).to(home) for a in shard_state)
        )
        last_commit = time.monotonic()

        def shard_cb(done, total, M_now, T_now):
            nonlocal lease_ref, last_commit, interrupted
            board.heartbeat()
            due = (
                commit_s == 0.0
                or time.monotonic() - last_commit >= commit_s
            )
            quitting = False
            if progress_cb is not None:
                base = global_done()
                # the board's n_done for OUR lease lags the live loop;
                # swap in the fresh value for this shard
                base -= max(0, lease_ref.n_done - a)
                if progress_cb(min(n, base + (done - a)), n, M_now, T_now) is False:
                    quitting = True
            if quitting:
                interrupted = True
            if due or quitting:
                committed = commit_state(lease_ref, M_now, T_now, done)
                last_commit = time.monotonic()
                if committed is None:
                    # Adopted away: abandon the shard.  lease_ref MUST be
                    # cleared so run_lease does not finish_lease the
                    # partial (M, T) the early-stopped loop returns —
                    # that would write a state file whose sidecar claims
                    # n_done == stop over partial content, and the next
                    # adopter (which trusts the sidecar's n_done over the
                    # lease's, because a crash between state write and
                    # lease update legitimately leaves the file ahead)
                    # would mark the shard complete with maxima missing.
                    lease_ref = None
                    return False
                lease_ref = committed
            if quitting:
                board.update(lease_ref, released=True)
                return False
            return True

        M, T = run_bank_sharded(
            ts, bank_P, bank_tau, bank_psi0, geom, mesh,
            per_device_batch=per_device_batch,
            state=dev_state, start_template=resume_at, stop_template=b,
            progress_cb=shard_cb,
        )
        if interrupted or lease_ref is None:
            return
        finish_lease(lease_ref, M, T, b)

    def commit_state(lease, M_now, T_now, done) -> ShardLease | None:
        with tracing.span(
            "shard-commit", shard=lease.shard, n_done=int(done)
        ):
            path = write_shard_state(
                board.root, lease, _host_copy(M_now), _host_copy(T_now),
                int(done), n,
            )
            m_commits.inc()
            return board.update(lease, n_done=int(done), state_path=path)

    def finish_lease(lease, M, T, b) -> None:
        nonlocal lease_ref
        if M is not None:
            path = write_shard_state(
                board.root, lease, _host_copy(M), _host_copy(T), b, n
            )
            m_commits.inc()
            lease = board.update(
                lease, n_done=b, state_path=path, complete=True
            )
        else:
            lease = board.update(lease, n_done=b, complete=True)
        lease_ref = lease
        if lease is not None:
            flightrec.record(
                "shard-complete", shard=lease.shard, stop=b
            )

    lease_ref: ShardLease | None = None
    n_shards = len(ranges)
    deadline = time.monotonic() + wait_s
    # pass 1: our own shard first, then sweep for adoptable work until
    # the whole board is complete (or quit)
    poll_s = min(0.2, board.timeout_s / 4.0)
    while not interrupted:
        if watchdog.abort_requested():
            # the hang doctor wants out: stop claiming, leave committed
            # shard state as the durable resume point and let the driver
            # map this to the temporary-exit rc
            interrupted = True
            break
        board.heartbeat()
        claimed = None
        for k in sorted(range(n_shards), key=lambda k: (k != dist.process_id, k)):
            a, b = ranges[k]
            lease = board.try_claim(k, a, b, preferred_owner=f"host{k}")
            if lease is not None:
                claimed = lease
                break
        if claimed is not None:
            run_lease(claimed)
            deadline = time.monotonic() + wait_s
            continue
        leases = board.leases(n_shards)
        if all(l is not None and l.complete for l in leases.values()):
            break
        if time.monotonic() > deadline:
            raise resilience.LeaseError(
                f"Shard board did not complete within {wait_s:.0f}s; "
                f"incomplete shards: "
                f"{[k for k, l in leases.items() if l is None or not l.complete]}"
            )
        time.sleep(poll_s)

    if interrupted:
        erplog.warn(
            "Quit requested: shard leases released; the shard states on "
            "%s are the durable resume point.\n", board.root,
        )
        return ElasticResult(state=None, merged=False, interrupted=True)

    # merge race: winner folds all shard states; a winner that dies here
    # is adoptable because the merge lease only completes after the
    # driver's result write (ElasticResult.finalize_done)
    while True:
        if watchdog.abort_requested():
            return ElasticResult(state=None, merged=False, interrupted=True)
        board.heartbeat()
        merge_lease = board.try_claim(MERGE_SHARD, 0, n)
        if merge_lease is not None:
            break
        cur = board.read_lease(MERGE_SHARD)
        if cur is not None and cur.complete:
            erplog.info(
                "Host %s completed the merge; this host is done.\n",
                cur.owner,
            )
            return ElasticResult(state=None, merged=False, interrupted=False)
        if time.monotonic() > deadline:
            raise resilience.LeaseError(
                f"Merge did not complete within {wait_s:.0f}s "
                f"(owner: {cur.owner if cur else None})."
            )
        time.sleep(poll_s)

    with tracing.span("elastic-merge"), watchdog.guard("merge", n_shards=n_shards):
        faultinject.fault_point("merge", n_shards=n_shards)
        states = []
        for k, (a, b) in enumerate(ranges):
            if a == b:
                continue
            lease = board.read_lease(k)
            if lease is None or not lease.complete:
                raise resilience.LeaseError(
                    f"Merge started with shard {k} incomplete."
                )
            if lease.state_path is None:
                continue  # empty-range shard completed without state
            M, T, _doc = load_shard_state(lease.state_path, k, n)
            states.append((M, T))
        if seed_host is not None:
            states.append(seed_host)
        M, T = merge_states(states)
    flightrec.record(
        "elastic-merge", n_shards=n_shards, host=dist.host_id
    )
    erplog.info(
        "Merged %d shard states on %s; finalizing the search.\n",
        len(states), dist.host_id,
    )
    return ElasticResult(
        state=(M, T), merged=True, interrupted=False,
        board=board, merge_lease=merge_lease,
    )
