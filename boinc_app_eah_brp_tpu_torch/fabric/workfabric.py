"""Work-fabric simulator: the server half of BOINC's volunteer fabric.

Drives hundreds-to-thousands of concurrent volunteer streams through the
``issue -> compute -> report -> validate -> grant/retry`` state machine
that the reference app's real deployment ran on (the BOINC server side
of Einstein@Home).  The scheduler itself is host code: the honest
reference results are computed ONCE per payload by a real search (a
driver subprocess, or the resident serving tier through
:class:`ServerBackend`, see ``tools/fabric_soak.py``) or synthesized by
tests, and each volunteer stream is a thread replaying, mutating,
delaying or withholding those bytes through a
:class:`~.hosts.HostModel`.

State machine (per workunit)::

                 +----------------------------------------------+
                 v                                              | re-issue
    PENDING -> ISSUED -> (reports arrive) -> VALIDATING --agree--> GRANTED
                 |                               |
                 |  deadline passes              | disagree: escalate
                 +-> TIMEOUT (host demoted) -----+   target replicas +1

* **Quorum** — a workunit is granted when the validator
  (``fabric/validator.py``) finds an agreeing replica pair (strict tier
  preferred), or — the adaptive-replication fast path — when a single
  intrinsically-valid result arrives from a host that is *still trusted
  at report time* and the assignment was not chosen for a spot-check.
  A deadline expiry or invalid replica closes the fast path for that
  WU: the target escalates to a full quorum, so a re-issued replica
  landing on an arbitrary host is never granted on intrinsic checks
  alone.
* **Reputation** — ``trust_after`` consecutive validated results make a
  host trusted (quorum-2 drops to quorum-1 + spot-checks); one invalid
  result or timeout demotes it instantly and its pending work escalates.
* **Retry/timeout/backoff** — replica deadlines, re-issue backoff and
  transient-validator-error retries all draw from
  ``runtime/resilience.py``'s :class:`RetryPolicy` machinery.
* **Observability** — every transition lands in ``fabric.*`` counters /
  gauges (``runtime/metrics.py``) and flight-recorder events
  (``runtime/flightrec.py``): ``fabric-issue``, ``fabric-report``,
  ``fabric-reject``, ``fabric-grant``, ``fabric-reissue``,
  ``fabric-timeout``, ``fabric-escalate``, ``fabric-trust``,
  ``fabric-demote``.  Each validation round writes a signed
  ``erp-quorum/1`` verdict artifact.  Every workunit is minted a
  **correlation id** at first issue; it tags all of the above
  (``wu_id``/``host_id``/``corr`` fields), the verdict docs, the
  per-host labeled metrics, the exact-latency ``erp-wu-lifecycle/1``
  export (:meth:`Fabric.export_lifecycle`) and — when tracing is armed
  — per-WU ``wu:*`` lanes in the Chrome trace, so one WU's
  issue→compute→report→validate→grant story reads end-to-end across
  threads and artifacts.  Pass a scoped ``runtime/obs.ObsContext`` as
  ``Fabric(obs=...)`` to isolate all of it from the process defaults.

The scheduler NEVER consults host-model ground truth — only validator
verdicts; ground truth exists so soaks can assert zero lied reports were
granted.  Nothing here imports torch until a :class:`ServerBackend` is
built.  States, counters, events, the summary and the
``erp-wu-lifecycle/1`` export are the JAX package's
``fabric/workfabric.py``'s.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field

from ..runtime import flightrec, metrics, tracing
from ..runtime import logging as erplog
from ..runtime.resilience import RetryPolicy, call_with_retry
from .hosts import HostModel, HostReputation
from .validator import (
    QuorumOutcome,
    Replica,
    compare_replicas,
    validate_quorum,
    validate_single,
)

# assignment states
ISSUED = "issued"
REPORTED = "reported"
VALID = "valid"
INVALID = "invalid"
TIMEOUT = "timeout"
OBSOLETE = "obsolete"  # WU granted before this replica reported

# workunit states
PENDING = "pending"
GRANTED = "granted"
FAILED = "failed"

LIFECYCLE_SCHEMA = "erp-wu-lifecycle/1"

# per-process fabric sequence number: the correlation-id prefix must be
# unique across fabrics in one process but stable within a run, so every
# event/verdict/lane of one soak shares one token
_fabric_seq = itertools.count(1)


@dataclass
class FabricConfig:
    """Scheduler policy knobs (every soak names its own)."""

    t_obs: float = 1.0
    bank_epoch: int = 7
    quorum: int = 2  # baseline replication
    max_target: int = 4  # escalation ceiling per validation round
    max_replicas_per_wu: int = 12  # starvation guard (soak asserts unused)
    deadline_s: float = 2.0  # report deadline per assignment
    trust_after: int = 3  # consecutive valids -> trusted
    spot_check_rate: float = 0.1  # quorum-1 grants still double-checked
    reissue_base_s: float = 0.01  # re-issue backoff (RetryPolicy semantics)
    reissue_max_s: float = 0.25
    seed: int = 0
    spool_dir: str = "fabric-spool"  # reported replica files
    verdict_dir: str = "fabric-verdicts"  # signed erp-quorum/1 artifacts
    granted_dir: str = "fabric-granted"  # canonical granted results


@dataclass
class Assignment:
    wu_id: str
    host_id: int
    seq: int  # unique replica number within the WU
    issued_at: float
    deadline: float
    state: str = ISSUED
    path: str | None = None
    claimed_epoch: int | None = None
    judged: bool = False  # reputation already updated for this replica
    reported_at: float | None = None  # monotonic, when the report landed
    ts_issue_us: float | None = None  # trace-base stamp (tracing armed only)


@dataclass
class WorkUnit:
    wu_id: str
    payload: str  # payload-class key into the reference map
    epoch: int
    target: int  # current replication target
    state: str = PENDING
    assignments: list[Assignment] = field(default_factory=list)
    rounds: int = 0  # validation rounds run
    reissues: int = 0
    next_issue_at: float = 0.0
    granted_sha: str | None = None
    granted_path: str | None = None
    spot_checked: bool = False
    validating: bool = False  # a validation round is in flight (unlocked)
    validated_seqs: frozenset | None = None  # replica set of the last round
    # correlation + lifecycle instrumentation (issue -> grant)
    corr_id: str = ""  # assigned at first issue; threads every artifact
    first_issued_at: float | None = None  # monotonic
    first_issued_wall: float | None = None
    granted_at: float | None = None  # monotonic
    granted_wall: float | None = None
    validation_s: float = 0.0  # wall spent inside validator rounds
    timeouts: int = 0
    grant_tier: str | None = None
    winner_host: int | None = None
    lane_records: list = field(default_factory=list)  # wu:* Chrome lane

    def outstanding(self) -> list[Assignment]:
        return [a for a in self.assignments if a.state == ISSUED]

    def reported(self) -> list[Assignment]:
        return [a for a in self.assignments if a.state in (REPORTED, VALID)]


class Fabric:
    """The scheduler half of the volunteer fabric, driven concurrently by
    host stream threads via :meth:`request_work` / :meth:`report` and by
    a supervisor via :meth:`check_deadlines`.  Scheduler state lives
    behind one lock, but validation rounds (file parsing, verdict
    writes, retry backoff) run outside it — see
    :meth:`_validate_pending` — so a slow or crashing validator never
    blocks issue/report traffic or deadline supervision."""

    def __init__(
        self,
        config: FabricConfig,
        workunits: list[WorkUnit],
        references: dict[str, bytes],
        workdir: str,
        obs=None,
    ):
        self.config = config
        self.workdir = workdir
        self.references = dict(references)
        # scoped observability: a fleet session hands its ObsContext so
        # this fabric's counters/events/lanes land in that session's
        # artifacts; None keeps the process-global default layers
        self.obs = obs
        self._m = obs.metrics if obs is not None else metrics
        self._fr = obs.flightrec if obs is not None else flightrec
        self._tr = obs.tracing if obs is not None else tracing
        # correlation-id prefix: unique per fabric in this process,
        # shared by every event/verdict/lane of the run
        self.run_token = f"f{next(_fabric_seq)}s{config.seed}"
        self._lock = threading.RLock()
        self._wus = {wu.wu_id: wu for wu in workunits}
        self._reputation: dict[int, HostReputation] = {}
        self._echo_pool: list[tuple[int, bytes]] = []  # (host, raw bytes)
        self._retry = RetryPolicy(
            budget=1_000_000_000,
            base_s=config.reissue_base_s,
            max_s=config.reissue_max_s,
            seed=config.seed,
        )
        # validator-crash retries come from a bounded, separate budget so
        # a flapping validator cannot spin forever
        self._validate_retry = RetryPolicy(
            budget=64, base_s=config.reissue_base_s,
            max_s=config.reissue_max_s, seed=config.seed + 1,
        )
        import random

        self._spot_rng = random.Random(f"fabric-spot:{config.seed}")
        for sub in (config.spool_dir, config.verdict_dir, config.granted_dir):
            os.makedirs(os.path.join(workdir, sub), exist_ok=True)

    # -- helpers ----------------------------------------------------------

    def _rep(self, host_id: int) -> HostReputation:
        rep = self._reputation.get(host_id)
        if rep is None:
            rep = self._reputation[host_id] = HostReputation(host_id=host_id)
        return rep

    def _gauges(self) -> None:
        wus = self._wus.values()
        self._m.gauge("fabric.wus_pending").set(
            sum(1 for w in wus if w.state == PENDING)
        )
        self._m.gauge("fabric.wus_granted").set(
            sum(1 for w in wus if w.state == GRANTED)
        )
        self._m.gauge("fabric.hosts_trusted").set(
            sum(
                1
                for r in self._reputation.values()
                if r.trusted(self.config.trust_after)
            )
        )

    def workunit(self, wu_id: str) -> WorkUnit:
        with self._lock:
            return self._wus[wu_id]

    def done(self) -> bool:
        with self._lock:
            return all(
                w.state in (GRANTED, FAILED) for w in self._wus.values()
            )

    def granted(self) -> list[WorkUnit]:
        with self._lock:
            return [w for w in self._wus.values() if w.state == GRANTED]

    def failed(self) -> list[WorkUnit]:
        with self._lock:
            return [w for w in self._wus.values() if w.state == FAILED]

    def reputation_snapshot(self) -> dict[int, HostReputation]:
        with self._lock:
            return dict(self._reputation)

    def recent_reports(self, exclude_host: int) -> list[bytes]:
        """Other hosts' recently reported raw files (the echo adversary's
        source material)."""
        with self._lock:
            return [b for h, b in self._echo_pool if h != exclude_host][-16:]

    # -- issue ------------------------------------------------------------

    def request_work(self, host_id: int) -> Assignment | None:
        """Next assignment for ``host_id``, or None when nothing is
        eligible (all targets met, backoff pending, or this host already
        served every pending WU)."""
        now = time.monotonic()
        with self._lock:
            rep = self._rep(host_id)
            trusted = rep.trusted(self.config.trust_after)
            for wu in self._wus.values():
                if wu.state != PENDING or now < wu.next_issue_at:
                    continue
                if any(a.host_id == host_id for a in wu.assignments):
                    continue  # one replica per host per WU (BOINC rule)
                active = [
                    a
                    for a in wu.assignments
                    if a.state in (ISSUED, REPORTED, VALID)
                ]
                if not wu.assignments and trusted:
                    # adaptive replication: first assignment of a fresh WU
                    # to a trusted host runs at quorum-1 unless the
                    # spot-check lottery says otherwise
                    if self._spot_rng.random() < self.config.spot_check_rate:
                        wu.spot_checked = True
                        self._m.counter("fabric.spot_checks").inc()
                    else:
                        wu.target = 1
                if len(active) >= wu.target:
                    continue
                if len(wu.assignments) >= self.config.max_replicas_per_wu:
                    continue
                seq = len(wu.assignments)
                a = Assignment(
                    wu_id=wu.wu_id,
                    host_id=host_id,
                    seq=seq,
                    issued_at=now,
                    deadline=now + self.config.deadline_s,
                )
                a.ts_issue_us = self._tr.now_us()
                if not wu.corr_id:
                    # correlation id minted at FIRST issue: every later
                    # event, verdict, metric label and trace lane of
                    # this WU carries it (and the driver subprocess
                    # inherits it via ERP_CORR_ID)
                    wu.corr_id = f"{self.run_token}-{wu.wu_id}"
                    wu.first_issued_at = now
                    wu.first_issued_wall = time.time()
                wu.assignments.append(a)
                self._m.counter("fabric.issued").inc()
                self._m.counter(
                    metrics.labeled("fabric.host.issued", host_id=host_id)
                ).inc()
                self._fr.record(
                    "fabric-issue", wu_id=wu.wu_id, host_id=host_id,
                    seq=seq, target=wu.target, corr=wu.corr_id,
                )
                self._gauges()
                return a
            return None

    # -- report + validation ---------------------------------------------

    def report(
        self,
        assignment: Assignment,
        payload: bytes,
        claimed_epoch: int,
    ) -> None:
        """A host hands back its result file bytes for an assignment.

        The ``result_report`` fault point lives in the host models'
        compute path (``fabric/hosts.py``), NOT here: a single site per
        report keeps host ground truth authoritative about every
        mutation the payload suffered before validation.
        """
        path = os.path.join(
            self.workdir,
            self.config.spool_dir,
            f"{assignment.wu_id}.h{assignment.host_id}.s{assignment.seq}.cand",
        )
        with open(path, "wb") as f:
            f.write(payload)
        with self._lock:
            wu = self._wus[assignment.wu_id]
            assignment.path = path
            assignment.claimed_epoch = claimed_epoch
            assignment.reported_at = time.monotonic()
            self._m.counter("fabric.reported").inc()
            self._m.counter(
                metrics.labeled(
                    "fabric.host.reported", host_id=assignment.host_id
                )
            ).inc()
            self._fr.record(
                "fabric-report", wu_id=wu.wu_id,
                host_id=assignment.host_id, seq=assignment.seq,
                corr=wu.corr_id,
            )
            self._lane_span(wu, assignment)
            if wu.state != PENDING:
                # WU already granted/failed: accept silently, never punish
                # an honest-but-slow host (BOINC grants these credit too)
                assignment.state = OBSOLETE
                self._m.counter("fabric.obsolete_reports").inc()
                return
            if assignment.state == TIMEOUT:
                # deadline already passed and the replica was re-issued:
                # reject the late report outright
                self._m.counter("fabric.late_reports").inc()
                self._fr.record(
                    "fabric-reject", wu_id=wu.wu_id,
                    host_id=assignment.host_id,
                    reason="deadline-exceeded", corr=wu.corr_id,
                )
                return
            assignment.state = REPORTED
            self._echo_pool.append((assignment.host_id, payload))
            del self._echo_pool[:-64]
            self._gauges()
        self._validate_pending(wu)

    def _lane_span(self, wu: WorkUnit, a: Assignment) -> None:
        """Queue the replica's issue→report span for this WU's ``wu:*``
        Chrome lane (flushed via ``add_device_records`` at grant/fail so
        lanes appear complete).  Free when tracing is off."""
        end = self._tr.now_us()
        if a.ts_issue_us is None or end is None:
            return
        # one sub-lane per replica: two replicas of the same WU overlap
        # in time without nesting, and Chrome B/E pairs must balance
        # per lane (one replica per host per WU keeps each sub-lane to
        # a single span)
        wu.lane_records.append(
            {
                "name": f"replica h{a.host_id}",
                "tid": f"wu:{wu.wu_id}:h{a.host_id}",
                "ts_us": a.ts_issue_us,
                "dur_us": max(0.0, end - a.ts_issue_us),
                "args": {
                    "corr": wu.corr_id, "host_id": a.host_id, "seq": a.seq,
                },
            }
        )

    def _lane_instant(self, wu: WorkUnit, name: str, **args) -> None:
        ts = self._tr.now_us()
        if ts is None:
            return
        wu.lane_records.append(
            {
                "kind": "instant",
                "name": name,
                "tid": f"wu:{wu.wu_id}",
                "ts_us": ts,
                "args": {"corr": wu.corr_id, **args},
            }
        )

    def _lane_flush(self, wu: WorkUnit) -> None:
        """Assemble the WU's lifecycle lane and hand it to the tracer's
        Chrome-export side channel."""
        records = list(wu.lane_records)
        wu.lane_records = []
        now = self._tr.now_us()
        if records and now is not None and wu.first_issued_at is not None:
            start = min(r["ts_us"] for r in records)
            records.insert(
                0,
                {
                    "name": f"wu {wu.wu_id}",
                    "tid": f"wu:{wu.wu_id}",
                    "ts_us": start,
                    "dur_us": max(0.0, now - start),
                    "args": {
                        "corr": wu.corr_id, "state": wu.state,
                        "tier": wu.grant_tier, "rounds": wu.rounds,
                        "reissues": wu.reissues,
                    },
                },
            )
        if records:
            self._tr.add_device_records(records)

    def _replica_of(self, a: Assignment) -> Replica:
        return Replica(
            host_id=a.host_id,
            path=a.path,
            bank_epoch=a.claimed_epoch,
            reputation=self._rep(a.host_id).consecutive_valid,
        )

    def _plan_round(self, wu: WorkUnit) -> tuple | None:
        """Reserve the next validation round for ``wu`` (caller holds
        the lock): returns ``(kind, assignments, replicas, round_no)``
        with the replica set snapshotted, or None when no round is due —
        not enough reports, another round already in flight, or the
        reported set is unchanged since the last round."""
        if wu.state != PENDING or wu.validating:
            return None
        reported = wu.reported()
        seqs = frozenset(a.seq for a in reported)
        if seqs == wu.validated_seqs:
            return None  # this exact replica set was already judged
        if wu.target == 1 and len(reported) == 1:
            # the quorum-1 fast path belongs to CURRENTLY-trusted hosts
            # only: a deadline re-issue can hand a target-1 replica to
            # an arbitrary host, and intrinsic checks alone must never
            # grant it — escalate to a full quorum instead (the replica
            # stays in play as the first quorum member)
            rep = self._rep(reported[0].host_id)
            if not rep.trusted(self.config.trust_after):
                wu.target = max(wu.target, self.config.quorum)
                self._fr.record(
                    "fabric-escalate", wu_id=wu.wu_id,
                    reason="untrusted-single", target=wu.target,
                    corr=wu.corr_id,
                )
                return None
            kind = "single"
        elif len(reported) >= 2:
            kind = "quorum"
        else:
            return None
        wu.validating = True
        wu.validated_seqs = seqs
        round_no = wu.rounds
        wu.rounds += 1
        replicas = [self._replica_of(a) for a in reported]
        return kind, list(reported), replicas, round_no

    def _validate_pending(self, wu: WorkUnit) -> None:
        """Run validation rounds for ``wu`` until none is due.  The
        validator itself — replica file parsing, verdict writes, retry
        backoff on injected faults — runs OUTSIDE the global lock so
        hundreds of streams and the deadline supervisor never serialize
        behind one round; the per-WU ``validating`` flag keeps rounds
        for the same WU sequential, and replicas that report mid-round
        are picked up by the next loop iteration."""
        outdir = os.path.join(self.workdir, self.config.verdict_dir)
        while True:
            with self._lock:
                plan = self._plan_round(wu)
            if plan is None:
                return
            kind, reported, replicas, round_no = plan
            round_t0 = time.monotonic()
            try:
                if kind == "single":
                    outcome = self._run_validator(
                        lambda: validate_single(
                            wu.wu_id, replicas[0], self.config.t_obs,
                            expected_epoch=wu.epoch, outdir=outdir,
                            round_no=round_no, corr_id=wu.corr_id,
                        )
                    )
                else:
                    outcome = self._run_validator(
                        lambda: validate_quorum(
                            wu.wu_id, replicas, self.config.t_obs,
                            expected_epoch=wu.epoch, outdir=outdir,
                            round_no=round_no, corr_id=wu.corr_id,
                        )
                    )
            except Exception:
                with self._lock:
                    wu.validating = False
                raise
            round_s = time.monotonic() - round_t0
            with self._lock:
                wu.validating = False
                wu.validation_s += round_s
                self._m.counter("fabric.validation_rounds").inc()
                self._m.histogram(
                    "fabric.validation_latency_ms",
                    metrics.LATENCY_BUCKETS_MS, unit="ms",
                ).observe(round_s * 1e3)
                if wu.state != PENDING:
                    return  # granted/failed while the round ran
                if kind == "single":
                    self._apply_single(wu, reported[0], outcome)
                else:
                    self._apply_quorum(wu, reported, outcome)
                self._gauges()

    def _apply_single(
        self, wu: WorkUnit, a: Assignment, outcome: QuorumOutcome
    ) -> None:
        """Apply a trusted-single round's outcome.  Caller holds the
        lock."""
        if outcome.granted:
            self._m.counter("fabric.granted_quorum1").inc()
            self._grant(wu, outcome, [a])
            return
        problems = outcome.loaded[0].problems
        gap_only = bool(problems) and all(
            p.startswith("gap-claim-needs-quorum") for p in problems
        )
        if gap_only:
            # a LEGITIMATE anomaly, not a proven lie: a trusted
            # host claiming a quarantine gap escalates to a full
            # quorum (the replica stays in play, the host is not
            # judged) — only a disagreeing second opinion can
            # condemn a gap claim
            self._m.counter("fabric.gap_escalations").inc()
            self._fr.record(
                "fabric-escalate", wu_id=wu.wu_id,
                reason="gap-claim-needs-quorum",
                target=self.config.quorum, corr=wu.corr_id,
            )
        else:
            self._judge_invalid(wu, a, outcome)
        # the fast path is closed for this WU: it now requires a
        # full quorum, and a lying "trusted" host is excluded by
        # the one-replica-per-host rule
        wu.target = max(wu.target, self.config.quorum)
        self._schedule_reissue(
            wu,
            reason=(
                "gap-claim-needs-quorum"
                if gap_only
                else "trusted-single-invalid"
            ),
        )

    def _apply_quorum(
        self,
        wu: WorkUnit,
        reported: list[Assignment],
        outcome: QuorumOutcome,
    ) -> None:
        """Apply a quorum round's outcome.  Caller holds the lock."""
        if outcome.granted:
            winner_loaded = outcome.loaded[outcome.winner]
            agreeing: list[Assignment] = []
            for idx, a in enumerate(reported):
                lr = outcome.loaded[idx]
                if not lr.ok:
                    self._judge_invalid(wu, a, outcome, lr.problems)
                    continue
                if idx == outcome.winner:
                    agreeing.append(a)
                    continue
                tier, _ = compare_replicas(winner_loaded, lr)
                if tier is not None:
                    agreeing.append(a)
                else:
                    self._judge_invalid(
                        wu, a, outcome, ["disagrees-with-quorum"]
                    )
            self._grant(wu, outcome, agreeing)
            return
        # no agreement: demote intrinsically-invalid replicas, escalate
        # the replication target, re-issue to fresh hosts
        for idx, a in enumerate(reported):
            lr = outcome.loaded[idx]
            if not lr.ok:
                self._judge_invalid(wu, a, outcome, lr.problems)
        still_valid = [a for a in wu.reported()]
        if outcome.verdict == "disagree" and len(still_valid) >= 2:
            # two intrinsically-plausible replicas that disagree (e.g. a
            # forged quarantine gap): neither can be trusted — keep both
            # unjudged and escalate until an agreeing pair exists
            pass
        old = wu.target
        # the ceiling bounds the escalation, never progress: a round
        # without agreement always asks for one replica more than are
        # still in play.  Capped at max_target, four plausible replicas
        # that pairwise disagree (an honest one, two reorders and a gap
        # liar, since the port's validator grants no reordered pair)
        # would hold the WU PENDING with nothing to issue; this way
        # max_replicas_per_wu is what ends a WU that never agrees
        wu.target = max(
            min(self.config.max_target, max(wu.target, self.config.quorum)),
            len(wu.reported()) + 1,
        )
        if wu.target != old:
            self._fr.record(
                "fabric-escalate", wu_id=wu.wu_id, target=wu.target,
                rounds=wu.rounds, corr=wu.corr_id,
            )
        self._schedule_reissue(wu, reason=outcome.verdict)

    def _run_validator(self, fn) -> QuorumOutcome:
        """Validator invocations retry transient failures (including
        injected ``validate:*`` faults) on a bounded policy."""
        self._m.counter("fabric.validations").inc()
        try:
            return call_with_retry(
                fn, "fabric-validate", retry_policy=self._validate_retry
            )
        except Exception:
            self._m.counter("fabric.validation_failures").inc()
            raise

    def _judge_invalid(
        self,
        wu: WorkUnit,
        a: Assignment,
        outcome: QuorumOutcome,
        problems: list[str] | None = None,
    ) -> None:
        if a.judged:
            a.state = INVALID
            return
        a.state = INVALID
        a.judged = True
        rep = self._rep(a.host_id)
        was_trusted = rep.trusted(self.config.trust_after)
        rep.record_invalid()
        self._m.counter("fabric.invalid_replicas").inc()
        self._m.counter("fabric.adversary_detected").inc()
        reasons = problems
        if reasons is None:
            for lr in outcome.loaded:
                if lr.replica.host_id == a.host_id:
                    reasons = lr.problems
                    break
        for reason in reasons or ["unknown"]:
            tag = reason.split(":", 1)[0].strip()
            self._m.counter(f"fabric.reject.{tag}").inc()
            self._m.counter(
                metrics.labeled(
                    "fabric.host.rejected", host_id=a.host_id, tag=tag
                )
            ).inc()
        self._fr.record(
            "fabric-reject", wu_id=wu.wu_id, host_id=a.host_id,
            reasons=(reasons or [])[:5], corr=wu.corr_id,
        )
        if was_trusted:
            self._fr.record(
                "fabric-demote", host_id=a.host_id, wu_id=wu.wu_id,
                corr=wu.corr_id,
            )
        erplog.warn(
            "Fabric: host %d replica of %s rejected (%s)\n",
            a.host_id, wu.wu_id, "; ".join((reasons or ["unknown"])[:3]),
        )

    def _judge_valid(self, a: Assignment) -> None:
        if a.judged:
            a.state = VALID
            return
        a.state = VALID
        a.judged = True
        rep = self._rep(a.host_id)
        before = rep.trusted(self.config.trust_after)
        rep.record_valid()
        self._m.counter(
            metrics.labeled("fabric.host.valid", host_id=a.host_id)
        ).inc()
        if not before and rep.trusted(self.config.trust_after):
            self._m.counter("fabric.hosts_promoted").inc()
            self._fr.record(
                "fabric-trust", host_id=a.host_id, wu_id=a.wu_id,
                corr=self._wus[a.wu_id].corr_id,
            )

    def _grant(
        self, wu: WorkUnit, outcome: QuorumOutcome, agreeing: list[Assignment]
    ) -> None:
        winner = outcome.loaded[outcome.winner]
        granted_path = os.path.join(
            self.workdir, self.config.granted_dir, f"{wu.wu_id}.cand"
        )
        with open(winner.replica.path, "rb") as src:
            data = src.read()
        tmp = f"{granted_path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, granted_path)
        wu.state = GRANTED
        wu.granted_sha = outcome.canonical_sha256
        wu.granted_path = granted_path
        wu.granted_at = time.monotonic()
        wu.granted_wall = time.time()
        wu.grant_tier = outcome.tier
        wu.winner_host = winner.replica.host_id
        for a in agreeing:
            self._judge_valid(a)
        for a in wu.outstanding():
            a.state = OBSOLETE
        self._m.counter("fabric.granted").inc()
        if wu.first_issued_at is not None:
            self._m.histogram(
                "fabric.grant_latency_ms", metrics.LATENCY_BUCKETS_MS,
                unit="ms",
            ).observe((wu.granted_at - wu.first_issued_at) * 1e3)
        self._fr.record(
            "fabric-grant", wu_id=wu.wu_id, tier=outcome.tier,
            winner=winner.replica.host_id, rounds=wu.rounds,
            replicas=len(wu.assignments), corr=wu.corr_id,
        )
        self._lane_instant(
            wu, "grant", tier=outcome.tier, winner=winner.replica.host_id
        )
        self._lane_flush(wu)
        self._gauges()

    # -- deadlines + re-issue --------------------------------------------

    def _schedule_reissue(self, wu: WorkUnit, reason: str) -> None:
        wu.reissues += 1
        wu.next_issue_at = time.monotonic() + self._retry.backoff_s(
            min(wu.reissues, 8)
        )
        self._m.counter("fabric.reissued").inc()
        self._fr.record(
            "fabric-reissue", wu_id=wu.wu_id, reason=reason,
            n=wu.reissues, corr=wu.corr_id,
        )
        self._lane_instant(wu, "reissue", reason=reason, n=wu.reissues)
        if len(wu.assignments) >= self.config.max_replicas_per_wu:
            wu.state = FAILED
            self._lane_flush(wu)
            erplog.warn(
                "Fabric: %s FAILED after %d replicas\n",
                wu.wu_id, len(wu.assignments),
            )

    def check_deadlines(self) -> int:
        """Time out overdue assignments; returns how many were expired.
        Called by the supervisor loop."""
        now = time.monotonic()
        expired = 0
        with self._lock:
            for wu in self._wus.values():
                if wu.state != PENDING:
                    continue
                for a in wu.assignments:
                    if a.state == ISSUED and now > a.deadline:
                        a.state = TIMEOUT
                        a.judged = True
                        expired += 1
                        self._rep(a.host_id).record_timeout()
                        # a deadline expiry closes any quorum-1 fast
                        # path for this WU: the replacement replica may
                        # land on ANY host and must meet a full quorum
                        # (the invalid path escalates the same way)
                        wu.target = max(wu.target, self.config.quorum)
                        wu.timeouts += 1
                        self._m.counter("fabric.timeouts").inc()
                        self._m.counter(
                            metrics.labeled(
                                "fabric.host.timeout", host_id=a.host_id
                            )
                        ).inc()
                        self._fr.record(
                            "fabric-timeout", wu_id=wu.wu_id,
                            host_id=a.host_id, corr=wu.corr_id,
                        )
                        self._lane_instant(wu, "timeout", host_id=a.host_id)
                        self._schedule_reissue(wu, reason="deadline")
            if expired:
                self._gauges()
        return expired

    # -- end-of-run summary ----------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            wus = list(self._wus.values())
            issued = sum(len(w.assignments) for w in wus)
            return {
                "wus": len(wus),
                "granted": sum(1 for w in wus if w.state == GRANTED),
                "failed": sum(1 for w in wus if w.state == FAILED),
                "pending": sum(1 for w in wus if w.state == PENDING),
                "replicas_issued": issued,
                "reissues": sum(w.reissues for w in wus),
                "validation_rounds": sum(w.rounds for w in wus),
                "quorum1_grants": sum(
                    1
                    for w in wus
                    if w.state == GRANTED and w.target == 1
                ),
                "hosts_trusted": sum(
                    1
                    for r in self._reputation.values()
                    if r.trusted(self.config.trust_after)
                ),
                "hosts_demoted": sum(
                    1
                    for r in self._reputation.values()
                    if r.total_invalid > 0
                ),
            }

    def lifecycles(self) -> list[dict]:
        """Per-WU lifecycle records (issue→grant), correlation ids
        included — the exact-latency source ``tools/fleet_report.py``
        computes its percentiles from (histograms only bound them)."""
        with self._lock:
            out = []
            for wu in self._wus.values():
                grant_latency = (
                    wu.granted_at - wu.first_issued_at
                    if wu.granted_at is not None
                    and wu.first_issued_at is not None
                    else None
                )
                out.append(
                    {
                        "wu_id": wu.wu_id,
                        "corr_id": wu.corr_id,
                        "payload": wu.payload,
                        "state": wu.state,
                        "target": wu.target,
                        "rounds": wu.rounds,
                        "reissues": wu.reissues,
                        "timeouts": wu.timeouts,
                        "replicas": len(wu.assignments),
                        "spot_checked": wu.spot_checked,
                        "issued_unix": wu.first_issued_wall,
                        "granted_unix": wu.granted_wall,
                        "grant_latency_s": (
                            round(grant_latency, 6)
                            if grant_latency is not None
                            else None
                        ),
                        "validation_s": round(wu.validation_s, 6),
                        "grant_tier": wu.grant_tier,
                        "winner_host": wu.winner_host,
                        "granted_sha": wu.granted_sha,
                        "assignments": [
                            {
                                "host_id": a.host_id,
                                "seq": a.seq,
                                "state": a.state,
                                "compute_s": (
                                    round(a.reported_at - a.issued_at, 6)
                                    if a.reported_at is not None
                                    else None
                                ),
                            }
                            for a in wu.assignments
                        ],
                    }
                )
            return out

    def export_lifecycle(self, path: str) -> str:
        """Write the ``erp-wu-lifecycle/1`` artifact: every WU's
        correlated lifecycle plus the host reputation table, config
        knobs and run summary — one of the three inputs the fleet
        rollup aggregates (with the metrics stream and the signed
        verdict dir)."""
        with self._lock:
            hosts = [
                {
                    "host_id": r.host_id,
                    "consecutive_valid": r.consecutive_valid,
                    "total_valid": r.total_valid,
                    "total_invalid": r.total_invalid,
                    "total_timeout": r.total_timeout,
                    "trusted": r.trusted(self.config.trust_after),
                }
                for r in sorted(
                    self._reputation.values(), key=lambda r: r.host_id
                )
            ]
        doc = {
            "schema": LIFECYCLE_SCHEMA,
            "t": time.time(),
            "run_token": self.run_token,
            "config": {
                "quorum": self.config.quorum,
                "max_target": self.config.max_target,
                "deadline_s": self.config.deadline_s,
                "trust_after": self.config.trust_after,
                "spot_check_rate": self.config.spot_check_rate,
                "seed": self.config.seed,
            },
            "summary": self.summary(),
            "hosts": hosts,
            "wus": self.lifecycles(),
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# stream driver


def run_streams(
    fabric: Fabric,
    hosts: list[HostModel],
    *,
    stale_references: dict[str, bytes] | None = None,
    latency_s: tuple[float, float] = (0.001, 0.01),
    idle_s: float = 0.01,
    timeout_s: float = 120.0,
    poll_s: float = 0.02,
) -> bool:
    """Run one volunteer-stream thread per host until every workunit is
    granted or failed (True = all done before ``timeout_s``).

    The stream loop IS the volunteer lifecycle: request work, "compute"
    (a seeded latency sleep — the honest bytes were computed once by the
    reference subprocess), report, repeat.  A stall adversary sleeps past
    its deadline and then reports anyway, exercising both the timeout
    re-issue and the late-report rejection.  A supervisor thread expires
    deadlines at ``poll_s`` cadence.
    """
    import random

    stop = threading.Event()

    def supervisor() -> None:
        while not stop.is_set():
            fabric.check_deadlines()
            stop.wait(poll_s)

    def stream(host: HostModel) -> None:
        rng = random.Random(f"stream:{fabric.config.seed}:{host.host_id}")
        while not stop.is_set():
            a = fabric.request_work(host.host_id)
            if a is None:
                if fabric.done():
                    return
                stop.wait(idle_s * (0.5 + rng.random()))
                continue
            wu = fabric.workunit(a.wu_id)
            ref = fabric.references[wu.payload]
            stale = (stale_references or {}).get(wu.payload)
            payload, epoch, stalled = host.compute(
                a.wu_id,
                ref,
                wu.epoch,
                stale_reference_bytes=stale,
                echo_pool=fabric.recent_reports(host.host_id),
            )
            if stalled:
                # sleep past the deadline, then report late anyway (the
                # raw reference bytes — the content is irrelevant, the
                # scheduler must reject on deadline alone)
                stop.wait(fabric.config.deadline_s * 1.5)
                payload = ref
            else:
                stop.wait(rng.uniform(*latency_s))
            if payload is not None:
                try:
                    fabric.report(a, payload, epoch)
                except Exception as exc:
                    erplog.warn(
                        "Fabric stream host %d report failed: %s\n",
                        host.host_id, exc,
                    )

    sup = threading.Thread(target=supervisor, name="fabric-supervisor",
                           daemon=True)
    sup.start()
    threads = [
        threading.Thread(
            target=stream, args=(h,), name=f"fabric-host{h.host_id}",
            daemon=True,
        )
        for h in hosts
    ]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout_s
    try:
        while time.monotonic() < deadline:
            if fabric.done():
                return True
            time.sleep(poll_s)
        return fabric.done()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
        sup.join(timeout=5.0)


# ---------------------------------------------------------------------------
# compute backends

FABRIC_BACKEND_ENV = "ERP_FABRIC_BACKEND"


def compute_backend() -> str:
    """How the fabric's honest reference results get computed:
    ``subprocess`` (default — one real driver process per payload class,
    ``tools/fabric_soak.py`` phase 1) or ``server`` — the in-process
    fleet serving tier (``serving/server.py``), one resident Scheduler
    streaming every payload class through cached executables, with the
    fabric's correlation ids flowing through each Session's scoped
    ObsContext instead of the ``ERP_CORR_ID`` subprocess env."""
    return (
        os.environ.get(FABRIC_BACKEND_ENV, "subprocess").strip().lower()
        or "subprocess"
    )


class ServerBackend:
    """In-process compute backend: the fabric side of the serving tier.

    Lazily imports the serving stack (this module stays torch-free until
    a backend is actually constructed) and exposes the one call the fabric
    needs — args in, result-file bytes out — with the workunit's
    correlation id threaded into the Session's scoped observability
    bundle.  ``stats()`` surfaces the server scoreboard so soaks can
    assert the zero-recompile steady state held while the fabric ran.

    The backend survives a server restart: when the resident server has
    been closed underneath it (a supervised rc-99 restart cycle tears
    the old instance down), ``compute`` reconnects — it builds a fresh
    FleetServer with the same name/warm/resume configuration and
    resubmits.  With ``resume_dir`` set the replacement replays the WU
    journal first, so work accepted by the dead instance is not lost.

    ``device`` is the server's (``"cuda"`` by default: without a card the
    constructor raises unless the caller passes ``"cpu"``); every
    workunit computed through the backend runs there, whatever device
    its args named."""

    def __init__(self, *, name: str = "fabric-server", warm_specs=None,
                 resume_dir: str | None = None, device: str = "cuda"):
        self._name = name
        self._warm_specs = warm_specs
        self._resume_dir = resume_dir
        self.device = device
        self._reconnects = 0
        self._server = self._connect()

    def _connect(self):
        from ..serving import FleetServer  # noqa: PLC0415 — keep fabric torch-free

        return FleetServer(
            name=self._name, warm_specs=self._warm_specs,
            resume_dir=self._resume_dir, device=self.device,
        )

    def _server_gone(self) -> bool:
        srv = self._server
        return srv is None or getattr(srv, "_stop", False)

    def compute(self, args, *, corr_id: str | None = None) -> bytes:
        """Run one workunit through the resident server; returns the
        result-file bytes (the fabric's reference payload currency).
        Reconnects (once per call) when the server was restarted."""
        args = dataclasses.replace(args, device=self.device)
        if self._server_gone():
            self._reconnect()
        try:
            res = self._server.process(args, corr_id=corr_id)
        except RuntimeError:
            # the server closed between the liveness check and the
            # submit (restart race): reconnect once and resubmit
            if not self._server_gone():
                raise
            self._reconnect()
            res = self._server.process(args, corr_id=corr_id)
        if not res.ok:
            raise RuntimeError(
                f"server backend: session {res.name} exited {res.code}"
                + (f" ({res.error})" if res.error else "")
            )
        with open(res.outputfile, "rb") as f:
            return f.read()

    def _reconnect(self) -> None:
        self._reconnects += 1
        erplog.warn(
            "Server backend: resident server is gone; reconnecting "
            "(%d).\n", self._reconnects,
        )
        self._server = self._connect()

    def stats(self) -> dict:
        doc = self._server.stats()
        doc["backend_reconnects"] = self._reconnects
        return doc

    def close(self) -> None:
        if self._server is not None:
            self._server.close()

    def __enter__(self) -> "ServerBackend":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
