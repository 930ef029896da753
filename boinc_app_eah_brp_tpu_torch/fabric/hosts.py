"""Volunteer host models: honest behavior, six adversaries, reputation.

The work-fabric simulator (``fabric/workfabric.py``) drives hundreds of
these concurrently.  A host model answers one question — *given a
workunit assignment and the honest reference bytes, what does this host
report?* — and the adversarial models answer it the way real volunteer
fleets misbehave (BOINC's validator lore):

* ``bitflip``   — flips bits in reported candidate powers (overclocked
                  hardware, bad VRAM).  Mutation mechanics are shared
                  with ``runtime/faultinject.py``'s ``corrupt`` kind so
                  injected environmental corruption and deliberate lies
                  corrupt payloads identically.
* ``reorder``   — swaps toplist rows (a broken writer): violates the
                  finalizer's exact output order.
* ``stale``     — computes against a previous template-bank epoch and
                  reports that epoch (a host that never downloaded the
                  new bank).
* ``echo``      — replays another host's result file verbatim instead of
                  computing (credit farming).
* ``stall``     — accepts work and never reports within the deadline.
* ``gap_liar``  — claims a quarantine gap that never happened (a host
                  "excusing" skipped work; the named-gap provenance line
                  of the result header makes the claim comparable, and any honest replica
                  disagrees with the forged gap line).

Every model records ground truth (``lies``) about each report so soaks
can assert ZERO lied reports were ever granted — the scheduler itself
never reads ground truth, only validator verdicts.

Reputation (:class:`HostReputation`) implements BOINC-style adaptive
replication: ``trust_after`` consecutive validated results make a host
*trusted* (its work may be granted at quorum-1, spot-checked at
``spot_check_rate``); any invalid/timeout resets the streak and demotes
the host.  Nothing in ``fabric/`` imports torch.  Reports, ground truth
and reputation are the JAX package's ``fabric/hosts.py``, byte for byte
for the same seed, host id and reference bytes.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field

from ..io.results import (
    QUARANTINE_TAG,
    ResultHeader,
    parse_quarantine_ranges,
    split_result_sections,
)
from ..runtime import faultinject

ADVERSARY_KINDS = (
    "bitflip",
    "reorder",
    "stale",
    "echo",
    "stall",
    "gap_liar",
)

HOST_KINDS = ("honest",) + ADVERSARY_KINDS


@dataclass
class ReportGroundTruth:
    """What the host ACTUALLY did for one report (soak assertions only)."""

    wu_id: str
    lied: bool
    kind: str  # "honest" or the adversary kind exercised
    stalled: bool = False


def _render_report(
    header: ResultHeader, candidate_lines: list[str], gaps: list
) -> bytes:
    header.quarantined = list(gaps)
    body = header.render() + "".join(f"{line}\n" for line in candidate_lines)
    return (body + "%DONE%\n").encode("utf-8")


@dataclass
class HostModel:
    """One volunteer host's behavior.  ``kind`` is "honest" or an
    adversary; adversarial hosts misbehave with probability ``p_lie``
    per assignment (a real bad host is intermittently bad — that is
    exactly what makes reputation dangerous) and behave honestly
    otherwise."""

    host_id: int
    kind: str = "honest"
    p_lie: float = 1.0
    seed: int = 0
    date_iso: str = "2008-11-12T00:00:00+00:00"
    truths: list[ReportGroundTruth] = field(default_factory=list)

    def __post_init__(self):
        if self.kind not in HOST_KINDS:
            raise ValueError(f"unknown host kind {self.kind!r}")
        self._rng = random.Random(f"host:{self.seed}:{self.host_id}:{self.kind}")
        self._lock = threading.Lock()

    # -- behavior ---------------------------------------------------------

    def _header(self) -> ResultHeader:
        return ResultHeader(
            user_id=self.host_id,
            user_name=f"vol{self.host_id}",
            host_id=self.host_id,
            host_cpid=f"cpid-{self.host_id:04d}",
            exec_name="einstein_brp_fabric",
            erp_git_version="fabric-sim",
            boinc_rev="sim",
            date_iso=self.date_iso,
        )

    def _truth(self, wu_id: str, lied: bool, kind: str, stalled=False) -> None:
        with self._lock:
            self.truths.append(
                ReportGroundTruth(wu_id=wu_id, lied=lied, kind=kind,
                                  stalled=stalled)
            )

    def compute(
        self,
        wu_id: str,
        reference_bytes: bytes,
        bank_epoch: int,
        stale_reference_bytes: bytes | None = None,
        echo_pool: list[bytes] | None = None,
    ) -> tuple[bytes | None, int, bool]:
        """The host's report for one assignment:
        ``(file bytes or None, claimed bank epoch, stalled)``.

        ``reference_bytes`` is the honest single-process result for the
        workunit (provenance header will be replaced by this host's own);
        ``stale_reference_bytes`` is what an out-of-date bank would have
        produced; ``echo_pool`` holds other hosts' already-reported files.
        ``None`` bytes = the host stalls past its deadline.
        """
        lie = self.kind != "honest" and self._rng.random() < self.p_lie
        header_lines, cand_lines, _ = split_result_sections(
            reference_bytes.decode("utf-8")
        )
        gaps = []
        for line in header_lines:
            if line.strip().startswith("% Quarantined templates:"):
                gaps = parse_quarantine_ranges(line.strip())

        if not lie:
            payload = _render_report(self._header(), cand_lines, gaps)
            # the environmental corruption channel: an armed
            # result_report:corrupt fault mutates even honest reports —
            # the validator must catch those too
            mutated = faultinject.fault_point(
                "result_report", payload=payload, host=self.host_id, wu=wu_id
            )
            if mutated == payload:
                self._truth(wu_id, False, "honest")
            else:
                # "lied" means the SCIENCE changed: candidate lines, gap
                # claims or the %DONE% terminator.  A flip landing in
                # header cosmetics (date, user name) may be rejected on
                # provenance or granted harmlessly — either is correct
                self._truth(
                    wu_id,
                    self._content_changed(mutated, cand_lines, gaps),
                    "fault-injected",
                )
            return mutated, bank_epoch, False

        if self.kind == "stall":
            self._truth(wu_id, True, "stall", stalled=True)
            return None, bank_epoch, True

        if self.kind == "echo" and echo_pool:
            victim = echo_pool[self._rng.randrange(len(echo_pool))]
            self._truth(wu_id, True, "echo")
            return victim, bank_epoch, False

        if self.kind == "stale" and stale_reference_bytes is not None:
            _, stale_lines, _ = split_result_sections(
                stale_reference_bytes.decode("utf-8")
            )
            self._truth(wu_id, True, "stale")
            return (
                _render_report(self._header(), stale_lines, gaps),
                bank_epoch - 1,
                False,
            )

        if self.kind == "reorder" and len(cand_lines) >= 2:
            rng = random.Random(f"{self.seed}:{self.host_id}:{wu_id}:reorder")
            swapped = faultinject.swap_rows(cand_lines, rng)
            if swapped == cand_lines:  # seeded swap hit equal printed rows
                swapped = list(reversed(cand_lines))
            self._truth(wu_id, True, "reorder")
            return _render_report(self._header(), swapped, gaps), bank_epoch, False

        if self.kind == "gap_liar":
            # the forged gap is a pure function of host_id: two
            # INDEPENDENT liars can then never collude on the same hole
            # and strict-agree past a quorum (identical coordinated lies
            # defeat replication by construction — BOINC's too — and are
            # out of scope for the fabric model)
            a = (3 * self.host_id) % 89
            fake_gaps = gaps + [(a, a + 2)]
            self._truth(wu_id, True, "gap_liar")
            return (
                _render_report(self._header(), cand_lines, fake_gaps),
                bank_epoch,
                False,
            )

        # bitflip (and the fallback when a model's prop is unavailable,
        # e.g. echo with an empty pool): corrupt the candidate section
        # with the SAME primitive faultinject's corrupt kind uses
        rng = random.Random(f"{self.seed}:{self.host_id}:{wu_id}:bitflip")
        body = "\n".join(cand_lines).encode("utf-8")
        corrupted = faultinject.corrupt_bytes(body, rng)
        if corrupted == body and body:
            corrupted = faultinject.corrupt_bytes(body, rng, flips=8)
        new_lines = corrupted.decode("utf-8", errors="replace").split("\n")
        self._truth(wu_id, True, "bitflip")
        return _render_report(self._header(), new_lines, gaps), bank_epoch, False

    @staticmethod
    def _content_changed(mutated: bytes, cand_lines: list[str], gaps) -> bool:
        try:
            header_lines, mlines, mdone = split_result_sections(
                mutated.decode("utf-8")
            )
        except (ValueError, UnicodeDecodeError):
            return True
        mgaps: list = []
        for line in header_lines:
            if line.strip().startswith(QUARANTINE_TAG):
                mgaps = parse_quarantine_ranges(line.strip())
        return not (
            mdone and mlines == cand_lines and mgaps == list(gaps)
        )

    # -- ground-truth queries (soak assertions) ---------------------------

    def lied_wus(self) -> set[str]:
        with self._lock:
            return {t.wu_id for t in self.truths if t.lied}


@dataclass
class HostReputation:
    """Adaptive-replication trust state for one host (scheduler-side)."""

    host_id: int
    consecutive_valid: int = 0
    total_valid: int = 0
    total_invalid: int = 0
    total_timeout: int = 0

    def record_valid(self) -> None:
        self.consecutive_valid += 1
        self.total_valid += 1

    def record_invalid(self) -> None:
        self.consecutive_valid = 0
        self.total_invalid += 1

    def record_timeout(self) -> None:
        self.consecutive_valid = 0
        self.total_timeout += 1

    def trusted(self, trust_after: int) -> bool:
        """Quorum-1 eligibility: an unbroken streak of validated results
        and no invalid result EVER (one proven lie is disqualifying —
        cheaper than BOINC's decaying error rate and strictly safer)."""
        return (
            self.consecutive_valid >= trust_after and self.total_invalid == 0
        )
