"""Quorum validator: redundant-result comparison for the volunteer fabric.

The reference app only worked at Einstein@Home scale because BOINC's
server side issued every workunit REDUNDANTLY to unreliable volunteer
hosts and granted credit only when independently-computed results agreed
(the validator half of the arXiv 0904.1826 deployment).  This
module is the chip-side half of that contract: it canonicalizes and
compares replica candidate files using the pipeline's own exact tie-break
semantics (``oracle/toplist.py::finalize_candidates`` orders by
``(fA, power, f0)`` descending; ``io/results.py`` defines the provenance
format including its named quarantine gaps) and emits a **signed
verdict artifact** (schema ``erp-quorum/1``) for every decision, so a
grant is always auditable from the artifact alone.

Three layers of defense, cheapest first:

1. **Intrinsic checks** (:func:`intrinsic_problems`) — no second replica
   needed.  A candidate file carries redundancy an adversary must keep
   consistent: ``fA`` is a deterministic function of ``power`` and
   ``n_harm`` (``-log10(chisq_Q(2*power*sigma, 2*n_harm))``), the output
   order is the finalizer's exact sort, frequency bins are globally
   deduped, the provenance header names the computing host, and the
   report names the template-bank epoch.  Bit-flipped powers, reordered
   rows, echoed files and stale-epoch results all die here.
2. **Strict tier** — the candidate sections (and quarantine gap lines)
   must agree **bitwise**.  Two honest replicas of our deterministic
   pipeline on identical software agree at this tier (the chaos soaks
   already prove byte-identity across kill/resume and host adoption).
3. **Fuzzy tier** — bounded frequency/power tolerance for replicas from
   *different* implementations (CPU reference vs chip, different FFT
   builds): candidate identity sets ``(frequency bin, n_harm)`` must
   match exactly, powers within ``power_rtol``, ``fA`` within
   ``fa_atol`` (the same physics-level relaxation as
   ``io/validate.py::compare_candidate_files``, but with no tail
   boundary forgiveness — a quorum grant is all-or-nothing).  Two
   replicas that print the same candidates in another row order agree at
   no tier (one of them is not the deterministic finalizer's order).

Replicas that claim quarantine gaps never fast-path: differing gap sets
are a hard disagreement (a gap is a named hole in the search — granting
across mismatched holes would silently drop candidates), and the
work-fabric scheduler escalates gap-claiming results to full quorum.

The module never imports torch — it is host-side control-plane code that
also runs inside soaks and tools.  The schema, the tolerances and the
canonical JSON that is signed are the JAX package's
``fabric/validator.py``'s, byte for byte: a verdict signed by one
package verifies in the other.  One decision differs: the JAX package's
fuzzy tier grants the same candidates in another row order, so a swap
among rows at the fA cap (which its intrinsic order check cannot see)
could be granted with the reordered file as the canonical result.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import math
import os
from dataclasses import dataclass, field

import numpy as np

from ..io.formats import N_CAND_5
from ..io.results import (
    QUARANTINE_TAG,
    ResultFile,
    format_candidate_line,
    parse_result,
    split_result_sections,
)
from ..oracle.stats import chisq_Q
from ..oracle.toplist import _SIGMA as SIGMA
from ..runtime import faultinject

QUORUM_SCHEMA = "erp-quorum/1"

ENV_KEY = "ERP_QUORUM_KEY"
_DEFAULT_KEY = "erp-quorum-dev"  # dev fallback; deployments set ERP_QUORUM_KEY

# fuzzy-tier tolerances: the same physics-level relaxation the BOINC
# validator applies across FFT builds (io/validate.py documents why)
DEFAULT_POWER_RTOL = 1.5e-2
DEFAULT_FA_ATOL = 0.15
DEFAULT_PARAM_RTOL = 1e-9

# intrinsic fA(power) consistency: printed %g precision (6 significant
# digits of both fields) bounds honest recomputation error far below this
FA_CONSISTENCY_ATOL = 0.02
# beyond this both the stored and recomputed fA sit in chisq_Q underflow
# territory where the 320 cap applies; require only that both saturate
_FA_SATURATED = 300.0


class QuorumError(ValueError):
    """Validator misuse (empty replica set, bad tolerance)."""


# ---------------------------------------------------------------------------
# loading + intrinsic validation


@dataclass
class Replica:
    """One host's reported result for a workunit, as handed to the
    validator by the fabric scheduler."""

    host_id: int
    path: str
    bank_epoch: int | None = None  # epoch the host CLAIMS it used
    reputation: int = 0  # scheduler-side trust weight (fuzzy canonical pick)


@dataclass
class LoadedReplica:
    replica: Replica
    result: ResultFile | None = None
    candidate_lines: list[str] = field(default_factory=list)
    sha256: str = ""
    problems: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems


def _expected_fa(power: float, n_harm: int) -> float:
    raw = power * SIGMA[n_harm]
    q = float(chisq_Q(2.0 * raw, 2 * n_harm))
    return -math.log10(q) if q > 0.0 else 320.0


def intrinsic_problems(
    result: ResultFile,
    *,
    expected_epoch: int | None = None,
    claimed_epoch: int | None = None,
    reporter_host: int | None = None,
    fa_ctol: float = FA_CONSISTENCY_ATOL,
) -> list[str]:
    """Problems a single replica exhibits WITHOUT a second opinion.

    Every check exploits redundancy the deterministic finalizer bakes
    into the file; an adversary must satisfy all of them simultaneously
    or be rejected before any quorum round spends a second host's work.
    """
    problems: list[str] = []
    if not result.done:
        problems.append("not-done: missing %DONE% terminator")
    cands = result.candidates
    if len(cands) > N_CAND_5:
        problems.append(
            f"too-many-candidates: {len(cands)} > {N_CAND_5}"
        )
    if expected_epoch is not None and claimed_epoch != expected_epoch:
        problems.append(
            f"stale-epoch: claimed bank epoch {claimed_epoch}, "
            f"workunit is epoch {expected_epoch}"
        )
    if (
        reporter_host is not None
        and result.header is not None
        and result.header.host_id != reporter_host
    ):
        problems.append(
            f"echo-provenance: header names host {result.header.host_id}, "
            f"reported by host {reporter_host}"
        )
    seen_f0: set[int] = set()
    for i in range(len(cands)):
        n_harm = int(cands["n_harm"][i])
        if n_harm not in SIGMA:
            problems.append(f"bad-n-harm: line {i} has n_harm={n_harm}")
            continue
        fa = float(cands["fA"][i])
        if fa <= 0.0:
            problems.append(f"non-positive-fA: line {i}")
        power = float(cands["power"][i])
        expect = _expected_fa(power, n_harm)
        if fa >= _FA_SATURATED and expect >= _FA_SATURATED:
            pass  # both saturated at the false-alarm cap
        elif abs(fa - expect) > fa_ctol:
            problems.append(
                f"fa-power-inconsistent: line {i} reports fA={fa:g} but "
                f"power={power:g} n_harm={n_harm} implies fA={expect:g}"
            )
        f0 = int(cands["f0"][i])
        if f0 in seen_f0:
            problems.append(f"duplicate-frequency: bin {f0} (line {i})")
        seen_f0.add(f0)
        if i > 0:
            # the finalizer sorts on FULL-precision (fA, power, f0)
            # descending, but the file carries only %g-printed keys:
            # rows whose full-precision fA values tie only at printed
            # precision may legitimately show any printed-power order
            # (the sub-ULP fA difference, not the power, decided the
            # sort) — so only an increase in printed fA itself proves
            # a reordered file
            prev_fa = float(cands["fA"][i - 1])
            if fa > prev_fa:
                problems.append(
                    f"order-violation: line {i} fA={fa:g} outranks "
                    f"line {i - 1} fA={prev_fa:g} "
                    f"(fA must be non-increasing)"
                )
    if result.header is not None:
        gaps = result.header.quarantined
        last = None
        for a, b in gaps:
            if a >= b or (last is not None and a < last):
                problems.append(f"bad-quarantine: ranges {gaps}")
                break
            last = b
    return problems


def load_replica(
    replica: Replica,
    t_obs: float,
    *,
    expected_epoch: int | None = None,
) -> LoadedReplica:
    """Read + parse + intrinsically validate one replica file."""
    loaded = LoadedReplica(replica=replica)
    try:
        with open(replica.path, "rb") as f:
            raw = f.read()
    except OSError as exc:
        loaded.problems.append(f"unreadable: {exc}")
        return loaded
    loaded.sha256 = hashlib.sha256(raw).hexdigest()
    try:
        text = raw.decode("utf-8")
        _, loaded.candidate_lines, _ = split_result_sections(text)
        loaded.result = parse_result(replica.path, t_obs=t_obs)
    except (ValueError, UnicodeDecodeError) as exc:
        loaded.problems.append(f"unparseable: {exc}")
        return loaded
    loaded.problems = intrinsic_problems(
        loaded.result,
        expected_epoch=expected_epoch,
        claimed_epoch=replica.bank_epoch,
        reporter_host=replica.host_id,
    )
    return loaded


# ---------------------------------------------------------------------------
# canonical form + comparison


def _quarantine_line(result: ResultFile) -> str:
    gaps = result.header.quarantined if result.header is not None else []
    if not gaps:
        return ""
    ranges = ", ".join(f"[{a}, {b})" for a, b in gaps)
    return f"{QUARANTINE_TAG} {ranges}"


def canonical_candidate_lines(result: ResultFile) -> list[str]:
    """Candidate lines re-rendered in the finalizer's exact tie-break
    order (``(fA, power, f0)`` descending, ``oracle/toplist.py``):
    files whose rows differ only in the order of printed-precision ties
    canonicalize identically."""
    cands = result.candidates
    order = np.lexsort(
        (
            -cands["f0"].astype(np.int64),
            -cands["power"].astype(np.float64),
            -cands["fA"].astype(np.float64),
        )
    )
    return [
        format_candidate_line(cands[int(i)], result.t_obs).rstrip("\n")
        for i in order
    ]


def canonical_digest(result: ResultFile) -> str:
    """sha256 over the canonical candidate section + quarantine gaps —
    the identity a grant is recorded under."""
    body = "\n".join(canonical_candidate_lines(result) + [_quarantine_line(result)])
    return hashlib.sha256(body.encode("utf-8")).hexdigest()


def compare_replicas(
    a: LoadedReplica,
    b: LoadedReplica,
    *,
    power_rtol: float = DEFAULT_POWER_RTOL,
    fa_atol: float = DEFAULT_FA_ATOL,
    param_rtol: float = DEFAULT_PARAM_RTOL,
) -> tuple[str | None, list[str]]:
    """``(tier, mismatches)``: tier ``"strict"`` on bitwise agreement of
    the candidate sections (+ identical gap lines), ``"fuzzy"`` on
    canonical agreement within tolerance, ``None`` with the reasons
    otherwise."""
    ra, rb = a.result, b.result
    ga = sorted(ra.header.quarantined) if ra.header else []
    gb = sorted(rb.header.quarantined) if rb.header else []
    if ga != gb:
        return None, [f"quarantine-mismatch: {ga} vs {gb}"]
    if a.candidate_lines == b.candidate_lines:
        return "strict", []
    if canonical_candidate_lines(ra) == canonical_candidate_lines(rb):
        # the same printed candidates in another row order: the finalizer's
        # order is deterministic, so one of the two is not its output.  A
        # swap among printed fA ties passes the intrinsic order check (at
        # the production width nearly every candidate sits at the 320 cap),
        # and a fuzzy grant could then credit the reordered replica and
        # keep its bytes; no tier grants the pair, a third replica decides
        return None, ["order-mismatch: the same candidates in another row order"]

    mismatches: list[str] = []
    ca, cb = ra.candidates, rb.candidates

    def keyed(c: np.ndarray) -> dict[tuple[int, int], np.void]:
        return {
            (int(c["f0"][i]), int(c["n_harm"][i])): c[i]
            for i in range(len(c))
        }

    ka, kb = keyed(ca), keyed(cb)
    only_a = sorted(set(ka) - set(kb))
    only_b = sorted(set(kb) - set(ka))
    for key in only_a:
        mismatches.append(f"missing: bin={key[0]} n_harm={key[1]} only in A")
    for key in only_b:
        mismatches.append(f"extra: bin={key[0]} n_harm={key[1]} only in B")
    for key in sorted(set(ka) & set(kb)):
        va, vb = ka[key], kb[key]
        for name in ("P_b", "tau", "Psi"):
            xa, xb = float(va[name]), float(vb[name])
            if abs(xa - xb) > param_rtol * max(1.0, abs(xa)):
                mismatches.append(
                    f"param: bin={key[0]} n_harm={key[1]} {name} "
                    f"{xa!r} vs {xb!r}"
                )
        pa, pb = float(va["power"]), float(vb["power"])
        if abs(pa - pb) > power_rtol * max(abs(pa), abs(pb)):
            mismatches.append(
                f"power: bin={key[0]} n_harm={key[1]} {pa!r} vs {pb!r} "
                f"(rtol {power_rtol:g})"
            )
        fa_a, fa_b = float(va["fA"]), float(vb["fA"])
        if abs(fa_a - fa_b) > fa_atol:
            mismatches.append(
                f"fA: bin={key[0]} n_harm={key[1]} {fa_a!r} vs {fa_b!r} "
                f"(atol {fa_atol:g})"
            )
    if mismatches:
        return None, mismatches
    return "fuzzy", []


# ---------------------------------------------------------------------------
# verdicts


@dataclass
class QuorumOutcome:
    verdict: str  # "agree" | "disagree" | "short"
    tier: str | None  # "strict" | "fuzzy" | "trusted-single" | None
    winner: int | None  # index into replicas of the canonical result
    canonical_sha256: str | None
    loaded: list[LoadedReplica] = field(default_factory=list)
    doc: dict = field(default_factory=dict)
    path: str | None = None  # verdict artifact, when written

    @property
    def granted(self) -> bool:
        return self.verdict == "agree"

    @property
    def invalid_replicas(self) -> list[LoadedReplica]:
        return [lr for lr in self.loaded if not lr.ok]


def _signing_key() -> bytes:
    return (os.environ.get(ENV_KEY) or _DEFAULT_KEY).encode("utf-8")


def _canonical_json(doc: dict) -> bytes:
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode(
        "utf-8"
    )


def sign_verdict(doc: dict) -> dict:
    """Attach an HMAC-SHA256 signature over the canonical JSON of the
    document (minus the signature block itself).  The shared key comes
    from ``ERP_QUORUM_KEY`` — the fleet server and its validators hold
    it, volunteer hosts do not, so a host cannot forge a grant record."""
    body = {k: v for k, v in doc.items() if k != "signature"}
    mac = hmac.new(_signing_key(), _canonical_json(body), hashlib.sha256)
    doc["signature"] = {
        "algo": "hmac-sha256",
        "key_id": "env" if os.environ.get(ENV_KEY) else "dev",
        "value": mac.hexdigest(),
    }
    return doc


def verify_verdict_signature(doc: dict) -> bool:
    sig = doc.get("signature")
    if not isinstance(sig, dict) or sig.get("algo") != "hmac-sha256":
        return False
    body = {k: v for k, v in doc.items() if k != "signature"}
    mac = hmac.new(_signing_key(), _canonical_json(body), hashlib.sha256)
    return hmac.compare_digest(mac.hexdigest(), str(sig.get("value", "")))


def _verdict_doc(
    wu_id: str,
    t_obs: float,
    expected_epoch: int | None,
    outcome: QuorumOutcome,
    tolerances: dict,
    mismatches: list[str],
    corr_id: str | None = None,
) -> dict:
    doc = {
        "schema": QUORUM_SCHEMA,
        "wu": wu_id,
        "t_obs": t_obs,
        "bank_epoch": expected_epoch,
        "verdict": outcome.verdict,
        "tier": outcome.tier,
        "winner_host": (
            outcome.loaded[outcome.winner].replica.host_id
            if outcome.winner is not None
            else None
        ),
        "canonical_sha256": outcome.canonical_sha256,
        "tolerances": tolerances,
        "mismatches": mismatches[:50],
        "replicas": [
            {
                "host": lr.replica.host_id,
                "path": os.path.basename(lr.replica.path),
                "sha256": lr.sha256,
                "bank_epoch": lr.replica.bank_epoch,
                "n_candidates": (
                    len(lr.result.candidates) if lr.result is not None else None
                ),
                "quarantined": (
                    [list(g) for g in lr.result.header.quarantined]
                    if lr.result is not None and lr.result.header is not None
                    else []
                ),
                "intrinsic_ok": lr.ok,
                "problems": lr.problems[:20],
            }
            for lr in outcome.loaded
        ],
    }
    if corr_id is not None:
        # the fabric's workunit correlation id, so a verdict artifact
        # joins the same end-to-end lifecycle as the flightrec events,
        # trace lanes and metrics labels (absent pre-correlation docs
        # stay byte-identical and verify under the same signature)
        doc["corr_id"] = corr_id
    return sign_verdict(doc)


def _write_verdict(doc: dict, outdir: str, wu_id: str, round_no: int) -> str:
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{wu_id}.r{round_no}.quorum.json")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def validate_quorum(
    wu_id: str,
    replicas: list[Replica],
    t_obs: float,
    *,
    expected_epoch: int | None = None,
    power_rtol: float = DEFAULT_POWER_RTOL,
    fa_atol: float = DEFAULT_FA_ATOL,
    param_rtol: float = DEFAULT_PARAM_RTOL,
    outdir: str | None = None,
    round_no: int = 0,
    corr_id: str | None = None,
) -> QuorumOutcome:
    """Quorum-validate >= 2 replicas of one workunit.

    Returns ``verdict="agree"`` with the winning replica when some pair
    of intrinsically-valid replicas agrees (strict tier preferred; on a
    fuzzy-tier grant the canonical result comes from the
    higher-reputation member of the first agreeing pair), ``"disagree"``
    when >= 2 valid replicas exist but no pair agrees, and ``"short"``
    when fewer than 2 replicas survive intrinsic validation.  The signed
    ``erp-quorum/1`` artifact is written under ``outdir`` when given.
    """
    if not replicas:
        raise QuorumError("validate_quorum needs at least one replica")
    faultinject.fault_point("validate", wu=wu_id, n=len(replicas))
    tolerances = {
        "power_rtol": power_rtol,
        "fa_atol": fa_atol,
        "param_rtol": param_rtol,
    }
    loaded = [
        load_replica(r, t_obs, expected_epoch=expected_epoch)
        for r in replicas
    ]
    outcome = QuorumOutcome(
        verdict="short", tier=None, winner=None,
        canonical_sha256=None, loaded=loaded,
    )
    valid = [i for i, lr in enumerate(loaded) if lr.ok]
    mismatches: list[str] = []
    if len(valid) >= 2:
        outcome.verdict = "disagree"
        pair: tuple[int, int] | None = None
        for want in ("strict", "fuzzy"):
            for ai in range(len(valid)):
                for bi in range(ai + 1, len(valid)):
                    i, j = valid[ai], valid[bi]
                    tier, mm = compare_replicas(
                        loaded[i], loaded[j],
                        power_rtol=power_rtol, fa_atol=fa_atol,
                        param_rtol=param_rtol,
                    )
                    if tier == want:
                        pair = (i, j)
                        outcome.tier = tier
                        break
                    if want == "strict" and tier is None and mm:
                        mismatches.extend(
                            f"{loaded[i].replica.host_id}/"
                            f"{loaded[j].replica.host_id}: {m}"
                            for m in mm
                        )
                if pair:
                    break
            if pair:
                break
        if pair:
            i, j = pair
            if outcome.tier == "strict":
                outcome.winner = i
            else:
                outcome.winner = (
                    i
                    if loaded[i].replica.reputation
                    >= loaded[j].replica.reputation
                    else j
                )
            outcome.verdict = "agree"
            outcome.canonical_sha256 = canonical_digest(
                loaded[outcome.winner].result
            )
            mismatches = []
    outcome.doc = _verdict_doc(
        wu_id, t_obs, expected_epoch, outcome, tolerances, mismatches,
        corr_id=corr_id,
    )
    if outdir is not None:
        outcome.path = _write_verdict(outcome.doc, outdir, wu_id, round_no)
    return outcome


def validate_single(
    wu_id: str,
    replica: Replica,
    t_obs: float,
    *,
    expected_epoch: int | None = None,
    outdir: str | None = None,
    round_no: int = 0,
    corr_id: str | None = None,
) -> QuorumOutcome:
    """Adaptive-replication fast path: a single replica from a TRUSTED
    host, granted on intrinsic validity alone (tier
    ``"trusted-single"``).  A replica claiming quarantine gaps is never
    granted here — gaps are anomalous by definition and must be
    confirmed by a full quorum, which is what keeps a reputation-laundering
    host from inventing holes in the search."""
    faultinject.fault_point("validate", wu=wu_id, n=1)
    loaded = load_replica(replica, t_obs, expected_epoch=expected_epoch)
    if (
        loaded.ok
        and loaded.result.header is not None
        and loaded.result.header.quarantined
    ):
        loaded.problems.append(
            "gap-claim-needs-quorum: trusted-single grants may not claim "
            "quarantine gaps"
        )
    outcome = QuorumOutcome(
        verdict="agree" if loaded.ok else "disagree",
        tier="trusted-single" if loaded.ok else None,
        winner=0 if loaded.ok else None,
        canonical_sha256=canonical_digest(loaded.result) if loaded.ok else None,
        loaded=[loaded],
    )
    outcome.doc = _verdict_doc(
        wu_id, t_obs, expected_epoch, outcome, {}, list(loaded.problems),
        corr_id=corr_id,
    )
    if outdir is not None:
        outcome.path = _write_verdict(outcome.doc, outdir, wu_id, round_no)
    return outcome


# ---------------------------------------------------------------------------
# artifact schema checking (tools/report_check.py)

_VERDICTS = ("agree", "disagree", "short")
_TIERS = (None, "strict", "fuzzy", "trusted-single")


def validate_quorum_verdict(
    doc, *, allow_dev_key: bool | None = None
) -> list[str]:
    """Structural + signature problems of an ``erp-quorum/1`` document
    (empty list = valid) — the ``tools/report_check.py`` hook.

    ``allow_dev_key`` decides whether a signature made with the
    hardcoded dev fallback key counts: anyone can forge such an
    artifact, so an authoritative check must reject it.  ``None``
    (default) allows the dev key only when the checker itself has no
    ``ERP_QUORUM_KEY`` configured (a dev/test environment); ``False``
    always flags it; ``True`` always allows it."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return ["not a JSON object"]
    if doc.get("schema") != QUORUM_SCHEMA:
        problems.append(f"schema is {doc.get('schema')!r}, not {QUORUM_SCHEMA}")
    if not isinstance(doc.get("wu"), str) or not doc.get("wu"):
        problems.append("missing wu id")
    if not isinstance(doc.get("t_obs"), (int, float)):
        problems.append("missing t_obs")
    if doc.get("verdict") not in _VERDICTS:
        problems.append(f"bad verdict {doc.get('verdict')!r}")
    if doc.get("tier") not in _TIERS:
        problems.append(f"bad tier {doc.get('tier')!r}")
    replicas = doc.get("replicas")
    if not isinstance(replicas, list) or not replicas:
        problems.append("missing replicas")
        replicas = []
    for i, rep in enumerate(replicas):
        if not isinstance(rep, dict):
            problems.append(f"replica {i} not an object")
            continue
        for key in ("host", "sha256", "intrinsic_ok", "problems"):
            if key not in rep:
                problems.append(f"replica {i} missing {key}")
    if doc.get("verdict") == "agree":
        if not doc.get("canonical_sha256"):
            problems.append("agree verdict without canonical_sha256")
        if doc.get("winner_host") is None:
            problems.append("agree verdict without winner_host")
    if not isinstance(doc.get("mismatches"), list):
        problems.append("missing mismatches list")
    if "corr_id" in doc and not (
        isinstance(doc["corr_id"], str) and doc["corr_id"]
    ):
        problems.append("corr_id present but not a nonempty string")
    if allow_dev_key is None:
        allow_dev_key = not os.environ.get(ENV_KEY)
    sig = doc.get("signature")
    key_id = sig.get("key_id") if isinstance(sig, dict) else None
    if key_id == "dev" and not allow_dev_key:
        problems.append(
            "signed with the dev fallback key (forgeable; authoritative "
            "verification requires ERP_QUORUM_KEY)"
        )
    if not verify_verdict_signature(doc):
        problems.append("signature verification failed")
    return problems
