"""Deterministic fault injection for the resilience layer.

The reference app earns its robustness on hostile volunteer hosts; this
module lets us MANUFACTURE that hostility on demand so the recovery paths
(``runtime/resilience.py``, checkpoint generations, the chaos soak) are
exercised by tests instead of waiting for real flaky hardware.  Fault
points are threaded through the hot paths — batch dispatch, the bank H2D
upload, checkpoint writes and the result write — and stay inert unless
``ERP_FAULT_SPEC`` names them.  ``rescore_feed`` is the JAX package's
background rescorer's site: a spec naming it parses, and in the port it
never fires.

Spec grammar (``ERP_FAULT_SPEC``)::

    spec    := entry (";" entry)*
    entry   := "seed=" INT
             | site ":" kind [trigger]
    site    := dispatch | h2d | ckpt_write | rescore_feed | result_write
             | lease_io | merge | result_report | validate
             | serving_submit | serving_dispatch | journal_write
    kind    := oom   (transient RESOURCE_EXHAUSTED-style InjectedFault)
             | eio   (InjectedIOError with errno EIO)
             | exc   (transient generic InjectedFault)
             | fatal (permanent InjectedFault)
             | hang  (deterministic stall: sleeps ERP_FAULT_HANG_S, a wedge
                      only the watchdog can break — raises nothing)
             | corrupt (deterministic seeded mutation of the ``payload=``
                      value passed through the fault point: bit flips for
                      bytes/str, a row swap for sequences — raises nothing,
                      the caller gets the mutated payload back)
    trigger := "@n=" INT      fire exactly on the Nth hit of the site
             | "@every=" INT  fire on every Nth hit
             | "@p=" FLOAT    fire per hit with probability p (seeded RNG)
             | "@tmpl=" INT   fire when the hit's ctx window [start, stop)
                              contains template INT (poison-range faults)

The default trigger is ``@n=1``.  Example:
``dispatch:oom@n=37;ckpt_write:eio@p=0.05;seed=7``.

Everything here is deterministic given the spec: counted triggers fire on
exact hit numbers, probabilistic triggers draw from a ``random.Random``
seeded from ``(seed, site, kind, rule index)``, so two runs with the same
spec inject the same schedule.  The module NEVER imports torch, and with no
spec configured ``fault_point`` is a single flag test — the production
hot loop pays nothing.  The grammar, sites and kinds are the JAX
package's ``runtime/faultinject.py``, so one spec drives either package.

Cross-restart persistence: when ``ERP_FAULT_STATE`` names a JSON file,
every rule that fires is recorded there, and ``configure`` marks rules
already on record as *spent* (they never fire again).  A supervised
restart (``--supervised`` re-execing after a watchdog exit) therefore
sees each injected wedge exactly once — the wedge behaves like a real
transient environmental fault instead of a groundhog-day one.  Rules with
``@tmpl=`` triggers deliberately ignore the state file: a poison range is
supposed to wedge on every visit until quarantined.
"""

from __future__ import annotations

import errno
import json
import os
import random
import threading
import time
from dataclasses import dataclass, field

ENV_SPEC = "ERP_FAULT_SPEC"
ENV_STATE = "ERP_FAULT_STATE"
ENV_HANG_S = "ERP_FAULT_HANG_S"

SITES = (
    "dispatch",
    "h2d",
    "ckpt_write",
    "rescore_feed",
    "result_write",
    "lease_io",
    "merge",
    # volunteer-fabric control plane (fabric/): the report a host hands
    # to the scheduler, and the quorum validator's compare step
    "result_report",
    "validate",
    # resident serving tier (serving/): the submit admission path, the
    # dispatch thread's hand-off to the Scheduler, and every append to
    # the WU journal's write-ahead log
    "serving_submit",
    "serving_dispatch",
    "journal_write",
)
KINDS = ("oom", "eio", "exc", "fatal", "hang", "corrupt")


class FaultSpecError(ValueError):
    """Malformed ERP_FAULT_SPEC (unknown site/kind, bad trigger)."""


class InjectedFault(RuntimeError):
    """A manufactured device/runtime failure.  ``transient`` mirrors the
    classification ``runtime/resilience.py`` would assign a real one."""

    def __init__(self, message: str, transient: bool = True):
        super().__init__(message)
        self.transient = transient


class InjectedIOError(OSError):
    """A manufactured I/O failure (errno EIO): indistinguishable from a
    real one to every caller except tests that check the type."""


@dataclass
class _Rule:
    site: str
    kind: str
    nth: int | None = None
    every: int | None = None
    p: float | None = None
    tmpl: int | None = None
    rng: random.Random | None = None
    fired: int = field(default=0, compare=False)
    spent: bool = field(default=False, compare=False)

    def should_fire(self, hit: int, ctx: dict) -> bool:
        if self.spent:
            return False
        if self.tmpl is not None:
            start, stop = ctx.get("start"), ctx.get("stop")
            if start is None or stop is None:
                return False
            return int(start) <= self.tmpl < int(stop)
        if self.nth is not None:
            return hit == self.nth
        if self.every is not None:
            return hit % self.every == 0
        return self.rng.random() < self.p


_lock = threading.Lock()
_active = False
_rules: dict[str, list[_Rule]] = {}
_hits: dict[str, int] = {}
_fired_total = 0
_seed = 0


def parse_spec(spec: str) -> tuple[dict[str, list[_Rule]], int]:
    """Parse a fault spec into per-site rules + the RNG seed.  Raises
    :class:`FaultSpecError` on anything the grammar doesn't cover — a typo
    silently injecting nothing would defeat the whole harness."""
    rules: dict[str, list[_Rule]] = {}
    seed = 0
    index = 0
    for raw in spec.split(";"):
        entry = raw.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            try:
                seed = int(entry[5:])
            except ValueError:
                raise FaultSpecError(f"bad seed in fault spec: {entry!r}")
            continue
        if ":" not in entry:
            raise FaultSpecError(
                f"fault spec entry {entry!r} is not 'site:kind[@trigger]' "
                f"or 'seed=N'"
            )
        site, rest = entry.split(":", 1)
        site = site.strip()
        if site not in SITES:
            raise FaultSpecError(
                f"unknown fault site {site!r} (know: {', '.join(SITES)})"
            )
        kind, _, trigger = rest.partition("@")
        kind = kind.strip()
        if kind not in KINDS:
            raise FaultSpecError(
                f"unknown fault kind {kind!r} (know: {', '.join(KINDS)})"
            )
        rule = _Rule(site=site, kind=kind)
        trigger = trigger.strip()
        if not trigger:
            rule.nth = 1
        elif trigger.startswith("n="):
            try:
                rule.nth = int(trigger[2:])
            except ValueError:
                raise FaultSpecError(f"bad trigger in {entry!r}")
            if rule.nth < 1:
                raise FaultSpecError(f"trigger n must be >= 1 in {entry!r}")
        elif trigger.startswith("every="):
            try:
                rule.every = int(trigger[6:])
            except ValueError:
                raise FaultSpecError(f"bad trigger in {entry!r}")
            if rule.every < 1:
                raise FaultSpecError(f"trigger every must be >= 1 in {entry!r}")
        elif trigger.startswith("p="):
            try:
                rule.p = float(trigger[2:])
            except ValueError:
                raise FaultSpecError(f"bad trigger in {entry!r}")
            if not 0.0 <= rule.p <= 1.0:
                raise FaultSpecError(f"trigger p must be in [0, 1] in {entry!r}")
        elif trigger.startswith("tmpl="):
            try:
                rule.tmpl = int(trigger[5:])
            except ValueError:
                raise FaultSpecError(f"bad trigger in {entry!r}")
            if rule.tmpl < 0:
                raise FaultSpecError(f"trigger tmpl must be >= 0 in {entry!r}")
        else:
            raise FaultSpecError(
                f"unknown trigger {trigger!r} in {entry!r} "
                f"(know: n=, every=, p=, tmpl=)"
            )
        rule._index = index  # type: ignore[attr-defined]
        index += 1
        rules.setdefault(site, []).append(rule)
    # seed the probabilistic rules only after the whole spec parsed, so a
    # trailing seed= entry still applies to rules written before it
    for site_rules in rules.values():
        for rule in site_rules:
            if rule.p is not None:
                rule.rng = random.Random(
                    f"{seed}:{rule.site}:{rule.kind}:{rule._index}"  # type: ignore[attr-defined]
                )
    return rules, seed


def _state_path() -> str | None:
    return os.environ.get(ENV_STATE) or None


def _load_spent(path: str) -> set[int]:
    """Rule indices recorded as fired by earlier processes sharing the
    state file (missing/corrupt file reads as empty — injection must never
    be less deterministic than no injection)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
        return {int(i) for i in doc.get("fired", [])}
    except (OSError, ValueError):
        return set()


def _mark_spent(path: str, index: int) -> None:
    spent = _load_spent(path)
    spent.add(index)
    doc = {"schema": "erp-fault-state/1", "fired": sorted(spent)}
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except OSError:
        pass


def configure(spec: str | None = None) -> bool:
    """(Re)load the fault schedule — from ``spec`` when given, else from
    ``ERP_FAULT_SPEC``.  Resets all hit counters.  Returns True when any
    fault rule is armed.  Raises :class:`FaultSpecError` on a malformed
    spec (the driver maps it to ``RADPUL_EVAL`` like any bad argument)."""
    global _active, _rules, _hits, _fired_total, _seed
    if spec is None:
        spec = os.environ.get(ENV_SPEC, "")
    with _lock:
        _rules, _seed = parse_spec(spec) if spec.strip() else ({}, 0)
        state = _state_path()
        if state and _rules:
            spent = _load_spent(state)
            for site_rules in _rules.values():
                for rule in site_rules:
                    # tmpl rules stay live across restarts by design: a
                    # poison range wedges on every visit until quarantined
                    if rule.tmpl is None and rule._index in spent:  # type: ignore[attr-defined]
                        rule.spent = True
        _hits = {}
        _fired_total = 0
        _active = bool(_rules)
    return _active


def active() -> bool:
    return _active


def hits(site: str) -> int:
    """How many times ``site``'s fault point has been evaluated since
    :func:`configure` (0 while inactive — inert points don't count)."""
    with _lock:
        return _hits.get(site, 0)


def fired_total() -> int:
    with _lock:
        return _fired_total


def corrupt_bytes(data: bytes, rng: random.Random, flips: int = 3) -> bytes:
    """Deterministically flip high bits of ``flips`` seeded positions.
    The 0x40 bit keeps printable ASCII printable while changing digits
    and letters beyond any validator tolerance — this is the shared
    mutation primitive the fabric's bit-flip host model also uses, so an
    injected ``corrupt`` fault and a lying volunteer host corrupt
    payloads the same way."""
    if not data:
        return data
    buf = bytearray(data)
    for _ in range(max(1, flips)):
        pos = rng.randrange(len(buf))
        buf[pos] ^= 0x40
    return bytes(buf)


def swap_rows(rows: list, rng: random.Random) -> list:
    """Deterministically swap two seeded distinct rows (a new list; the
    input is never mutated in place).  Single-row payloads come back
    unchanged."""
    out = list(rows)
    if len(out) >= 2:
        i = rng.randrange(len(out))
        j = rng.randrange(len(out) - 1)
        if j >= i:
            j += 1
        out[i], out[j] = out[j], out[i]
    return out


def _corrupt_payload(payload, rng: random.Random):
    if isinstance(payload, bytes):
        return corrupt_bytes(payload, rng)
    if isinstance(payload, str):
        return corrupt_bytes(payload.encode("utf-8"), rng).decode(
            "utf-8", errors="replace"
        )
    if isinstance(payload, (list, tuple)):
        swapped = swap_rows(list(payload), rng)
        return type(payload)(swapped) if isinstance(payload, tuple) else swapped
    return payload


def fault_point(site: str, payload=None, **ctx):
    """Evaluate the fault point ``site``; raises the configured injected
    exception when a rule fires.  With no spec configured this is a single
    module-flag test — safe to leave in production hot loops.

    ``payload`` threads a value THROUGH the fault point: it is returned
    unchanged unless a ``corrupt`` rule fires, in which case the caller
    receives a deterministically mutated copy (bit flips for bytes/str, a
    row swap for list/tuple).  ``corrupt`` rules only match hits that
    carry a payload — a payload-less hit falls through to the next rule."""
    if not _active:
        return payload
    return _evaluate(site, ctx, payload)


def _evaluate(site: str, ctx: dict, payload=None):
    global _fired_total
    with _lock:
        hit = _hits.get(site, 0) + 1
        _hits[site] = hit
        fired_rule = None
        for rule in _rules.get(site, ()):
            if rule.kind == "corrupt" and payload is None:
                continue
            if rule.should_fire(hit, ctx):
                rule.fired += 1
                _fired_total += 1
                fired_rule = rule
                break
        state = _state_path()
        seed = _seed
    if fired_rule is None:
        return payload
    # persist the firing BEFORE acting: a hang ends in a hard exit that
    # would otherwise lose the record and re-wedge every restart
    if state:
        _mark_spent(state, fired_rule._index)  # type: ignore[attr-defined]
    # telemetry outside the lock; these modules never import torch either
    from . import flightrec, metrics
    from . import logging as erplog

    metrics.counter("faultinject.fired").inc()
    flightrec.record(
        "fault-injected", site=site, fault=fired_rule.kind, hit=hit, **ctx
    )
    detail = f"injected {fired_rule.kind} at {site} (hit {hit})"
    erplog.warn("Fault injection: %s\n", detail)
    if fired_rule.kind == "corrupt":
        # deterministic given the spec: the mutation RNG is seeded from
        # (spec seed, site, hit number), so two runs with the same spec
        # corrupt the same payloads the same way
        return _corrupt_payload(
            payload, random.Random(f"{seed}:{site}:corrupt:{hit}")
        )
    if fired_rule.kind == "hang":
        _hang(detail)
        return payload
    if fired_rule.kind == "oom":
        raise InjectedFault(f"RESOURCE_EXHAUSTED: {detail}")
    if fired_rule.kind == "eio":
        raise InjectedIOError(errno.EIO, detail)
    if fired_rule.kind == "fatal":
        raise InjectedFault(detail, transient=False)
    raise InjectedFault(detail)


def _hang(detail: str) -> None:
    """A deterministic wedge: block the calling thread for
    ``ERP_FAULT_HANG_S`` seconds (default effectively forever).  The sleep
    deliberately ignores the watchdog's cooperative-abort flag — it models
    a thread stuck inside a C call (a dead collective, wedged device
    stream, NFS heartbeat write), which only the escalation ladder's hard
    exit can clear."""
    try:
        hang_s = float(os.environ.get(ENV_HANG_S, "3600"))
    except ValueError:
        hang_s = 3600.0
    deadline = time.monotonic() + hang_s
    while time.monotonic() < deadline:
        time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))


# arm from the environment at import so standalone tools inherit the spec
# without an explicit configure(); a malformed env spec stays silent here
# (nothing armed) — the driver's explicit configure() re-raises it loudly
try:
    configure()
except FaultSpecError:
    pass
