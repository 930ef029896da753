"""WU journal: the FleetServer's append-only write-ahead log.

BOINC's deployment model assumes every component can die and be
re-issued; the journal keeps a crash of the resident server from losing
accepted work.  It is a JSONL WAL (``erp-serving-journal/1``) next to the server's resume dir
recording every workunit lifecycle transition:

* ``submit``  — the WU was ACCEPTED: full serialized ``DriverArgs``
  (all fields are plain scalars) + corr_id, **fsync'd** before the
  submit call returns, so an accepted WU survives any crash;
* ``dispatch`` — the dispatch thread handed the WU to the Scheduler
  (flushed, not fsync'd: a lost dispatch record only costs a re-run);
* ``done``    — the result file was granted; carries the sha256
  **payload digest** of the result bytes, **fsync'd** (the grant is the
  other durability point — after it, compaction may drop the WU);
* ``failed``  — terminal failure with the driver's mapped exit code;
* ``close``   — the drain-or-abort decision ``FleetServer.close()``
  took, so a post-mortem can tell "abandoned on purpose" from "lost".

**Replay** (:func:`replay`) folds the log into per-ticket state: every
accepted-but-ungranted WU (submitted or dispatched, no terminal record)
comes back in original submit order — FIFO-within-affinity packing is
preserved because the server re-enqueues in that order and the packing
rule is applied at pop time, exactly as for live submits.  Replay is a
pure function of the file: replaying twice gives the same state as
replaying once, which is what makes repeated crash-restart cycles safe.

**Compaction rule**: once a ticket is terminal (done/failed) all its
records are dead weight; :func:`compact` atomically rewrites the log
keeping only non-terminal tickets' records (plus their original seq
numbers, so ordering survives).  The server compacts at resume time and
after a clean drain-close — the journal's steady-state size is
proportional to the backlog, not to the total served.

Every append funnels through the ``journal_write`` fault site
(``runtime/faultinject.py``) and is retried under the run's transient
budget (``runtime/resilience.py``), so an injected or real EIO on the
WAL degrades to a retry, not a lost WU.  ``validate_journal`` is wired
into the JAX package's ``tools/metrics_report.py --check`` like every other artifact
schema; a torn final line (the crash case) is tolerated and counted,
torn lines anywhere else are corruption.

The port's copy of the JAX package's ``serving/journal.py``: the same
format, byte for byte, so either package's server replays the other's
journal.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time

from ..runtime import faultinject
from ..runtime import metrics
from ..runtime import resilience

JOURNAL_SCHEMA = "erp-serving-journal/1"
JOURNAL_NAME = "serving-journal.jsonl"

EVENTS = ("submit", "dispatch", "done", "failed", "close")
TERMINAL_EVENTS = ("done", "failed")


def journal_path(dirpath: str) -> str:
    """The journal's canonical location inside a server resume dir."""
    return os.path.join(dirpath, JOURNAL_NAME)


def payload_digest(path: str | None) -> str | None:
    """sha256 hex digest of a result file's bytes — the provenance hook
    the byte-identity gates (``fleet_bench --verify``, serving chaos)
    cross-check.  None when the file is unreadable."""
    if not path:
        return None
    try:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()
    except OSError:
        return None


def _args_dict(args) -> dict:
    """Serialize the driver argument surface for replay re-enqueue."""
    if dataclasses.is_dataclass(args) and not isinstance(args, type):
        return dataclasses.asdict(args)
    return dict(vars(args))


class WUJournal:
    """Append handle on one journal file.  Thread-safe; opens lazily and
    continues the line ``seq`` of an existing file so compaction and
    crash-restart never reset ordering."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._fh = None
        self._seq = 0
        if os.path.exists(path):
            self._seq = replay(path).max_seq

    # -- low-level append -------------------------------------------------

    def append(self, event: str, ticket: str | None, *, fsync: bool = False,
               **fields) -> dict:
        with self._lock:
            self._seq += 1
            rec = {
                "schema": JOURNAL_SCHEMA,
                "seq": self._seq,
                "t": time.time(),
                "pid": os.getpid(),
                "event": event,
                "ticket": ticket,
                **fields,
            }
            line = json.dumps(rec, sort_keys=True) + "\n"

            def _write():
                faultinject.fault_point(
                    "journal_write", event=event, ticket=ticket
                )
                if self._fh is None or self._fh.closed:
                    os.makedirs(
                        os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True,
                    )
                    self._fh = open(self.path, "a", encoding="utf-8")
                self._fh.write(line)
                self._fh.flush()
                if fsync:
                    os.fsync(self._fh.fileno())

            # transient EIO on the WAL spends retry budget instead of
            # dropping an accepted WU (the serving chaos soak injects
            # exactly this)
            resilience.call_with_retry(_write, "journal_write")
            metrics.gauge("fleet.journal_bytes").set(self._fh.tell())
        return rec

    # -- lifecycle records ------------------------------------------------

    def record_submit(self, ticket: str, args, *,
                      corr_id: str | None = None) -> dict:
        return self.append(
            "submit", ticket, fsync=True,
            args=_args_dict(args), corr_id=corr_id,
        )

    def record_dispatch(self, ticket: str) -> dict:
        return self.append("dispatch", ticket)

    def record_done(self, ticket: str, outputfile: str | None) -> dict:
        return self.append(
            "done", ticket, fsync=True,
            code=0, digest=payload_digest(outputfile),
        )

    def record_failed(self, ticket: str, code: int,
                      error: str | None = None) -> dict:
        return self.append("failed", ticket, code=int(code), error=error)

    def record_close(self, mode: str, *, pending: int,
                     abandoned: list[str] | None = None) -> dict:
        return self.append(
            "close", None, fsync=True,
            mode=mode, pending=int(pending), abandoned=abandoned or [],
        )

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def compact(self) -> dict:
        """Apply the compaction rule to this journal (see
        :func:`compact`); reopens the append handle on the new file."""
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()
            self._fh = None
            return compact(self.path)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()
            self._fh = None


# ---------------------------------------------------------------------------
# replay


@dataclasses.dataclass
class JournalState:
    """The folded view of one journal file (pure function of its bytes:
    replaying twice == replaying once)."""

    pending: list[dict] = dataclasses.field(default_factory=list)
    submits: dict = dataclasses.field(default_factory=dict)
    done: dict = dataclasses.field(default_factory=dict)
    failed: dict = dataclasses.field(default_factory=dict)
    dispatched: set = dataclasses.field(default_factory=set)
    closes: list[dict] = dataclasses.field(default_factory=list)
    records: int = 0
    torn: int = 0
    max_seq: int = 0
    max_wu_seq: int = 0


def _wu_seq(ticket: str | None) -> int:
    """Numeric suffix of a ``<name>-wu-<N>`` ticket (0 when unparseable)
    — lets a resumed server continue ticket numbering without reuse."""
    try:
        return int(str(ticket).rsplit("-", 1)[1])
    except (IndexError, ValueError):
        return 0


def _read_lines(path: str):
    """(lineno, parsed-or-None, raw) triples; parse failures yield None
    so the caller decides whether a torn line is tolerable."""
    with open(path, encoding="utf-8") as f:
        for lineno, raw in enumerate(f, start=1):
            if not raw.strip():
                continue
            try:
                doc = json.loads(raw)
                if not isinstance(doc, dict):
                    doc = None
            except ValueError:
                doc = None
            yield lineno, doc, raw


def replay(path: str) -> JournalState:
    """Fold the journal into per-ticket state.  ``pending`` holds the
    submit records of every accepted-but-ungranted WU in original submit
    order; duplicate submits for a ticket keep the first (idempotency).
    Unparseable lines are skipped and counted as torn."""
    st = JournalState()
    if not os.path.exists(path):
        return st
    for _lineno, doc, _raw in _read_lines(path):
        if doc is None or doc.get("schema") != JOURNAL_SCHEMA:
            st.torn += 1
            continue
        st.records += 1
        st.max_seq = max(st.max_seq, int(doc.get("seq") or 0))
        event = doc.get("event")
        ticket = doc.get("ticket")
        if event == "close":
            st.closes.append(doc)
            continue
        if ticket is None:
            st.torn += 1
            continue
        st.max_wu_seq = max(st.max_wu_seq, _wu_seq(ticket))
        if event == "submit":
            st.submits.setdefault(ticket, doc)
        elif event == "dispatch":
            st.dispatched.add(ticket)
        elif event == "done":
            st.done.setdefault(ticket, doc)
        elif event == "failed":
            st.failed.setdefault(ticket, doc)
    st.pending = [
        rec for t, rec in st.submits.items()
        if t not in st.done and t not in st.failed
    ]
    return st


def compact(path: str) -> dict:
    """The compaction rule: drop every record of terminal (done/failed)
    tickets and stale ``close`` markers; keep non-terminal tickets'
    records verbatim (original seq, original order) plus the FINAL
    ``close`` marker, so the journaled drain/abort decision survives
    compaction and a fully-drained journal still self-identifies as
    ``erp-serving-journal/1``.  Atomic tmp+fsync+replace, same
    discipline as every other artifact writer.  Returns
    ``{"kept": n, "dropped": m}``."""
    st = replay(path)
    terminal = set(st.done) | set(st.failed)
    rows = list(_read_lines(path))
    last_close = max(
        (
            lineno
            for lineno, doc, _raw in rows
            if doc is not None
            and doc.get("schema") == JOURNAL_SCHEMA
            and doc.get("event") == "close"
        ),
        default=None,
    )
    kept_lines: list[str] = []
    dropped = 0
    for lineno, doc, raw in rows:
        if doc is None or doc.get("schema") != JOURNAL_SCHEMA:
            dropped += 1
            continue
        if doc.get("event") == "close" and lineno != last_close:
            dropped += 1
            continue
        if doc.get("event") != "close" and doc.get("ticket") in terminal:
            dropped += 1
            continue
        kept_lines.append(raw if raw.endswith("\n") else raw + "\n")
    if dropped == 0:
        return {"kept": len(kept_lines), "dropped": 0}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.writelines(kept_lines)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    metrics.counter("fleet.journal_compactions").inc()
    return {"kept": len(kept_lines), "dropped": dropped}


# ---------------------------------------------------------------------------
# validation (the metrics_report --check hook)


def validate_journal(path: str) -> list[str]:
    """Structural problems in a journal file (empty list = valid).
    Checks: schema on every line, known events, strictly increasing seq,
    submit-before-transition ordering, digests on done records, no
    transitions after a terminal record.  A single unparseable FINAL
    line is the tolerated crash-torn tail; torn lines anywhere else are
    corruption."""
    problems: list[str] = []
    if not os.path.exists(path):
        return [f"{path}: no such journal"]
    rows = list(_read_lines(path))
    if not rows:
        return problems
    last_seq = 0
    submitted: set = set()
    terminal: set = set()
    for i, (lineno, doc, _raw) in enumerate(rows):
        if doc is None or doc.get("schema") != JOURNAL_SCHEMA:
            if i == len(rows) - 1:
                continue  # torn tail: the crash case, tolerated
            problems.append(f"line {lineno}: unparseable or wrong schema")
            continue
        event = doc.get("event")
        if event not in EVENTS:
            problems.append(f"line {lineno}: unknown event {event!r}")
            continue
        seq = doc.get("seq")
        if not isinstance(seq, int) or seq <= last_seq:
            problems.append(
                f"line {lineno}: seq {seq!r} not strictly increasing "
                f"(after {last_seq})"
            )
        else:
            last_seq = seq
        if event == "close":
            if doc.get("mode") not in ("drain", "abort"):
                problems.append(
                    f"line {lineno}: close mode {doc.get('mode')!r}"
                )
            continue
        ticket = doc.get("ticket")
        if not ticket:
            problems.append(f"line {lineno}: {event} without a ticket")
            continue
        if event == "submit":
            if not isinstance(doc.get("args"), dict):
                problems.append(
                    f"line {lineno}: submit {ticket} has no args dict"
                )
            submitted.add(ticket)
            continue
        if ticket not in submitted:
            problems.append(
                f"line {lineno}: {event} for never-submitted {ticket}"
            )
        if ticket in terminal:
            problems.append(
                f"line {lineno}: {event} after terminal record for {ticket}"
            )
        if event == "done" and "digest" not in doc:
            problems.append(f"line {lineno}: done {ticket} missing digest")
        if event in TERMINAL_EVENTS:
            terminal.add(ticket)
    return problems
