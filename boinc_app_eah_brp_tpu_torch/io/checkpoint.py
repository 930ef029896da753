"""Checkpoint file read/write, byte-compatible with the reference and with
the JAX package's checkpoints in both directions.

Format (``demod_binary.c:1742-1783`` writer, ``:546-652`` reader):
``CP_Header`` (n_template, originalfile) followed by exactly ``N_CAND`` (500)
packed ``CP_cand`` records: the per-harmonic toplists (5 x 100), each block
sorted descending by power.  Writes go to ``<path>.tmp`` then an atomic
rename.

Audit trail: each write also drops a ``<path>.audit.json`` sidecar
(schema ``erp-checkpoint-audit/1``) holding a SHA-256 of the exact bytes
written, the template counter, the bank identity and the writing run's
process count.  :func:`verify_checkpoint_audit` re-checks them on resume,
so a torn write, a stale file or a different bank raises
:class:`CheckpointError` instead of seeding a wrong toplist.  A missing
sidecar (a checkpoint of the reference itself) is accepted.

Generations: each write first rotates the previous checkpoint to
``<path>.1`` (its sidecar rides along), keeping ``ERP_CKPT_GENERATIONS``
(default 2) resumable generations.  A live checkpoint that fails its own
digest is never rotated over a good backup.
:func:`load_resumable_checkpoint` walks the generations newest first and
resumes from the first that passes every check; :func:`remove_checkpoint`
removes them all once a pass of a task is finished.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass

import numpy as np

from ..runtime import logging as erplog
from .formats import CP_CAND_DTYPE, CP_HEADER_DTYPE, N_CAND

AUDIT_SCHEMA = "erp-checkpoint-audit/1"

ENV_GENERATIONS = "ERP_CKPT_GENERATIONS"
ENV_RESUME_REBALANCE = "ERP_RESUME_REBALANCE"
DEFAULT_GENERATIONS = 2


class CheckpointError(RuntimeError):
    pass


@dataclass
class Checkpoint:
    n_template: int  # templates fully processed so far
    originalfile: str  # input file name recorded at checkpoint time
    candidates: np.ndarray  # CP_CAND_DTYPE[N_CAND]

    def __post_init__(self):
        if self.candidates.dtype != CP_CAND_DTYPE or len(self.candidates) != N_CAND:
            raise CheckpointError("candidates must be CP_cand[500]")


def topology_record(
    process_count: int = 1,
    ranges: list[tuple[int, int]] | None = None,
    quarantined: list[tuple[int, int]] | None = None,
) -> dict:
    """The audit sidecar's record of how many processes wrote the
    checkpoint and, for a multi-process run, a digest of its per-shard
    template ranges (the JAX package's record); a checkpoint of a run with
    another process count is refused on resume unless
    ``ERP_RESUME_REBALANCE=1``.  ``quarantined`` names the template ranges
    the hang doctor skipped (``runtime/watchdog.py``), the same gap record
    as the result header."""
    doc = {"process_count": int(process_count)}
    if ranges is not None:
        doc["n_shards"] = len(ranges)
        layout = json.dumps([[int(a), int(b)] for a, b in ranges])
        doc["layout_sha"] = hashlib.sha256(layout.encode()).hexdigest()
    if quarantined:
        doc["quarantined"] = [[int(a), int(b)] for a, b in quarantined]
    return doc


def _rebalance_allowed() -> bool:
    return os.environ.get(ENV_RESUME_REBALANCE, "").strip().lower() in ("1", "true", "yes", "on")


def audit_path(path: str) -> str:
    return path + ".audit.json"


def generations() -> int:
    """How many checkpoint generations to keep (>= 1)."""
    try:
        n = int(os.environ.get(ENV_GENERATIONS, DEFAULT_GENERATIONS))
    except (TypeError, ValueError):
        n = DEFAULT_GENERATIONS
    return max(1, n)


def generation_path(path: str, gen: int) -> str:
    """On-disk path of generation ``gen`` (0 = the live checkpoint)."""
    return path if gen == 0 else f"{path}.{gen}"


def generation_paths(path: str) -> list[str]:
    return [generation_path(path, g) for g in range(generations())]


def remove_checkpoint(path: str, inputfile: str | None = None) -> bool:
    """Remove every generation of the checkpoint at ``path`` with its
    audit sidecar, as the reference's wrapper unlinks a finished pass's
    checkpoint (``erp_boinc_wrapper.cpp:463-464``); returns whether a file
    went.  With ``inputfile``, only a checkpoint whose newest readable
    generation names that input, so another pass's checkpoint stays."""
    paths = generation_paths(path)
    if inputfile is not None:
        named = None
        for p in paths:
            try:
                named = read_checkpoint(p).originalfile
                break
            except (CheckpointError, OSError):
                continue
        if named != inputfile:
            return False
    removed = False
    for p in paths:
        for f in (p, audit_path(p)):
            try:
                os.remove(f)
                removed = True
            except FileNotFoundError:
                pass
    return removed


def _fsync_dir(path: str) -> None:
    """Best-effort fsync of ``path``'s directory so a just-renamed file
    survives power loss; some filesystems refuse it."""
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def read_checkpoint(path: str) -> Checkpoint:
    with open(path, "rb") as f:
        head_bytes = f.read(CP_HEADER_DTYPE.itemsize)
        if len(head_bytes) != CP_HEADER_DTYPE.itemsize:
            raise CheckpointError(f"Premature end of data header in file: {path}")
        header = np.frombuffer(head_bytes, dtype=CP_HEADER_DTYPE, count=1)[0]
        cand_bytes = f.read(CP_CAND_DTYPE.itemsize * N_CAND)
        if len(cand_bytes) != CP_CAND_DTYPE.itemsize * N_CAND:
            raise CheckpointError(f"Couldn't read all candidates from checkpoint {path}")
        candidates = np.frombuffer(cand_bytes, dtype=CP_CAND_DTYPE, count=N_CAND).copy()
    originalfile = bytes(header["originalfile"]).split(b"\x00", 1)[0].decode("latin-1")
    return Checkpoint(n_template=int(header["n_template"]), originalfile=originalfile, candidates=candidates)


def _file_digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _rotate_generations(path: str) -> None:
    """Shift generation g -> g+1 for every existing generation, oldest
    first so nothing is clobbered; the live checkpoint only when its bytes
    still match its audit digest.  Sidecars ride along with their files,
    each moved before its file: a kill between the two renames leaves the
    newer generation whole without a sidecar (which resume accepts), where
    the file first would leave the older one under a sidecar that is not
    its own and the newer one gone."""
    n = generations()
    if n < 2 or not os.path.exists(path):
        return
    audit = _read_audit(path)
    if audit is not None and audit.get("schema") == AUDIT_SCHEMA:
        try:
            digest = _file_digest(path)
        except OSError as e:
            erplog.warn("Couldn't read checkpoint %s for rotation (%s); keeping previous generation.\n", path, e)
            return
        if digest != audit.get("sha256"):
            erplog.warn(
                "Checkpoint %s fails its audit digest; NOT rotating it over the previous generation.\n", path
            )
            return
    for g in range(n - 1, 0, -1):
        src, dst = generation_path(path, g - 1), generation_path(path, g)
        if not os.path.exists(src):
            continue
        try:
            if os.path.exists(audit_path(src)):
                os.replace(audit_path(src), audit_path(dst))
            elif os.path.exists(audit_path(dst)):
                # src had no sidecar: drop dst's stale one rather than let it
                # claim the wrong file's digest
                os.remove(audit_path(dst))
            os.replace(src, dst)
        except OSError as e:
            erplog.warn("Checkpoint generation rotation %s -> %s failed: %s\n", src, dst, e)
            return


def write_checkpoint(path: str, cp: Checkpoint, bank=None, topology=None) -> None:
    """Durable atomic write: rotate the previous generation aside, write
    ``<path>.tmp`` with fsync, rename (``demod_binary.c:1750-1779``), then
    the audit sidecar (also atomic, after the checkpoint, so a crash
    between the two leaves a stale sidecar that resume detects).

    ``bank``: the template bank's identity for the sidecar, a ``(path,
    n_templates)`` tuple or a dict with those keys.  ``topology``: see
    :func:`topology_record`.  An injected ``ckpt_write`` fault
    (``runtime/faultinject.py``) fires before anything is touched."""
    from ..runtime import faultinject, tracing

    faultinject.fault_point("ckpt_write", path=path, n_template=cp.n_template)
    header = np.zeros((), dtype=CP_HEADER_DTYPE)
    header["n_template"] = cp.n_template
    header["originalfile"] = cp.originalfile.encode("latin-1")
    payload = header.tobytes() + np.ascontiguousarray(cp.candidates).tobytes()
    # the rotation moves gen0's sidecar to gen1: read it first to keep the
    # sidecar's sequence number counting up across the write
    prev_audit = _read_audit(path)
    with tracing.span("ckpt-write", n_template=int(cp.n_template)):
        _rotate_generations(path)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(path)
        _write_audit(path, cp, payload, bank, prev=prev_audit, topology=topology)


def _bank_identity(bank) -> dict | None:
    if bank is None:
        return None
    if isinstance(bank, dict):
        return {"path": bank.get("path"), "n_templates": bank.get("n_templates")}
    b_path, n = bank
    return {"path": os.path.basename(str(b_path)) if b_path else None, "n_templates": int(n)}


def _read_audit(path: str) -> dict | None:
    """The sidecar of checkpoint ``path``, or None when absent or unreadable."""
    try:
        with open(audit_path(path), "r", encoding="utf-8") as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def _write_audit(path: str, cp: Checkpoint, payload: bytes, bank, prev=None, topology=None) -> None:
    """Best-effort sidecar write: a failure logs and returns, never losing
    the checkpoint that is already in place.  ``prev`` is the audit doc
    from before the rotation, for the sequence number."""
    seq = 0
    if prev is not None:
        try:
            seq = int(prev.get("seq", -1)) + 1
        except (TypeError, ValueError):
            seq = 0
        try:
            prev_n = int(prev.get("n_template"))
        except (TypeError, ValueError):
            prev_n = None
        if prev_n is not None and cp.n_template < prev_n:
            erplog.debug(
                "Checkpoint counter moved backwards (%d -> %d): restarted run overwriting an older checkpoint.\n",
                prev_n, cp.n_template,
            )
    doc = {
        "schema": AUDIT_SCHEMA,
        "sha256": hashlib.sha256(payload).hexdigest(),
        "n_bytes": len(payload),
        "n_template": int(cp.n_template),
        "originalfile": cp.originalfile,
        "bank": _bank_identity(bank),
        "written_unix": time.time(),
        "seq": seq,
    }
    if topology is not None:
        doc["topology"] = topology
    apath = audit_path(path)
    try:
        tmp = apath + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, apath)
    except OSError as e:
        erplog.warn("Couldn't write checkpoint audit sidecar %s: %s\n", apath, e)


def verify_checkpoint_audit(
    path: str,
    cp: Checkpoint,
    template_total: int | None = None,
    bank_path: str | None = None,
    process_count: int | None = None,
) -> dict | None:
    """Cross-check a just-read checkpoint against its audit sidecar.

    Raises :class:`CheckpointError` on a digest mismatch, an
    ``n_template`` that disagrees with the header, a different bank (size
    or file name), or another process count (unless
    ``ERP_RESUME_REBALANCE=1``: a partial toplist reseeds as virtual
    templates whatever topology wrote it).  A missing sidecar passes.
    Returns the audit doc or None."""
    audit = _read_audit(path)
    if audit is None or audit.get("schema") != AUDIT_SCHEMA:
        erplog.debug("No audit sidecar for checkpoint %s; skipping integrity verification.\n", path)
        return None
    digest = _file_digest(path)
    if digest != audit.get("sha256"):
        raise CheckpointError(
            f"Checkpoint {path} does not match its audit record: content digest {digest[:16]}... != "
            f"recorded {str(audit.get('sha256'))[:16]}... (corrupted checkpoint or stale sidecar; "
            f"delete both to restart from scratch)."
        )
    try:
        audit_n = int(audit.get("n_template"))
    except (TypeError, ValueError):
        audit_n = None
    if audit_n is not None and audit_n != cp.n_template:
        raise CheckpointError(
            f"Checkpoint {path} header says {cp.n_template} templates done but its audit record says "
            f"{audit_n}: stale or mixed-up checkpoint files."
        )
    bank = audit.get("bank")
    if isinstance(bank, dict):
        if (
            template_total is not None
            and bank.get("n_templates") is not None
            and int(bank["n_templates"]) != int(template_total)
        ):
            raise CheckpointError(
                f"Checkpoint {path} was written against a template bank of {bank['n_templates']} "
                f"templates but the current bank has {template_total}: resuming would mis-index the bank."
            )
        if bank_path is not None and bank.get("path") and os.path.basename(bank_path) != bank["path"]:
            raise CheckpointError(
                f"Checkpoint {path} was written against template bank {bank['path']!r} but this run "
                f"uses {os.path.basename(bank_path)!r}."
            )
    topo = audit.get("topology")
    if process_count is not None and isinstance(topo, dict):
        try:
            cp_procs = int(topo.get("process_count"))
        except (TypeError, ValueError):
            cp_procs = None
        if cp_procs is not None and cp_procs != int(process_count):
            if not _rebalance_allowed():
                raise CheckpointError(
                    f"Checkpoint {path} was written by a {cp_procs}-process run but this run has "
                    f"{process_count} processes: the shard layout changed. Set "
                    f"{ENV_RESUME_REBALANCE}=1 to rebalance the resumed toplist across the new "
                    f"topology explicitly."
                )
            erplog.warn(
                "Rebalancing resume: checkpoint %s was written by a %d-process run, resuming across "
                "%d processes (%s=1).\n",
                path, cp_procs, int(process_count), ENV_RESUME_REBALANCE,
            )
    erplog.debug(
        "Checkpoint audit verified: %s (seq %s, %d templates done).\n", path, audit.get("seq"), cp.n_template
    )
    return audit


def validate_resume(cp: Checkpoint, template_total: int, inputfile: str) -> None:
    """Consistency checks on resume (``demod_binary.c:574-593``), plus a
    refusal of non-finite candidate powers, which would carry NaN or inf
    into every later merge."""
    if cp.n_template > template_total:
        raise CheckpointError(
            f"Header checkpoint file contains inconsistent information about number of templates "
            f"done ({cp.n_template} > {template_total})."
        )
    if cp.originalfile != inputfile:
        raise CheckpointError(
            f"Input file on command line {inputfile} doesn't agree with input file "
            f"{cp.originalfile} from checkpoint header."
        )
    bad = ~np.isfinite(cp.candidates["power"])
    if bad.any():
        raise CheckpointError(
            f"Checkpoint contains {int(bad.sum())} non-finite candidate powers (first at slot "
            f"{int(np.argmax(bad))}): refusing to resume from a numerically corrupted toplist."
        )


def load_resumable_checkpoint(
    path: str,
    template_total: int,
    inputfile: str,
    bank_path: str | None = None,
    process_count: int | None = None,
):
    """The newest checkpoint generation that passes every resume check
    (read, :func:`validate_resume`, :func:`verify_checkpoint_audit`), as
    ``(cp, used_path, generation)``; None when no generation exists (a
    fresh start).  A rejected generation falls through to the older one;
    raises the last rejection when every existing generation is bad."""
    last_err: Exception | None = None
    for gen, gpath in enumerate(generation_paths(path)):
        if not os.path.exists(gpath):
            continue
        try:
            cp = read_checkpoint(gpath)
            validate_resume(cp, template_total, inputfile)
            verify_checkpoint_audit(
                gpath, cp, template_total=template_total, bank_path=bank_path, process_count=process_count
            )
        except (CheckpointError, OSError) as e:
            last_err = e
            erplog.warn("Checkpoint generation %d (%s) rejected on resume: %s\n", gen, gpath, e)
            continue
        if gen > 0:
            erplog.warn(
                "Resuming from previous checkpoint generation %d (%s, %d templates done) after "
                "rejecting the newer one(s).\n",
                gen, gpath, cp.n_template,
            )
        return cp, gpath, gen
    if last_err is not None:
        raise last_err
    return None
