"""Candidate result file writer/parser.

The candidate file is the validation surface of the whole search — BOINC's
server-side validator compares these files across hosts. Format
(``demod_binary.c:1557-1685``):

* optional provenance header of ``%``-prefixed lines:
  ``% User: <id> (<name>)`` / ``% Host:`` / ``% Date:`` / ``% Exec:`` /
  ``% ERP git id:`` / ``% BOINC rev.:`` followed by a blank line
  (``demod_binary.c:1616``)
* up to 100 candidate lines, printf ``"%6.12f %6.12f %6.12f %6.12f %g %g %d"``:
  ``freq  P_b  tau  Psi  power  fA  n_harm`` where ``freq = f0_bin / t_obs``
  (``demod_binary.c:1640-1642``)
* terminated by ``%DONE%``                    (``demod_binary.c:1667``)

Writes go to ``<path>.tmp`` then an atomic rename (``demod_binary.c:1680``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np

from .formats import CP_CAND_DTYPE

TIME_FORMAT = "%Y-%m-%dT%H:%M:%S+00:00"  # demod_binary.c:85


@dataclass
class ResultHeader:
    user_id: int = 0
    user_name: str | None = None
    host_id: int = 0
    host_cpid: str | None = None
    exec_name: str = "unknown"
    erp_git_version: str = "unknown"
    boinc_rev: str = "unknown"
    date_iso: str | None = None  # defaults to now (UTC)
    # template ranges skipped by the hang doctor's poison-range
    # quarantine (runtime/watchdog.py): a validator comparing this file
    # against another host's must know the gap is NAMED, not silent
    quarantined: list[tuple[int, int]] = field(default_factory=list)

    def render(self) -> str:
        date = self.date_iso
        if date is None:
            # ERP_RESULT_DATE pins the header timestamp so harnesses (the
            # chaos soak, replay tests) can compare result files by byte
            date = os.environ.get("ERP_RESULT_DATE")
        if date is None:
            date = time.strftime(TIME_FORMAT, time.gmtime())
        quarantine_line = ""
        if self.quarantined:
            ranges = ", ".join(f"[{a}, {b})" for a, b in self.quarantined)
            quarantine_line = f"% Quarantined templates: {ranges}\n"
        return (
            f"% User: {self.user_id} ({self.user_name or 'unknown'})\n"
            f"% Host: {self.host_id} ({self.host_cpid or 'unknown'})\n"
            f"% Date: {date}\n"
            f"% Exec: {self.exec_name}\n"
            f"% ERP git id: {self.erp_git_version}\n"
            f"% BOINC rev.: {self.boinc_rev}\n"
            f"{quarantine_line}\n"
        )


@dataclass
class ResultFile:
    candidates: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=CP_CAND_DTYPE)
    )  # CP_CAND_DTYPE records in output order; ``power`` already sigma-scaled
    t_obs: float = 1.0  # padded observation time (s): freq = f0 / t_obs
    header: ResultHeader | None = None
    done: bool = True


def format_candidate_line(cand: np.void, t_obs: float) -> str:
    """One candidate line, exactly printf'd as the reference does."""
    res_factor = 1.0 / t_obs
    freq = float(cand["f0"]) * res_factor
    return (
        f"{freq:6.12f} {float(cand['P_b']):6.12f} {float(cand['tau']):6.12f} "
        f"{float(cand['Psi']):6.12f} {'%g' % float(cand['power'])} "
        f"{'%g' % float(cand['fA'])} {int(cand['n_harm'])}\n"
    )


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync so the rename itself is durable."""
    d = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_result_file(path: str, result: ResultFile) -> None:
    """Durable atomic write (tmp + fsync + rename): the result file is
    what the BOINC validator judges, so a kill mid-write must leave
    either the old file or the complete new one — never a truncation.
    An injected ``result_write`` fault (``runtime/faultinject.py``) fires
    before anything is written."""
    from ..runtime import faultinject

    faultinject.fault_point("result_write", path=path)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        if result.header is not None:
            f.write(result.header.render())
        for cand in result.candidates:
            f.write(format_candidate_line(cand, result.t_obs))
        f.write("%DONE%\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path)


@dataclass
class ParsedResult:
    lines: np.ndarray  # float64[n, 7]: freq P_b tau Psi power fA n_harm
    done: bool
    header_lines: list[str]


def split_result_sections(text: str) -> tuple[list[str], list[str], bool]:
    """Split a candidate file into ``(header_lines, candidate_lines,
    done)`` without interpreting either section.  ``header_lines`` are the
    ``%``-prefixed provenance lines plus blanks (newline-stripped);
    ``candidate_lines`` keep their exact bytes minus the newline — this is
    what the quorum validator's bitwise tier compares.  Anything after the
    ``%DONE%`` marker is ignored (demod_binary.c:1667)."""
    header_lines: list[str] = []
    candidate_lines: list[str] = []
    done = False
    for line in text.splitlines():
        stripped = line.strip()
        if stripped == "%DONE%":
            done = True
            break
        if stripped.startswith("%") or not stripped:
            header_lines.append(line)
        else:
            candidate_lines.append(line)
    return header_lines, candidate_lines, done


def parse_result_file(path: str) -> ParsedResult:
    with open(path, "r") as f:
        header_lines, candidate_lines, done = split_result_sections(f.read())
    rows = [[float(v) for v in line.split()] for line in candidate_lines]
    arr = np.asarray(rows, dtype=np.float64).reshape(-1, 7)
    return ParsedResult(lines=arr, done=done, header_lines=header_lines)


_HEADER_FIELDS = {
    # "% Tag:" -> (ResultHeader id attr, name attr) for the two-part lines
    "User": ("user_id", "user_name"),
    "Host": ("host_id", "host_cpid"),
}

QUARANTINE_TAG = "% Quarantined templates:"


def parse_quarantine_ranges(line: str) -> list[tuple[int, int]]:
    """``[a, b), [c, d)`` range list of a quarantine provenance line."""
    body = line.split(":", 1)[1]
    ranges = []
    for part in body.split(","):
        part = part.strip().lstrip("[").rstrip(")")
        if not part:
            continue
        ranges.append(int(part))
    it = iter(ranges)
    return list(zip(it, it))


def parse_result(path: str, t_obs: float = 1.0) -> ResultFile:
    """Parse a candidate file back into the :class:`ResultFile` that wrote
    it — the round-trip API: ``write_result_file(p, r)`` followed by
    ``parse_result(p, r.t_obs)`` reproduces the candidate records, the
    provenance header (quarantine gaps included) and the ``done`` flag,
    and re-writing the parsed object reproduces the file byte-for-byte
    (the printf formats round-trip: re-rendering the parsed float64
    fields emits the same decimal strings).

    ``t_obs`` must be the padded observation time the writer used —
    frequency bins are reconstructed as ``f0 = round(freq * t_obs)``
    (demod_binary.c:1640-1642).  With the 1.0 default the ``f0`` field
    holds rounded frequencies in Hz, which is fine for header inspection
    but NOT for bin-exact comparison."""
    with open(path, "r") as f:
        text = f.read()
    header_lines, candidate_lines, done = split_result_sections(text)

    header = None
    if any(line.strip() for line in header_lines):
        header = ResultHeader()
        for line in header_lines:
            stripped = line.strip()
            if stripped.startswith(QUARANTINE_TAG):
                header.quarantined = parse_quarantine_ranges(stripped)
                continue
            if not stripped.startswith("%") or ":" not in stripped:
                continue
            tag, _, value = stripped.lstrip("%").strip().partition(":")
            tag, value = tag.strip(), value.strip()
            if tag in _HEADER_FIELDS:
                id_attr, name_attr = _HEADER_FIELDS[tag]
                ident, _, name = value.partition("(")
                try:
                    setattr(header, id_attr, int(ident.strip()))
                except ValueError:
                    pass
                name = name.rstrip(")").strip()
                setattr(header, name_attr, name if name != "unknown" else None)
            elif tag == "Date":
                header.date_iso = value
            elif tag == "Exec":
                header.exec_name = value
            elif tag == "ERP git id":
                header.erp_git_version = value
            elif tag == "BOINC rev.":
                header.boinc_rev = value

    cands = np.zeros(len(candidate_lines), dtype=CP_CAND_DTYPE)
    for i, line in enumerate(candidate_lines):
        vals = line.split()
        if len(vals) != 7:
            raise ValueError(
                f"{path}: candidate line {i} has {len(vals)} fields, not 7"
            )
        freq, P_b, tau, Psi, power, fA, n_harm = vals
        cands[i]["f0"] = int(round(float(freq) * t_obs))
        cands[i]["P_b"] = float(P_b)
        cands[i]["tau"] = float(tau)
        cands[i]["Psi"] = float(Psi)
        cands[i]["power"] = float(power)
        cands[i]["fA"] = float(fA)
        cands[i]["n_harm"] = int(n_harm)
    return ResultFile(candidates=cands, t_obs=t_obs, header=header, done=done)
