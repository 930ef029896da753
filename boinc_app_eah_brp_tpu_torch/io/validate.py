"""Candidate-file comparison: the BOINC validator stand-in.

Counterpart of the reference package's ``io/validate.py``.  The
reference's real test oracle is BOINC's server-side validation: two hosts
(different CPUs, compilers, FFT libraries) run the same workunit and their
candidate files are compared with a physics-level tolerance; exact bit
agreement is impossible across FFT libraries and float contraction modes.
This module implements that comparison for two local candidate files, or
two in-memory candidate lists (``runtime/precision.py`` scores its dtype
lanes with it).

Matching contract:

* candidates are keyed by (frequency bin, n_harm); the sets must agree
  exactly: a missing or extra candidate is a failure, except a weak one
  near the false-alarm threshold (``boundary``);
* template parameters (P_b, tau, Psi) of matching candidates must agree to
  formatting precision (they are copied from the same bank line);
* power and fA agree within a relative/absolute tolerance that absorbs
  FFT-implementation and accumulation-order differences.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .results import QUARANTINE_TAG, parse_quarantine_ranges, parse_result_file


@dataclass
class CandidateDiff:
    """Outcome of comparing two candidate files."""

    matched: int = 0
    missing: list = field(default_factory=list)  # hard: in A, absent from B
    extra: list = field(default_factory=list)  # hard: in B, absent from A
    boundary: list = field(default_factory=list)  # tolerated tail misses
    mismatches: list = field(default_factory=list)  # value deltas beyond tol
    a_done: bool = True
    b_done: bool = True
    # the quarantine gaps of each file: a file that searched fewer
    # templates is not comparable over the gap, so mismatched gap sets
    # are a hard failure
    a_quarantined: list = field(default_factory=list)
    b_quarantined: list = field(default_factory=list)

    @property
    def quarantine_mismatch(self) -> bool:
        return sorted(self.a_quarantined) != sorted(self.b_quarantined)

    @property
    def ok(self) -> bool:
        return (
            not self.missing
            and not self.extra
            and not self.mismatches
            and not self.quarantine_mismatch
            and self.a_done
            and self.b_done
        )

    def report(self) -> str:
        lines = [
            f"matched: {self.matched}",
            f"missing from B: {len(self.missing)}",
            f"extra in B: {len(self.extra)}",
            f"boundary (tolerated near-threshold): {len(self.boundary)}",
            f"value mismatches: {len(self.mismatches)}",
        ]
        for tag, items in (("missing", self.missing), ("extra", self.extra), ("boundary", self.boundary)):
            for key in items[:10]:
                lines.append(f"  {tag}: bin={key[0]} n_harm={key[1]}")
        for key, what, va, vb in self.mismatches[:10]:
            lines.append(f"  mismatch bin={key[0]} n_harm={key[1]} {what}: {va} vs {vb}")
        if not self.a_done:
            lines.append("  file A not %DONE%-terminated")
        if not self.b_done:
            lines.append("  file B not %DONE%-terminated")
        if self.quarantine_mismatch:
            lines.append(f"  quarantine gaps differ: A={self.a_quarantined} B={self.b_quarantined}")
        return "\n".join(lines)


_F0, _PB, _TAU, _PSI, _POWER, _FA, _NHARM = range(7)


def _key(cand, t_obs: float) -> tuple[int, int]:
    """(frequency bin, n_harm): the identity of a candidate.  freq is
    printed as ``f0_bin / t_obs`` (``demod_binary.c:1640-1642``) with 12
    decimal digits, so rounding recovers the bin for any plausible t_obs."""
    return (int(round(cand[_F0] * t_obs)), int(cand[_NHARM]))


def compare_candidate_rows(
    rows_a,
    rows_b,
    t_obs: float,
    power_rtol: float = 1.5e-2,
    fa_atol: float = 0.15,
    param_rtol: float = 1e-9,
    top_k: int = 5,
    tail_margin: float = 0.25,
    diff: CandidateDiff | None = None,
) -> CandidateDiff:
    """Compare two in-memory candidate lists under the validator
    tolerance.  Each row is a 7-column sequence in the result-file column
    order (f0 Hz, P_b, tau, psi, power, fA, n_harm).  The ``top_k``
    strongest candidates (by fA) of each list must match by key; a weaker
    one present in only one list is ``boundary`` if its fA is within
    ``tail_margin`` of that list's weakest, else ``missing``/``extra``.
    ``diff`` lets a caller pre-populate the file-level fields (done flags,
    quarantine gaps)."""
    if diff is None:
        diff = CandidateDiff()

    amap = {_key(c, t_obs): c for c in rows_a}
    bmap = {_key(c, t_obs): c for c in rows_b}

    def classify(only: list, src_map: dict, strict: set) -> tuple[list, list]:
        floor = min((float(c[_FA]) for c in src_map.values()), default=0.0)
        hard, soft = [], []
        for k in only:
            near_tail = float(src_map[k][_FA]) <= floor + tail_margin
            (soft if near_tail and k not in strict else hard).append(k)
        return hard, soft

    def top_keys(m: dict) -> set:
        ranked = sorted(m, key=lambda k: -float(m[k][_FA]))
        return set(ranked[:top_k])

    strict = top_keys(amap) | top_keys(bmap)
    only_a = sorted(k for k in amap if k not in bmap)
    only_b = sorted(k for k in bmap if k not in amap)
    diff.missing, soft_a = classify(only_a, amap, strict)
    diff.extra, soft_b = classify(only_b, bmap, strict)
    diff.boundary = soft_a + soft_b

    for key in sorted(set(amap) & set(bmap)):
        ca, cb = amap[key], bmap[key]
        diff.matched += 1
        for name, col in (("P_b", _PB), ("tau", _TAU), ("psi", _PSI)):
            va, vb = float(ca[col]), float(cb[col])
            if abs(va - vb) > param_rtol * max(1.0, abs(va)):
                diff.mismatches.append((key, name, va, vb))
        pa, pb = float(ca[_POWER]), float(cb[_POWER])
        if abs(pa - pb) > power_rtol * max(abs(pa), abs(pb)):
            diff.mismatches.append((key, "power", pa, pb))
        fa_a, fa_b = float(ca[_FA]), float(cb[_FA])
        if abs(fa_a - fa_b) > fa_atol:
            diff.mismatches.append((key, "fA", fa_a, fa_b))
    return diff


def compare_candidate_files(
    path_a: str,
    path_b: str,
    t_obs: float,
    power_rtol: float = 1.5e-2,
    fa_atol: float = 0.15,
    param_rtol: float = 1e-9,
    top_k: int = 5,
    tail_margin: float = 0.25,
) -> CandidateDiff:
    """Compare two candidate files under the validator tolerance
    (:func:`compare_candidate_rows`), with each file's ``%DONE%`` marker
    and quarantine gaps.  ``t_obs`` is the padded observation time that
    bins output frequencies, of the workunit both files came from."""
    ra = parse_result_file(path_a)
    rb = parse_result_file(path_b)

    def gaps(parsed) -> list:
        for line in parsed.header_lines:
            if line.strip().startswith(QUARANTINE_TAG):
                return parse_quarantine_ranges(line.strip())
        return []

    return compare_candidate_rows(
        ra.lines,
        rb.lines,
        t_obs,
        power_rtol=power_rtol,
        fa_atol=fa_atol,
        param_rtol=param_rtol,
        top_k=top_k,
        tail_margin=tail_margin,
        diff=CandidateDiff(a_done=ra.done, b_done=rb.done, a_quarantined=gaps(ra), b_quarantined=gaps(rb)),
    )
