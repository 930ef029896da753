"""The root cause of every candidate that is in one of two candidate
files only: the JAX package's ``tools/boundary_analysis.py``.

The golden diff (``tools/golden_ref.py``) tolerates a weak candidate near
the false-alarm threshold that is in one file only as "boundary"
(``io/validate.py``) without saying why the other side dropped it.  The
output stage emits at most 100 candidates, sorted by (fA, power, f0),
with a cross-harmonic frequency dedup (``demod_binary.c:1630-1671``), so
such a candidate has one of three causes:

* ``cap-cutoff``: the other file ranks it below its weakest emitted
  candidate, so the 100-slot cap cut it there: an ordering effect of
  sub-tolerance power differences;
* ``dedup``: the other file emitted a same-bin candidate at another
  n_harm with a higher fA first, and the frequency dedup suppressed this
  one;
* ``threshold``: neither; the candidate never crossed the fA threshold in
  the other run (a power-level disagreement).  The tool exits 1 on any.

The dictionaries and the side names (``ref-only``, ``tpu-only``; the
``tpu`` side is the program under test) are the JAX tool's, so the two
tools' JSON documents compare key for key.  ``t_obs`` comes from the
workunit both runs read (``golden_ref.padded_t_obs``).

Usage:
    python -m boinc_app_eah_brp_tpu_torch.tools.boundary_analysis --wu WU \\
        --ref REF.cand --tpu PORT.cand [--ref-cpt REF.cpt] [--tpu-cpt PORT.cpt] [--json OUT]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..io.results import parse_result_file
from ..io.validate import _FA, _PB, _POWER, _PSI, _TAU, _key, compare_candidate_files
from .golden_ref import padded_t_obs


def _by_key(lines, t_obs):
    return {_key(c, t_obs): c for c in lines}


def _floor_fa(cmap) -> float:
    return min((float(c[_FA]) for c in cmap.values()), default=0.0)


def _toplist_fa(cpt_path, key):
    """The other side's own view of ``key``: its (bin, n_harm) looked up
    in that run's 500-entry checkpoint toplist (the raw power survives
    there when the 100-candidate cap drops the candidate from the output
    file), with the fA the output stage would have given it
    (``oracle/toplist.py``)."""
    if not cpt_path or not os.path.exists(cpt_path):
        return None
    import numpy as np

    from ..io.checkpoint import read_checkpoint
    from ..oracle.stats import chisq_Q

    cands = read_checkpoint(cpt_path).candidates
    bin_idx, n_harm = key
    sel = (cands["f0"] == bin_idx) & (cands["n_harm"] == n_harm)
    if not sel.any():
        return None
    row = cands[sel][0]
    power = float(row["power"])
    q = float(chisq_Q(2.0 * power, 2 * n_harm))
    fa = -np.log10(q) if q > 0.0 else 320.0
    return {
        "raw_power": power,
        "fA": float(fa),
        "template": (float(row["P_b"]), float(row["tau"]), float(row["Psi"])),
    }


def classify_boundary(key, here, other, t_obs, other_cpt=None):
    """Why is ``key`` (present in ``here``) absent from ``other``?"""
    cand = here[key]
    fa = float(cand[_FA])
    bin_idx = key[0]
    # cross-harmonic dedup: an emitted same-bin candidate in `other` with
    # another n_harm and an fA at least this one's suppresses this key
    for k, c in other.items():
        if k[0] == bin_idx and k != key and float(c[_FA]) >= fa:
            return {
                "cause": "dedup",
                "detail": (
                    f"other file emitted bin {bin_idx} as n_harm={k[1]} "
                    f"with fA={float(c[_FA]):.4f} >= {fa:.4f}; the "
                    "cross-harmonic frequency dedup keeps only the first"
                ),
            }
    # cap cutoff: the other side emitted a full 100 and its weakest
    # outranks this one, judged by the fA the other side computed for this
    # key (its checkpoint toplist): the two runs' powers differ in the last
    # bits, which is what reorders the dense near-threshold tail
    other_floor = _floor_fa(other)
    own_view = _toplist_fa(other_cpt, key)
    if own_view is not None:
        # per-bin maxima keep the best template: near-equal templates can
        # swap the win on sub-tolerance power differences, which moves the
        # bin's power by the gap between the templates
        tpl_here = (float(cand[_PB]), float(cand[_TAU]), float(cand[_PSI]))
        same_tpl = all(abs(a - b) <= 1e-6 * max(1.0, abs(a)) for a, b in zip(tpl_here, own_view["template"]))
        own_view["winner"] = (
            "same template"
            if same_tpl
            else (
                f"DIFFERENT template won there "
                f"(here P_b={tpl_here[0]:.6g} tau={tpl_here[1]:.6g}, "
                f"there P_b={own_view['template'][0]:.6g} "
                f"tau={own_view['template'][1]:.6g})"
            )
        )
    if own_view is not None and len(other) >= 100 and own_view["fA"] <= other_floor:
        return {
            "cause": "cap-cutoff",
            "other_side_fA": own_view["fA"],
            "other_side_raw_power": own_view["raw_power"],
            "other_side_winner": own_view["winner"],
            "detail": (
                f"the other run computed fA={own_view['fA']:.4f} for "
                f"this bin (raw power {own_view['raw_power']:.4f}, "
                f"{own_view['winner']}), below its own 100-candidate "
                f"floor fA={other_floor:.4f} — the cap cut it there; "
                f"here it scored fA={fa:.4f}, just above ours. A pure "
                "ordering flip among near-equal tail candidates."
            ),
        }
    if len(other) >= 100 and fa <= other_floor:
        return {
            "cause": "cap-cutoff",
            "detail": (
                f"other file's 100-candidate floor is fA={other_floor:.4f}; "
                f"this candidate's fA={fa:.4f} ranks below it — the cap "
                "cut it, i.e. a pure ordering flip among near-equal tail "
                "candidates"
            ),
        }
    if own_view is not None:
        return {
            "cause": "threshold",
            "other_side_fA": own_view["fA"],
            "other_side_raw_power": own_view["raw_power"],
            "detail": (
                f"fA={fa:.4f} here vs {own_view['fA']:.4f} in the other "
                f"run's toplist (floor {other_floor:.4f}, {len(other)} "
                "emitted) — a power-level disagreement beyond selection "
                "order"
            ),
        }
    return {
        "cause": "threshold",
        "detail": (
            f"fA={fa:.4f} vs other floor {other_floor:.4f} with "
            f"{len(other)} emitted — not explained by cap or dedup "
            "(no checkpoint available for the other side's own view)"
        ),
    }


def analyse(ref: str, port: str, ref_cpt: str | None, port_cpt: str | None, t_obs: float) -> dict:
    """Every boundary candidate of the diff of ``ref`` against ``port``
    with its cause (each checkpoint from the same run as its candidate
    file): the JAX tool's document, ``boundary`` and ``summary`` included."""
    diff = compare_candidate_files(ref, port, t_obs=t_obs)
    ra = _by_key(parse_result_file(ref).lines, t_obs)
    rb = _by_key(parse_result_file(port).lines, t_obs)
    out = {
        "ref": ref,
        "tpu": port,
        "matched": diff.matched,
        "missing": len(diff.missing),
        "extra": len(diff.extra),
        "mismatches": len(diff.mismatches),
        "boundary": [],
    }
    for key in diff.boundary:
        if key in ra:
            side, here, other, other_cpt = "ref-only", ra, rb, port_cpt
        else:
            side, here, other, other_cpt = "tpu-only", rb, ra, ref_cpt
        cand = here[key]
        out["boundary"].append({
            "bin": key[0],
            "n_harm": key[1],
            "side": side,
            "fA": float(cand[_FA]),
            "power": float(cand[_POWER]),
            "own_floor_fA": _floor_fa(here),
            "other_floor_fA": _floor_fa(other),
            **classify_boundary(key, here, other, t_obs, other_cpt=other_cpt),
        })
    causes = sorted({e["cause"] for e in out["boundary"]})
    out["summary"] = f"{len(out['boundary'])} boundary candidates, causes: " + (", ".join(causes) if causes else "none")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Give the root cause of every boundary candidate of a golden diff.")
    ap.add_argument("--wu", required=True, help="the workunit both runs searched (its padded t_obs bins the rows)")
    ap.add_argument("--ref", required=True, help="the reference run's candidate file")
    # each checkpoint must come from the same run as its candidate file:
    # the other side's own view reads the checkpoint toplist of that run
    ap.add_argument("--tpu", required=True, help="the program's candidate file")
    ap.add_argument("--ref-cpt", default=None, help="the reference run's checkpoint (its 500-entry toplist)")
    ap.add_argument("--tpu-cpt", default=None, help="the program's checkpoint, of the same run as --tpu")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    out = analyse(args.ref, args.tpu, args.ref_cpt, args.tpu_cpt, padded_t_obs(args.wu))
    for e in out["boundary"]:
        print(f"{e['side']} bin={e['bin']} n_harm={e['n_harm']} fA={e['fA']:.4f} -> {e['cause']}: {e['detail']}")
    print(out["summary"])
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        print(f"wrote {args.json}")
    # a threshold cause is a power-level disagreement, not a selection-order effect
    return 1 if any(e["cause"] == "threshold" for e in out["boundary"]) else 0


if __name__ == "__main__":
    sys.exit(main())
