"""The comparisons that decide ``correct``.

Each judge returns its numbers as ``{name: value}``; :func:`verdict`
holds each against its limit, from the cell's traffic file.  A number is
a widest relative gap or a count, so a sound run reads low: a gap near
rounding, a count of 0.

* The bank-pass cell (:func:`judge_state`): the (M, T) state of every
  whole pass in the window, each bitwise the first's (else every number
  is infinite).  On a sample of templates drawn from the seed the
  reference computes each template's harmonic sums; ``own_gap`` is the
  widest gap between the program's M and the reference's sum of the
  template the program's T names, over the bins whose T is sampled;
  ``beat_gap`` how far a sampled template's sum rises above the
  program's M anywhere (a template the search left out rises above it).
* The workunit cells (:func:`judge_candidates`): one candidate file,
  against the reference's whitening, search and rescoring of the same
  inputs.  ``power_gap`` is the widest gap between a row's power and the
  reference's rescored power of the row's template, harmonic level and
  bin; ``top_gap`` the widest gap between the false-alarm figure (fA) of
  each row the reference writes (its own toplist and output stage,
  ``bmlib/cands.py``) and the file's row at the same frequency bin, 1
  where the file lacks it.  A file that is not whole,
  or names a template the bank lacks, reads infinite in every number.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import cands
from .inputs import Problem
from .reference import Reference, template_params

HARMONICS = (1, 2, 4, 8, 16)


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, value, limit)]): correct when every number is at
    or below its limit; a number without a limit, or one that is not
    finite, fails."""
    rows = []
    ok = True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and np.isfinite(value) and value <= limit
        ok = ok and good
        rows.append((name, float(value), None if limit is None else float(limit)))
    return ok, rows


# -- the program's state layout (phase-major rows; ops/harmonic.py) --------


def to_natural(arr: np.ndarray, fund_hi: int) -> np.ndarray:
    """(5, W) phase-major -> (5, fund_hi): level k holds n_ph = 16 >> k
    phases (1 at level 0) of Q = ceil(fund_hi / n_ph) bins each, bin
    ``q * n_ph + p`` at ``p * Q + q``."""
    out = np.empty((5, fund_hi), dtype=arr.dtype)
    for k in range(5):
        n_ph = 1 if k == 0 else 16 >> k
        q = -(-fund_hi // n_ph)
        out[k] = arr[k, : n_ph * q].reshape(n_ph, q).T.reshape(-1)[:fund_hi]
    return out


def sample_rows(n_bank: int, count: int, seed_rng: np.random.Generator, must=()) -> np.ndarray:
    rows = set(int(r) for r in seed_rng.choice(n_bank, size=min(count, n_bank), replace=False))
    rows.update(int(r) for r in must)
    return np.array(sorted(rows), dtype=np.int64)


def judge_state(states: list, problem: Problem, ref: Reference, rows: np.ndarray, batch: int) -> dict:
    """Numbers of the bank-pass cell.  ``states`` are the passes' (M, T)
    as host arrays in the program's layout."""
    g = problem.geom
    M0, T0 = states[0]
    if any(not (np.array_equal(M, M0) and np.array_equal(T, T0)) for M, T in states[1:]):
        return dict(own_gap=float("inf"), beat_gap=float("inf"))
    return judge_maxima(to_natural(M0, g.fund_hi), to_natural(T0, g.fund_hi), problem, ref, rows, batch)


def judge_maxima(M: np.ndarray, T: np.ndarray, problem: Problem, ref: Reference, rows: np.ndarray, batch: int) -> dict:
    """``own_gap`` and ``beat_gap`` of a state (M, T) in natural bin order
    against the reference's sums of the templates ``rows``."""
    g = problem.geom
    M = torch.from_numpy(np.asarray(M, dtype=np.float32)).to(ref.dev)
    T = torch.from_numpy(np.asarray(T, dtype=np.int64)).to(ref.dev)
    n_bank = len(problem.P)
    if int(T.min()) < 0 or int(T.max()) >= n_bank:
        return dict(own_gap=float("inf"), beat_gap=float("inf"))
    params = template_params(problem.P, problem.tau, problem.psi, g.dt)
    beat = torch.zeros_like(M)
    own = torch.zeros_like(M)
    seen = torch.zeros(M.shape, dtype=torch.bool, device=ref.dev)
    slot = torch.full((n_bank,), -1, dtype=torch.int64, device=ref.dev)

    def visit(chunk, S):
        nonlocal beat, own, seen
        beat = torch.maximum(beat, S.amax(dim=0))
        slot.fill_(-1)
        slot[torch.from_numpy(chunk).to(ref.dev)] = torch.arange(len(chunk), device=ref.dev)
        pos = slot[T]
        hit = pos >= 0
        got = S.gather(0, pos.clamp(min=0)[None]).squeeze(0)
        own = torch.where(hit, got, own)
        seen |= hit

    ref.search(ref.whiten(problem.samples, problem.zap_ranges, problem.config["search"]["padding"]), params, rows,
               batch, visit)
    floor = M.median(dim=1, keepdim=True).values.clamp(min=torch.finfo(torch.float32).tiny)
    den = torch.maximum(M, floor)
    own_gap = torch.where(seen, (M - own).abs() / den, 0.0).max()
    beat_gap = ((beat - M) / den).clamp(min=0.0).max()
    return dict(own_gap=float(own_gap), beat_gap=float(beat_gap))


# -- candidate files --------------------------------------------------------


def _bank_keys(problem: Problem) -> dict:
    keys = {}
    for t, vals in enumerate(zip(problem.P, problem.tau, problem.psi)):
        keys.setdefault(tuple(f"{float(np.float32(v)):6.12f}" for v in vals), t)
    return keys


def candidate_lines(rows: np.ndarray, t_obs: float) -> str:
    """Candidate lines as the C prints them, then ``%DONE%``."""
    out = []
    for r in rows:
        out.append(
            f"{float(r['f0']) / t_obs:6.12f} {float(r['P_b']):6.12f} {float(r['tau']):6.12f} "
            f"{float(r['Psi']):6.12f} {'%g' % float(r['power'])} {'%g' % float(r['fA'])} {int(r['n_harm'])}\n"
        )
    return "".join(out) + "%DONE%\n"


def reference_toplist(ref: Reference, ts: torch.Tensor, problem: Problem, params: np.ndarray,
                      batch: int) -> cands.Toplist:
    """The toplist of the reference's search of the whole bank, filled
    template by template in bank order (:class:`cands.Toplist`)."""
    g = problem.geom
    top = cands.Toplist(cands.thresholds(problem.config["search"]["fA"], g.fft_size))
    w2, L = g.window_2, cands.LEVELS

    def visit(chunk, S):
        # the thresholds only rise, so those at the batch's start let
        # through every bin that any of its templates may keep
        thr = torch.tensor([top.threshold(k) for k in range(L)], dtype=S.dtype, device=S.device)
        tail = S[:, :, w2:]
        mask = tail > thr[None, :, None]
        at = mask.nonzero().cpu().numpy()
        vals = tail[mask].cpu().numpy()
        cut = np.searchsorted(at[:, 0] * L + at[:, 1], np.arange(len(chunk) * L + 1))
        for b, t in enumerate(chunk):
            hits = [(at[cut[b * L + k] : cut[b * L + k + 1], 2] + w2, vals[cut[b * L + k] : cut[b * L + k + 1]])
                    for k in range(L)]
            top.template(int(t), hits)

    ref.search(ts, params, np.arange(len(problem.P)), batch, visit)
    return top


def reference_candidates(ref: Reference, problem: Problem, batch: int) -> str:
    """The candidate file the reference writes for ``problem``: whitening,
    the search, the toplist, the output stage, the rescoring of every
    winning template (each of its entries takes the rescored power) and
    the output stage again."""
    g = problem.geom
    bank = (problem.P, problem.tau, problem.psi)
    ts = ref.whiten(problem.samples, problem.zap_ranges, problem.config["search"]["padding"])
    params = template_params(problem.P, problem.tau, problem.psi, g.dt)
    entries = reference_toplist(ref, ts, problem, params, batch).entries()
    order = sorted({int(t) for t in cands.emit(entries, bank)["t"]})
    pairs = [[(k, f0) for k, _, t, f0 in entries if t == w] for w in order]
    rescored = {(w, k, f0): float(v) for w, want, vals in zip(order, pairs, ref.point_powers(ts, params[order], pairs))
                for (k, f0), v in zip(want, vals)}
    entries = [(k, rescored.get((t, k, f0), power), t, f0) for k, power, t, f0 in entries]
    return candidate_lines(cands.emit(entries, bank), g.t_obs)


def _parse(text: str, t_obs: float):
    rows = cands.parse_candidates(text, t_obs)
    if rows is None:
        return None, None
    keys = [tuple(ln.split()[1:4]) for ln in text.splitlines()[:-1] if ln and not ln.startswith("%")]
    return rows, keys


def judge_candidates(text: str, problem: Problem, ref: Reference, batch: int) -> dict:
    """Numbers of one candidate file of ``problem``."""
    g = problem.geom
    bad = dict(power_gap=float("inf"), top_gap=float("inf"))
    rows, keys = _parse(text, g.t_obs)
    if rows is None:
        return bad
    bank = _bank_keys(problem)
    if any(k not in bank for k in keys) or any(int(n) not in HARMONICS for n in rows["n_harm"]):
        return bad
    if len(rows) and int(rows["f0"].max()) >= g.fund_hi:
        return bad
    t_rows = np.array([bank[k] for k in keys], dtype=np.int64)
    k_rows = np.array([int(n).bit_length() - 1 for n in rows["n_harm"]], dtype=np.int64)
    f_rows = rows["f0"].astype(np.int64)
    s = problem.config["search"]
    ts = ref.whiten(problem.samples, problem.zap_ranges, s["padding"])
    params = template_params(problem.P, problem.tau, problem.psi, g.dt)

    uniq = sorted(set(t_rows.tolist()))
    pairs = [[(int(k_rows[i]), int(f_rows[i])) for i in np.flatnonzero(t_rows == t)] for t in uniq]
    pts = ref.point_powers(ts, params[uniq], pairs)
    want = np.zeros(len(rows), dtype=np.float64)
    for t, vals in zip(uniq, pts):
        for i, v in zip(np.flatnonzero(t_rows == t), vals):
            want[i] = np.float64(np.float32(v)) / math.sqrt(int(rows["n_harm"][i]))
    power_gap = float(np.max(np.abs(rows["power"] - want) / np.maximum(want, 1e-30))) if len(rows) else 0.0

    top = reference_toplist(ref, ts, problem, params, batch)
    ref_rows = cands.emit(top.entries(), (problem.P, problem.tau, problem.psi))
    fa = {int(f): float(a) for f, a in zip(rows["f0"], rows["fA"])}
    top_gap = max((abs(fa[int(r["f0"])] - r["fA"]) / r["fA"] if int(r["f0"]) in fa else 1.0 for r in ref_rows),
                  default=0.0)
    return dict(power_gap=power_gap, top_gap=float(top_gap))
