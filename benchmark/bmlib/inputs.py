"""The benchmark's inputs, made from ``--seed``: a PALFA-class workunit,
the orbital template bank and the zaplist, as arrays and as the files the
command line reads.

One configuration file (``configs/<name>.json``) fixes the deployment:
sample count and time, bank size, search flags, zap ranges and the
synthetic data's parameters.  :func:`make_problem` draws everything a cell
needs from one seed, so the same seed gives the same inputs, and every
seed gives the same sizes.  Both sides of the comparison get these inputs:
the program through the files (or, for the bank-pass cell, the arrays),
the reference through the arrays.
"""

from __future__ import annotations

import dataclasses
import gzip
import math
import os

import numpy as np

# struct dd_header (structs.h:74-107): 15 doubles, then the integer and
# string tail; 1168 bytes, little-endian
_DD_DOUBLES = (
    "tsample", "tobs", "timestamp", "fcenter", "fchan", "RA", "DEC", "gal_l", "gal_b",
    "AZstart", "ZAstart", "ASTstart", "LSTstart", "DM", "scale",
)
DD_HEADER_DTYPE = np.dtype(
    [(n, "<f8") for n in _DD_DOUBLES]
    + [("filesize", "<u4"), ("datasize", "<u4"), ("nsamples", "<u4"), ("smprec", "<u2"), ("nchan", "<u2"),
       ("nifs", "<u2"), ("lagformat", "<u2"), ("sum", "<u2"), ("level", "<u2"), ("name", "S256"),
       ("originalfile", "S256"), ("proj_id", "S256"), ("observers", "S256")]
)
assert DD_HEADER_DTYPE.itemsize == 1168


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The search geometry of ``demod_binary.c:782,1087-1099``."""

    n_unpadded: int
    nsamples: int
    fft_size: int
    window: int
    window_2: int
    fund_hi: int
    harm_hi: int
    dt: float
    t_obs: float

    @classmethod
    def derive(cls, n_unpadded: int, tsample_us: float, f0: float, padding: float, window: int) -> "Geometry":
        nsamples = int(padding * n_unpadded + 0.5)
        if nsamples % 2:
            raise ValueError("padded nsamples must be even")
        dt = tsample_us * 1.0e-6
        t_obs = nsamples * dt
        fft_size = nsamples // 2 + 1
        window_2 = int(window * 0.5 + 0.5)
        return cls(
            n_unpadded=n_unpadded, nsamples=nsamples, fft_size=fft_size, window=window, window_2=window_2,
            fund_hi=min(fft_size - window_2, int(f0 * t_obs + 0.5)),
            harm_hi=min(fft_size - window_2, int(16.0 * f0 * t_obs + 0.5)),
            dt=dt, t_obs=t_obs,
        )


@dataclasses.dataclass(frozen=True)
class Problem:
    """One workunit of a cell: its 4-bit sample values (float32), the bank
    (float64 arrays, as parsed back from the bank file's text), the zap
    ranges (Hz) and the geometry; ``inject`` is the bank row whose orbit
    the injected pulsar follows."""

    samples: np.ndarray
    P: np.ndarray
    tau: np.ndarray
    psi: np.ndarray
    zap_ranges: np.ndarray
    geom: Geometry
    inject: int
    config: dict


def geometry(config: dict) -> Geometry:
    s = config["search"]
    return Geometry.derive(config["samples"], config["tsample_us"], s["f0"], s["padding"], s["window"])


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """The generator of ``seed``'s stream ``stream``: any whole number,
    negative or above 64 bits included, maps to a fixed SeedSequence."""
    return np.random.default_rng(np.random.SeedSequence([seed % (1 << 64), (seed >> 64) % (1 << 64), *stream]))


def _text_round(x: np.ndarray) -> np.ndarray:
    """``x`` as the bank file's ``%.12f`` text parses back."""
    return np.array([float(f"{v:.12f}") for v in x], dtype=np.float64)


DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def read_bank(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A bank file's ``P tau psi0`` lines as float64 arrays."""
    a = np.loadtxt(path, dtype=np.float64, ndmin=2)
    return a[:, 0].copy(), a[:, 1].copy(), a[:, 2].copy()


def make_bank(config: dict, seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The configuration's bank: its ``file`` under ``data/`` where it
    names one (the same for every seed), else the seeded synthetic bank:
    row 0 the null template (1000, 0, 0), then P, tau and psi uniform in
    the configuration's ranges; the configuration's ``templates`` rows
    of one draw of ``bank_draw`` rows, so a cut bank is the first rows of
    the full one."""
    b = config["bank"]
    if "file" in b:
        P, tau, psi = read_bank(os.path.join(DATA, b["file"]))
        m = config["templates"]
        if len(P) != m:
            raise ValueError(f"{b['file']} holds {len(P)} templates, the configuration {m}")
        return P, tau, psi
    rng = rng_for(seed, 0)
    n = b["bank_draw"] - 1
    P = np.concatenate([[1000.0], rng.uniform(*b["P_s"], n)])
    tau = np.concatenate([[0.0], rng.uniform(*b["tau_s"], n)])
    # below 2 pi by a margin, so the %.12f text never rounds up to it
    psi = np.concatenate([[0.0], rng.uniform(0.0, 2 * math.pi - 1e-9, n)])
    m = config["templates"]
    return _text_round(P[:m]), _text_round(tau[:m]), _text_round(psi[:m])


def pulsed_samples(config: dict, rng: np.random.Generator, orbit: tuple[float, float, float]) -> np.ndarray:
    """4-bit sample values: normal noise plus a pulse train at the
    configuration's frequency whose arrival times follow ``orbit`` (P,
    tau, psi0), rounded and clipped to 0..15."""
    d = config["data"]
    n = config["samples"]
    dt = config["tsample_us"] * 1e-6
    P, tau, psi0 = orbit
    i = np.arange(n, dtype=np.float64)
    del_t = (tau * np.sin(2 * np.pi / P * i * dt + psi0) - tau * np.sin(psi0)) / dt
    t_pulsar = np.interp(i, i - del_t, i) * dt
    x = rng.normal(d["noise_mean"], d["noise_sd"], n)
    x += d["pulse_amp"] * (np.cos(2 * np.pi * d["pulse_hz"] * t_pulsar) > d["pulse_cos_above"])
    return np.clip(np.round(x), 0, 15).astype(np.float32)


def make_problem(config: dict, seed: int, index: int = 0) -> Problem:
    """Workunit ``index`` of ``seed`` under ``config``: the bank is the
    seed's; the samples and the injected row are the workunit's own."""
    P, tau, psi = make_bank(config, seed)
    rng = rng_for(seed, 1, index)
    inject = int(rng.integers(1, len(P)))
    samples = pulsed_samples(config, rng, (P[inject], tau[inject], psi[inject]))
    return Problem(
        samples=samples, P=P, tau=tau, psi=psi,
        zap_ranges=np.asarray(config["search"]["zap_ranges"], dtype=np.float64).reshape(-1, 2),
        geom=geometry(config), inject=inject, config=config,
    )


def write_workunit(path: str, samples: np.ndarray, tsample_us: float) -> None:
    """A gzip ``.bin4`` workunit: the packed header, then the samples as
    nibble pairs, high nibble first, scale 1."""
    q = np.asarray(samples).astype(np.uint8)
    if q.size % 2:
        raise ValueError("4-bit payload needs an even number of samples")
    header = np.zeros((), dtype=DD_HEADER_DTYPE)
    header["tsample"] = tsample_us
    header["tobs"] = q.size * tsample_us * 1.0e-6
    header["nsamples"] = q.size
    header["scale"] = 1.0
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(header.tobytes())
        f.write(((q[0::2] << 4) | q[1::2]).tobytes())


def write_bank(path: str, P, tau, psi) -> None:
    with open(path, "w") as f:
        f.writelines(f"{p:.12f} {t:.12f} {s:.12f}\n" for p, t, s in zip(P, tau, psi))


def write_zaplist(path: str, zap_ranges) -> None:
    with open(path, "w") as f:
        f.writelines(f"{float(lo)!r} {float(hi)!r}\n" for lo, hi in zap_ranges)


def write_inputs(problem: Problem, directory: str, name: str) -> dict:
    """The problem's workunit, bank and zaplist in ``directory``; returns
    their paths (``wu``, ``bank``, ``zap``)."""
    os.makedirs(directory, exist_ok=True)
    paths = {
        "wu": os.path.join(directory, f"{name}.bin4"),
        "bank": os.path.join(directory, "bank.txt"),
        "zap": os.path.join(directory, "zaplist.txt"),
    }
    write_workunit(paths["wu"], problem.samples, problem.config["tsample_us"])
    write_bank(paths["bank"], problem.P, problem.tau, problem.psi)
    write_zaplist(paths["zap"], problem.zap_ranges)
    return paths
