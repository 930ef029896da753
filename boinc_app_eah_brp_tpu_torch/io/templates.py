"""Orbital template bank parser.

A template bank is a text file with one template per line:
``P_orb tau Psi0`` (three floats, scanned with ``"%lg %lg %lg\\n"``,
``demod_binary.c:197,507-535``). The reference parses the whole file once just
to count and validate it, then re-reads it a template at a time; we parse once
and keep the bank in memory — the search consumes it in batches.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class TemplateBankError(ValueError):
    pass


@dataclass
class TemplateBank:
    """Parsed template bank.

    ``P``, ``tau``, ``psi0`` keep the file's double precision; the reference
    casts each to ``float`` on use (``demod_binary.c:1208-1210``) — consumers
    should go through :meth:`as_float32` for the compute path.
    """

    P: np.ndarray  # float64[n] orbital period (s)
    tau: np.ndarray  # float64[n] projected orbital radius (light seconds)
    psi0: np.ndarray  # float64[n] initial orbital phase (rad)

    def __len__(self) -> int:
        return len(self.P)

    def as_float32(self):
        return (
            self.P.astype(np.float32),
            self.tau.astype(np.float32),
            self.psi0.astype(np.float32),
        )

    def slice(self, start: int, stop: int) -> "TemplateBank":
        return TemplateBank(
            self.P[start:stop], self.tau[start:stop], self.psi0[start:stop]
        )


def read_template_bank(path: str) -> TemplateBank:
    P, tau, psi0 = [], [], []
    with open(path, "r") as f:
        for lineno, line in enumerate(f, 1):
            parts = line.split()
            if len(parts) != 3:
                raise TemplateBankError(
                    f"Line {lineno} in templatebank {path} seems to be damaged."
                )
            try:
                values = [float(p) for p in parts]
            except ValueError as e:
                raise TemplateBankError(
                    f"Line {lineno} in templatebank {path} seems to be damaged."
                ) from e
            P.append(values[0])
            tau.append(values[1])
            psi0.append(values[2])
    return TemplateBank(
        np.asarray(P, dtype=np.float64),
        np.asarray(tau, dtype=np.float64),
        np.asarray(psi0, dtype=np.float64),
    )


def write_template_bank(path: str, bank: TemplateBank) -> None:
    with open(path, "w") as f:
        for p, t, s in zip(bank.P, bank.tau, bank.psi0):
            f.write(f"{p:.12f} {t:.12f} {s:.12f}\n")
