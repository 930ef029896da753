"""RFI zaplist parser: lines of ``fmin fmax`` (Hz), scanned with
``"%lg %lg"`` (``demod_binary.c:993-1009``)."""

from __future__ import annotations

import numpy as np


def read_zaplist(path: str) -> np.ndarray:
    """Returns float64[n, 2] of (fmin, fmax) frequency ranges."""
    ranges = []
    with open(path, "r") as f:
        for lineno, line in enumerate(f, 1):
            if not line.strip():
                continue
            parts = line.split()
            if len(parts) < 2:
                raise ValueError(
                    f"Couldn't read complete line no. {lineno} from zaplist file {path}."
                )
            ranges.append((float(parts[0]), float(parts[1])))
    return np.asarray(ranges, dtype=np.float64).reshape(-1, 2)


def zap_bin_ranges(ranges: np.ndarray, t_obs: float) -> np.ndarray:
    """Frequency ranges -> inclusive FFT-bin ranges.

    ``idx = (unsigned int)(f * t_obs + 0.5)`` (``demod_binary.c:1012-1013``),
    where ``t_obs`` is the *padded* observation time.
    """
    return (ranges * t_obs + 0.5).astype(np.uint32)
