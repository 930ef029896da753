"""Whitening helpers that stay on the host (``demod_binary.c:917,1015-1021``):
the zap-noise seed and the GSL-compatible taus2 zap-noise stream."""

from __future__ import annotations

import numpy as np

from .gslrng import Taus2, gaussian_ziggurat


def seed_from_samples(samples: np.ndarray) -> int:
    """``seed = *((int32_t*) t_series_dd)`` (``demod_binary.c:917``)."""
    return int(np.frombuffer(samples[:1].astype(np.float32).tobytes(), "<i4")[0])


def zap_noise(
    seed: int, bin_ranges: np.ndarray, sigma: float, fft_size: int
) -> tuple[np.ndarray, np.ndarray]:
    """(indices, complex values) for all zapped bins, in file order.

    Each bin draws re then im sequentially from one taus2 stream
    (``demod_binary.c:1015-1021``). Out-of-range bins (the reference would
    write out of bounds — UB) are drawn but dropped.
    """
    rng = Taus2(seed)
    idx_list, val_list = [], []
    for fmin_idx, fmax_idx in bin_ranges:
        for idx in range(int(fmin_idx), int(fmax_idx) + 1):
            re = gaussian_ziggurat(rng, sigma)
            im = gaussian_ziggurat(rng, sigma)
            if idx < fft_size:
                idx_list.append(idx)
                val_list.append(complex(np.float32(re), np.float32(im)))
    return (
        np.asarray(idx_list, dtype=np.int64),
        np.asarray(val_list, dtype=np.complex64),
    )
