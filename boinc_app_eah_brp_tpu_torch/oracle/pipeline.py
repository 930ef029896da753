"""Search configuration and derived geometry (``demod_binary.c:210-215``,
``:1087-1099``): numpy copies of the reference package's definitions."""

from __future__ import annotations

from dataclasses import dataclass


def fft_size_for(nsamples: int) -> int:
    """``fft_size = (int)(nsamples*0.5 + 0.5) + 1`` (``demod_binary.c:1092``).

    Equals ``nsamples//2 + 1`` for even nsamples, which the padded length
    always is in production (k * 2^22). We require even.
    """
    if nsamples % 2:
        raise ValueError("padded nsamples must be even")
    return nsamples // 2 + 1


@dataclass
class SearchConfig:
    """User variables with the reference defaults (``demod_binary.c:210-215``)."""

    f0: float = 250.0  # max fundamental frequency searched (Hz)
    padding: float = 1.0  # frequency over-resolution factor
    fA: float = 0.04  # overall false alarm probability
    window: int = 1000  # running-median window (bins)
    white: bool = False


@dataclass
class DerivedParams:
    """Geometry derived from header + config (``demod_binary.c:1087-1099``)."""

    n_unpadded: int
    nsamples: int  # padded
    fft_size: int
    window_2: int
    fundamental_idx_hi: int
    harmonic_idx_hi: int
    dt: float  # seconds
    t_obs: float  # padded observation time, seconds

    @classmethod
    def derive(cls, n_unpadded: int, tsample_us: float, cfg: SearchConfig) -> "DerivedParams":
        nsamples = int(cfg.padding * n_unpadded + 0.5)  # demod_binary.c:782
        dt = tsample_us * 1.0e-6
        t_obs = nsamples * dt  # demod_binary.c:1087 (uses padded nsamples)
        fft_size = fft_size_for(nsamples)
        window_2 = int(cfg.window * 0.5 + 0.5)
        fundamental_idx_hi = min(fft_size - window_2, int(cfg.f0 * t_obs + 0.5))
        harmonic_idx_hi = min(fft_size - window_2, int(16.0 * cfg.f0 * t_obs + 0.5))
        if fft_size < cfg.window:
            raise ValueError(
                f"Running median window ({cfg.window} bins) is too wide for data set ({fft_size} bins)!"
            )
        return cls(
            n_unpadded=n_unpadded,
            nsamples=nsamples,
            fft_size=fft_size,
            window_2=window_2,
            fundamental_idx_hi=fundamental_idx_hi,
            harmonic_idx_hi=harmonic_idx_hi,
            dt=dt,
            t_obs=t_obs,
        )
