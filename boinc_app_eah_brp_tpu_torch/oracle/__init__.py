"""Host-side numpy pieces of the search: configuration, chi-squared
statistics, the toplist, the reference sine table and the zap-noise RNG."""

from .pipeline import DerivedParams, SearchConfig, fft_size_for
from .stats import base_thresholds, chisq_Q, chisq_Qinv
from .toplist import finalize_candidates, update_toplist_from_maxima
from .whiten import seed_from_samples, zap_noise

__all__ = [
    "DerivedParams",
    "SearchConfig",
    "base_thresholds",
    "chisq_Q",
    "chisq_Qinv",
    "fft_size_for",
    "finalize_candidates",
    "seed_from_samples",
    "update_toplist_from_maxima",
    "zap_noise",
]
