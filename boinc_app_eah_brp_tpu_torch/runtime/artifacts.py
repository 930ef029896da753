"""Round-numbered artifact helpers of the port's tools.

The port's copy of the JAX package's ``runtime/artifacts.py``: one home
for the ordering rule, so that ``BENCH_r9`` never sorts after
``BENCH_r10`` in any tool that picks the newest artifact.
"""

from __future__ import annotations

import os
import re


def round_key(path: str) -> tuple[int, str]:
    """Sort key for round-numbered artifacts (BENCH_r*, FULLWU_r*,
    BATCHSWEEP_r*): the PARSED round number with a deterministic
    basename tiebreak; names without a round sort last."""
    m = re.search(r"_r(\d+)", os.path.basename(path))
    return (int(m.group(1)) if m else -1, os.path.basename(path))
