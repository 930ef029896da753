"""LUT sine in PyTorch: the reference's ``sincosLUTLookup``
(``erp_utilities.cpp:176-209``) in the unwrapped-index form the resampler
uses.

The 64+1-entry table plus 2nd-order Taylor interpolation is the
reference's phase model; keeping its exact float32 semantics keeps the
nearest-neighbour resampling indices, and so the candidate set, aligned
with the reference builds.  For a nonnegative phase the unwrapped index
``iu = trunc(64*x/2pi + 0.5)`` addresses ``table[iu & 63]`` directly (the
table has period 64); this is the plain version of the lookup inside the
resampler kernel (``csrc/resample.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..oracle.sincos import (
    COS_SAMPLES,
    ERP_SINCOS_LUT_RES_F,
    ERP_SINCOS_LUT_RES_F_INV,
    ERP_TWO_PI,
    ERP_TWO_PI_INV,
    SIN_SAMPLES,
)

# float32 constants as Python floats (exact): eager torch ops on float32
# tensors round each result to float32, as the reference does
TWO_PI = float(ERP_TWO_PI)
TWO_PI_INV = float(ERP_TWO_PI_INV)
RES_F = float(ERP_SINCOS_LUT_RES_F)
RES_F_INV = float(ERP_SINCOS_LUT_RES_F_INV)

SIN64 = np.ascontiguousarray(SIN_SAMPLES[:64])
COS64 = np.ascontiguousarray(COS_SAMPLES[:64])


def sincos_lut_unwrapped(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin(x), cos(x)) of a float32 phase ``x >= 0`` through the LUT.
    A negative unwrapped index reads entry 0, as the tiled table's clipped
    window does."""
    scaled = TWO_PI_INV * x.to(torch.float32)
    iu = (scaled * RES_F + 0.5).to(torch.int32)  # trunc toward zero
    d = TWO_PI * (scaled - RES_F_INV * iu.to(torch.float32))
    k = (iu.clamp(min=0) & 63).long()
    ts = torch.from_numpy(SIN64).to(x.device)[k]
    tc = torch.from_numpy(COS64).to(x.device)[k]
    d2 = d * (0.5 * d)
    return ts + d * tc - d2 * ts, tc - d * ts - d2 * tc
