"""Binary on-disk formats of the reference application, as NumPy dtypes.

Byte-for-byte compatible with the packed C structs in the reference's
``structs.h`` (all structs are ``__attribute__((__packed__))`` and written
little-endian on every production platform; the reference byte-swaps on
big-endian hosts, see ``demod_binary.c:674-703`` — we always read/write
little-endian explicitly):

* ``DD_HEADER_DTYPE``  <- ``struct dd_header``   (structs.h:74-107), 1168 bytes
* ``CP_HEADER_DTYPE``  <- ``struct cp_header``   (structs.h:111-115), 260 bytes
* ``CP_CAND_DTYPE``    <- ``struct cp_cand``     (structs.h:121-130), 48 bytes
* ``DATA_HEADER_DTYPE``<- ``struct data_header`` (structs.h:40-68), 1152 bytes
"""

from __future__ import annotations

import numpy as np

FN_LENGTH = 256  # structs.h:32
N_BINS_SS = 40  # structs.h:33 — screensaver power-spectrum bins
MICROSEC = 1.0e-6  # structs.h:34

# number of candidates reported / stored (demod_binary.c:83-84)
N_CAND_5 = 100
N_CAND = 500

_DD_DOUBLES = [
    "tsample",  # sample time in us
    "tobs",  # observation time in s
    "timestamp",  # MJD
    "fcenter",  # center freq MHz
    "fchan",  # channel band kHz
    "RA",
    "DEC",
    "gal_l",
    "gal_b",
    "AZstart",
    "ZAstart",
    "ASTstart",
    "LSTstart",
    "DM",  # trial dispersion measure, pc cm^-3
    "scale",  # scale factor for compressed data
]

# integer + string tail shared by both header structs
_HEADER_TAIL = [
    ("filesize", "<u4"),
    ("datasize", "<u4"),
    ("nsamples", "<u4"),
    ("smprec", "<u2"),
    ("nchan", "<u2"),
    ("nifs", "<u2"),
    ("lagformat", "<u2"),
    ("sum", "<u2"),
    ("level", "<u2"),
    ("name", f"S{FN_LENGTH}"),
    ("originalfile", f"S{FN_LENGTH}"),
    ("proj_id", f"S{FN_LENGTH}"),
    ("observers", f"S{FN_LENGTH}"),
]

DD_HEADER_DTYPE = np.dtype([(name, "<f8") for name in _DD_DOUBLES] + _HEADER_TAIL)
assert DD_HEADER_DTYPE.itemsize == 1168, DD_HEADER_DTYPE.itemsize

# struct data_header (structs.h:40-68) lacks the DM/scale doubles
DATA_HEADER_DTYPE = np.dtype(
    [(name, "<f8") for name in _DD_DOUBLES[:13]] + _HEADER_TAIL
)
assert DATA_HEADER_DTYPE.itemsize == 1152, DATA_HEADER_DTYPE.itemsize

CP_HEADER_DTYPE = np.dtype(
    [
        ("n_template", "<u4"),
        ("originalfile", f"S{FN_LENGTH}"),
    ]
)
assert CP_HEADER_DTYPE.itemsize == 260, CP_HEADER_DTYPE.itemsize

CP_CAND_DTYPE = np.dtype(
    [
        ("power", "<f8"),  # demodulated power
        ("P_b", "<f8"),  # binary period
        ("tau", "<f8"),  # projected orbital radius (light travel time)
        ("Psi", "<f8"),  # initial orbital phase
        ("fA", "<f8"),  # -log10 false alarm rate
        ("n_harm", "<u4"),  # number of summed harmonics
        ("f0", "<u4"),  # intrinsic spin frequency bin in FFT
    ]
)
assert CP_CAND_DTYPE.itemsize == 48, CP_CAND_DTYPE.itemsize
