"""Workunit (dedispersed time series) reader/writer.

A BRP workunit is a gzip stream: a packed ``DD_Header`` (1168 bytes) followed
by the sample payload — 4-bit packed nibbles for ``.bin4`` files, signed bytes
for ``.binary`` files. Mirrors ``demod_binary.c:655-842``:

* file-format selection by extension (``demod_binary.c:318-325``)
* 4-bit unpack: byte ``b`` yields samples ``b >> 4`` then ``b % 16``, each
  divided by ``header.scale``                     (``demod_binary.c:830-842``)
* 8-bit unpack: ``signed char / scale``
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

from .formats import DD_HEADER_DTYPE


@dataclass
class Workunit:
    header: np.void  # scalar of DD_HEADER_DTYPE
    samples: np.ndarray  # float32[nsamples], unpacked & scaled
    is_4bit: bool
    # raw 4-bit payload bytes (uint8[nsamples//2], None for 8-bit files):
    # kept so the packed nibbles — not the 8x larger unpacked floats — can
    # be shipped to the device and split there (ops/unpack.py)
    raw: np.ndarray | None = None

    @property
    def nsamples(self) -> int:
        return int(self.header["nsamples"])

    @property
    def tsample_s(self) -> float:
        """Sample time in seconds (header stores microseconds)."""
        return float(self.header["tsample"]) * 1.0e-6


def detect_format(path: str) -> bool:
    """True for 4-bit (.bin4), False for 8-bit (.binary).

    Same extension sniffing as ``demod_binary.c:318-325``.
    """
    if ".binary" in path:
        return False
    if ".bin4" in path:
        return True
    raise ValueError(f"Unknown file format (extension) for input file: {path}")


def unpack_4bit(raw: np.ndarray, scale: float, nsamples: int | None = None) -> np.ndarray:
    """Unpack 4-bit nibble pairs to float32, high nibble first.

    ``t[2i] = (b >> 4)/scale``, ``t[2i+1] = (b % 16)/scale``
    (``demod_binary.c:833-837``). The division is by the header's *double*
    scale with a single rounding to float, exactly like the C expression.
    If ``nsamples`` exceeds the unpacked count (odd header nsamples), the
    tail stays zero like the reference's calloc'd buffer.
    """
    raw = np.asarray(raw, dtype=np.uint8)
    n_out = raw.size * 2 if nsamples is None else nsamples
    out = np.zeros(n_out, dtype=np.float32)
    scale64 = np.float64(scale)
    out[0 : 2 * raw.size : 2] = ((raw >> 4).astype(np.float64) / scale64).astype(
        np.float32
    )
    out[1 : 2 * raw.size : 2] = ((raw & 0x0F).astype(np.float64) / scale64).astype(
        np.float32
    )
    return out


def unpack_8bit(raw: np.ndarray, scale: float) -> np.ndarray:
    """``signed char / scale`` (``demod_binary.c:838-841``), double division
    rounded once to float."""
    raw = np.asarray(raw, dtype=np.int8)
    return (raw.astype(np.float64) / np.float64(scale)).astype(np.float32)


def read_workunit(path: str) -> Workunit:
    is_4bit = detect_format(path)
    with gzip.open(path, "rb") as f:
        head_bytes = f.read(DD_HEADER_DTYPE.itemsize)
        if len(head_bytes) != DD_HEADER_DTYPE.itemsize:
            raise EOFError(f"Premature end of data header in file: {path}")
        header = np.frombuffer(head_bytes, dtype=DD_HEADER_DTYPE, count=1)[0]
        nsamples = int(header["nsamples"])
        # 4-bit: n_unpadded_format = nsamples * 0.5 truncated
        # (demod_binary.c:779); an odd nsamples leaves the last sample 0.0
        nbytes = int(nsamples * 0.5) if is_4bit else nsamples
        payload = f.read(nbytes)
        if len(payload) != nbytes:
            raise EOFError(f"Premature end of data in file: {path}")
    raw = np.frombuffer(payload, dtype=np.uint8)
    scale = float(header["scale"])
    samples = (
        unpack_4bit(raw, scale, nsamples) if is_4bit else unpack_8bit(raw, scale)
    )
    return Workunit(
        header=header,
        samples=samples,
        is_4bit=is_4bit,
        raw=raw if is_4bit else None,
    )


def pack_4bit(samples: np.ndarray, scale: float) -> bytes:
    """Inverse of :func:`unpack_4bit` for synthesizing test workunits."""
    q = np.clip(np.round(np.asarray(samples) * scale), 0, 15).astype(np.uint8)
    if q.size % 2:
        raise ValueError("4-bit payload needs an even number of samples")
    return ((q[0::2] << 4) | q[1::2]).tobytes()


def write_workunit(
    path: str,
    samples: np.ndarray,
    *,
    tsample_us: float,
    scale: float = 1.0,
    dm: float = 0.0,
    extra_header_fields: dict | None = None,
) -> None:
    """Write a synthetic 4-bit or 8-bit workunit (gzip header + payload).

    Used by the test suite to build small fixtures exercising the same format
    path as the shipped Arecibo test WU.
    """
    header = np.zeros((), dtype=DD_HEADER_DTYPE)
    nsamples = len(samples)
    header["tsample"] = tsample_us
    header["tobs"] = nsamples * tsample_us * 1.0e-6
    header["nsamples"] = nsamples
    header["scale"] = scale
    header["DM"] = dm
    for key, value in (extra_header_fields or {}).items():
        header[key] = value
    is_4bit = detect_format(path)
    if is_4bit:
        payload = pack_4bit(samples, scale)
    else:
        payload = (
            np.clip(np.round(np.asarray(samples) * scale), -128, 127)
            .astype(np.int8)
            .tobytes()
        )
    with gzip.open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(payload)
