"""The plain reference of the BRP search, in PyTorch: whitening, the
orbital resampling, the power spectrum, the 16-harmonic fold, the
earliest-template-wins merge, and the rescoring's point powers.

It imports nothing of the program.  It follows the C reference's float32
semantics (``demod_binary.c``, ``demod_binary_resamp_cpu.c``,
``hs_common.c``, ``erp_utilities.cpp``): every multiply and add is its own
torch operation, so each rounds on its own as in the C; constants are
float32 tensors (a Python scalar divisor would become a reciprocal and a
multiply).  The running median is a sort of each window.  The rescoring's
spectrum takes a float64 FFT rounded to float32, as the C's FFTW-backed
host path and numpy's do.

``lowp=True`` is the control: the same computation with every stage's
output (whitened series, resampled series, power, harmonic sums) rounded
through bfloat16, the precision below the configuration's float32.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .gslrng import Taus2, gaussian_ziggurat
from .inputs import Geometry

# erp_utilities.cpp:45-46: the 65-entry tables as the reference prints them
_SIN = (
    "0.000000 0.098017 0.195090 0.290285 0.382683 0.471397 0.555570 0.634393 "
    "0.707107 0.773010 0.831470 0.881921 0.923880 0.956940 0.980785 0.995185 "
    "1.000000 0.995185 0.980785 0.956940 0.923880 0.881921 0.831470 0.773010 "
    "0.707107 0.634393 0.555570 0.471397 0.382683 0.290285 0.195091 0.098017 "
    "0.000000 -0.098017 -0.195090 -0.290284 -0.382683 -0.471397 -0.555570 "
    "-0.634393 -0.707107 -0.773010 -0.831469 -0.881921 -0.923880 -0.956940 "
    "-0.980785 -0.995185 -1.000000 -0.995185 -0.980785 -0.956940 -0.923880 "
    "-0.881921 -0.831470 -0.773011 -0.707107 -0.634394 -0.555570 -0.471397 "
    "-0.382684 -0.290285 -0.195091 -0.098017 -0.000000"
)
_COS = (
    "1.000000 0.995185 0.980785 0.956940 0.923880 0.881921 0.831470 0.773010 "
    "0.707107 0.634393 0.555570 0.471397 0.382683 0.290285 0.195090 0.098017 "
    "0.000000 -0.098017 -0.195090 -0.290285 -0.382683 -0.471397 -0.555570 "
    "-0.634393 -0.707107 -0.773010 -0.831470 -0.881921 -0.923880 -0.956940 "
    "-0.980785 -0.995185 -1.000000 -0.995185 -0.980785 -0.956940 -0.923880 "
    "-0.881921 -0.831470 -0.773011 -0.707107 -0.634393 -0.555570 -0.471397 "
    "-0.382684 -0.290285 -0.195090 -0.098017 0.000000 0.098017 0.195090 "
    "0.290285 0.382683 0.471397 0.555570 0.634393 0.707107 0.773010 0.831470 "
    "0.881921 0.923879 0.956940 0.980785 0.995185 1.000000"
)
SIN_TABLE = np.array(_SIN.split(), dtype=np.float32)
COS_TABLE = np.array(_COS.split(), dtype=np.float32)
# erp_utilities.h:31: the truncated literal 6.283185f, one ulp below 2*pi
TWO_PI = np.float32(6.283185)

# hs_common.c:78-148: each harmonic level's new multipliers, summed left
# to right, then added to the running sum as one group
LEVELS = ((16,), (8,), (12, 4), (14, 10, 6, 2), (15, 13, 11, 9, 7, 5, 3, 1))

_libm = None


def sinf(x: float) -> np.float32:
    """glibc's float sine: the C computes ``S0 = tau * sin(Psi0) *
    step_inv`` through the float overload (``demod_binary.c:1230``)."""
    global _libm
    if _libm is None:
        try:
            _libm = ctypes.CDLL("libm.so.6")
            _libm.sinf.restype = ctypes.c_float
            _libm.sinf.argtypes = [ctypes.c_float]
        except OSError:
            _libm = False
    if _libm is False:
        return np.sin(np.float32(x), dtype=np.float32)
    return np.float32(_libm.sinf(float(np.float32(x))))


def template_params(P, tau, psi, dt: float) -> np.ndarray:
    """float32[n, 4] rows (tau, omega, psi0, S0) as the C driver derives
    them (``demod_binary.c:1208-1238``)."""
    tau32 = np.asarray(tau, dtype=np.float32)
    psi32 = np.asarray(psi, dtype=np.float32)
    P32 = np.asarray(P, dtype=np.float32)
    step_inv = np.float32(1.0) / np.float32(dt)
    omega = (2.0 * np.pi / P32.astype(np.float64)).astype(np.float32)
    s = np.array([sinf(v) for v in psi32], dtype=np.float32)
    s0 = ((tau32 * s).astype(np.float32) * step_inv).astype(np.float32)
    return np.stack([tau32, omega, psi32, s0], axis=1)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


class Reference:
    """The reference on ``device`` for one geometry; ``lowp`` makes it the
    bfloat16 control."""

    def __init__(self, geom: Geometry, device, lowp: bool = False):
        self.g = geom
        self.dev = torch.device(device)
        self.lowp = lowp
        f = lambda v: torch.tensor(np.float32(v), device=self.dev)  # noqa: E731
        self.f32 = f
        self.sin_t = torch.from_numpy(SIN_TABLE).to(self.dev)
        self.cos_t = torch.from_numpy(COS_TABLE).to(self.dev)
        self.i_f = torch.arange(geom.n_unpadded, dtype=torch.float32, device=self.dev)
        self.t = self.i_f * f(geom.dt)

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return _round_bf16(x) if self.lowp else x

    # -- whitening (demod_binary.c:856-1079) -------------------------------

    def running_median(self, ps: torch.Tensor, block: int = 1 << 16) -> torch.Tensor:
        """Medians of every ``window``-bin window of ``ps``; the two central
        values averaged in double, then rounded, for an even window."""
        w = self.g.window
        n_out = ps.shape[0] - w + 1
        out = torch.empty(n_out, dtype=torch.float32, device=self.dev)
        half = w // 2
        for s in range(0, n_out, block):
            e = min(s + block, n_out)
            sw = torch.sort(ps[s : e + w - 1].unfold(0, w, 1), dim=1).values
            if w % 2:
                out[s:e] = sw[:, half]
            else:
                out[s:e] = ((sw[:, half - 1].double() + sw[:, half].double()) * 0.5).float()
        return out

    def whiten(self, samples: np.ndarray, zap_ranges: np.ndarray, padding: float) -> torch.Tensor:
        """The whitened, zapped series float32[n_unpadded]."""
        g, f = self.g, self.f32
        x = torch.zeros(g.nsamples, dtype=torch.float32, device=self.dev)
        x[: g.n_unpadded] = torch.from_numpy(np.asarray(samples, dtype=np.float32)).to(self.dev)
        F = torch.fft.rfft(x)
        re, im = F.real.contiguous(), F.imag.contiguous()
        ps = re * re + im * im
        ps[0] = 0.0
        rm = self.running_median(ps)
        scale = torch.ones(g.fft_size, dtype=torch.float32, device=self.dev)
        scale[g.window_2 : g.window_2 + rm.shape[0]] = torch.sqrt(f(math.log(2.0)) / rm)
        re = re * scale
        im = im * scale
        # the zap noise: one taus2 stream seeded with the first sample's bits
        seed = int(np.asarray(samples[:1], dtype=np.float32).view("<i4")[0])
        rng = Taus2(seed)
        sigma = float(np.sqrt(0.5) * np.sqrt(padding))
        idx, vre, vim = [], [], []
        for lo, hi in (np.asarray(zap_ranges) * g.t_obs + 0.5).astype(np.uint32):
            for b in range(int(lo), int(hi) + 1):
                r = gaussian_ziggurat(rng, sigma)
                i = gaussian_ziggurat(rng, sigma)
                if b < g.fft_size:
                    idx.append(b)
                    vre.append(np.float32(r))
                    vim.append(np.float32(i))
        if idx:
            ii = torch.tensor(idx, dtype=torch.int64, device=self.dev)
            re[ii] = torch.tensor(np.array(vre, dtype=np.float32), device=self.dev)
            im[ii] = torch.tensor(np.array(vim, dtype=np.float32), device=self.dev)
        w2 = g.window_2
        for a in (re, im):
            a[:w2] = 0.0
            a[g.fft_size - w2 :] = 0.0
        back = torch.fft.irfft(torch.complex(re, im), n=g.nsamples)
        back = back * f(np.sqrt(np.float32(g.nsamples)))
        return self._q(back[: g.n_unpadded].contiguous())

    # -- the search (demod_binary_resamp_cpu.c:80-136, fft, hs_common.c) --

    def _lut_sin(self, x: torch.Tensor) -> torch.Tensor:
        f = self.f32
        scaled = f(np.float32(1.0) / TWO_PI) * x
        xt = scaled - torch.trunc(scaled)
        xt = torch.where(xt < 0.0, xt + f(1.0), xt)
        i0 = (xt * f(64.0) + f(0.5)).to(torch.int64)
        d = f(TWO_PI) * (xt - f(1.0 / 64.0) * i0.to(torch.float32))
        d2 = d * (f(0.5) * d)
        ts = self.sin_t[i0]
        tc = self.cos_t[i0]
        return (ts + d * tc) - d2 * ts

    def resample(self, ts: torch.Tensor, params: np.ndarray) -> torch.Tensor:
        """float32[B, nsamples]: each template's nearest-sample resampling
        of ``ts``, padded with its mean."""
        g, f = self.g, self.f32
        p = torch.from_numpy(np.ascontiguousarray(params, dtype=np.float32)).to(self.dev)
        tau, omega, psi, s0 = (p[:, c : c + 1] for c in range(4))
        step_inv = f(np.float32(1.0) / np.float32(g.dt))
        phase = omega * self.t + psi
        del_t = (tau * self._lut_sin(phase)) * step_inv - s0
        del phase
        reach = self.i_f - del_t
        # the shrink loop (:105-109): the last sample whose reach stays inside
        limit = f(g.n_unpadded - 1)
        idx = torch.arange(g.n_unpadded, device=self.dev)
        n_steps = torch.where(reach >= limit, -1, idx).amax(dim=1)
        near = torch.trunc(reach + f(0.5)).to(torch.int64).clamp_(0, g.n_unpadded - 1)
        del reach, del_t
        inside = idx[None, :] < n_steps[:, None]
        head = torch.where(inside, ts[near], 0.0)
        del near
        mean = (head.double().sum(dim=1) / n_steps.clamp(min=1).double()).float()
        mean = torch.where(n_steps > 0, mean, 0.0)
        out = mean[:, None].expand(-1, g.nsamples).contiguous()
        out[:, : g.n_unpadded] = torch.where(inside, head, mean[:, None])
        return self._q(out)

    def power(self, x: torch.Tensor, fft64: bool = False) -> torch.Tensor:
        """float32 ``(re^2 + im^2) / nsamples`` with DC 0; ``fft64`` takes
        the transform in float64 and rounds its output to float32."""
        F = torch.fft.rfft(x.double() if fft64 else x)
        re = F.real.float()
        im = F.imag.float()
        del F
        ps = (re * re + im * im) * self.f32(np.float32(1.0 / self.g.nsamples))
        ps[:, 0] = 0.0
        return self._q(ps)

    def _gather(self, ps: torch.Tensor, i: torch.Tensor, l: int) -> torch.Tensor:
        return ps[:, (i * l + 8) >> 4]

    def fold(self, ps: torch.Tensor) -> torch.Tensor:
        """float32[B, 5, fund_hi] in natural bin order: level 0 the power,
        level k the largest 2^k-harmonic sum over the summing indices
        ``i in [2^k j - 2^(k-1), 2^k j + 2^(k-1))``, below ``harm_hi``."""
        g = self.g
        B = ps.shape[0]
        n_i = 16 * g.fund_hi
        i = torch.arange(n_i, device=self.dev)
        # indices past the spectrum read 0
        ps = torch.nn.functional.pad(ps, (0, max(0, n_i + 1 - ps.shape[1])))
        out = torch.empty((B, 5, g.fund_hi), dtype=torch.float32, device=self.dev)
        out[:, 0] = ps[:, : g.fund_hi]
        running = self._gather(ps, i, 16)
        valid = i < g.harm_hi
        for k in range(1, 5):
            level = None
            for l in LEVELS[k]:
                term = self._gather(ps, i, l)
                level = term if level is None else level + term
            running = running + level
            del level
            m, h = 1 << k, 1 << (k - 1)
            s = torch.where(valid[: m * g.fund_hi - h], running[:, : m * g.fund_hi - h], 0.0)
            s = torch.nn.functional.pad(s, (h, 0))
            out[:, k] = s.view(B, g.fund_hi, m).amax(dim=2)
        return self._q(out)

    def sums(self, ts: torch.Tensor, params: np.ndarray) -> torch.Tensor:
        """float32[B, 5, fund_hi]: the search's harmonic sums of a batch."""
        return self.fold(self.power(self.resample(ts, params)))

    def search(self, ts: torch.Tensor, params: np.ndarray, rows, batch: int, visit=None):
        """(M, T) natural order over templates ``rows`` (ascending bank
        indices), merged batch by batch with a strict ``>`` (ties keep the
        earlier template); ``visit(rows_chunk, sums)`` sees every batch."""
        g = self.g
        rows = np.asarray(rows, dtype=np.int64)
        M = torch.zeros((5, g.fund_hi), dtype=torch.float32, device=self.dev)
        T = torch.zeros((5, g.fund_hi), dtype=torch.int64, device=self.dev)
        for s in range(0, len(rows), batch):
            chunk = rows[s : s + batch]
            S = self.sums(ts, params[chunk])
            if visit is not None:
                visit(chunk, S)
            bmax, barg = S.max(dim=0)
            better = bmax > M
            M = torch.where(better, bmax, M)
            T = torch.where(better, torch.from_numpy(chunk).to(self.dev)[barg], T)
            del S
        return M, T

    # -- the rescoring's point powers (oracle of demod_binary.c's host path)

    def point_powers(self, ts: torch.Tensor, params: np.ndarray, pairs) -> list[float]:
        """For each template row of ``params`` (float32[n, 4]) and its list
        of (k, f0) pairs: the 2^k-harmonic power at fundamental bin f0 from
        a float64 transform rounded to float32, over the summing indices
        inside ``[window_2, harm_hi)``; float32 values."""
        g = self.g
        out = []
        for row, want in zip(params, pairs):
            ps = self.power(self.resample(ts, row[None, :]), fft64=True)[0]
            vals = []
            for k, j in want:
                if k == 0:
                    vals.append(float(ps[j]))
                    continue
                mp = 16 >> k
                lo = max(-(-(16 * j - 8) // mp), g.window_2)
                hi = min((16 * j + 7) // mp + 1, g.harm_hi)
                i = torch.arange(lo, hi, device=self.dev)
                s = None
                for level in LEVELS[: k + 1]:
                    acc = None
                    for l in level:
                        term = ps[(i * l + 8) >> 4]
                        acc = term if acc is None else acc + term
                    s = acc if s is None else s + acc
                vals.append(float(self._q(s.amax()[None])[0]))
            out.append(vals)
        return out
