"""PyTorch/CUDA port of the BRP binary-pulsar search.

The search's main path — workunit, whitening, batched template search
(resample, FFT, power, 16-harmonic fold, max/argmax merge), toplist,
candidate file — runs on an NVIDIA Hopper card through hand-written CUDA
kernels (``csrc/``), with a plain PyTorch version of each kernel beside
its wrapper (``ops/``) for CPU tensors.  Entry points take a ``device``
argument that defaults to ``"cuda"``.
"""

__version__ = "0.1.0"
