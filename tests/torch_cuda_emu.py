"""Builds a CUDA source of the port (``csrc/<name>.cu``) with g++ against
``tests/torch_cuda_emu.h``, which runs its kernels on the host: each
launch ``kernel<<<grid, threads, smem, stream>>>(`` is rewritten to
``emu_launch(grid, threads, smem, kernel, `` and the dynamic shared array
to the header's.  The tests that use it hold a kernel's own logic on a
machine without nvcc or a card."""

import os
import re
import shutil
import subprocess

from boinc_app_eah_brp_tpu_torch.ops import kernels

EMU_H = os.path.join(os.path.dirname(__file__), "torch_cuda_emu.h")


def build(name: str, directory) -> str:
    """The shared library of ``csrc/<name>.cu`` built for the host in
    ``directory``; returns its path."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the native median too (ops/native_median.py)"
    src = open(os.path.join(kernels.CSRC, f"{name}.cu")).read()
    src = src.replace("#include <cuda_pipeline.h>\n", "")
    src = src.replace("#include <cuda_runtime.h>", f'#include "{EMU_H}"')
    src = re.sub(r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), \w+>>>\(", r"emu_launch(\2, \3, \4, \1, ", src)
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu_dynamic_shared.data());", src)
    assert "<<<" not in src and "extern __shared__" not in src
    cpp, so = os.path.join(directory, f"{name}_emu.cpp"), os.path.join(directory, f"lib{name}_emu.so")
    with open(cpp, "w") as fh:
        fh.write(src)
    subprocess.run([gxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-o", so, cpp],
                   check=True, capture_output=True, text=True)
    return so
