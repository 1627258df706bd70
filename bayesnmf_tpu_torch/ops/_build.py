"""Build the port's CUDA kernels and load them with ctypes.

All of ``bayesnmf_tpu_torch/csrc/*.cu`` is compiled at first use into one
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -shared -Xcompiler -fPIC -o <lib> csrc/*.cu

No ``--use_fast_math``: the MH acceptance ratio needs accurate logs.
``-fmad=false`` keeps products and sums from being contracted into FMAs, so
the kernel rounds as its plain PyTorch version does; with FMAs, 1-ulp
differences in a proposal move the log acceptance ratio by ~1e-4 at
G = 2780, beyond the parity tolerance. The
library goes to ``build/bayesnmf_tpu_torch/`` at the repository root, named
by a hash of the sources, so an edited source is rebuilt and an unchanged
one is loaded as it is. Nothing here runs when the package is imported; a
missing ``nvcc`` raises only when a CUDA tensor needs a kernel.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "bayesnmf_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "bayesnmf_tpu_torch CUDA kernels cannot be built")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernels' shared library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        h = hashlib.sha256()
        for s in srcs:
            with open(s, "rb") as fh:
                h.update(os.path.basename(s).encode() + b"\0" + fh.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        os.makedirs(BUILD_DIR, exist_ok=True)
        lib_path = os.path.join(BUILD_DIR,
                                f"libkernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(lib_path):
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, lib_path)
        _lib = ctypes.CDLL(lib_path)
        return _lib
