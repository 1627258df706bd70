"""Build the port's CUDA kernels and load them with ctypes.

All of ``bayesnmf_tpu_torch/csrc/*.cu`` (with the headers they share,
``csrc/*.cuh``) is compiled at first use into one shared library with a
plain C interface: one nvcc per source, all started together, then one
link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \\
         -Xcompiler -fPIC -c -o <obj> csrc/<source>.cu      (each source)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib> <objs>

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
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "bayesnmf_tpu_torch")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                           "-fPIC")

_lock = threading.Lock()
_lib = None
#: seconds each source took to compile in this process's build (empty when
#: the library was already built)
compile_seconds: dict = {}


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
        # the headers the sources include (csrc/*.cuh) are hashed with them
        for s in srcs + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
            with open(s, "rb") as fh:
                h.update(os.path.basename(s).encode() + b"\0" + fh.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        os.makedirs(BUILD_DIR, exist_ok=True)
        lib_path = os.path.join(BUILD_DIR,
                                f"libkernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(lib_path):
            _compile(srcs, lib_path)
        _lib = ctypes.CDLL(lib_path)
        return _lib


def _compile(srcs: list[str], lib_path: str):
    """One nvcc per source, run together, then the link into ``lib_path``
    (written under a temporary name and renamed, so a reader never sees a
    half-written library)."""
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(src) + f".{tag}.o")
            for src in srcs]
    t0 = time.perf_counter()
    # each compiler's messages go to a file, read once it has ended
    logs = [open(obj + ".log", "w+") for obj in objs]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=log, stderr=log, text=True)
             for src, obj, log in zip(srcs, objs, logs)]
    # each source's seconds, for finding the build's longest pole
    done = {}
    while len(done) < len(srcs):
        for src, proc in zip(srcs, procs):
            if src not in done and proc.poll() is not None:
                done[src] = time.perf_counter() - t0
        time.sleep(0.1)
    compile_seconds.update({os.path.basename(k): v for k, v in done.items()})
    errors = []
    for src, proc, log in zip(srcs, procs, logs):
        proc.wait()
        log.seek(0)
        err = log.read()
        log.close()
        os.remove(log.name)
        if proc.returncode != 0:
            errors.append(f"{os.path.basename(src)} ({proc.returncode}):\n"
                          f"{err}")
    tmp = f"{lib_path}.{tag}"
    if not errors:
        proc = subprocess.run([_nvcc(), *ARCH_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            errors.append(f"link ({proc.returncode}):\n{proc.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    os.replace(tmp, lib_path)
