"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` has a plain C interface and is compiled
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
in ``build/`` inside the package (listed in .gitignore), named by a hash
of the source and flags so an edited source rebuilds.  The build happens
at first use and `build_all` starts one nvcc per source at once.  A build
that fails raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("fdmt", "fir", "beamform", "romein", "dq")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
build_log = {}    # name -> {"seconds", "ptxas"} of builds in this process


def nvcc_path():
    from torch.utils.cpp_extension import CUDA_HOME
    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc")


def _target(name):
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() +
                         " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{key}.so"


def _start(name):
    src, lib = _target(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, time.perf_counter()


def _finish(name, started):
    if started is None:
        return
    proc, tmp, lib, t0 = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)
    build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": out}


def build_all(names=SOURCES):
    """Compile every named source that is not built yet, one nvcc each,
    all started together; -> seconds taken."""
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            _finish(n, s)
    return time.perf_counter() - t0


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _libs[name] = ctypes.CDLL(str(_target(name)[1]))
        return lib
