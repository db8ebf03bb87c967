"""Build and load the port's CUDA kernels and its host libraries.

Each source ``csrc/<name>.cu`` has a plain C interface and is compiled
with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library
in ``build/`` inside the package (listed in .gitignore), named by a hash
of the source and flags so an edited source rebuilds.  A library of
`DERIVED` is a source built with extra flags (``fir_long``: ``fir.cu``
with its long form), so that one source's instantiations build in two
nvcc processes at once.  The build happens
at first use and `build_all` starts one nvcc per source at once.  A build
that fails raises with the compiler's output; nothing falls back.

The host libraries (`HOST_LIBS`: the UDP data plane, ``csrc/*.cpp`` and
``csrc/udp_host.h``) need no CUDA: `load_host` compiles them with the host
C++ compiler (``c++``) the same way, hash-named, at first use, through a
temporary file renamed into place, so processes building at once do not
collide.
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
SOURCES = ("fdmt", "fir", "fir_long", "beamform", "romein", "dq",
           "xengine")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DERIVED = {"fir_long": ("fir", ("-DFIR_LONG_FORM",))}

HOST_LIBS = {"udp": ("socket.cpp", "udp_capture.cpp", "udp_transmit.cpp")}
HOST_HEADERS = ("udp_host.h",)
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

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
    """-> (source, extra nvcc flags, library path)."""
    base, extra = DERIVED.get(name, (name, ()))
    src = CSRC / f"{base}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(
        NVCC_FLAGS + extra).encode()).hexdigest()[:16]
    return src, extra, BUILD_DIR / f"lib{name}-{key}.so"


def _start(name):
    src, extra, lib = _target(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)]
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
            lib = _libs[name] = ctypes.CDLL(str(_target(name)[2]))
        return lib


def _host_target(name):
    srcs = [CSRC / f for f in HOST_LIBS[name]]
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for f in srcs + [CSRC / f for f in HOST_HEADERS]:
        h.update(f.read_bytes())
    return srcs, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_host(name):
    """The ctypes library (`ctypes.CDLL`: its calls run without the GIL)
    of host library `name` (`HOST_LIBS`), built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        srcs, target = _host_target(name)
        if not target.exists():
            cxx = shutil.which("c++")
            if cxx is None:
                raise RuntimeError("no host C++ compiler (c++) found: "
                                   f"{name} is built from csrc/*.cpp")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            res = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp),
                                  *map(str, srcs)], capture_output=True,
                                 text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"c++ failed for {list(HOST_LIBS[name])} "
                    f"(exit {res.returncode}):\n{res.stdout}{res.stderr}")
            os.replace(tmp, target)
        lib = _libs[name] = ctypes.CDLL(str(target))
        return lib
