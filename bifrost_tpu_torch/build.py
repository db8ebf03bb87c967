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

The host libraries (`HOST_LIBS`: the ring engine, ``csrc/ring.cpp`` over
``csrc/ring_host.h``; the UDP data plane, ``csrc/*.cpp`` and
``csrc/udp_host.h``; the shm ring over ``csrc/host_status.h``) need no
CUDA: `load_host` compiles them with the host
C++ compiler (``c++``) the same way, hash-named, at first use, through a
temporary file renamed into place, so processes building at once do not
collide.  The ring engine is loaded with ``RTLD_GLOBAL`` before a library
that calls it (`HOST_DEPS`: the UDP capture engine reserves and commits
the ring itself), so that library's references resolve to the one
engine.

The directory the builds go to is `BUILD_DIR` (generated libraries under
`MAP_BUILD_DIR`, its ``map/``): the package's ``build/`` by default, or the
`kernel_cache` flag's directory once cache.py switches it there
(`set_build_dir`), so a later process loads what an earlier one built.

Generated sources (bf.map's kernel M1, ops/map_codegen.py): `load_generated`
compiles one ``.cu`` that includes ``csrc/map_common.cuh`` with
``--fmad=false`` (no multiply and add contracted: the plain engine rounds
each operator on its own) into ``build/map/lib<sha256>.so``, named by the
source, the flags and the header, through a temporary file and a rename.
It has its own lock, so a map build never holds `_lock` against the
fixed kernels, a lock per library, so that threads asking for one
program at once run one compiler, and an in-process LRU of
`GENERATED_CAPACITY` loaded libraries.  ptxas's report is kept beside the library
(``lib<sha256>.ptxas``), so a library loaded from disk still tells its
registers and spills (`generated_log`).  `load_generated_host` builds
the same source with the host C++ compiler (its ``map_host`` entry), for
the CPU tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import OrderedDict
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent / "build"
BUILD_DIR = DEFAULT_BUILD_DIR
SOURCES = ("fdmt", "fir", "fir_long", "beamform", "romein", "dq",
           "flag", "xengine")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DERIVED = {"fir_long": ("fir", ("-DFIR_LONG_FORM",))}

HOST_LIBS = {"ring": ("ring.cpp",),
             "udp": ("socket.cpp", "udp_capture.cpp", "udp_transmit.cpp"),
             "shmring": ("shmring.cpp",)}
HOST_HEADERS = ("ring_host.h", "udp_host.h", "host_status.h")
HOST_DEPS = {"udp": ("ring",)}
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

MAP_BUILD_DIR = DEFAULT_BUILD_DIR / "map"
MAP_HEADER = "map_common.cuh"
MAP_NVCC_FLAGS = NVCC_FLAGS + ("--fmad=false", "-I", str(CSRC))
MAP_HOST_FLAGS = HOST_FLAGS + ("-ffp-contract=off", "-I", str(CSRC))
GENERATED_CAPACITY = 64

_lock = threading.Lock()
_libs = {}
build_log = {}    # name -> {"seconds", "ptxas"} of builds in this process
_gen_lock = threading.Lock()
_gen_libs = OrderedDict()   # (kind, target path) -> ctypes library
_gen_build_locks = {}       # target path -> lock held while it builds
# One entry per generated library loaded in this process: {"name",
# "seconds" (0.0 where the built library was on disk), "nvcc" (whether a
# compiler ran), "ptxas" (its -v output, kept beside the library; "" for
# a host build)}.
generated_log = []


def set_build_dir(path=None):
    """Send later builds to `path` (its ``map/`` for the generated ones),
    or back to the package's ``build/`` with None -> the directory.
    Libraries loaded already stay loaded."""
    global BUILD_DIR, MAP_BUILD_DIR
    path = DEFAULT_BUILD_DIR if path is None else Path(path)
    with _lock, _gen_lock:
        BUILD_DIR = path
        MAP_BUILD_DIR = path / "map"
    return path


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
    of host library `name` (`HOST_LIBS`), built at first use, after the
    libraries it calls (`HOST_DEPS`).  A failed build raises with the
    compiler's output."""
    for dep in HOST_DEPS.get(name, ()):
        load_host(dep)
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
        called = any(name in deps for deps in HOST_DEPS.values())
        mode = ctypes.RTLD_GLOBAL if called else ctypes.DEFAULT_MODE
        lib = _libs[name] = ctypes.CDLL(str(target), mode=mode)
        return lib


def _generated_target(name, source, flags, suffix):
    h = hashlib.sha256(source.encode())
    h.update(" ".join(flags).encode())
    h.update((CSRC / MAP_HEADER).read_bytes())
    return MAP_BUILD_DIR / f"lib{h.hexdigest()[:24]}{suffix}.so"


def _load_generated(kind, name, source, compiler, flags, suffix):
    target = _generated_target(name, source, flags, suffix)
    key = (kind, str(target))
    with _gen_lock:
        lib = _gen_libs.get(key)
        if lib is not None:
            _gen_libs.move_to_end(key)
            return lib
        build_lock = _gen_build_locks.setdefault(str(target),
                                                 threading.Lock())
    # The compiler runs outside `_gen_lock`, so that threads build
    # different programs at once, and under the library's own lock, so
    # that threads asking for one program run one compiler; it writes
    # temporary files and renames the library into place, so no process
    # loads a half-written one.
    with build_lock:
        return _build_generated(kind, key, name, source, compiler, flags,
                                target)


def _build_generated(kind, key, name, source, compiler, flags, target):
    with _gen_lock:
        lib = _gen_libs.get(key)
        if lib is not None:
            return lib
    entry = {"name": name, "kind": kind, "seconds": 0.0, "nvcc": False,
             "ptxas": ""}
    report = target.with_suffix(".ptxas")
    if not target.exists():
        target.parent.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.{threading.get_ident()}"
        src = target.with_suffix(f".{tag}.cu")
        tmp = target.with_suffix(f".{tag}.tmp")
        src.write_text(source)
        t0 = time.perf_counter()
        try:
            res = subprocess.run([compiler, *flags, "-o", str(tmp),
                                  str(src)], capture_output=True, text=True)
        finally:
            src.unlink(missing_ok=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{os.path.basename(compiler)} failed for the generated "
                f"map kernel {name} (exit {res.returncode}):\n"
                f"{res.stdout}{res.stderr}\n--- source ---\n{source}")
        out = res.stdout + res.stderr
        rtmp = report.with_suffix(f".{tag}.ptxtmp")
        rtmp.write_text(out)
        os.replace(rtmp, report)
        os.replace(tmp, target)
        entry.update(seconds=time.perf_counter() - t0, nvcc=True,
                     ptxas=out)
    elif report.exists():
        entry["ptxas"] = report.read_text()
    with _gen_lock:
        lib = _gen_libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(target))
            generated_log.append(entry)
            _gen_libs[key] = lib
            while len(_gen_libs) > GENERATED_CAPACITY:
                _gen_libs.popitem(last=False)
        return lib


def generated_path(name, source):
    """Where `load_generated` puts the library of `source`."""
    return _generated_target(name, source, MAP_NVCC_FLAGS + ("-x", "cu"),
                             "")


def load_generated(name, source):
    """The ctypes library of a generated CUDA source (bf.map's M1): built
    with nvcc for sm_90a and ``--fmad=false`` at first use, or loaded from
    ``build/map/`` where a process built it before.  A failed build
    raises with nvcc's output."""
    return _load_generated("cuda", name, source, nvcc_path(),
                           MAP_NVCC_FLAGS + ("-x", "cu"), "")


def load_generated_host(name, source):
    """The same generated source built with the host C++ compiler (its
    ``map_host`` entry runs the kernel's body over every element on the
    CPU), for the tests that have no card."""
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (c++) found: the generated "
                           "map bodies are checked on the host with it")
    return _load_generated("host", name, source, cxx,
                           MAP_HOST_FLAGS + ("-x", "c++"), "-host")


def clear_generated():
    """Forget the loaded generated libraries (the next load reads the
    built library from disk, or builds it)."""
    with _gen_lock:
        _gen_libs.clear()
