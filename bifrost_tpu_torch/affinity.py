"""CPU-core affinity and names of block threads (counterpart of
bifrost_tpu/affinity.py; reference python/bifrost/affinity.py:37-41).

Linux's ``sched_setaffinity``/``sched_getaffinity`` with pid 0 act on the
calling thread, and libc's ``pthread_setname_np`` names it, so no host
library is built.  A block built under ``block_scope(core=N)`` pins its
thread to core N when it starts (pipeline.Block._run) and records N in its
``bind`` proclog.
"""

from __future__ import annotations

import ctypes
import errno
import os

__all__ = ["get_core", "set_core", "set_openmp_cores", "set_thread_name"]

_libc = None


def _pthread():
    global _libc
    if _libc is None:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.pthread_self.restype = ctypes.c_ulong
        libc.pthread_self.argtypes = []
        libc.pthread_setname_np.restype = ctypes.c_int
        libc.pthread_setname_np.argtypes = [ctypes.c_ulong, ctypes.c_char_p]
        _libc = libc
    return _libc


def get_core():
    """The core the calling thread is pinned to, or -1 when it may run on
    more than one."""
    cores = os.sched_getaffinity(0)
    return next(iter(cores)) if len(cores) == 1 else -1


def set_core(core):
    """Pin the calling thread to one core (-1: every online core).  A core
    out of range or refused by the kernel raises ValueError naming it, in
    the JAX package's words."""
    core = int(core)
    ncore = max(1, os.sysconf("SC_NPROCESSORS_ONLN"))
    if core >= ncore:
        raise ValueError(f"cannot pin thread to core {core}: invalid "
                         f"argument: core {core} out of range "
                         f"({ncore} online)")
    try:
        os.sched_setaffinity(0, range(ncore) if core < 0 else {core})
    except OSError as e:
        kind = ("invalid argument" if e.errno == errno.EINVAL
                else "internal error")
        raise ValueError(f"cannot pin thread to core {core}: {kind}: "
                         f"cannot pin thread to core {core}: "
                         f"sched_setaffinity: {os.strerror(e.errno)}") \
            from None


def set_openmp_cores(cores):
    """The reference pins an OpenMP worker pool; the port's host work runs
    on its block threads and PyTorch's own pool, so the calling thread is
    pinned to the first core, as the JAX package does."""
    cores = list(cores)
    if cores:
        set_core(cores[0])


def set_thread_name(name):
    """Name the calling OS thread (15 bytes kept), as `top -H` and
    `ps -L` show it."""
    lib = _pthread()
    rc = lib.pthread_setname_np(lib.pthread_self(),
                                str(name).encode()[:15])
    if rc:
        raise RuntimeError(f"cannot name the thread: {os.strerror(rc)}")
