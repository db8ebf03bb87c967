"""CPU-core affinity and names of block threads (counterpart of
bifrost_tpu/affinity.py; reference python/bifrost/affinity.py:37-41).

Linux's ``sched_setaffinity``/``sched_getaffinity`` with pid 0 act on the
calling thread, and libc's ``pthread_setname_np`` names it, so no host
library is built.  A block built under ``block_scope(core=N)`` pins its
thread to core N when it starts (pipeline.Block._run) and records N in its
``bind`` proclog.  A ring of such a block prefers core N's NUMA node for
its host bytes (ring.py); `core_node` and `page_nodes` read back where
pages lie, from sysfs and ``/proc/self/numa_maps`` (read only).
"""

from __future__ import annotations

import ctypes
import errno
import os

__all__ = ["get_core", "set_core", "set_openmp_cores", "set_thread_name",
           "core_node", "page_nodes"]

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


def core_node(core):
    """The NUMA node of CPU `core` (sysfs), or None where the machine does
    not say."""
    try:
        names = os.listdir(f"/sys/devices/system/cpu/cpu{int(core)}")
    except OSError:
        return None
    nodes = [int(n[4:]) for n in names
             if n.startswith("node") and n[4:].isdigit()]
    return nodes[0] if nodes else None


def page_nodes(ptr, nbyte):
    """{NUMA node: resident pages} of the mappings of this process that
    overlap [ptr, ptr + nbyte), and their memory policies, from
    ``/proc/self/numa_maps`` -> (dict, set of policy strings), or None
    where the kernel keeps no such file (built without NUMA).  Pages not
    touched yet are not counted."""
    if not os.path.exists("/proc/self/numa_maps"):
        return None
    lo, hi = int(ptr), int(ptr) + int(nbyte)
    starts = []
    with open("/proc/self/maps") as f:
        for line in f:
            a, b = (int(x, 16) for x in line.split()[0].split("-"))
            if a < hi and b > lo:
                starts.append(a)
    nodes, policies = {}, set()
    with open("/proc/self/numa_maps") as f:
        for line in f:
            fields = line.split()
            if int(fields[0], 16) not in starts:
                continue
            policies.add(fields[1])
            for fld in fields[2:]:
                key, _, val = fld.partition("=")
                if key[:1] == "N" and key[1:].isdigit():
                    node = int(key[1:])
                    nodes[node] = nodes.get(node, 0) + int(val)
    return nodes, policies
