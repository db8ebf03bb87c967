"""Memory spaces (counterpart of bifrost_tpu/memory.py).

Spaces: 'system' (host memory), 'cuda' (device memory of the pipeline's
torch device) and 'cuda_host' (pinned host memory, the H2D staging space;
it takes the place of the JAX package's 'tpu_host').  A space names where
a ring keeps its bytes; the torch device that backs 'cuda' is the
pipeline's, so a pipeline built with ``device='cpu'`` (the tests) keeps
its 'cuda' rings in host memory, as the JAX package's 'tpu' space runs on
JAX's CPU backend in its tests.  The module imports torch at first
allocation, so the observability tools, which read its space names, start
without it.

Raw allocation (bifrost_tpu/memory.py:65-97 over cpp/src/memory.cpp):
`raw_malloc` hands out host addresses aligned to `alignment()` and keeps
a registry of them, so `raw_get_space` answers a pointer's space and
`raw_free` releases it.  'system' memory is the port's own; 'cuda_host'
is pinned by PyTorch's pinned allocator, and where it cannot be pinned
(no CUDA runtime) the call raises, never handing out pageable memory in
its place; 'cuda' raises, because device memory in the port is a
tensor's.  `memcpy`, `memcpy2D` and `memset` act on host addresses.
"""

from __future__ import annotations

import ctypes
import threading

from .core import (BifrostError, STATUS_INVALID_POINTER,
                   STATUS_MEM_ALLOC_FAILED, STATUS_UNSUPPORTED_SPACE)

SPACES = ("system", "cuda", "cuda_host")
# Space numbers as the JAX engine logs them in a ring's `space` key
# (cpp/include/btcore.h BTspace: 'tpu' is 2, 'tpu_host' 3), for the
# observability tools.
SPACEMAP = {"auto": 0, "system": 1, "cuda": 2, "cuda_host": 3}
SPACEMAP_INV = {0: "auto", 1: "system", 2: "cuda", 3: "cuda_host"}
# Spellings of the JAX package and the reference, accepted so pipelines
# port without edits.
_ALIASES = {"auto": "system", "tpu": "cuda", "tpu_host": "cuda_host",
            "cuda_managed": "cuda"}


class Space(object):
    def __init__(self, s):
        if isinstance(s, Space):
            s = s.space
        s = _ALIASES.get(s, s)
        if s not in SPACES:
            raise ValueError(f"invalid space: {s!r}")
        self.space = s

    def as_BFspace(self):
        """The space's number (`SPACEMAP`)."""
        return SPACEMAP[self.space]

    def __eq__(self, other):
        return self.space == Space(other).space

    def __hash__(self):
        return hash(self.space)

    def __str__(self):
        return self.space

    def __repr__(self):
        return f"Space('{self.space}')"


def space_device(space, device):
    """The torch device that holds `space`'s bytes in a pipeline bound to
    `device`: 'cuda' lives on `device`, the host spaces on the CPU."""
    import torch
    return torch.device(device) if Space(space).space == "cuda" \
        else torch.device("cpu")


def alloc_bytes(shape, space, device):
    """Uninitialized uint8 tensor of `shape` in `space`.  'cuda_host' is
    pinned when `device` is a CUDA device (on a CPU-bound pipeline there
    is nothing to pin for)."""
    import torch
    dev = space_device(space, device)
    pin = Space(space).space == "cuda_host" and \
        torch.device(device).type == "cuda"
    return torch.empty(shape, dtype=torch.uint8, device=dev, pin_memory=pin)


def space_accessible(space, from_spaces):
    """Can memory in `space` be dereferenced by code running in
    `from_spaces` (a space, a list of them, or 'any')?  Host code reaches
    'system' and 'cuda_host' alike; 'cuda' only from 'cuda'
    (bifrost_tpu/memory.py:44-62)."""
    if from_spaces == "any":
        return True
    if not isinstance(from_spaces, (list, tuple, set)):
        from_spaces = [from_spaces]
    from_spaces = {Space(s).space for s in from_spaces}
    space = Space(space).space
    if space in from_spaces:
        return True
    if space == "cuda_host":
        return "system" in from_spaces
    if space == "system":
        return "cuda_host" in from_spaces
    return False


# cpp/src/memory.cpp's kAlignment.
_ALIGNMENT = 512
_alloc_lock = threading.Lock()
# address -> (space, size, the object that owns the bytes)
_allocations = {}


def alignment():
    """The alignment of every `raw_malloc` address, in bytes."""
    return _ALIGNMENT


def require_pinning():
    """Raise BifrostError where there is no CUDA runtime to pin host
    memory with: 'cuda_host' is pinned memory or an error."""
    import torch
    if not torch.cuda.is_available():
        raise BifrostError(STATUS_UNSUPPORTED_SPACE,
                           "'cuda_host' memory is pinned by the CUDA "
                           "runtime, and there is none")


def _pinned_block(nbyte):
    """A pinned uint8 tensor of `nbyte` bytes, or BifrostError."""
    import torch
    require_pinning()
    try:
        buf = torch.empty(nbyte, dtype=torch.uint8, pin_memory=True)
    except RuntimeError as e:
        raise BifrostError(STATUS_MEM_ALLOC_FAILED,
                           f"could not pin {nbyte} bytes: {e}") from e
    if not buf.is_pinned():
        raise BifrostError(STATUS_MEM_ALLOC_FAILED,
                           f"{nbyte} bytes came back unpinned")
    return buf, buf.data_ptr()


def raw_malloc(size, space):
    """-> the address of `size` bytes in `space`, aligned to
    `alignment()`; free it with `raw_free`."""
    space = Space(space).space
    if space == "cuda":
        raise BifrostError(STATUS_UNSUPPORTED_SPACE,
                           "'cuda' memory in the port is a tensor's; "
                           "allocate it with ndarray.empty(..., "
                           "space='cuda')")
    nbyte = max(int(size), 1) + _ALIGNMENT
    if space == "cuda_host":
        owner, base = _pinned_block(nbyte)
    else:
        owner = ctypes.create_string_buffer(nbyte)
        base = ctypes.addressof(owner)
    ptr = (base + _ALIGNMENT - 1) // _ALIGNMENT * _ALIGNMENT
    with _alloc_lock:
        _allocations[ptr] = (space, int(size), owner)
    return ptr


def raw_free(ptr, space="system"):
    """Release an address `raw_malloc` gave (None or 0: nothing)."""
    if not ptr:
        return
    with _alloc_lock:
        if _allocations.pop(int(ptr), None) is None:
            raise BifrostError(STATUS_INVALID_POINTER,
                               f"0x{int(ptr):x} was not given by "
                               f"raw_malloc, or was freed")


def raw_get_space(ptr):
    """The space of a `raw_malloc` address; 'system' for any other."""
    with _alloc_lock:
        entry = _allocations.get(int(ptr))
    return entry[0] if entry is not None else "system"


def raw_pinned(ptr):
    """Is the `raw_malloc` address `ptr` pinned (its backing tensor's
    `is_pinned()`)?"""
    with _alloc_lock:
        entry = _allocations.get(int(ptr))
    return entry is not None and entry[0] == "cuda_host" and \
        entry[2].is_pinned()


def memcpy(dst_ptr, src_ptr, size):
    """Copy `size` bytes between host addresses."""
    ctypes.memmove(dst_ptr, src_ptr, int(size))


def memcpy2D(dst_ptr, dst_stride, src_ptr, src_stride, width, height):
    """Copy `height` rows of `width` bytes between host addresses, each
    side advancing by its own stride a row."""
    for row in range(int(height)):
        ctypes.memmove(dst_ptr + row * dst_stride,
                       src_ptr + row * src_stride, int(width))


def memset(ptr, value, size):
    """Set `size` bytes at a host address to `value`."""
    ctypes.memset(ptr, int(value), int(size))
