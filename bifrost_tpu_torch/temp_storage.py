"""Shared scratch storage (counterpart of bifrost_tpu/temp_storage.py;
reference python/bifrost/temp_storage.py): a lock-guarded, grow-only byte
buffer that blocks of one scope share, for example as a workspace.  The
buffer is a torch uint8 tensor on the storage's device ('cuda': the
card, or the device named; the host spaces: the CPU, pinned for
'cuda_host')."""

from __future__ import annotations

import threading

import torch

from . import device as _device
from .memory import Space

__all__ = ["TempStorage", "TempStorageAllocation"]


class TempStorage(object):
    def __init__(self, space="system", device=None):
        self.space = str(Space(space))
        self.device = _device.resolve_device(device) \
            if self.space == "cuda" else torch.device("cpu")
        self.size = 0
        self.buffer = None
        self.lock = threading.Lock()

    def allocate(self, size):
        """Grow to at least `size` bytes; -> a TempStorageAllocation that
        holds the lock until it is released (a context manager)."""
        with self.lock:
            if size > self.size:
                self.buffer = torch.empty(
                    int(size), dtype=torch.uint8, device=self.device,
                    pin_memory=self.space == "cuda_host")
                self.size = int(size)
        return TempStorageAllocation(self, size)


class TempStorageAllocation(object):
    def __init__(self, parent, size):
        self.parent = parent
        self.size = size
        parent.lock.acquire()

    @property
    def data(self):
        """The first `size` bytes of the shared buffer (a uint8 tensor)."""
        return self.parent.buffer[:self.size]

    def release(self):
        self.parent.lock.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
