"""Status strings and build/device probes (counterpart of
bifrost_tpu/core.py; reference python/bifrost/core.py:37-41).

The status codes are those of the JAX package's C core, which the port's
host libraries keep (csrc/host_status.h), so every code reads here as it
reads through the JAX package's `core.status_string`."""

from __future__ import annotations

__all__ = ["status_string", "debug_enabled", "set_debug_enabled",
           "cuda_enabled"]

# BTstatus -> text (cpp/include/btcore.h's codes, cpp/src/common.cpp's
# btGetStatusString).
_STATUS = {
    0: "success",
    1: "end of data",
    2: "would block",
    8: "invalid pointer",
    9: "invalid argument",
    10: "invalid state",
    11: "invalid space",
    12: "invalid shape",
    16: "memory allocation failed",
    17: "memory operation failed",
    18: "insufficient space",
    24: "unsupported",
    25: "unsupported space",
    32: "interrupted",
    33: "data overwritten",
    34: "not found",
    40: "I/O error",
    41: "shm peer process died",
    99: "internal error",
}

_debug = False


def status_string(status):
    """Human-readable name of a status code (reference core.py:37)."""
    return _STATUS.get(int(status), "unknown status")


def debug_enabled():
    """The debug switch (reference core.py:39); the port's Python code
    has no native asserts to gate, so it is a process-wide flag."""
    return _debug


def set_debug_enabled(enabled):
    global _debug
    _debug = bool(enabled)


def cuda_enabled():
    """True when a CUDA device is present (the reference's build
    constant, a runtime probe here)."""
    import torch
    return torch.cuda.is_available()
