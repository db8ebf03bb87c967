"""Shared op plumbing (counterpart of bifrost_tpu/ops/common.py):
`prepare` lifts an op's input to a tensor in logical form, `finalize`
lowers a result into an output array.
"""

from __future__ import annotations

import numpy as np
import torch

from ..DataType import DataType
from ..ndarray import (asarray, complex_view, copy_array, ndarray,
                       storage_view)


def prepare(x):
    """-> tensor.  A tensor stays on its device as it is; host input (numpy
    or a host `ndarray`) moves to this thread's device (the card unless
    the caller bound the CPU) in its logical form, as the JAX `prepare`
    gives it: complex integers as complex64, packed sub-byte types
    unpacked to 8-bit values."""
    if isinstance(x, torch.Tensor):
        return x
    dt = x.bf.dtype if isinstance(x, ndarray) else \
        DataType(np.asarray(x).dtype)
    t = asarray(np.asarray(x), space="cuda")
    if dt.nbit < 8:
        from .unpack import unpack_logical
        return unpack_logical(t, dt)
    if dt.is_complex and dt.is_integer:
        return complex_view(t, dt)
    return t


def finalize(result, out=None):
    """Write the tensor `result` into `out` and return `out`; with no
    `out`, return `result`.  `out` is a tensor, or a host array (numpy,
    a host `ndarray`) in which the result lands with one copy from
    whatever device it is on, lowered to `out`'s type: complex results
    to complex-integer (re, im) storage, 8-bit values to packed bytes."""
    if out is None:
        return result
    if isinstance(out, torch.Tensor):
        out.copy_(result)
        return out
    dt = out.bf.dtype if isinstance(out, ndarray) else \
        DataType(np.asarray(out).dtype)
    if dt.is_complex and dt.is_integer and result.is_complex():
        result = storage_view(result, dt if dt.nbit >= 8 else
                              dt.as_nbit(8))
    if dt.nbit < 8:
        from .quantize import _pack_bits
        result = _pack_bits(result, dt)
    copy_array(out, result.reshape(_storage_shape(out)))
    return out


def _storage_shape(out):
    """The tensor shape of a host array's bytes (a complex-integer host
    array gains its (re, im) axis)."""
    a = np.asarray(out)
    return a.shape + (2,) if a.dtype.names is not None else a.shape
