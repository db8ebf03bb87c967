"""Bit unpacking: 1/2/4-bit packed storage -> 8-bit values (counterpart
of bifrost_tpu/ops/unpack.py; reference src/unpack.cpp, gunpack.cu).

Packed storage is uint8 with several values a byte, MSB-first; the
`align_msb` option leaves each value left-aligned in its byte (scaled by
2^(8-nbit)).  Signed types (i1/i2/i4, ci4) sign-extend with the
reference's shifts: the field is shifted up to the int8 MSB and
arithmetic-shifted back.  Plain torch bit arithmetic on uint8/int8, the
JAX package's jitted jnp expression: no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..DataType import DataType
from .runtime import OpRuntime


def _unpack_bits(raw, dtype, align_msb=False):
    """uint8 storage -> int8 (signed) or uint8 (unsigned) values; the
    last axis expands by 8 // nbit.  A complex type (ci4) comes out as
    interleaved re, im, which the caller regroups."""
    dt = DataType(dtype)
    nbit = dt.nbit
    per = 8 // nbit
    shifts = torch.arange(per - 1, -1, -1, dtype=torch.uint8,
                          device=raw.device) * nbit
    raw = raw.view(torch.uint8) if raw.dtype == torch.int8 else raw
    fields = (raw.unsqueeze(-1) >> shifts) & ((1 << nbit) - 1)
    fields = fields.reshape(raw.shape[:-1] + (raw.shape[-1] * per,))
    if dt.is_signed:
        up = (fields << (8 - nbit)).view(torch.int8)
        return up if align_msb else up >> (8 - nbit)
    return fields << (8 - nbit) if align_msb else fields


def unpack_pairs(raw, dtype, align_msb=False):
    """Packed complex storage (ci4) -> its int8 storage form with a
    trailing (re, im) axis of 2, the ci8 ring form."""
    vals = _unpack_bits(raw, dtype, align_msb)
    return vals.reshape(vals.shape[:-1] + (vals.shape[-1] // 2, 2))


def unpack_logical(raw, dtype, align_msb=False):
    """Packed uint8 storage -> logical values: complex64 for ci4, int8
    or uint8 for real types (left-aligned when align_msb)."""
    dt = DataType(dtype)
    if dt.is_complex:
        p = unpack_pairs(raw, dt, align_msb)
        return torch.complex(p[..., 0].float(), p[..., 1].float())
    return _unpack_bits(raw, dt, align_msb)


def _storage(x, dtype):
    """An input (tensor or numpy) -> its packed uint8 storage tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))
                            .view(np.uint8))


def unpack(src, dtype, dst=None, align_msb=False):
    """Unpack `src` (packed uint8 storage of `dtype`) -> the 8-bit
    storage form (int8/uint8 values; (re, im) int8 pairs for ci4), into
    `dst` when given (reference unpack.py:37: unpack(src, dst))."""
    dt = DataType(dtype)
    if dt.nbit >= 8:
        raise ValueError(f"unpack input must be <8-bit packed, got {dt}")
    raw = _storage(src, dt)
    res = unpack_pairs(raw, dt, align_msb) if dt.is_complex else \
        _unpack_bits(raw, dt, align_msb)
    if dst is None:
        return res
    dst.copy_(res.view(dst.dtype).reshape(dst.shape))
    return dst


class Unpack(object):
    """Planned unpack op on the ops runtime (the JAX `Unpack`): the
    executors cached per (method, packed dtype, align_msb, form), the
    uniform `plan_report()`, `traceable()`, the storage -> logical
    function, and `storage()`, the packed -> 8-bit storage function the
    unpack block runs on every gulp, fused or not."""

    def __init__(self, dtype, align_msb=False):
        dt = DataType(dtype)
        if dt.nbit >= 8:
            raise ValueError(f"unpack input must be <8-bit packed, got {dt}")
        self.dtype = str(dt)
        self.align_msb = bool(align_msb)
        self.runtime = OpRuntime("unpack", ("torch",), default="torch")

    def traceable(self):
        """Packed uint8 storage -> logical values (the same function
        object for the plan's life)."""
        return self._plan("logical", unpack_logical)

    def storage(self):
        """Packed uint8 storage -> the 8-bit storage form, (re, im) int8
        pairs for ci4 (the same function object for the plan's life)."""
        return self._plan("storage", unpack)

    def _plan(self, form, fn):
        method = self.runtime.resolve_method(None)
        dtype, align = self.dtype, self.align_msb
        return self.runtime.plan(
            (method, dtype, align, form),
            lambda: lambda raw: fn(raw, dtype, align_msb=align),
            method=method, origin="host")

    def execute(self, raw):
        """Packed storage gulp -> logical values."""
        return self.traceable()(raw)

    def plan_report(self):
        rep = self.runtime.report()
        rep.update({"dtype": self.dtype, "align_msb": self.align_msb})
        return rep
