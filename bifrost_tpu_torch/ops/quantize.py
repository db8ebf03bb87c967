"""Quantization: float -> integer with a scale and a clip, down to 1/2/4-bit
packed storage (counterpart of bifrost_tpu/ops/quantize.py; reference
src/quantize.cpp, guantize.cu).

Values are scaled, rounded, clipped to the output type's range and, for
sub-byte outputs, packed MSB-first into uint8 bytes: the inverse of
ops.unpack.  Complex outputs (ci4/ci8/...) quantize re and im apart.  The
rounding is the JAX code's `jnp.round`, half to even (-2.5 -> -2, 0.5 ->
0, 2.5 -> 2; its comment says half away from zero), which `torch.round`
also does.  NaN becomes 0, as the JAX cast to int8 gives.  Plain torch
arithmetic: no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..DataType import DataType
from ..ndarray import complex_view, ndarray
from .runtime import OpRuntime


def _pack_bits(vals, dtype):
    """8-bit integer values -> packed uint8 storage (MSB-first).  For a
    complex type the input's trailing (re, im) axis is interleaved
    first."""
    dt = DataType(dtype)
    nbit = dt.nbit
    per = 8 // nbit
    if dt.is_complex:
        vals = vals.reshape(vals.shape[:-2] + (vals.shape[-2] * 2,))
    n = vals.shape[-1]
    if n % per:
        raise ValueError(f"last axis ({n}) not divisible by {per}")
    if vals.dtype == torch.int8:
        vals = vals.view(torch.uint8)
    fields = (vals & ((1 << nbit) - 1)).reshape(
        vals.shape[:-1] + (n // per, per)).to(torch.int64)
    shifts = torch.arange(per - 1, -1, -1, device=vals.device) * nbit
    return (fields << shifts).sum(-1).to(torch.uint8)


def _quantize_fn(odtype, complex_in):
    """The quantizer for output type `odtype` -> fn(x, scale) giving the
    output's storage form (packed bytes, (re, im) pairs or values)."""
    odt = DataType(odtype)
    nbit = odt.nbit
    if odt.is_signed:
        lo, hi = -(1 << (nbit - 1)), (1 << (nbit - 1)) - 1
    else:
        lo, hi = 0, (1 << nbit) - 1
    store = (torch.int8 if odt.is_signed else torch.uint8) if nbit <= 8 \
        else odt.as_torch_dtype()

    def q(x, scale):
        y = torch.round(x * scale).clamp(lo, hi)
        return torch.nan_to_num(y, nan=0.0).to(store)

    def fn(x, scale):
        if complex_in:
            y = torch.stack([q(x.real, scale), q(x.imag, scale)], dim=-1)
        else:
            y = q(x, scale)
        return _pack_bits(y, odt) if nbit < 8 else y

    return fn


def _logical(src):
    """A float input -> a tensor (numpy moves to a CPU tensor)."""
    if isinstance(src, torch.Tensor):
        return src
    return torch.from_numpy(np.ascontiguousarray(np.asarray(src)))


class Quantize(object):
    """Planned quantize op on the ops runtime (the JAX `Quantize`):
    executors cached per (method, output dtype, input complexity,
    scale) with the uniform `plan_report()`; `traceable()` is the stage
    function a fused chain calls, producing the storage form the
    unfused block commits to its ring."""

    def __init__(self, dtype, scale=1.0):
        odt = DataType(dtype)
        if not odt.is_integer:
            raise ValueError(f"quantize output must be integer, got {odt}")
        self.dtype = str(odt)
        self.scale = float(scale)
        self.runtime = OpRuntime("quantize", ("torch",), default="torch")

    def traceable(self, complex_in):
        """x -> storage form, the scale bound (the same function object
        for the plan's life)."""
        method = self.runtime.resolve_method(None)
        scale = self.scale

        def build():
            fn = _quantize_fn(self.dtype, bool(complex_in))
            return lambda x: fn(x, scale)
        return self.runtime.plan(
            (method, self.dtype, bool(complex_in), scale), build,
            method=method, origin="host")

    def execute(self, src):
        """src (float or complex float) -> storage form for the plan's
        dtype (bitwise `quantize_to`)."""
        x = _logical(src)
        return self.traceable(x.is_complex())(x)

    def plan_report(self):
        rep = self.runtime.report()
        rep.update({"dtype": self.dtype, "scale": self.scale})
        return rep


def quantize_to(src, odtype, scale=1.0):
    """Functional form: -> the storage tensor of `src` quantized to
    `odtype`."""
    x = _logical(src)
    return _quantize_fn(odtype, x.is_complex())(x, float(scale))


def quantize(src, dst, scale=1.0, dtype=None):
    """Quantize float `src` into integer `dst` (reference quantize.py:41:
    quantize(src, dst, scale)): a storage tensor, or a numpy array of the
    JAX package's host form.  `dtype` names dst's type (packed and
    complex types need it; a host `ndarray` dst defaults to its `.bf`
    dtype, a numpy dst to its own dtype)."""
    if dtype is None and isinstance(dst, ndarray):
        dtype = dst.bf.dtype
    if dtype is None:
        if isinstance(dst, torch.Tensor):
            raise ValueError("quantize: name dst's dtype for a tensor dst")
        dtype = DataType(np.asarray(dst).dtype)
    odt = DataType(dtype)
    if not odt.is_integer:
        raise ValueError(f"quantize output must be integer, got {odt}")
    res = quantize_to(src, odt, scale)
    if isinstance(dst, torch.Tensor):
        return dst.copy_(res.reshape(dst.shape))
    raw = np.asarray(dst).view(np.uint8)
    raw[...] = res.cpu().numpy().view(np.uint8).reshape(raw.shape)
    return dst


def lift(x, dtype):
    """A quantize block's ring input as float: complex integers lift to
    complex64, everything else is used as it is."""
    dt = DataType(dtype)
    if dt.is_complex and dt.is_integer:
        return complex_view(x, dt)
    return x if x.is_floating_point() or x.is_complex() else x.float()
