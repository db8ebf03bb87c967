"""Batched N-D FFT plans (counterpart of bifrost_tpu/ops/fft.py; reference
src/fft.cu, python/bifrost/fft.py), on torch.fft: cuFFT on the card,
pocketfft on the CPU.

The transform follows the JAX package's dtype-driven dispatch and shift
placement (ops/fft.py:53-107): c2c forward applies fftshift to the
output; the inverse is unnormalised (cuFFT semantics) and applies
ifftshift to the input; r2c is forward only; c2r is the unnormalised
inverse, whose requested shift is a (-1)^m modulation of the real output
per transformed axis (even lengths only).

`fft_method` ('auto' reads the config flag): 'torch' is the only engine.
The JAX engines 'xla' (XLA's FFT) and 'matmul'/'matmul_f32'/'matmul_int8'
(ops/fft_mxu.py, a DFT on the TPU's matrix unit) are TPU methods and
raise.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..DataType import DataType
from .common import finalize, prepare
from .fftshift import fftshift
from .runtime import OpRuntime

FFT_METHODS = ("torch",)
_TPU_METHODS = ("xla", "matmul", "matmul_f32", "matmul_int8")


def resolve_method(method):
    """None/'auto' -> the `fft_method` config flag (default 'torch'),
    validated; the JAX package's TPU engines raise with the reason."""
    if method in _TPU_METHODS:
        raise ValueError(
            f"fft: method {method!r} is a TPU engine of the JAX package "
            f"(XLA's FFT or the MXU DFT of ops/fft_mxu.py); the port's FFT "
            f"is torch.fft, cuFFT on the card ('auto' or 'torch')")
    return OpRuntime("fft", FFT_METHODS, config_flag="fft_method",
                     default="torch").resolve_method(method)


def transform(x, axes, kind, inverse=False, apply_fftshift=False,
              real_out_n=None):
    """The FFT of `x` over `axes`: kind 'c2c', 'r2c' or 'c2r'
    (`real_out_n`: the real output lengths of a c2r)."""
    axes = tuple(axes)
    if kind == "r2c":
        y = torch.fft.rfftn(x, dim=axes)
        return fftshift(y, axes) if apply_fftshift else y
    if kind == "c2r":
        if apply_fftshift and any(n % 2 for n in real_out_n):
            raise NotImplementedError(
                "c2r with apply_fftshift requires even transform lengths")
        y = torch.fft.irfftn(x, s=real_out_n, dim=axes, norm="forward")
        if apply_fftshift:
            for a, n in zip(axes, real_out_n):
                mod = 1.0 - 2.0 * (torch.arange(n, device=y.device) % 2)
                shape = [1] * y.dim()
                shape[a] = n
                y = y * mod.to(y.dtype).view(shape)
        return y
    if inverse:
        if apply_fftshift:
            x = fftshift(x, axes, inverse=True)
        return torch.fft.ifftn(x, dim=axes, norm="forward")
    y = torch.fft.fftn(x, dim=axes)
    return fftshift(y, axes) if apply_fftshift else y


def _logical_info(arr):
    """-> (DataType, logical shape) of an op's array: a tensor's storage
    type and shape, a host `ndarray`'s `.bf` type and logical shape,
    numpy's own; nothing moves."""
    from ..ndarray import _TORCH_BF, ndarray
    if isinstance(arr, torch.Tensor):
        return DataType(_TORCH_BF[arr.dtype]), tuple(arr.shape)
    if isinstance(arr, ndarray):
        return arr.bf.dtype, tuple(arr.logical_shape)
    a = np.asarray(arr)
    return DataType(a.dtype), tuple(a.shape)


def _norm_axes(axes, ndim):
    if axes is None:
        axes = list(range(ndim))
    if isinstance(axes, int):
        axes = [axes]
    return tuple(int(a) % ndim for a in axes)


class Fft(object):
    """Plan object (counterpart of the JAX `Fft`): the transform's `axes`,
    `kind` ('c2c', 'r2c', 'c2r'), `apply_fftshift` and c2r output
    lengths, set by `init(iarray, oarray, axes, apply_fftshift)` from the
    arrays' types as the JAX plan sets them, or by its block
    (blocks/fft.py); ``execute`` runs the transform, its function cached
    on the runtime per (method, geometry), and ``plan_report`` gives the
    runtime schema."""

    def __init__(self, method=None):
        self.axes = None
        self.kind = None
        self.apply_fftshift = False
        self.workspace_size = 0   # torch.fft manages cuFFT's workspace
        self.method = resolve_method(method)
        self.runtime = OpRuntime("fft", FFT_METHODS,
                                 config_flag="fft_method", default="torch")
        self._real_out_n = None

    def init(self, iarray, oarray, axes=None, apply_fftshift=False):
        """Plan the transform of `iarray` into `oarray` over `axes`: r2c
        for real input and complex output, c2r for the reverse, else c2c
        (bifrost_tpu/ops/fft.py:158-184).  -> the workspace size, 0."""
        idt, ishape = _logical_info(iarray)
        odt, oshape = _logical_info(oarray)
        self.axes = _norm_axes(axes, len(ishape))
        if not idt.is_complex and odt.is_complex:
            self.kind = "r2c"
        elif idt.is_complex and not odt.is_complex:
            self.kind = "c2r"
            self._real_out_n = tuple(oshape[a] for a in self.axes)
        else:
            self.kind = "c2c"
        self.apply_fftshift = bool(apply_fftshift)
        if (self.kind == "c2r" and self.apply_fftshift
                and any(n % 2 for n in self._real_out_n)):
            raise NotImplementedError(
                "c2r with apply_fftshift requires even transform lengths")
        return self.workspace_size

    def execute(self, iarray, oarray=None, inverse=False):
        x = prepare(iarray)
        key = (self.method, self.axes, self.kind, self.apply_fftshift,
               bool(inverse), self._real_out_n)
        fn = self.runtime.plan(
            key, lambda: functools.partial(
                transform, axes=self.axes, kind=self.kind,
                inverse=bool(inverse), apply_fftshift=self.apply_fftshift,
                real_out_n=self._real_out_n),
            method=self.method, origin="host")
        return finalize(fn(x), out=oarray)

    def execute_workspace(self, iarray, oarray, workspace_ptr=None,
                          workspace_size=0, inverse=False):
        """`execute`; torch.fft needs no caller workspace."""
        return self.execute(iarray, oarray, inverse=inverse)

    def plan_report(self):
        rep = self.runtime.report()
        rep.update({"kind": self.kind, "axes": self.axes,
                    "apply_fftshift": bool(self.apply_fftshift)})
        return rep


def fft(iarray, oarray=None, axes=None, apply_fftshift=False, inverse=False,
        method=None):
    """One-shot FFT (bifrost_tpu/ops/fft.py:227): into `oarray` when
    given, else -> a new tensor on the input's device (c2c for complex
    input, r2c for real)."""
    plan = Fft(method=method)
    if oarray is None:
        idt, ishape = _logical_info(iarray)
        plan.axes = _norm_axes(axes, len(ishape))
        plan.kind = "c2c" if idt.is_complex else "r2c"
        plan.apply_fftshift = bool(apply_fftshift)
    else:
        plan.init(iarray, oarray, axes, apply_fftshift)
    return plan.execute(iarray, oarray, inverse=inverse)
