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

import torch

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


class Fft(object):
    """Plan object (counterpart of the JAX `Fft`): the transform's `axes`,
    `kind` ('c2c', 'r2c', 'c2r'), `apply_fftshift` and c2r output
    lengths are set by its block (blocks/fft.py); ``execute`` runs the
    transform, ``plan_report`` gives the runtime schema."""

    def __init__(self, method=None):
        self.axes = None
        self.kind = None
        self.apply_fftshift = False
        self.method = resolve_method(method)
        self.runtime = OpRuntime("fft", FFT_METHODS,
                                 config_flag="fft_method", default="torch")
        self._real_out_n = None

    def execute(self, iarray, oarray=None, inverse=False):
        x = prepare(iarray)
        self.runtime.last_method = self.method
        self.runtime.last_origin = "host"
        y = transform(x, self.axes, self.kind, inverse, self.apply_fftshift,
                      self._real_out_n)
        return finalize(y, out=oarray)

    def plan_report(self):
        rep = self.runtime.report()
        rep.update({"kind": self.kind, "axes": self.axes,
                    "apply_fftshift": bool(self.apply_fftshift)})
        return rep
