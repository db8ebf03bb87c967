"""Beamform plan: per-channel weighted station sums with fused detect and
time integration, the B engine of an FX beamformer (counterpart of the
single-device part of bifrost_tpu/ops/beamform.py).

Math: per channel c, ``beam[t, c, b] = sum_i w[b, i] * x[t, c, i]`` (no
conjugation of w: the caller bakes conjugate phases into the weights),
detected and integrated to ``p[b, c] = sum_t |beam[t, c, b]|**2`` f32.

Methods (the `beamform_method` config flag when None/'auto'):

- 'cuda' (what 'auto' resolves to): kernel K4 (ops/beamform_kernel.py,
  csrc/beamform.cu) for a CUDA tensor, its plain version for a CPU one.
- 'plain': the plain PyTorch version on any device.

The two are bitwise equal.  Against the JAX package's time-tiled
four-real-matmul form they agree bitwise where every partial sum is an
integer below 2**24, else to a tolerance (ops/beamform_kernel.py).

The JAX plan pads stations and beams to the 128-lane tile and channels
to 8 rows for Mosaic (`_geom`, `_pad_weights_fn`); the kernel here needs
no padding, so none of that is ported.  Weights are staged to the device
once per `set_weights` (once per block sequence) as one (nbeam, nsp)
complex64 tensor.  ``execute_raw`` takes ci8 ring storage in header axis
order and hands it to the kernel at 2 B/sample after at most one
transpose; packed ci4 storage is unpacked to that form first.  The mesh
variants (station tensor parallelism, beam sharding) live in
blocks/beamform.py, which runs this plan's engine shard by shard.
"""

from __future__ import annotations

import numpy as np
import torch

from ..DataType import DataType
from .beamform_kernel import beamform_power, beamform_power_plain
from .common import finalize
from .runtime import OpRuntime
from .unpack import unpack_pairs


def tiled_power(x, w, method="cuda"):
    """Single-device beamform-detect-integrate: x (ntime, nchan, nsp)
    complex64 or ci8 storage (ntime, nchan, nsp, 2), w (nbeam, nsp)
    complex64 on x's device -> (nbeam, nchan) f32.  The JAX function takes
    (re, im) planes padded to the TPU tiles; here the kernel reads the
    complex (or int8 pair) storage as it lies."""
    if method == "cuda":
        return beamform_power(x, w)
    if method == "plain":
        return beamform_power_plain(x, w)
    raise ValueError(f"beamform: unknown method {method!r}")


class Beamform(object):
    """Plan API: ``init(weights, method=)``, ``set_weights``, ``execute``
    / ``execute_raw``, ``plan_report``.  ``method``: None/'auto' (the
    `beamform_method` flag, else 'cuda'), 'cuda' or 'plain'."""

    def __init__(self):
        self.method = "auto"
        self.weights = None          # staged (nbeam, nsp) complex64
        self.nbeam = None
        self.nsp = None
        self.weights_origin = None   # 'host' | 'device'
        self._runtime = OpRuntime("beamform", ("cuda", "plain"),
                                  config_flag="beamform_method",
                                  default="cuda")

    def init(self, weights, method=None, device=None):
        if method is not None:
            self.method = method
        self.set_weights(weights, device=device)
        return self

    def set_weights(self, weights, device=None):
        """Stage the (nbeam, nstation[, npol]) complex weights on `device`
        (default: the weights' own device for a tensor, the CPU for numpy)
        as one contiguous (nbeam, nsp) complex64 tensor: one H2D per call
        (per block sequence), not one per gulp."""
        if isinstance(weights, torch.Tensor):
            origin = "device" if weights.is_cuda else "host"
            w = weights
        else:
            origin = "host"
            w = torch.from_numpy(np.asarray(weights, dtype=np.complex64))
        if w.dim() == 3:
            w = w.reshape(w.shape[0], -1)
        if w.dim() != 2:
            raise ValueError(f"weights must be (nbeam, nstation[, npol]); "
                             f"got {tuple(weights.shape)}")
        device = w.device if device is None else torch.device(device)
        self.weights = w.to(device=device, dtype=torch.complex64) \
            .contiguous()
        self.nbeam, self.nsp = int(w.shape[0]), int(w.shape[1])
        self.weights_origin = origin

    def _resolve(self):
        return self._runtime.resolve_method(self.method)

    def _weights_on(self, device):
        if self.weights.device != device:
            self.weights = self.weights.to(device)
        return self.weights

    def _power(self, x):
        method = self._resolve()
        self._runtime.last_method = method
        self._runtime.last_origin = self.weights_origin
        return tiled_power(x, self._weights_on(x.device), method)

    def execute(self, idata, odata=None):
        """Logical gulp (ntime, nchan, nsp), complex or real, or a batch
        of them (batch, ntime, nchan, nsp) -> integrated (nbeam, nchan)
        (or (batch, nbeam, nchan)) f32 beam powers."""
        x = idata if isinstance(idata, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(idata))
        if x.dim() not in (3, 4):
            raise ValueError(f"beamform expects (ntime, nchan, nsp) or a "
                             f"leading batch axis, got shape "
                             f"{tuple(x.shape)}")
        # Real voltages take a zero imaginary part (exact).
        x = x.to(torch.complex64).contiguous()
        res = self._power(x) if x.dim() == 3 else \
            torch.stack([self._power(xb) for xb in x])
        return finalize(res, out=odata)

    def execute_raw(self, raw, dtype, perm=(0, 1, 2, 3)):
        """Raw ring storage in header axis order: packed ci4 (4 logical
        axes) or ci8 (4 logical axes and the trailing (re, im) axis); ``perm`` takes it to (time, freq,
        station, pol).  -> (nbeam, nchan) f32."""
        dt = DataType(dtype)
        if not (dt.is_complex and dt.is_integer):
            raise ValueError(f"beamform: execute_raw expects a "
                             f"complex-integer dtype, got {dt}")
        if dt.nbit == 4:
            # Packed ci4 becomes its ci8 pair form, which K4 reads as is.
            raw = unpack_pairs(raw, dt)
        elif dt.nbit != 8:
            raise ValueError(f"beamform: execute_raw takes ci4 or ci8 "
                             f"storage, got {dt}")
        perm = tuple(perm)
        if perm != (0, 1, 2, 3):
            raw = raw.permute(perm + (4,))
        t, c = raw.shape[0], raw.shape[1]
        return self._power(raw.contiguous().reshape(t, c, -1, 2))

    def plan_report(self):
        """Uniform runtime accounting (ops/runtime.py schema) + the
        beamform plan-state tail."""
        rep = self._runtime.report()
        rep.update({"nbeam": self.nbeam, "nsp": self.nsp,
                    "weights_origin": self.weights_origin})
        return rep
