"""Complex gain calibration plan and the weight-plane fold helpers of the
B/X engines (counterpart of bifrost_tpu/ops/calibrate.py:40-254).

A calibrated stream is x' = g * x with one complex gain per cell (often
per station).  Two ways there:

- `GainCal`, a planned op that multiplies the samples themselves, kernel
  K5b (ops/dq_kernel.py), for chains whose downstream stages have no
  weight plane (blocks/calibrate.py).
- `fold_gains`: beamforming is b = sum_s w_s x_s, so calibrating the
  input equals staging w'_s = w_s g_s; the same helper zeroes flagged
  stations (mask True = flagged).  `gain_outer` is the X-engine's
  conj(g_i) g_j plane.

Methods (the `dq_cal_method` config flag when None/'auto'): 'cuda' (what
'auto' resolves to; K5b for a CUDA tensor, its plain version for a CPU
tensor) and 'plain' (the plain version on any device); the two are
bitwise equal.  A real stream takes the real gain part only, as the
JAX plan does (its samples are lifted to complex with a zero imaginary
part and the imaginary gain scaled by zero).  The numpy helpers are the
JAX package's, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from ..DataType import DataType
from . import dq_kernel
from .common import prepare
from .runtime import OpRuntime, staged_unpack


def fold_gains(weights, gains=None, mask=None):
    """Fold per-element complex gains and/or a boolean flag mask into a
    (nbeam, nelement) weight plane: w' = w * g * (mask ? 0 : 1)."""
    w = np.asarray(weights, dtype=np.complex64)
    if gains is not None:
        g = np.asarray(gains, dtype=np.complex64).reshape(-1)
        if g.size != w.shape[-1]:
            raise ValueError(
                f"fold_gains: {g.size} gain(s) for {w.shape[-1]} "
                f"weight element(s)")
        w = w * g[None, :]
    if mask is not None:
        m = np.asarray(mask, dtype=bool).reshape(-1)
        if m.size != w.shape[-1]:
            raise ValueError(
                f"fold_gains: {m.size} mask element(s) for "
                f"{w.shape[-1]} weight element(s)")
        w = w * (~m)[None, :].astype(np.complex64)
    return w.astype(np.complex64)


def gain_outer(gains):
    """The X-engine's visibility-plane fold: conj(g_i) g_j as a dense
    (n, n) complex64 plane."""
    g = np.asarray(gains, dtype=np.complex64).reshape(-1)
    return (np.conj(g)[:, None] * g[None, :]).astype(np.complex64)


def decode_gains(obj):
    """A header-borne gain table ("cal_gains"): a list of [re, im] pairs
    or an array-like of complexes -> (n,) complex64."""
    arr = np.asarray(obj)
    if arr.ndim == 2 and arr.shape[-1] == 2 and \
            not np.iscomplexobj(arr):
        return (arr[:, 0] + 1j * arr[:, 1]).astype(np.complex64)
    return arr.reshape(-1).astype(np.complex64)


def resolve_gains(gains, gain_callback, header, header_key="cal_gains"):
    """The B/X engines' per-sequence gain resolution: the block's table,
    then `gain_callback(header)`, then the header's `header_key` table
    unless an upstream GainCalBlock stamped ``cal_applied`` (a table
    must not fold twice) -> (n,) complex64, or None when uncalibrated."""
    if gains is not None:
        return gains
    if gain_callback is not None:
        g = gain_callback(header)
        if g is not None:
            return decode_gains(g)
    if not header.get("cal_applied"):
        g = header.get(header_key)
        if g is not None:
            return decode_gains(g)
    return None


def encode_gains(gains):
    """Inverse of `decode_gains`: (n,) complex -> a JSON-safe list of
    [re, im] pairs."""
    g = np.asarray(gains, dtype=np.complex64).reshape(-1)
    return [[float(v.real), float(v.imag)] for v in g]


class GainCal(object):
    """Plan API of the JAX `GainCal`: init(gains), execute / execute_raw
    per gulp, set_gains, staged_gains, plan_report.  ``method``:
    None/'auto' (the `dq_cal_method` flag, else 'cuda'), 'cuda' or
    'plain'."""

    def __init__(self, method=None):
        self.gains = None           # (ncell,) complex64 host master copy
        self._dev_gains = None      # staged (ncell,) complex64 tensor
        self.method = method if method is not None else "auto"
        self._runtime = OpRuntime("calibrate", ("cuda", "plain"),
                                  config_flag="dq_cal_method",
                                  default="cuda")
        if method not in (None, "auto"):
            self._runtime.resolve_method(method)

    def init(self, gains=None, method=None):
        if gains is not None:
            self.set_gains(gains)
        if method is not None:
            self.method = method
        return self

    def set_gains(self, gains):
        """(ncell,) complex gains, one per flattened non-time cell.  The
        staged device copy is dropped only when the values change."""
        g = np.asarray(gains, dtype=np.complex64).reshape(-1)
        unchanged = self.gains is not None and \
            np.array_equal(g, self.gains)
        self.gains = g
        if not unchanged:
            self._dev_gains = None

    def staged_gains(self, device="cpu"):
        """The gains as one contiguous (ncell,) complex64 tensor on
        `device`, staged once per gain set."""
        if self.gains is None:
            raise ValueError("calibrate: set_gains first")
        device = torch.device(device)
        if self._dev_gains is None or self._dev_gains.device != device:
            self._dev_gains = torch.from_numpy(self.gains).to(device)
        return self._dev_gains

    def _resolve(self):
        return self._runtime.resolve_method(self.method)

    def _apply(self, x, g, out):
        method = self._resolve()
        self._runtime.last_method = method
        self._runtime.last_origin = "host"
        if method == "cuda":
            return dq_kernel.gain_apply(x, g, out)
        return dq_kernel.gain_apply_plain(x, g, out)

    def _gains_for(self, ncell, device):
        g = self.staged_gains(device)
        if g.shape[0] != ncell:
            raise ValueError(f"calibrate: {g.shape[0]} gain(s) for {ncell} "
                             f"stream cell(s)")
        return g

    def execute(self, idata, out=None):
        """Calibrate one logical gulp: (ntime, ...cell...) -> y with
        per-cell gains applied; complex input -> complex64, real input
        -> float32 (real gains).  `out`: a tensor of y's shape and dtype
        to write into (a ring span)."""
        x = prepare(idata)
        ntime = x.shape[0]
        xm = x.reshape(ntime, -1)
        g = self._gains_for(xm.shape[1], x.device)
        if x.is_complex():
            o = None if out is None else out.view(ntime, -1)
            y = self._apply(xm.to(torch.complex64), g, o)
            return out if out is not None else y.view(x.shape)
        x32 = xm.to(torch.float32)
        gr = torch.complex(g.real, g.imag * 0.0)
        y = self._apply(torch.complex(x32, torch.zeros_like(x32)), gr,
                        None).real.reshape(x.shape)
        return y.contiguous() if out is None else out.copy_(y)

    def execute_raw(self, raw, dtype, out=None):
        """Raw ring storage of a complex-integer gulp (time-first header
        order: packed ci4, or ci8 and wider) -> complex64 of the logical
        shape, unpacked with `staged_unpack` and then calibrated."""
        re, im = staged_unpack(raw, DataType(dtype))
        shape = re.shape
        ntime = shape[0]
        x = torch.complex(re.reshape(ntime, -1), im.reshape(ntime, -1))
        o = None if out is None else out.view(ntime, -1)
        y = self._apply(x, self._gains_for(x.shape[1], x.device), o)
        return out if out is not None else y.view(shape)

    def plan_report(self):
        """Uniform runtime accounting (ops/runtime.py schema) + the
        calibration plan tail."""
        rep = self._runtime.report()
        rep.update({"ngain": None if self.gains is None
                    else int(self.gains.size)})
        return rep


def calibrate(idata, gains, method=None):
    """One-shot gain application -> the calibrated gulp."""
    return GainCal(method=method).init(gains=gains).execute(idata)
