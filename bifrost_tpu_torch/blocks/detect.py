"""Detect block: square-law polarization detection (counterpart of
bifrost_tpu/blocks/detect.py; reference python/bifrost/blocks/detect.py):
'scalar' (|x|^2), 'jones' (xx + i yy, x conj(y)) or 'stokes' (I, Q, U,
V) over a pol axis of length 2.  The JAX block computes these in jnp
(no Pallas kernel); here they are elementwise torch ops on the real and
imaginary parts, the arithmetic of `real(x * conj(y))` spelled out."""

from __future__ import annotations

import torch

from ..DataType import DataType
from ..ndarray import complex_view
from ..pipeline import TransformBlock
from ._common import deepcopy_header


def _power(x):
    return x.real * x.real + x.imag * x.imag


def detect_fn(x, mode, axis, npol, out):
    """Detect complex `x` (logical form) over its pol `axis` into the
    tensor `out`."""
    if mode == "scalar" or npol == 1:
        out.copy_(_power(x))
        return out
    xp, yp = x.select(axis, 0), x.select(axis, 1)
    xx, yy = _power(xp), _power(yp)
    # xy = xp * conj(yp)
    re = xp.real * yp.real + xp.imag * yp.imag
    im = xp.imag * yp.real - xp.real * yp.imag
    if mode == "jones":
        parts = [torch.complex(xx, yy), torch.complex(re, im)]
    elif mode == "stokes":
        parts = [xx + yy, xx - yy, 2 * re, -2 * im]
    else:
        raise ValueError(f"bad detect mode {mode}")
    for i, p in enumerate(parts):
        out.select(axis, i).copy_(p)
    return out


class DetectBlock(TransformBlock):
    def __init__(self, iring, mode, axis=None, *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        self.specified_axis = axis
        self.mode = mode.lower()

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        itype = DataType(itensor["dtype"])
        if not itype.is_complex:
            raise TypeError("Input data must be complex")
        self._idtype = itype
        self.axis = self.specified_axis
        labels = itensor.get("labels")
        if labels is None and self.axis is None and self.mode != "scalar":
            raise TypeError("Polarization axis must be labelled 'pol' or set "
                            "manually")
        if self.axis is None and self.mode != "scalar" and labels and \
                "pol" in labels:
            self.axis = labels.index("pol")
        elif isinstance(self.axis, str):
            self.axis = labels.index(self.axis)
        ohdr = deepcopy_header(ihdr)
        otensor = ohdr["_tensor"]
        if self.axis is not None:
            self.npol = otensor["shape"][self.axis]
            if self.npol not in (1, 2):
                raise ValueError("Axis must have length 1 or 2")
            if self.mode == "stokes" and self.npol == 2:
                otensor["shape"][self.axis] = 4
            if "labels" in otensor and otensor["labels"] is not None:
                otensor["labels"][self.axis] = "pol"
        else:
            self.npol = 1
        if self.mode == "jones" and self.npol == 2:
            otype = itype
        else:
            otype = itype.as_real()
        otensor["dtype"] = str(otype.as_floating_point())
        self._oshape = list(otensor["shape"])
        self._otorch = DataType(otensor["dtype"]).as_torch_dtype()
        return ohdr

    def _detect(self, x, out=None):
        if self._idtype.is_integer:
            x = complex_view(x, self._idtype)
        if out is None:
            shape = list(x.shape)
            if self.axis is not None:
                shape[self.axis] = self._oshape[self.axis]
            out = torch.empty(shape, dtype=self._otorch, device=x.device)
        return detect_fn(x, self.mode if self.npol == 2 else "scalar",
                         self.axis if self.axis is not None else 0,
                         self.npol, out=out)

    def on_data(self, ispan, ospan):
        self._detect(ispan.data, out=ospan.data)

    def device_kernel(self):
        """The stage function for a fused group (fuse.py)."""
        return self._detect


def detect(iring, mode, axis=None, *args, **kwargs):
    """Square-law detect: scalar (|x|^2), jones, or stokes products
    (reference blocks/detect.py:126-147)."""
    return DetectBlock(iring, mode, axis, *args, **kwargs)
