"""Reduce block: reduce along an axis by a factor with a named op
(counterpart of bifrost_tpu/blocks/reduce.py; reference
python/bifrost/blocks/reduce.py), on `ops.reduce`.  On the frame axis
the block emits input_nframe / factor frames a gulp."""

from __future__ import annotations

from ..DataType import DataType
from ..ndarray import complex_view
from ..ops.reduce import reduce_to
from ..pipeline import TransformBlock
from ._common import deepcopy_header, store


class ReduceBlock(TransformBlock):
    def __init__(self, iring, axis, factor=None, op="sum", *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        self.specified_axis = axis
        self.specified_factor = factor
        self.op = op

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        ohdr = deepcopy_header(ihdr)
        otensor = ohdr["_tensor"]
        itype = DataType(itensor["dtype"])
        self._idtype = itype
        otensor["dtype"] = "f32"
        if itype.is_complex and not self.op.startswith("pwr"):
            otensor["dtype"] = "cf32"
        labels = itensor.get("labels")
        if labels and isinstance(self.specified_axis, str):
            self.axis = labels.index(self.specified_axis)
        else:
            self.axis = self.specified_axis
        self.frame_axis = itensor["shape"].index(-1)
        self.factor = self.specified_factor
        if self.axis == self.frame_axis:
            if self.factor is None:
                raise ValueError("Reduce factor must be specified for frame "
                                 "axis")
        else:
            if self.factor is None:
                self.factor = otensor["shape"][self.axis]
            elif otensor["shape"][self.axis] % self.factor:
                raise ValueError("Reduce factor does not divide axis length")
            otensor["shape"][self.axis] //= self.factor
        if "scales" in otensor and otensor["scales"]:
            otensor["scales"][self.axis][1] *= self.factor
        return ohdr

    def define_output_nframes(self, input_nframe):
        if self.axis == self.frame_axis:
            if input_nframe % self.factor:
                raise ValueError("Reduce factor does not divide input_nframe")
            return [input_nframe // self.factor]
        return [input_nframe]

    def _reduce(self, x):
        dt = self._idtype
        if dt.is_complex and dt.is_integer:
            x = complex_view(x, dt)
        oshape = list(x.shape)
        oshape[self.axis] = oshape[self.axis] // self.factor
        return reduce_to(x, tuple(oshape), self.op)

    def on_data(self, ispan, ospan):
        store(ospan, self._reduce(ispan.data))

    def device_kernel(self):
        """The stage function for a fused group (fuse.py)."""
        return self._reduce


def reduce(iring, axis, factor=None, op="sum", *args, **kwargs):
    """Reduce data along an axis by `factor` using `op`
    (reference blocks/reduce.py:92-128)."""
    return ReduceBlock(iring, axis, factor, op, *args, **kwargs)
