"""Quantize block (counterpart of bifrost_tpu/blocks/quantize.py;
reference python/bifrost/blocks/quantize.py): float -> integer storage
(packed for sub-byte types) through the planned `ops.quantize.Quantize`
op.

``fused_output_form = "storage"``: the stage hands on ring storage form
(packed bytes, (re, im) int8 pairs).  A fused stage's input is ring
storage in the port, so the next stage takes it as its ring read would;
a sub-byte real output folds several values a byte, which the next
stage's header shape cannot hold, so such a quantize may end a fused
group but not extend one (fuse.py, ``dtype_incompatible``).
"""

from __future__ import annotations

from ..DataType import DataType
from ..ops.quantize import Quantize, lift
from ..pipeline import TransformBlock
from ._common import deepcopy_header, store


class QuantizeBlock(TransformBlock):

    fused_output_form = "storage"

    def __init__(self, iring, dtype, scale=1.0, *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        self.dtype = str(DataType(dtype))
        self.scale = scale
        self.plan = Quantize(self.dtype, scale)

    def on_sequence(self, iseq):
        ihdr = iseq.header
        self._itype = DataType(ihdr["_tensor"]["dtype"])
        ohdr = deepcopy_header(ihdr)
        ohdr["_tensor"]["dtype"] = self.dtype
        return ohdr

    def on_data(self, ispan, ospan):
        store(ospan, self.device_kernel()(ispan.data))

    def device_kernel(self):
        """Ring input -> the output's storage form (a fused stage's
        function, and the gulp's)."""
        itype = self._itype
        fn = self.plan.traceable(itype.is_complex)
        return lambda x: fn(lift(x, itype))

    def plan_report(self):
        """The plan's uniform ops-runtime accounting."""
        return self.plan.plan_report()


def quantize(iring, dtype, scale=1.0, *args, **kwargs):
    """Quantize data to a lower-precision (possibly packed) integer dtype
    (reference blocks/quantize.py)."""
    return QuantizeBlock(iring, dtype, scale, *args, **kwargs)
