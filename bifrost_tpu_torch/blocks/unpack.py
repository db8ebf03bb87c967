"""Unpack block (counterpart of bifrost_tpu/blocks/unpack.py; reference
python/bifrost/blocks/unpack.py): packed 1/2/4-bit storage -> its 8-bit
type, through the planned `ops.unpack.Unpack` op.

A ring read hands the packed uint8 storage as it lies, on a 'cuda' ring
and a host ring alike, and the block writes the 8-bit storage form ((re,
im) int8 pairs for ci4) through the plan's `storage()` executor, so
`plan_report()` counts every gulp.  `device_kernel()` gives a fused group
the same executor; a fused stage's input is ring storage, so an unpack
may follow any stage in a group.
"""

from __future__ import annotations

from ..DataType import DataType
from ..ops.unpack import Unpack
from ..pipeline import TransformBlock
from ._common import deepcopy_header, store


class UnpackBlock(TransformBlock):
    def __init__(self, iring, dtype=None, align_msb=False, *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        self.dtype = dtype
        self.align_msb = align_msb
        self.plan = None

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itype = DataType(ihdr["_tensor"]["dtype"])
        otype = itype.as_nbit(8) if self.dtype is None \
            else DataType(self.dtype)
        self.plan = Unpack(str(itype), align_msb=self.align_msb)
        ohdr = deepcopy_header(ihdr)
        ohdr["_tensor"]["dtype"] = str(otype)
        return ohdr

    def on_data(self, ispan, ospan):
        store(ospan, self.plan.storage()(ispan.data))

    def device_kernel(self):
        """Packed storage -> the 8-bit storage form (a fused stage's
        function, and the gulp's)."""
        return self.plan.storage()

    def plan_report(self):
        """The plan's uniform ops-runtime accounting."""
        return self.plan.plan_report()


def unpack(iring, dtype=None, align_msb=False, *args, **kwargs):
    """Unpack 1/2/4-bit data to 8-bit (reference blocks/unpack.py:44-83)."""
    return UnpackBlock(iring, dtype, align_msb, *args, **kwargs)
