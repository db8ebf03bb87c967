"""Scrunch block: average `factor` frames into one (counterpart of
bifrost_tpu/blocks/scrunch.py; reference python/bifrost/blocks/
scrunch.py).  The mean is the sum times the f32 reciprocal of `factor`,
as XLA compiles the JAX block's `jnp.mean`."""

from __future__ import annotations

from ..ops.reduce import reduce_to
from ..pipeline import TransformBlock
from ._common import deepcopy_header, store


class ScrunchBlock(TransformBlock):
    def __init__(self, iring, factor, *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        if not isinstance(factor, int):
            raise TypeError("factor must be int")
        self.factor = factor

    def define_output_nframes(self, input_nframe):
        if input_nframe % self.factor:
            raise ValueError("Scrunch factor does not divide gulp size")
        return [input_nframe // self.factor]

    def on_sequence(self, iseq):
        ohdr = deepcopy_header(iseq.header)
        self.frame_axis = ohdr["_tensor"]["shape"].index(-1)
        if "scales" in ohdr["_tensor"] and ohdr["_tensor"]["scales"]:
            fax = self.frame_axis
            ohdr["_tensor"]["scales"][fax][1] *= self.factor
        return ohdr

    def on_data(self, ispan, ospan):
        x = ispan.data
        out_nframe = ispan.nframe // self.factor
        oshape = list(x.shape)
        oshape[self.frame_axis] = out_nframe
        store(ospan, reduce_to(x, tuple(oshape), "mean"))
        return out_nframe


def scrunch(iring, factor, *args, **kwargs):
    """Average `factor` incoming frames into one output frame
    (reference blocks/scrunch.py:40-87)."""
    return ScrunchBlock(iring, factor, *args, **kwargs)
