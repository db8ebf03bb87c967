"""Reverse block: flip the data along axes and negate each axis's scale
step (counterpart of bifrost_tpu/blocks/reverse.py; reference
python/bifrost/blocks/reverse.py)."""

from __future__ import annotations

import torch

from ..pipeline import TransformBlock
from ._common import deepcopy_header, store


class ReverseBlock(TransformBlock):
    def __init__(self, iring, axes, *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        self.specified_axes = axes if isinstance(axes, (list, tuple)) \
            else [axes]

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        self.axes = [itensor["labels"].index(ax) if isinstance(ax, str)
                     else ax for ax in self.specified_axes]
        frame_axis = itensor["shape"].index(-1)
        if frame_axis in self.axes:
            raise ValueError("cannot reverse the frame axis")
        ohdr = deepcopy_header(ihdr)
        otensor = ohdr["_tensor"]
        if "scales" in otensor and otensor["scales"] is not None:
            for ax in self.axes:
                n = itensor["shape"][ax]
                off, step = otensor["scales"][ax]
                otensor["scales"][ax] = [off + step * (n - 1), -step]
        return ohdr

    def on_data(self, ispan, ospan):
        store(ospan, torch.flip(ispan.data, dims=tuple(self.axes)))


def reverse(iring, axes, *args, **kwargs):
    """Reverse the data along the given axes (reference blocks/reverse.py)."""
    return ReverseBlock(iring, axes, *args, **kwargs)
