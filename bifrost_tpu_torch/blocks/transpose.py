"""Transpose block (counterpart of bifrost_tpu/blocks/transpose.py;
reference python/bifrost/blocks/transpose.py)."""

from __future__ import annotations

from ..pipeline import TransformBlock
from ..ops.transpose import transpose as bf_transpose
from ._common import deepcopy_header


class TransposeBlock(TransformBlock):
    def __init__(self, iring, axes, *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        self.specified_axes = list(axes)

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        # allow lookup by label
        self.axes = [itensor["labels"].index(ax) if isinstance(ax, str)
                     else ax for ax in self.specified_axes]
        ohdr = deepcopy_header(ihdr)
        otensor = ohdr["_tensor"]
        for key in ("shape", "labels", "scales", "units"):
            if key in itensor and itensor[key] is not None:
                otensor[key] = [itensor[key][a] for a in self.axes]
        return ohdr

    def on_data(self, ispan, ospan):
        # span tensors are in header axis order with the frame axis in
        # place, so the permutation applies directly
        bf_transpose(ospan.data, ispan.data, self.axes)

    def device_kernel(self):
        """The stage function for a fused group (fuse.py): the same
        permutation into a new contiguous tensor."""
        axes = list(self.axes)
        return lambda x: bf_transpose(None, x, axes)


def transpose(iring, axes, *args, **kwargs):
    """Transpose the data stream to a new axis order
    (reference blocks/transpose.py:57-97)."""
    return TransposeBlock(iring, axes, *args, **kwargs)
