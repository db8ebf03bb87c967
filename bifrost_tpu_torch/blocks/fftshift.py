"""FFT-shift block (counterpart of bifrost_tpu/blocks/fftshift.py;
reference python/bifrost/blocks/fftshift.py): roll the given axes by half
their length and move each axis's scale offset to match."""

from __future__ import annotations

from ..ops.fftshift import fftshift as bf_fftshift
from ..pipeline import TransformBlock
from ._common import deepcopy_header


class FftShiftBlock(TransformBlock):
    def __init__(self, iring, axes, inverse=False, *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        if not isinstance(axes, (list, tuple)):
            axes = [axes]
        self.specified_axes = list(axes)
        self.inverse = inverse

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        self.axes = [itensor["labels"].index(ax) if isinstance(ax, str)
                     else ax for ax in self.specified_axes]
        frame_axis = itensor["shape"].index(-1)
        if frame_axis in self.axes:
            raise ValueError("cannot fftshift the frame axis")
        ohdr = deepcopy_header(ihdr)
        otensor = ohdr["_tensor"]
        # the shift moves the zero bin to the centre: offset -= n/2 * step
        if "scales" in otensor and otensor["scales"] is not None:
            for ax in self.axes:
                n = itensor["shape"][ax]
                off, step = otensor["scales"][ax]
                otensor["scales"][ax] = [off - (n // 2) * step, step]
        return ohdr

    def on_data(self, ispan, ospan):
        # Span tensors keep a complex integer's (re, im) axis last, after
        # every header axis, so the header's axes apply as they are.
        bf_fftshift(ispan.data, tuple(self.axes), dst=ospan.data,
                    inverse=self.inverse)


def fftshift(iring, axes, inverse=False, *args, **kwargs):
    """Apply an FFT shift along the given axes
    (reference blocks/fftshift.py:38-109)."""
    return FftShiftBlock(iring, axes, inverse, *args, **kwargs)
