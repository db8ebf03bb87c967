"""FFT block (counterpart of bifrost_tpu/blocks/fft.py; reference
python/bifrost/blocks/fft.py): axis scales and units rewritten to the
Fourier conjugate, r2c/c2r shape changes, on the planned `ops.fft.Fft`
(torch.fft).  `method=` (None reads the `fft_method` config flag) is
resolved once per sequence and latched."""

from __future__ import annotations

from ..DataType import DataType
from ..ndarray import complex_view
from ..ops.fft import Fft, resolve_method
from ..pipeline import TransformBlock
from ..units import transform_units
from ._common import deepcopy_header


class FftBlock(TransformBlock):
    def __init__(self, iring, axes, inverse=False, real_output=False,
                 axis_labels=None, apply_fftshift=False, method=None,
                 *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        if not isinstance(axes, (list, tuple)):
            axes = [axes]
        if not isinstance(axis_labels, (list, tuple)):
            axis_labels = [axis_labels]
        self.specified_axes = list(axes)
        self.real_output = real_output
        self.inverse = inverse
        self.axis_labels = list(axis_labels)
        self.apply_fftshift = apply_fftshift
        self.specified_method = method
        self.fft = Fft(method=method)    # validates an explicit method

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        self._idtype = DataType(itensor["dtype"])
        itype = self._idtype.as_floating_point()
        self.axes = [itensor["labels"].index(ax) if isinstance(ax, str)
                     else ax for ax in self.specified_axes]
        axes = self.axes
        shape = [itensor["shape"][ax] for ax in axes]
        otype = itype.as_real() if self.real_output else itype.as_complex()
        ohdr = deepcopy_header(ihdr)
        otensor = ohdr["_tensor"]
        otensor["dtype"] = str(otype)
        if itype.is_real and otype.is_complex:
            self.mode = "r2c"
        elif itype.is_complex and otype.is_real:
            self.mode = "c2r"
        else:
            self.mode = "c2c"
        frame_axis = itensor["shape"].index(-1)
        if frame_axis in axes:
            raise KeyError("Cannot transform frame axis; reshape the data "
                           "stream first")
        if self.mode == "r2c":
            otensor["shape"][axes[-1]] = otensor["shape"][axes[-1]] // 2 + 1
        elif self.mode == "c2r":
            otensor["shape"][axes[-1]] = (otensor["shape"][axes[-1]] - 1) * 2
            shape[-1] = (shape[-1] - 1) * 2
        for i, (ax, length) in enumerate(zip(axes, shape)):
            if "units" in otensor and otensor["units"] is not None:
                otensor["units"][ax] = transform_units(otensor["units"][ax],
                                                       -1)
            if "scales" in otensor and otensor["scales"] is not None:
                scale = otensor["scales"][ax][1]
                otensor["scales"][ax] = [0, 1.0 / (scale * length)
                                         if scale else 0]
            if "labels" in otensor and self.axis_labels != [None]:
                otensor["labels"][ax] = self.axis_labels[i]
        # Resolve the engine once per sequence and latch the flag.
        self.fft.method = resolve_method(self.specified_method)
        self._hold_flag_latch("fft_method")
        self.fft.axes = tuple(axes)
        self.fft.kind = self.mode
        self.fft.apply_fftshift = self.apply_fftshift
        self.fft._real_out_n = tuple(shape) if self.mode == "c2r" else None
        return ohdr

    def _lift(self, x):
        dt = self._idtype
        if dt.is_complex and dt.is_integer:
            return complex_view(x, dt)
        return x.float() if dt.is_integer else x

    def on_data(self, ispan, ospan):
        self.fft.execute(self._lift(ispan.data), ospan.data,
                         inverse=self.inverse)

    def device_kernel(self):
        """The stage function for a fused group (fuse.py): the same
        planned transform into a new tensor."""
        inverse = self.inverse
        return lambda x: self.fft.execute(self._lift(x), None,
                                          inverse=inverse)

    def plan_report(self):
        return self.fft.plan_report()


def fft(iring, axes, inverse=False, real_output=False, axis_labels=None,
        apply_fftshift=False, method=None, *args, **kwargs):
    """FFT the data along the given axes (reference blocks/fft.py:121-179)
    with torch.fft (cuFFT on the card)."""
    return FftBlock(iring, axes, inverse, real_output, axis_labels,
                    apply_fftshift, method, *args, **kwargs)
