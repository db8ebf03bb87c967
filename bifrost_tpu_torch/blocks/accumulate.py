"""Accumulate block: sum `nframe` one-frame gulps into one output frame
(counterpart of bifrost_tpu/blocks/accumulate.py; reference
python/bifrost/blocks/accumulate.py).  The running sum is the block's
own tensor: the first gulp of an integration is copied out of its span
(a span is a view of ring bytes the writer reuses), the later ones are
added to it in place, which rounds as the JAX block's `acc + x`."""

from __future__ import annotations

from ..DataType import DataType
from ..ndarray import complex_view
from ..pipeline import TransformBlock
from ._common import deepcopy_header, store


class AccumulateBlock(TransformBlock):

    def output_nframes_for_gulp(self, rel_frame0, in_nframe):
        """The exact emit schedule: the gulp is one frame and
        `on_sequence` zeroes the count, so an integration ends every
        `nframe` frames of the sequence."""
        return [(rel_frame0 + in_nframe) // self.nframe
                - rel_frame0 // self.nframe]

    def __init__(self, iring, nframe, dtype=None, gulp_nframe=1,
                 *args, **kwargs):
        if gulp_nframe != 1:
            raise ValueError("AccumulateBlock requires gulp_nframe=1")
        super().__init__(iring, gulp_nframe=1, *args, **kwargs)
        self.nframe = nframe
        self.dtype = dtype

    def on_sequence(self, iseq):
        ihdr = iseq.header
        self._idtype = DataType(ihdr["_tensor"]["dtype"])
        ohdr = deepcopy_header(ihdr)
        otensor = ohdr["_tensor"]
        if "scales" in otensor and otensor["scales"]:
            fax = otensor["shape"].index(-1)
            otensor["scales"][fax][1] *= self.nframe
        if self.dtype is not None:
            otensor["dtype"] = str(DataType(self.dtype))
        self.frame_count = 0
        self._acc = None
        return ohdr

    def fold(self, acc, x):
        """One frame `x` into the running sum `acc` (None at the start of
        an integration) -> the new sum: the first frame is copied, the
        later ones added in place.  A fused group ending in this block
        folds its frames through here (fuse.py)."""
        dt = self._idtype
        if dt.is_complex and dt.is_integer:
            x = complex_view(x, dt)
        if acc is None:
            return x.clone()
        acc += x
        return acc

    def on_data(self, ispan, ospan):
        self._acc = self.fold(self._acc if self.frame_count else None,
                              ispan.data)
        self.frame_count += 1
        if self.frame_count == self.nframe:
            store(ospan, self._acc)
            self.frame_count = 0
            self._acc = None
            return 1
        return 0


def accumulate(iring, nframe, dtype=None, *args, **kwargs):
    """Accumulate `nframe` frames before outputting one
    (reference blocks/accumulate.py:77-104)."""
    return AccumulateBlock(iring, nframe, dtype, *args, **kwargs)
