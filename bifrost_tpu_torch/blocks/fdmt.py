"""FDMT block: incoherent dedispersion over streaming gulps (counterpart
of bifrost_tpu/blocks/fdmt.py:103-226; reference
python/bifrost/blocks/fdmt.py).  Input axes [..., 'freq', 'time'], output
[..., 'dispersion', 'time'], with `max_delay` frames of input overlap
between gulps so each output gulp has its full dispersion history.

Host-ring input (bifrost_tpu/blocks/fdmt.py:179-212): the transform runs
on the pipeline's device wherever the input ring lies.  A span of a
'system' ring is staged onto the device, and the block keeps the last
`max_delay` staged frames there as a carried tail, so after a sequence's
first gulp only the new frames cross (`gulp` frames a gulp instead of
`gulp + max_delay`); a frame-offset guard stages the whole span again
whenever continuity breaks (a sequence start, frames a lossy reader
skipped).  `_frames_staged` counts the frames staged in the sequence.
The output ring stays in the input's space, as in the reference.

Fusion: in a fused group (fuse.py) the ring overlap becomes a carry of
the last max_delay input frames, zeros at the sequence start; the group
drops the first max_delay output frames (`fused_carry_warmup_nframe`),
the frames the overlap never emits, so the fused stream equals this
block's.
"""

from __future__ import annotations

import math

import torch

from ..pipeline import TransformBlock
from ..ops.fdmt import Fdmt
from ..units import convert_units
from ._common import deepcopy_header, store


class FdmtBlock(TransformBlock):

    # Under the async executor the worker reserves this block's output,
    # one open reservation at a time (pipeline.py,
    # async_reserve_ahead).
    async_reserve_ahead = False

    kdm = 4.148741601e3  # MHz^2 cm^3 s / pc
    dm_units = "pc cm^-3"

    def __init__(self, iring, max_dm=None, max_delay=None, max_diagonal=None,
                 exponent=-2.0, negative_delays=False, method=None,
                 *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        if sum(m is not None
               for m in (max_dm, max_delay, max_diagonal)) != 1:
            raise ValueError("Must specify exactly one of: max_dm, max_delay, "
                             "max_diagonal")
        self.max_value = max_dm or max_delay or max_diagonal or 0.0
        self.max_mode = ("dm" if max_dm is not None else
                         "delay" if max_delay is not None else "diagonal")
        self.exponent = exponent
        self.negative_delays = negative_delays
        self.method = method
        self.fdmt = Fdmt()

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        labels = itensor["labels"]
        if labels[-1] != "time" or labels[-2] != "freq":
            raise KeyError(f"Expected axes [..., 'freq', 'time'], got {labels}")
        nchan = itensor["shape"][-2]
        f0_, df_ = itensor["scales"][-2]
        t0_, dt_ = itensor["scales"][-1]
        f0 = convert_units(f0_, itensor["units"][-2], "MHz")
        df = convert_units(df_, itensor["units"][-2], "MHz")
        dt = convert_units(dt_, itensor["units"][-1], "s")
        max_mode, max_value = self.max_mode, self.max_value
        if max_mode == "diagonal":
            max_mode, max_value = "delay", int(math.ceil(nchan * max_value))
        if max_mode == "dm":
            rel_delay = (self.kdm / dt * max_value *
                         (f0 ** -2 - (f0 + nchan * df) ** -2))
            self.max_delay = int(math.ceil(abs(rel_delay)))
            max_dm = max_value
        else:
            self.max_delay = int(max_value)
            fac = f0 ** -2 - (f0 + nchan * df) ** -2
            max_dm = self.max_delay * dt / (self.kdm * abs(fac))
        if self.negative_delays:
            max_dm = -max_dm
        self.dm_step = max_dm / self.max_delay
        self.fdmt.init(nchan, self.max_delay, f0, df, self.exponent,
                       method=self.method)
        # One executor per sequence: the method flag is latched until the
        # sequence ends (config.py).
        self.fdmt._runtime.resolve_method(self.fdmt.method)
        self._hold_flag_latch("fdmt_method")
        self.plan_report = self.fdmt.plan_report()
        # The carried input tail of a host-ring input (module docstring),
        # reset per sequence.
        self._tail = None
        self._tail_off = None
        self._frames_staged = 0
        self._lead_shape = tuple(int(s) for s in itensor["shape"][:-2])
        self._nchan = int(nchan)
        ohdr = deepcopy_header(ihdr)
        refdm = convert_units(ihdr.get("refdm", 0.0),
                              ihdr.get("refdm_units", self.dm_units),
                              self.dm_units)
        ot = ohdr["_tensor"]
        ot["dtype"] = "f32"
        ot["shape"][-2] = self.max_delay
        ot["labels"][-2] = "dispersion"
        ot["scales"][-2] = [refdm, self.dm_step]
        ot["units"][-2] = self.dm_units
        ohdr["max_dm"] = max_dm
        ohdr["max_dm_units"] = self.dm_units
        ohdr["cfreq"] = f0_ + 0.5 * (nchan - 1) * df_
        ohdr["cfreq_units"] = itensor["units"][-2]
        ohdr["bw"] = nchan * df_
        ohdr["bw_units"] = itensor["units"][-2]
        return ohdr

    def define_input_overlap_nframe(self, iseqs):
        """Overlap successive gulps by max_delay frames so every output frame
        has complete dispersion history (reference blocks/fdmt.py)."""
        return self.max_delay

    def _dedisperse(self, x, n):
        """The last `n` complete frames of the transform of `x`, (...,
        nchan, ntime) with `max_delay` frames of history."""
        res = self.fdmt.execute(x, negative_delays=self.negative_delays)
        if self.negative_delays:
            # Negative sweeps read *future* samples: the warm-up region
            # sits at the END of each gulp, so keep the head.
            return res[..., :n]
        return res[..., res.shape[-1] - n:]

    def _stage_gulp(self, ispan):
        """The span's (..., nchan, ntime + overlap) input on the block's
        device: a 'cuda' ring's span as it is, a host ring's staged,
        only the frames the carried tail does not already hold."""
        x = ispan.data
        if ispan.ring.space == "cuda":
            return x
        overlap = self.max_delay
        foff = ispan.frame_offset
        if self._tail is not None and foff == self._tail_off and \
                ispan.nframe > overlap:
            x = torch.cat([self._tail, x[..., overlap:].to(self.device)],
                          dim=-1)
            self._frames_staged += ispan.nframe - overlap
        else:
            # A copy even on the CPU: the tail must not alias ring bytes.
            x = x.to(self.device, copy=True)
            self._frames_staged += ispan.nframe
        if overlap > 0 and ispan.nframe >= overlap:
            self._tail = x[..., x.shape[-1] - overlap:]
            self._tail_off = foff + ispan.nframe - overlap
        else:
            self._tail = None
            self._tail_off = None
        return x

    def on_data(self, ispan, ospan):
        # ispan.data: (..., nchan, ntime + overlap), time last; the output
        # drops the overlap (warm-up) frames.
        n = ospan.nframe
        store(ospan, self._dedisperse(self._stage_gulp(ispan), n))
        return n

    # ------------------------------------------- fused-carry protocol
    @property
    def fused_carry_warmup_nframe(self):
        """Output frames the group drops at a sequence start: those of
        the zero carry, which the ring overlap never emits."""
        return self.max_delay

    def _with_carry(self, x, carry):
        return torch.cat([carry, x.to(torch.float32)], dim=-1)

    def device_kernel_carry(self):
        """The fused stage step(x, tail, consts) -> (y, tail'): the
        transform of [carried max_delay input frames || this gulp],
        keeping this gulp's frames (the unfused gulp's code on the same
        window).  Valid after on_sequence."""
        md = self.max_delay

        def step(x, carry, consts):
            full = self._with_carry(x, carry)
            return (self._dedisperse(full, x.shape[-1]),
                    full[..., full.shape[-1] - md:])
        return step

    def fused_carry_advance(self, x, carry):
        """The carry after a gulp whose whole output is warm-up, without
        the transform (so that the fused run launches no merge step the
        unfused one does not)."""
        full = self._with_carry(x, carry)
        return full[..., full.shape[-1] - self.max_delay:]

    def fused_carry_init(self):
        """A zero input tail: (..., nchan, max_delay) f32."""
        return torch.zeros(self._lead_shape + (self._nchan, self.max_delay),
                           dtype=torch.float32, device=self.device)

    def fused_carry_consts(self):
        return ()


def fdmt(iring, max_dm=None, max_delay=None, max_diagonal=None,
         exponent=-2.0, negative_delays=False, method=None, *args, **kwargs):
    """Fast Dispersion Measure Transform (reference blocks/fdmt.py:117-180)."""
    return FdmtBlock(iring, max_dm, max_delay, max_diagonal, exponent,
                     negative_delays, method, *args, **kwargs)
