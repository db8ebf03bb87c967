"""Gain-calibration block: per-cell complex gains applied to the stream
(counterpart of bifrost_tpu/blocks/calibrate.py:75-278).

Runs the planned `ops.calibrate.GainCal`: `method=` (None reads the
`dq_cal_method` config flag, latched for the sequence) selects kernel
K5b or its plain version.  Gains resolve per sequence from, in order:
the block's `gains=`, the `gain_callback(header)` hook, or the stream
header's ``cal_gains`` key (a JSON-safe list of [re, im] pairs,
`ops.calibrate.decode_gains`).  A table sized to one stream axis (per
station, say) broadcasts across the other cell axes (`broadcast_gains`);
a full-size table applies per cell.  `set_gains()` stages a table that
applies at the next gulp boundary.  The output header loses the
``cal_gains`` key and gains ``cal_applied``, so the engines downstream
do not fold the same table again.  Output: cf32 for complex input
(ci8 or ci4 on a 'cuda' ring is read in raw storage form), f32 for real
input.

For a B-engine consumer, folding the gains into the beamform weights
(`BeamformBlock(gains=...)`) gives the same beams with no pass over the
samples.

Fusion: the block declares the fused-carry protocol with a trivial
carry (the apply is stateless), so it joins fused groups (fuse.py)
beside the flagger and the PFB.  Its step applies a pending
`set_gains()` at the gulp boundary as this block does; the JAX group
reads the gains once per sequence, its compiled program's constant.
Not ported: the plan proclog.
"""

from __future__ import annotations

import threading

import numpy as np

from ..DataType import DataType
from ..ndarray import complex_view
from ..ops.calibrate import GainCal, decode_gains
from ..pipeline import TransformBlock
from ._common import deepcopy_header


def broadcast_gains(gains, cell_shape, labels=None, axis=None):
    """Broadcast a gain table to a flat (ncell,) plane over `cell_shape`
    (the non-time axes, C order).  Full-size tables pass through; a table
    sized to one axis broadcasts across the others: `axis` pins which
    (a name from `labels`, which include time, or an index into
    cell_shape), else a 'station'-labelled axis wins, then a unique
    length match."""
    g = np.asarray(gains, dtype=np.complex64).reshape(-1)
    ncell = int(np.prod(cell_shape)) if cell_shape else 1
    if g.size == ncell:
        return g
    if axis is not None and not isinstance(axis, int):
        if labels is None or axis not in labels:
            raise ValueError(f"calibrate: axis {axis!r} not in stream "
                             f"labels {labels}")
        axis = list(labels).index(axis) - 1   # labels include time
    cands = [i for i, n in enumerate(cell_shape) if n == g.size]
    if axis is None and labels is not None and len(cands) > 1:
        station = [i for i in cands
                   if str(labels[i + 1]).lower() in
                   ("station", "stand", "antenna", "ant", "input")]
        if len(station) == 1:
            axis = station[0]
    if axis is None:
        if len(cands) != 1:
            raise ValueError(
                f"calibrate: {g.size} gain(s) match "
                f"{len(cands)} axes of cell shape {cell_shape}; pass "
                f"a full-size table or pin the axis")
        axis = cands[0]
    if cell_shape[axis] != g.size:
        raise ValueError(
            f"calibrate: {g.size} gain(s) for axis {axis} of length "
            f"{cell_shape[axis]}")
    shape = [1] * len(cell_shape)
    shape[axis] = g.size
    return np.ascontiguousarray(
        np.broadcast_to(g.reshape(shape), cell_shape)).reshape(-1)


class GainCalBlock(TransformBlock):

    # Under the async executor the worker reserves this block's output
    # (its commit may shrink on a gulp), except that the exact
    # `output_nframes_for_gulp` below restores the reserve-ahead
    # (pipeline.py, async_reserve_ahead).
    async_reserve_ahead = False

    def __init__(self, iring, gains=None, *args, method=None, axis=None,
                 gain_callback=None, header_key="cal_gains", **kwargs):
        """gains: a complex table (full cell size or one axis, see
        `broadcast_gains`), or None to resolve through `gain_callback` or
        the `header_key` header key.  method: None resolves the
        `dq_cal_method` config flag per sequence."""
        super().__init__(iring, *args, **kwargs)
        self.gains = None if gains is None \
            else np.asarray(gains, dtype=np.complex64)
        self.axis = axis
        self.gain_callback = gain_callback
        self.header_key = header_key
        self.method = method
        self.cal = GainCal()
        self._pending = None
        self._lock = threading.Lock()
        self.gain_updates = 0

    exact_output_nframes = True

    def define_output_nframes(self, input_nframe):
        return [input_nframe]

    def output_nframes_for_gulp(self, rel_frame0, in_nframe):
        return [in_nframe]

    def set_gains(self, gains):
        """Stage a new gain table, applied at the next gulp boundary
        (thread-safe)."""
        with self._lock:
            self._pending = np.asarray(gains, dtype=np.complex64)

    def _resolve_gains(self, ihdr):
        if self.gains is not None:
            return self.gains
        if self.gain_callback is not None:
            g = self.gain_callback(ihdr)
            if g is not None:
                return decode_gains(g)
        g = ihdr.get(self.header_key)
        if g is not None:
            return decode_gains(g)
        raise ValueError(
            f"{self.name}: no gains: pass gains=, gain_callback=, or "
            f"put a {self.header_key!r} table in the stream header")

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        if itensor["shape"][0] != -1:
            raise ValueError(
                f"calibrate: the frame (streaming) axis must lead "
                f"(time-first), got shape {itensor['shape']}")
        self._dtype = DataType(itensor["dtype"])
        self._cell_shape = tuple(int(s) for s in itensor["shape"][1:])
        self._labels = itensor.get("labels")
        g = broadcast_gains(self._resolve_gains(ihdr), self._cell_shape,
                            self._labels, self.axis)
        # Resolve the method once per sequence and latch the config flag.
        self.cal.method = self.method if self.method is not None \
            else "auto"
        self.cal.init(gains=g)
        self.cal.method = self.cal._resolve()
        self._hold_flag_latch("dq_cal_method")
        self._raw_reads = 0
        self._raw_read_nbyte = 0
        ohdr = deepcopy_header(ihdr)
        ohdr["_tensor"]["dtype"] = "cf32" if self._dtype.is_complex \
            else "f32"
        # The stream is calibrated now: the engines downstream must not
        # fold the same table again.
        ohdr.pop(self.header_key, None)
        ohdr["cal_applied"] = True
        return ohdr

    def _apply_pending(self):
        with self._lock:
            pend = self._pending
            self._pending = None
        if pend is not None:
            self.cal.set_gains(broadcast_gains(
                pend, self._cell_shape, self._labels, self.axis))
            self.gain_updates += 1

    def on_data(self, ispan, ospan):
        n = ispan.nframe
        if n == 0:
            return 0
        self._apply_pending()
        out = ospan.data[:n]
        raw = ispan.data_storage
        if raw is not None:
            self.cal.execute_raw(raw, str(self._dtype), out=out)
            self._raw_reads += 1
            self._raw_read_nbyte += raw.numel() * raw.element_size()
        else:
            x = ispan.data
            if self._dtype.is_complex and self._dtype.is_integer:
                x = complex_view(x, self._dtype)
            self.cal.execute(x, out=out)
        return n

    def plan_report(self):
        """The plan's runtime accounting (ops/runtime.py schema +
        calibration config)."""
        return self.cal.plan_report()

    # ------------------------------------------- fused-carry protocol
    fused_carry_warmup_nframe = 0
    fused_carry_stride = 1

    def device_kernel_carry(self):
        """The fused stage step(x, carry, consts) -> (y, carry) on a
        logical gulp: the plan's `execute`, the unfused gulp's code, with
        the (unused) carry threaded through.  Valid after on_sequence."""
        def step(x, carry, consts):
            self._apply_pending()
            return self.cal.execute(x), carry
        return step

    def device_kernel_carry_raw(self, dtype):
        """The same on ci8 or ci4 ring storage (the plan's
        `execute_raw`)."""
        def step(raw, carry, consts):
            self._apply_pending()
            return self.cal.execute_raw(raw, dtype), carry
        return step

    def fused_carry_init(self):
        """The apply carries nothing."""
        return None

    def fused_carry_consts(self):
        """No constants: the staged gain plane lives on the plan,
        re-staged by a `set_gains()` at the next gulp boundary."""
        return ()


def gaincal(iring, gains=None, *args, **kwargs):
    """Per-cell complex gain calibration, x' = g * x on kernel K5b, gains
    from the parameter, a callback or the ``cal_gains`` header key, and
    updatable mid-sequence with `set_gains()`.  For a B-engine consumer
    prefer `BeamformBlock(gains=...)`, the fold into the weights."""
    return GainCalBlock(iring, gains, *args, **kwargs)
