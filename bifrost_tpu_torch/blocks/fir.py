"""FIR block: a streaming per-channel FIR filter with decimation
(counterpart of bifrost_tpu/blocks/fir.py; reference: the bfFir plan
driven per gulp, python/bifrost/fir.py).

Runs the planned `ops.fir.Fir`: `method=` (None reads the `fir_method`
config flag, latched for the sequence) selects kernel K2, its plain
version or the 'conv' baseline; the (ntap-1)-sample history carries
between gulps inside the plan, so split gulps are bitwise one long gulp.
The resolved method and the plan's cache accounting land on the
`<name>/fir_plan` proclog.

ci8/ci4 ingest: a 'cuda' ring carrying a complex-integer stream is read
in storage form (`ReadSpan.data_storage`: ci8 at 2 B/sample, which K2
reads as it lies; packed ci4 at 1 B/sample, unpacked to ci8 pairs
first), and the filtered gulp is written straight into the output span.

Layout: the frame (streaming) axis must be time and must lead; every
other axis is a filter channel with its own coefficient bank (or one
(ntap,) bank for all).  Output: f32 for a real stream, cf32 for a
complex one, the time scale multiplied by `decim`.  gulp_nframe must be
a multiple of `decim`; trailing frames of a final partial gulp that do
not fill a decimation stride are dropped with a warning.

Fusion: the block declares the fused-carry protocol, so a fused group
(fuse.py, rule stateful_chain) threads the history through its carry
step, the plan's own `step`/`step_raw` with the history passed in:
a fused FIR is bitwise its unfused twin with the same K2 launches.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..DataType import DataType
from ..ndarray import complex_view
from ..ops.fir import Fir
from ..pipeline import TransformBlock
from ._common import deepcopy_header


class FirBlock(TransformBlock):

    def __init__(self, iring, coeffs, decim=1, *args, method=None,
                 **kwargs):
        """coeffs: (ntap,) shared bank or (ntap, nchan_flat) per-channel
        banks (nchan_flat = product of the non-time axes).  decim: the
        output keeps every decim-th filtered sample.  method: None
        resolves the `fir_method` config flag per sequence
        ('auto'/'cuda'/'plain'/'conv')."""
        super().__init__(iring, *args, **kwargs)
        self.coeffs = np.asarray(coeffs, dtype=np.float64)
        self.decim = int(decim)
        if self.decim < 1:
            raise ValueError(f"decim must be >= 1, got {decim}")
        self.method = method
        self.fir = Fir()

    def define_output_nframes(self, input_nframe):
        return [input_nframe // self.decim]

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        if itensor["shape"][0] != -1:
            raise ValueError(
                f"fir: the frame (streaming) axis must lead (time-first), "
                f"got shape {itensor['shape']}")
        gulp_actual = self.gulp_nframe or ihdr.get("gulp_nframe", 1)
        if gulp_actual % self.decim:
            raise ValueError(
                f"gulp_nframe ({gulp_actual}) must be a multiple of "
                f"decim ({self.decim}); set gulp_nframe= on the fir block")
        self._dtype = DataType(itensor["dtype"])
        # Resolve the method once per sequence and latch the config flag.
        self.fir.method = self.method if self.method is not None else "auto"
        self.fir.init(self.coeffs, decim=self.decim)
        self.fir.method = self.fir._resolve()
        self._hold_flag_latch("fir_method")
        self._raw_reads = 0        # gulps read in raw int storage form
        self._raw_read_nbyte = 0   # bytes those reads covered
        self._dropped_tail = 0
        chan_shape = itensor["shape"][1:]
        self._lanes = (int(np.prod(chan_shape)) if chan_shape else 1) * \
            (2 if self._dtype.is_complex else 1)
        ohdr = deepcopy_header(ihdr)
        ot = ohdr["_tensor"]
        ot["dtype"] = "cf32" if self._dtype.is_complex else "f32"
        if ot.get("scales") is not None and ot["scales"][0] is not None:
            ot["scales"][0][1] *= self.decim
        if ihdr.get("gulp_nframe"):
            ohdr["gulp_nframe"] = max(ihdr["gulp_nframe"] // self.decim, 1)
        if not hasattr(self, "_plan_proclog"):
            from ..proclog import ProcLog
            self._plan_proclog = ProcLog(f"{self.log_name}/fir_plan")
        self.fir._runtime.publish_proclog(self._plan_proclog, extra={
            "method": self.fir.method, "origin": "host",
            "ntap": self.fir.ntap, "decim": self.decim})
        return ohdr

    def _whole(self, nframe):
        """The frames of an `nframe` gulp that fill whole decimation
        strides: a final partial gulp's remainder has no output slot and
        is dropped, with a warning."""
        n = (nframe // self.decim) * self.decim
        if n < nframe:
            self._dropped_tail = nframe - n
            warnings.warn(
                f"{self.name}: dropping {self._dropped_tail} trailing "
                f"frame(s) not filling a decimation stride at sequence "
                f"end", stacklevel=1)
        return n

    def on_data(self, ispan, ospan):
        n = self._whole(ispan.nframe)
        if n == 0:
            return 0
        out = ospan.data[:n // self.decim]
        raw = ispan.data_storage
        if raw is not None:
            raw = self._count_raw(raw[:n])
            self.fir.execute_raw(raw, str(self._dtype), out=out)
        else:
            x = ispan.data[:n]
            if self._dtype.is_complex and self._dtype.is_integer:
                x = complex_view(x, self._dtype)
            self.fir.step(x, None, out=out)
        return n // self.decim

    def _count_raw(self, raw):
        """Count a gulp read in storage form (fused or not) -> it."""
        self._raw_reads += 1
        self._raw_read_nbyte += raw.numel() * raw.element_size()
        return raw

    def plan_report(self):
        """The plan's runtime accounting (ops/runtime.py schema + ntap and
        decim)."""
        return self.fir.plan_report()

    # ------------------------------------------- fused-carry protocol
    # No warm-up: the filter starts from a zero history fused and unfused
    # alike.
    fused_carry_warmup_nframe = 0

    @property
    def fused_carry_stride(self):
        """Input frames per output frame."""
        return self.decim

    def device_kernel_carry(self):
        """The fused stage step(x, history, consts) -> (y, history') on a
        logical gulp: the plan's `step`, the unfused gulp's code.  Valid
        after on_sequence."""
        def step(x, state, consts):
            n = self._whole(x.shape[0])
            return (None, state) if n == 0 else self.fir.step(x[:n], state)
        return step

    def device_kernel_carry_raw(self, dtype):
        """The same on complex-integer ring storage (the plan's
        `step_raw`: K2 reading ci8 at 2 B/sample, ci4 unpacked first);
        the history is shared with the logical form.  The block counts
        these reads as its unfused gulps count theirs."""
        def step(raw, state, consts):
            n = self._whole(raw.shape[0])
            return (None, state) if n == 0 else \
                self.fir.step_raw(self._count_raw(raw[:n]), dtype, state)
        return step

    def fused_carry_init(self):
        """A fresh zero (ntap-1)-sample history in the folded domain."""
        return self.fir.init_state(self._lanes, self.device)

    def fused_carry_consts(self):
        """None: the plan stages its banks once and its step reads them
        from its own cache."""
        return ()


def fir(iring, coeffs, decim=1, *args, **kwargs):
    """Per-channel FIR filter with decimation and carried inter-gulp
    history (reference python/bifrost/fir.py): kernel K2 on the card (or
    `method=` 'plain' / 'conv'); ci8/ci4 'cuda' rings are read in
    storage form."""
    return FirBlock(iring, coeffs, decim, *args, **kwargs)
