"""RFI excision block: the data-quality plane's flagger as a streaming
stage (counterpart of bifrost_tpu/blocks/flag.py:81-266).

Runs the planned `ops.flag.Flag`: `method=` (None reads the
`dq_flag_method` config flag, latched for the sequence) selects kernel
K5a or its plain version for the masked fill; the window statistics are
shared.  The baseline carries between gulps inside the plan, so
splitting a stream at multiples of the window is bitwise equal to one
long gulp.  ``window=None`` makes one window per gulp.

Output: the input stream with flagged (window, cell) regions excised,
zero-filled by default (the multiplicative mask the B/X engines
assume).  A gulp of a host ('system') ring, as `frb_search_spec` builds
the flagger after the capture, is staged onto the block's device,
flagged there and copied back into the host output span.  A real
integer stream is rounded and clipped back to its dtype (unflagged
samples pass through exactly), another real stream
keeps its dtype, and a complex stream becomes cf32.  A 'cuda' ring
carrying ci8 or ci4 is read in raw storage form (`ReadSpan.data_storage`)
and unpacked before the fill.  Each gulp's boolean mask (nwindows,
*cell_shape) is kept on ``last_mask``, handed to ``on_mask`` (an
observer: its errors are swallowed) and counted in
``flagged_fraction``; ``baseline_resets`` counts the cold starts (one
per sequence).

Fusion: the block declares the fused-carry protocol, so a fused group
(fuse.py) threads the baseline through its carry step, the plan's own
`step`/`step_raw`.  As in the JAX group, a fused gulp's mask is not
observed: ``last_mask``, ``on_mask`` and ``flagged_fraction`` follow the
unfused block only.  Not ported: the plan proclog (no proclog yet);
`plan_report()` returns the same accounting.
"""

from __future__ import annotations

import numpy as np
import torch

from ..DataType import DataType
from ..ndarray import complex_view
from ..ops.flag import Flag
from ..pipeline import TransformBlock
from ._common import deepcopy_header


class RfiFlagBlock(TransformBlock):

    # Under the async executor the worker reserves this block's output
    # (its commit may shrink on a gulp), except that the exact
    # `output_nframes_for_gulp` below restores the reserve-ahead
    # (pipeline.py, async_reserve_ahead).
    async_reserve_ahead = False

    def __init__(self, iring, algo="mad", thresh=6.0, mad_factor=4.0,
                 alpha=0.25, window=None, fill="zero", *args, method=None,
                 on_mask=None, **kwargs):
        """algo, thresh, mad_factor, alpha, fill: the plan's parameters
        (ops.flag.Flag.init).  window: frames per flagging decision
        (None: one window per gulp).  method: None resolves the
        `dq_flag_method` config flag per sequence ('auto'/'cuda'/
        'plain').  on_mask: callable(mask) per gulp with the
        (nwindows, *cell_shape) bool numpy mask."""
        super().__init__(iring, *args, **kwargs)
        self.algo = algo
        self.thresh = float(thresh)
        self.mad_factor = float(mad_factor)
        self.alpha = float(alpha)
        self.window = None if window is None else int(window)
        self.fill = fill
        self.method = method
        self.on_mask = on_mask
        self.flagger = Flag()
        self.last_mask = None
        self.cells_seen = 0
        self.cells_flagged = 0
        self.baseline_resets = 0

    exact_output_nframes = True

    def define_output_nframes(self, input_nframe):
        return [input_nframe]

    def output_nframes_for_gulp(self, rel_frame0, in_nframe):
        return [in_nframe]

    @property
    def flagged_fraction(self):
        """Fraction of (window, cell) decisions flagged so far."""
        if not self.cells_seen:
            return 0.0
        return self.cells_flagged / self.cells_seen

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        if itensor["shape"][0] != -1:
            raise ValueError(
                f"flag: the frame (streaming) axis must lead "
                f"(time-first), got shape {itensor['shape']}")
        self._dtype = DataType(itensor["dtype"])
        gulp_actual = self.gulp_nframe or ihdr.get("gulp_nframe", 1)
        window = self.window if self.window is not None else gulp_actual
        # Resolve the method once per sequence and latch the config flag.
        self.flagger.method = self.method if self.method is not None \
            else "auto"
        self.flagger.init(window, algo=self.algo, thresh=self.thresh,
                          mad_factor=self.mad_factor, alpha=self.alpha,
                          fill=self.fill)
        self.flagger.method = self.flagger._resolve()
        self._hold_flag_latch("dq_flag_method")
        self._raw_reads = 0        # gulps read in raw int storage form
        self._raw_read_nbyte = 0   # bytes those reads covered
        # A (re)started sequence begins from a cold baseline.
        self.baseline_resets += 1
        self.last_mask = None
        self._cell_shape = tuple(int(s) for s in itensor["shape"][1:])
        self._ncell = int(np.prod(self._cell_shape))
        ohdr = deepcopy_header(ihdr)
        if self._dtype.is_complex:
            ohdr["_tensor"]["dtype"] = "cf32"
        return ohdr

    def on_data(self, ispan, ospan):
        n = ispan.nframe
        if n == 0:
            return 0
        out = ospan.data[:n]
        raw = ispan.data_storage
        if raw is not None:
            _, mask = self.flagger.execute_raw(raw, str(self._dtype),
                                               out=out)
            self._raw_reads += 1
            self._raw_read_nbyte += raw.numel() * raw.element_size()
        else:
            x = ispan.data
            # A host ring's gulp is flagged on the block's device (K5a on
            # the card) and the result copied back into the host span.
            stage = ispan.ring.space != "cuda" and \
                x.device != torch.device(self.device)
            if stage:
                x = x.to(self.device)
            if self._dtype.is_complex and self._dtype.is_integer:
                x = complex_view(x, self._dtype)
            y, mask = self.flagger.execute(x, out=None if stage else out)
            if stage:
                out.copy_(y)
        m = mask.cpu().numpy()
        self.last_mask = m.reshape((m.shape[0],) + self._cell_shape)
        self.cells_seen += m.size
        self.cells_flagged += int(np.count_nonzero(m))
        cb = self.on_mask
        if cb is not None:
            try:
                cb(self.last_mask)
            except Exception:  # noqa: BLE001 — observer only
                pass
        return n

    def plan_report(self):
        """The plan's runtime accounting (ops/runtime.py schema +
        flagger config)."""
        return self.flagger.plan_report()

    # ------------------------------------------- fused-carry protocol
    # No warm-up: a cell's first window is its own baseline, fused and
    # unfused alike.
    fused_carry_warmup_nframe = 0
    fused_carry_stride = 1

    def device_kernel_carry(self):
        """The fused stage step(x, baseline, consts) -> (y, baseline') on
        a logical gulp: the plan's `step`, the unfused gulp's code.
        Valid after on_sequence."""
        def step(x, state, consts):
            y, _, state = self.flagger.step(x, state)
            return y, state
        return step

    def device_kernel_carry_raw(self, dtype):
        """The same on ci8 or ci4 ring storage (the plan's `step_raw`); the
        baseline is shared with the logical form."""
        def step(raw, state, consts):
            y, _, state = self.flagger.step_raw(raw, dtype, state)
            return y, state
        return step

    def fused_carry_init(self):
        """A cold baseline: (3, ncell) f32 zeros."""
        return self.flagger.init_state(self._ncell, self.device)

    def fused_carry_consts(self):
        """No constants: the thresholds live on the plan (`set_params`
        applies at the next window, as unfused)."""
        return ()


def rfi_flag(iring, algo="mad", thresh=6.0, mad_factor=4.0, alpha=0.25,
             window=None, fill="zero", *args, **kwargs):
    """RFI excision stage: windowed robust flagging (median/MAD or
    spectral kurtosis) against a baseline carried between gulps, flagged
    (window, cell) regions zero-filled by kernel K5a."""
    return RfiFlagBlock(iring, algo, thresh, mad_factor, alpha, window,
                        fill, *args, **kwargs)
