"""RFI excision plan: windowed robust flagging with a carried baseline
(counterpart of bifrost_tpu/ops/flag.py).

The input stream is cut into fixed ``window``-frame windows; each
window's per-cell statistics are tested against a running baseline
carried between gulps, and flagged (window, cell) regions are excised by
the masked fill, kernel K5a (ops/dq_kernel.py): zeros by default, the
carried median with ``fill='baseline'`` (real streams only).

Algorithms, as the JAX plan's (its module docstring has the reasoning):

- 'mad': per-window median and MAD per cell (ops/stats.py).  A cell is
  flagged when its window median walks off the carried baseline by more
  than ``thresh`` robust sigmas, when its window MAD inflates by more
  than ``mad_factor`` over the carried MAD, or, before the cell has a
  baseline, over the cross-cell median MAD of the window.
- 'sk': spectral kurtosis over the window outside ``1 +- thresh *
  sqrt(4 / M)``, or, once warmed, a window mean more than ``mad_factor``
  times the carried mean off it.

The baseline is an EMA (``alpha``) updated only on unflagged windows,
with a warm-up counter (capped at 2**20) that makes a cell's first
window self-referential.  The carried state is (3, ncell) f32 rows
[center, scale, warm].  Splitting a stream at multiples of ``window``
frames is bitwise equal to one long gulp; a gulp that is not a multiple
closes a short tail window of its own.

Layout of the work: the JAX plan scans the windows one by one
(``lax.scan``).  Only the baseline recurrence is sequential, so here the
statistics of every window of a gulp (medians, MADs, the cross-cell
median, the SK sums) come from one batched pass, and then a loop over
the windows walks (ncell,) vectors.

Methods (the `dq_flag_method` config flag when None/'auto'): 'cuda'
(what 'auto' resolves to; K5a for a CUDA tensor, its plain version for a
CPU tensor) and 'plain' (the plain version on any device).  The
statistics are shared, and the fill is a select, so the two are bitwise
equal.  Against the JAX package the masks and fills agree exactly
wherever no decision sits within an ulp of its threshold: XLA:CPU
contracts the complex power ``re*re + im*im``, the EMA update and the
thresholds' ``a*b + c`` into FMAs, which the port does not, so the
carried state agrees to a relative tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

from ..DataType import DataType
from . import dq_kernel
from .common import prepare
from .runtime import OpRuntime, staged_unpack
from .stats import MAD_EPS, MAD_SIGMA, median, spectral_kurtosis

WARM_CAP = 2.0 ** 20


def _f32(v):
    return float(np.float32(v))


class Flag(object):
    """Plan API of the JAX `Flag`: init(window, ...), execute /
    execute_raw per gulp returning (y, mask) with the baseline carried
    between gulps, set_params, reset_state, init_state, plan_report.
    ``method``: None/'auto' (the `dq_flag_method` flag, else 'cuda'),
    'cuda' or 'plain' (module docstring)."""

    ALGOS = ("mad", "sk")
    FILLS = ("zero", "baseline")

    def __init__(self, method=None):
        self.window = None
        self.algo = "mad"
        self.thresh = 6.0
        self.mad_factor = 4.0
        self.alpha = 0.25
        self.fill = "zero"
        self._state = None
        self._state_key = None
        self.method = method if method is not None else "auto"
        self._runtime = OpRuntime("flag", ("cuda", "plain"),
                                  config_flag="dq_flag_method",
                                  default="cuda")
        if method not in (None, "auto"):
            self._runtime.resolve_method(method)

    def init(self, window, algo="mad", thresh=6.0, mad_factor=4.0,
             alpha=0.25, fill="zero", method=None):
        """window: frames per flagging decision (>= 2).  algo: 'mad' |
        'sk'.  thresh, mad_factor, alpha: the thresholds and the EMA
        weight (module docstring).  fill: 'zero' | 'baseline'."""
        self.window = int(window)
        if self.window < 2:
            raise ValueError(f"flag: window must be >= 2, got {window}")
        if algo not in self.ALGOS:
            raise ValueError(f"flag: unknown algo {algo!r} "
                             f"(expected {'/'.join(self.ALGOS)})")
        if fill not in self.FILLS:
            raise ValueError(f"flag: unknown fill {fill!r} "
                             f"(expected {'/'.join(self.FILLS)})")
        self.algo = algo
        self.fill = fill
        if method is not None:
            self.method = method
        self.set_params(thresh, mad_factor, alpha)
        self._state = None
        return self

    def set_params(self, thresh=None, mad_factor=None, alpha=None):
        """Retune the thresholds mid-stream; the next window uses them
        (the carried baseline stays)."""
        if thresh is not None:
            self.thresh = float(thresh)
        if mad_factor is not None:
            self.mad_factor = float(mad_factor)
        if alpha is not None:
            self.alpha = float(alpha)

    def _params(self):
        """[thresh, mad_factor, alpha] as f32 values, the precision the
        JAX plan's staged parameter vector holds them in."""
        return tuple(_f32(v) for v in (self.thresh, self.mad_factor,
                                       self.alpha))

    def reset_state(self):
        self._state = None

    def init_state(self, ncell, device="cpu"):
        """Fresh cold baseline: (3, ncell) f32 zeros [center, scale,
        warm]."""
        return torch.zeros(3, int(ncell), dtype=torch.float32,
                           device=device)

    def load_state(self, state):
        """Resume from a carried (3, ncell) [center, scale, warm]
        baseline (a JAX plan's, through `weights.carry_over`): the next
        gulp adopts it in place of a cold start."""
        st = state if isinstance(state, torch.Tensor) else \
            torch.from_numpy(np.array(state, dtype=np.float32))
        if st.dim() != 2 or st.shape[0] != 3:
            raise ValueError(f"flag: a carried state is (3, ncell), got "
                             f"{tuple(st.shape)}")
        self._state = st.to(torch.float32)
        self._state_key = None

    def _ensure_state(self, key, ncell, device):
        key = (key, self.algo, self.window)
        if self._state is not None and self._state_key is None:
            if self._state.shape[1] != ncell:
                raise ValueError(f"flag: carried state holds "
                                 f"{self._state.shape[1]} cells, the "
                                 f"stream {ncell}")
            self._state_key = key
        if self._state is None or self._state_key != key:
            self._state = self.init_state(ncell, device)
            self._state_key = key
        elif self._state.device != device:
            self._state = self._state.to(device)
        return self._state

    def _resolve(self):
        return self._runtime.resolve_method(self.method)

    # ------------------------------------------------------- statistics
    def _window_stats(self, pw):
        """Carry-free statistics of n windows of m frames: pw (n, m,
        ncell) f32 -> tuple of (n, ncell) rows (and (n,) for the
        cross-cell median)."""
        if self.algo == "mad":
            med = median(pw, dim=1, keepdim=True)
            mad = median((pw - med).abs(), dim=1, keepdim=False)
            cross = median(mad, dim=1, keepdim=False)
            return med[:, 0], mad, cross
        return spectral_kurtosis(pw, dim=1), pw.sum(dim=1) / pw.shape[1]

    def _walk(self, stats, m, state, bads, fills):
        """The baseline recurrence over the windows of `stats` (one
        segment of m-frame windows), appending each window's mask and
        fill row; -> state'."""
        p_thresh, p_mad, a = self._params()
        c_b, s_b, warm = state.unbind(0)
        if self.algo == "mad":
            med, mad, cross = stats
            cold = mad > p_mad * (cross + MAD_EPS)[:, None]
        else:
            sk, mean = stats
            band = _f32(np.sqrt(4.0 / max(m, 2)))
            skbad = (sk - 1.0).abs() > p_thresh * band
        for i in range(stats[0].shape[0]):
            warmed = warm > 0.0
            if self.algo == "mad":
                ref_c = torch.where(warmed, c_b, med[i])
                ref_s = torch.where(warmed, s_b, mad[i])
                bad = ((med[i] - ref_c).abs() >
                       p_thresh * (MAD_SIGMA * ref_s + MAD_EPS)) \
                    | (mad[i] > p_mad * (ref_s + MAD_EPS)) \
                    | (~warmed & cold[i])
                good = ~bad
                c_b = torch.where(good, ref_c + a * (med[i] - ref_c), ref_c)
                s_b = torch.where(good, ref_s + a * (mad[i] - ref_s), ref_s)
            else:
                ref_c = torch.where(warmed, c_b, mean[i])
                bad = skbad[i] | (warmed & ((mean[i] - ref_c).abs() >
                                            p_mad * (ref_c + MAD_EPS)))
                good = ~bad
                c_b = torch.where(good, ref_c + a * (mean[i] - ref_c),
                                  ref_c)
                s_b = sk[i]
            warm = torch.where(good, torch.clamp(warm + 1.0, max=WARM_CAP),
                               warm)
            bads.append(bad)
            fills.append(ref_c)
        return torch.stack([c_b, s_b, warm])

    def _windows(self, pwr, state):
        """pwr (ntime, ncell) f32 -> (mask (nrows, ncell) bool, fill rows
        (nrows, ncell) f32, state')."""
        ntime, ncell = pwr.shape
        w = self.window
        nwin, tail = divmod(ntime, w)
        bads, fills = [], []
        for n, m, lo in ((nwin, w, 0), (1 if tail else 0, tail, nwin * w)):
            if n:
                pw = pwr[lo:lo + n * m].reshape(n, m, ncell)
                state = self._walk(self._window_stats(pw), m, state, bads,
                                   fills)
        return torch.stack(bads), torch.stack(fills), state

    # --------------------------------------------------------- execution
    def _apply(self, x, mask, fillr, out):
        fill = fillr if self.fill == "baseline" else None
        if self._resolve() == "cuda":
            return dq_kernel.masked_fill(x, mask, fill, self.window, out)
        return dq_kernel.masked_fill_plain(x, mask, fill, self.window, out)

    def _run(self, pwr, x, key, state, out):
        """The windows and the fill of one gulp from baseline `state`;
        with `state` None, from the plan's own baseline, which it then
        carries -> (y, mask, state')."""
        if self.fill == "baseline" and x.is_complex():
            raise ValueError("flag: fill='baseline' is defined for real "
                             "streams only (an excised complex sample has "
                             "no phase to paint)")
        method = self._resolve()
        self._runtime.last_method = method
        self._runtime.last_origin = "device"
        own = state is None
        if own:
            state = self._ensure_state(key, pwr.shape[1], pwr.device)
        mask, fillr, state = self._windows(pwr, state)
        if own:
            self._state = state
        return self._apply(x, mask, fillr, out), mask, state

    def execute(self, idata, out=None):
        """Flag one logical gulp: (ntime, ...cell...) -> (y, mask) with
        the baseline carried.  y keeps the input's shape; a real integer
        stream is rounded and clipped back to its dtype, another real
        stream keeps its dtype, a complex one becomes complex64.  mask
        is (nwindows, ncell) bool, one row per closed window, cells in C
        order of the non-time axes.  `out`: a tensor of y's shape and
        dtype to write into (a ring span)."""
        return self.step(idata, None, out)[:2]

    def step(self, idata, state, out=None):
        """`execute` from an explicit baseline `state` (None: the plan's
        own) -> (y, mask, state'): the fused group's carry step."""
        if self.window is None:
            raise ValueError("flag: init(window, ...) first")
        x = prepare(idata)
        if x.dim() < 1 or x.shape[0] == 0:
            raise ValueError(f"flag: execute expects a (ntime >= 1, "
                             f"...cell...) gulp, got {tuple(x.shape)}")
        cells = tuple(x.shape[1:])
        ntime = x.shape[0]
        key = (cells, bool(x.is_complex()))
        if x.is_complex():
            xm = x.reshape(ntime, -1).to(torch.complex64)
            re, im = xm.real, xm.imag
            o = None if out is None else out.view(ntime, -1)
            y, mask, state = self._run(re * re + im * im, xm, key, state, o)
            return (out if out is not None else y.view(x.shape)), mask, \
                state
        x32 = x.reshape(ntime, -1).to(torch.float32)
        if x.dtype == torch.float32 and out is not None:
            _, mask, state = self._run(x32, x32, key, state,
                                       out.view(ntime, -1))
            return out, mask, state
        y32, mask, state = self._run(x32, x32, key, state, None)
        if x.dtype.is_floating_point:
            y = y32.to(x.dtype)
        else:
            info = torch.iinfo(x.dtype)
            y = y32.round().clamp(info.min, info.max).to(x.dtype)
        y = y.view(x.shape)
        return (y if out is None else out.copy_(y)), mask, state

    def execute_raw(self, raw, dtype, out=None):
        """Raw ring storage of a complex-integer gulp (time-first header
        order: packed ci4 bytes, or ci8 and wider with the trailing (re,
        im) axis of 2) -> (y complex64 of the logical shape, mask);
        unpacked with `staged_unpack`, then flagged as `execute` flags a
        complex gulp (the same carried baseline)."""
        return self.step_raw(raw, dtype, None, out)[:2]

    def step_raw(self, raw, dtype, state, out=None):
        """`execute_raw` from an explicit baseline `state` (None: the
        plan's own) -> (y, mask, state')."""
        if self.window is None:
            raise ValueError("flag: init(window, ...) first")
        dt = DataType(dtype)
        if raw.dim() < 2:
            raise ValueError(f"flag: execute_raw expects (ntime, "
                             f"...cell...) storage, got shape "
                             f"{tuple(raw.shape)}")
        re, im = staged_unpack(raw, dt)
        shape = re.shape
        ntime = shape[0]
        re, im = re.reshape(ntime, -1), im.reshape(ntime, -1)
        o = None if out is None else out.view(ntime, -1)
        y, mask, state = self._run(re * re + im * im, torch.complex(re, im),
                                   (tuple(shape[1:]), True), state, o)
        return (out if out is not None else y.view(shape)), mask, state

    def plan_report(self):
        """Uniform runtime accounting (ops/runtime.py schema) + the
        flagger plan tail."""
        rep = self._runtime.report()
        rep.update({"algo": self.algo, "window": self.window,
                    "fill": self.fill})
        return rep


def flag(idata, window, algo="mad", thresh=6.0, mad_factor=4.0,
         alpha=0.25, fill="zero", method=None):
    """One-shot RFI flagger from a cold baseline -> (y, mask) (module
    docstring)."""
    plan = Flag(method=method)
    plan.init(window, algo=algo, thresh=thresh, mad_factor=mad_factor,
              alpha=alpha, fill=fill)
    return plan.execute(idata)
