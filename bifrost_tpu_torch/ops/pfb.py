"""Polyphase-filterbank channelizer plan (counterpart of
bifrost_tpu/ops/pfb.py): the F-engine's front half as one planned op on
the ops runtime.

Each gulp runs the ntap-frame FIR MAC against a windowed-sinc prototype
(kernel K2, ops/fir_kernel.py) and the nchan-point DFT as four real
matmuls (ops/pfb_kernel.py); the (ntap-1)-frame history carries between
gulps inside the plan, so split gulps are bitwise equal to one long gulp.

Methods (the `pfb_method` config flag when None/'auto'):

- 'cuda' (what 'auto' resolves to): the MAC runs on kernel K2 for a CUDA
  tensor and on its plain version for a CPU tensor.
- 'plain': the plain PyTorch MAC on any device.

The DFT matmuls are shared, so the two methods are bitwise equal.

Data layout: input (ntime, ...stream...) with time leading; every
non-time axis is an independent stream sharing the prototype.  Output
(ntime // nchan, nchan, ...stream...) complex64.  Real streams take the
full nchan-point complex DFT.  Raw ci8 ring storage (`execute_raw`, the
trailing (re, im) axis of 2) folds into the MAC's lane layout as it lies,
so the kernel reads the voltages at 2 B/sample and lifts them to f32 in
registers (the JAX package's storage-width ingest, ops/pfb.py:37-41).
Packed ci4 storage is first unpacked to that (re, im) int8 form
(`ops.unpack.unpack_pairs`), the values the JAX package's
`staged_unpack_canonical` gives its MAC.
"""

from __future__ import annotations

import numpy as np
import torch

from ..DataType import DataType
from ..ndarray import complex_view, structured_to_pair
from .common import finalize
from .pfb_kernel import _dft_mats, fold_frames, pfb_tiled
from .runtime import OpRuntime
from .unpack import unpack_pairs


def pfb_coeffs(nchan, ntap, window="hamming"):
    """The standard prototype filter: a windowed sinc spanning
    ntap * nchan samples, derived in f64 -> (ntap, nchan).  `window`:
    'hamming' (default), 'hanning', 'blackman', or 'boxcar' (pure
    sinc)."""
    n = ntap * nchan
    x = np.arange(n, dtype=np.float64) / nchan - ntap / 2.0
    wins = {"hamming": np.hamming, "hanning": np.hanning,
            "blackman": np.blackman, "boxcar": np.ones}
    if window not in wins:
        raise ValueError(f"pfb: unknown window {window!r} "
                         f"(expected {'/'.join(sorted(wins))})")
    h = np.sinc(x) * wins[window](n)
    return h.reshape(ntap, nchan)


def _as_tensor(idata):
    """numpy or tensor -> tensor; a structured complex-int array becomes
    its logical complex value."""
    if isinstance(idata, torch.Tensor):
        return idata
    a = np.asarray(idata)
    if a.dtype.names is not None:
        return complex_view(torch.from_numpy(structured_to_pair(a)), "ci8")
    return torch.from_numpy(np.ascontiguousarray(a))


class Pfb(object):
    """Plan API of the JAX `Pfb`: init(nchan, ...), execute / execute_raw
    per gulp with carried inter-gulp state, set_coeffs, reset_state,
    plan_report.  ``method``: None/'auto' (the `pfb_method` flag, else
    'cuda'), 'cuda' or 'plain' (module docstring)."""

    def __init__(self, method=None):
        self.nchan = None
        self.coeffs = None          # (ntap, nchan) f64 host master copy
        self._state = None
        self._state_key = None
        self.method = method if method is not None else "auto"
        self._runtime = OpRuntime("pfb", ("cuda", "plain"),
                                  config_flag="pfb_method", default="cuda")
        if method not in (None, "auto"):
            self._runtime.resolve_method(method)

    def init(self, nchan, coeffs=None, ntap=4, window="hamming",
             method=None):
        self.nchan = int(nchan)
        if self.nchan < 2:
            raise ValueError(f"pfb: nchan must be >= 2, got {nchan}")
        if coeffs is None:
            coeffs = pfb_coeffs(self.nchan, int(ntap), window)
        self.set_coeffs(coeffs)
        if method is not None:
            self.method = method
        self._state = None
        return self

    def set_coeffs(self, coeffs):
        c = np.asarray(coeffs, dtype=np.float64)
        if c.ndim == 1:
            if c.size % self.nchan:
                raise ValueError(
                    f"pfb: flat prototype length {c.size} is not a "
                    f"multiple of nchan ({self.nchan})")
            c = c.reshape(-1, self.nchan)
        if c.shape[1] != self.nchan:
            raise ValueError(
                f"pfb: coeffs expect {c.shape[1]} channels but the plan "
                f"has nchan={self.nchan}")
        unchanged = self.coeffs is not None and \
            np.array_equal(c, self.coeffs)
        self.coeffs = c
        self._state = None
        if not unchanged:
            self._runtime.invalidate()     # drops the staged planes

    def reset_state(self):
        self._state = None

    @property
    def ntap(self):
        return self.coeffs.shape[0]

    # --------------------------------------------------------- execution
    def _resolve(self):
        return self._runtime.resolve_method(self.method)

    def staged(self, device):
        """(prototype, Wre, Wim) f32 on `device`, staged once per method,
        device and coefficient set (the runtime cache; set_coeffs drops
        it)."""
        device = torch.device(device)
        method = self._resolve()

        def build():
            wre, wim = _dft_mats(self.nchan)
            return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in (self.coeffs.astype(np.float32), wre, wim))

        return self._runtime.plan((method, str(device)), build,
                                  method=method, origin="host")

    def init_state(self, nstream, ncomp, device):
        """Fresh zero history: (ntap-1, nchan * nstream * ncomp) f32."""
        return torch.zeros(self.ntap - 1, self.nchan * nstream * ncomp,
                           dtype=torch.float32, device=device)

    def _ensure_state(self, key, nstream, ncomp, device):
        key = (key, self.ntap, self.nchan, str(device))
        if self._state is None or self._state_key != key:
            self._state = self.init_state(nstream, ncomp, device)
            self._state_key = key
        return self._state

    def _run(self, xf, nstream, ncomp, key, state, out):
        """The MAC and the DFT of one folded gulp from history `state`;
        with `state` None, from the plan's own history, which it then
        carries -> (y, state')."""
        dev = xf.device
        coeffs, wre, wim = self.staged(dev)
        own = state is None
        if own:
            state = self._ensure_state(key, nstream, ncomp, dev)
        y, state = pfb_tiled(xf, coeffs, state, wre, wim, self.nchan,
                             nstream, ncomp, method=self._resolve(), out=out)
        if own:
            self._state = state
        return y, state

    def execute(self, idata, odata=None):
        """Channelize one logical gulp: (ntime, ...stream...) real or
        complex -> (ntime // nchan, nchan, ...stream...) complex64,
        carrying the (ntap-1)-frame history.  ntime must be a multiple
        of nchan."""
        y, _ = self.step(idata, None)
        return finalize(y, out=odata)

    def fold(self, idata):
        """A logical gulp (ntime, ...stream...) -> (its folded frames
        (ntime // nchan, lanes), nstream, ncomp, stream shape)."""
        x = _as_tensor(idata)
        ntime = x.shape[0]
        if ntime % self.nchan:
            raise ValueError(
                f"pfb: gulp length {ntime} is not a multiple of nchan "
                f"({self.nchan})")
        chan_shape = tuple(x.shape[1:])
        nstream = int(np.prod(chan_shape)) if chan_shape else 1
        xm = x.reshape(ntime, nstream)
        if x.is_complex():
            return (fold_frames(xm.real.float(), xm.imag.float(),
                                self.nchan), nstream, 2, chan_shape)
        return (fold_frames(xm.float(), None, self.nchan).contiguous(),
                nstream, 1, chan_shape)

    def step(self, idata, state):
        """`execute` from an explicit history `state` (None: the plan's
        own) -> (y, state'): the fused group's carry step (the block's
        `device_kernel_carry`)."""
        xf, nstream, ncomp, chan_shape = self.fold(idata)
        y, state = self._run(xf, nstream, ncomp, (chan_shape, ncomp),
                             state, None)
        return y.reshape((y.shape[0], self.nchan) + chan_shape), state

    def run_shards(self, shards, halos, nstream, ncomp, chan_shape, out):
        """The MAC and DFT of one folded gulp cut into consecutive time
        shards (`shards`, each on its shard's device, at least ntap-1
        frames), into `out` ((frames, nchan, ...stream...) complex64 on
        the plan's device), carrying the plan's own history: the first
        shard starts from it, shard k from `halos[k]`, the last ntap-1
        folded frames of shard k-1 (handed over by the caller's halo
        exchange).  The same MAC rows in the same order as one whole
        gulp, so bitwise that."""
        key = (chan_shape, ncomp)
        state = self._ensure_state(key, nstream, ncomp, out.device)
        f0 = 0
        for k, xk in enumerate(shards):
            st = state if k == 0 else halos[k]
            if st.device != xk.device or st.dtype != torch.float32:
                st = st.to(xk.device, torch.float32)
            y, last = self._run(xk, nstream, ncomp, key, st, None)
            m = y.shape[0]
            out[f0:f0 + m].copy_(y.view((m, self.nchan) + chan_shape))
            f0 += m
        self._state = last if last.device == out.device \
            else last.to(out.device)

    def execute_raw(self, raw, dtype, out=None):
        """Raw ring-storage gulp (time-first: packed ci4 bytes, or ci8
        or wider with its trailing (re, im) axis) -> complex64 (ntime // nchan, nchan,
        ...stream...), into `out` when given, carrying the state shared
        with `execute` for the same stream."""
        return self.step_raw(raw, dtype, None, out)[0]

    def step_raw(self, raw, dtype, state, out=None):
        """`execute_raw` from an explicit history `state` (None: the
        plan's own) -> (y, state')."""
        xf, nstream, chan_shape = self.fold_raw(raw, dtype)
        m = xf.shape[0]
        y, state = self._run(
            xf, nstream, 2, (chan_shape, 2), state,
            None if out is None else out.view(m, self.nchan, nstream))
        return y.view((m, self.nchan) + chan_shape), state

    def fold_raw(self, raw, dtype):
        """Raw ring storage (time-first) -> (its folded frames (ntime //
        nchan, lanes), int8 for ci8 as it lies, nstream, stream shape)."""
        dt = DataType(dtype)
        if not (dt.is_complex and dt.is_integer):
            raise ValueError(f"pfb: execute_raw expects a complex-integer "
                             f"dtype, got {dt}")
        if dt.nbit < 8:
            # Packed ci4 becomes its ci8 pair form, which K2 reads as is.
            raw = unpack_pairs(raw, dt)
        if raw.dim() < 2 or raw.shape[-1] != 2:
            raise ValueError(
                f"pfb: execute_raw expects (ntime, ...stream..., 2) "
                f"storage, got shape {tuple(raw.shape)}")
        ntime = raw.shape[0]
        if ntime % self.nchan:
            raise ValueError(
                f"pfb: gulp length {ntime} is not a multiple of nchan "
                f"({self.nchan})")
        chan_shape = tuple(raw.shape[1:-1])
        nstream = int(np.prod(chan_shape)) if chan_shape else 1
        # [time, ...stream..., (re, im)] is the folded lane order as it
        # lies: lane = (chan * nstream + stream) * 2 + comp.
        xf = raw.contiguous().view(ntime // self.nchan, -1)
        if xf.dtype != torch.int8:
            xf = xf.float()
        return xf, nstream, chan_shape

    def plan_report(self):
        """Uniform runtime accounting (ops/runtime.py schema) + the PFB
        plan tail."""
        rep = self._runtime.report()
        rep.update({"nchan": self.nchan,
                    "ntap": self.ntap if self.coeffs is not None else None})
        return rep


def pfb(idata, nchan, odata=None, coeffs=None, ntap=4, window="hamming",
        method=None):
    """One-shot functional PFB channelizer (fresh zero history);
    returns (ntime // nchan, nchan, ...stream...) complex64."""
    plan = Pfb(method=method)
    plan.init(nchan, coeffs=coeffs, ntap=ntap, window=window)
    return plan.execute(idata, odata)
