"""FIR filter with decimation and carried inter-gulp history (counterpart
of bifrost_tpu/ops/fir.py; reference src/fir.cu bfFir*,
python/bifrost/fir.py).

Each channel's time series is convolved with its coefficient bank (or
one bank shared by all), keeping every `decim`-th output, and the last
ntap - 1 samples carry between gulps, so split gulps are bitwise one
long gulp.  The MAC is kernel K2 (ops/fir_kernel.py), the PFB's.

Methods (the `fir_method` config flag when None/'auto'):

- 'cuda' (what 'auto' resolves to; also what the legacy `fir_pallas`
  bool forces): K2 for a CUDA tensor, its plain version for a CPU one.
- 'plain': the plain PyTorch MAC (`fir_mac_plain`) on any device; the
  JAX package's 'jnp' MAC twin's arithmetic, so bitwise 'cuda'.
- 'conv': ``F.conv1d(groups=lanes)`` over the history-extended lanes
  (TF32 off), the JAX package's grouped-convolution benchmark baseline;
  its reduction order is cuDNN's, so it is not bitwise the MAC.

The JAX package's 'pallas' and 'jnp' are refused with the name of their
counterparts here.

Complex streams fold onto the real MAC as interleaved (re, im) lanes,
lane = chan * 2 + comp, one coefficient column serving both (K2's
`rep` 2); a bank shared by every channel is one column for all lanes.
`execute_raw` takes a ci8 (or wider) ring gulp in storage form, whose
(re, im) pairs already lie in that lane order, so K2 reads int8 voltages
as they lie; packed ci4 is first unpacked to that form
(`ops.unpack.unpack_pairs`), as the PFB does.

Data layout (the reference's): input (ntime, ...chan...), coefficients
(ntap, nchan_flat) or (ntap,); the carried history is (ntap-1,
lanes) f32 in the folded domain, shared by `execute` and `execute_raw`
for one stream.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..DataType import DataType
from ..ndarray import complex_view, structured_to_pair
from .common import finalize
from .fir_kernel import fir_mac, fir_mac_plain, next_state
from .runtime import OpRuntime
from .unpack import unpack_pairs

FIR_METHODS = ("cuda", "plain", "conv")
_JAX_METHODS = {
    "pallas": "the Pallas TPU kernel of the JAX package; its port is "
              "kernel K2, method 'cuda' (or 'auto')",
    "jnp": "the JAX package's jnp MAC twin; its port is the plain "
           "PyTorch MAC, method 'plain'",
}


def _as_tensor(idata):
    """numpy or tensor -> tensor; a structured complex-int array becomes
    its logical complex value."""
    if isinstance(idata, torch.Tensor):
        return idata
    a = np.asarray(idata)
    if a.dtype.names is not None:
        return complex_view(torch.from_numpy(structured_to_pair(a)), "ci8")
    return torch.from_numpy(np.ascontiguousarray(a))


def conv_mac(x, coeffs, state, decim=1, rep=1):
    """The 'conv' method: the MAC of `fir_mac_plain` as one depthwise
    ``F.conv1d`` over the history-extended lanes, TF32 off."""
    ntap = coeffs.shape[0]
    lanes = x.shape[1]
    xin = (torch.cat([state, x.float()]) if ntap > 1 else x.float()).T
    w = coeffs.flip(0).T.repeat_interleave(rep, 0)[:, None, :]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv1d(xin.contiguous()[None], w.contiguous(), stride=decim,
                     groups=lanes)
    return y[0].T.contiguous()


class Fir(object):
    """Plan API of the JAX `Fir` (reference fir.py:38-55): init(coeffs,
    decim), execute / execute_raw per gulp with carried state,
    set_coeffs, reset_state, plan_report.  ``method``: None/'auto' (the
    `fir_method` flag, then 'cuda'), 'cuda', 'plain' or 'conv' (module
    docstring)."""

    def __init__(self, method=None):
        self.coeffs = None          # (ntap, nchan_flat) f64 host master copy
        self.decim = 1
        self._state = None
        self._state_key = None
        self.method = method if method is not None else "auto"
        self._runtime = OpRuntime("fir", FIR_METHODS,
                                  config_flag="fir_method", default="cuda")
        if method not in (None, "auto"):
            self._resolve()

    def init(self, coeffs, decim=1, space=None, method=None):
        """`space` is the reference API's and unused: the plan runs where
        its input lies."""
        self.set_coeffs(coeffs)
        self.decim = int(decim)
        if self.decim < 1:
            raise ValueError(f"fir: decim must be >= 1, got {decim}")
        if method is not None:
            self.method = method
            self._resolve()
        self._state = None
        return self

    def set_coeffs(self, coeffs):
        """New coefficients reset the history.  Equal ones keep the banks
        staged on the device, so a per-sequence re-init (FirBlock) costs
        only the reset."""
        c = np.asarray(coeffs, dtype=np.float64)
        if c.ndim == 1:
            c = c[:, None]
        if c.ndim != 2 or c.shape[0] < 1:
            raise ValueError(f"fir: coeffs must be (ntap,) or (ntap, nchan), "
                             f"got shape {np.shape(coeffs)}")
        unchanged = self.coeffs is not None and \
            np.array_equal(c, self.coeffs)
        self.coeffs = c
        self._state = None
        if not unchanged:
            self._runtime.invalidate()

    def reset_state(self):
        self._state = None

    @property
    def ntap(self):
        return self.coeffs.shape[0]

    # --------------------------------------------------------- execution
    def _resolve(self):
        method = self.method if self.method is not None else "auto"
        if method == "auto":
            from .. import config
            method = config.get("fir_method")
            if method == "auto" and bool(config.get("fir_pallas")):
                method = "cuda"        # the legacy bool: the kernel
        if method in _JAX_METHODS:
            raise ValueError(f"fir: method {method!r} is "
                             f"{_JAX_METHODS[method]}")
        return self._runtime.resolve_method(method)

    def _banks(self, nchan, device):
        """The coefficients for `nchan` channels, (ntap, nchan) banks or
        the one shared column, as f32 on `device`, staged once per device
        and coefficient set (the runtime cache; set_coeffs drops it)."""
        ncol = self.coeffs.shape[1]
        if ncol not in (1, nchan):
            raise ValueError(f"fir: coeff channels {ncol} != data channels "
                             f"{nchan}")
        device = torch.device(device)
        method = self._resolve()

        def build():
            return torch.from_numpy(np.ascontiguousarray(
                self.coeffs, dtype=np.float32)).to(device)

        return self._runtime.plan((str(device),), build, method=method,
                                  origin="host")

    def init_state(self, lanes, device):
        """A fresh zero history: (ntap-1, lanes) f32."""
        return torch.zeros(self.ntap - 1, lanes, dtype=torch.float32,
                           device=device)

    def _mac(self, xf, nchan, state, out):
        """One folded gulp (ntime, nchan or 2 nchan lanes) from history
        `state` (None: the plan's own, which it then carries) -> (y
        (nout, lanes) f32, state')."""
        dev = xf.device
        lanes = xf.shape[1]
        if xf.shape[0] % self.decim:
            raise ValueError(f"fir: gulp length {xf.shape[0]} is not a "
                             f"multiple of decim {self.decim}")
        coeffs = self._banks(nchan, dev)
        rep = lanes // coeffs.shape[1]
        own = state is None
        if own:
            key = (lanes, self.ntap, str(dev))
            if self._state is None or self._state_key != key:
                self._state = self.init_state(lanes, dev)
                self._state_key = key
            state = self._state
        method = self._resolve()
        if method == "cuda":
            y = fir_mac(xf, coeffs, state, self.decim, rep, out=out)
        else:
            mac = fir_mac_plain if method == "plain" else conv_mac
            y = mac(xf, coeffs, state, self.decim, rep)
            if out is not None:
                y = out.copy_(y)
        state = next_state(xf, state)
        if own:
            self._state = state
        return y, state

    def step(self, idata, state, out=None):
        """`execute` from an explicit history `state` (None: the plan's
        own) -> (y, state'): the fused group's carry step (the block's
        `device_kernel_carry`).  `out` (optional): the output tensor."""
        x = _as_tensor(idata)
        ntime = x.shape[0]
        chan_shape = tuple(x.shape[1:])
        nchan = int(np.prod(chan_shape)) if chan_shape else 1
        xm = x.reshape(ntime, nchan)
        nout = ntime // self.decim
        if x.is_complex():
            xf = torch.stack([xm.real, xm.imag], -1).reshape(ntime, -1)
            xf = xf.float().contiguous()
            of = None if out is None else \
                torch.view_as_real(out).view(nout, 2 * nchan)
            y, state = self._mac(xf, nchan, state, of)
            y = torch.view_as_complex(y.view(nout, nchan, 2))
        else:
            xf = xm if xm.dtype in (torch.float32, torch.int8) else \
                xm.float()
            of = None if out is None else out.view(nout, nchan)
            y, state = self._mac(xf.contiguous(), nchan, state, of)
        return y.view((nout,) + chan_shape), state

    def execute(self, idata, odata=None):
        """Filter one logical gulp: (ntime, ...chan...) real or complex ->
        (ntime // decim, ...chan...) f32 or complex64, carrying the
        (ntap-1)-sample history.  ntime must be a multiple of decim."""
        y, _ = self.step(idata, None)
        return finalize(y, out=odata)

    def step_raw(self, raw, dtype, state, out=None):
        """`execute_raw` from an explicit history `state` (None: the
        plan's own) -> (y, state')."""
        dt = DataType(dtype)
        if not (dt.is_complex and dt.is_integer):
            raise ValueError(f"fir: execute_raw expects a complex-integer "
                             f"dtype, got {dt}")
        if raw.dim() < 2:
            raise ValueError(f"fir: execute_raw expects (ntime, ...chan...) "
                             f"storage, got shape {tuple(raw.shape)}")
        if dt.nbit < 8:
            # Packed ci4 becomes its ci8 pair form, which K2 reads as is.
            raw = unpack_pairs(raw, dt)
        if raw.shape[-1] != 2:
            raise ValueError(f"fir: {dt} storage needs a trailing (re, im) "
                             f"axis of 2, got shape {tuple(raw.shape)}")
        ntime = raw.shape[0]
        chan_shape = tuple(raw.shape[1:-1])
        nchan = int(np.prod(chan_shape)) if chan_shape else 1
        nout = ntime // self.decim
        # [time, ...chan..., (re, im)] is the folded lane order as it lies.
        xf = raw.contiguous().view(ntime, 2 * nchan)
        if xf.dtype != torch.int8:
            xf = xf.float()
        of = None if out is None else \
            torch.view_as_real(out).view(nout, 2 * nchan)
        y, state = self._mac(xf, nchan, state, of)
        return torch.view_as_complex(y.view(nout, nchan, 2)) \
            .view((nout,) + chan_shape), state

    def execute_raw(self, raw, dtype, out=None):
        """A ring gulp in storage form (time first: ci8 or wider with its
        trailing (re, im) axis, or packed ci4 bytes) -> complex64
        (ntime // decim, ...chan...), into `out` when given, carrying the
        history shared with `execute` for the same stream."""
        return self.step_raw(raw, dtype, None, out)[0]

    def plan_report(self):
        """The runtime's accounting (ops/runtime.py schema) and the plan's
        ntap and decim: the JAX report's keys."""
        rep = self._runtime.report()
        rep.update({"ntap": self.ntap if self.coeffs is not None else None,
                    "decim": self.decim})
        return rep
