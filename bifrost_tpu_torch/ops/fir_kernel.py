"""Per-lane FIR multiply-accumulate: the hand-written CUDA kernel
(csrc/fir.cu) and its plain PyTorch version.

Replaces bifrost_tpu/ops/fir_pallas.py::_fir_fn (the channels-on-lanes
tile walk behind `fir_tiled`), and through it the MAC stage of
bifrost_tpu/ops/pfb_pallas.py::pfb_tiled.  The plain version is the JAX
module's ``mode='mac'`` twin: taps in ascending k, each multiplying the
sample delayed by ntap-1-k by the mirrored coefficient h[ntap-1-k], with
(ntap-1) rows of carried history in front of the gulp, decimation a
strided select of output rows.  The kernel keeps that order and rounds
every product and sum on its own, so the two are bitwise equal.

`fir_mac` launches a kernel for a CUDA tensor and runs `fir_mac_plain`
only for a tensor on the CPU; any other device raises.  The source has
two kernels, chosen by `fir_vectors`: the vector kernel (a thread owns
8 int8 or 4 f32 lanes of every input row, one load a row, and walks up
to 8 output frames) where the layout allows it, the scalar kernel (one
output a thread) elsewhere.  `fir_mac.launches` counts kernel launches (and
nothing else), `fir_mac.vector_launches` those of the vector kernel.
"""

from __future__ import annotations

import ctypes
import re

import torch

from .. import build


def _constants():
    """csrc/fir.cu's geometry of the vector kernel (its constexprs
    kLanesInt8, kLanesF32 and kMaxTap), read from the source so that the
    route decision and the kernel cannot disagree."""
    src = (build.CSRC / "fir.cu").read_text()
    val = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    return tuple(int(val[k]) for k in ("kLanesInt8", "kLanesF32",
                                        "kMaxTap"))


# Lanes of a row a vector thread owns (int8 x, f32 x); largest ntap of
# the vector kernel.
LANES_INT8, LANES_F32, MAX_TAP = _constants()


def _check_geometry(x, coeffs, state, decim, rep):
    if x.dim() != 2 or coeffs.dim() != 2:
        raise ValueError(f"fir: x must be (ntime, lanes) and coeffs (ntap, "
                         f"ncoef), got {tuple(x.shape)} and "
                         f"{tuple(coeffs.shape)}")
    ntime, lanes = x.shape
    ntap, ncoef = coeffs.shape
    if ntap < 1 or decim < 1 or rep < 1 or ncoef * rep != lanes:
        raise ValueError(f"fir: {ncoef} coefficient columns x rep {rep} "
                         f"do not cover {lanes} lanes (ntap {ntap}, decim "
                         f"{decim})")
    if ntime % decim:
        raise ValueError(f"fir: gulp length {ntime} is not a multiple of "
                         f"decim {decim}")
    if tuple(state.shape) != (ntap - 1, lanes):
        raise ValueError(f"fir: state must be ({ntap - 1}, {lanes}), got "
                         f"{tuple(state.shape)}")
    return ntime // decim, lanes, ntap, ncoef


def fir_mac_plain(x, coeffs, state, decim=1, rep=1):
    """y[j, L] = sum_k xh[j*decim + k, L] * coeffs[ntap-1-k, L // rep], k
    ascending from a zero accumulator, where xh is `state` followed by
    `x` in f32: the JAX 'mac' twin's arithmetic.  x: (ntime, lanes) f32
    or int8; coeffs: (ntap, lanes // rep) f32; state: (ntap-1, lanes)
    f32.  -> (ntime // decim, lanes) f32."""
    nout, lanes, ntap, ncoef = _check_geometry(x, coeffs, state, decim, rep)
    xh = torch.cat([state, x.float()]) if ntap > 1 else x.float()
    acc = torch.zeros(nout, lanes, dtype=torch.float32, device=x.device)
    for k in range(ntap):
        xk = xh[k:k + (nout - 1) * decim + 1:decim]
        ck = coeffs[ntap - 1 - k]
        acc = acc + (xk.reshape(nout, ncoef, rep) *
                     ck[None, :, None]).reshape(nout, lanes)
    return acc


def fir_vectors(x, state, out, ntap):
    """Whether K2 takes its vector kernel: a thread owns V lanes of every
    row (LANES_INT8 for int8 x, LANES_F32 for f32), so the lane count is
    a multiple of V and x, out and (for ntap > 1) state start 16-byte
    aligned; and ntap is one the kernel is instantiated for.  (`rep`
    only decides whether a thread holds one coefficient column or V.)"""
    v = LANES_INT8 if x.dtype == torch.int8 else LANES_F32
    return (x.shape[1] % v == 0 and 1 <= ntap <= MAX_TAP and
            x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 and
            (ntap == 1 or state.data_ptr() % 16 == 0))


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("fir")
        lib.fir_mac.argtypes = [ctypes.c_void_p, ctypes.c_int] + \
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + \
            [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2 + [ctypes.c_int] + \
            [ctypes.c_void_p]
        lib.fir_mac.restype = ctypes.c_int
        lib.fir_error_string.argtypes = [ctypes.c_int]
        lib.fir_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def fir_mac(x, coeffs, state, decim=1, rep=1, out=None):
    """The FIR MAC of `fir_mac_plain` on `x`'s device -> (ntime // decim,
    lanes) f32 (into `out` when given).  On the card every operand must
    be a contiguous tensor there: x f32 or int8, coeffs and state f32."""
    if x.device.type == "cpu":
        y = fir_mac_plain(x, coeffs, state, decim, rep)
        return y if out is None else out.copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"fir_mac: unsupported device {x.device}")
    nout, lanes, ntap, ncoef = _check_geometry(x, coeffs, state, decim, rep)
    if x.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"fir_mac: x must be float32 or int8, got {x.dtype}")
    if out is None:
        out = torch.empty(nout, lanes, dtype=torch.float32, device=x.device)
    for name, t, dt in (("coeffs", coeffs, torch.float32),
                        ("state", state, torch.float32),
                        ("out", out, torch.float32)):
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fir_mac: {name} must be a contiguous {dt} "
                             f"tensor on {x.device}")
    if not x.is_contiguous():
        raise ValueError("fir_mac: x must be contiguous")
    if tuple(out.shape) != (nout, lanes):
        raise ValueError(f"fir_mac: out must be ({nout}, {lanes})")
    vec = fir_vectors(x, state, out, ntap)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fir_mac(x.data_ptr(), int(x.dtype == torch.int8),
                      state.data_ptr(), coeffs.data_ptr(), out.data_ptr(),
                      nout, lanes, ntap, decim, rep, ncoef, int(vec), stream)
    if err:
        raise RuntimeError("fir_mac launch failed: " +
                           lib.fir_error_string(err).decode())
    fir_mac.launches += 1
    fir_mac.vector_launches += vec
    return out


fir_mac.launches = 0
fir_mac.vector_launches = 0


def fir_tiled(x, coeffs, state, decim=1, rep=1, method="cuda"):
    """FIR over (ntime, lanes) `x` with (ntap, lanes // rep) `coeffs` and
    (ntap-1, lanes) carried f32 `state` -> (y, new_state), the port of
    bifrost_tpu/ops/fir_pallas.py::fir_tiled.  `method` 'cuda' takes
    `fir_mac` (the kernel on the card), 'plain' the plain version on any
    device.  new_state is the last ntap-1 rows of state followed by x."""
    if method == "cuda":
        y = fir_mac(x, coeffs, state, decim, rep)
    elif method == "plain":
        y = fir_mac_plain(x, coeffs, state, decim, rep)
    else:
        raise ValueError(f"fir: unknown method {method!r}")
    hist = coeffs.shape[0] - 1
    if hist == 0:
        return y, state
    if x.shape[0] >= hist:
        # A copy: x may be ring memory that the writer reuses.
        return y, x[x.shape[0] - hist:].to(torch.float32, copy=True)
    return y, torch.cat([state, x.float()])[-hist:]
