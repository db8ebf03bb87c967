"""The exact int8 X-engine: kernel X1 (csrc/xengine.cu) and its plain
PyTorch version.

    v[c, i, j] = sum_t conj(x[t, c, i]) * x[t, c, j]

on integer voltages in canonical (time, freq, station*pol) order, as
``vr = rr + ii`` and ``vi = ri - ir`` summed exactly, then converted to
f32 -> complex64 (nchan, nsp, nsp).  X1 has no Pallas counterpart: the
JAX package's int8 engine is four ``jnp.einsum(...,
preferred_element_type=int32)`` products outside any kernel
(bifrost_tpu/blocks/correlate.py, ``_xengine_planes_core``).  Every
partial sum is an integer below 2^31 under the correlate block's gulp
guard, so the kernel, the plain version and the JAX engine agree bit
for bit.

Input storage forms (`fmt`): ``'ci8'``, an int8 (ntime, nchan, nsp, 2)
tensor of (re, im) pairs, or ``'ci4'``, a uint8 (ntime, nchan, nsp)
tensor of packed bytes (re in the high nibble).  Another axis order is
one ``permute(...).contiguous()`` first (the correlate block's raw head
does that).

The plain version contracts the int8 planes as f64 `torch.matmul` on
either device, exact because every partial sum is an integer below
2^53; the f64 -> f32 conversion rounds as int32 -> f32 would.  `xengine_int8` launches X1 for a CUDA
tensor and runs the plain version only for a CPU tensor; any other
device raises.  `xengine_int8.launches` counts its kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

FORMATS = {"ci8": 0, "ci4": 1}


def planes(x, fmt):
    """Storage-form gulp -> its (re, im) int8 planes (ntime, nchan,
    nsp): ci8 pairs split, ci4 nibbles sign-extended (the high nibble
    is re)."""
    if fmt == "ci8":
        return x[..., 0], x[..., 1]
    if fmt == "ci4":
        b = x.view(torch.int8)
        return b >> 4, (b << 4) >> 4
    raise ValueError(f"xengine: unknown storage form {fmt!r} "
                     f"(expected {'/'.join(FORMATS)})")


def xengine_int8_plain(x, fmt, out=None):
    """X1's plain version: the exact contraction of `x`'s int8 planes
    -> complex64 (nchan, nsp, nsp) (into `out` when given)."""
    re, im = planes(x, fmt)
    a = re.double().permute(1, 0, 2)               # (nchan, ntime, nsp)
    b = im.double().permute(1, 0, 2)
    v = torch.complex((a.mT @ a + b.mT @ b).float(),
                      (a.mT @ b - b.mT @ a).float())
    return v if out is None else out.copy_(v)


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("xengine")
        lib.xengine_int8.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 3 +
            [ctypes.c_void_p] * 2)
        lib.xengine_int8.restype = ctypes.c_int
        lib.xengine_error_string.argtypes = [ctypes.c_int]
        lib.xengine_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _shape(x, fmt):
    """-> (ntime, nchan, nsp) of a storage-form gulp, checked."""
    if fmt not in FORMATS:
        raise ValueError(f"xengine: unknown storage form {fmt!r} "
                         f"(expected {'/'.join(FORMATS)})")
    want = (torch.int8, 4) if fmt == "ci8" else (torch.uint8, 3)
    if (x.dtype, x.dim()) != want or (fmt == "ci8" and x.shape[-1] != 2):
        raise TypeError(f"xengine: {fmt} storage must be {want[0]} with "
                        f"{want[1]} axes{' (trailing 2)' if fmt == 'ci8' else ''}"
                        f", got {x.dtype} {tuple(x.shape)}")
    return tuple(int(n) for n in x.shape[:3])


def xengine_int8(x, fmt, out=None):
    """X1 on `x`'s device -> complex64 (nchan, nsp, nsp) in `out`
    (allocated when None).  On the card x and out are contiguous and
    out is complex64 on x's device."""
    ntime, nchan, nsp = _shape(x, fmt)
    if x.device.type == "cpu":
        return xengine_int8_plain(x, fmt, out)
    if x.device.type != "cuda":
        raise ValueError(f"xengine_int8: unsupported device {x.device}")
    if out is None:
        out = torch.empty((nchan, nsp, nsp), dtype=torch.complex64,
                          device=x.device)
    if out.dtype != torch.complex64 or out.numel() != nchan * nsp * nsp \
            or out.device != x.device or not out.is_contiguous():
        raise ValueError(f"xengine_int8: out must be contiguous complex64 "
                         f"({nchan}, {nsp}, {nsp}) on {x.device}")
    if not x.is_contiguous():
        raise ValueError("xengine_int8: x must be contiguous")
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.xengine_int8(x.data_ptr(), FORMATS[fmt], ntime, nchan, nsp,
                           out.data_ptr(), stream)
    if err:
        raise RuntimeError("xengine_int8 launch failed: " +
                           lib.xengine_error_string(err).decode())
    xengine_int8.launches += 1
    return out


xengine_int8.launches = 0
