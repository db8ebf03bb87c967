"""Data-quality apply stage: the hand-written CUDA kernels
(csrc/dq.cu) and their plain PyTorch versions.

Replaces the two kernels of bifrost_tpu/ops/dq_pallas.py:

- K5a, `masked_fill` (``_fill_fn``): ``y[t, c] = fill[r, c] if
  mask[r, c] else x[t, c]`` with ``r = t // window``, on an (ntime, ncell)
  float32 or complex64 gulp; the flagger's per-window rows are read as
  they are, never repeated up to frame rate, and a complex gulp is one
  launch (a cell's (re, im) pair shares its mask).  ``fill`` is None for
  zeros (always, for complex gulps).
- K5b, `gain_apply` (``_gain_fn``): ``y[t, c] = x[t, c] * g[c]`` over
  complex64, computed as ``(re*gr - im*gi, re*gi + im*gr)`` with every
  product and difference rounded on its own.

The plain versions compute the same in the kernels' order, so each
kernel is bitwise equal to its plain version on every input.  Against
the JAX package on the CPU the fill is bitwise too; the gain multiply
differs by XLA:CPU's FMA contraction of ``re*gr - im*gi`` (at most one
rounding of ``|re*gr| + |im*gi|``).

The wrappers launch the kernel for CUDA tensors and run the plain
version only for tensors on the CPU; any other device raises.  ``x`` and
``out`` may have any element strides (a ring span is read and written in
place).  `.launches` on each wrapper counts its kernel launches (and
nothing else).  K5a has two kernels, chosen by layout (`fill_vectors`):
16-byte vectors where x and out hold their cells contiguously at
16-byte aligned bases and row strides, one element a thread otherwise;
`masked_fill.vector_launches` counts the vector kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build


def _rows(ntime, window, device):
    return torch.div(torch.arange(ntime, device=device), window,
                     rounding_mode="floor")


def masked_fill_plain(x, mask, fill, window, out=None):
    """K5a's plain version: x (ntime, ncell) float32 or complex64, mask
    (nrows, ncell) bool with nrows = ceil(ntime / window), fill the same
    shape in float32 or None for zeros -> y (into `out` when given)."""
    rows = _rows(x.shape[0], window, x.device)
    f = torch.zeros((), dtype=x.dtype, device=x.device) if fill is None \
        else fill[rows]
    m = mask[rows]
    y = torch.where(m if m.dtype == torch.bool else m != 0, f, x)
    return y if out is None else out.copy_(y)


def gain_apply_plain(x, g, out=None):
    """K5b's plain version: x (ntime, ncell) complex64, g (ncell,)
    complex64 -> x * g per cell, each product and sum rounded on its own,
    on separate f32 planes."""
    re, im = x.real, x.imag
    gr, gi = g.real, g.imag
    y = torch.complex(re * gr - im * gi, re * gi + im * gr)
    return y if out is None else out.copy_(y)


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("dq")
        lib.dq_masked_fill.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] +
            [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2 +
            [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2 +
            [ctypes.c_void_p])
        lib.dq_masked_fill.restype = ctypes.c_int
        lib.dq_gain_apply.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_longlong] * 2 +
            [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4 +
            [ctypes.c_void_p])
        lib.dq_gain_apply.restype = ctypes.c_int
        lib.dq_error_string.argtypes = [ctypes.c_int]
        lib.dq_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_pair(name, x, out, dtypes):
    if x.dtype not in dtypes or x.dim() != 2:
        raise TypeError(f"{name}: x must be {' or '.join(map(str, dtypes))} "
                        f"(ntime, ncell), got {x.dtype} {tuple(x.shape)}")
    if out.dtype != x.dtype or out.shape != x.shape or \
            out.device != x.device:
        raise ValueError(f"{name}: out must be {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    lo = lambda t: t.data_ptr()                          # noqa: E731
    hi = lambda t: t.data_ptr() + t.element_size() * (   # noqa: E731
        sum((n - 1) * s for n, s in zip(t.shape, t.stride())) + 1)
    if x.numel() and lo(x) < hi(out) and lo(out) < hi(x):
        raise ValueError(f"{name}: out overlaps x")


def fill_vectors(x, out):
    """Whether K5a moves x -> out in 16-byte vectors: both hold their
    cells contiguously (cell stride 1) at 16-byte aligned bases and row
    strides."""
    return all(t.stride(1) == 1 and t.data_ptr() % 16 == 0 and
               t.stride(0) * t.element_size() % 16 == 0 for t in (x, out))


def _device_check(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def masked_fill(x, mask, fill, window, out=None):
    """K5a on `x`'s device: `masked_fill_plain`'s result in `out`
    (allocated when None).  On the card mask is a contiguous bool or
    uint8 tensor there, fill a contiguous float32 one or None (None for
    a complex64 x), and out must not overlap x."""
    if x.device.type == "cpu":
        return masked_fill_plain(x, mask, fill, window, out)
    _device_check("masked_fill", x)
    if out is None:
        out = torch.empty_like(x)
    _check_pair("masked_fill", x, out, (torch.float32, torch.complex64))
    ntime, ncell = x.shape
    window = int(window)
    nrows = -(-ntime // window) if window > 0 else 0
    if window < 1 or mask.dtype not in (torch.bool, torch.uint8) or \
            tuple(mask.shape) != (nrows, ncell) or \
            not mask.is_contiguous() or mask.device != x.device:
        raise ValueError(f"masked_fill: mask must be contiguous bool "
                         f"({nrows}, {ncell}) on {x.device} for window "
                         f"{window}")
    cplx = x.dtype == torch.complex64
    if fill is not None:
        if cplx:
            raise ValueError("masked_fill: a complex gulp fills with zeros "
                             "(fill=None)")
        if fill.dtype != torch.float32 or fill.shape != mask.shape or \
                not fill.is_contiguous() or fill.device != x.device:
            raise ValueError(f"masked_fill: fill must be contiguous float32 "
                             f"({nrows}, {ncell}) on {x.device}")
    vec = fill_vectors(x, out)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dq_masked_fill(
        x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr(),
        out.stride(0), out.stride(1), mask.data_ptr(),
        None if fill is None else fill.data_ptr(), ntime, ncell, window,
        int(cplx), int(vec), stream)
    if err:
        raise RuntimeError("masked_fill launch failed: " +
                           lib.dq_error_string(err).decode())
    masked_fill.launches += 1
    masked_fill.vector_launches += vec
    return out


def gain_apply(x, g, out=None):
    """K5b on `x`'s device: `gain_apply_plain`'s result in `out`
    (allocated when None).  On the card g is a contiguous complex64
    (ncell,) tensor there and out must not overlap x."""
    if x.device.type == "cpu":
        return gain_apply_plain(x, g, out)
    _device_check("gain_apply", x)
    if out is None:
        out = torch.empty_like(x)
    _check_pair("gain_apply", x, out, (torch.complex64,))
    ntime, ncell = x.shape
    if g.dtype != torch.complex64 or tuple(g.shape) != (ncell,) or \
            not g.is_contiguous() or g.device != x.device:
        raise ValueError(f"gain_apply: g must be contiguous complex64 "
                         f"({ncell},) on {x.device}")
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.dq_gain_apply(
        x.data_ptr(), x.stride(0), x.stride(1), g.data_ptr(), out.data_ptr(),
        out.stride(0), out.stride(1), ntime, ncell, stream)
    if err:
        raise RuntimeError("gain_apply launch failed: " +
                           lib.dq_error_string(err).decode())
    gain_apply.launches += 1
    return out


masked_fill.launches = 0
masked_fill.vector_launches = 0
gain_apply.launches = 0
