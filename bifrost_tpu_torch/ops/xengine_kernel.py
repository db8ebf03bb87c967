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
device raises.  `xengine_int8.launches` counts its calls on the card,
one a gulp: each is X1's two kernels, the corner turn into the int8
planes and the tiles of the Hermitian half.

`xengine_int8_tiled` is the plain twin of that decomposition (the
planes padded as the kernels read them, the tile pairs holding some
i <= j, three int32 sums a tile, each tile's v[i, j] and its mirror
v[j, i]); `tile_pairs` lists the tiles the kernel launches.  Their
geometry (`K_TILE`, `TILE_M`, `TILE_N`, `PITCH`) is read from the
source, so the twin and the kernel cannot disagree.
"""

from __future__ import annotations

import ctypes
import re

import torch

from .. import build

FORMATS = {"ci8": 0, "ci4": 1}


def _constants():
    """csrc/xengine.cu's geometry (its constexprs kKTile, kTileM, kTileN,
    kPitch), read from the source."""
    src = (build.CSRC / "xengine.cu").read_text()
    val = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    return tuple(int(val[k]) for k in ("kKTile", "kTileM", "kTileN",
                                        "kPitch"))


# Samples of time a stage, stations of the i and the j side a tile, the
# multiple the planes' time pitch is rounded up to.
K_TILE, TILE_M, TILE_N, PITCH = _constants()


def pitch(ntime):
    """The planes' time pitch for a gulp of `ntime` frames."""
    return -(-ntime // PITCH) * PITCH


def tile_pairs(nsp):
    """The (i0, j0) corners of the tiles X1 launches, in its block
    order: row tile a takes the column tiles from a * TILE_M / TILE_N,
    the tiles holding some pair i <= j."""
    nb = -(-nsp // TILE_N)
    return [(a * TILE_M, b * TILE_N) for a in range(-(-nsp // TILE_M))
            for b in range(a * TILE_M // TILE_N, nb)]


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


def xengine_int8_tiled(x, fmt, out=None):
    """The plain twin of X1's decomposition -> complex64 (nchan, nsp,
    nsp): the planes zero-padded to whole tiles of time and stations (as
    the corner turn and the zero-filling tile loads leave them), and for
    each tile of `tile_pairs` the three int32 sums rr + ii, ri and ir,
    written as v[i, j] = (rr + ii, ri - ir) where i <= j and as the
    mirror v[j, i] = (rr + ii, ir - ri) where i < j.  Into `out` when
    given; every element is written once."""
    ntime, nchan, nsp = _shape(x, fmt)
    re, im = planes(x, fmt)
    depth = -(-pitch(ntime) // K_TILE) * K_TILE
    rows = max(-(-nsp // TILE_M) * TILE_M, -(-nsp // TILE_N) * TILE_N)
    p = torch.zeros((2, nchan, rows, depth), dtype=torch.int32,
                    device=x.device)
    p[0, :, :nsp, :ntime] = re.permute(1, 2, 0)
    p[1, :, :nsp, :ntime] = im.permute(1, 2, 0)
    if out is None:
        out = torch.empty((nchan, nsp, nsp), dtype=torch.complex64,
                          device=x.device)
    o = torch.view_as_real(out)
    i = torch.arange(TILE_M, device=x.device)[:, None]
    j = torch.arange(TILE_N, device=x.device)[None, :]
    for i0, j0 in tile_pairs(nsp):
        ar, ai = p[:, :, i0:i0 + TILE_M]
        br, bi = p[:, :, j0:j0 + TILE_N]
        accr = ar @ br.mT + ai @ bi.mT
        accp, accq = ar @ bi.mT, ai @ br.mT
        ok = (j0 + j < nsp) & (i0 + i < nsp)
        a, b = torch.nonzero((i0 + i <= j0 + j) & ok, as_tuple=True)
        o[:, i0 + a, j0 + b, 0] = accr[:, a, b].float()
        o[:, i0 + a, j0 + b, 1] = (accp - accq)[:, a, b].float()
        a, b = torch.nonzero((i0 + i < j0 + j) & ok, as_tuple=True)
        o[:, j0 + b, i0 + a, 0] = accr[:, a, b].float()
        o[:, j0 + b, i0 + a, 1] = (accq - accp)[:, a, b].float()
    return out


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("xengine")
        lib.xengine_int8.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 3 +
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2)
        lib.xengine_corner_turn.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 3 +
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p])
        lib.xengine_tiles.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_longlong] * 3 +
            [ctypes.c_void_p] * 2)
        lib.xengine_kernel_info.argtypes = (
            [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4)
        for fn in ("xengine_int8", "xengine_corner_turn", "xengine_tiles",
                   "xengine_kernel_info"):
            getattr(lib, fn).restype = ctypes.c_int
        lib.xengine_error_string.argtypes = [ctypes.c_int]
        lib.xengine_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_info():
    """{'corner_turn_ci4' | 'tiles' | 'corner_turn_ci8': {'regs',
    'local_bytes', 'static_smem', 'dynamic_smem'}} of X1's kernels as
    built (regs at launch: the tiles kernel's setmaxnreg then moves the
    producer's registers to the consumers)."""
    lib = _library()
    out = {}
    for which, name in enumerate(("corner_turn_ci4", "tiles",
                                  "corner_turn_ci8")):
        vals = [ctypes.c_int() for _ in range(4)]
        err = lib.xengine_kernel_info(which,
                                      *(ctypes.byref(v) for v in vals))
        if err:
            raise RuntimeError("xengine_kernel_info failed: " +
                               lib.xengine_error_string(err).decode())
        out[name] = dict(zip(("regs", "local_bytes", "static_smem",
                              "dynamic_smem"), (v.value for v in vals)))
    return out


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
    out is complex64 on x's device; the planes' scratch (2 * nchan *
    nsp * pitch(ntime) bytes) is allocated on x's device each call."""
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
    tp = pitch(ntime)
    scratch = torch.empty((2 * nchan, nsp, tp), dtype=torch.int8,
                          device=x.device)
    err = lib.xengine_int8(x.data_ptr(), FORMATS[fmt], ntime, nchan, nsp,
                           scratch.data_ptr(), tp, out.data_ptr(), stream)
    if err:
        raise RuntimeError("xengine_int8 launch failed: " +
                           lib.xengine_error_string(err).decode())
    xengine_int8.launches += 1
    return out


xengine_int8.launches = 0
