"""Romein gridding: the hand-written CUDA kernels (csrc/romein.cu) and
their plain PyTorch versions.

Replaces the two gridders of bifrost_tpu/ops/romein_pallas.py:

- K6a, `grid_general` (``_gridder_fn``): per-visibility m x m kernels,
  ``grid[p, y+j, x+k] += d[p, v] * K[j, k]``;
- K6b, `grid_separable` (``_gridder_sep_fn``): rank-1 kernels
  K[j, k] = u[j] v[k], ``grid[p, y+j, x+k] += u[j] * (d[p, v] * v[k])``.

Both walk one plan (ops/romein.py `build_plan`): for each destination
cell, its in-grid contributions in ascending code order, the code being
``v * m*m + j * m + k`` (CSR: ``offsets`` (ncell + 1,) and ``entries``
int32).  Each cell's contributions are summed in that order from +0.0,
every product and sum rounded on its own, then written to the grid (or
added to it, ``accumulate=True``).  The plain versions walk the same lists
rank by rank (the r-th contribution of every cell that has one, for r = 0,
1, ...), so kernel and plain version are bitwise equal on every input, and
reruns are bit-identical.  Against the JAX package's one-hot MXU gridders
(another summation order) they agree to a tolerance.

Kernel planes are broadcasts: ``kern`` is (nk, nvk, m, m) and u, v are
(nk, nvk, m), with nk 1 or the number of data planes and nvk 1 or the
number of visibilities.  ``data`` is (nplane, nvis) complex64 and ``out``
(nplane, ngrid, ngrid) complex64, each with any element strides (a
time-last ring span is read and written in place).

The wrappers launch the kernel for CUDA tensors and run the plain version
only for tensors on the CPU; any other device raises.  `.launches` on
each wrapper counts its kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import build


def _rank_walk(data, offsets, entries, contrib):
    """Sum each cell's contributions in list order from +0.0 -> (accr,
    acci) f32 (nplane, ncell).  `contrib(code)` gives the (re, im)
    (nplane, n) of the contributions with codes (n,)."""
    nplane = data.shape[0]
    ncell = offsets.numel() - 1
    dev = data.device
    off = offsets.to(torch.int64)
    counts = (off[1:] - off[:-1]).cpu().numpy()
    # Cells by count, largest first: the cells with an r-th contribution
    # are then a prefix of this order.
    order = np.argsort(-counts, kind="stable")
    nactive = np.bincount(counts, minlength=1)[::-1].cumsum()[::-1]
    accr = torch.zeros(nplane, ncell, dtype=torch.float32, device=dev)
    acci = torch.zeros_like(accr)
    order_t = torch.from_numpy(order).to(dev)
    start = off[:-1][order_t]
    for r in range(1, len(nactive)):
        n = int(nactive[r])
        code = entries[start[:n] + (r - 1)].to(torch.int64)
        cr, ci = contrib(code)
        accr[:, :n].add_(cr)
        acci[:, :n].add_(ci)
    outr = torch.empty_like(accr)
    outi = torch.empty_like(acci)
    outr[:, order_t] = accr
    outi[:, order_t] = acci
    return outr, outi


def _cmul(ar, ai, br, bi):
    """(ar + i ai)(br + i bi), each product and sum rounded on its own."""
    return ar * br - ai * bi, ar * bi + ai * br


def _kernel_index(kern, code_part):
    """Kernel values at flat indices of each kernel plane -> (re, im) of
    shape (nk, n), which broadcast over the data planes."""
    flat = kern.reshape(kern.shape[0], -1)[:, code_part]
    return flat.real, flat.imag


def _finish(accr, acci, out, accumulate):
    grid = torch.complex(accr, acci).view(out.shape)
    if accumulate:
        grid = out + grid
    out.copy_(grid)
    return out


def grid_general_plain(data, offsets, entries, kern, out,
                       accumulate=False):
    """K6a's plain version: data (nplane, nvis) complex64, the plan's
    (offsets, entries), kern (nk, nvk, m, m) complex64, out (nplane,
    ngrid, ngrid) complex64 -> out."""
    m = kern.shape[-1]
    mm = m * m
    nvk = kern.shape[1]
    dr, di = data.real, data.imag

    def contrib(code):
        vis = torch.div(code, mm, rounding_mode="floor")
        jk = code - vis * mm
        kr, ki = _kernel_index(kern, (vis if nvk > 1 else 0) * mm + jk)
        return _cmul(dr[:, vis], di[:, vis], kr, ki)

    accr, acci = _rank_walk(data, offsets, entries, contrib)
    return _finish(accr, acci, out, accumulate)


def grid_separable_plain(data, offsets, entries, u, v, out,
                         accumulate=False):
    """K6b's plain version: as `grid_general_plain` with the rank-1
    factors u, v (nk, nvk, m) complex64 in place of the kernel."""
    m = u.shape[-1]
    mm = m * m
    nvk = u.shape[1]
    dr, di = data.real, data.imag

    def contrib(code):
        vis = torch.div(code, mm, rounding_mode="floor")
        jk = code - vis * mm
        j = torch.div(jk, m, rounding_mode="floor")
        k = jk - j * m
        base = (vis if nvk > 1 else 0) * m
        ur, ui = _kernel_index(u, base + j)
        vr, vi = _kernel_index(v, base + k)
        wr, wi = _cmul(dr[:, vis], di[:, vis], vr, vi)
        return _cmul(ur, ui, wr, wi)

    accr, acci = _rank_walk(data, offsets, entries, contrib)
    return _finish(accr, acci, out, accumulate)


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = build.load("romein")
        lib.romein_grid.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_longlong] * 2 +
            [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 +
            [ctypes.c_void_p] * 2 + [ctypes.c_longlong] +
            [ctypes.c_int] * 3 + [ctypes.c_void_p] +
            [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
        lib.romein_grid.restype = ctypes.c_int
        lib.romein_error_string.argtypes = [ctypes.c_int]
        lib.romein_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(name, data, offsets, entries, ka, kb, out, accumulate):
    """Validate the operands of a CUDA launch and launch K6a (kb None) or
    K6b."""
    dev = data.device
    if data.dtype != torch.complex64 or data.dim() != 2:
        raise TypeError(f"{name}: data must be complex64 (nplane, nvis), "
                        f"got {data.dtype} {tuple(data.shape)}")
    nplane, nvis = data.shape
    if out.dtype != torch.complex64 or out.dim() != 3 or \
            out.shape[0] != nplane or out.shape[1] != out.shape[2]:
        raise ValueError(f"{name}: out must be complex64 ({nplane}, ngrid, "
                         f"ngrid), got {out.dtype} {tuple(out.shape)}")
    ngrid = out.shape[1]
    if out.stride(1) != ngrid * out.stride(2):
        raise ValueError(f"{name}: out's cells must be evenly strided "
                         f"(strides {out.stride()})")
    ncell = ngrid * ngrid
    for t, what in ((offsets, "offsets"), (entries, "entries")):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous int32")
    if offsets.numel() != ncell + 1:
        raise ValueError(f"{name}: offsets has {offsets.numel()} entries "
                         f"for {ncell} cells")
    planes = (ka,) if kb is None else (ka, kb)
    for t in planes:
        if t.dtype != torch.complex64 or not t.is_contiguous():
            raise ValueError(f"{name}: kernel planes must be contiguous "
                             f"complex64")
    m = ka.shape[-1]
    nk, nvk = ka.shape[0], ka.shape[1]
    want = (nk, nvk, m, m) if kb is None else (nk, nvk, m)
    if tuple(ka.shape) != want or (kb is not None and
                                   tuple(kb.shape) != want) or \
            nk not in (1, nplane) or nvk not in (1, nvis):
        raise ValueError(f"{name}: kernel planes {tuple(ka.shape)} do not "
                         f"broadcast over ({nplane}, {nvis})")
    if nvis * m * m >= 2 ** 31:
        raise ValueError(f"{name}: {nvis} visibilities x {m}x{m} overflow "
                         f"the plan's int32 codes")
    for t in (offsets, entries, out) + planes:
        if t.device != dev:
            raise ValueError(f"{name}: every operand must be on {dev}")
    kps = 0 if nk == 1 else ka[0].numel()
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.romein_grid(
        data.data_ptr(), data.stride(0), data.stride(1), offsets.data_ptr(),
        entries.data_ptr(), ncell, nplane, ka.data_ptr(),
        None if kb is None else kb.data_ptr(), kps, int(nvk > 1), m,
        int(kb is not None), out.data_ptr(), out.stride(0), out.stride(2),
        int(bool(accumulate)), stream)
    if err:
        raise RuntimeError(f"{name} launch failed: " +
                           lib.romein_error_string(err).decode())
    return out


def grid_general(data, offsets, entries, kern, out, accumulate=False):
    """K6a on `data`'s device: `grid_general_plain`'s result in `out`.
    On the card every operand lies there: data complex64 (nplane, nvis),
    offsets/entries contiguous int32, kern contiguous complex64 (nk, nvk,
    m, m) with nk in (1, nplane) and nvk in (1, nvis), out complex64
    (nplane, ngrid, ngrid) with evenly strided cells."""
    if data.device.type == "cpu":
        return grid_general_plain(data, offsets, entries, kern, out,
                                  accumulate)
    if data.device.type != "cuda":
        raise ValueError(f"grid_general: unsupported device {data.device}")
    _launch("grid_general", data, offsets, entries, kern, None, out,
            accumulate)
    grid_general.launches += 1
    return out


def grid_separable(data, offsets, entries, u, v, out, accumulate=False):
    """K6b on `data`'s device: `grid_separable_plain`'s result in `out`,
    with the operands of `grid_general` and the rank-1 factors u, v
    (nk, nvk, m) in place of the kernel."""
    if data.device.type == "cpu":
        return grid_separable_plain(data, offsets, entries, u, v, out,
                                    accumulate)
    if data.device.type != "cuda":
        raise ValueError(f"grid_separable: unsupported device "
                         f"{data.device}")
    _launch("grid_separable", data, offsets, entries, u, v, out,
            accumulate)
    grid_separable.launches += 1
    return out


grid_general.launches = 0
grid_separable.launches = 0
