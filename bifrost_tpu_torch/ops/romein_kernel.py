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

The kernels walk the same lists through the tiled plan (ops/romein.py
`build_tiles`, held here as `Tiles`): tiles of TILE x TILE cells, each
tile's visibilities in chunks (`chunk_slots`), each (chunk, cell)
segment of a cell's list walked by one warp in list order, so the sums
are the CSR walk's.  The wrappers launch the kernel for CUDA tensors,
which needs the tiled plan (`tiles=`, else they raise), and run the
plain version only for tensors on the CPU; any other device raises.
`.launches` on each wrapper counts its kernel launches (and nothing
else).
"""

from __future__ import annotations

import ctypes
import re

import numpy as np
import torch

from .. import build


def _geometry():
    """The tiled plan's geometry as csrc/romein.cu compiles it (its
    constexprs kTile, kChunk, kEntries, kWarps), read from the source so
    that plan and kernel cannot disagree."""
    src = (build.CSRC / "romein.cu").read_text()
    val = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    return tuple(int(val[k]) for k in ("kTile", "kChunk", "kEntries",
                                        "kWarps"))


# Tiles of TILE x TILE cells, chunks of at most CHUNK visibilities and
# ENTRIES contributions, WARPS warps a block.
TILE, CHUNK, ENTRIES, WARPS = _geometry()


def chunk_slots(m):
    """Visibilities per chunk for an m x m support: CHUNK, or fewer where
    a chunk's contributions (at most min(m*m, TILE*TILE) a visibility in a
    tile) could pass ENTRIES."""
    return max(1, min(CHUNK, ENTRIES // min(m * m, TILE * TILE)))


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


class Tiles(object):
    """The tiled plan of one CSR plan on one device: the tables of
    ops/romein.py `build_tiles` (numpy arrays, or the tensors of
    ops/romein_plan.py `build_tiles`) as int32 tensors, with the grid side
    `ngrid`, the kernel support `m` and the visibility count `ndata` they
    were cut for, the number of chunks `nchunk` and the most cells with
    contributions in a tile, `max_cells`."""

    NAMES = ("tile_chunk0", "cellmap", "chunk_vis0", "svis", "wtab",
             "items", "tent")

    def __init__(self, tables, m, ngrid, ndata, device):
        self.m, self.ngrid, self.ndata = int(m), int(ngrid), int(ndata)
        for name in self.NAMES:
            t = tables[name]
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(t)
            setattr(self, name, t.to(device))
        self.nchunk = int(self.chunk_vis0.shape[0]) - 1
        self.max_cells = int(self.cellmap.max()) + 1 \
            if self.cellmap.numel() else 0


def _declare(lib):
    """Set the argument and result types of csrc/romein.cu's functions
    on `lib`, a ctypes library built from it -> lib."""
    lib.romein_grid.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 +
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 +
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] +
        [ctypes.c_int] * 3 + [ctypes.c_void_p] +
        [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.romein_grid.restype = ctypes.c_int
    lib.romein_info.argtypes = [ctypes.c_int] * 3 + \
        [ctypes.POINTER(ctypes.c_int)] * 5
    lib.romein_info.restype = ctypes.c_int
    lib.romein_error_string.argtypes = [ctypes.c_int]
    lib.romein_error_string.restype = ctypes.c_char_p
    return lib


# The library the kernels launch from, built at first use.  romein_bounds.py
# (at the repo root) puts its own builds of csrc/romein.cu here to time the
# gridders' halves apart (PERF.md's open question on the gridders).
_lib = None


def _library():
    global _lib
    if _lib is None:
        _lib = _declare(build.load("romein"))
    return _lib


def kernel_info(separable, source, max_cells):
    """-> dict of the built kernel instantiation's registers, spilled
    bytes per thread ('local_bytes'), static and dynamic shared memory per
    block and resident blocks per SM (CUDA's own attributes) for a plan
    with `max_cells` (`Tiles.max_cells`).  `source`: where the
    instantiation reads kernel taps, 0 device memory (per-plane kernels,
    or too many taps), 1 a table of a shared kernel, 2 each chunk's
    slots' taps of a shared per-visibility kernel."""
    lib = _library()
    vals = [ctypes.c_int() for _ in range(5)]
    err = lib.romein_info(int(separable), int(source), int(max_cells),
                          *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError("romein_info failed: " +
                           lib.romein_error_string(err).decode())
    keys = ("regs", "local_bytes", "smem_static", "smem_dynamic",
            "blocks_per_sm")
    return dict(zip(keys, (v.value for v in vals)))


def _check_tiles(name, tiles, dev, ngrid, m, nvis):
    """Validate the tiled plan of a CUDA launch: cut for this grid,
    support and visibility count, its tables int32, contiguous, on `dev`
    and of the shapes the grid gives them."""
    if tiles is None:
        raise ValueError(f"{name}: a CUDA launch needs the tiled plan "
                         f"(ops/romein.py build_tiles, RomeinPlan.tiles)")
    if (tiles.ngrid, tiles.m, tiles.ndata) != (ngrid, m, nvis):
        raise ValueError(f"{name}: tiled plan for ngrid {tiles.ngrid}, m "
                         f"{tiles.m}, {tiles.ndata} visibilities; the "
                         f"launch has {ngrid}, {m}, {nvis}")
    ntx = -(-ngrid // TILE)
    if not 0 <= tiles.max_cells <= TILE * TILE:
        raise ValueError(f"{name}: tiles.max_cells {tiles.max_cells} is "
                         f"not a tile's cell count")
    want = {"tile_chunk0": (ntx * ntx + 1,),
            "cellmap": (ntx * ntx * TILE * TILE,),
            "chunk_vis0": (tiles.nchunk + 1,),
            "wtab": (tiles.nchunk * WARPS + 1, 2)}
    for what in Tiles.NAMES:
        t = getattr(tiles, what)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: tiles.{what} must be contiguous "
                             f"int32")
        if t.device != dev:
            raise ValueError(f"{name}: every operand must be on {dev}")
        if what in want and tuple(t.shape) != want[what]:
            raise ValueError(f"{name}: tiles.{what} has shape "
                             f"{tuple(t.shape)}, expected {want[what]} "
                             f"for ngrid {ngrid}")
        if what not in want and t.dim() != 1:
            raise ValueError(f"{name}: tiles.{what} must be 1-D")


def _launch(name, data, ka, kb, out, accumulate, tiles):
    """Validate the operands of a CUDA launch and launch K6a (kb None) or
    K6b.  The kernels walk the tiled plan alone."""
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
    for t in (out,) + planes:
        if t.device != dev:
            raise ValueError(f"{name}: every operand must be on {dev}")
    _check_tiles(name, tiles, dev, ngrid, m, nvis)
    kps = 0 if nk == 1 else ka[0].numel()
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.romein_grid(
        data.data_ptr(), data.stride(0), data.stride(1), nplane,
        *(getattr(tiles, t).data_ptr() for t in Tiles.NAMES),
        tiles.max_cells, ngrid, chunk_slots(m), ka.data_ptr(),
        None if kb is None else kb.data_ptr(), kps, int(nvk > 1), m,
        int(kb is not None), out.data_ptr(), out.stride(0), out.stride(2),
        int(bool(accumulate)), stream)
    if err:
        raise RuntimeError(f"{name} launch failed: " +
                           lib.romein_error_string(err).decode())
    return out


def grid_general(data, offsets, entries, kern, out, accumulate=False,
                 tiles=None):
    """K6a on `data`'s device: `grid_general_plain`'s result in `out`.
    On the CPU the plain version walks the CSR plan (offsets, entries).
    On the card the kernel walks `tiles`, the plan's `Tiles` (required
    there), and every operand lies there: data complex64 (nplane, nvis),
    kern contiguous complex64 (nk, nvk, m, m) with nk in (1, nplane) and
    nvk in (1, nvis), out complex64 (nplane, ngrid, ngrid) with evenly
    strided cells."""
    if data.device.type == "cpu":
        return grid_general_plain(data, offsets, entries, kern, out,
                                  accumulate)
    if data.device.type != "cuda":
        raise ValueError(f"grid_general: unsupported device {data.device}")
    _launch("grid_general", data, kern, None, out, accumulate, tiles)
    grid_general.launches += 1
    return out


def grid_separable(data, offsets, entries, u, v, out, accumulate=False,
                   tiles=None):
    """K6b on `data`'s device: `grid_separable_plain`'s result in `out`,
    with the operands of `grid_general` and the rank-1 factors u, v
    (nk, nvk, m) in place of the kernel."""
    if data.device.type == "cpu":
        return grid_separable_plain(data, offsets, entries, u, v, out,
                                    accumulate)
    if data.device.type != "cuda":
        raise ValueError(f"grid_separable: unsupported device "
                         f"{data.device}")
    _launch("grid_separable", data, u, v, out, accumulate, tiles)
    grid_separable.launches += 1
    return out


grid_general.launches = 0
grid_separable.launches = 0
