"""Romein gridding plan (counterpart of bifrost_tpu/ops/romein.py and of
the plan-time part of bifrost_tpu/ops/romein_pallas.py).

Each visibility v with grid position (x, y) and an m x m convolution
kernel K scatters v * K into grid[y:y+m, x:x+m] of its plane; every part
of a patch that falls outside the grid drops, on every side (the JAX
scatter wraps negative indices unless remapped, ops/romein.py:109-116;
here they never enter the plan).

API as in the JAX package: ``init(positions, kernels, ngrid, method=)``,
``set_positions``, ``set_kernels``, ``execute(data, grid)``,
``plan_report()``.  Positions (2, ..., nvis) and kernels (broadcastable to
(npol, nvis, m, m)) are plan state from either origin, as in the JAX
package (bifrost_tpu/ops/romein.py:209-235):

- 'host': numpy arrays or lists; the plan is built in numpy
  (`build_plan`, `build_tiles`, `kernel_planes`, `separate_kernels`
  below);
- 'device': a `torch.Tensor` given for either (UVW computed on the card
  by an earlier stage); the plan is built on the tensor's device by the
  torch builders of ops/romein_plan.py, bitwise equal to the host
  builders' tables (the JAX `bin_to_tiles_device` path).  A tensor on
  another device than the data's is moved once, when the plan is built.

`plan_report()["origin"]` says which origin built the last plan and
`plan_build_s` how long it took.

The plan, built once per positions and kernels and cached per (method,
npol, nvis, device, origin) and, for a device origin, the tensors'
identity and version (an in-place edit never serves a stale plan), lists
every in-grid contribution sorted by
destination cell (`build_plan`, the destination sort of the JAX 'sorted'
method, ops/romein.py:311-330, with CSR offsets per cell).  It keeps
broadcast kernel planes as broadcasts: one (m, m) kernel plane, or one
rank-1 (u, v) pair, per distinct leading index, never the (npol, nvis, m,
m) array the JAX host plan materialises.  Kernels that `separate_kernels`
(copied verbatim) finds rank-1 take K6b, the others K6a
(ops/romein_kernel.py, csrc/romein.cu); all planes of a call go in one
launch.  For the kernels the plan is also cut into tiles (`build_tiles`:
tiles of cells, each tile's visibilities in chunks, each cell's list
split by chunk), which keeps every cell's summation order.

Methods (the `romein_method` config flag when None/'auto'): 'cuda' (what
'auto' resolves to: K6a/K6b for a CUDA tensor, their plain versions for a
CPU one) and 'plain' (the plain versions on any device); the two are
bitwise equal.  The JAX methods 'pallas', 'scatter' and 'sorted' and the
'bf16' precision are TPU formulations and raise.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..DataType import DataType
from . import romein_plan
from .romein_kernel import (TILE, WARPS, Tiles, chunk_slots, grid_general,
                            grid_general_plain, grid_separable,
                            grid_separable_plain)
from .runtime import OpRuntime
from .unpack import unpack_logical

METHODS = ("cuda", "plain")
_TPU_METHODS = ("pallas", "scatter", "sorted")


def separate_kernels(kern, tol=1e-5):
    """Rank-1 factor (npol, ndata, m, m) kernels as u[j] * v[k], or None
    (bifrost_tpu/ops/romein_pallas.py:281-333, verbatim).

    Classic gridding kernels (prolate spheroidal, Gaussian, Kaiser-Bessel
    anti-aliasing functions) are outer products of 1-D windows; detecting
    that at plan time lets the gridder use the separable kernel K6b.
    Non-separable kernels (w-projection) take the general kernel K6a.

    Implemented over explicit (re, im) f32 planes: pivot selection by
    |.|^2, division as multiply-by-conjugate over |pivot|^2.
    """
    kern = np.asarray(kern)
    npol, ndata, m, m2 = kern.shape
    kr = np.ascontiguousarray(kern.real, np.float32)
    ki = np.ascontiguousarray(kern.imag, np.float32)
    mag2 = kr * kr + ki * ki
    piv = mag2.reshape(npol, ndata, -1).argmax(-1)
    j0, k0 = piv // m2, piv % m2
    idx_p, idx_d = np.ogrid[:npol, :ndata]
    pvr = kr[idx_p, idx_d, j0, k0]                      # (npol, ndata)
    pvi = ki[idx_p, idx_d, j0, k0]
    denom = pvr * pvr + pvi * pvi
    zero = denom == 0
    safe = np.where(zero, np.float32(1), denom)
    ur = kr[idx_p[..., None], idx_d[..., None], np.arange(m)[None, None],
            k0[..., None]]                              # (npol, ndata, m)
    ui = ki[idx_p[..., None], idx_d[..., None], np.arange(m)[None, None],
            k0[..., None]]
    vnr = kr[idx_p[..., None], idx_d[..., None], j0[..., None],
             np.arange(m2)[None, None]]
    vni = ki[idx_p[..., None], idx_d[..., None], j0[..., None],
             np.arange(m2)[None, None]]
    vr = (vnr * pvr[..., None] + vni * pvi[..., None]) / safe[..., None]
    vi = (vni * pvr[..., None] - vnr * pvi[..., None]) / safe[..., None]
    z = zero[..., None]
    ur = np.where(z, np.float32(0), ur)
    ui = np.where(z, np.float32(0), ui)
    vr = np.where(z, np.float32(0), vr)
    vi = np.where(z, np.float32(0), vi)
    er = ur[..., :, None] * vr[..., None, :] \
        - ui[..., :, None] * vi[..., None, :] - kr
    ei = ur[..., :, None] * vi[..., None, :] \
        + ui[..., :, None] * vr[..., None, :] - ki
    err2 = er * er + ei * ei
    scale2 = max(float(mag2.max()), 1e-30)
    if float(err2.max()) > (tol * tol) * scale2:
        return None
    return ((ur + 1j * ui).astype(np.complex64),
            (vr + 1j * vi).astype(np.complex64))


def build_plan(xs, ys, m, ngrid):
    """Host plan: every in-grid contribution of visibilities with patch
    corners (xs, ys) and an m x m support, sorted by destination cell.
    -> (offsets (ngrid*ngrid + 1,) int32, entries int32), entries[
    offsets[c]:offsets[c+1]] the codes v * m*m + j * m + k of cell c in
    ascending order."""
    xs = np.asarray(xs, np.int64).reshape(-1)
    ys = np.asarray(ys, np.int64).reshape(-1)
    ndata = xs.size
    if ndata * m * m >= 2 ** 31:
        raise ValueError(f"romein: {ndata} visibilities x {m}x{m} overflow "
                         f"the plan's int32 codes")
    dy, dx = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    iy = (ys[:, None, None] + dy[None]).reshape(-1)
    ix = (xs[:, None, None] + dx[None]).reshape(-1)
    keep = (iy >= 0) & (iy < ngrid) & (ix >= 0) & (ix < ngrid)
    code = np.nonzero(keep)[0]
    lin = iy[keep] * ngrid + ix[keep]
    order = np.argsort(lin, kind="stable")
    counts = np.bincount(lin, minlength=ngrid * ngrid)
    offsets = np.zeros(ngrid * ngrid + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets.astype(np.int32), code[order].astype(np.int32)


def build_tiles(offsets, entries, m, ngrid, ndata):
    """The tiled plan of K6a/K6b (csrc/romein.cu), from the CSR plan of
    `build_plan`, at the kernels' geometry (ops/romein_kernel.py reads it
    from their source).  The grid is cut into TILE x TILE cells (ragged at
    the edge); each tile's distinct visibilities S_T, ascending, are cut
    into chunks of `chunk_slots(m)` slots; for each (chunk, cell) the
    cell's contributions whose visibility falls in the chunk form one
    item, and a chunk's items are dealt to WARPS warps, heaviest first in
    snake order.  -> dict of int32 arrays:

    - tile_chunk0 (ntile + 1,): tile t's chunks are tile_chunk0[t] ..
      tile_chunk0[t + 1] - 1, tiles row-major;
    - cellmap (ntile * TILE * TILE,): local cell (ly * TILE + lx) of
      tile t -> its row among the tile's cells with contributions, in
      row-major order, or -1;
    - chunk_vis0 (nchunk + 1,): chunk g's slots s map to visibilities
      svis[chunk_vis0[g] + s], s < chunk_vis0[g + 1] - chunk_vis0[g];
    - svis: every tile's S_T, concatenated;
    - wtab (nchunk * WARPS + 1, 2): warp w of chunk g walks items
      wtab[g*WARPS + w, 0] .. wtab[g*WARPS + w + 1, 0] - 1, whose entries
      start at tent[wtab[g*WARPS + w, 1]] and follow one another;
    - items: the cell's row (cellmap) | count << 16;
    - tent: one per contribution, off | j << 16 | k << 24, where off =
      slot << 8 | (slot % 32) << 3 is the byte offset of the slot's row
      of 32 planes in the kernel's chunk buffer, swizzled for lane 0
      (lane l reads off ^ 8 l).

    A cell's items, in chunk order, list its CSR entries in their order,
    so a walk of the tiled plan sums each cell as the CSR walk does."""
    if not 0 < m < 256:
        raise ValueError(f"romein: a tiled plan needs m < 256 (got {m})")
    tile, warps, chunk = TILE, WARPS, chunk_slots(m)
    mm = m * m
    off = np.asarray(offsets, np.int64)
    ent = np.asarray(entries, np.int64)
    ntx = -(-ngrid // tile)
    ntile = ntx * ntx
    cell = np.repeat(np.arange(ngrid * ngrid), np.diff(off))
    y, x = cell // ngrid, cell % ngrid
    tid = (y // tile) * ntx + x // tile
    lc = (y % tile) * tile + x % tile
    vis = ent // mm
    jk = ent - vis * mm
    # S_T: the distinct (tile, visibility) pairs, ascending.
    uk, inv = np.unique(tid * ndata + vis, return_inverse=True)
    st_tile = uk // ndata
    st0 = np.searchsorted(st_tile, np.arange(ntile + 1))
    slot = np.arange(uk.size) - st0[st_tile]
    nchunk_t = -(-np.diff(st0) // chunk)
    tile_chunk0 = np.zeros(ntile + 1, np.int64)
    np.cumsum(nchunk_t, out=tile_chunk0[1:])
    nchunk = int(tile_chunk0[-1])
    g_t = np.repeat(np.arange(ntile), nchunk_t)
    chunk_vis0 = np.append(st0[g_t] + (np.arange(nchunk) -
                                       tile_chunk0[g_t]) * chunk, uk.size)
    eg = (tile_chunk0[st_tile] + slot // chunk)[inv]
    eslot = (slot % chunk)[inv]
    # Each tile's cells with contributions, numbered in row-major order.
    tcell = np.unique(tid * (tile * tile) + lc)
    cellmap = np.full(ntile * tile * tile, -1, np.int64)
    cellmap[tcell] = np.arange(tcell.size) - np.searchsorted(
        tcell, tcell // (tile * tile) * (tile * tile))
    # Items: the (chunk, cell) groups.  The stable sort keeps each
    # group's entries in CSR order (ascending visibility).
    order = np.lexsort((lc, eg))
    ikey = eg[order] * (tile * tile) + lc[order]
    first = np.flatnonzero(np.diff(ikey, prepend=-1))
    icount = np.diff(np.append(first, ikey.size))
    ig, ilc = ikey[first] // (tile * tile), ikey[first] % (tile * tile)
    # Deal each chunk's items to the warps, heaviest first, in snake
    # order (0..W-1, W-1..0, ...).
    byweight = np.lexsort((ilc, -icount, ig))
    istart = np.searchsorted(ig[byweight], np.arange(nchunk))
    rank = np.arange(icount.size) - istart[ig[byweight]]
    rnd, pos = rank // warps, rank % warps
    warp = np.empty_like(rank)
    warp[byweight] = np.where(rnd % 2 == 0, pos, warps - 1 - pos)
    iorder = np.lexsort((ilc, warp, ig))
    # Entries follow their items in the walk's order.
    walk_rank = np.empty_like(iorder)
    walk_rank[iorder] = np.arange(iorder.size)
    tent_src = order[np.argsort(np.repeat(walk_rank, icount),
                                kind="stable")]
    es = eslot[tent_src]
    tent = ((es << 8) | ((es % 32) << 3) | ((jk[tent_src] // m) << 16) |
            ((jk[tent_src] % m) << 24)).astype(np.uint32).view(np.int32)
    wkey = ig[iorder] * warps + warp[iorder]
    wtab = np.zeros((nchunk * warps + 1, 2), np.int64)
    wtab[:, 0] = np.searchsorted(wkey, np.arange(nchunk * warps + 1))
    wtab[:, 1] = np.append(0, np.cumsum(icount[iorder]))[wtab[:, 0]]
    ig_tile = np.searchsorted(tile_chunk0, ig[iorder], side="right") - 1
    items = cellmap[ig_tile * (tile * tile) + ilc[iorder]] | \
        (icount[iorder] << 16)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return {"tile_chunk0": i32(tile_chunk0), "cellmap": i32(cellmap),
            "chunk_vis0": i32(chunk_vis0),
            "svis": i32(uk % ndata), "wtab": i32(wtab), "items": i32(items),
            "tent": i32(tent)}


def kernel_planes(kern, npol, ndata, m):
    """Kernels -> their distinct planes (nk, nvk, m, m) complex64, nk in
    (1, npol), nvk in (1, ndata): a full (npol * ndata * m * m) array in
    any leading arrangement is (npol, ndata, m, m) (the JAX reshape
    tolerance, ops/romein.py:266-274); anything else must broadcast to
    (npol, ndata, m, m) and stays a broadcast."""
    kern = np.asarray(kern, np.complex64)
    if kern.size == npol * ndata * m * m:
        return kern.reshape(npol, ndata, m, m)
    if kern.ndim < 2 or kern.ndim > 4 or kern.shape[-2:] != (m, m):
        raise ValueError(f"romein: kernels {kern.shape} do not broadcast "
                         f"to ({npol}, {ndata}, {m}, {m})")
    k4 = kern.reshape((1,) * (4 - kern.ndim) + kern.shape)
    if k4.shape[0] not in (1, npol) or k4.shape[1] not in (1, ndata):
        raise ValueError(f"romein: kernels {kern.shape} do not broadcast "
                         f"to ({npol}, {ndata}, {m}, {m})")
    return np.ascontiguousarray(k4)


class RomeinPlan(object):
    """A built plan on one device: the CSR lists, the kernel planes
    (`kern`, or the rank-1 `u`, `v` when `separable`) and, for the
    kernels ('cuda' on a CUDA device), the tiled plan `tiles` (else
    None), built in `tiles_build_s` seconds.  Positions `xs`, `ys` and
    kernels `kern` given as tensors take the torch builders on `device`
    (`origin` 'device'); numpy arrays take the host builders ('host')."""

    def __init__(self, xs, ys, kern, ngrid, npol, ndata, device,
                 method="cuda"):
        m = int(kern.shape[-1])
        device = torch.device(device)
        self.m, self.ngrid, self.npol, self.ndata = m, ngrid, npol, ndata
        on_device = any(isinstance(a, torch.Tensor) for a in (xs, ys, kern))
        self.origin = "device" if on_device else "host"
        if on_device:
            builders = (romein_plan.build_plan, romein_plan.build_tiles,
                        romein_plan.kernel_planes,
                        romein_plan.separate_kernels)

            def put(a):
                if not isinstance(a, torch.Tensor):
                    a = torch.from_numpy(np.ascontiguousarray(a))
                return a.to(device)
            xs, ys, kern = put(xs), put(ys), put(kern)
        else:
            builders = (build_plan, build_tiles, kernel_planes,
                        separate_kernels)

            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        plan_fn, tiles_fn, planes_fn, separate_fn = builders
        offsets, entries = plan_fn(xs, ys, m, ngrid)
        self.ncontrib = int(entries.shape[0])
        self.maxcount = int((offsets[1:] - offsets[:-1]).max()) \
            if offsets.shape[0] > 1 else 0
        planes = planes_fn(kern, npol, ndata, m)
        uv = separate_fn(planes)
        self.separable = uv is not None
        self.offsets, self.entries = put(offsets), put(entries)
        self.tiles, self.tiles_build_s = None, 0.0
        if method == "cuda" and device.type == "cuda":
            t0 = time.perf_counter()
            self.tiles = Tiles(tiles_fn(offsets, entries, m, ngrid, ndata),
                               m, ngrid, ndata, device)
            if on_device:
                torch.cuda.synchronize(device)
            self.tiles_build_s = time.perf_counter() - t0
        if self.separable:
            self.u, self.v = put(uv[0]), put(uv[1])
            self.kern = None
        else:
            self.kern = put(planes)
            self.u = self.v = None
        if on_device and device.type == "cuda":
            torch.cuda.synchronize(device)

    def grid(self, data, out, method, accumulate):
        """Grid data (npol, ndata) complex64 into out (npol, ngrid,
        ngrid) with K6a/K6b ('cuda') or their plain versions."""
        if method != "cuda":
            fn = grid_separable_plain if self.separable else \
                grid_general_plain
            planes = (self.u, self.v) if self.separable else (self.kern,)
            return fn(data, self.offsets, self.entries, *planes, out,
                      accumulate)
        if self.separable:
            return grid_separable(data, self.offsets, self.entries, self.u,
                                  self.v, out, accumulate, self.tiles)
        return grid_general(data, self.offsets, self.entries, self.kern, out,
                            accumulate, self.tiles)


class Romein(object):
    """Plan API (counterpart of bifrost_tpu/ops/romein.py `Romein`)."""

    def __init__(self):
        self.positions = None   # (2, ..., ndata) int: numpy or a tensor
        self.kernels = None     # complex kernels: numpy or a tensor
        self.ngrid = None
        self.m = None
        self.method = "auto"
        self._last_plan = None
        self._runtime = OpRuntime("romein", METHODS,
                                  config_flag="romein_method",
                                  default="cuda")

    # The runtime's stamps of the last execute, as the JAX `Romein`
    # exposes them (bifrost_tpu/ops/romein.py:155-179).
    @property
    def last_method(self):
        """Resolved method of the last execute."""
        return self._runtime.last_method

    @last_method.setter
    def last_method(self, value):
        self._runtime.last_method = value

    @property
    def last_origin(self):
        """Plan-state origin ('host' or 'device') of that execute."""
        return self._runtime.last_origin

    @last_origin.setter
    def last_origin(self, value):
        self._runtime.last_origin = value

    @property
    def last_plan_build_s(self):
        """Seconds the plan took to build (0.0 when served from cache)."""
        return self._runtime.last_plan_build_s

    @last_plan_build_s.setter
    def last_plan_build_s(self, value):
        self._runtime.last_plan_build_s = value

    def init(self, positions, kernels, ngrid, method=None, precision="f32"):
        """method: None/'auto' (the `romein_method` flag, else 'cuda'),
        'cuda' or 'plain'.  precision must be 'f32'."""
        if precision != "f32":
            raise ValueError(
                f"romein: precision {precision!r} is the JAX package's "
                f"single-pass MXU mode; the port grids in f32 only")
        self.set_positions(positions)
        self.set_kernels(kernels)
        self.ngrid = int(ngrid)
        self.method = "auto" if method is None else method
        self._resolve()
        return self

    def _resolve(self):
        if self.method in _TPU_METHODS:
            raise ValueError(
                f"romein: method {self.method!r} is a TPU formulation of "
                f"the JAX package; the port's methods are 'auto', 'cuda' "
                f"(kernels K6a/K6b) and 'plain'")
        return self._runtime.resolve_method(self.method)

    @staticmethod
    def _state(a):
        """Plan state as given: a tensor stays where it is (the device
        origin), anything else becomes a numpy array (the host origin)."""
        return a if isinstance(a, torch.Tensor) else np.asarray(a)

    def set_positions(self, positions):
        self.positions = self._state(positions)
        self._runtime.invalidate()
        self._last_plan = None

    def set_kernels(self, kernels):
        self.kernels = self._state(kernels)
        self.m = int(self.kernels.shape[-1])
        self._runtime.invalidate()
        self._last_plan = None

    @property
    def state_origin(self):
        """'device' when positions or kernels are a tensor (the torch
        builders derive the plan), else 'host' (numpy), as the JAX
        `Romein.state_origin`."""
        return "device" if any(isinstance(a, torch.Tensor) for a in
                               (self.positions, self.kernels)) else "host"

    def plan(self, npol, ndata, device):
        """The built plan for `npol` planes of `ndata` visibilities on
        `device` (cached)."""
        method = self._resolve()
        device = torch.device(device)
        origin = self.state_origin

        def build():
            pos = self.positions.reshape(2, -1, self.positions.shape[-1])
            if pos.shape[-1] != ndata:
                raise ValueError(f"romein: {pos.shape[-1]} positions for "
                                 f"{ndata} visibilities")
            return RomeinPlan(pos[0, 0], pos[1, 0], self.kernels,
                              self.ngrid, npol, ndata, device, method)

        key = (method, npol, ndata, str(device), origin)
        if origin == "device":
            key += tuple((id(a), a._version) if isinstance(a, torch.Tensor)
                         else None for a in (self.positions, self.kernels))
        plan = self._runtime.plan(key, build, method=method, origin=origin)
        self._last_plan = plan
        return plan, method

    def execute(self, idata, odata=None, accumulate=True, dtype=None):
        """Grid `idata` ((npol, ndata), or (..., ndata) complex) onto
        `odata` ((npol, ngrid, ngrid) complex64 tensor, a new zero grid
        when None): the result is added to the grid (`accumulate`, the
        JAX execute's ``grid + gridded``) or replaces it.  `dtype` names
        a packed input's storage type: packed ci4 bytes (one visibility
        a byte) are unpacked to their complex values first, as the JAX
        plan unpacks them before its gridding kernel.  -> the grid."""
        data = idata if isinstance(idata, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(idata))
        if dtype is not None and DataType(dtype).nbit < 8:
            data = unpack_logical(data, dtype)
        data = data.reshape(-1, data.shape[-1])
        if data.dtype != torch.complex64:
            data = data.to(torch.complex64)
        npol, ndata = data.shape
        n = self.ngrid
        if odata is None:
            odata = torch.zeros(npol, n, n, dtype=torch.complex64,
                                device=data.device)
        grid = odata.view(npol, n, n)
        plan, method = self.plan(npol, ndata, data.device)
        plan.grid(data, grid, method, accumulate)
        return odata

    @property
    def separable(self):
        """Whether the last plan took the rank-1 kernel K6b."""
        plan = self._last_plan
        return None if plan is None else plan.separable

    def plan_report(self):
        """Uniform runtime accounting (ops/runtime.py schema) + the
        gridder's geometry and kernel choice."""
        rep = self._runtime.report()
        plan = self._last_plan
        rep.update({"ngrid": self.ngrid, "m": self.m,
                    "kernel": None if plan is None else
                    ("separable" if plan.separable else "general"),
                    "ncontrib": None if plan is None else plan.ncontrib})
        return rep
