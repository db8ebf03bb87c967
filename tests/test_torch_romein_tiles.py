"""The tiled plan of the Romein kernels K6a/K6b (bifrost_tpu_torch.ops.
romein `build_tiles`) on the CPU.

The kernels (csrc/romein.cu) walk the tiled plan: per tile, chunk and
warp, items of one cell each, whose entries name a slot of the chunk's
visibilities and the kernel tap (j, k).  Their sums are bitwise those of
the plain versions only if every cell's contributions come out of the
tiled tables in its CSR order, so these tests rebuild every cell's list
from the tables and compare it with the CSR plan exactly, and sum a
seeded grid through the tables in the kernel's order (`_walk`, a test
helper, not a second plain version) against `grid_general_plain` and
`grid_separable_plain`, bitwise, with -0.0 in the starting grid.  The
kernels themselves run in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch

from bifrost_tpu_torch.ops.romein import (RomeinPlan, build_plan,
                                          build_tiles, kernel_planes,
                                          separate_kernels)
from bifrost_tpu_torch.ops.romein_kernel import (CHUNK, ENTRIES, TILE,
                                                 WARPS, Tiles, _check_tiles,
                                                 chunk_slots,
                                                 grid_general_plain,
                                                 grid_separable_plain)
from bifrost_tpu_torch.service import default_uvw


def _unpack(tb, m, ngrid):
    """Every entry of the tiled tables in walk order -> dict of arrays:
    its chunk `g`, warp `w`, grid cell, slot, visibility, code (v * m*m +
    j * m + k), and per item its chunk, cell and count."""
    tile, warps = TILE, WARPS
    wtab = tb["wtab"].astype(np.int64)
    nchunk = tb["chunk_vis0"].size - 1
    nitem = np.diff(wtab[:, 0])
    row = np.repeat(np.arange(nchunk * warps), nitem)
    ig, iw = row // warps, row % warps
    items = tb["items"].astype(np.int64)
    irow, icount = items & 0xffff, items >> 16
    # The entries of a (chunk, warp) start where wtab says and follow one
    # another, item by item.
    assert np.array_equal(wtab[:, 1], np.append(0, np.cumsum(icount))[
        wtab[:, 0]])
    tent = tb["tent"].view(np.uint32).astype(np.int64)
    assert tent.size == icount.sum()
    eitem = np.repeat(np.arange(items.size), icount)
    # The low half is the slot's row offset in bytes in the kernel's chunk
    # buffer (32 planes of 8 bytes a slot), swizzled for lane 0.
    off, j, k = tent & 0xffff, (tent >> 16) & 0xff, tent >> 24
    slot = off >> 8
    assert np.array_equal(off & 0xff, (slot % 32) << 3)
    g = ig[eitem]
    v0 = tb["chunk_vis0"].astype(np.int64)
    assert (slot < (v0[g + 1] - v0[g])).all() and (j < m).all() and \
        (k < m).all()
    vis = tb["svis"][v0[g] + slot].astype(np.int64)
    ntx = -(-ngrid // tile)
    tile_of_g = np.searchsorted(tb["tile_chunk0"], np.arange(nchunk),
                                side="right") - 1
    tid = tile_of_g[ig]
    # The cell map numbers each tile's cells with contributions in
    # row-major order; items name a cell by that row.
    cmap = tb["cellmap"].reshape(ntx * ntx, tile * tile).astype(np.int64)
    t_, lc_ = np.nonzero(cmap >= 0)
    local = np.full(cmap.shape, -1, np.int64)
    local[t_, cmap[t_, lc_]] = lc_
    ilc = local[tid, irow]
    assert (ilc >= 0).all()
    y = (tid // ntx) * tile + ilc // tile
    x = (tid % ntx) * tile + ilc % tile
    assert ((y < ngrid) & (x < ngrid)).all()
    icell = y * ngrid + x
    return {"g": g, "w": iw[eitem], "cell": icell[eitem], "slot": slot,
            "vis": vis, "code": vis * m * m + j * m + k, "ig": ig,
            "iw": iw, "icell": icell, "icount": icount}


def _check_lists(off, ent, tb, m, ngrid):
    """Every cell's list rebuilt from the tiled tables equals its CSR
    list exactly, in order; one warp per (chunk, cell); each tile's
    visibilities ascending, in chunks of the kernels' `chunk_slots(m)`
    with at most ENTRIES contributions a chunk."""
    u = _unpack(tb, m, ngrid)
    per_chunk = np.bincount(u["g"], minlength=tb["chunk_vis0"].size - 1)
    assert per_chunk.max(initial=0) <= ENTRIES
    pairs = u["ig"] * ngrid * ngrid + u["icell"]
    assert np.unique(pairs).size == pairs.size
    # Per cell, chunks in order; within a chunk the item's own order.
    order = np.lexsort((u["g"], u["cell"]))
    assert np.array_equal(u["code"][order], ent.astype(np.int64))
    assert np.array_equal(np.bincount(u["cell"], minlength=ngrid * ngrid),
                          np.diff(off))
    tc, cv = tb["tile_chunk0"], tb["chunk_vis0"].astype(np.int64)
    ntx = -(-ngrid // TILE)
    assert tc.size == ntx * ntx + 1
    for t in range(ntx * ntx):
        s = tb["svis"][cv[tc[t]]:cv[tc[t + 1]]]
        assert (np.diff(s) > 0).all()
        assert (np.diff(cv[tc[t]:tc[t + 1] + 1])[:-1] ==
                chunk_slots(m)).all()
    return u


def _sum_tiles(m, ngrid, xs, ys, tile):
    """Sum over visibilities of the tiles their in-grid cells touch,
    from the positions alone."""
    total = 0
    for a in (np.asarray(xs), np.asarray(ys)):
        lo = np.clip(a, 0, ngrid - 1) // tile
        hi = np.clip(a + m - 1, 0, ngrid - 1) // tile
        ok = (a + m - 1 >= 0) & (a < ngrid)
        n = np.where(ok, hi - lo + 1, 0)
        total = n if isinstance(total, int) else total * n
    return int(total.sum())


def _case(nvis, ngrid, m, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    pos = rng.integers(-m if lo is None else lo,
                       ngrid + 1 if hi is None else hi, (2, nvis))
    off, ent = build_plan(pos[0], pos[1], m, ngrid)
    return pos, off, ent


@pytest.mark.parametrize("m,ngrid,nvis", [
    (1, 40, 1000), (3, 40, 500), (5, 40, 700), (3, 32, 400), (20, 40, 60),
    (5, 37, 900), (3, 16, 200), (2, 5, 100)])
def test_tiles_rebuild_every_cell_list(m, ngrid, nvis):
    """Positions straddling every edge; ngrid that the tile divides, does
    not, and is smaller than; tiles with more visibilities than one chunk;
    supports from one cell to larger than a tile (chunks of 32, 11 and 1
    slots)."""
    pos, off, ent = _case(nvis, ngrid, m, seed=100 + m + ngrid)
    tb = build_tiles(off, ent, m, ngrid, nvis)
    _check_lists(off, ent, tb, m, ngrid)
    assert tb["svis"].size == _sum_tiles(m, ngrid, pos[0], pos[1], TILE)
    assert np.diff(tb["tile_chunk0"]).max() > 1


@pytest.mark.parametrize("m,ngrid,nvis", [(3, 40, 500), (5, 37, 300),
                                          (1, 16, 20)])
def test_cellmap_numbers_each_tiles_cells_with_contributions(m, ngrid,
                                                              nvis):
    """The kernels keep accumulator rows only for cells with
    contributions: the cell map numbers exactly those of each tile, in
    row-major order, and marks every other cell (the ragged edge's
    included) -1; `Tiles.max_cells` is the fullest tile's count."""
    pos, off, ent = _case(nvis, ngrid, m, seed=14)
    tb = build_tiles(off, ent, m, ngrid, nvis)
    ntx = -(-ngrid // TILE)
    cmap = tb["cellmap"].reshape(ntx, ntx, TILE, TILE)
    full = np.zeros((ntx * TILE, ntx * TILE), bool)
    full[:ngrid, :ngrid] = (np.diff(off) > 0).reshape(ngrid, ngrid)
    busy = full.reshape(ntx, TILE, ntx, TILE).transpose(0, 2, 1, 3)
    assert np.array_equal(cmap >= 0, busy)
    for ty in range(ntx):
        for tx in range(ntx):
            rows = cmap[ty, tx][busy[ty, tx]]
            assert rows.tolist() == list(range(rows.size))
    tiles = Tiles(tb, m, ngrid, nvis, "cpu")
    assert tiles.max_cells == busy.sum(axis=(2, 3)).max()


def test_chunk_slots_keep_a_chunk_within_the_kernel_buffers():
    """A visibility adds at most min(m*m, TILE*TILE) contributions to a
    tile, so chunks of `chunk_slots(m)` never pass ENTRIES."""
    for m in range(1, 40):
        c = chunk_slots(m)
        assert 1 <= c <= CHUNK
        assert c * min(m * m, TILE * TILE) <= ENTRIES
    assert chunk_slots(3) == CHUNK


def test_tiles_of_an_empty_plan():
    """Every patch off the grid: no chunk, no item, no entry; every tile
    is still there (the kernel writes its cells)."""
    pos, off, ent = _case(50, 40, 3, seed=7, lo=41, hi=60)
    assert ent.size == 0
    tb = build_tiles(off, ent, 3, 40, 50)
    assert tb["tile_chunk0"].tolist() == [0] * 10
    assert (tb["cellmap"] == -1).all() and \
        Tiles(tb, 3, 40, 50, "cpu").max_cells == 0
    assert tb["chunk_vis0"].tolist() == [0]
    assert tb["wtab"].tolist() == [[0, 0]]
    for name in ("svis", "items", "tent"):
        assert tb[name].size == 0
    assert all(a.dtype == np.int32 and a.flags.c_contiguous
               for a in tb.values())


def test_tiles_refuse_fields_they_cannot_hold():
    """An entry holds j and k in 8 bits each."""
    pos, off, ent = _case(10, 16, 3, seed=8)
    for m in (0, 256):
        with pytest.raises(ValueError, match="m < 256"):
            build_tiles(off, ent, m, 16, 10)


def _balance(u, nchunk, warps):
    """Per (chunk, warp) contributions -> (nchunk, warps)."""
    load = np.zeros(nchunk * warps, np.int64)
    np.add.at(load, u["ig"] * warps + u["iw"], u["icount"])
    return load.reshape(nchunk, warps)


@pytest.mark.parametrize("m,ngrid,nvis", [(3, 40, 700), (5, 48, 2000)])
def test_tiles_balance_each_chunk_over_the_warps(m, ngrid, nvis):
    """A chunk's items are dealt heaviest first in snake order: no warp
    carries more than the mean plus one item."""
    _, off, ent = _case(nvis, ngrid, m, seed=9)
    tb = build_tiles(off, ent, m, ngrid, nvis)
    u = _unpack(tb, m, ngrid)
    nchunk = tb["chunk_vis0"].size - 1
    load = _balance(u, nchunk, WARPS)
    big = np.zeros(nchunk, np.int64)
    np.maximum.at(big, u["ig"], u["icount"])
    assert (load.max(1) <= load.mean(1) + big).all()
    assert load.sum() == ent.size


def test_tiles_at_the_flagship():
    """`lwa_instrument_spec`'s default positions (256 x 2 inputs, ngrid
    128, m 3) at the kernel's tile, chunk and warp counts: every cell's
    list rebuilt exactly; S_T sums to 1.196 x nvis; the items of a chunk
    leave its warps within 9 % of even, summed over chunks."""
    m, ngrid = 3, 128
    uvw = default_uvw(256, 2, ngrid, m)
    nvis = uvw.shape[1]
    off, ent = build_plan(uvw[0], uvw[1], m, ngrid)
    tb = build_tiles(off, ent, m, ngrid, nvis)
    u = _check_lists(off, ent, tb, m, ngrid)
    assert chunk_slots(m) == CHUNK
    nst = tb["svis"].size
    assert nst == _sum_tiles(m, ngrid, uvw[0], uvw[1], TILE)
    assert abs(nst / nvis - 1.196) < 5e-4
    nchunk = tb["chunk_vis0"].size - 1
    load = _balance(u, nchunk, WARPS)
    assert load.max(1).sum() <= 1.09 * load.mean(1).sum()
    assert np.diff(tb["tile_chunk0"]).min() > 0
    assert Tiles(tb, m, ngrid, nvis, "cpu").max_cells == 144


def _walk(data, tb, planes, m, ngrid, out, accumulate, separable):
    """Sum the grid through the tiled tables in the kernel's order: per
    tile, chunk, warp and item, the item's entries into the cell's
    running sum, every product and sum an f32 operation of its own."""
    nplane = data.shape[0]
    dr, di = data.real, data.imag
    accr = torch.zeros(nplane, ngrid * ngrid)
    acci = torch.zeros_like(accr)
    u = _unpack(tb, m, ngrid)
    nvk = planes[0].shape[1]
    pl = [p.reshape(p.shape[0], -1) for p in planes]

    def tap(p, idx):
        return p[:, idx].real, p[:, idx].imag

    e = 0
    for cell, cnt in zip(u["icell"], u["icount"]):
        ar, ai = accr[:, cell].clone(), acci[:, cell].clone()
        for _ in range(cnt):
            vis, code = int(u["vis"][e]), int(u["code"][e])
            jk = code - vis * m * m
            j, k = divmod(jk, m)
            xr, xi = dr[:, vis], di[:, vis]
            if separable:
                base = vis * m if nvk > 1 else 0
                ur, ui = tap(pl[0], base + j)
                vr, vi = tap(pl[1], base + k)
                wr, wi = xr * vr - xi * vi, xr * vi + xi * vr
                cr, ci = ur * wr - ui * wi, ur * wi + ui * wr
            else:
                kr, ki = tap(pl[0], (vis * m * m if nvk > 1 else 0) + jk)
                cr, ci = xr * kr - xi * ki, xr * ki + xi * kr
            ar, ai = ar + cr, ai + ci
            e += 1
        accr[:, cell], acci[:, cell] = ar, ai
    grid = torch.complex(accr, acci).view(out.shape)
    out.copy_(out + grid if accumulate else grid)
    return out


@pytest.mark.parametrize("rank1,per_pol,per_vis,accumulate,m,ngrid,nvis", [
    (True, False, False, False, 3, 20, 300),
    (True, True, True, True, 3, 20, 300),
    (False, False, True, True, 5, 29, 150),
    (False, True, False, False, 3, 33, 300),
    (True, False, True, True, 1, 17, 300),
    (False, False, False, True, 2, 16, 300)])
def test_walk_of_the_tiles_equals_the_plain_versions_bitwise(
        rank1, per_pol, per_vis, accumulate, m, ngrid, nvis):
    """Seeded data, kernels shared, per visibility and per plane, enough
    visibilities that a tile spans several chunks: the walk in the
    kernels' order equals the plain version bitwise, with -0.0 cells in
    the starting grid (accumulate turns them into g + 0.0)."""
    rng = np.random.default_rng(31 + m + ngrid)
    npol = 3
    pos = rng.integers(-m, ngrid + 1, (2, nvis))
    shape = (npol if per_pol else 1, nvis if per_vis else 1)
    cplx = lambda s: rng.standard_normal(s) + 1j * rng.standard_normal(s)
    if rank1:
        uu, vv = cplx(shape + (m,)), cplx(shape + (m,))
        kern = (uu[..., :, None] * vv[..., None, :]).astype(np.complex64)
    else:
        kern = cplx(shape + (m, m)).astype(np.complex64)
    kp = kernel_planes(kern, npol, nvis, m)
    uv = separate_kernels(kp)
    assert (uv is not None) == (rank1 or m == 1)
    planes = [torch.from_numpy(np.ascontiguousarray(p))
              for p in (uv if rank1 else (kp,))]
    off, ent = build_plan(pos[0], pos[1], m, ngrid)
    tb = build_tiles(off, ent, m, ngrid, nvis)
    assert np.diff(tb["tile_chunk0"]).max() > 1
    data = torch.from_numpy(cplx((npol, nvis)).astype(np.complex64))
    g0 = np.full((npol, ngrid, ngrid), 0.5 - 1j, np.complex64)
    g0[:, ::3, 1::2] = np.complex64(complex(-0.0, -0.0))
    g0 = torch.from_numpy(g0)
    plain = grid_separable_plain if rank1 else grid_general_plain
    want = plain(data, torch.from_numpy(off), torch.from_numpy(ent),
                 *planes, g0.clone(), accumulate)
    got = _walk(data, tb, planes, m, ngrid, g0.clone(), accumulate, rank1)
    bits = lambda t: torch.view_as_real(t).view(torch.int32)
    assert torch.equal(bits(got), bits(want))
    # Empty cells that held -0.0 come out +0.0 either way.
    empty = torch.from_numpy(np.diff(off) == 0).view(ngrid, ngrid)
    negz = torch.signbit(torch.view_as_real(g0)).all(-1) & \
        (torch.view_as_real(g0) == 0).all(-1) & empty
    assert negz.any()
    assert (bits(got)[negz] == 0).all()


def _tiles_of(off, ent, m, ngrid, nvis):
    return Tiles(build_tiles(off, ent, m, ngrid, nvis), m, ngrid, nvis,
                 "cpu")


def test_check_tiles_refuses_what_the_kernel_cannot_take():
    """The CUDA launch's validation of the tiled plan (run here on CPU
    tensors): missing tables, another geometry, another grid or kernel
    support or visibility count, a table of the wrong type, shape or
    device."""
    _, off, ent = _case(200, 40, 3, seed=12)
    tiles = _tiles_of(off, ent, 3, 40, 200)
    dev = torch.device("cpu")
    _check_tiles("k", tiles, dev, 40, 3, 200)
    with pytest.raises(ValueError, match="needs the tiled plan"):
        _check_tiles("k", None, dev, 40, 3, 200)
    with pytest.raises(ValueError, match="ngrid 40"):
        _check_tiles("k", tiles, dev, 48, 3, 200)
    with pytest.raises(ValueError, match="m 3"):
        _check_tiles("k", tiles, dev, 40, 5, 200)
    with pytest.raises(ValueError, match="200 visibilities"):
        _check_tiles("k", tiles, dev, 40, 3, 201)
    with pytest.raises(ValueError, match="on meta"):
        _check_tiles("k", tiles, torch.device("meta"), 40, 3, 200)
    other = _tiles_of(off, ent, 3, 40, 200)
    other.wtab = other.wtab[:-1]
    with pytest.raises(ValueError, match="wtab"):
        _check_tiles("k", other, dev, 40, 3, 200)
    other = _tiles_of(off, ent, 3, 40, 200)
    other.svis = other.svis.view(1, -1)
    with pytest.raises(ValueError, match="svis must be 1-D"):
        _check_tiles("k", other, dev, 40, 3, 200)
    other = _tiles_of(off, ent, 3, 40, 200)
    other.items = other.items.long()
    with pytest.raises(ValueError, match="items must be contiguous int32"):
        _check_tiles("k", other, dev, 40, 3, 200)
    other = _tiles_of(off, ent, 3, 40, 200)
    other.tile_chunk0 = other.tile_chunk0[:-1]
    with pytest.raises(ValueError, match="tile_chunk0"):
        _check_tiles("k", other, dev, 40, 3, 200)
    other = _tiles_of(off, ent, 3, 40, 200)
    other.cellmap = other.cellmap[:-1]
    with pytest.raises(ValueError, match="cellmap"):
        _check_tiles("k", other, dev, 40, 3, 200)
    other = _tiles_of(off, ent, 3, 40, 200)
    other.max_cells = TILE * TILE + 1
    with pytest.raises(ValueError, match="max_cells"):
        _check_tiles("k", other, dev, 40, 3, 200)


def test_plan_builds_tiles_only_for_the_kernels():
    """RomeinPlan cuts the tiles for 'cuda' on a CUDA device only: on
    the CPU, and for 'plain', the plain versions walk the CSR plan."""
    pos, off, ent = _case(100, 24, 3, seed=13)
    kern = np.ones((3, 3), np.complex64)
    for method in ("cuda", "plain"):
        plan = RomeinPlan(pos[0], pos[1], kern, 24, 2, 100, "cpu", method)
        assert plan.tiles is None and plan.tiles_build_s == 0.0
