"""The gridder's plan built from tensors on their own device: the torch
counterparts of the host builders of ops/romein.py (`build_plan`,
`build_tiles`, `kernel_planes`, `separate_kernels`), as the JAX package
derives its plan from device-resident positions with jitted programs
(bifrost_tpu/ops/romein_pallas.py:257 `bin_to_tiles_device`, :416
`separate_kernels_device`).

Each builder takes tensors and returns tensors on the same device that
are bitwise equal to its host counterpart's arrays:

- every numpy argsort and lexsort is a stable sort (`torch.sort(...,
  stable=True)`), a lexsort a chain of them from the least significant
  key; `np.unique` is `torch.unique(sorted=True)`, `np.searchsorted`
  `torch.searchsorted`;
- the f32 arithmetic of `separate_kernels` runs one operator per call,
  so no product is contracted into an FMA and every quotient is the
  IEEE-rounded one, as numpy computes them; the complex results are
  assembled with numpy's own operations (in f64, as numpy promotes);
- only sizes cross to the host (counts, the number of chunks, the
  separability test's two maxima); positions, kernels and the plan's
  arrays stay on the device.
"""

from __future__ import annotations

import torch

from .romein_kernel import TILE, WARPS, chunk_slots


def _stable_argsort(key):
    return torch.sort(key, stable=True).indices


def _lexsort(keys):
    """np.lexsort: the last key is the primary one; stable throughout."""
    order = _stable_argsort(keys[0])
    for k in keys[1:]:
        order = order[_stable_argsort(k[order])]
    return order


def _arange(n, like):
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _ceil_div(a, b):
    return -torch.div(-a, b, rounding_mode="floor")


def build_plan(xs, ys, m, ngrid):
    """ops/romein.py `build_plan` on tensors -> (offsets (ngrid*ngrid + 1,)
    int32, entries int32) on their device."""
    xs = xs.reshape(-1).to(torch.int64)
    ys = ys.reshape(-1).to(torch.int64)
    ndata = xs.numel()
    if ndata * m * m >= 2 ** 31:
        raise ValueError(f"romein: {ndata} visibilities x {m}x{m} overflow "
                         f"the plan's int32 codes")
    d = _arange(m, xs)
    iy = (ys[:, None, None] + d[None, :, None]).expand(ndata, m, m) \
        .reshape(-1)
    ix = (xs[:, None, None] + d[None, None, :]).expand(ndata, m, m) \
        .reshape(-1)
    keep = (iy >= 0) & (iy < ngrid) & (ix >= 0) & (ix < ngrid)
    code = torch.nonzero(keep).reshape(-1)
    lin = iy[code] * ngrid + ix[code]
    order = _stable_argsort(lin)
    counts = torch.bincount(lin, minlength=ngrid * ngrid)
    offsets = torch.zeros(ngrid * ngrid + 1, dtype=torch.int64,
                          device=xs.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets.to(torch.int32), code[order].to(torch.int32)


def build_tiles(offsets, entries, m, ngrid, ndata):
    """ops/romein.py `build_tiles` on tensors: the same dict of int32
    tables, on the tensors' device."""
    if not 0 < m < 256:
        raise ValueError(f"romein: a tiled plan needs m < 256 (got {m})")
    tile, warps, chunk = TILE, WARPS, chunk_slots(m)
    tt = tile * tile
    mm = m * m
    off = offsets.to(torch.int64)
    ent = entries.to(torch.int64)
    ntx = -(-ngrid // tile)
    ntile = ntx * ntx
    cell = torch.repeat_interleave(_arange(ngrid * ngrid, off),
                                   off[1:] - off[:-1])
    y, x = cell // ngrid, cell % ngrid
    tid = (y // tile) * ntx + x // tile
    lc = (y % tile) * tile + x % tile
    vis = ent // mm
    jk = ent - vis * mm
    # S_T: the distinct (tile, visibility) pairs, ascending.
    uk, inv = torch.unique(tid * ndata + vis, sorted=True,
                           return_inverse=True)
    st_tile = uk // ndata
    st0 = torch.searchsorted(st_tile, _arange(ntile + 1, off))
    slot = _arange(uk.numel(), off) - st0[st_tile]
    nchunk_t = _ceil_div(st0[1:] - st0[:-1], chunk)
    tile_chunk0 = torch.zeros(ntile + 1, dtype=torch.int64,
                              device=off.device)
    tile_chunk0[1:] = torch.cumsum(nchunk_t, 0)
    nchunk = int(tile_chunk0[-1])
    g_t = torch.repeat_interleave(_arange(ntile, off), nchunk_t)
    chunk_vis0 = torch.cat([st0[g_t] + (_arange(nchunk, off) -
                                        tile_chunk0[g_t]) * chunk,
                            uk.new_tensor([uk.numel()])])
    eg = (tile_chunk0[st_tile] + slot // chunk)[inv]
    eslot = (slot % chunk)[inv]
    # Each tile's cells with contributions, numbered in row-major order.
    tcell = torch.unique(tid * tt + lc, sorted=True)
    cellmap = torch.full((ntile * tt,), -1, dtype=torch.int64,
                         device=off.device)
    cellmap[tcell] = _arange(tcell.numel(), off) - torch.searchsorted(
        tcell, tcell // tt * tt)
    # Items: the (chunk, cell) groups, each in CSR order.
    order = _lexsort((lc, eg))
    ikey = eg[order] * tt + lc[order]
    first = torch.nonzero(torch.diff(ikey, prepend=ikey.new_tensor([-1]))
                          ).reshape(-1)
    icount = torch.diff(torch.cat([first, first.new_tensor([ikey.numel()])]))
    ig, ilc = ikey[first] // tt, ikey[first] % tt
    # Deal each chunk's items to the warps, heaviest first, in snake
    # order.
    byweight = _lexsort((ilc, -icount, ig))
    istart = torch.searchsorted(ig[byweight], _arange(nchunk, off))
    rank = _arange(icount.numel(), off) - istart[ig[byweight]]
    rnd, pos = rank // warps, rank % warps
    warp = torch.empty_like(rank)
    warp[byweight] = torch.where(rnd % 2 == 0, pos, warps - 1 - pos)
    iorder = _lexsort((ilc, warp, ig))
    # Entries follow their items in the walk's order.
    walk_rank = torch.empty_like(iorder)
    walk_rank[iorder] = _arange(iorder.numel(), off)
    tent_src = order[_stable_argsort(torch.repeat_interleave(walk_rank,
                                                             icount))]
    es = eslot[tent_src]
    tent = (es << 8) | ((es % 32) << 3) | ((jk[tent_src] // m) << 16) | \
        ((jk[tent_src] % m) << 24)
    tent = torch.where(tent >= 2 ** 31, tent - 2 ** 32, tent)
    wkey = ig[iorder] * warps + warp[iorder]
    w0 = torch.searchsorted(wkey, _arange(nchunk * warps + 1, off))
    wstart = torch.cat([icount.new_zeros(1),
                        torch.cumsum(icount[iorder], 0)])
    wtab = torch.stack([w0, wstart[w0]], 1)
    ig_tile = torch.searchsorted(tile_chunk0, ig[iorder], right=True) - 1
    items = cellmap[ig_tile * tt + ilc[iorder]] | (icount[iorder] << 16)
    i32 = lambda a: a.to(torch.int32).contiguous()  # noqa: E731
    return {"tile_chunk0": i32(tile_chunk0), "cellmap": i32(cellmap),
            "chunk_vis0": i32(chunk_vis0), "svis": i32(uk % ndata),
            "wtab": i32(wtab), "items": i32(items), "tent": i32(tent)}


def kernel_planes(kern, npol, ndata, m):
    """ops/romein.py `kernel_planes` on a tensor -> (nk, nvk, m, m)
    complex64 on its device, with the same reshape and broadcast
    tolerance."""
    kern = kern.to(torch.complex64)
    if kern.numel() == npol * ndata * m * m:
        return kern.reshape(npol, ndata, m, m).contiguous()
    shape = tuple(kern.shape)
    if kern.dim() < 2 or kern.dim() > 4 or shape[-2:] != (m, m):
        raise ValueError(f"romein: kernels {shape} do not broadcast "
                         f"to ({npol}, {ndata}, {m}, {m})")
    k4 = kern.reshape((1,) * (4 - kern.dim()) + shape)
    if k4.shape[0] not in (1, npol) or k4.shape[1] not in (1, ndata):
        raise ValueError(f"romein: kernels {shape} do not broadcast "
                         f"to ({npol}, {ndata}, {m}, {m})")
    return k4.contiguous()


def _np_complex(re, im):
    """numpy's ``(re + 1j * im).astype(np.complex64)`` for f32 `re`,
    `im`: 1j * im in f64 is (0*im - 1*0, 0*0 + 1*im), then re is added
    with an imaginary part of +0 (signed zeros as numpy gives them)."""
    re, im = re.double(), im.double()
    pr = im * 0.0 - 0.0
    pi = im + 0.0
    return torch.complex((re + pr).float(), (pi + 0.0).float())


def separate_kernels(kern, tol=1e-5):
    """ops/romein.py `separate_kernels` on a (npol, ndata, m, m) complex
    tensor -> (u, v) complex64 tensors (npol, ndata, m), or None."""
    npol, ndata, m, m2 = kern.shape
    kr = kern.real.to(torch.float32).contiguous()
    ki = kern.imag.to(torch.float32).contiguous()
    mag2 = torch.add(torch.mul(kr, kr), torch.mul(ki, ki))
    piv = mag2.reshape(npol, ndata, -1).argmax(-1)
    j0, k0 = piv // m2, piv % m2
    ip = _arange(npol, kern)[:, None]
    idd = _arange(ndata, kern)[None, :]
    pvr = kr[ip, idd, j0, k0]                           # (npol, ndata)
    pvi = ki[ip, idd, j0, k0]
    denom = torch.add(torch.mul(pvr, pvr), torch.mul(pvi, pvi))
    zero = denom == 0
    safe = torch.where(zero, torch.ones_like(denom), denom)
    ar = _arange(m, kern)[None, None]
    ar2 = _arange(m2, kern)[None, None]
    ur = kr[ip[..., None], idd[..., None], ar, k0[..., None]]
    ui = ki[ip[..., None], idd[..., None], ar, k0[..., None]]
    vnr = kr[ip[..., None], idd[..., None], j0[..., None], ar2]
    vni = ki[ip[..., None], idd[..., None], j0[..., None], ar2]
    pr, pi, sf = pvr[..., None], pvi[..., None], safe[..., None]
    vr = torch.div(torch.add(torch.mul(vnr, pr), torch.mul(vni, pi)), sf)
    vi = torch.div(torch.sub(torch.mul(vni, pr), torch.mul(vnr, pi)), sf)
    z = zero[..., None]
    zf = torch.zeros((), dtype=torch.float32, device=kern.device)
    ur, ui = torch.where(z, zf, ur), torch.where(z, zf, ui)
    vr, vi = torch.where(z, zf, vr), torch.where(z, zf, vi)
    er = torch.sub(torch.sub(torch.mul(ur[..., :, None], vr[..., None, :]),
                             torch.mul(ui[..., :, None], vi[..., None, :])),
                   kr)
    ei = torch.sub(torch.add(torch.mul(ur[..., :, None], vi[..., None, :]),
                             torch.mul(ui[..., :, None], vr[..., None, :])),
                   ki)
    err2 = torch.add(torch.mul(er, er), torch.mul(ei, ei))
    scale2 = max(float(mag2.max()), 1e-30)
    if float(err2.max()) > (tol * tol) * scale2:
        return None
    return _np_complex(ur, ui), _np_complex(vr, vi)
