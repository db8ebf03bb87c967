"""Kernel tests that need a CUDA card (marked `gpu`; they skip without
one).  This file imports no JAX, so on the card's machine, which has no
JAX, it runs without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import time

import numpy as np
import pytest
import torch

from bifrost_tpu_torch.ops import Fdmt
from bifrost_tpu_torch.ops import fdmt_kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.gpu
def test_merge_step_kernel_bitwise_vs_plain(cuda):
    """The CUDA kernel against its plain version, bitwise, with -0.0
    inputs, partner-less rows and delays past the row length."""
    rng = np.random.default_rng(4)
    state = torch.from_numpy(
        rng.standard_normal((64, 300)).astype(np.float32)).to(cuda)
    state[5] = -0.0
    tabs = [torch.from_numpy(a.astype(np.int32)).to(cuda) for a in (
        rng.integers(0, 64, 48), rng.integers(-1, 64, 48),
        rng.integers(0, 320, 48))]
    out = torch.empty(48, 300, device=cuda)
    before = fdmt_kernel.merge_step.launches
    fdmt_kernel.merge_step(state, *tabs, out=out)
    assert fdmt_kernel.merge_step.launches == before + 1
    assert _bits_equal(out, fdmt_kernel.merge_step_plain(state, *tabs))


@pytest.mark.gpu
@pytest.mark.parametrize("ntime", [300, 65])
def test_merge_step_kernel_batched_bitwise_vs_plain(cuda, ntime):
    """The kernel on a (3, rows, ntime) batch in one launch, into a slice
    of a larger buffer (the executor's ping-pong layout), against its
    plain version, bitwise: -0.0 inputs, partner-less rows, delays past
    the row length, random and sorted (shared-row) tables; 16-byte
    accesses (ntime 300) and element accesses (65)."""
    rng = np.random.default_rng(16)
    state = torch.from_numpy(
        rng.standard_normal((3, 64, ntime)).astype(np.float32)).to(cuda)
    state[:, 5] = -0.0
    state[..., ::7] = -0.0
    r = np.arange(48)
    da = np.round(r * 0.55).astype(np.int64)
    for tabs in ((rng.integers(0, 64, 48), rng.integers(-1, 64, 48),
                  rng.integers(0, ntime + 20, 48)),
                 (da, np.where(r % 11 == 3, -1, 20 + r - da), da)):
        tabs = [torch.from_numpy(a.astype(np.int32)).to(cuda) for a in tabs]
        out = torch.full((3, 56, ntime), float("nan"), device=cuda)[:, :48]
        before = fdmt_kernel.merge_step.launches
        fdmt_kernel.merge_step(state, *tabs, out=out)
        assert fdmt_kernel.merge_step.launches == before + 1
        want = fdmt_kernel.merge_step_plain(state, *tabs)
        torch.cuda.synchronize()
        assert _bits_equal(out.contiguous(), want)


@pytest.mark.gpu
def test_merge_step_rejects_bad_operands(cuda):
    state = torch.zeros(8, 16, device=cuda)
    tabs = [torch.zeros(8, dtype=torch.int32, device=cuda)] * 3
    with pytest.raises(ValueError, match="overlaps"):
        fdmt_kernel.merge_step(state, *tabs, out=state)
    with pytest.raises(ValueError, match="int32"):
        fdmt_kernel.merge_step(state, *[t.long() for t in tabs],
                               out=torch.empty(8, 16, device=cuda))
    # Batched operands: slices of one buffer whose spans interleave, a
    # batch mismatch, rows that are not contiguous.
    buf = torch.zeros(2, 16, 16, device=cuda)
    with pytest.raises(ValueError, match="overlaps"):
        fdmt_kernel.merge_step(buf[:, :8], *tabs, out=buf[:, 8:])
    with pytest.raises(ValueError, match="does not match"):
        fdmt_kernel.merge_step(torch.zeros(3, 8, 16, device=cuda), *tabs,
                               out=torch.empty(2, 8, 16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fdmt_kernel.merge_step(state, *tabs,
                               out=torch.empty(8, 32, device=cuda)[:, :16])


@pytest.mark.gpu
def test_fdmt_cuda_matches_cpu(cuda):
    """The whole transform on the card (kernel) against the CPU (plain
    version), bitwise, at a bucketed geometry."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((64, 160)).astype(np.float32))
    plan = Fdmt().init(64, 128, 60e6, 0.1e6)
    assert _bits_equal(plan.execute(x.to(cuda)).cpu(), plan.execute(x))


@pytest.mark.gpu
def test_fdmt_batched_cuda_matches_cpu(cuda):
    """A batch of beams on the card, one launch per merge step for the
    whole batch, against the CPU, bitwise, and against each beam alone."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((8, 256, 65))
                         .astype(np.float32))
    plan = Fdmt().init(256, 64, 40.0, 1e-6 / (1e-6 * 256))
    before = fdmt_kernel.merge_step.launches
    got = plan.execute(x.to(cuda)).cpu()
    assert fdmt_kernel.merge_step.launches == before + len(plan._steps)
    assert _bits_equal(got, plan.execute(x))
    for i in (0, 7):
        assert _bits_equal(got[i].contiguous(),
                           plan.execute(x[i].to(cuda)).cpu())


def _fir_case(rng, int8, ntap, rep, lanes, ntime, layout, cuda):
    """Seeded (x, coeffs, state) for K2 on the card in `layout`:
    'contig'; 'offset' (x one element past a buffer's start); 'oddrow'
    (x from the second row of a buffer); 'state' (the state one element
    past a buffer's start).  f32 samples and the state carry -0.0."""
    dtype = torch.int8 if int8 else torch.float32
    xv = rng.integers(-128, 128, (ntime, lanes)).astype(np.int8) if int8 \
        else rng.standard_normal((ntime, lanes)).astype(np.float32)
    if not int8:
        xv[::3, ::5] = -0.0
    if layout == "offset":
        x = torch.empty(ntime * lanes + 1, dtype=dtype,
                        device=cuda)[1:].view(ntime, lanes)
    elif layout == "oddrow":
        x = torch.empty(ntime + 1, lanes, dtype=dtype, device=cuda)[1:]
    else:
        x = torch.empty(ntime, lanes, dtype=dtype, device=cuda)
    x.copy_(torch.from_numpy(xv))
    sv = rng.standard_normal((ntap - 1, lanes)).astype(np.float32)
    sv[:, ::4] = -0.0
    skip = int(layout == "state")
    st = torch.empty((ntap - 1) * lanes + skip, device=cuda)[skip:]
    st = st.view(ntap - 1, lanes).copy_(torch.from_numpy(sv))
    c = torch.from_numpy(rng.standard_normal(
        (ntap, lanes // rep)).astype(np.float32)).to(cuda)
    return x, c, st


@pytest.mark.gpu
@pytest.mark.parametrize("decim,ntap,rep,int8,lanes,ntime,layout,vec", [
    (1, 4, 1, False, 72, 40, "contig", True),
    (2, 8, 1, False, 72, 40, "contig", True),
    (4, 1, 1, False, 72, 40, "contig", True),
    (1, 4, 6, True, 72, 40, "contig", True),
    (1, 4, 6, False, 72, 40, "contig", True),
    (1, 4, 1024, True, 2048, 16, "contig", True),
    (1, 4, 1024, False, 2048, 16, "contig", True),
    (1, 4, 1, True, 64, 16, "contig", True),
    (1, 8, 1, True, 64, 16, "contig", True),
    (1, 4, 2, True, 36, 16, "contig", False),
    (1, 4, 2, False, 42, 16, "contig", False),
    (1, 4, 16, True, 64, 16, "offset", False),
    (1, 4, 4, False, 64, 16, "offset", False),
    (1, 3, 1, False, 63, 16, "oddrow", False),
    (1, 4, 4, False, 64, 16, "state", False),
    (1, 8, 16, True, 64, 3, "contig", True),
    (1, 1, 4, False, 64, 16, "contig", True),
    (1, 9, 16, True, 64, 16, "contig", True),
    (1, 17, 16, True, 64, 16, "contig", False),
    (2, 4, 16, True, 64, 32, "contig", True),
    (4, 4, 4, False, 64, 32, "contig", True),
    (5, 3, 4, False, 64, 40, "contig", True)])
def test_fir_mac_kernel_bitwise_vs_plain(cuda, decim, ntap, rep, int8, lanes,
                                         ntime, layout, vec):
    """K2 against its plain version, bitwise, each launch's kernel
    asserted: decimation (2, 4 and past ntap, where rows are skipped), 1,
    9 (the long form) and 17 taps (above the vector kernel's
    instantiations), coefficient
    columns shared by a thread's lanes (the PFB's rep 1024) and per lane
    (rep 1 and 6, 4 and 8 taps), frames across the vector kernel's
    8-frame cut, a gulp shorter than ntap - 1, int8 and f32 input with
    -0.0; the scalar kernel on lanes that are not a multiple of the
    vector, a base off by one element, one row into a buffer of an odd
    lane count and a state off 16-byte alignment."""
    from bifrost_tpu_torch.ops import fir_kernel
    rng = np.random.default_rng(6)
    x, c, st = _fir_case(rng, int8, ntap, rep, lanes, ntime, layout, cuda)
    out = torch.empty(ntime // decim, lanes, device=cuda)
    assert fir_kernel.fir_vectors(x, st, out, ntap) == vec
    before = fir_kernel.fir_mac.launches
    vbefore = fir_kernel.fir_mac.vector_launches
    y = fir_kernel.fir_mac(x, c, st, decim, rep, out=out)
    assert fir_kernel.fir_mac.launches == before + 1
    assert fir_kernel.fir_mac.vector_launches == vbefore + vec
    want = fir_kernel.fir_mac_plain(x, c, st, decim, rep)
    torch.cuda.synchronize()
    assert _bits_equal(y, want)


@pytest.mark.gpu
@pytest.mark.parametrize("ntap", list(range(9, 17)))
@pytest.mark.parametrize("decim", [1, 4])
@pytest.mark.parametrize("rep", [1, 2, 64])
@pytest.mark.parametrize("int8", [True, False])
def test_fir_mac_long_taps_bitwise_vs_plain(cuda, int8, rep, decim, ntap):
    """K2 at 9 to 16 taps against its plain version, bitwise: int8 input
    on the vector kernel's long form (the `fir_long` build, 4 lanes a
    thread), f32 input with -0.0 on the scalar kernel; decim 1 and 4, a
    column a lane (rep 1), one for each (re, im) pair (rep 2, the
    complex FIR) and one for all of a thread's lanes (rep 64); 75 output
    frames, across the 32-frame cut."""
    from bifrost_tpu_torch.ops import fir_kernel
    rng = np.random.default_rng(ntap * 100 + decim * 10 + rep)
    lanes, nout = 128, 75
    x, c, st = _fir_case(rng, int8, ntap, rep, lanes, nout * decim,
                         "contig", cuda)
    out = torch.full((nout, lanes), float("nan"), device=cuda)
    assert fir_kernel.fir_vectors(x, st, out, ntap) == int8
    vbefore = fir_kernel.fir_mac.vector_launches
    y = fir_kernel.fir_mac(x, c, st, decim, rep, out=out)
    assert fir_kernel.fir_mac.vector_launches == vbefore + int8
    want = fir_kernel.fir_mac_plain(x, c, st, decim, rep)
    torch.cuda.synchronize()
    assert _bits_equal(y, want)


@pytest.mark.gpu
@pytest.mark.parametrize("decim", [1, 4])
def test_fir_block_on_a_cuda_ring_matches_plain(cuda, decim):
    """FirBlock reading ci8 raw from a 'cuda' ring, 16 taps: K2 on every
    gulp, all on its vector kernel, bitwise the block with
    method='plain' on the card and the same block on the CPU."""
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.ops import fir_kernel
    from bifrost_tpu_torch.pipeline import Pipeline
    rng = np.random.default_rng(40 + decim)
    raw = rng.integers(-128, 128, (512, 64, 2, 2)).astype(np.int8)
    c = rng.standard_normal((16, 128))

    def run(device, method):
        outs = []
        with Pipeline(device=device) as pipe:
            src = blocks.array_source(raw, 128, header={
                "dtype": "ci8", "labels": ["time", "station", "pol"]})
            f = blocks.fir(blocks.copy(src, space="cuda"), c, decim=decim,
                           method=method)
            blocks.callback_sink(f, on_data=lambda a: outs.append(
                a.cpu().clone()))
            pipe.run()
        return torch.cat(outs), f

    before = fir_kernel.fir_mac.launches
    vbefore = fir_kernel.fir_mac.vector_launches
    got, f = run(cuda, None)
    assert fir_kernel.fir_mac.launches - before == 4
    assert fir_kernel.fir_mac.vector_launches - vbefore == 4
    assert f._raw_reads == 4
    plain, _ = run(cuda, "plain")
    cpu, _ = run("cpu", None)
    assert got.shape == (512 // decim, 64, 2)
    assert _bits_equal(torch.view_as_real(got), torch.view_as_real(plain))
    assert _bits_equal(torch.view_as_real(got), torch.view_as_real(cpu))


@pytest.mark.gpu
def test_async_executor_depth4_bitwise_depth1_on_the_card(cuda):
    """The executor on the card: ci4 capture -> host unpack -> H2D ->
    int8 correlate (X1), and the raw head, at depth 4 bitwise depth 1
    with X1 launched as often; at depth 4 the H2D copy and the correlate
    ran on their workers, on their blocks' streams."""
    from bifrost_tpu_torch import blocks, config
    from bifrost_tpu_torch.ops import xengine_kernel
    from bifrost_tpu_torch.pipeline import Pipeline
    rng = np.random.default_rng(44)
    frames = rng.integers(0, 256, (2048, 8, 16, 2), dtype=np.uint8)
    hdr = {"dtype": "ci4", "labels": ["time", "freq", "station", "pol"]}

    def run(depth, unpack):
        config.set("pipeline_async_depth", depth)
        outs = []
        try:
            with Pipeline(device=cuda) as pipe:
                src = blocks.array_source(frames, 256, header=dict(hdr))
                if unpack:
                    src = blocks.unpack(src)
                dev = blocks.copy(src, space="cuda")
                x = blocks.correlate(dev, 512, engine="int8")
                blocks.callback_sink(x, on_data=lambda a: outs.append(
                    a.clone()))
                before = xengine_kernel.xengine_int8.launches
                pipe.run()
                torch.cuda.synchronize()
        finally:
            config.reset("pipeline_async_depth")
        return (torch.cat(outs), xengine_kernel.xengine_int8.launches -
                before, (dev._exec_async_depth, x._exec_async_depth))

    for unpack in (False, True):
        a, na, da = run(1, unpack)
        b, nb, db = run(4, unpack)
        assert na == nb == 8 and da == (0, 0) and db == (4, 4)
        assert a.shape == (4, 8, 16, 2, 16, 2)
        assert _bits_equal(torch.view_as_real(a), torch.view_as_real(b))


@pytest.mark.gpu
@pytest.mark.parametrize("nbeam,int8,ntime,nchan,nsp,offset", [
    (1, False, 40, 5, 300, 0), (2, True, 5, 5, 300, 0),
    (8, False, 16, 5, 300, 0), (8, True, 33, 5, 300, 0),
    (1, False, 1, 5, 300, 0), (3, True, 5, 30, 1, 0),
    (8, False, 16, 13, 513, 0), (9, True, 33, 5, 300, 0),
    (128, False, 5, 7, 64, 0), (8, True, 260, 3, 520, 0),
    (9, False, 260, 3, 40, 0), (8, False, 16, 9, 512, 1),
    (8, True, 16, 9, 512, 1), (8, False, 0, 5, 300, 0)])
def test_beamform_kernel_bitwise_vs_plain(cuda, nbeam, int8, ntime, nchan,
                                          nsp, offset):
    """K4 against its plain version, bitwise: f32 and int8 voltages;
    frame counts of 0, 1 and across the kernel's frame tile (260 > 256
    rows a block); channel counts that are not a multiple of a block's
    channels; station counts of 1 and across its chunks (16 c64 or 64
    ci8 stations) with a short last chunk; beams across its groups of 8;
    16-byte copies and element copies (a row's bytes not 16-byte
    aligned, or x offset by one sample)."""
    from bifrost_tpu_torch.ops import beamform_kernel
    rng = np.random.default_rng(7)
    shape = (ntime, nchan, nsp)
    if int8:
        buf = rng.integers(-128, 128, (np.prod(shape) + offset, 2))
        x = torch.from_numpy(buf.astype(np.int8)).to(cuda)[offset:] \
            .view(shape + (2,))
    else:
        buf = (rng.standard_normal(np.prod(shape) + offset) +
               1j * rng.standard_normal(np.prod(shape) + offset))
        x = torch.from_numpy(buf.astype(np.complex64)).to(cuda)[offset:] \
            .view(shape)
    w = torch.from_numpy((rng.standard_normal((nbeam, nsp)) +
                          1j * rng.standard_normal((nbeam, nsp)))
                         .astype(np.complex64)).to(cuda)
    geo = beamform_kernel.launch_geometry(ntime, nchan, nsp, nbeam,
                                          2 if int8 else 8, x.data_ptr())
    assert geo["vec"] == (offset == 0 and nsp * (2 if int8 else 8) % 16 == 0)
    before = beamform_kernel.beamform_power.launches
    p = beamform_kernel.beamform_power(x, w)
    assert beamform_kernel.beamform_power.launches == before + 1
    assert _bits_equal(p, beamform_kernel.beamform_power_plain(x, w))


@pytest.mark.gpu
def test_pfb_and_beamform_cuda_match_cpu(cuda):
    """The PFB and the beamform plan on the card against the CPU: the MAC
    and the B-engine bitwise, the DFT matmuls (cuBLAS against the CPU's
    BLAS, another summation order) to 1e-5 of the peak."""
    from bifrost_tpu_torch.ops import Beamform, Pfb
    rng = np.random.default_rng(8)
    raw = rng.integers(-8, 8, (64 * 6, 3, 2, 2)).astype(np.int8)
    got, want = (Pfb(method="cuda").init(64, ntap=4).execute_raw(
        torch.from_numpy(raw).to(dev), "ci8").cpu()
        for dev in (cuda, torch.device("cpu")))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    w = rng.integers(-3, 4, (8, 6)).astype(np.complex64)
    xb = torch.from_numpy(raw).reshape(6, 64, 3, 2, 2)
    a = Beamform().init(w, method="cuda").execute_raw(xb.to(cuda), "ci8")
    b = Beamform().init(w, method="cuda").execute_raw(xb, "ci8")
    assert _bits_equal(a.cpu(), b)


def _romein_case(npol, nvis, ngrid, m, rank1, per_pol, per_vis, seed,
                 empty=False):
    """Seeded (data, plan, kernel planes) for K6a/K6b: positions that
    straddle every edge of the grid (or, `empty`, all off it)."""
    from bifrost_tpu_torch.ops.romein import (build_plan, kernel_planes,
                                              separate_kernels)
    rng = np.random.default_rng(seed)
    pos = rng.integers(ngrid + 1, 2 * ngrid, (2, nvis)) if empty else \
        rng.integers(-m, ngrid + 1, (2, nvis))
    shape = (npol if per_pol else 1, nvis if per_vis else 1)
    if rank1:
        u = rng.standard_normal(shape + (m,)) + \
            1j * rng.standard_normal(shape + (m,))
        v = rng.standard_normal(shape + (m,)) + \
            1j * rng.standard_normal(shape + (m,))
        kern = (u[..., :, None] * v[..., None, :]).astype(np.complex64)
    else:
        kern = (rng.standard_normal(shape + (m, m)) +
                1j * rng.standard_normal(shape + (m, m))).astype(np.complex64)
    planes = kernel_planes(kern, npol, nvis, m)
    uv = separate_kernels(planes)
    assert (uv is not None) == rank1
    off, ent = build_plan(pos[0], pos[1], m, ngrid)
    assert (ent.size == 0) == empty
    data = (rng.standard_normal((npol, nvis)) +
            1j * rng.standard_normal((npol, nvis))).astype(np.complex64)
    return data, off, ent, (uv if rank1 else (planes,))


@pytest.mark.gpu
@pytest.mark.parametrize(
    "rank1,per_pol,per_vis,strided,accumulate,npol,empty", [
        (True, False, False, True, False, 3, False),
        (True, True, True, False, True, 3, False),
        (False, False, True, True, False, 3, False),
        (False, True, True, False, True, 3, False),
        (False, False, False, False, False, 3, False),
        (True, False, False, False, True, 1, False),
        (False, True, False, True, True, 33, False),
        (True, True, True, True, False, 33, False),
        (False, False, True, False, True, 64, False),
        (True, False, False, True, True, 3, True),
        (False, True, True, False, False, 33, True)])
def test_romein_kernels_bitwise_vs_plain(cuda, rank1, per_pol, per_vis,
                                         strided, accumulate, npol, empty):
    """K6b (rank-1) and K6a against their plain versions, bitwise: shared,
    per-visibility and per-plane kernel planes, out-of-grid patches, an
    ngrid (40) that the tile does not divide, tiles with more
    visibilities than a chunk, plane counts that are not a multiple of 32,
    an empty plan, strided data and grids (a time-last ring span),
    overwrite and accumulate over -0.0 cells; a rerun bit-identical."""
    from bifrost_tpu_torch.ops import romein_kernel as rk
    from bifrost_tpu_torch.ops.romein import build_tiles
    nvis, ngrid, m = 700, 40, 5
    data, off, ent, planes = _romein_case(npol, nvis, ngrid, m, rank1,
                                          per_pol, per_vis, seed=11,
                                          empty=empty)
    tb = build_tiles(off, ent, m, ngrid, nvis)
    if not empty:
        assert np.diff(tb["tile_chunk0"]).max() > 1
    tiles = rk.Tiles(tb, m, ngrid, nvis, cuda)
    off, ent = (torch.from_numpy(a).to(cuda) for a in (off, ent))
    planes = [torch.from_numpy(np.ascontiguousarray(p)).to(cuda)
              for p in planes]
    d = torch.from_numpy(data).to(cuda)
    if strided:
        d = torch.stack([d, torch.zeros_like(d)], -1)[..., 0]
    g0 = np.full((npol, ngrid, ngrid, 2), 0.5 - 1j, np.complex64)
    g0[:, ::3, 1::2] = np.complex64(complex(-0.0, -0.0))
    g0 = torch.from_numpy(g0).to(cuda)
    out, ref, again = g0.clone(), g0.clone(), g0.clone()
    if not strided:
        out, ref, again = (t[..., 0].contiguous() for t in (out, ref, again))
    else:
        out, ref, again = out[..., 0], ref[..., 0], again[..., 0]
    kernel = rk.grid_separable if rank1 else rk.grid_general
    plain = rk.grid_separable_plain if rank1 else rk.grid_general_plain
    before = (rk.grid_general.launches, rk.grid_separable.launches)
    kernel(d, off, ent, *planes, out, accumulate=accumulate, tiles=tiles)
    kernel(d, off, ent, *planes, again, accumulate=accumulate, tiles=tiles)
    plain(d, off, ent, *planes, ref, accumulate=accumulate)
    after = (rk.grid_general.launches, rk.grid_separable.launches)
    assert after == (before[0] + 2 * (not rank1), before[1] + 2 * rank1)
    torch.cuda.synchronize()
    bits = lambda t: torch.view_as_real(t).contiguous().view(torch.int32)
    assert torch.equal(bits(out), bits(ref))
    assert torch.equal(bits(out), bits(again))


@pytest.mark.gpu
def test_romein_kernels_refuse_without_tiles(cuda):
    """A CUDA launch without the tiled plan, or with one cut for another
    grid, raises and launches nothing."""
    from bifrost_tpu_torch.ops import romein_kernel as rk
    from bifrost_tpu_torch.ops.romein import build_tiles
    data, off, ent, planes = _romein_case(2, 50, 24, 3, True, False, False,
                                          seed=16)
    other = rk.Tiles(build_tiles(off, ent, 3, 24, 50), 3, 24, 50, cuda)
    other.ngrid = 32
    off, ent = (torch.from_numpy(a).to(cuda) for a in (off, ent))
    u, v = (torch.from_numpy(np.ascontiguousarray(p)).to(cuda)
            for p in planes)
    d = torch.from_numpy(data).to(cuda)
    out = torch.zeros(2, 24, 24, dtype=torch.complex64, device=cuda)
    before = rk.grid_separable.launches
    with pytest.raises(ValueError, match="needs the tiled plan"):
        rk.grid_separable(d, off, ent, u, v, out)
    with pytest.raises(ValueError, match="ngrid 32"):
        rk.grid_separable(d, off, ent, u, v, out, tiles=other)
    assert rk.grid_separable.launches == before


@pytest.mark.gpu
def test_romein_plan_cuda_matches_cpu(cuda):
    """The Romein plan on the card (kernels) against the CPU (plain),
    bitwise, and two runs on the card bit-identical."""
    from bifrost_tpu_torch.ops import Romein
    rng = np.random.default_rng(12)
    npol, nvis, ngrid = 4, 500, 32
    pos = rng.integers(-3, ngrid, (2, 1, nvis)).astype(np.int32)
    vis = torch.from_numpy((rng.standard_normal((npol, nvis)) +
                            1j * rng.standard_normal((npol, nvis)))
                           .astype(np.complex64))
    for kern in (np.ones((3, 3), np.complex64),
                 (rng.standard_normal((1, nvis, 3, 3)) + 1j)
                 .astype(np.complex64)):
        plan = Romein().init(pos, kern, ngrid)
        a = plan.execute(vis.to(cuda)).cpu()
        b = plan.execute(vis.to(cuda)).cpu()
        c = plan.execute(vis)
        assert torch.equal(torch.view_as_real(a), torch.view_as_real(c))
        assert torch.equal(torch.view_as_real(a), torch.view_as_real(b))


def _span(rows, cols, dtype, layout, cuda):
    """A (rows, cols) tensor on the card in `layout`: 'contig'; 'strided'
    (every third cell of a wider buffer); 'offset' (a buffer's cells from
    the second on: the base 4 or 8 bytes past 16-byte alignment);
    'padded' (the first cols cells of rows padded to a 16-byte stride)."""
    if layout == "strided":
        return torch.empty(rows, 3 * cols, dtype=dtype, device=cuda)[:, ::3]
    if layout == "offset":
        return torch.empty(rows, cols + 1, dtype=dtype, device=cuda)[:, 1:]
    if layout == "padded":
        per = 16 // torch.empty((), dtype=dtype).element_size()
        return torch.empty(rows, -(-cols // per) * per, dtype=dtype,
                           device=cuda)[:, :cols]
    return torch.empty(rows, cols, dtype=dtype, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("cplx,baseline,ntime,window,ncell,xlay,olay,vec", [
    (False, True, 37, 8, 300, "contig", "strided", False),
    (False, False, 64, 16, 300, "contig", "strided", False),
    (True, False, 37, 8, 300, "contig", "strided", False),
    (True, False, 16, 16, 300, "contig", "strided", False),
    (False, True, 37, 8, 300, "contig", "contig", True),
    (False, True, 64, 16, 301, "padded", "padded", True),
    (False, False, 37, 8, 301, "contig", "contig", False),
    (True, False, 37, 8, 301, "padded", "padded", True),
    (True, False, 16, 1, 300, "contig", "contig", True),
    (False, True, 10, 64, 300, "contig", "contig", True),
    (False, True, 100, 40, 302, "padded", "padded", True),
    (False, False, 37, 8, 300, "offset", "offset", False),
    (True, False, 40, 16, 300, "contig", "offset", False)])
def test_masked_fill_kernel_bitwise_vs_plain(cuda, cplx, baseline, ntime,
                                             window, ncell, xlay, olay, vec):
    """K5a against its plain version, bitwise: f32 with a baseline fill
    and zero fill, complex64 (one launch for both components), -0.0
    samples; window 1, a window longer than the gulp, a tail window,
    windows longer than a thread's frame group; the vector kernel on
    contiguous and padded spans, with cell counts that are not a multiple
    of its width (a scalar tail), and the scalar kernel on a strided span,
    on a base off 16-byte alignment and on a row stride off it.  Each
    launch's kernel is asserted."""
    from bifrost_tpu_torch.ops import dq_kernel
    rng = np.random.default_rng(13)
    nrows = -(-ntime // window)
    dtype = torch.complex64 if cplx else torch.float32
    xv = rng.standard_normal((ntime, ncell)).astype(np.float32)
    xv[::3, ::5] = -0.0
    if cplx:
        xv = (xv + 1j * rng.standard_normal(xv.shape)).astype(np.complex64)
    x = _span(ntime, ncell, dtype, xlay, cuda)
    x.copy_(torch.from_numpy(xv))
    mask = torch.from_numpy(rng.random((nrows, ncell)) < 0.3).to(cuda)
    fill = torch.from_numpy(rng.standard_normal((nrows, ncell))
                            .astype(np.float32)).to(cuda) \
        if baseline else None
    out = _span(ntime, ncell, dtype, olay, cuda)
    assert dq_kernel.fill_vectors(x, out) == vec
    before = dq_kernel.masked_fill.launches
    vbefore = dq_kernel.masked_fill.vector_launches
    dq_kernel.masked_fill(x, mask, fill, window, out=out)
    assert dq_kernel.masked_fill.launches == before + 1
    assert dq_kernel.masked_fill.vector_launches == vbefore + vec
    want = dq_kernel.masked_fill_plain(x, mask, fill, window)
    torch.cuda.synchronize()
    got = out.contiguous()
    if cplx:
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    assert _bits_equal(got, want)


@pytest.mark.gpu
def test_gain_apply_kernel_bitwise_vs_plain(cuda):
    """K5b against its plain version, bitwise, into a strided span."""
    from bifrost_tpu_torch.ops import dq_kernel
    rng = np.random.default_rng(14)
    x = torch.from_numpy((rng.standard_normal((40, 700)) +
                          1j * rng.standard_normal((40, 700)))
                         .astype(np.complex64)).to(cuda)
    g = torch.from_numpy((rng.standard_normal(700) +
                          1j * rng.standard_normal(700))
                         .astype(np.complex64)).to(cuda)
    out = torch.empty(80, 700, dtype=torch.complex64, device=cuda)[::2]
    before = dq_kernel.gain_apply.launches
    dq_kernel.gain_apply(x, g, out=out)
    assert dq_kernel.gain_apply.launches == before + 1
    want = dq_kernel.gain_apply_plain(x, g)
    torch.cuda.synchronize()
    assert _bits_equal(torch.view_as_real(out.contiguous()),
                       torch.view_as_real(want))
    with pytest.raises(ValueError, match="overlaps"):
        dq_kernel.gain_apply(x, g, out=x)
    with pytest.raises(ValueError, match="complex64"):
        dq_kernel.gain_apply(x, g.to(torch.complex128))


@pytest.mark.gpu
def test_flag_and_gaincal_cuda_match_cpu(cuda):
    """The 'mad' flagger and the calibrator on the card (kernels) against
    the CPU (plain versions), bitwise: the median/MAD statistics are
    sorts and elementwise IEEE operations on both."""
    from bifrost_tpu_torch.ops import Flag, GainCal
    rng = np.random.default_rng(15)
    x = (rng.standard_normal((150, 8, 5)) +
         1j * rng.standard_normal((150, 8, 5))).astype(np.complex64)
    x[96:, 3, 1] += 25.0
    u8 = rng.integers(0, 32, (150, 40)).astype(np.uint8)
    u8[64:, 5] = 250
    for a in (x, u8):
        p, q = Flag().init(16), Flag().init(16)
        y1, m1 = p.execute(torch.from_numpy(a).to(cuda))
        y2, m2 = q.execute(torch.from_numpy(a))
        assert torch.equal(m1.cpu(), m2) and m2.any()
        assert torch.equal(y1.cpu(), y2)
        assert torch.equal(p._state.cpu(), q._state)
    g = (rng.standard_normal(40) + 1j * rng.standard_normal(40)) \
        .astype(np.complex64)
    a = GainCal().init(gains=g).execute(torch.from_numpy(x).to(cuda))
    b = GainCal().init(gains=g).execute(torch.from_numpy(x))
    assert _bits_equal(torch.view_as_real(a.cpu()), torch.view_as_real(b))


# ------------------------------------------------------------ egress plane

class _Collect(object):
    """A DeviceSinkBlock factory that keeps a copy of each gulp (or what
    `check(i, arr)` says of it) and the address of the array it was
    handed."""

    def __new__(cls, iring, check=None):
        from bifrost_tpu_torch.egress import DeviceSinkBlock

        class Sink(DeviceSinkBlock):
            def on_sink_sequence(self, iseq):
                self.chunks, self.addrs = [], []

            def on_sink_data(self, arr, frame_offset):
                self.addrs.append(arr.ctypes.data)
                if check is None:
                    self.chunks.append(np.array(arr))
                else:
                    self.chunks.append(check(len(self.chunks), arr))

        return Sink(iring)


class _DeviceSource(object):
    """A source writing a 'cuda' ring straight from the card: gulp i of
    `ngulp` holds `pattern(i)` (a function of the gulp index)."""

    def __new__(cls, shape, gulp, ngulp, pattern, **kwargs):
        import contextlib

        from bifrost_tpu_torch.pipeline import SourceBlock

        class Source(SourceBlock):
            def create_reader(self, name):
                @contextlib.contextmanager
                def reader():
                    self.i = 0
                    yield self
                return reader()

            def on_sequence(self, reader, name):
                return [{"name": name, "_tensor": {
                    "dtype": "f32", "shape": [-1] + list(shape),
                    "labels": ["time"] + [f"ax{k}" for k in
                                          range(len(shape))]}}]

            def on_data(self, reader, ospans):
                if self.i == ngulp:
                    return [0]
                ospans[0].data.copy_(pattern(self.i))
                self.i += 1
                return [gulp]

        return Source(["devsrc"], gulp, space="cuda", **kwargs)


def _egress_run(cuda, shape, gulp, ngulp, pattern, staged, **sink_kw):
    from bifrost_tpu_torch import config
    from bifrost_tpu_torch.pipeline import Pipeline
    config.set("egress_staging", staged)
    try:
        with Pipeline(device=cuda) as pipe:
            src = _DeviceSource(shape, gulp, ngulp, pattern,
                                buffer_factor=2)
            snk = _Collect(src, **sink_kw)
            pipe.run()
    finally:
        config.reset("egress_staging")
    return snk


@pytest.mark.gpu
def test_egress_staged_equals_blocking_512mib(cuda, monkeypatch):
    """Staged and blocking egress are bitwise equal at 512 MiB gulps
    (the instrument's image frame, 4096 x 128 x 128 cf32, as f32), and
    every staged gulp is handed over in a pinned staging buffer."""
    from bifrost_tpu_torch import egress
    shape = (4096, 128, 256)
    bufs = []
    real = egress._alloc_staging_buffer

    def alloc(nbyte, pin):
        bufs.append(real(nbyte, pin))
        return bufs[-1]

    monkeypatch.setattr(egress, "_alloc_staging_buffer", alloc)

    def pattern(i):
        g = torch.Generator(device=cuda).manual_seed(100 + i)
        return torch.randn((1,) + shape, generator=g, device=cuda)

    stg = _egress_run(cuda, shape, 1, 3, pattern, True)
    blk = _egress_run(cuda, shape, 1, 3, pattern, False)
    assert stg._egress_drained_gulps == 3 and len(stg.chunks) == 3
    assert bufs and all(b.is_pinned() for b in bufs)
    assert set(stg.addrs) <= {b.data_ptr() for b in bufs}
    for s, b in zip(stg.chunks, blk.chunks):
        assert s.nbytes == 512 << 20
        assert np.array_equal(s.view(np.uint32), b.view(np.uint32))
    assert np.array_equal(stg.chunks[2], pattern(2).cpu().numpy())


@pytest.mark.gpu
def test_egress_staging_pool_is_pinned(cuda):
    from bifrost_tpu_torch.egress import EgressStager
    st = EgressStager("pin", depth=2, device=cuda)
    buf = st.pool.acquire(1 << 20)
    assert buf.is_pinned()
    st.pool.release(buf)
    st.close()


@pytest.mark.gpu
def test_egress_span_reuse_stress(cuda, monkeypatch):
    """A 'cuda' ring of buffer factor 2, 64 gulps of 32 MiB each with a
    distinct seeded pattern, and each gulp's copy held back on the copy
    stream by a sleep kernel of some 5 ms queued before it: every staged
    gulp equals its source.  The writer reuses a span's bytes as soon as
    the span's release event allows; were the copy not ordered before
    that event, the writer would overwrite the bytes while the copy
    waits, and the gulp would land a later gulp's pattern."""
    from bifrost_tpu_torch import egress
    shape = (1024, 8192)
    real = egress._start_transfer

    def held_back(dst, src):
        torch.cuda._sleep(10_000_000)    # cycles on the copy stream
        return real(dst, src)

    monkeypatch.setattr(egress, "_start_transfer", held_back)

    def pattern(i):
        base = torch.arange(shape[0] * shape[1], device=cuda,
                            dtype=torch.float32).view((1,) + shape)
        return (base * 0.5 + float(i * 7919 % 65521)).remainder(1 << 20)

    def check(i, arr):
        return np.array_equal(arr, pattern(i).cpu().numpy())

    snk = _egress_run(cuda, shape, 1, 64, pattern, True, check=check)
    assert snk._egress_staging and len(snk.chunks) == 64
    assert all(snk.chunks), [i for i, ok in enumerate(snk.chunks) if not ok]


@pytest.mark.gpu
def test_gpuspec_chain_cuda_matches_cpu(cuda, tmp_path):
    """The gpuspec chain (GUPPI -> FFT -> Stokes -> reduce -> accumulate
    -> SIGPROC) on the card equals the same chain on the CPU within the
    testbench's FFT bound."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.io import guppi_raw, sigproc
    nblock, nchan, ntime, f_avg, n_int = 12, 8, 4096, 16, 3
    raw = str(tmp_path / "v.raw")
    rng = np.random.default_rng(8)
    with open(raw, "wb") as f:
        for b in range(nblock):
            guppi_raw.write_header(f, {
                "BLOCSIZE": nchan * ntime * 4, "OBSNCHAN": nchan, "NPOL": 2,
                "NBITS": 8, "OBSFREQ": 1420.0, "OBSBW": 100.0, "PKTIDX": b})
            f.write(rng.integers(-8, 8, nchan * ntime * 4,
                                 dtype=np.int8).tobytes())
    out = {}
    for k, dev in enumerate((cuda, "cpu")):
        d = tmp_path / f"run{k}"
        d.mkdir()
        with bt.Pipeline(device=dev) as pipe:
            bc = bt.BlockChainer()
            bc.custom(bt.blocks.read_guppi_raw([raw], gulp_nframe=1))
            bc.blocks.copy("cuda")
            bc.blocks.transpose(["time", "pol", "freq", "fine_time"])
            bc.blocks.fft(axes="fine_time", axis_labels="fine_freq",
                          apply_fftshift=True)
            bc.blocks.detect(mode="stokes")
            bc.views.merge_axes("freq", "fine_freq", label="freq")
            bc.blocks.reduce("freq", f_avg)
            bc.blocks.accumulate(n_int)
            snk = bc.blocks.write_sigproc(path=str(d))
            pipe.run()
        with sigproc.SigprocFile(snk.filename) as sf:
            out[k] = np.array(sf.read(sf.nframe))
    a, b = out[0], out[1]
    assert a.shape == b.shape == (nblock // n_int, 4, nchan * ntime // f_avg)
    atol = 32 * np.finfo(np.float32).eps * np.sqrt(a.shape[-1] * f_avg) * \
        np.abs(b).max()
    assert np.isfinite(a).all() and np.abs(a - b).max() <= atol


@pytest.mark.gpu
@pytest.mark.parametrize("tail", [False, True])
def test_fused_group_span_reuse_under_fused_async(cuda, monkeypatch, tail):
    """A fused copy -> transpose -> reduce group (with `tail`, ending in
    an accumulate, whose gulps then run on the group's worker under
    fused_async) reads a pinned host ring of buffer factor 2 for 64
    gulps of seeded patterns, each gulp's H2D copy held back on the
    group's stream by a sleep kernel of some 5 ms queued before it:
    every output equals its source.  The group copies a pinned span in
    place, so it holds the span until the copy's event; were it
    released at once, the source would overwrite it while the copy
    waits, and the gulp would carry a later gulp's pattern."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import config
    from bifrost_tpu_torch.blocks.copy import CopyBlock
    from bifrost_tpu_torch.pipeline import Pipeline, SourceBlock
    ngulp, shape = 64, (64, 4096)
    real = CopyBlock._h2d

    def held_back(self, src, dst):
        torch.cuda._sleep(10_000_000)        # cycles on the group's stream
        return real(self, src, dst)

    monkeypatch.setattr(CopyBlock, "_h2d", held_back)

    def pattern(i):
        return np.random.default_rng(1000 + i).integers(
            0, 1000, (1,) + shape).astype(np.float32)

    class Source(SourceBlock):
        def create_reader(self, name):
            import contextlib
            self.i = 0
            return contextlib.nullcontext(self)

        def on_sequence(self, reader, name):
            return [{"name": name, "_tensor": {
                "dtype": "f32", "shape": [-1, *shape],
                "labels": ["time", "a", "b"]}}]

        def on_data(self, reader, ospans):
            if self.i == ngulp:
                return [0]
            ospans[0].data.copy_(torch.from_numpy(pattern(self.i)))
            self.i += 1
            return [1]

    got = []
    assert config.get("fused_async")
    with Pipeline(device=cuda) as pipe:
        src = Source(["host"], 1, space="cuda_host", buffer_factor=2)
        with bt.block_scope(fuse=True):
            d = bt.blocks.copy(src, space="cuda")
            t = bt.blocks.transpose(d, ["time", "b", "a"])
            out = bt.blocks.reduce(t, "a", op="sum")
            if tail:
                out = bt.blocks.accumulate(out, 2)
        bt.blocks.gather_sink(out, got)
        pipe.run()
        rep = pipe.fusion_report()
    assert len(rep["groups"]) == 1 and \
        len(rep["groups"][0]["constituents"]) == 3 + tail
    want = [pattern(i).sum(axis=1).reshape(1, shape[1], 1)
            for i in range(ngulp)]
    if tail:
        want = [want[i] + want[i + 1] for i in range(0, ngulp, 2)]
    assert len(got) == len(want)
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if not np.array_equal(np.asarray(a), b)]
    assert not bad, f"gulps {bad} differ from their source"


@pytest.mark.gpu
def test_supervised_fused_group_restart_with_held_spans(cuda, monkeypatch):
    """A fused copy -> transpose -> reduce -> accumulate(2) group under
    `fused_async`, reading a pinned host ring of buffer factor 2 for 64
    gulps of seeded patterns, each gulp's H2D copy held back on the
    group's stream by a sleep kernel of some 5 ms (the span-reuse test's
    model), faults on its 12th gulp after the gulp's work is enqueued
    and before its commit.  The supervised restart sheds that gulp and
    the integration it ends, resets the carry, and every output before
    and after it equals its source's.  The faulted output reservation
    goes back behind a fence recorded after its still-running stream
    work, and the fence is handed to the ring for the writer's next
    reservation of those bytes."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import config
    from bifrost_tpu_torch.blocks.copy import CopyBlock
    from bifrost_tpu_torch.pipeline import Pipeline, SourceBlock
    from bifrost_tpu_torch.ring import Ring
    from bifrost_tpu_torch.supervise import RestartPolicy, Supervisor
    ngulp, shape, fault_gulp = 64, (64, 4096), 11
    real_h2d, real_cancel = CopyBlock._h2d, Ring._cancel
    cancels = []

    def held_back(self, src, dst):
        torch.cuda._sleep(10_000_000)        # cycles on the group's stream
        return real_h2d(self, src, dst)

    def watched_cancel(self, token, begin, size, fence):
        pending = fence is not None and not fence.query()
        real_cancel(self, token, begin, size, fence)
        cancels.append((self.space, fence is not None, pending,
                        fence is not None and fence in self._release_events))

    monkeypatch.setattr(CopyBlock, "_h2d", held_back)
    monkeypatch.setattr(Ring, "_cancel", watched_cancel)

    def pattern(i):
        return np.random.default_rng(1000 + i).integers(
            0, 1000, (1,) + shape).astype(np.float32)

    class Source(SourceBlock):
        def create_reader(self, name):
            import contextlib
            self.i = 0
            return contextlib.nullcontext(self)

        def on_sequence(self, reader, name):
            return [{"name": name, "_tensor": {
                "dtype": "f32", "shape": [-1, *shape],
                "labels": ["time", "a", "b"]}}]

        def on_data(self, reader, ospans):
            if self.i == ngulp:
                return [0]
            ospans[0].data.copy_(torch.from_numpy(pattern(self.i)))
            self.i += 1
            return [1]

    got = []
    assert config.get("fused_async")
    with Pipeline(device=cuda) as pipe:
        src = Source(["host"], 1, space="cuda_host", buffer_factor=2)
        with bt.block_scope(fuse=True):
            d = bt.blocks.copy(src, space="cuda")
            t = bt.blocks.transpose(d, ["time", "b", "a"])
            r = bt.blocks.reduce(t, "a", op="sum")
            acc = bt.blocks.accumulate(r, 2)
        bt.blocks.gather_sink(acc, got)
        pipe._fuse_device_chains()
        group = [b for b in pipe.blocks
                 if getattr(b, "constituent_names", None)][0]
        calls = []

        def on_data(ispan, ospan, orig=group.on_data):
            n = orig(ispan, ospan)
            calls.append(n)
            if len(calls) == fault_gulp + 1:
                raise RuntimeError("fault after the gulp's work is queued")
            return n

        group.on_data = on_data
        sup = Supervisor(policy=RestartPolicy(max_restarts=3, backoff=0.01))
        pipe.run(supervise=sup)
    assert sup.counters["restarts"] == 1 and sup.counters["escalations"] == 0
    # The faulted gulp emitted: its reservation was cancelled on the
    # 'cuda' ring behind a fence its held-back work had not yet passed.
    assert ("cuda", True, True, True) in cancels, cancels
    want = [pattern(i).sum(axis=1).reshape(1, shape[1], 1) +
            pattern(i + 1).sum(axis=1).reshape(1, shape[1], 1)
            for i in list(range(0, fault_gulp - 1, 2)) +
            list(range(fault_gulp + 1, ngulp, 2))]
    assert len(got) == len(want)
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if not np.array_equal(np.asarray(a), b)]
    assert not bad, f"outputs {bad} differ from their source"


@pytest.mark.gpu
def test_deadman_on_a_block_waiting_in_a_cuda_ring(cuda):
    """The H2D copy is parked before its last gulp (stamping its
    heartbeat: scaffolding), so the sink waits in an acquire on the
    copy's 'cuda' ring and misses its heartbeats; the deadman's targeted
    interrupt wakes it out of that wait, the supervisor counts one
    restart at the same frame, the copy goes on 0.2 s after the deadman,
    and every frame reaches the sink once, bitwise."""
    import threading
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.blocks.testing import array_source
    from bifrost_tpu_torch.faultinject import FaultPlan
    from bifrost_tpu_torch.pipeline import Pipeline, SinkBlock
    from bifrost_tpu_torch.supervise import RestartPolicy, Supervisor
    data = np.random.default_rng(5).standard_normal((32, 1024)) \
        .astype(np.float32)

    class Sink(SinkBlock):
        def __init__(self, iring, **kwargs):
            super().__init__(iring, **kwargs)
            self.chunks, self.nseqs = [], 0

        def on_sequence(self, iseq):
            self.nseqs += 1

        def on_data(self, ispan):
            self.chunks.append(ispan.data.cpu().numpy().copy())

    release, marks = threading.Event(), {}

    def on_ev(ev):
        marks.setdefault(ev.kind, ev.block)
        if ev.kind == "deadman_interrupt":
            threading.Timer(0.2, release.set).start()

    t0 = time.monotonic()
    with Pipeline(device=cuda) as pipe:
        src = array_source(data, 8)
        dev = blocks.copy(src, space="cuda")
        sink = Sink(dev)
        sup = Supervisor(policy=RestartPolicy(max_restarts=3, backoff=0.01),
                         heartbeat_interval_s=0.2, heartbeat_misses=5,
                         on_event=on_ev)
        plan = FaultPlan()
        plan.wedge_at("block.on_data", block=dev.name, nth=3,
                      release=release, timeout=60.0, stamp_heartbeat=True)
        pipe._fuse_device_chains()
        plan.attach(pipe)
        try:
            pipe.run(supervise=sup)
        finally:
            plan.detach()
            release.set()
    assert time.monotonic() - t0 < 30
    c = sup.counters
    assert c["deadman_interrupts"] == 1 and c["restarts"] == 1 and \
        c["escalations"] == 0, c
    assert marks["deadman_interrupt"] == marks["restart"] == sink.name
    assert sink.nseqs == 2
    assert np.array_equal(np.concatenate(sink.chunks, axis=0), data)


@pytest.mark.gpu
def test_socket_fed_frb_search_dedisperses_on_the_card(cuda):
    """frb_search_spec over loopback: its rings stay in the capture's
    'system' space, as the reference builds them, while the FDMT stages
    each host gulp onto the card and runs kernel K1 there (one launch a
    merge step a gulp; no CPU fallback), its carried tail holding the
    staged frames to the stream's length, and the flagger (rfi_flag)
    runs K5a there too."""
    import struct

    from bifrost_tpu_torch.ops import dq_kernel
    from bifrost_tpu_torch.service import Service, frb_search_spec
    from bifrost_tpu_torch.udp import UDPSocket, UDPTransmit

    nframe, gulp, max_delay = 512, 64, 16
    rx = UDPSocket().bind("127.0.0.1", 0)
    rx.set_timeout(0.05)
    spec = frb_search_spec(rx, 1, 64, buffer_ntime=4096, slot_ntime=16,
                           gulp_nframe=gulp, max_delay=max_delay,
                           rfi_flag=dict(algo="mad", window=16))
    svc = Service(spec, name="frb_sock_card")
    fdmt_block = svc.blocks["fdmt"]
    svc.start()
    k1 = fdmt_kernel.merge_step.launches
    k5a = dq_kernel.masked_fill.launches
    tx_sock = UDPSocket().connect("127.0.0.1", rx.port)
    tx = UDPTransmit(tx_sock)
    for t in range(nframe):
        tx.send(struct.pack("<QHH", t, 0, 0) +
                bytes((t * 7 + 13 * c) % 23 + 10 for c in range(64)))
        if t % 64 == 63:
            time.sleep(0.01)
    # The capture commits its last two windows at its end, so the stream's
    # last gulp waits for stop(); every gulp before it arrives first.
    det = svc.blocks["detect"]
    deadline = time.monotonic() + 30
    while det.frames_seen < nframe - 2 * gulp - max_delay:
        assert time.monotonic() < deadline, det.frames_seen
        time.sleep(0.05)
    time.sleep(0.5)
    report = svc.stop(timeout=30.0)
    rx.shutdown()
    assert report.exit_code == 0
    assert {r.space for r in svc.pipeline.rings} == {"system"}
    assert svc.pipeline.device.type == "cuda"
    nsteps = len(fdmt_block.fdmt._steps)
    ngulp = nframe // gulp
    assert fdmt_kernel.merge_step.launches - k1 == nsteps * ngulp
    assert dq_kernel.masked_fill.launches - k5a > 0
    assert fdmt_block._frames_staged == nframe
    assert report.ledger["committed_frames"] == nframe - max_delay


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["ci8", "ci4"])
@pytest.mark.parametrize("ntime,nchan,nsp,values", [
    (64, 2, 100, "random"),      # nsp not a multiple of the tiles
    (45, 3, 64, "random"),       # T not a multiple of the 32-deep step
    (1, 2, 70, "random"),        # T = 1
    (200, 1, 130, "random"),     # nchan 1, two ragged edges
    (1024, 4, 512, "random")] +  # the main path's depth and width
    # Around the 64-row warpgroups and 128-station tiles, the 32-sample
    # wgmma step and the 16-sample pitch, on full-range voltages.
    [(t, 2, n, "random") for n in (1, 63, 64, 65, 127, 128, 129, 200)
     for t in (1, 31, 33, 45, 200)] +
    # Extreme values: every sample at the type's minimum or maximum, and
    # alternating extremes (re and im opposite).
    [(t, c, n, v) for v in ("min", "max", "alternating")
     for t, c, n in ((200, 2, 129), (33, 1, 64))])
def test_xengine_kernel_bitwise_vs_plain(cuda, fmt, ntime, nchan, nsp,
                                         values):
    """X1 against its plain version (f64 matmul, exact), bitwise, into
    an output prefilled with NaN (a tile the Hermitian grid forgot to
    compute or mirror fails), with its launch counted once."""
    from bifrost_tpu_torch.ops import xengine_kernel as xk
    g = torch.Generator().manual_seed(ntime * nsp + nchan)
    lo, hi = (-128, 127) if fmt == "ci8" else (-8, 7)
    shape = (ntime, nchan, nsp)
    if values == "random":
        re = torch.randint(lo, hi + 1, shape, generator=g)
        im = torch.randint(lo, hi + 1, shape, generator=g)
    elif values in ("min", "max"):
        re = im = torch.full(shape, lo if values == "min" else hi)
    else:
        up = (torch.arange(ntime)[:, None, None] +
              torch.arange(nsp)[None, None, :]) % 2 == 0
        re = torch.where(up, hi, lo).expand(shape)
        im = torch.where(up, lo, hi).expand(shape)
    if fmt == "ci8":
        x = torch.stack([re, im], -1).to(torch.int8)
    else:
        x = (((re & 0xF) << 4) | (im & 0xF)).to(torch.uint8)
    x = x.to(cuda)
    got = torch.full((nchan, nsp, nsp), complex(np.nan, np.nan),
                     dtype=torch.complex64, device=cuda)
    before = xk.xengine_int8.launches
    assert xk.xengine_int8(x, fmt, got) is got
    assert xk.xengine_int8.launches == before + 1
    want = xk.xengine_int8_plain(x, fmt)
    assert _bits_equal(torch.view_as_real(got), torch.view_as_real(want))
    cpu = xk.xengine_int8_plain(x.cpu(), fmt)
    assert torch.equal(got.cpu(), cpu)
    strided = torch.cat([x, x], dim=2)[:, :, :nsp]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        xk.xengine_int8(strided, fmt)


@pytest.mark.gpu
def test_xengine_kernel_at_the_gulp_guard(cuda):
    """X1 at the correlate block's gulp guard (65,535 frames), every ci8
    value -128: rr + ii reaches 2 * 128**2 * 65,535, the largest sum
    int32 must hold; bitwise the plain version, into NaN."""
    from bifrost_tpu_torch.ops import xengine_kernel as xk
    x = torch.full((65535, 1, 64, 2), -128, dtype=torch.int8, device=cuda)
    got = torch.full((1, 64, 64), complex(np.nan, np.nan),
                     dtype=torch.complex64, device=cuda)
    xk.xengine_int8(x, "ci8", got)
    want = xk.xengine_int8_plain(x, "ci8")
    assert _bits_equal(torch.view_as_real(got), torch.view_as_real(want))
    assert got[0, 0, 0].real.item() == float(2 * 128 ** 2 * 65535)


@pytest.mark.gpu
@pytest.mark.parametrize("gulp", [8, 16])
@pytest.mark.parametrize("fmt", ["ci8", "ci4"])
def test_correlate_host_ring_runs_x1_on_the_card(cuda, fmt, gulp):
    """A complex-integer stream on a host ring, with no copy: the int8
    correlate stages each gulp onto the card and launches X1 there (a
    gulp of 16 is one whole integration, landing in the host span), and
    its visibilities equal the CPU pipeline's."""
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.ops import xengine_kernel as xk
    from bifrost_tpu_torch.pipeline import Pipeline
    rng = np.random.default_rng(7)
    if fmt == "ci8":
        data = rng.integers(-128, 128, (32, 4, 8, 2, 2)).astype(np.int8)
    else:
        data = rng.integers(0, 256, (32, 4, 8, 2)).astype(np.uint8)
    runs = {}
    for dev in (None, "cpu"):
        chunks = []
        with Pipeline(device=dev) as pipe:
            src = blocks.array_source(data, gulp, header={
                "dtype": fmt, "labels": ["time", "freq", "station", "pol"]})
            x = blocks.correlate(src, 16, engine="int8")
            blocks.gather_sink(x, chunks)
            before = xk.xengine_int8.launches
            pipe.run()
        runs[dev] = (np.concatenate(chunks), xk.xengine_int8.launches -
                     before, x._raw_reads)
    assert runs[None][1:] == (32 // gulp, 0)
    assert runs["cpu"][1:] == (0, 0)
    assert np.array_equal(runs[None][0], runs["cpu"][0])
