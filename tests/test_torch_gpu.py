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
from torch_map_forms import (EAGER_FORMS, FORMS, ONE_PASS, READS_SCATTERED,
                             SCATTER_TABLE, SQRT_EDGES, STREAM_FORMS,
                             eager_data, layout as layout_input,
                             sqrt_edge_ulps, storage, ulps_of)


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


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["separable", "general", "shared"])
def test_romein_device_origin_plan_on_the_card(cuda, kind):
    """Positions and kernels given as card tensors: the plan is built on
    the card (origin 'device'), every table (CSR, the seven tiled-plan
    tables, the kernel or u/v planes) bitwise the host-built plan's, and
    K6a/K6b launched from it bitwise their host-origin launches."""
    from bifrost_tpu_torch.ops import Romein
    from bifrost_tpu_torch.ops import romein_kernel as rk
    rng = np.random.default_rng(31)
    npol, nvis, ngrid, m = 2, 3000, 150, 4
    pos = rng.integers(-m, ngrid + 2, (2, 1, nvis)).astype(np.int32)
    if kind == "separable":
        u = (rng.standard_normal((npol, nvis, m)) + 1j).astype(np.complex64)
        kern = (u[..., :, None] * u[..., None, :]).astype(np.complex64)
    elif kind == "general":
        kern = (rng.standard_normal((npol, nvis, m, m)) + 1j *
                rng.standard_normal((npol, nvis, m, m))).astype(np.complex64)
    else:
        kern = np.ones((m, m), np.complex64)
    vis = torch.from_numpy((rng.standard_normal((npol, nvis)) + 1j *
                            rng.standard_normal((npol, nvis)))
                           .astype(np.complex64)).to(cuda)
    host = Romein().init(pos, kern, ngrid)
    dev = Romein().init(torch.from_numpy(pos).to(cuda),
                        torch.from_numpy(kern).to(cuda), ngrid)
    before = rk.grid_general.launches + rk.grid_separable.launches
    a = host.execute(vis)
    b = dev.execute(vis)
    assert rk.grid_general.launches + rk.grid_separable.launches == \
        before + 2
    assert dev.plan_report()["origin"] == "device"
    assert host.plan_report()["origin"] == "host"
    ph, pd = host._last_plan, dev._last_plan
    assert ph.separable == pd.separable == (kind != "general")
    names = ["offsets", "entries"] + (["u", "v"] if ph.separable
                                      else ["kern"])
    for name in names:
        x, y = getattr(ph, name), getattr(pd, name)
        assert x.device == y.device and x.dtype == y.dtype
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), name
    for name in rk.Tiles.NAMES:
        x, y = getattr(ph.tiles, name), getattr(pd.tiles, name)
        assert torch.equal(x, y), name
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


def _walk_case(algo, n, ncell, m, params, seed):
    """Statistics and state (numpy f32) for W1's edge checks: warm counts
    0, 1, 5, WARM_CAP - 1 and WARM_CAP; -0.0 centres; -0.0 statistics,
    and one NaN statistic in a few cells; in window 0, cells tied
    exactly with each threshold, computed with f32 roundings as the
    plain walk computes them (the SK threshold as the f32 value of its
    f64 product) -> (stats, state, number of tied cells)."""
    from bifrost_tpu_torch.ops.flag_kernel import WARM_CAP
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p_thresh, p_mad = f32(params[0]), f32(params[1])
    sig, eps = f32(1.4826), f32(1e-6)
    k = np.arange(ncell)
    warm = rng.choice(np.array([0, 0, 1, 5, WARM_CAP - 1, WARM_CAP], f32),
                      ncell)
    c = rng.uniform(1, 4, ncell).astype(f32)
    s = rng.uniform(0.2, 1, ncell).astype(f32)
    c[k % 13 == 6] = -0.0
    z = rng.standard_normal((n, ncell)).astype(f32)
    u = rng.uniform(0.3, 6, (n, ncell)).astype(f32)
    if algo == "mad":
        stats = [c + f32(6) * z * s, s * u, rng.uniform(0.3, 1, n)
                 .astype(f32)]
    else:
        stats = [f32(1) + f32(2) * z, c * u]
    for j, a in enumerate(stats[:2]):
        a[rng.random(a.shape) < 0.01] = -0.0
        nan = k % 31 == 7 + j          # a NaN taints a cell from then on
        a[rng.integers(0, n, ncell)[nan], nan] = np.nan
    warmed = warm > 0
    if algo == "mad":
        if n > 2:
            stats[2][n // 2] = np.nan
        t = [(k % 13 == 1) & warmed, (k % 13 == 2) & warmed,
             (k % 13 == 3) & ~warmed]
        c[t[0]] = 0.0
        stats[0][0, t[0]] = p_thresh * (sig * s[t[0]] + eps)
        stats[1][0, t[1]] = p_mad * (s[t[1]] + eps)
        stats[1][0, t[2]] = p_mad * (stats[2][0] + eps)
    else:
        thr = f32(float(p_thresh) * float(f32(np.sqrt(4.0 / max(m, 2)))))
        t = [k % 13 == 1, (k % 13 == 2) & warmed]
        stats[0][0, t[0]] = f32(1) - thr
        c[t[1]] = 0.0
        stats[1][0, t[1]] = p_mad * (c[t[1]] + eps)
    state = np.stack([c, s, warm])
    return stats, state, int(sum(x.sum() for x in t))


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["mad", "sk"])
@pytest.mark.parametrize("n,ncell,m,strided", [
    (256, 4096, 16, False), (1, 2_097_152, 16, False), (1, 4096, 12, False),
    (3, 1000, 5, True), (9, 300, 16, True)])
def test_flag_walk_kernel_bitwise_vs_plain(cuda, algo, n, ncell, m,
                                           strided):
    """W1 against its plain walk, bitwise: [frbflag]'s 256 windows x 4096
    channels and [dq]'s one window of 2,097,152 cells, tail segments (12
    and 5 frames: an SK threshold that is not an f32 product), windows
    past a thread's chunk of 8; ties at each threshold, NaN and -0.0
    statistics, -0.0 centres, warm counts at and one short of the cap;
    statistics and state read through element strides.  The caller's
    state is left as it was."""
    from bifrost_tpu_torch.ops.flag_kernel import flag_walk, flag_walk_plain
    params = (6.0, 4.0, 0.25)
    stats, state, ntie = _walk_case(algo, n, ncell, m, params, 40 + n)
    assert ntie > 0

    def put(a):
        t = torch.from_numpy(a).to(cuda)
        if not strided:
            return t
        wide = torch.full(a.shape[:-1] + (2 * a.shape[-1],), float("nan"),
                          device=cuda)
        wide[..., ::2] = t
        return wide[..., ::2]

    stats = [put(a) for a in stats[:2]] + \
        [torch.from_numpy(a).to(cuda) for a in stats[2:]]
    state = put(state)
    keep = state.clone()
    before = flag_walk.launches
    got = flag_walk(stats, m, state, params, algo)
    assert flag_walk.launches == before + 1
    want = flag_walk_plain(stats, m, state, params, algo)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bool and torch.equal(got[0], want[0])
    assert want[0].any() and not want[0].all()
    assert _bits_equal(got[1], want[1]) and _bits_equal(got[2], want[2])
    assert _bits_equal(state, keep)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["mad", "sk"])
def test_flag_cuda_bitwise_plain_every_form(cuda, algo):
    """Flag.execute / execute_raw under 'cuda' (W1, K5a) against 'plain'
    on the card, bitwise, on u8, f32 (also with fill='baseline'), c64 and
    ci8 gulps of 150 frames at window 16 (9 windows and a tail: two W1
    launches a gulp), two gulps from the carried baseline."""
    from bifrost_tpu_torch.ops import Flag, dq_kernel, flag_kernel
    rng = np.random.default_rng(41)
    forms = {"u8": rng.integers(0, 32, (150, 40)).astype(np.uint8),
             "f32": (rng.standard_normal((150, 8, 5)) ** 2)
             .astype(np.float32),
             "c64": (rng.standard_normal((150, 8, 5)) +
                     1j * rng.standard_normal((150, 8, 5)))
             .astype(np.complex64),
             "ci8": rng.integers(-20, 20, (150, 6, 4, 2)).astype(np.int8)}
    forms["u8"][64:, 5] = 250
    forms["f32"][80:, 3, 2] += 30.0
    forms["c64"][96:, 3, 1] += 25.0
    forms["ci8"][64:, 2, 1] = 100
    for name, a in forms.items():
        for fill in (("zero", "baseline") if name in ("u8", "f32")
                     else ("zero",)):
            plans = [Flag(method=mth).init(16, algo=algo, fill=fill)
                     for mth in ("cuda", "plain")]
            for g in range(2):
                x = torch.from_numpy(a[::-1].copy() if g else a).to(cuda)
                w0 = flag_kernel.flag_walk.launches
                f0 = dq_kernel.masked_fill.launches
                res = [p.execute_raw(x, "ci8") if name == "ci8"
                       else p.execute(x) for p in plans]
                assert flag_kernel.flag_walk.launches == w0 + 2
                assert dq_kernel.masked_fill.launches == f0 + 1
                (y1, m1), (y2, m2) = res
                torch.cuda.synchronize()
                assert torch.equal(m1, m2) and m1.any(), (name, fill, g)
                if y1.is_complex():
                    y1, y2 = torch.view_as_real(y1), torch.view_as_real(y2)
                assert torch.equal(y1.view(torch.uint8).flatten(),
                                   y2.view(torch.uint8).flatten())
                assert _bits_equal(plans[0]._state, plans[1]._state)


def _stats_power(n, m, ncell, seed, strided, dev):
    """(n, m, ncell) f32 power for W1s's edge checks: exponential noise;
    NaN samples of both signs, -0.0 and +0.0 ties, infinities, small
    integers (ties), all-equal and all-NaN cells -> a tensor on `dev`,
    cells every other element of a wider buffer where `strided`."""
    rng = np.random.default_rng(seed)
    pw = rng.exponential(1.0, (n, m, ncell)).astype(np.float32)
    k = np.arange(ncell)
    special = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0],
                       np.float32)
    special = np.concatenate([special, np.array([0xFFC00000], np.uint32)
                              .view(np.float32)])
    sel = (rng.random(pw.shape) < 0.2) & (k % 7 == 1)
    pw[sel] = rng.choice(special, pw.shape)[sel]
    pw[:, :, k % 7 == 2] = rng.choice(np.array([0.0, -0.0], np.float32),
                                      (n, m, int((k % 7 == 2).sum())))
    pw[:, :, k % 7 == 3] = rng.integers(0, 3, (n, m, int((k % 7 == 3)
                                                        .sum())))
    pw[:, :, k % 7 == 4] = 2.5
    pw[:, :, k % 97 == 5] = np.nan
    t = torch.from_numpy(pw).to(dev)
    if not strided:
        return t
    wide = torch.full((n, m, 2 * ncell), float("nan"), device=dev)
    wide[..., ::2] = t
    return wide[..., ::2]


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["mad", "sk"])
@pytest.mark.parametrize("n,m,ncell,strided", [
    (256, 16, 4096, False), (1, 16, 2_097_152, False), (3, 2, 1000, True),
    (4, 5, 300, False), (2, 12, 777, True), (5, 17, 129, False),
    (3, 32, 64, True), (1, 1, 100, False)])
def test_flag_stats_kernel_bitwise_vs_plain(cuda, algo, n, m, ncell,
                                            strided):
    """W1s against its plain version, bitwise: [frbflag]'s 256 windows
    of 16 frames x 4096 channels and [dq]'s one window of 16 frames x
    2,097,152 cells; windows of 1 to 32 frames (the register limit),
    NaN samples of both signs, -0.0/+0.0 ties, infinities, all-equal and
    all-NaN cells; the power read through element strides.  'sk' refuses
    a window of one frame."""
    from bifrost_tpu_torch.ops.flag_kernel import flag_stats, flag_stats_plain
    pw = _stats_power(n, m, ncell, 60 + m, strided, cuda)
    if algo == "sk" and m < 2:
        with pytest.raises(ValueError, match="at least 2"):
            flag_stats(pw, algo)
        return
    before = flag_stats.launches
    got = flag_stats(pw, algo)
    assert flag_stats.launches == before + 1
    want = flag_stats_plain(pw, algo)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == (n, ncell) and a.is_contiguous()
        assert _bits_equal(a, b.contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["mad", "sk"])
@pytest.mark.parametrize("n,ncell,m,strided", [
    (2, 4096, 16, False), (31, 4112, 16, False), (32, 1000, 12, True),
    (33, 4096, 16, False), (64, 33, 5, False), (97, 4112, 16, True)])
def test_flag_walk_ring_bitwise_vs_plain(cuda, algo, n, ncell, m,
                                         strided):
    """W1's ring form against its plain walk, bitwise, at the edges of
    its chunks of 32 windows (31, 32, 33, 64), past the ring's three
    stages (97 windows: four chunks, the last of one), blocks of 32
    cells with a partial last block (4112, 1000, 33), 16-byte row stores
    (ncell a multiple of 16) and element stores; the edge cases of
    `_walk_case`."""
    from bifrost_tpu_torch.ops.flag_kernel import (flag_walk,
                                                   flag_walk_plain,
                                                   walk_form)
    params = (6.0, 4.0, 0.25)
    stats, state, ntie = _walk_case(algo, n, ncell, m, params, 70 + n)
    assert ntie > 0

    def put(a):
        t = torch.from_numpy(a).to(cuda)
        if not strided or a.ndim < 2:
            return t
        wide = torch.full(a.shape[:-1] + (2 * a.shape[-1],), float("nan"),
                          device=cuda)
        wide[..., ::2] = t
        return wide[..., ::2]

    stats = [put(a) for a in stats]
    state = put(state)
    keep = state.clone()
    assert walk_form(stats, state) == "ring"
    before = flag_walk.launches, flag_walk.vector_launches
    got = flag_walk(stats, m, state, params, algo)
    assert (flag_walk.launches, flag_walk.vector_launches) == \
        (before[0] + 1, before[1])
    want = flag_walk_plain(stats, m, state, params, algo)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and want[0].any()
    assert _bits_equal(got[1], want[1]) and _bits_equal(got[2], want[2])
    assert _bits_equal(state, keep)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["mad", "sk"])
@pytest.mark.parametrize("ncell,strided,form", [
    (4096, False, "one4"), (4096, True, "one"), (4094, False, "one")])
def test_flag_walk_one_window_forms(cuda, algo, ncell, strided, form):
    """W1's one-window form: four cells a thread where the rows are
    contiguous and aligned and ncell a multiple of 4 (counted in
    `vector_launches`), a cell a thread otherwise; bitwise its plain
    walk."""
    from bifrost_tpu_torch.ops.flag_kernel import (flag_walk,
                                                   flag_walk_plain,
                                                   walk_form)
    params = (6.0, 4.0, 0.25)
    stats, state, _ = _walk_case(algo, 1, ncell, 16, params, 80)

    def put(a):
        t = torch.from_numpy(a).to(cuda)
        if not strided or a.ndim < 2:
            return t
        wide = torch.full(a.shape[:-1] + (2 * a.shape[-1],), float("nan"),
                          device=cuda)
        wide[..., ::2] = t
        return wide[..., ::2]

    stats = [put(a) for a in stats]
    state = put(state)
    assert walk_form(stats, state) == form
    before = flag_walk.vector_launches
    got = flag_walk(stats, 16, state, params, algo)
    assert flag_walk.vector_launches == before + (form == "one4")
    want = flag_walk_plain(stats, 16, state, params, algo)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and want[0].any()
    assert _bits_equal(got[1], want[1]) and _bits_equal(got[2], want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["mad", "sk"])
@pytest.mark.parametrize("n,m,ncell,strided", [
    (1, 33, 100, False), (2, 40, 77, True), (3, 63, 50, False),
    (1, 64, 129, True), (2, 75, 40, False), (1, 4096, 300, False),
    (1, 4097, 64, True), (1, 6145, 20, False), (1, 65536, 24, False),
    (1, 4096, 4096, False)])
def test_flag_stats_select_bitwise_vs_plain(cuda, algo, n, m, ncell,
                                            strided):
    """W1s's select form (windows above 32 frames) against its plain
    version, bitwise: the radix select's two middle ranks (odd and even
    m), windows held in shared memory (up to 6144 frames) and read from
    device memory in each pass (6145, 65,536), partial tiles of 8
    cells, the SK tree's ragged chunks and levels (4097: 129 chunks;
    65,536: three levels), the edge cases of `_stats_power`, strided
    power; [frbflag]'s gulp as one window, the flag block's default."""
    from bifrost_tpu_torch.ops.flag_kernel import (flag_stats,
                                                   flag_stats_plain,
                                                   stats_form)
    pw = _stats_power(n, m, ncell, 90 + m, strided, cuda)
    assert stats_form(m) == "select"
    before = flag_stats.launches, flag_stats.select_launches
    got = flag_stats(pw, algo)
    assert (flag_stats.launches, flag_stats.select_launches) == \
        (before[0] + 1, before[1] + 1)
    want = flag_stats_plain(pw, algo)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == (n, ncell) and a.is_contiguous()
        assert _bits_equal(a, b.contiguous())


def _nan_equal(a, b):
    """Bitwise where b is not NaN, NaN where it is."""
    nan = torch.isnan(b)
    return a.shape == b.shape and torch.equal(torch.isnan(a), nan) and \
        torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n,ncell,strided,nans", [
    (3, 1, False, False), (3, 2, False, True), (4, 7, True, True),
    (5, 40, False, False), (2, 41, True, True), (256, 4096, False, False),
    (3, 16384, False, True), (2, 16385, True, True),
    (1, 2_097_152, False, False), (1, 2_097_151, False, True)])
def test_flag_cross_kernel_bitwise_vs_plain(cuda, n, ncell, strided, nans):
    """W1m against `stats.median` of the same MAD rows, a NaN compared as
    a NaN: one and two cells, odd and even rows, rows with NaN MADs
    (some all NaN, some with the middle on a NaN), ties at 0, the block
    a row form up to 16,384 cells (one launch) and the grid form above
    (three launches), [frbflag]'s 256 x 4096 and [dq]'s 1 x 2,097,152,
    strided rows."""
    from bifrost_tpu_torch.ops.flag_kernel import (cross_form, flag_cross,
                                                   flag_cross_plain)
    rng = np.random.default_rng(95 + ncell)
    mad = (rng.exponential(1.0, (n, ncell)) *
           rng.uniform(0.5, 4.0, ncell)).astype(np.float32)
    mad[:, ::9] = 0.0
    mad[:, 1::13] = 2.0
    if nans:
        mad[0, ::2] = np.nan
        mad[-1] = np.nan
    t = torch.from_numpy(mad).to(cuda)
    if strided:
        wide = torch.full((n, 2 * ncell), 7.0, device=cuda)
        wide[:, ::2] = t
        t = wide[:, ::2]
    before = flag_cross.launches
    got = flag_cross(t)
    assert flag_cross.launches == before + (1 if cross_form(ncell) == "row"
                                            else 3)
    want = flag_cross_plain(t)
    torch.cuda.synchronize()
    assert got.shape == (n,) and _nan_equal(got, want)
    if nans:
        assert torch.isnan(got[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["mad", "sk"])
@pytest.mark.parametrize("window,routes", [(16, ["registers", "registers"]),
                                           (40, ["select", "registers"]),
                                           (150, ["select"])])
def test_flag_cuda_stats_route_and_launches(cuda, algo, window, routes):
    """`Flag` 'cuda' on the card: W1s once a segment in either form (the
    select form above 32 frames: no "torch" route is left), W1m once a
    'mad' segment, W1 once a segment, `plan_report()["stats_route"]`;
    bitwise 'plain' on the card and 'cuda' on the CPU, gulp after
    gulp."""
    from bifrost_tpu_torch.ops import Flag, flag_kernel
    rng = np.random.default_rng(43)
    plans = [Flag(method=mth).init(window, algo=algo)
             for mth in ("cuda", "plain", "cuda")]
    for g in range(2):
        a = rng.integers(0, 32, (150, 6, 40)).astype(np.uint8)
        a[64:, 2, 5] = 250
        a[:, 4, 7] = 200
        a[:, 1, 3] = rng.integers(0, 250, 150)   # a noisy cell
        x = torch.from_numpy(a)
        s0, x0, w0 = (flag_kernel.flag_stats.launches,
                      flag_kernel.flag_cross.launches,
                      flag_kernel.flag_walk.launches)
        sel0 = flag_kernel.flag_stats.select_launches
        res = [p.execute(x.to(cuda) if i < 2 else x)
               for i, p in enumerate(plans)]
        assert flag_kernel.flag_stats.launches == s0 + len(routes)
        assert flag_kernel.flag_stats.select_launches == \
            sel0 + routes.count("select")
        assert flag_kernel.flag_cross.launches == \
            x0 + len(routes) * (algo == "mad")
        assert flag_kernel.flag_walk.launches == w0 + len(routes)
        torch.cuda.synchronize()
        for p in plans:
            assert p.plan_report()["stats_route"] == routes
        (y1, m1), (y2, m2), (y3, m3) = res
        assert m1.any() and torch.equal(m1, m2) and torch.equal(m1.cpu(), m3)
        assert torch.equal(y1, y2) and torch.equal(y1.cpu(), y3)
        assert _bits_equal(plans[0]._state, plans[1]._state)
        if algo == "mad":
            assert _bits_equal(plans[0]._state.cpu(), plans[2]._state)


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


# ------------------------------------------- bf.map's generated kernel M1

def _m1_case(op, x, dtype, ocs=None, carry=None):
    """M1 and its plain version on the same card operands -> (kernel
    outputs, plain outputs, launches of the call)."""
    from bifrost_tpu_torch.ops import map_kernel
    prog = op.program(dtype if dtype is not None else x.dtype,
                      x.dim() - (1 if dtype in ("ci8", "ci16") else 0), ocs)
    lshape = map_kernel.logical_shape(x, prog.inputs[0])
    out_shape = lshape if not op.explicit else \
        (lshape[0],) + (tuple(ocs) if ocs is not None else lshape[1:])
    scal = [op.scalars[n] for n in prog.scalar_names]
    if op.fuse_form == "stencil" and carry is None:
        carry = op.carry_init(lshape[1:], prog.inputs[0].dtype, x.device)
    ins = [x] + [op.scalars[i.name] for i in prog.inputs[1:]]
    before = map_kernel.map_apply.launches
    got = map_kernel.map_apply(prog, ins, out_shape, scal, carry)
    n = map_kernel.map_apply.launches - before
    want = map_kernel.map_apply_plain(prog, ins, out_shape, scal, carry)
    torch.cuda.synchronize()
    return got, want, n


def _same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("func,dtype,axes,ocs", [
    # integer-exact complex input, raw ci8 pairs and packed ci4: bitwise
    ("y = 2.0f*x*x.conj() + 1.0f", "ci8", None, None),
    ("y = 2.0f*x*x.conj() + 1.0f", "ci4", None, None),
    ("y = mag2(v) - v.real * 3", "ci8", None, None),
    # packed real storage read in the kernel, integer arithmetic: bitwise
    ("y = (x << 2) - x * 3 + (x >> 1)", "i4", None, None),
    ("y(t,c) = (float)(x(t, nc-1-c)) * 0.5 + x(t, c)", "u2", ("t", "c"),
     None),
    # real f32 arithmetic (fmad off; division by a scalar divides on
    # both sides): bitwise
    ("y = (x*x - 0.1) / 3 + x % 1.5 - sqrt(fabs(x))", None, None, None),
    ("y = x > 0 ? x // 0.75 : round(x * 2) - x**2", None, None, None),
    ("y(t,c) = x(t, c-9) + x(t, nc-1-c) * 2", None, ("t", "c"), None),
    ("y(t,c) = x(t, 2*c) - c", None, ("t", "c"), (300,)),
])
def test_map_kernel_bitwise_vs_plain(cuda, func, dtype, axes, ocs):
    """M1 against its plain version on the card, bitwise: integer-exact
    complex input (ci8 and ci4 read in the kernel), packed real storage
    (i4, u2) and real f32 arithmetic (fmad off, true division); one
    launch a call."""
    from bifrost_tpu_torch.ops.map import Map
    rng = np.random.default_rng(21)
    if dtype == "ci8":
        x = torch.from_numpy(rng.integers(-128, 128, (4096, 600, 2))
                             .astype(np.int8)).to(cuda)
    elif dtype in ("ci4", "i4", "u2"):
        x = torch.from_numpy(rng.integers(0, 256, (4096, 600))
                             .astype(np.uint8)).to(cuda)
    else:
        x = torch.from_numpy((rng.standard_normal((4096, 600)) * 4)
                             .astype(np.float32)).to(cuda)
    op = Map(func, axis_names=axes)
    (got, _), (want, _), n = _m1_case(op, x, dtype, ocs)
    assert n == 1
    assert _same_bits(got[0], want[0]), \
        (got[0].float() - want[0].float()).abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [None, "ci8", "i4"])
def test_map_kernel_stencil_carry_on_the_card(cuda, dtype):
    """The stencil's two-pointer reads and its next carry, chained over
    gulps of 1000, 2 (shorter than the carry) and 333 frames read
    through a strided span: bitwise the plain engine's concatenation."""
    from bifrost_tpu_torch.ops.map import Map
    rng = np.random.default_rng(22)
    op = Map("y(t,c) = x(t,c) - x(t-3,c) * 0.5 + x(t-1, c+1)",
             axis_names=("t", "c"))
    if dtype == "ci8":
        frames = torch.from_numpy(rng.integers(-100, 100, (1335, 64, 2))
                                  .astype(np.int8)).to(cuda)
    elif dtype == "i4":
        frames = torch.from_numpy(rng.integers(0, 256, (1335, 32))
                                  .astype(np.uint8)).to(cuda)
    else:
        big = torch.from_numpy(rng.standard_normal((1335, 80))
                               .astype(np.float32)).to(cuda)
        frames = big[:, 8:72]          # a strided view, as a ring span
    carry = None
    for a, b in ((0, 1000), (1000, 1002), (1002, 1335)):
        (got, gc), (want, wc), n = _m1_case(op, frames[a:b], dtype,
                                            carry=carry)
        assert n == 1 and _same_bits(got[0], want[0])
        assert _same_bits(gc, wc)
        carry = gc


@pytest.mark.gpu
def test_map_kernel_tolerance_tiers(cuda):
    """Transcendentals (libdevice against PyTorch's kernels) and complex
    products of arbitrary values (PyTorch's kernels are built with fmad
    on): within 4 ulps of the larger magnitude."""
    from bifrost_tpu_torch.ops.map import Map
    rng = np.random.default_rng(23)
    x = torch.from_numpy((rng.standard_normal((2048, 256)) * 1.5)
                         .astype(np.float32)).to(cuda)
    z = torch.complex(x, x.flip(0))
    for func, arg in (("y = exp(x) + sin(x) * cos(x)", x),
                      ("y = log(fabs(x) + 1) - tanh(x)", x),
                      ("y = x * x.conj() * (0.3 + 0.7j) + x / (x - 2j)", z)):
        (got, _), (want, _), n = _m1_case(Map(func), arg, None)
        g = torch.view_as_real(got[0]) if got[0].is_complex() else got[0]
        w = torch.view_as_real(want[0]) if want[0].is_complex() else want[0]
        scale = torch.maximum(g.abs(), w.abs()) + 1
        assert n == 1
        assert float(((g - w).abs() / scale).max()) <= 4 * 2.0 ** -24 * 8


@pytest.mark.gpu
def test_map_kernel_eager_broadcast_and_failures(cuda):
    """The eager call's broadcasting form on M1 (each input through its
    own strides), bitwise the plain engine; 'cuda' on a refused program
    (a helper with a loop) raises with the reason; a program the kernel does not implement
    raises under 'auto' on a card tensor; a generated source nvcc
    refuses raises with nvcc's output (nothing falls back)."""
    from bifrost_tpu_torch import build
    from bifrost_tpu_torch.ops import map_kernel
    from bifrost_tpu_torch.ops.map import Map, map as eager_map
    rng = np.random.default_rng(24)
    big = torch.from_numpy(rng.integers(-50, 50, (300, 80))
                           .astype(np.float32)).to(cuda)
    a = big[:, 8:72]                    # strided rows
    b = torch.from_numpy(rng.integers(-50, 50, (64,))
                         .astype(np.float32)).to(cuda)
    before = map_kernel.map_apply.launches
    got = eager_map("c = a*s - b; d = c / 7", {"a": a, "b": b, "s": 3.0})
    assert map_kernel.map_apply.launches == before + 1
    from bifrost_tpu_torch import config
    config.set("map_method", "plain")
    try:
        want = eager_map("c = a*s - b; d = c / 7", {"a": a, "b": b,
                                                     "s": 3.0})
    finally:
        config.reset("map_method")
    for k in ("c", "d"):
        assert _same_bits(got[k], want[k])
    loop = ("def h(v):\n    for _ in range(2):\n        v = v * 2\n"
            "    return v\n")
    with pytest.raises(ValueError, match="a loop"):
        Map("y(t) = h(x(t+1))", axis_names=("t",), extra_code=loop,
            method="cuda").execute(a[:, 0])
    before = map_kernel.map_apply.launches
    with pytest.raises(NotImplementedError, match="complex32"):
        Map("y = Complex(v, v)").execute(a.half())
    assert map_kernel.map_apply.launches == before
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load_generated("broken", "this is not CUDA;")


def _m1_plain_method(fn):
    from bifrost_tpu_torch import config
    config.set("map_method", "plain")
    try:
        return fn()
    finally:
        config.reset("map_method")


@pytest.mark.gpu
@pytest.mark.parametrize("func,dtype,scalars,axes", [
    # half storage types: f32 opmath, rounded after each operator; CPU
    # scalars read unrounded by +, -, *, %, rounded by / and comparisons
    ("y = v * v - v / 3 + 1.5", "f16", None, None),
    ("y = v * 0.1 + 0.3 - s * v", "f16", {"s": 0.7}, None),
    ("y = v > 0.1 ? v // 0.75 : v % 1.3", "f16", None, None),
    ("y = v ** 3 - v ** 2 + v ** -2 + sqrt(fabs(v))", "f16", None, None),
    ("y = max(v, 0.5) + round(v * 4) + rsqrt(fabs(v) + 1)", "bf16", None,
     None),
    ("y = v * 0.1 + 0.3 - v % 0.7", "bf16", None, None),
    ("y = exp(v) * sin(v)", "f16", None, None),
    ("y = (float)(v) * 3 + v", "bf16", None, None),
    # packed complex ci2 / ci1 read in the kernel
    ("y = v * v.conj() + v * 2", "ci2", None, None),
    ("y(t,c) = v(t,c) - v(t-1,c) * 0.5", "ci1", None, ("t", "c")),
    # scalars: ** and shifts (the plain engine's own values), 0-d tensors
    ("y = v * (s ** t) + (k << j) - (k >> j) + f32cast(s) ** 2.5",
     "f32", {"s": 2.5, "t": 1.5, "k": 37, "j": 3}, None),
    ("y = v * w0 + exp(f32cast(s))", "f32",
     {"w0": "tensor0", "s": 1.3}, None),
    # statements that depend on no array, constant arrays
    ("a = s * 2; y(t,c) = v(t,c) * a + 3", "f32", {"s": 1.5}, ("t", "c")),
    ("y = v * w + 1", "f32", {"w": "array"}, None),
    ("y(t,c) = v(t,c) - v(t-2,c) * w", "f32", {"w": "array"}, ("t", "c")),
])
def test_map_kernel_new_forms_bitwise_vs_plain(cuda, func, dtype, scalars,
                                               axes):
    """M1 on its half, packed-complex, hoisted-scalar, constant-array and
    array-independent forms, against the plain engine on the card,
    bitwise; one launch a call."""
    from bifrost_tpu_torch.ops.map import Map
    rng = np.random.default_rng(41)
    scal = dict(scalars or {})
    for k, v in scal.items():
        if v == "array":
            scal[k] = torch.from_numpy(rng.standard_normal(600).astype(
                np.float32)).to(cuda)
        elif v == "tensor0":
            scal[k] = torch.tensor(0.3)
    if dtype in ("ci2", "ci1"):
        x = torch.from_numpy(rng.integers(0, 256, (4096, 600))
                             .astype(np.uint8)).to(cuda)
    else:
        x = torch.from_numpy((rng.standard_normal((4096, 600)) * 4)
                             .astype(np.float32)).to(cuda)
        x = x.to({"f16": torch.float16, "bf16": torch.bfloat16,
                  "f32": torch.float32}[dtype])
        dtype = None
    op = Map(func, axis_names=axes, scalars=scal, in_name="v")
    (got, gc), (want, wc), n = _m1_case(op, x, dtype)
    assert n == 1
    assert _same_bits(got[0], want[0]), \
        (got[0].double() - want[0].double()).abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("case", [f for f, _ in SCATTER_TABLE] +
                         [f"{f} @ {shape}" for f, shape, _ in EAGER_FORMS])
def test_map_kernel_gather_and_scatter_bitwise_vs_plain(cuda, case):
    """The eager explicit-index and scatter forms on M1 ('auto' on card
    tensors), bitwise the plain engine on the card, every output; one
    launch, two where the program scatters but for the injective affine
    scatters of ONE_PASS; a statement reading what an earlier one
    scattered starts a program of its own."""
    from bifrost_tpu_torch.ops import map_kernel
    from bifrost_tpu_torch.ops.map import _compile_map, map as eager_map
    func, _, rest = case.partition(" @ ")
    if rest:
        shape, scal = next((s, d) for f, s, d in EAGER_FORMS
                           if f == func and str(s) == rest)
        data = eager_data(dev=cuda)
        data.update(scal)
    else:
        shape = (5,)
        data = {"a": torch.arange(5, dtype=torch.float32, device=cuda) + 10,
                "c": torch.zeros(5, device=cuda)}
    axes = ("i", "j")[:len(shape)]

    def run():
        return eager_map(func, {k: (v.clone() if isinstance(
            v, torch.Tensor) else v) for k, v in data.items()},
            axis_names=axes, shape=shape)
    before = map_kernel.map_apply.launches
    got = run()
    n = map_kernel.map_apply.launches - before
    want = _m1_plain_method(run)
    torch.cuda.synchronize()
    if not isinstance(got, dict):
        got, want = {"_": got}, {"_": want}
    for k in got:
        assert _same_bits(got[k], want[k]), k
    scatters = any(idx is not None and tuple(idx) != axes for _, idx, _ in
                   _compile_map(func, tuple(sorted(data)), axes).statements)
    if func in READS_SCATTERED:
        assert n == 3, n                # cut in two: scatter, then gather
    else:
        assert n == (2 if scatters and func not in ONE_PASS else 1), n


# The gather form's tile path and the one-pass scatter on the card:
# (program, arrays: name -> shape, grid, dtype, path, launches); the full
# gulp is chip_smoke's [map] eager shape (65,536 x 512 complex64).
GULP = (65536, 512)
TILE_CASES = [
    ("c(i,j) = a(j,i)", {"a": (45, 37)}, (37, 45), "f32", "tile", 1),
    ("c(i,j) = a(j,i)", {"a": GULP}, GULP[::-1], "c64", "tile", 1),
    ("c(i,j) = a(j,i)", {"a": (45, 1)}, (1, 45), "i8", "element", 1),
    ("c(i,j,k) = a(k,i,j)", {"a": (20, 24, 12)}, (24, 12, 20), "f16",
     "tile", 1),
    ("c(i,j) = a(nj-1-j, i) * 2", {"a": (40, 33)}, (33, 40), "i32", "tile",
     1),
    ("c(j,i) = a(i,j)", {"a": (45, 37), "c": (37, 45)}, (45, 37), "i8",
     "tile", 1),
    ("c(j,i) = a(i,j)", {"a": GULP, "c": GULP[::-1]}, GULP, "c64", "tile",
     1),
    ("c(i, nj-1-j) = a(i, j)", {"a": GULP, "c": GULP}, GULP, "c64",
     "vector", 1),
    ("c(i, nj-1-j) = a(i, j)", {"a": (46, 39), "c": (46, 39)}, (46, 39),
     "f16", "element", 1),
    ("c(i,j) = a(i, nj-1-j)", {"a": GULP}, GULP, "c64", "vector", 1),
    ("c(i + 1, j) = a(i, j)", {"a": (45, 40), "c": (46, 40)}, (45, 40),
     "f32", "element", 1),
    ("c(j + 1, i) = a(i, j)", {"a": (12, 40), "c": (41, 13)}, (12, 40),
     "c64", "tile", 1),
    ("c(i//2 + h, j) = a(i, j)", {"a": GULP, "c": GULP}, GULP, "c64",
     "element", 2),
]
# each case in both index types; the full gulp in int32 (its int64 form
# is the ragged cases')
TILE_RUNS = [(c, ix) for c in TILE_CASES for ix in ("int32", "int64")
             if ix == "int32" or c[2] not in (GULP, GULP[::-1])]


@pytest.mark.gpu
@pytest.mark.parametrize("case,index", TILE_RUNS, ids=[
    f"{c[0]} {c[2]} {c[3]} {ix}" for c, ix in TILE_RUNS])
def test_map_kernel_tile_and_one_pass_bitwise_vs_plain(cuda, case, index,
                                                      monkeypatch):
    """The gather form's tile path (a shared-memory corner turn), its
    vector path (reversed reads) and the injective scatter as one launch
    over its target, at ragged and full-gulp shapes, in both index types
    (int64 forced by map_kernel.INDEX32_LIMIT, lowered to 16): each on
    the path asserted, bitwise the plain engine on the card; the
    repeated-target scatter stays two launches."""
    from bifrost_tpu_torch.ops import map_kernel
    from bifrost_tpu_torch.ops.map import clear_map_cache, map as eager_map
    func, arrays, grid, dt, path, launches = case
    if index == "int64":
        # a fresh program: one keeps the words of the layouts it has seen
        clear_map_cache()
        monkeypatch.setattr(map_kernel, "INDEX32_LIMIT", 16)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(46)
    data = {}
    for k, shape in arrays.items():
        x = torch.randn(shape, device=cuda, generator=gen) * 20
        data[k] = torch.complex(x, -x / 3) if dt == "c64" else x.to(
            {"f32": torch.float32, "f16": torch.float16, "i8": torch.int8,
             "i32": torch.int32}[dt])
    if "+ h" in func:
        data["h"] = 3 * grid[0] // 4

    def run():
        return eager_map(func, dict(data), axis_names=("i", "j", "k")[
            :len(grid)], shape=grid)
    before = map_kernel.map_apply.launches
    tiles = map_kernel.map_apply.tile_launches
    got = run()
    n = map_kernel.map_apply.launches - before
    last = dict(map_kernel.map_apply.last)
    want = _m1_plain_method(run)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    assert (last["path"], last["index"], n) == (path, index, launches), last
    assert map_kernel.map_apply.tile_launches - tiles == (path == "tile")


@pytest.mark.gpu
def test_map_kernel_scatter_duplicates_repeatable(cuda):
    """A scatter of 4M sources onto 80K targets, 32 sources each and a
    quarter of the sources dropped: the owner rule (the highest source
    position wins) gives the same bits in 20 repeated launches, bitwise
    the plain engine's amax rule on the card."""
    from bifrost_tpu_torch.ops.map import map as eager_map
    rng = np.random.default_rng(44)
    a = torch.from_numpy(rng.standard_normal((4096, 1024)).astype(
        np.float32)).to(cuda)
    c = torch.zeros((80, 1024), device=cuda)
    func = "c(i // 32 - 16, j) = a(i, j) * 3"

    def run():
        return eager_map(func, {"a": a, "c": c}, axis_names=("i", "j"),
                         shape=(4096, 1024))
    want = _m1_plain_method(run)
    first = run()
    for _ in range(20):
        assert _same_bits(run(), first)
    assert _same_bits(first, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["ci8", "ci4", "f32"])
@pytest.mark.parametrize("func,form", STREAM_FORMS)
def test_map_kernel_forward_and_unbounded_bitwise_vs_plain(cuda, func, form,
                                                          dtype):
    """The forward and unbounded streaming forms on M1's element path
    (raw ci8 and ci4 read in the kernel, f32), one launch a gulp,
    bitwise the plain engine on the card."""
    from bifrost_tpu_torch.ops.map import Map
    rng = np.random.default_rng(45)
    shape = (1000, 16, 8, 2)
    if dtype == "ci8":
        x = torch.from_numpy(rng.integers(-128, 128, shape + (2,))
                             .astype(np.int8))
    elif dtype == "ci4":
        x = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
    else:
        x = torch.from_numpy((rng.standard_normal(shape) * 4)
                             .astype(np.float32))
    op = Map(func, axis_names=("t", "c", "s", "p"))
    assert op._resolve(dtype if dtype != "f32" else torch.float32, 4) == \
        "cuda"
    (got, _), (want, _), n = _m1_case(op, x.to(cuda),
                                      None if dtype == "f32" else dtype)
    assert n == 1 and _same_bits(got[0], want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("func,axes", [
    ("y = g(v, w)", None), ("y(t,c) = g(v(t+1,c), w) + v(t,c)", ("t", "c")),
])
def test_map_kernel_inlined_helpers_bitwise_vs_plain(cuda, func, axes):
    """extra_code helpers inlined into M1 (nested, torch.minimum, where,
    np.pi), bitwise the plain engine's evaluation of the helpers on the
    card; the eager call too; one launch each."""
    from bifrost_tpu_torch.ops import map_kernel
    from bifrost_tpu_torch.ops.map import Map, map as eager_map
    code = ("def sq(v):\n    return v * v\n"
            "def g(v, w):\n    a = sq(v) * w - v / 3\n"
            "    b = torch.minimum(a, v) - 1\n"
            "    return where(b > 0, b, -b) + np.pi\n")
    rng = np.random.default_rng(46)
    x = torch.from_numpy((rng.standard_normal((4096, 600)) * 4)
                         .astype(np.float32)).to(cuda)
    op = Map(func, axis_names=axes, scalars={"w": 0.7}, in_name="v",
             extra_code=code)
    (got, _), (want, _), n = _m1_case(op, x, None)
    assert n == 1 and _same_bits(got[0], want[0])
    if axes is None:
        before = map_kernel.map_apply.launches
        got = eager_map(func, {"v": x, "w": 0.7}, extra_code=code)
        assert map_kernel.map_apply.launches == before + 1
        want = _m1_plain_method(lambda: eager_map(
            func, {"v": x, "w": 0.7}, extra_code=code))
        assert _same_bits(got, want)


@pytest.mark.gpu
def test_map_kernel_rank_and_eager_forms_on_the_card(cuda):
    """A rank-10 elementwise call (contiguous and strided, collapsed to 8
    axes), the eager call with outputs of differing shapes, ``not`` and a
    statement that depends on no array: bitwise the plain engine, one
    launch each; strides that cannot be collapsed raise."""
    from bifrost_tpu_torch.ops import map_codegen
    from bifrost_tpu_torch.ops import map_kernel
    from bifrost_tpu_torch.ops.map import Map, map as eager_map
    rng = np.random.default_rng(42)
    shape = (2, 3, 2, 2, 3, 2, 2, 2, 3, 64)
    big = torch.from_numpy(rng.standard_normal(shape[:-1] + (128,))
                           .astype(np.float32)).to(cuda)
    for x in (big[..., :64].contiguous(), big[..., ::2]):
        (got, _), (want, _), n = _m1_case(Map("y = v * 3 - 1"), x, None)
        assert n == 1 and _same_bits(got[0], want[0])
    bad = big.permute(9, 8, 7, 6, 5, 4, 3, 2, 1, 0)[:, ::2]
    with pytest.raises(map_codegen.Unsupported, match="collapsed"):
        Map("y = v * 3 - 1").execute(bad)
    a = torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32)
                         ).to(cuda)
    b = torch.from_numpy(rng.standard_normal(64).astype(np.float32)).to(cuda)
    func = "c = a + 1; d = b * 2; e = s * 3; f = a * (not s)"
    before = map_kernel.map_apply.launches
    got = eager_map(func, {"a": a, "b": b, "s": 0})
    assert map_kernel.map_apply.launches == before + 1
    want = _m1_plain_method(lambda: eager_map(func, {"a": a, "b": b,
                                                     "s": 0}))
    assert got["e"] == want["e"] == 0
    for k in ("c", "d", "f"):
        assert _same_bits(got[k], want[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_map_kernel_complex_transcendentals_within_tolerance(cuda, dtype):
    """The complex transcendentals (f64 formulas, csrc/map_common.cuh)
    against PyTorch's card kernels (thrust's) on |z| in (0.1, 10), random
    phases (never on a branch cut: the cuts of sqrt, log, pow and rsqrt
    on the negative real axis, of asin and acos on the real axis beyond
    +-1, of atan on the imaginary axis beyond +-i): within 24 ulps of
    max(|z|, |w|) in the component type, pow within 48.  M1 computes in
    f64 and rounds once, so for complex64 it is within an ulp of the
    true value and the spread is thrust's float formulas (atan 18.5 ulps,
    pow 16, the rest under 6 on an H100); tests/test_torch_map_codegen.py
    holds the complex128 bodies within 8 ulps of a 120-bit mpmath
    reference."""
    from bifrost_tpu_torch.ops.map import Map
    rng = np.random.default_rng(43)
    mag = np.exp(rng.uniform(np.log(0.1), np.log(10), (2048, 256)))
    ph = rng.uniform(-np.pi, np.pi, (2048, 256))
    z = torch.from_numpy(mag * np.exp(1j * ph)).to(dtype).to(cuda)
    eps = 2.0 ** -24 if dtype == torch.complex64 else 2.0 ** -53
    tol = 24
    worst = {}
    for fn in ("sqrt", "log", "log2", "log10", "sin", "cos", "tan", "asin",
               "acos", "atan", "sinh", "cosh", "tanh", "rsqrt",
               "pow(v, 2.5)", "v ** (0.5 + 1.5j)"):
        func = f"y = {fn}(v)" if "v" not in fn else f"y = {fn}"
        (got, _), (want, _), n = _m1_case(Map(func, in_name="v"), z, None)
        assert n == 1
        g = torch.view_as_real(got[0]).double()
        w = torch.view_as_real(want[0]).double()
        scale = torch.maximum(z.abs().double(), want[0].abs().double())
        worst[fn] = float(((g - w).abs() / scale[..., None]).max()) / eps
    print("M1 complex ulps", dtype, worst)
    assert all(err <= tol * (2 if "v" in fn else 1)
               for fn, err in worst.items()), worst


@pytest.mark.gpu
def test_map_kernel_complex64_sqrt_at_the_ends_of_the_range(cuda):
    """complex64 sqrt on M1 (csqrt_f) at SQRT_EDGES (FLT_MAX-sized parts,
    subnormal parts, zero against a tiny part, the scaling thresholds):
    finite, within 2 ulps of max(|z|, |w|) of a 120-bit mpmath reference
    and of torch.sqrt of the same points in complex128 on the card.
    PyTorch's complex64 card kernel is no reference here: on an H100 it
    returns inf at (3e38, 3e38), a negative real part at (-3.4e38,
    1e-30) and loses subnormal parts."""
    pytest.importorskip("mpmath")
    from bifrost_tpu_torch.ops.map import Map
    z = torch.tensor([complex(a, b) for a, b in SQRT_EDGES],
                     dtype=torch.complex64)[None, :].to(cuda)
    (got, _), _, n = _m1_case(Map("y = sqrt(v)", in_name="v"), z, None)
    got = got[0]
    assert n == 1 and torch.isfinite(torch.view_as_real(got)).all(), got
    err = sqrt_edge_ulps(got, z)
    assert float(err.max()) <= 2, dict(zip(SQRT_EDGES, err.tolist()))
    err = ulps_of(got.cpu(), torch.sqrt(z.to(torch.complex128)).cpu(),
                  z.cpu())
    assert float(err.max()) <= 2, dict(zip(SQRT_EDGES, err.tolist()))


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", [np.float32, np.int32])
def test_map_numpy_array_scalar_on_the_card(cuda, wdtype):
    """A numpy array of one axis or more bound as a scalar, on a card
    tensor: M1's constant-array route (one launch a call) for the eager
    call, a Map over a stream, set_scalars after construction and a
    stencil over split gulps, bitwise the same Map on the CPU (which
    tests/test_torch_map.py holds against the JAX Map)."""
    from bifrost_tpu_torch import device
    from bifrost_tpu_torch.ops import map_kernel
    from bifrost_tpu_torch.ops.map import Map, map as eager_map
    rng = np.random.default_rng(47)
    x = rng.integers(-60, 60, (4099, 37)).astype(np.float32)
    w = rng.integers(-6, 6, (37,)).astype(wdtype)
    xc, xg = torch.from_numpy(x), torch.from_numpy(x).to(cuda)

    def one_launch(fn):
        before = map_kernel.map_apply.launches
        out = fn()
        assert map_kernel.map_apply.launches == before + 1
        return out

    got = one_launch(lambda: eager_map("y = x * w + 1", {"x": xg, "w": w}))
    device.set_device("cpu")       # the eager call's numpy operands too
    try:
        want = eager_map("y = x * w + 1", {"x": xc, "w": w})
    finally:
        device._tls.device = None
    assert got.is_cuda and not want.is_cuda
    assert _same_bits(got.cpu(), want)
    op = Map("y = x * w + 1", scalars={"w": w})
    for w_new in (None, (w * 3).astype(wdtype)):
        if w_new is not None:
            op.set_scalars({"w": w_new})
        got = one_launch(lambda: op.execute(xg))
        assert _same_bits(got.cpu(), op.execute(xc))
    st = Map("y(t,c) = x(t,c) - x(t-2,c) * w", scalars={"w": w},
             axis_names=("t", "c"))
    cg = st.carry_init((37,), torch.float32, cuda)
    cc = st.carry_init((37,), torch.float32)
    for a, b in ((0, 1000), (1000, 1001), (1001, 4099)):
        yg, cg = one_launch(lambda: st.execute_carry(xg[a:b], cg))
        yc, cc = st.execute_carry(xc[a:b], cc)
        assert _same_bits(yg.cpu(), yc) and _same_bits(cg.cpu(), cc)


# M1's two paths and two index types on the card (the CPU twins are in
# tests/test_torch_map_codegen.py; the forms and layouts in
# tests/torch_map_forms.py).
def _m1_storage(form, frames, chan, dev):
    return storage(form, frames, chan, 51, dev)


def _m1_layout(form, kind, dev):
    return layout_input(form, kind, 4095, (300, 96), 51, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["vector", "tail", "unaligned",
                                    "transposed"])
@pytest.mark.parametrize("form", list(FORMS))
def test_map_kernel_paths_bitwise_vs_plain(cuda, form, layout):
    """Each storage form on M1's vector path (contiguous; the ragged
    tail on the element path) and element path (a span from an
    unaligned frame, a transposed operand): bitwise the plain version,
    one launch, the path and the 32-bit index type counted on
    map_apply.  A one-byte vector (ci2, ci1) is aligned anywhere."""
    from bifrost_tpu_torch.ops import map_codegen, map_kernel
    from bifrost_tpu_torch.ops.map import Map
    func, dt, _ = FORMS[form]
    x = _m1_layout(form, layout, cuda)
    vec0 = map_kernel.map_apply.vector_launches
    op = Map(func, in_name="v")
    (got, _), (want, _), n = _m1_case(op, x,
                                      dt if isinstance(dt, str) else None)
    last = map_kernel.map_apply.last
    prog = op.program(dt if isinstance(dt, str) else x.dtype,
                      x.dim() - (dt == "ci8"))
    nb = map_codegen.storage_bytes(prog.inputs[0]) * prog.vec
    path = "element" if layout == "transposed" or (
        layout == "unaligned" and nb > 1) else "vector"
    assert n == 1 and (last["path"], last["index"]) == (path, "int32")
    assert map_kernel.map_apply.vector_launches == vec0 + (path == "vector")
    assert _same_bits(got[0], want[0]), (form, layout)


@pytest.mark.gpu
@pytest.mark.parametrize("noff", [1, 3])
@pytest.mark.parametrize("dtype", [None, "ci8"])
@pytest.mark.parametrize("layout", ["vector", "element"])
def test_map_kernel_stencil_window_on_the_card(cuda, noff, dtype, layout):
    """The stencil's register window over gulps of 1000, 2 (shorter than
    the carry at noffset 3), 333 and 17 frames (runs that do not divide
    the gulp; a run at frame 0 reads the carry), a gather beside the
    window reads; on a strided span from an unaligned column the element
    path: bitwise the plain version, next carry included."""
    from bifrost_tpu_torch.ops import map_kernel
    from bifrost_tpu_torch.ops.map import Map
    rng = np.random.default_rng(52)
    op = Map(f"y(t,c) = x(t,c) - x(t-{noff},c) * 0.5 + x(t-1,c) * "
             f"x(t-1, c+1)", axis_names=("t", "c"))
    n = 1000 + 2 + 333 + 17
    shape = (n, 72) if dtype is None else (n, 72, 2)
    big = torch.from_numpy(rng.integers(-60, 60, shape).astype(
        np.float32 if dtype is None else np.int8)).to(cuda)
    frames = big[:, :64].contiguous() if layout == "vector" else \
        big[:, 3:67]
    carry, a = None, 0
    for g in (1000, 2, 333, 17):
        (got, gc), (want, wc), k = _m1_case(op, frames[a:a + g], dtype,
                                            carry=carry)
        a += g
        assert k == 1 and map_kernel.map_apply.last["path"] == layout
        assert _same_bits(got[0], want[0]) and _same_bits(gc, wc), g
        carry = gc


@pytest.mark.gpu
def test_map_kernel_eager_broadcast_paths(cuda):
    """The eager call on M1 with a broadcast operand along the outer axis
    and along the innermost one (the vector path, an output of a smaller
    shape written once), and with an output broadcast along the
    innermost axis or an innermost extent V does not divide (the element
    path): bitwise the plain engine, one launch each."""
    from bifrost_tpu_torch import config
    from bifrost_tpu_torch.ops import map_kernel
    from bifrost_tpu_torch.ops.map import map as eager_map
    rng = np.random.default_rng(53)
    for bshape, func, path in (
            ((256,), "c = a*b - 1; d = b * 2", "vector"),
            ((3000, 1), "c = a*b - 1; d = a - b", "vector"),
            ((3000, 1), "c = a*b - 1; d = b * 2", "element"),
            ((255,), "c = a*b - 1; d = b * 2", "element")):
        cols = bshape[-1] if bshape[-1] != 1 else 256
        a = torch.from_numpy(rng.standard_normal((3000, cols)).astype(
            np.float32)).to(cuda)
        b = torch.from_numpy(rng.standard_normal(bshape).astype(
            np.float32)).to(cuda)
        before = map_kernel.map_apply.launches
        got = eager_map(func, {"a": a, "b": b})
        assert map_kernel.map_apply.launches == before + 1
        assert map_kernel.map_apply.last["path"] == path, (bshape, func)
        config.set("map_method", "plain")
        try:
            want = eager_map(func, {"a": a, "b": b})
        finally:
            config.reset("map_method")
        for k in ("c", "d"):
            assert _same_bits(got[k], want[k]), (bshape, func, k)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["elementwise", "stencil", "local",
                                  "packed"])
def test_map_kernel_index64_form(cuda, case, monkeypatch):
    """M1's 64-bit index type, taken where an index or offset reaches
    map_kernel.INDEX32_LIMIT (lowered here to 16): bitwise the plain
    version on both paths, counted on map_apply."""
    from bifrost_tpu_torch.ops import map_kernel
    from bifrost_tpu_torch.ops.map import Map
    monkeypatch.setattr(map_kernel, "INDEX32_LIMIT", 16)
    before = map_kernel.map_apply.index64_launches
    x = _m1_storage("ci8", 1000, 64, cuda)
    if case == "elementwise":
        runs = [(Map("y = 2.0f*x*x.conj() + 1.0f"), x, "ci8", None)]
    elif case == "local":
        runs = [(Map("y(t,c) = x(t, nc-1-c) * 2 + x(t,c)",
                     axis_names=("t", "c")), x, "ci8", None)]
    elif case == "packed":
        runs = [(Map("y = v * 3 - (v >> 1)", in_name="v"),
                 _m1_storage("i4", 1000, 36, cuda)[1:], "i4", None)]
    else:
        op = Map("y(t,c) = x(t,c) - x(t-3,c) + x(t-1, c+1)",
                 axis_names=("t", "c"))
        runs = [(op, x[a:b], "ci8", None) for a, b in ((0, 500), (500, 502),
                                                        (502, 1000))]
    carry = None
    for op, xi, dt, _ in runs:
        (got, gc), (want, wc), n = _m1_case(op, xi, dt, carry=carry)
        assert n == 1 and map_kernel.map_apply.last["index"] == "int64"
        assert _same_bits(got[0], want[0])
        if gc is not None:
            assert _same_bits(gc, wc)
            carry = gc
    assert map_kernel.map_apply.index64_launches == before + len(runs)


# ------------------------------------------------------------ the fleet
FLEET_GULP = 4096


def _fleet_map_spec(func, volt, sink_outs, pace_s=0.05):
    """A paced ci8 replay -> copy('cuda') -> map(func) -> a staged
    DeviceSinkBlock keeping host copies of its gulps."""
    from bifrost_tpu_torch.blocks.testing import ArraySourceBlock
    from bifrost_tpu_torch.egress import DeviceSinkBlock
    from bifrost_tpu_torch.service import ServiceSpec, StageSpec

    class Paced(ArraySourceBlock):
        def on_data(self, reader, ospans):
            time.sleep(pace_s)
            return super().on_data(reader, ospans)

    class Sink(DeviceSinkBlock):
        def on_sink_sequence(self, iseq):
            pass

        def on_sink_data(self, arr, frame_offset):
            sink_outs.append(np.array(arr))

    hdr = {"dtype": "ci8", "labels": ["time", "station", "pol"]}
    return ServiceSpec([
        StageSpec("custom", name="replay", params=dict(
            factory=lambda up: Paced(volt, FLEET_GULP, header=hdr,
                                     name="fl_replay"))),
        StageSpec("copy", name="fl_copy"),
        StageSpec("map", name="map", params=dict(func=func)),
        StageSpec("custom", name="sink", params=dict(
            factory=lambda up: Sink(up, name="fl_sink"))),
    ])


@pytest.mark.gpu
def test_fleet_two_tenants_map_respec_cold_then_warm(cuda):
    """Two tenants on the card: an FRB-shaped FDMT chain and a map chain
    whose map stage is respecced mid-stream to a program no process has
    built (M1 is compiled: cold) and back (the library is loaded: warm).
    Every map gulp is bitwise the plain engine of the program live for
    it; the other tenant's dedispersed output is bitwise its bare run."""
    from bifrost_tpu_torch import build
    from bifrost_tpu_torch.blocks.testing import array_source, gather_sink
    from bifrost_tpu_torch.blocks import copy, map_block
    from bifrost_tpu_torch.fleet import FleetScheduler, TenantSpec
    from bifrost_tpu_torch.pipeline import Pipeline
    from bifrost_tpu_torch.service import (ServiceSpec, StageSpec,
                                           frb_search_pipeline)
    build.build_all()
    rng = np.random.default_rng(18)
    ngulp = 10
    volt = rng.integers(-8, 8, (ngulp * FLEET_GULP, 16, 2, 2),
                        dtype=np.int8)
    # A program of its own (a constant drawn per run): its M1 library is
    # on no disk yet, so the first respec compiles it.
    k = float(rng.integers(3, 1 << 20))
    funcs = ("y = x * x.conj()", f"y = x * {k}f")
    fdata = rng.integers(0, 32, (6 * 256, 128)).astype(np.uint8)
    bare = []
    frb_search_pipeline(fdata, 256, 64, device=cuda, gather=bare)[0].run()
    got, outs = [], []
    fspec = ServiceSpec([
        StageSpec("custom", name="capture", params=dict(
            factory=lambda up: array_source(fdata, 256, header={
                "labels": ["time", "freq"],
                "scales": [[0.0, 1e-3], [40.0, 0.00928]]},
                name="fl_capture"))),
        StageSpec("copy", name="fl_fcopy"),
        StageSpec("transpose", name="fl_t", params=dict(
            axes=["freq", "time"], gulp_nframe=256)),
        StageSpec("fdmt", name="fl_fdmt", params=dict(max_delay=64,
                                                      gulp_nframe=256)),
        StageSpec("custom", name="gather", params=dict(
            factory=lambda up: gather_sink(up, got, name="fl_gather"))),
    ])
    fleet = FleetScheduler(device=cuda, staging_bytes_total=1 << 30)
    fleet.submit(TenantSpec("frb", fspec, priority=1))
    mt = fleet.submit(TenantSpec("map", _fleet_map_spec(
        funcs[0], volt, outs), staging_bytes=FLEET_GULP * 16 * 2 * 8))
    recs, olds, logs = [], [], []
    for n, func in ((2, funcs[1]), (5, funcs[0])):
        deadline = time.monotonic() + 120
        while len(outs) < n:
            assert time.monotonic() < deadline and mt.state == "running"
            time.sleep(0.01)
        olds.append(mt.service.blocks["map"])
        nlog = len(build.generated_log)
        recs.append(fleet.respec("map", "map", StageSpec(
            "map", name="map", params=dict(func=func)), timeout=120.0))
        logs.append(build.generated_log[nlog:])
    assert fleet.wait(timeout=300)
    rep = fleet.stop()
    assert rep.exit_code == 0 and rep.counters["respecs"] == 2
    assert [e["nvcc"] for e in logs[0]] == [True]
    assert not any(e["nvcc"] for e in logs[1])
    seams = [o._loop_frame for o in olds]
    assert 0 < seams[0] < seams[1] < len(volt)
    assert len(outs) == ngulp
    plain = {}
    for func in funcs:
        plain[func] = []
        with Pipeline(device=cuda) as pipe:
            src = array_source(volt, FLEET_GULP, header={
                "dtype": "ci8", "labels": ["time", "station", "pol"]})
            gather_sink(map_block(copy(src, space="cuda"), func,
                                  method="plain"), plain[func])
        pipe.run()
    for g, y in enumerate(outs):
        f = g * FLEET_GULP
        func = funcs[1] if seams[0] <= f < seams[1] else funcs[0]
        assert np.array_equal(y.view(np.uint32),
                              plain[func][g].view(np.uint32)), g
    assert len(got) == len(bare)
    for a, b in zip(got, bare):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.gpu
def test_fleet_staging_view_on_a_cuda_stager_is_pinned_and_quota_held(cuda):
    """A view of the staging pool of a fleet on the card, behind a CUDA
    EgressStager, hands out pinned buffers; releases past the view's
    quota are dropped, so the view never keeps more than its quota."""
    from bifrost_tpu_torch.egress import EgressStager
    from bifrost_tpu_torch.fleet import FleetScheduler
    fleet = FleetScheduler(name="fleetpin", device=cuda,
                           staging_bytes_total=8 << 20)
    pool = fleet.staging_pool
    view = pool.view("t", quota_bytes=2 << 20)
    st = EgressStager("fleetpin", depth=2, device=cuda, pool=view)
    assert st.pool is view
    bufs = [st.pool.acquire(1 << 20) for _ in range(4)]
    assert all(b.is_pinned() for b in bufs)
    assert view.stats()["over_quota_allocs"] == 2
    for b in bufs:
        st.pool.release(b)
        assert view.stats()["retained_bytes"] <= view.quota_bytes
    assert view.stats()["retained_bytes"] == 2 << 20
    assert pool.stats()["dropped"] == 2
    again = st.pool.acquire(1 << 20)
    assert again.is_pinned() and view.stats()["allocated"] == 4
    st.pool.release(again)
    st.close()
    fleet.stop()


# -------------------------------------------- the inter-process plane
_IPC_SHM_READER = r"""
import json, sys
import numpy as np
from bifrost_tpu_torch.shmring import ShmRingReader
with ShmRingReader(sys.argv[1]) as r:
    hdr, _ = r.read_sequence()
    with open(sys.argv[2] + ".json", "w") as f:
        json.dump(hdr, f)
    chunks = []
    buf = np.empty(1 << 20, np.uint8)
    while True:
        n = r.readinto(buf)
        if n == 0:
            break
        chunks.append(buf[:n].copy())
np.concatenate(chunks).tofile(sys.argv[2])
"""


def _ipc_stream(shape, ngulp, seed):
    """A seeded f32 stream of `ngulp` gulps of `shape` (frame axis 0)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((ngulp * shape[0],) + shape[1:]) \
        .astype(np.float32)


def _ipc_pipeline(cuda, data, gulp, sink, ringlets=False):
    """array_source -> copy('cuda') [-> transpose to ringlets] ->
    sink(ring); -> the sink."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.blocks import array_source, copy
    with bt.Pipeline(device=cuda) as pipe:
        d = copy(array_source(data, gulp, header={"labels": ["time", "x"]}),
                 space="cuda")
        if ringlets:
            d = bt.blocks.transpose(d, ["x", "time"])
        snk = sink(d)
        pipe.run()
    return snk


@pytest.mark.gpu
@pytest.mark.parametrize("ringlets", [False, True],
                         ids=["frames", "ringlets"])
def test_shm_send_from_a_cuda_ring_lands_bitwise_in_another_process(
        cuda, tmp_path, ringlets):
    """shm_send on a 'cuda' ring takes the staged path through the wrap
    (the ring holds 1.5 gulps), and a reader process receives every byte.
    A stream with ringlets (x, time) goes on frame-major, under a header
    whose frame axis is first: the bytes and header of the (time, x)
    source."""
    import json
    import os
    import subprocess
    import sys
    from bifrost_tpu_torch.blocks import shm_send
    data = _ipc_stream((256, 1024), 8, 1)
    name = f"gpu_shm_{os.getpid()}"
    out = tmp_path / "got.bin"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    reader = subprocess.Popen(
        [sys.executable, "-c", _IPC_SHM_READER, name, str(out)],
        env=dict(os.environ, PYTHONPATH=root), cwd=root)
    try:
        snk = _ipc_pipeline(cuda, data, 256, lambda d: shm_send(
            d, name, data_capacity=3 * 256 * 1024 * 4 // 2, min_readers=1,
            reader_timeout=120), ringlets=ringlets)
        assert reader.wait(timeout=120) == 0
    finally:
        if reader.poll() is None:
            reader.kill()
            reader.wait(timeout=30)
    assert snk._egress_drained_gulps == 8
    got = np.fromfile(out, np.float32).reshape(data.shape)
    assert np.array_equal(got.view(np.uint32), data.view(np.uint32))
    with open(str(out) + ".json") as f:
        tensor = json.load(f)["_tensor"]
    assert tensor["shape"] == [-1, 1024] and \
        tensor["labels"] == ["time", "x"]


@pytest.mark.gpu
def test_dada_ipc_send_from_a_cuda_ring_lands_bitwise(cuda):
    """dada_ipc_send on a 'cuda' ring: staged, gulps spanning buffers (bufsz 1.5 gulps a frame short), every byte
    read back through the DADA reader."""
    import os
    import threading
    from bifrost_tpu_torch.blocks import dada_ipc_send
    from bifrost_tpu_torch.io.dada_ipc import DadaHDU
    data = _ipc_stream((128, 512), 6, 2)
    key = 0x52000000 + (os.getpid() & 0xFFFF) * 0x400
    bufsz = 3 * 128 * 512 * 4 // 2 - 512 * 4
    got, err = [], []

    def read():
        try:
            deadline = time.monotonic() + 60
            while True:
                try:
                    hdu = DadaHDU(key, create=False)
                    break
                except (OSError, RuntimeError):
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.02)
            try:
                assert "TENSOR_JSON" in hdu.read_header(timeout=60)
                while True:
                    r = hdu.data.open_read_buf(timeout=60)
                    if r == "EOD":
                        break
                    buf, nbyte = r
                    got.append(bytes(buf[:nbyte]))
                    hdu.data.mark_cleared()
            finally:
                hdu.close()
        except Exception as e:  # noqa: BLE001 — asserted below
            err.append(e)

    t = threading.Thread(target=read)
    t.start()
    snk = _ipc_pipeline(cuda, data, 128, lambda d: dada_ipc_send(
        d, key, nbufs=3, bufsz=bufsz))
    t.join(timeout=120)
    assert not t.is_alive() and not err, err
    assert snk._egress_drained_gulps == 6
    assert b"".join(got) == data.tobytes()


@pytest.mark.gpu
def test_serialize_from_a_cuda_ring_equals_the_system_ring(cuda, tmp_path):
    """serialize on a 'cuda' ring writes the files the same stream from a
    'system' ring writes, byte for byte, ringlets and rotation included."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.blocks import array_source, copy, serialize
    data = _ipc_stream((64, 32), 8, 3)
    files = {}
    for space in ("system", "cuda"):
        out = tmp_path / space
        out.mkdir()
        with bt.Pipeline(device=cuda) as pipe:
            src = array_source(data, 64, header={"labels": ["time", "x"]})
            d = copy(src, space=space) if space == "cuda" else src
            t = bt.blocks.transpose(d, ["x", "time"])
            serialize(t, path=str(out), max_file_size=3 * 64 * 4)
            pipe.run()
        files[space] = {p.name: p.read_bytes() for p in out.iterdir()}
    assert len(files["cuda"]) > 64 and files["cuda"] == files["system"]


def _virtual_mesh(axes, cuda):
    from bifrost_tpu_torch.parallel import make_mesh, virtual_devices
    return make_mesh(devices=virtual_devices(8, cuda), axis_names=axes)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("axes,spec,nbeam,evict", [
    (("time", "freq"), ("time", "freq"), 8, False),
    (("time", "beam"), ("time", None), 8, False),
    (("time", "freq"), (None, "freq"), 8, True)])
def test_beamform_kernel_at_mesh_shard_shapes(cuda, int8, axes, spec,
                                              nbeam, evict):
    """K4 at the mesh B-engine's per-shard local shapes of a (16, 4096,
    512) gulp, bitwise its plain version on every distinct shard: a
    (time, freq) = (4, 2) shard, a (time, beam) = (2, 4) shard with its
    2-beam weight slice, and after an eviction the 7 survivors' (7, 1)
    mesh on 56 channels (time replicated, a whole-gulp launch).  Integer
    data: the shards' powers psum to the single launch's, bitwise."""
    from bifrost_tpu_torch.blocks.beamform import _bengine_mesh
    from bifrost_tpu_torch.ops import beamform_kernel as bk
    from bifrost_tpu_torch.parallel import faultdomain
    from bifrost_tpu_torch.parallel.shard import shard_views
    mesh = _virtual_mesh(axes, cuda)
    nchan = 56 if evict else 4096
    g = torch.Generator().manual_seed(nchan + nbeam)
    pairs = torch.randint(-8, 8, (16, nchan, 512, 2), generator=g)
    x = pairs.to(torch.int8) if int8 else \
        torch.complex(pairs[..., 0].float(), pairs[..., 1].float())
    x = x.to(cuda)
    w = torch.complex(torch.randint(-3, 4, (nbeam, 512), generator=g).float(),
                      torch.randint(-3, 4, (nbeam, 512), generator=g)
                      .float()).to(cuda)
    faultdomain.reset()
    try:
        if evict:
            faultdomain.evict(str(mesh.devices.flat[5]))
            mesh = faultdomain.effective_mesh(mesh)
            assert mesh.devices.shape == (7, 1)
        wspec = ("beam", None) if "beam" in axes else (None, None)
        xs = shard_views(mesh, x, spec + (None,))
        ws = shard_views(mesh, w, wspec)
        pairs_seen = set()
        for xv, wv in zip(xs.values, ws.values):
            if (id(xv), id(wv)) in pairs_seen:
                continue
            pairs_seen.add((id(xv), id(wv)))
            xv, wv = xv.contiguous(), wv.contiguous()
            before = bk.beamform_power.launches
            p = bk.beamform_power(xv, wv)
            assert bk.beamform_power.launches == before + 1
            assert _bits_equal(p, bk.beamform_power_plain(xv, wv))
        assert len(pairs_seen) == (1 if evict else 8)
        tax = "time" if spec[0] else None
        fax = "freq" if spec[1] else None
        bax = "beam" if "beam" in axes else None
        before = bk.beamform_power.launches
        got = _bengine_mesh(mesh, tax, fax, None, bax)(x, w)
        assert bk.beamform_power.launches == before + len(pairs_seen)
        assert _bits_equal(got, bk.beamform_power(x.contiguous(), w))
    finally:
        faultdomain.reset()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["ci8", "ci4"])
@pytest.mark.parametrize("nchan,evict", [(128, False), (56, True)])
def test_xengine_kernel_at_mesh_shard_shapes(cuda, fmt, nchan, evict):
    """X1 at the mesh X-engine's per-shard local shapes of a 1024-frame
    gulp of 512 inputs: (time, freq) = (2, 4) shards of 128 channels
    (512 x 32 x 512), and after an eviction a 7-way freq shard of 56
    channels with time replicated (1024 x 8 x 512); bitwise the plain
    version per shard, and the psum of the shards' visibilities bitwise
    one whole-gulp launch (integer data, exact)."""
    from bifrost_tpu_torch.blocks.correlate import _xengine_mesh
    from bifrost_tpu_torch.ops import xengine_kernel as xk
    from bifrost_tpu_torch.parallel import faultdomain
    from bifrost_tpu_torch.parallel.shard import shard_views
    mesh = _virtual_mesh(("freq",) if evict else ("time", "freq"), cuda)
    g = torch.Generator().manual_seed(nchan)
    lo, hi = (-128, 127) if fmt == "ci8" else (-8, 7)
    re = torch.randint(lo, hi + 1, (1024, nchan, 512), generator=g)
    im = torch.randint(lo, hi + 1, (1024, nchan, 512), generator=g)
    x = torch.stack([re, im], -1).to(torch.int8) if fmt == "ci8" else \
        (((re & 0xF) << 4) | (im & 0xF)).to(torch.uint8)
    x = x.to(cuda)
    faultdomain.reset()
    try:
        if evict:
            faultdomain.evict(str(mesh.devices.flat[2]))
            mesh = faultdomain.effective_mesh(mesh)
            assert mesh.devices.shape == (7,)
            tax, fax = None, "freq"
        else:
            tax, fax = "time", "freq"
        xs = shard_views(mesh, x, (tax, fax))
        shards = xs.distinct()
        assert len(shards) == (7 if evict else 8)
        for xv in shards:
            xv = xv.contiguous()
            before = xk.xengine_int8.launches
            got = xk.xengine_int8(xv, fmt)
            assert xk.xengine_int8.launches == before + 1
            assert _bits_equal(torch.view_as_real(got), torch.view_as_real(
                xk.xengine_int8_plain(xv, fmt)))
        before = xk.xengine_int8.launches
        v = _xengine_mesh(mesh, tax, fax, "int8", fmt=fmt)(x)
        assert xk.xengine_int8.launches == before + len(shards)
        whole = xk.xengine_int8(x, fmt)
        assert _bits_equal(torch.view_as_real(v), torch.view_as_real(whole))
    finally:
        faultdomain.reset()


# ------------------------------------------- the user surface on the card
@pytest.mark.gpu
def test_raw_malloc_cuda_host_is_pinned_and_memcpy2d(cuda):
    from bifrost_tpu_torch import memory
    p1 = memory.raw_malloc(64 * 32, "cuda_host")
    p2 = memory.raw_malloc(64 * 64, "cuda_host")
    try:
        assert memory.raw_pinned(p1) and memory.raw_pinned(p2)
        assert memory.raw_get_space(p1) == "cuda_host"
        assert p1 % memory.alignment() == 0
        src = np.arange(64 * 32, dtype=np.uint8)
        memory.memcpy(p1, src.ctypes.data, src.nbytes)
        memory.memset(p2, 0, 64 * 64)
        memory.memcpy2D(p2, 64, p1, 32, 32, 64)
        import bifrost_tpu_torch as bf
        dst = bf.ndarray(buffer=p2, shape=(64, 64), dtype="u8")
        np.testing.assert_array_equal(dst[:, :32], src.reshape(64, 32))
        assert not dst[:, 32:].any()
    finally:
        memory.raw_free(p1)
        memory.raw_free(p2)


@pytest.mark.gpu
def test_surface_arrays_on_the_card(cuda):
    import bifrost_tpu_torch as bf
    from bifrost_tpu_torch import memory
    a = np.arange(48, dtype=np.float32).reshape(6, 8)
    t = bf.asarray(a, space="cuda", device=cuda)
    assert t.is_cuda and bf.get_space(t) == "cuda"
    assert bf.asarray(t, space="system").tobytes() == a.tobytes()
    pinned = bf.asarray(a, space="cuda_host")
    assert pinned.is_pinned() and bf.get_space(pinned) == "cuda_host"
    for src, space in ((t, "cuda"), (pinned, "cuda_host")):
        for like in (bf.empty_like, bf.zeros_like):
            y = like(src)
            assert bf.get_space(y) == space and y.device == src.device
            assert y.shape == src.shape and y.dtype == src.dtype
        assert not bf.zeros_like(src).any()
    assert bf.empty((4,), space="cuda_host").is_pinned()
    m = t.clone()
    bf.memset_array(m, 0xFF)
    assert bool((m.view(torch.int32) == -1).all())
    ptr = memory.raw_malloc(a.nbytes, "cuda_host")
    try:
        host = bf.ndarray(buffer=ptr, shape=a.shape, dtype="f32",
                          space="cuda_host")
        assert bf.copy_array(host, t) is host
        assert host.tobytes() == a.tobytes()
    finally:
        memory.raw_free(ptr)


@pytest.mark.gpu
def test_external_stream_queues_the_scope_s_work_on_the_stream(cuda):
    import bifrost_tpu_torch as bf
    stream = torch.cuda.Stream(cuda)
    torch.cuda.synchronize()
    with bf.device.ExternalStream(stream):
        assert torch.cuda.current_stream(cuda) == stream
        torch.cuda._sleep(100_000_000)
        assert not stream.query()
        assert torch.cuda.default_stream(cuda).query()
    assert stream.query()
    with bf.device.ExternalStream(stream.cuda_stream, device=cuda):
        assert torch.cuda.current_stream(cuda).cuda_stream == \
            stream.cuda_stream


@pytest.mark.gpu
def test_fft_and_fdmt_from_the_card_into_host_ndarrays(cuda):
    import bifrost_tpu_torch as bf
    rng = np.random.default_rng(22)
    x = torch.from_numpy((rng.standard_normal((8, 512)) + 1j *
                          rng.standard_normal((8, 512))).astype(
                              np.complex64)).to(cuda)
    want = np.fft.fft(x.cpu().numpy(), axis=1)
    out = bf.empty((8, 512), dtype="cf32")
    bf.fft.fft(x, out, axes=1)
    bound = 32 * np.finfo(np.float32).eps * np.sqrt(512) * \
        np.abs(want).max()
    assert np.abs(np.asarray(out) - want).max() <= bound
    nchan, max_delay, ntime = 256, 64, 1024
    xf = torch.from_numpy(rng.integers(0, 32, (nchan, ntime)).astype(
        np.float32)).to(cuda)
    plan = Fdmt().init(nchan, max_delay, 40.0, 0.1, method="cuda")
    fout = bf.empty((max_delay, ntime), dtype="f32")
    before = fdmt_kernel.merge_step.launches
    assert plan.execute(xf, fout) is fout
    assert fdmt_kernel.merge_step.launches == before + len(plan._steps)
    plain = Fdmt().init(nchan, max_delay, 40.0, 0.1, method="plain") \
        .execute(xf).cpu().numpy()
    assert np.asarray(fout).tobytes() == plain.tobytes()


@pytest.mark.gpu
def test_numpy_input_to_the_ops_lands_on_the_card(cuda):
    """With no device bound, numpy input to every op that lifts it goes
    to the card."""
    import importlib
    import threading
    import bifrost_tpu_torch as bf
    from bifrost_tpu_torch.ops import fftshift, reduce_to, transpose
    from bifrost_tpu_torch.ops.calibrate import calibrate
    from bifrost_tpu_torch.ops.flag import flag
    emap = importlib.import_module("bifrost_tpu_torch.ops.map").map
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    calls = [lambda: calibrate(x, np.ones(4, np.complex64)),
             lambda: Fdmt().init(8, 4, 60e6, 0.1e6).execute(x),
             lambda: bf.fft.fft(x, axes=1),
             lambda: fftshift(x, axes=0),
             lambda: flag(x, 4)[0],
             lambda: emap("b = a * 2", {"a": x}, shape=(8, 4)),
             lambda: reduce_to(x, (8, 1), "sum"),
             lambda: transpose(None, x, axes=(1, 0))]
    got = []

    def run():
        got.extend(c() for c in calls)
    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive() and len(got) == len(calls)
    assert all(r.is_cuda for r in got)
