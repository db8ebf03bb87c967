"""The port's exact int8 X-engine (`CorrelateBlock(engine='int8')`, kernel
X1's plain version) against the JAX package's `correlate(engine='int8')`,
on the CPU, on the same seeded numpy input.

- ci8 and packed ci4 voltages read raw from a 'cuda' ring (the storage
  head), and complex voltages through the logical path, whose float ->
  int8 cast must truncate, send NaN to 0 and saturate as JAX's
  ``astype(int8)`` does; mid-gulp integration boundaries and a partial
  final gulp; fused against unfused (mirrors tests/test_blocks.py:307,
  tests/test_beamform_fir.py:344 and tests/test_fusion_engines.py:106).
- X1's plain version against a numpy int64 golden, ci8 and ci4.
- The gulp guard (65,536 frames) and the `xengine_method` latch.

Tolerance: none without gains.  Every product and sum is an integer
below 2**24 here (|v| <= 2 * 128**2 * 16), so the f32 visibilities are
exact on both sides and compared bitwise.  With gains the fold
``v' = (vr Gr - vi Gi, vr Gi + vi Gr)`` (G_ij = conj(g_i) g_j) is f32
arithmetic that XLA:CPU compiles its own way (FMA contraction) and the
port does not.  With A = |gr| + |gi| and S = (|vr| + |vi|) A_i A_j, the
port's real and imaginary parts are each within 4 roundings, 4 * 2**-24
* S, of the exact fold of the exact planes (G's product and sum, the
fold's product and sum); the XLA side measured up to 5.6 * 2**-24 * S on
these inputs, so each part is held to |port - jax| <= 16 * 2**-24 * S.
"""

import numpy as np
import pytest
import torch

import bifrost_tpu as jbf
from bifrost_tpu import blocks as jblocks
from bifrost_tpu import config as jconfig
from bifrost_tpu.blocks.testing import array_source as j_array_source
from bifrost_tpu.blocks.testing import gather_sink as j_gather
from bifrost_tpu.ops import quantize as j_quantize
from bifrost_tpu.pipeline import Pipeline as JPipeline

import bifrost_tpu_torch as pbf
from bifrost_tpu_torch import blocks as pblocks
from bifrost_tpu_torch import config as pconfig
from bifrost_tpu_torch.blocks.correlate import INT8_MAX_GULP, int8_pairs
from bifrost_tpu_torch.ops import xengine_kernel
from bifrost_tpu_torch.ops.xengine_kernel import (xengine_int8,
                                                  xengine_int8_plain)
from bifrost_tpu_torch.pipeline import Pipeline as PPipeline

EPS = 2.0 ** -24
HDR = ["time", "freq", "station", "pol"]


def _ci8(ntime, shape=(4, 3, 2), seed=0, lo=-128, hi=128):
    rng = np.random.default_rng(seed)
    raw = np.empty((ntime,) + shape, dtype=[("re", "i1"), ("im", "i1")])
    raw["re"] = rng.integers(lo, hi, raw.shape)
    raw["im"] = rng.integers(lo, hi, raw.shape)
    return raw


def _ci4(ntime, shape=(4, 3, 2), seed=0):
    """Packed ci4 bytes and their complex value."""
    rng = np.random.default_rng(seed)
    a = (rng.integers(-8, 8, (ntime,) + shape) +
         1j * rng.integers(-8, 8, (ntime,) + shape)).astype(np.complex64)
    q = jbf.empty(a.shape, dtype="ci4")
    j_quantize(a, q, scale=1.0)
    return np.asarray(q), a


def _run_jax(data, dtype, n_int, gulp, fuse_on, labels=HDR, **kw):
    jconfig.set("pipeline_fuse", fuse_on)
    try:
        chunks = []
        with JPipeline() as pipe:
            src = j_array_source(np.asarray(data), gulp, header={
                "dtype": dtype, "labels": labels})
            with jbf.block_scope(fuse=True):
                dev = jblocks.copy(src, space="tpu")
                x = jblocks.correlate(dev, nframe_per_integration=n_int,
                                      engine="int8", **kw)
            j_gather(jblocks.copy(x, space="system"), chunks)
            pipe.run()
        return np.concatenate(chunks, axis=0)
    finally:
        jconfig.reset("pipeline_fuse")


def _run_port(data, dtype, n_int, gulp, fuse_on, labels=HDR, report=None,
              **kw):
    pconfig.set("pipeline_fuse", fuse_on)
    try:
        chunks = []
        with PPipeline(device="cpu") as pipe:
            src = pblocks.array_source(np.asarray(data), gulp, header={
                "dtype": dtype, "labels": labels})
            with pbf.block_scope(fuse=True):
                dev = pblocks.copy(src, space="cuda")
                x = pblocks.correlate(dev, n_int, engine="int8", **kw)
            pblocks.gather_sink(x, chunks)
            pipe.run()
            if report is not None:
                report.append(pipe.fusion_report())
        return np.concatenate(chunks, axis=0), x
    finally:
        pconfig.reset("pipeline_fuse")


def _golden(a, n_int):
    xf = a.astype(np.complex128).reshape(a.shape[0], a.shape[1], -1)
    return np.stack([np.einsum("tci,tcj->cij", np.conj(xf[t:t + n_int]),
                               xf[t:t + n_int])
                     for t in range(0, a.shape[0] - n_int + 1, n_int)])


@pytest.mark.parametrize("ntime,gulp,n_int", [
    (48, 8, 16),     # integration boundary on the gulp grid
    (48, 8, 12),     # mid-gulp integration boundary
    (44, 8, 12),     # partial final gulp, dropped
    (16, 16, 16),    # one gulp is one integration: straight into the span
])
@pytest.mark.parametrize("dtype", ["ci8", "ci4"])
@pytest.mark.parametrize("fuse_on", [False, True])
def test_int8_engine_raw_head_bitwise_vs_jax(dtype, ntime, gulp, n_int,
                                             fuse_on):
    if dtype == "ci8":
        data = _ci8(ntime, seed=ntime + n_int)
        a = data["re"] + 1j * data["im"].astype(np.float64)
    else:
        data, a = _ci4(ntime, seed=ntime + n_int)
    rep = []
    if ntime % n_int:
        with pytest.warns(UserWarning, match="partial integration"):
            got, blk = _run_port(data, dtype, n_int, gulp, fuse_on,
                                 report=rep)
    else:
        got, blk = _run_port(data, dtype, n_int, gulp, fuse_on, report=rep)
    want = _run_jax(data, dtype, n_int, gulp, fuse_on)
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert np.array_equal(got.reshape(-1, *_golden(a, n_int).shape[1:]),
                          _golden(a, n_int).astype(np.complex64))
    if fuse_on:
        names = [n for g in rep[0]["groups"] for n in g["constituents"]]
        assert blk.name in names
    else:
        # The unfused block read every gulp in raw storage form.
        ngulp = -(-ntime // gulp)
        assert blk._raw_reads == ngulp
        assert blk._raw_read_nbyte == data.size * (2 if dtype == "ci8"
                                                   else 1)


@pytest.mark.parametrize("engine", ["int8", "f32"])
@pytest.mark.parametrize("dtype", ["ci8", "ci4"])
def test_correlate_host_ring_storage_vs_jax(dtype, engine):
    """A complex-integer stream on a host ring, with no copy: the block
    stages each gulp onto its device in storage form (the ci4 bytes are
    not lifted through a complex view), counts no raw read, and agrees
    bitwise with the JAX block on its host ring."""
    if dtype == "ci8":
        data = _ci8(24, seed=21)
    else:
        data, _ = _ci4(24, seed=21)
    chunks = []
    with PPipeline(device="cpu") as pipe:
        src = pblocks.array_source(data, 8, header={
            "dtype": dtype, "labels": HDR})
        x = pblocks.correlate(src, 12, engine=engine)
        pblocks.gather_sink(x, chunks)
        pipe.run()
    got = np.concatenate(chunks, axis=0)
    jchunks = []
    with JPipeline() as pipe:
        src = j_array_source(np.asarray(data), 8, header={
            "dtype": dtype, "labels": HDR})
        j_gather(jblocks.correlate(src, nframe_per_integration=12,
                                   engine=engine), jchunks)
        pipe.run()
    want = np.concatenate(jchunks, axis=0)
    assert got.shape == want.shape == (2, 4, 3, 2, 3, 2)
    assert np.array_equal(got, want)
    assert x._raw_reads == 0


def test_int8_engine_fused_equals_unfused_with_permuted_axes():
    """A header in another axis order: one permute to canonical order,
    fused == unfused == JAX."""
    data = _ci8(24, shape=(3, 2, 4), seed=9)      # (time, pol, freq, station)
    labels = ["time", "pol", "freq", "station"]
    f, _ = _run_port(data, "ci8", 8, 8, True, labels=labels)
    u, _ = _run_port(data, "ci8", 8, 8, False, labels=labels)
    assert np.array_equal(f, u)
    assert np.array_equal(f, _run_jax(data, "ci8", 8, 8, False,
                                      labels=labels))


def test_int8_engine_logical_path_casts_like_jax():
    """Complex f32 voltages through the int8 engine: truncation, NaN ->
    0 and saturation as JAX's astype(int8); bitwise through the blocks,
    and through the engines alone for infinities (the JAX ring carries
    inf - inf j as nan - inf j, so the blocks cannot be compared
    there)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((32, 4, 3, 2)) * 90 +
         1j * rng.standard_normal((32, 4, 3, 2)) * 90).astype(np.complex64)
    x[0, 0, 0, 0] = -300.7 + 200.2j
    x[2, 2, 2, 0] = complex(np.nan, 0.5)
    x[3, 3, 0, 1] = -0.99 + 0.99j
    got, _ = _run_port(x, "cf32", 16, 8, False)
    want = _run_jax(x, "cf32", 16, 8, False)
    assert np.array_equal(got, want)
    import jax.numpy as jnp
    from bifrost_tpu.blocks.correlate import _xengine_jit
    y = x[:16].reshape(16, 4, 6).copy()
    y[1, 1, 1] = complex(np.inf, -np.inf)
    y[2, 0, 3] = complex(-np.inf, 1e10)
    v = xengine_int8_plain(int8_pairs(torch.from_numpy(y)), "ci8")
    assert np.array_equal(v.numpy(), np.asarray(_xengine_jit(
        jnp.asarray(y), "int8")))
    p = int8_pairs(torch.tensor([-300.7 + 200.2j, complex(np.inf, -np.inf),
                                 complex(np.nan, 0.5), -0.99 + 127.9j]))
    assert p.tolist() == [[-128, 127], [127, -128], [0, 0], [0, 127]]


def test_int8_engine_gains_within_fold_bound():
    data = _ci8(32, seed=5)
    rng = np.random.default_rng(6)
    g = (rng.standard_normal(3) + 1j * rng.standard_normal(3)) \
        .astype(np.complex64)
    got, _ = _run_port(data, "ci8", 16, 8, False, gains=g)
    want = _run_jax(data, "ci8", 16, 8, False, gains=g)
    plain, _ = _run_port(data, "ci8", 16, 8, False)
    gg = np.repeat(g, 2)
    G = np.conj(gg)[:, None] * gg[None, :]
    A = np.abs(gg.real) + np.abs(gg.imag)
    v = plain.reshape(plain.shape[0], plain.shape[1], 6, 6)
    bound = 16 * EPS * (np.abs(v.real) + np.abs(v.imag)) * \
        (A[:, None] * A[None, :])
    d = got.reshape(v.shape) - want.reshape(v.shape)
    assert (np.abs(d.real) <= bound).all()
    assert (np.abs(d.imag) <= bound).all()
    exact = v.astype(np.complex128) * G
    assert np.allclose(got.reshape(v.shape), exact, rtol=1e-5, atol=1e-3)


def _x1_input(fmt, ntime, nchan, nsp, values="random", seed=12):
    """A storage-form gulp and its int planes: seeded full-range values,
    all at the type's minimum or maximum, or alternating extremes (signs
    flip along time and stations, re and im opposite)."""
    lo, hi = (-128, 127) if fmt == "ci8" else (-8, 7)
    shape = (ntime, nchan, nsp)
    if values == "random":
        rng = np.random.default_rng(seed)
        re = rng.integers(lo, hi + 1, shape)
        im = rng.integers(lo, hi + 1, shape)
    elif values in ("min", "max"):
        re = im = np.full(shape, lo if values == "min" else hi)
    else:
        up = (np.arange(ntime)[:, None, None] +
              np.arange(nsp)[None, None, :]) % 2 == 0
        re = np.broadcast_to(np.where(up, hi, lo), shape)
        im = np.broadcast_to(np.where(up, lo, hi), shape)
    if fmt == "ci8":
        x = torch.from_numpy(np.stack([re, im], -1).astype(np.int8))
    else:
        x = torch.from_numpy((((re & 0xF) << 4) | (im & 0xF))
                             .astype(np.uint8))
    return x, re, im


# X1's boundaries: stations around its 64-row warpgroup and 128-station
# tiles, frames around its 32-sample wgmma step and the 16-sample pitch;
# extreme values at two of them.  The first two cases are the original
# ones.
X1_CASES = ([("ci8", 37, 3, 70, "random"), ("ci4", 37, 3, 70, "random")] +
            [(fmt, t, 2, n, "random") for fmt in ("ci8", "ci4")
             for n in (1, 63, 64, 65, 127, 128, 129, 200)
             for t in (1, 31, 33, 45, 200)] +
            [(fmt, t, c, n, v) for fmt in ("ci8", "ci4")
             for v in ("min", "max", "alternating")
             for t, c, n in ((200, 2, 129), (33, 1, 64))])


@pytest.mark.parametrize(
    "fmt,ntime,nchan,nsp,values", X1_CASES,
    ids=["ci8", "ci4"] + ["-".join(map(str, c)) for c in X1_CASES[2:]])
def test_x1_plain_vs_int64_golden(fmt, ntime, nchan, nsp, values):
    """X1's plain version, the wrapper on the CPU and the plain twin of
    the kernel's decomposition against an int64 golden; the twin
    bitwise the plain version, into an `out` prefilled with NaN."""
    x, re, im = _x1_input(fmt, ntime, nchan, nsp, values)
    z = (re + 1j * im).astype(np.complex128)
    golden = np.einsum("tci,tcj->cij", np.conj(z), z)
    for fn in (xengine_int8, xengine_int8_plain,
               xengine_kernel.xengine_int8_tiled):
        v = fn(x, fmt)
        assert v.dtype == torch.complex64 and v.shape == (nchan, nsp, nsp)
        assert np.array_equal(v.numpy(), golden.astype(np.complex64))
    out = torch.empty(nchan, nsp, nsp, dtype=torch.complex64)
    assert xengine_int8(x, fmt, out=out) is out
    nan = torch.full((nchan, nsp, nsp), complex(np.nan, np.nan))
    assert xengine_kernel.xengine_int8_tiled(x, fmt, out=nan) is nan
    assert torch.equal(torch.view_as_real(nan).view(torch.int32),
                       torch.view_as_real(out).view(torch.int32))
    with pytest.raises(TypeError):
        xengine_int8(x.float(), fmt)
    with pytest.raises(ValueError, match="storage form"):
        xengine_int8(x, "ci2")


@pytest.mark.parametrize("fmt", ["ci8", "ci4"])
@pytest.mark.parametrize("ntime,nsp,values", [
    (45, 129, "random"), (1, 200, "random"), (33, 64, "min"),
    (200, 65, "alternating")])
def test_x1_hermitian(fmt, ntime, nsp, values):
    """v[c, j, i] == conj(v[c, i, j]) on the plain version and on the
    twin that writes the lower triangle as mirrors: the real parts
    bitwise, the imaginary parts equal as values (a zero is +0.0 on
    both sides, where conj gives -0.0)."""
    x, _, _ = _x1_input(fmt, ntime, 2, nsp, values, seed=ntime + nsp)
    for fn in (xengine_int8_plain, xengine_kernel.xengine_int8_tiled):
        v = fn(x, fmt)
        assert torch.equal(v.real.mT.contiguous().view(torch.int32),
                           v.real.contiguous().view(torch.int32))
        assert torch.equal(v.imag.mT, -v.imag)
        assert (v.imag.diagonal(dim1=1, dim2=2) == 0).all()


@pytest.mark.parametrize("nsp", [1, 63, 64, 65, 127, 128, 129, 200, 512,
                                 1000])
def test_x1_tile_pairs_cover_the_upper_triangle_once(nsp):
    """The tiles X1 launches hold every pair i <= j exactly once, and
    no tile lies wholly below the diagonal (10 of 16 at 512 stations)."""
    tm, tn = xengine_kernel.TILE_M, xengine_kernel.TILE_N
    hits = np.zeros((nsp, nsp), dtype=np.int64)
    pairs = xengine_kernel.tile_pairs(nsp)
    for i0, j0 in pairs:
        assert i0 <= j0 + tn - 1 and i0 < nsp and j0 < nsp
        hits[i0:i0 + tm, j0:j0 + tn] += 1
    assert (np.triu(hits) == np.triu(np.ones_like(hits))).all()
    assert len(set(pairs)) == len(pairs)
    if nsp == 512 and tm == tn == 128:
        assert len(pairs) == 10


def test_int8_gulp_guard():
    data = _ci8(8, seed=1)
    with PPipeline(device="cpu") as pipe:
        src = pblocks.array_source(data, 8, header={
            "dtype": "ci8", "labels": HDR})
        x = pblocks.correlate(src, INT8_MAX_GULP, engine="int8",
                              gulp_nframe=INT8_MAX_GULP)
        pblocks.gather_sink(x, [])
        with pytest.raises(Exception, match="int32"):
            pipe.run()
    assert INT8_MAX_GULP == 65536
    with PPipeline(device="cpu"):
        src = pblocks.array_source(data, 8, header={
            "dtype": "ci8", "labels": HDR})
        with pytest.raises(ValueError, match="engine"):
            pblocks.correlate(src, 8, engine="bf16")


def test_xengine_method_latched_per_sequence():
    """'plain' and 'cuda' (the plain version on the CPU) agree bitwise;
    the flag cannot change while a sequence holds it.  The stream runs
    more gulps than the output ring holds (ROADMAP Queue C)."""
    data = _ci8(512, shape=(2, 2, 1), seed=3)
    errs = []

    def flip(*_):
        try:
            pconfig.set("xengine_method", "cuda")
        except RuntimeError as e:
            errs.append(str(e))

    pconfig.set("xengine_method", "plain")
    try:
        chunks = []
        with PPipeline(device="cpu") as pipe:
            src = pblocks.array_source(data, 8, header={
                "dtype": "ci8", "labels": HDR})
            dev = pblocks.copy(src, space="cuda")
            x = pblocks.correlate(dev, 8, engine="int8")
            pblocks.callback_sink(x, on_data=lambda a: (
                chunks.append(a.clone().numpy()), flip()))
            pipe.run()
        assert x._xmethod == "plain"
        assert errs and "xengine_method" in errs[0]
    finally:
        pconfig.reset("xengine_method")
    assert pconfig.get("xengine_method") == "auto"
    cuda_run, blk = _run_port(data, "ci8", 8, 8, False)
    assert blk._xmethod == "cuda"
    assert np.array_equal(np.concatenate(chunks), cuda_run)
    with pytest.raises(ValueError):
        xengine_kernel.xengine_int8(torch.zeros(2, 1, 1, 2,
                                                dtype=torch.int8)
                                    .to("meta"), "ci8")


def test_f32_engine_raw_ci16_head_matches_jax():
    """The raw head lifts wide storage as it lies: ci16 voltages past the
    int8 range through the f32 engine, against the JAX engine (products
    of integers below 2**12, sums below 2**24: bitwise)."""
    rng = np.random.default_rng(13)
    raw = np.empty((16, 2, 3, 2), dtype=[("re", "<i2"), ("im", "<i2")])
    raw["re"] = rng.integers(-900, 900, raw.shape)
    raw["im"] = rng.integers(-900, 900, raw.shape)
    chunks = []
    with PPipeline(device="cpu") as pipe:
        src = pblocks.array_source(raw, 8, header={"dtype": "ci16",
                                                  "labels": HDR})
        x = pblocks.correlate(pblocks.copy(src, space="cuda"), 8)
        pblocks.gather_sink(x, chunks)
        pipe.run()
    got = np.concatenate(chunks)
    jchunks = []
    with JPipeline() as pipe:
        src = j_array_source(raw, 8, header={"dtype": "ci16",
                                             "labels": HDR})
        jx = jblocks.correlate(jblocks.copy(src, space="tpu"), 8)
        j_gather(jblocks.copy(jx, space="system"), jchunks)
        pipe.run()
    assert x._raw_reads == 2
    assert np.array_equal(got, np.concatenate(jchunks))
