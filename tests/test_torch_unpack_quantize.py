"""The port's sub-byte data plane against the JAX package, on the CPU, on
the same seeded numpy input: `ops.unpack`, `ops.quantize`, the planned
`Unpack`/`Quantize` ops, `staged_unpack` on packed ci4, the unpack and
quantize blocks, and the quantize stage's storage-form boundary in a
fused group.

Tolerance: none.  Every value here is a bit operation or an integer
rounding, so each comparison is bitwise, .5 ties (half to even, the JAX
code's `jnp.round`), out-of-range saturation and NaN included.
"""

import numpy as np
import pytest
import torch

import bifrost_tpu as jbf
from bifrost_tpu import blocks as jblocks
from bifrost_tpu import config as jconfig
from bifrost_tpu.blocks.testing import array_source as j_array_source
from bifrost_tpu.blocks.testing import callback_sink as j_callback_sink
from bifrost_tpu.ops import quantize as j_quantize
from bifrost_tpu.ops import unpack as j_unpack
from bifrost_tpu.pipeline import Pipeline as JPipeline

import bifrost_tpu_torch as pbf
from bifrost_tpu_torch import blocks as pblocks
from bifrost_tpu_torch import config as pconfig
from bifrost_tpu_torch.ops import quantize as p_quantize
from bifrost_tpu_torch.ops import unpack as p_unpack
from bifrost_tpu_torch.ops.quantize import Quantize, quantize_to
from bifrost_tpu_torch.ops.runtime import (staged_unpack,
                                           storage_nbyte_per_sample)
from bifrost_tpu_torch.ops.unpack import Unpack, unpack_logical
from bifrost_tpu_torch.pipeline import Pipeline as PPipeline


def _jq(x, dtype, shape, scale):
    """The JAX quantize into a fresh host array of `dtype` -> its
    storage bytes as numpy."""
    q = jbf.empty(shape, dtype=dtype)
    j_quantize(x, q, scale=scale)
    return np.asarray(q)


def _storage_bytes(t):
    return t.contiguous().numpy().view(np.uint8)


# ------------------------------------------------------------- quantize
@pytest.mark.parametrize("dtype,scale", [
    ("i8", 2.0), ("i8", 1.0), ("u8", 1.0), ("i4", 1.0), ("u2", 1.0),
    ("i2", 0.5), ("ci8", 1.0), ("ci4", 1.0), ("ci4", 3.0)])
def test_quantize_bitwise_vs_jax(dtype, scale):
    """Half-way values, out-of-range values and NaN against the JAX
    quantizer: the same storage bytes."""
    rng = np.random.default_rng(3)
    ties = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, -3.5],
                    np.float32)
    wild = np.array([300.7, -300.2, 200.0, -200.0, 1e9, -1e9, 0.0, np.nan],
                    np.float32)
    base = np.concatenate([ties, wild,
                           (rng.standard_normal(16) * 9).astype(np.float32)])
    if dtype.startswith("c"):
        x = (base + 1j * base[::-1]).astype(np.complex64)
    else:
        x = base
    want = _jq(x, dtype, x.shape, scale)
    got = quantize_to(torch.from_numpy(x), dtype, scale)
    assert np.array_equal(_storage_bytes(got), want.view(np.uint8)
                          .reshape(_storage_bytes(got).shape))
    # .5 rounds half to even, as jnp.round does
    if dtype == "i8" and scale == 1.0:
        assert got[:8].tolist() == [-2, -2, 0, 0, 2, 2, 4, -4]
        assert got[8:16].tolist() == [127, -128, 127, -128, 127, -128, 0, 0]


def test_quantize_into_numpy_and_tensor_dst():
    x = np.arange(-8, 8, dtype=np.float32)
    q = jbf.empty((16,), dtype="i4")
    j_quantize(x, q, scale=1.0)
    host = np.zeros(8, np.uint8)
    p_quantize(x, host, dtype="i4")
    assert np.array_equal(host, np.asarray(q).view(np.uint8))
    t = torch.zeros(8, dtype=torch.uint8)
    p_quantize(x, t, dtype="i4")
    assert np.array_equal(t.numpy(), host)
    with pytest.raises(ValueError, match="integer"):
        p_quantize(x, t, dtype="f32")


# --------------------------------------------------------------- unpack
@pytest.mark.parametrize("dtype", ["i4", "u4", "i2", "u2", "i1", "u1"])
@pytest.mark.parametrize("align_msb", [False, True])
def test_unpack_real_bitwise_vs_jax(dtype, align_msb):
    """Every byte value, MSB-first, with the reference's shift-based
    sign extension and align_msb."""
    packed = np.arange(256, dtype=np.uint8).reshape(4, 64)
    from bifrost_tpu.ndarray import ndarray as jnd
    per = 8 // int(dtype[1:])
    a = jnd(base=packed.copy(), dtype=dtype, shape=(4, 64 * per))
    out = jbf.empty((4, 64 * per), dtype=dtype[0] + "8")
    j_unpack(a, out, align_msb=align_msb)
    got = p_unpack(torch.from_numpy(packed), dtype, align_msb=align_msb)
    assert np.array_equal(got.numpy(), np.asarray(out))


@pytest.mark.parametrize("align_msb", [False, True])
def test_unpack_ci4_bitwise_vs_jax(align_msb):
    """ci4 -> ci8 pairs (re the high nibble) and the logical complex
    value, against the JAX unpack of the JAX-quantized bytes."""
    rng = np.random.default_rng(21)
    x = (rng.integers(-8, 8, (6, 16)) +
         1j * rng.integers(-8, 8, (6, 16))).astype(np.complex64)
    packed = _jq(x, "ci4", x.shape, 1.0)
    from bifrost_tpu.ndarray import ndarray as jnd
    u = jbf.empty(x.shape, dtype="ci8")
    j_unpack(jnd(base=packed.copy(), dtype="ci4", shape=x.shape), u,
             align_msb=align_msb)
    want = np.asarray(u)
    got = p_unpack(torch.from_numpy(packed), "ci4", align_msb=align_msb)
    assert np.array_equal(got[..., 0].numpy(), want["re"])
    assert np.array_equal(got[..., 1].numpy(), want["im"])
    from bifrost_tpu.ndarray import to_jax
    from bifrost_tpu.ops.unpack import unpack_logical as j_logical
    jl = np.asarray(j_logical(to_jax(packed), "ci4", align_msb))
    assert np.array_equal(
        unpack_logical(torch.from_numpy(packed), "ci4", align_msb).numpy(),
        jl)
    if not align_msb:
        assert np.array_equal(got[..., 0].numpy(), x.real.astype(np.int8))


def test_unpack_refuses_whole_bytes_and_writes_dst():
    with pytest.raises(ValueError, match="<8-bit"):
        p_unpack(torch.zeros(4, dtype=torch.uint8), "i8")
    dst = torch.empty(8, dtype=torch.int8)
    packed = torch.tensor([0x7F, 0x80, 0x0F, 0xF0], dtype=torch.uint8)
    p_unpack(packed, "i4", dst)
    assert dst.tolist() == [7, -1, -8, 0, 0, -1, -1, 0]


# -------------------------------------------------------- staged unpack
def test_staged_unpack_ci4_and_byte_counts():
    """Mirrors tests/test_ops_runtime.py's staged-unpack cases: the ci4
    planes against the JAX helper's, bitwise; ci8 passes through."""
    from bifrost_tpu.ndarray import to_jax
    from bifrost_tpu.ops.runtime import staged_unpack as j_staged
    rng = np.random.default_rng(8)
    re = rng.integers(-8, 8, (6, 5)).astype(np.int8)
    im = rng.integers(-8, 8, (6, 5)).astype(np.int8)
    packed = (((re & 0xF).astype(np.uint8) << 4) |
              (im & 0xF).astype(np.uint8))
    jre, jim = j_staged(to_jax(packed), "ci4")
    pre, pim = staged_unpack(torch.from_numpy(packed), "ci4")
    assert np.array_equal(pre.numpy(), np.asarray(jre).astype(np.float32))
    assert np.array_equal(pim.numpy(), np.asarray(jim).astype(np.float32))
    raw = torch.arange(24, dtype=torch.int8).reshape(3, 4, 2)
    r8, i8 = staged_unpack(raw, "ci8")
    assert np.array_equal(r8.numpy(), raw[..., 0].float().numpy())
    assert np.array_equal(i8.numpy(), raw[..., 1].float().numpy())
    with pytest.raises(ValueError, match="complex-integer"):
        staged_unpack(torch.zeros(2, 2), "f32")
    from bifrost_tpu.ops.runtime import storage_nbyte_per_sample as j_nb
    for dt in ("ci4", "ci8", "ci16", "ci32"):
        assert storage_nbyte_per_sample(dt) == j_nb(dt)
    with pytest.raises(ValueError):
        storage_nbyte_per_sample("f32")


# --------------------------------------------------------- planned ops
def test_quantize_unpack_planned_ops():
    """Mirrors test_fusion.py::test_quantize_unpack_planned_ops: report
    schema, a stable traceable per plan, cache hits, the round trip."""
    q = Quantize("ci4", scale=2.0)
    assert q.traceable(True) is q.traceable(True)
    x = (np.random.default_rng(4).random((4, 8)) * 4 - 2) \
        .astype(np.complex64)
    r1 = q.execute(x)
    q.execute(x)
    rep = q.plan_report()
    assert rep["op"] == "quantize" and rep["dtype"] == "ci4"
    assert rep["cache"]["hits"] >= 1
    from bifrost_tpu.ops.quantize import Quantize as JQuantize
    assert np.array_equal(r1.numpy(), np.asarray(JQuantize(
        "ci4", scale=2.0).execute(x)))
    u = Unpack("ci4")
    back = u.execute(r1)
    rep = u.plan_report()
    assert rep["op"] == "unpack" and rep["dtype"] == "ci4"
    golden = np.clip(np.round(x.real * 2), -8, 7) + \
        1j * np.clip(np.round(x.imag * 2), -8, 7)
    assert np.array_equal(back.numpy(), golden.astype(np.complex64))
    with pytest.raises(ValueError):
        Unpack("ci8")
    with pytest.raises(ValueError):
        Quantize("f32")


# --------------------------------------------------------------- blocks
def _ci4_stream(shape, seed):
    rng = np.random.default_rng(seed)
    vals = (rng.integers(-7, 8, shape) + 1j * rng.integers(-7, 8, shape)
            ).astype(np.complex64)
    return vals, _jq(vals, "ci4", shape, 1.0)


def test_unpack_block_device_ring():
    """Mirrors test_fusion.py::test_unpack_block_device_ring: a packed
    ci4 'cuda' ring expands on the device to ci8, bitwise the values the
    JAX block hands on."""
    vals, packed = _ci4_stream((8, 4), 5)
    jgot = []
    with JPipeline() as pipe:
        src = j_array_source(packed, 4, header={
            "dtype": "ci4", "labels": ["time", "x"]})
        u = jblocks.unpack(jblocks.copy(src, space="tpu"))
        j_callback_sink(u, on_data=lambda a: jgot.append(np.asarray(a)))
        pipe.run()
    pgot = []
    with PPipeline(device="cpu") as pipe:
        src = pblocks.array_source(packed, 4, header={
            "dtype": "ci4", "labels": ["time", "x"]})
        u = pblocks.unpack(pblocks.copy(src, space="cuda"))
        pblocks.gather_sink(u, pgot)
        pipe.run()
    out = np.concatenate(pgot, axis=0)
    assert out.shape == (8, 4, 2) and out.dtype == np.int8
    jout = np.concatenate(jgot, axis=0)
    assert np.array_equal(jout, vals)
    assert np.array_equal(out[..., 0] + 1j * out[..., 1], jout)


def test_unpack_block_host_ring_i4_to_i8():
    """The capture form: i4 bytes on a host ring -> i8 values, every
    gulp through the block's plan (its report counts them)."""
    x = np.arange(-8, 8, dtype=np.float32).reshape(2, 8)
    packed = _jq(x, "i4", x.shape, 1.0)
    got = []
    with PPipeline(device="cpu") as pipe:
        src = pblocks.array_source(packed, 1, header={
            "dtype": "i4", "labels": ["time", "freq"]})
        u = pblocks.unpack(src, dtype="i8")
        pblocks.gather_sink(u, got)
        pipe.run()
    assert np.array_equal(np.concatenate(got), x.astype(np.int8))
    rep = u.plan_report()
    assert rep["dtype"] == "i4" and rep["method"] == "torch"
    assert (rep["cache"]["misses"], rep["cache"]["hits"]) == (1, 1)
    assert u.device_kernel() is u.plan.storage()


def _quantize_chain(fuse_on, x, dtype, pkg):
    """src -> H2D -> quantize(dtype, 3.0) -> fftshift(b) under a fuse
    scope (JAX: 'tpu' rings), gathered on the host."""
    if pkg == "jax":
        jconfig.set("pipeline_fuse", fuse_on)
        got = []
        try:
            with JPipeline() as pipe:
                src = j_array_source(x, 4, header={
                    "labels": ["time", "a", "b"]})
                with jbf.block_scope(fuse=True):
                    dev = jblocks.copy(src, space="tpu")
                    q = jblocks.quantize(dev, dtype, scale=3.0)
                    s = jblocks.fftshift(q, axes="b")
                j_callback_sink(s, on_data=lambda a:
                                got.append(np.asarray(a)))
                pipe.run()
                rep = pipe.fusion_report()
            return np.concatenate(got, axis=0), rep
        finally:
            jconfig.reset("pipeline_fuse")
    pconfig.set("pipeline_fuse", fuse_on)
    got = []
    try:
        with PPipeline(device="cpu") as pipe:
            src = pblocks.array_source(x, 4, header={
                "labels": ["time", "a", "b"]})
            with pbf.block_scope(fuse=True):
                dev = pblocks.copy(src, space="cuda")
                q = pblocks.quantize(dev, dtype, scale=3.0)
                s = pblocks.fftshift(q, axes="b")
            pblocks.gather_sink(s, got)
            pipe.run()
            rep = pipe.fusion_report()
        return np.concatenate(got, axis=0), rep
    finally:
        pconfig.reset("pipeline_fuse")


@pytest.mark.parametrize("dtype", ["ci8", "ci4"])
def test_quantize_fused_storage_boundary(dtype):
    """Mirrors test_fusion.py::test_quantize_fused_storage_boundary:
    quantize -> fftshift fuses into one group of 3, fused == unfused
    bitwise, and the values equal the JAX chain's."""
    x = (np.random.default_rng(6).random((8, 4, 8)) * 6 - 3) \
        .astype(np.complex64)
    fused, rep = _quantize_chain(True, x, dtype, "port")
    unfused, _ = _quantize_chain(False, x, dtype, "port")
    assert rep["groups"] and len(rep["groups"][0]["constituents"]) == 3
    assert np.array_equal(fused, unfused)
    jfused, jrep = _quantize_chain(True, x, dtype, "jax")
    if dtype == "ci8":
        assert len(jrep["groups"][0]["constituents"]) == 3
        assert np.array_equal(fused[..., 0] + 1j * fused[..., 1], jfused)
    else:
        assert np.array_equal(fused, jfused.view(np.uint8)
                              .reshape(fused.shape))


def test_subbyte_real_quantize_ends_the_group():
    """A quantize to i4 folds two values a byte: it may end a group but
    not extend one (dtype_incompatible), as in the JAX planner."""
    x = np.random.default_rng(7).standard_normal((8, 4, 8)) \
        .astype(np.float32)
    with PPipeline(device="cpu") as pipe:
        src = pblocks.array_source(x, 4, header={
            "labels": ["time", "a", "b"]})
        with pbf.block_scope(fuse=True):
            dev = pblocks.copy(src, space="cuda")
            q = pblocks.quantize(dev, "i4", scale=2.0)
            s = pblocks.fftshift(q, axes="a")
        pblocks.gather_sink(s, [])
        rep = pipe.fusion_report()
    g = rep["groups"][0]["constituents"]
    assert g[-1] == q.name and s.name not in g
    assert rep["refused"][s.name] == "singleton"
    from bifrost_tpu_torch.fuse import _boundary_extends
    assert not _boundary_extends(q)


def test_subbyte_quantize_feeds_unpack_in_a_group():
    """A sub-byte complex quantize feeding an unpack: the packed storage
    passes between the stages as the ring would hand it, one group of
    three, fused == unfused bitwise, and the round trip gives the
    quantized values."""
    x = (np.random.default_rng(9).random((8, 6)) * 10 - 5 +
         1j * (np.random.default_rng(10).random((8, 6)) * 10 - 5)) \
        .astype(np.complex64)

    def run(fuse_on):
        pconfig.set("pipeline_fuse", fuse_on)
        got = []
        try:
            with PPipeline(device="cpu") as pipe:
                src = pblocks.array_source(x, 4, header={
                    "labels": ["time", "chan"]})
                with pbf.block_scope(fuse=True):
                    dev = pblocks.copy(src, space="cuda")
                    q = pblocks.quantize(dev, "ci4", scale=1.5)
                    u = pblocks.unpack(q)
                pblocks.gather_sink(u, got)
                pipe.run()
                rep = pipe.fusion_report()
            return np.concatenate(got), rep
        finally:
            pconfig.reset("pipeline_fuse")

    fused, rep = run(True)
    unfused, _ = run(False)
    assert [len(g["constituents"]) for g in rep["groups"]] == [3]
    assert np.array_equal(fused, unfused)
    want = quantize_to(torch.from_numpy(x), "ci8", 1.5).numpy()
    assert np.array_equal(fused, np.clip(want, -8, 7))
