"""The port's DataType and small host surfaces against the JAX package's:
the cases of tests/test_dtype.py (DataType algebra, GUPPI headers, the
torch round trip, the header standard, the kernel disk cache), each run
through both packages."""

import io as _io

import numpy as np
import pytest

from bifrost_tpu import DataType as JDataType

from bifrost_tpu_torch import DataType


def test_parse():
    for name in ("ci8", "f32", "cf64x2", "i4", "u2", "bf16"):
        t, j = DataType(name), JDataType(name)
        assert (t.kind, t.nbit, t.veclen) == (j.kind, j.nbit, j.veclen)
    t = DataType("ci8")
    assert t.kind == "ci" and t.nbit == 8 and t.veclen == 1
    assert t.is_complex and t.is_integer and not t.is_floating_point
    t = DataType("f32")
    assert t.kind == "f" and t.nbit == 32
    t = DataType("cf64x2")
    assert t.veclen == 2 and t.nbit == 64


def test_numpy_roundtrip():
    assert DataType(np.float32) == DataType("f32")
    assert DataType(np.complex64) == DataType("cf32")
    assert DataType("i16").as_numpy_dtype() == np.dtype(np.int16)
    assert DataType("cf32").as_numpy_dtype() == np.dtype(np.complex64)
    ci8 = DataType("ci8").as_numpy_dtype()
    assert ci8.names == ("re", "im") and ci8.itemsize == 2
    for name in ("ci8", "ci16", "cf32", "f64", "u8", "i4", "ci4"):
        assert DataType(name).as_numpy_dtype() == \
            JDataType(name).as_numpy_dtype(), name


def test_promotions():
    assert DataType("ci8").as_real() == DataType("i8")
    assert DataType("i8").as_complex() == DataType("ci8")
    assert DataType("ci8").as_floating_point() == DataType("cf32")
    assert DataType("i32").as_floating_point() == DataType("f64")
    assert DataType("f32").as_floating_point() == DataType("f32")
    for name in ("ci8", "i8", "i32", "f32", "cf32"):
        assert str(DataType(name).as_floating_point()) == \
            str(JDataType(name).as_floating_point())


def test_packed():
    t = DataType("ci4")
    assert t.itemsize_bits == 8
    t = DataType("i2")
    assert t.itemsize_bits == 2
    with pytest.raises(ValueError):
        t.itemsize
    with pytest.raises(ValueError):
        JDataType("i2").itemsize


def test_bf16():
    t = DataType("bf16")
    assert t.is_floating_point and t.nbit == 16
    import ml_dtypes
    assert t.as_numpy_dtype() == np.dtype(ml_dtypes.bfloat16)
    import torch
    assert t.as_torch_dtype() == torch.bfloat16


def test_sizes():
    for name in ("cf32", "ci8", "f64", "ci16", "u16"):
        assert DataType(name).itemsize == JDataType(name).itemsize, name
    assert DataType("cf32").itemsize == 8
    assert DataType("ci8").itemsize == 2
    assert DataType("f64").itemsize == 8


def test_guppi_directio_header():
    """DIRECTIO=0 skips no padding; the bytes equal the JAX writer's."""
    from bifrost_tpu.io import guppi_raw as jguppi
    from bifrost_tpu_torch.io import guppi_raw
    hdr_in = {"DIRECTIO": 0, "NBITS": 8, "OBSNCHAN": 4, "NPOL": 2,
              "BLOCSIZE": 64, "OBSFREQ": 1400.0, "OBSBW": 100.0}
    buf, jbuf = _io.BytesIO(), _io.BytesIO()
    guppi_raw.write_header(buf, hdr_in)
    jguppi.write_header(jbuf, hdr_in)
    assert buf.getvalue() == jbuf.getvalue()
    end = buf.tell()
    buf.seek(0)
    hdr = guppi_raw.read_header(buf)
    assert buf.tell() == end
    assert hdr["NTIME"] == 64 * 8 // (4 * 2 * 2 * 8)


def test_interop_torch_roundtrip():
    from bifrost_tpu_torch import interop, ndarray
    a = np.random.default_rng(0).random((4, 3)).astype(np.float32)
    t = interop.as_torch(a)
    assert t.shape == (4, 3)
    back = interop.from_torch(t)
    np.testing.assert_array_equal(np.asarray(back), a)
    # complex-int structured -> torch carries the trailing (re, im) axis
    raw = np.zeros(6, dtype=[("re", "i1"), ("im", "i1")])
    raw["re"] = np.arange(6)
    bfarr = ndarray(base=raw, dtype="ci8")
    tc = interop.as_torch(bfarr)
    assert tuple(tc.shape) == (6, 2)
    np.testing.assert_array_equal(tc[:, 0].numpy(), np.arange(6))


def test_header_standard():
    from bifrost_tpu.io.header_standard import \
        enforce_header_standard as jenforce
    from bifrost_tpu_torch.io.header_standard import \
        enforce_header_standard
    good = {"name": "x", "time_tag": 0,
            "_tensor": {"dtype": "f32", "shape": [-1, 4],
                        "labels": ["time", "f"], "scales": [[0, 1], [0, 1]],
                        "units": ["s", None]}}
    ok, problems = enforce_header_standard(good, strict=True)
    assert ok, problems
    bad = {"_tensor": {"dtype": "f32", "shape": [4, 4]}}
    ok, problems = enforce_header_standard(bad)
    assert not ok
    assert ok == jenforce(bad)[0]


def test_kernel_disk_cache_toggle(tmp_path):
    from bifrost_tpu_torch import cache
    cache.enable_kernel_disk_cache(str(tmp_path / "kc"))
    try:
        info = cache.kernel_cache_info()
        assert info["enabled"]
    finally:
        cache.disable_kernel_disk_cache()
    assert not cache.kernel_cache_info()["enabled"]
