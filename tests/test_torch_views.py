"""The port's header views (bifrost_tpu_torch/views) against the JAX
package's (bifrost_tpu/views/basic_views.py:14-128) on the CPU: each of
the eight views gives the header the JAX view gives on the same header,
and the view cases of tests/test_blocks.py (split_axis at :650 and
:744, delete_axis at :725) run through real pipelines of both packages.
`astype` puns a 'cuda' ring's bytes: a reader sees the span's bytes under
the new type, bitwise what the JAX view reads from the same bytes.
Headers compare equal; data bitwise.
"""

import copy
import json

import numpy as np
import pytest

from bifrost_tpu import blocks as jblocks
from bifrost_tpu import views as jviews
from bifrost_tpu.blocks.testing import array_source as j_array_source
from bifrost_tpu.blocks.testing import gather_sink as j_gather_sink
from bifrost_tpu.pipeline import Pipeline as JPipeline

from bifrost_tpu_torch import blocks, views
from bifrost_tpu_torch.blocks.testing import array_source, gather_sink
from bifrost_tpu_torch.ndarray import pair_to_structured
from bifrost_tpu_torch.pipeline import Pipeline

HDR = {"name": "v", "gulp_nframe": 8, "_tensor": {
    "dtype": "cf32", "shape": [-1, 8, 1, 4],
    "labels": ["time", "freq", "one", "pol"],
    "scales": [[0.0, 1e-3], [100.0, 2.0], None, None],
    "units": ["s", "MHz", None, None]}}


class _Block(object):
    """A stand-in for a block: views wrap its output rings."""

    def __init__(self, ring):
        self.orings = [ring]


class _Ring(object):
    name = "ring"
    space = "system"


def _transform(view_fn, pkg, *args, **kwargs):
    """The header transform a view installs on a block's output ring."""
    proxy = view_fn(_Block(_Ring()), *args, **kwargs)
    return proxy.orings[0].header_transform


@pytest.mark.parametrize("name,args,kwargs", [
    ("custom", (lambda h: dict(h, extra=1),), {}),
    ("rename_axis", ("freq", "chan"), {}),
    ("reinterpret_axis", ("freq",), dict(label="f", scale=[1.0, 0.5],
                                         units="GHz")),
    ("reinterpret_axis", (3,), dict(label="p")),
    ("reverse_scale", ("freq",), {}),
    ("add_axis", ("freq",), dict(label="new")),
    ("add_axis", (-1,), dict(label="last", scale=[0, 1], units="m")),
    ("delete_axis", ("one",), {}),
    ("delete_axis", (-2,), {}),
    ("astype", ("f32",), {}),
    ("astype", ("cf64",), {}),
    ("split_axis", ("freq", 4), dict(label="fine")),
    ("split_axis", ("time", 4), {}),
    ("split_axis", (0, 3), {}),
    ("merge_axes", ("freq", "one"), dict(label="fo")),
])
def test_view_headers_equal_the_jax_views(name, args, kwargs):
    """Each view's header on the same input header, against the JAX
    view's (split_axis on the frame axis rescales gulp_nframe)."""
    port = _transform(getattr(views, name), views, *args, **kwargs)
    jax = _transform(getattr(jviews, name), jviews, *args, **kwargs)
    got = port(copy.deepcopy(HDR))
    want = jax(copy.deepcopy(HDR))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    if name == "split_axis" and args[0] in ("time", 0):
        assert got["gulp_nframe"] == (8 - 1) // args[1] + 1


@pytest.mark.parametrize("name,args", [
    ("delete_axis", ("freq",)),            # not of length 1
    ("astype", ("cf64",)),                 # 2 x 8 B does not divide by 16
    ("split_axis", ("pol", 3)),            # 4 % 3
    ("merge_axes", ("time", "pol")),       # not adjacent
])
def test_view_errors_equal_the_jax_views(name, args):
    hdr = copy.deepcopy(HDR)
    hdr["_tensor"]["shape"][-1] = 2 if name == "astype" else 4
    hdr["_tensor"]["dtype"] = "f32" if name == "astype" else "cf32"
    for pkg in (views, jviews):
        with pytest.raises(ValueError):
            _transform(getattr(pkg, name), pkg, *args)(copy.deepcopy(hdr))


def _port_run(data, hdr, build, gulp=8, device_ring=False):
    chunks, headers = [], []
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, gulp, header=dict(hdr))
        head = blocks.copy(src, space="cuda") if device_ring else src
        out = build(head)
        if device_ring:
            out = blocks.copy(out, space="system")
        gather_sink(out, chunks, headers)
        pipe.run()
    return np.concatenate(chunks, axis=0), headers


def _jax_run(data, hdr, build, gulp=8, device_ring=False):
    chunks, headers = [], []
    with JPipeline() as pipe:
        src = j_array_source(data, gulp, header=dict(hdr))
        head = jblocks.copy(src, space="tpu") if device_ring else src
        out = build(head)
        if device_ring:
            out = jblocks.copy(out, space="system")
        j_gather_sink(out, chunks, headers)
        pipe.run()
    return np.concatenate(chunks, axis=0), headers


def _tensor_hdr(headers):
    return json.dumps(headers[0]["_tensor"], sort_keys=True)


def test_views_split_merge():
    """Mirrors test_blocks.py:643 (split_axis), through a pipeline."""
    data = np.random.default_rng(0).random((32, 8)).astype(np.float32)
    hdr = {"labels": ["time", "freq"], "scales": [[0, 1.0], [100.0, 2.0]],
           "units": ["s", "MHz"]}
    out, headers = _port_run(data, hdr, lambda src: views.split_axis(
        src, "freq", 4, label="fine"))
    jout, jheaders = _jax_run(data, hdr, lambda src: jviews.split_axis(
        src, "freq", 4, label="fine"))
    t = headers[0]["_tensor"]
    assert t["shape"] == [-1, 2, 4]
    assert t["labels"] == ["time", "freq", "fine"]
    assert t["scales"][1][1] == 8.0
    assert _tensor_hdr(headers) == _tensor_hdr(jheaders)
    assert np.array_equal(out, data.reshape(32, 2, 4))
    assert np.array_equal(out, jout)


def test_views_delete_axis_negative():
    """Mirrors test_blocks.py:725."""
    data = np.random.default_rng(1).random((16, 4, 1)).astype(np.float32)
    hdr = {"labels": ["time", "freq", "dummy"]}
    out, headers = _port_run(data, hdr,
                             lambda src: views.delete_axis(src, -1))
    jout, jheaders = _jax_run(data, hdr,
                              lambda src: jviews.delete_axis(src, -1))
    assert headers[0]["_tensor"]["shape"] == [-1, 4]
    assert _tensor_hdr(headers) == _tensor_hdr(jheaders)
    assert np.array_equal(out, jout) and out.shape == (16, 4)


def test_device_ring_view_reshape():
    """Mirrors test_blocks.py:733: a view over a device ring reshapes the
    gulp (split_axis before a device transpose)."""
    rng = np.random.default_rng(12)
    data = (rng.random((32, 8)) + 1j * rng.random((32, 8))) \
        .astype(np.complex64)
    hdr = {"labels": ["time", "x"]}

    def build(pkg_views, pkg_blocks):
        def b(dev):
            v = pkg_views.split_axis(dev, "x", 4, label="fine")
            return pkg_blocks.transpose(v, ["time", "fine", "x"])
        return b
    out, _ = _port_run(data, hdr, build(views, blocks), device_ring=True)
    jout, _ = _jax_run(data, hdr, build(jviews, jblocks), device_ring=True)
    golden = data.reshape(32, 2, 4).transpose(0, 2, 1)
    assert np.array_equal(out, golden) and np.array_equal(out, jout)


def test_split_axis_on_the_frame_axis_rescales_the_gulp():
    """Splitting the frame axis: gulps of 8 frames become gulps of 2 of
    (4,) frames, the same data."""
    data = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    hdr = {"labels": ["time", "chan"], "gulp_nframe": 8}
    out, headers = _port_run(data, hdr, lambda src: views.split_axis(
        src, "time", 4), gulp=8)
    jout, jheaders = _jax_run(data, hdr, lambda src: jviews.split_axis(
        src, "time", 4), gulp=8)
    assert headers[0]["gulp_nframe"] == jheaders[0]["gulp_nframe"] == 2
    assert _tensor_hdr(headers) == _tensor_hdr(jheaders)
    assert out.shape == jout.shape and np.array_equal(out, jout)


@pytest.mark.parametrize("src_dtype,new_dtype", [
    ("ci8", "i16"), ("i16", "ci8"), ("cf32", "f32"), ("f32", "cf32"),
])
def test_astype_puns_cuda_ring_bytes(src_dtype, new_dtype):
    """astype on a 'cuda' ring reads the span's bytes under the new type:
    ci8 <-> i16 (one i16 per ci8 sample, re in the low byte) and
    cf32 <-> f32, bitwise the JAX view on the same bytes and numpy's
    view of them.  The JAX view runs on a host ring: over a device ring
    it raises (its device spans are typed arrays; ROADMAP Queue C)."""
    rng = np.random.default_rng(3)
    ntime, nchan = 16, 6
    if src_dtype == "ci8":
        data = rng.integers(-128, 128, (ntime, nchan, 2)).astype(np.int8)
        jdata = pair_to_structured(data, "ci8")
    elif src_dtype == "i16":
        data = rng.integers(-2 ** 15, 2 ** 15, (ntime, nchan)) \
            .astype(np.int16)
        jdata = data
    elif src_dtype == "cf32":
        data = (rng.standard_normal((ntime, nchan)) +
                1j * rng.standard_normal((ntime, nchan))) \
            .astype(np.complex64)
        jdata = data
    else:
        data = rng.standard_normal((ntime, nchan)).astype(np.float32)
        jdata = data
    hdr = {"dtype": src_dtype, "labels": ["time", "chan"]}
    out, headers = _port_run(data, hdr, lambda dev: views.astype(
        dev, new_dtype), device_ring=True)
    jout, jheaders = _jax_run(jdata, hdr, lambda dev: jviews.astype(
        dev, new_dtype))
    assert _tensor_hdr(headers) == _tensor_hdr(jheaders)
    with pytest.raises(Exception, match="view-compatible"):
        _jax_run(jdata, hdr, lambda dev: jviews.astype(dev, new_dtype),
                 device_ring=True)
    host = np.ascontiguousarray(jdata).view(np.uint8).reshape(ntime, -1)
    if new_dtype == "ci8":
        # the port hands ci8 in storage form, JAX the structured form:
        # the same bytes
        assert out.dtype == np.int8 and out.shape[-1] == 2
        assert np.array_equal(out.reshape(ntime, -1).view(np.uint8), host)
        assert np.array_equal(np.ascontiguousarray(jout).view(np.uint8)
                              .reshape(ntime, -1), host)
    else:
        assert np.array_equal(out.reshape(ntime, -1).view(np.uint8), host)
        assert out.dtype == np.asarray(jout).dtype
        assert np.array_equal(out.view(np.uint8),
                              np.asarray(jout).view(np.uint8))


def test_astype_puns_packed_ci4_bytes_as_jax_does():
    """Packed ci4 (one sample a byte, the real part in the high nibble)
    punned to u8 on a 'cuda' ring: the port hands the packed bytes as
    they lie, the same bytes the JAX view reads (on a host ring)."""
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (16, 8)).astype(np.uint8)
    hdr = {"dtype": "ci4", "labels": ["time", "chan"]}
    out, _ = _port_run(data, hdr, lambda dev: views.astype(dev, "u8"),
                       device_ring=True)
    jout, _ = _jax_run(data, hdr, lambda dev: jviews.astype(dev, "u8"))
    assert out.dtype == np.uint8 and np.array_equal(out, data)
    assert np.array_equal(out, np.asarray(jout))
