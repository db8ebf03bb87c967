"""The imaging branch's blocks of the port against the JAX package, on the
CPU, on the same seeded numpy input: the X-engine (`CorrelateBlock`,
engine 'f32'), the FFT block (c2c, r2c, c2r) and the `merge_axes` view,
data and headers.

Tolerances:
- X-engine: each visibility is a sum over the integration's n_int frames
  of products conj(x_i) x_j, formed and summed in another order by XLA
  (einsum at Precision.HIGHEST) and by torch.matmul.  With M[c, i, j] =
  sum_t |x_i| |x_j| (f64; x the gain-scaled voltages), each side is
  within (n_int + 4) * 2**-24 * M of the exact value (two roundings per
  product, two for the gain), so |port - jax| <= 2 (n_int + 4) 2**-24 M.
- FFT: an N-point transform in f32 is within 2 log2(N) 2**-24 * sum|x|
  of the exact one at every output (sum over the transformed axes), on
  either side; the inverse and c2r are scaled by N on both sides.
- Headers and views: equal.
"""

import math

import numpy as np
import pytest

from bifrost_tpu_torch import views
from bifrost_tpu_torch.blocks import (array_source, copy, correlate, fft,
                                      gather_sink)
from bifrost_tpu_torch.pipeline import Pipeline, PipelineInitError

EPS = 2.0 ** -24


def _jax_run(x, header, build):
    from bifrost_tpu import blocks
    from bifrost_tpu.blocks.testing import array_source as jsrc
    from bifrost_tpu.blocks.testing import gather_sink as jgather
    from bifrost_tpu.pipeline import Pipeline as JPipeline
    chunks, headers = [], []
    with JPipeline() as pipe:
        src = jsrc(x, header.pop("_gulp"), header=header)
        dev = blocks.copy(src, space="tpu")
        out = build(blocks, dev)
        host = blocks.copy(out, space="system")
        jgather(host, chunks, headers)
        pipe.run()
    return chunks, headers


def _port_run(x, header, build):
    chunks, headers = [], []
    with Pipeline(device="cpu") as pipe:
        src = array_source(x, header.pop("_gulp"), header=header)
        dev = copy(src, space="cuda")
        gather_sink(build(dev), chunks, headers)
        pipe.run()
    return chunks, headers


def _both(x, header, jbuild, pbuild):
    j = _jax_run(x, dict(header), jbuild)
    p = _port_run(x, dict(header), pbuild)
    return j, p


def _fx_input(ntime, nchan=4, nstand=3, npol=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((ntime, nchan, nstand, npol)) +
            1j * rng.standard_normal((ntime, nchan, nstand, npol))
            ).astype(np.complex64)


def _vis_bound(x, n_int, gains=None):
    """(n_int + 4) 2**-24 M per integration (module docstring)."""
    a = np.abs(x.astype(np.complex128))
    if gains is not None:
        a = a * np.abs(gains)
    a = a.reshape(-1, n_int, x.shape[1], x.shape[2] * x.shape[3])
    m = np.einsum("ktci,ktcj->kcij", a, a)
    return (n_int + 4) * EPS * m.reshape((-1,) + x.shape[1:] +
                                         x.shape[2:])


HDR = {"labels": ["time", "freq", "station", "pol"],
       "scales": [[0.0, 1e-6], [40.0, 0.1], None, None],
       "units": ["s", "MHz", None, None]}


@pytest.mark.parametrize("gulp,n_int", [(8, 16), (6, 16), (16, 16),
                                        (5, 12)])
def test_correlate_matches_jax(gulp, n_int):
    """Integration boundaries on gulp edges, mid-gulp (6 into 16), one
    integration per gulp (the span written in place), and several
    integrations per gulp."""
    x = _fx_input(48)
    hdr = dict(HDR, _gulp=gulp)
    (jc, jh), (pc, ph) = _both(
        x, hdr,
        lambda b, d: b.correlate(d, n_int, gulp_nframe=gulp),
        lambda d: correlate(d, n_int, gulp_nframe=gulp))
    want, got = np.concatenate(jc), np.concatenate(pc)
    assert got.shape == want.shape == (48 // n_int, 4, 3, 2, 3, 2)
    assert got.dtype == np.complex64
    assert (np.abs(got - want) <= 2 * _vis_bound(x, n_int)).all()
    assert ph[0]["_tensor"] == jh[0]["_tensor"]
    for key in ("matrix_fill_mode", "gulp_nframe"):
        assert ph[0][key] == jh[0][key]
    t = ph[0]["_tensor"]
    assert t["labels"] == ["time", "freq", "station_i", "pol_i",
                           "station_j", "pol_j"]
    assert t["scales"][0] == [0.0, 1e-6 * n_int]


def test_correlate_axis_order_and_gains():
    """Roles found by label (tests/test_parallel_pipeline.py:160), and
    per-station gains folded into the voltages (v_ij' = conj(g_i) g_j
    v_ij), against the JAX block and the einsum golden."""
    x = _fx_input(32, nchan=4, nstand=4)
    xt = np.ascontiguousarray(x.transpose(0, 3, 2, 1))
    hdr = {"labels": ["time", "pol", "stand", "chan"], "_gulp": 8}
    rng = np.random.default_rng(3)
    g = (rng.standard_normal(4) + 1j * rng.standard_normal(4)) \
        .astype(np.complex64)
    (jc, jh), (pc, ph) = _both(
        xt, hdr,
        lambda b, d: b.correlate(d, 16, gulp_nframe=8, gains=g),
        lambda d: correlate(d, 16, gulp_nframe=8, gains=g))
    want, got = np.concatenate(jc), np.concatenate(pc)
    gg = np.repeat(g, 2).reshape(4, 2)
    bound = 2 * _vis_bound(x, 16, gg)
    assert (np.abs(got - want) <= bound).all()
    xs = (x.astype(np.complex128) * gg).reshape(2, 16, 4, 8)
    golden = np.einsum("ktci,ktcj->kcij", np.conj(xs), xs) \
        .reshape(got.shape)
    assert (np.abs(got - golden) <= bound).all()
    assert ph[0]["_tensor"] == jh[0]["_tensor"]
    assert ph[0]["_tensor"]["labels"][2:] == ["stand_i", "pol_i",
                                             "stand_j", "pol_j"]


def test_correlate_drops_partial_tail_and_refuses_int8():
    """The trailing partial integration is dropped, with a warning; the
    int8 engine (no longer refused) matches the JAX engine bitwise on
    the same frames, its products exact integers
    (test_torch_xengine.py holds the rest of it)."""
    x = _fx_input(40)
    with pytest.warns(UserWarning, match="partial integration"):
        chunks, _ = _port_run(x, dict(HDR, _gulp=8),
                              lambda d: correlate(d, 16, gulp_nframe=8))
    assert np.concatenate(chunks).shape[0] == 2
    x8 = (x * 40).astype(np.complex64)
    with pytest.warns(UserWarning, match="partial integration"):
        (jc, jh), (pc, ph) = _both(
            x8, dict(HDR, _gulp=8),
            lambda b, d: b.correlate(d, 16, engine="int8"),
            lambda d: correlate(d, 16, engine="int8"))
    assert np.array_equal(np.concatenate(pc), np.concatenate(jc))
    assert ph[0]["_tensor"] == jh[0]["_tensor"]


def _fft_bound(x, axes):
    s = np.abs(x.astype(np.complex128)).sum(axis=tuple(axes),
                                             keepdims=True)
    n = int(np.prod([x.shape[a] for a in axes]))
    return 2 * max(math.log2(n), 1) * EPS * s


@pytest.mark.parametrize("kind,inverse,shift", [
    ("c2c", False, False), ("c2c", False, True), ("c2c", True, True),
    ("r2c", False, True), ("c2r", False, False), ("c2r", False, True)])
def test_fft_block_matches_jax(kind, inverse, shift):
    rng = np.random.default_rng(5)
    shape = (6, 8, 16)
    if kind == "r2c":
        x = rng.standard_normal(shape).astype(np.float32)
    else:
        x = (rng.standard_normal(shape) +
             1j * rng.standard_normal(shape)).astype(np.complex64)
    hdr = {"labels": ["time", "y", "x"],
           "scales": [[0, 1e-3], [0, 0.5], [2.0, 0.25]],
           "units": ["s", "m", "s"], "_gulp": 3}
    kwargs = dict(axes=["y", "x"], inverse=inverse,
                  real_output=(kind == "c2r"), axis_labels=["ky", "kx"],
                  apply_fftshift=shift)
    (jc, jh), (pc, ph) = _both(x, hdr,
                               lambda b, d: b.fft(d, **kwargs),
                               lambda d: fft(d, **kwargs))
    want, got = np.concatenate(jc), np.concatenate(pc)
    assert got.shape == want.shape and got.dtype == want.dtype
    bound = _fft_bound(x, (1, 2))
    if kind == "c2r" or inverse:
        bound = bound * np.prod(got.shape[1:]) / 1.0
    assert (np.abs(got - want) <= 2 * bound).all()
    assert ph[0]["_tensor"] == jh[0]["_tensor"]
    assert ph[0]["_tensor"]["labels"] == ["time", "ky", "kx"]


def test_fft_methods():
    from bifrost_tpu_torch.ops.fft import Fft, resolve_method
    assert resolve_method(None) == resolve_method("auto") == "torch"
    for m in ("xla", "matmul", "matmul_f32"):
        with pytest.raises(ValueError, match="TPU"):
            Fft(method=m)
    with pytest.raises(ValueError, match="unknown method"):
        Fft(method="bogus")


def _merged(src_block, merges):
    v = src_block
    for a1, a2, label in merges:
        v = views.merge_axes(v, a1, a2, label=label)
    return v


def test_merge_axes_matches_jax_on_the_imaging_header():
    """The instrument's three merges over the correlator's transposed
    header, and merges into the frame axis and of scaled axes, give the
    JAX view's headers; the data is untouched."""
    from bifrost_tpu import views as jviews
    x = np.arange(2 * 3 * 2 * 3 * 2 * 5, dtype=np.float32) \
        .reshape(2, 3, 2, 3, 2, 5).transpose(5, 0, 1, 2, 3, 4).copy()
    merges = [("station_i", "pol_i", "inp_i"),
              ("inp_i", "station_j", "inp_ij"),
              ("inp_ij", "pol_j", "vis")]
    hdr = {"labels": ["time", "freq", "station_i", "pol_i", "station_j",
                      "pol_j"],
           "scales": [[0.0, 1.6e-5], [4e7, 1e6], None, None, None, None],
           "units": ["s", "Hz", None, None, None, None], "_gulp": 2}

    def jbuild(b, d):
        return _merged_j(jviews, d, merges)

    (jc, jh), (pc, ph) = _both(x, hdr, jbuild,
                               lambda d: _merged(d, merges))
    assert ph[0]["_tensor"] == jh[0]["_tensor"]
    assert ph[0]["_tensor"]["shape"] == [-1, 2, 36]
    np.testing.assert_array_equal(np.concatenate(pc), np.concatenate(jc))
    np.testing.assert_array_equal(np.concatenate(pc).reshape(x.shape), x)
    # scaled axes: steps that line up merge; a frame-axis merge rescales
    # the gulp
    hdr2 = {"labels": ["time", "t2", "a", "b"],
            "scales": [[0.0, 4.0], [0.0, 1.0], [0.0, 4.0], [1.0, 1.0]],
            "units": ["s", "s", "m", "m"], "_gulp": 2}
    x2 = np.zeros((4, 4, 3, 4), np.float32)
    for merges2 in ([("a", "b", "ab")], [("time", "t2", "tt")]):
        (jc, jh), (pc, ph) = _both(
            x2, dict(hdr2), lambda b, d: _merged_j(jviews, d, merges2),
            lambda d: _merged(d, merges2))
        assert ph[0]["_tensor"] == jh[0]["_tensor"]
        assert ph[0]["gulp_nframe"] == jh[0]["gulp_nframe"]
    bad = dict(hdr2, scales=[[0.0, 4.0], [0.0, 1.0], [0.0, 3.0],
                             [1.0, 1.0]])
    with pytest.raises(PipelineInitError, match="line up"):
        _port_run(x2, dict(bad), lambda d: _merged(d, [("a", "b", "ab")]))


def _merged_j(jviews, d, merges):
    v = d
    for a1, a2, label in merges:
        v = jviews.merge_axes(v, a1, a2, label=label)
    return v
