"""Gain calibration of the port (bifrost_tpu_torch.ops.calibrate,
blocks.calibrate, kernel K5b's plain version, and the gain folds of the
beamform and correlate blocks) against the JAX package on the CPU, on
the same seeded numpy input.

Tolerances:
- K5b's plain version rounds re*gr, im*gi and their difference on their
  own, so it is bitwise equal to the unfused numpy f32 form.  XLA:CPU
  contracts the JAX kernel's (in 'jnp' and under the Pallas interpreter)
  into fma(re, gr, -(im*gi)): the two differ by at most one rounding of
  the sum, 2.4e-7 * (|re*gr| + |im*gi|) (and likewise for the imaginary
  part).
- The numpy helpers (fold_gains, gain_outer, decode/encode_gains,
  broadcast_gains) are copies: bitwise.
- The B-engine fold: integer voltages, weights and gains keep every sum
  an exact integer, so the port's blocks equal the JAX blocks bitwise.
- The X-engine: the port scales the voltages, the JAX engine the
  visibility planes; both within the correlate tests' bound.
"""

import numpy as np
import pytest
import torch

from bifrost_tpu.blocks.calibrate import broadcast_gains as j_broadcast
from bifrost_tpu.ops import calibrate as jcal
from bifrost_tpu.ops import dq_pallas
from bifrost_tpu_torch.blocks.calibrate import broadcast_gains
from bifrost_tpu_torch.ops import calibrate as pcal_fn
from bifrost_tpu_torch.ops.calibrate import (GainCal, decode_gains,
                                             encode_gains, fold_gains,
                                             gain_outer)
from bifrost_tpu_torch.ops.dq_kernel import gain_apply, gain_apply_plain
from bifrost_tpu_torch.weights import carry_over
from test_torch_correlate import _vis_bound

FMA_TOL = 2.4e-7


def _cplx(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.mark.parametrize("mode", ["jnp", "interpret"])
def test_gain_apply_plain_vs_numpy_and_dq_pallas(mode):
    rng = np.random.default_rng(1)
    x = _cplx(rng, 40, 300)
    g = _cplx(rng, 300)
    got = gain_apply_plain(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    re, im, gr, gi = x.real, x.imag, g.real, g.imag
    np.testing.assert_array_equal(got.real, re * gr - im * gi)
    np.testing.assert_array_equal(got.imag, re * gi + im * gr)
    yr, yi = (np.asarray(a) for a in dq_pallas.gain_apply(
        re.copy(), im.copy(), gr.copy(), gi.copy(), mode))
    assert np.abs(got.real - yr).max() > 0      # the FMA shows here
    assert (np.abs(got.real - yr) <=
            FMA_TOL * (np.abs(re * gr) + np.abs(im * gi))).all()
    assert (np.abs(got.imag - yi) <=
            FMA_TOL * (np.abs(re * gi) + np.abs(im * gr))).all()
    # strided in and out (a ring span), the wrapper's CPU path
    out = torch.empty(40, 600, dtype=torch.complex64)[:, ::2]
    gain_apply(torch.from_numpy(x), torch.from_numpy(g), out=out)
    np.testing.assert_array_equal(out.numpy(), got)


def _jgaincal(g, method):
    j = jcal.GainCal(method=method)
    j.pallas_interpret = True
    return j.init(gains=g)


@pytest.mark.parametrize("method", ["jnp", "pallas"])
def test_gaincal_matches_jax(method):
    """Complex, real (real gain part only) and raw ci8 gulps."""
    rng = np.random.default_rng(2)
    g = _cplx(rng, 24)
    x = _cplx(rng, 20, 6, 4)
    xr = rng.standard_normal((20, 24)).astype(np.float32)
    raw = rng.integers(-100, 100, (20, 6, 4, 2)).astype(np.int8)
    j = _jgaincal(g, method)
    p = GainCal(method="cuda").init(gains=g)
    want = np.asarray(j.execute(x))
    got = p.execute(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.complex64
    assert got.shape == want.shape
    gg = g.reshape(6, 4)
    mag = np.abs(x.real * gg.real) + np.abs(x.imag * gg.imag)
    assert (np.abs(got.real - want.real) <= FMA_TOL * mag).all()
    # a real stream takes the real gain part: one rounding, as XLA's
    want = np.asarray(j.execute(xr))
    got = p.execute(torch.from_numpy(xr)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # raw ci8 storage: integer samples, the same bound
    want = np.asarray(j.execute_raw(raw, "ci8"))
    got = p.execute_raw(torch.from_numpy(raw), "ci8").numpy()
    assert got.shape == want.shape == (20, 6, 4)
    xi = raw[..., 0] + 1j * raw[..., 1]
    mag = np.abs(xi.real * gg.real) + np.abs(xi.imag * gg.imag)
    assert (np.abs(got.real - want.real) <= FMA_TOL * mag).all()
    np.testing.assert_array_equal(
        got, pcal_fn(torch.from_numpy(xi.astype(np.complex64)), g).numpy())


def test_set_gains_restages_only_on_change_and_reports():
    rng = np.random.default_rng(3)
    g = _cplx(rng, 8)
    p = GainCal().init(gains=g)
    staged = p.staged_gains()
    p.set_gains(g.copy())
    assert p.staged_gains() is staged
    p.set_gains(g * 2)
    assert p.staged_gains() is not staged
    np.testing.assert_array_equal(p.staged_gains().numpy(), g * 2)
    p.execute(torch.from_numpy(_cplx(rng, 4, 8)))
    rep = p.plan_report()
    assert rep["op"] == "calibrate" and rep["method"] == "cuda"
    assert rep["ngain"] == 8
    with pytest.raises(ValueError, match="gain"):
        p.execute(torch.from_numpy(_cplx(rng, 4, 9)))
    with pytest.raises(ValueError, match="set_gains"):
        GainCal().staged_gains()
    with pytest.raises(ValueError, match="method"):
        GainCal(method="pallas")


def test_numpy_helpers_bitwise_vs_jax():
    rng = np.random.default_rng(4)
    w = _cplx(rng, 3, 8)
    g = _cplx(rng, 8)
    m = rng.random(8) < 0.3
    for args in ((w, g, None), (w, None, m), (w, g, m), (w, None, None)):
        np.testing.assert_array_equal(fold_gains(*args),
                                      jcal.fold_gains(*args))
    np.testing.assert_array_equal(gain_outer(g), jcal.gain_outer(g))
    enc = encode_gains(g)
    assert enc == jcal.encode_gains(g)
    np.testing.assert_array_equal(decode_gains(enc), jcal.decode_gains(enc))
    np.testing.assert_array_equal(decode_gains(g), jcal.decode_gains(g))
    labels = ["time", "freq", "station", "pol"]
    for gains, shape, lab, axis in (
            (_cplx(rng, 5), (3, 5, 2), labels, None),
            (_cplx(rng, 4), (4, 4, 2), labels, "station"),
            (_cplx(rng, 4), (4, 4, 2), labels, None),
            (_cplx(rng, 2), (3, 5, 2), None, 2),
            (_cplx(rng, 30), (3, 5, 2), None, None)):
        np.testing.assert_array_equal(
            broadcast_gains(gains, shape, lab, axis),
            j_broadcast(gains, shape, lab, axis))
    with pytest.raises(ValueError, match="match"):
        broadcast_gains(_cplx(rng, 4), (4, 4), None, None)
    assert carry_over(cal_gains=g)["cal_gains"].dtype == np.complex64


# ------------------------------------------------------- B-engine fold
_BHDR = {"labels": ["time", "freq", "station", "pol"],
         "scales": [[0, 1e-3], [40.0, 0.1], None, None],
         "units": ["s", "MHz", None, None]}


def _int_gains(rng, n):
    return (rng.integers(-2, 3, n) + 1j * rng.integers(-2, 3, n)) \
        .astype(np.complex64)


def _run(side, make, data, hdr, gulp, update=None):
    """array_source -> copy to the device -> make(blocks, ring) -> gather,
    on the JAX package or the port; `update(block)` runs after the
    block's first gulp (a mid-sequence set_gains / set_station_mask).
    -> (the gathered frames, the block)."""
    if side == "jax":
        from bifrost_tpu import blocks
        from bifrost_tpu.blocks.testing import array_source, gather_sink
        from bifrost_tpu.pipeline import Pipeline
        space, pkw = "tpu", {}
    else:
        from bifrost_tpu_torch import blocks
        from bifrost_tpu_torch.blocks import array_source, gather_sink
        from bifrost_tpu_torch.pipeline import Pipeline
        space, pkw = "cuda", {"device": "cpu"}
    got = []
    with Pipeline(**pkw) as pipe:
        src = array_source(data, gulp, header=dict(hdr))
        b = make(blocks, blocks.copy(src, space=space))
        if update is not None:
            inner = b.on_data
            ngulp = []

            def on_data(ispan, ospan):
                r = inner(ispan, ospan)
                ngulp.append(1)
                if len(ngulp) == 1:
                    update(b)
                return r
            b.on_data = on_data
        gather_sink(b, got)
        pipe.run()
    return np.concatenate([np.asarray(a) for a in got]), b


def _bf_run(side, data, hdr, w, n_int, gulp, update=None, **kw):
    return _run(side, lambda bl, r: bl.beamform(
        r, w, nframe_per_integration=n_int, **kw), data, hdr, gulp, update)


@pytest.mark.parametrize("case", ["gains", "mask", "callback", "header",
                                  "cal_applied", "set_gains"])
def test_beamform_fold_matches_jax(case):
    rng = np.random.default_rng(5)
    nstand, npol = 3, 2
    x = (rng.integers(-8, 8, (16, 4, nstand, npol)) +
         1j * rng.integers(-8, 8, (16, 4, nstand, npol))).astype(np.complex64)
    w = (rng.integers(-3, 4, (2, 6)) +
         1j * rng.integers(-3, 4, (2, 6))).astype(np.complex64)
    g = _int_gains(rng, nstand)
    g2 = _int_gains(rng, nstand * npol)
    mask = np.array([False, True, False])
    hdr = dict(_BHDR)
    kw, update = {}, None
    if case == "gains":
        kw = dict(gains=g)
    elif case == "mask":
        kw = dict(station_mask=mask, gains=g2)
    elif case == "callback":
        kw = dict(gain_callback=lambda h: jcal.encode_gains(g))
    elif case in ("header", "cal_applied"):
        hdr["cal_gains"] = encode_gains(g)
        hdr["cal_applied"] = case == "cal_applied"
    else:
        kw = dict(gains=g)

        def update(b):
            b.set_gains(g2)
            b.set_station_mask(mask)
    want, jb = _bf_run("jax", x, hdr, w, 4, 4, update, **kw)
    got, pb = _bf_run("port", x, hdr, w, 4, 4, update, **kw)
    assert got.shape == want.shape == (4, 2, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pb._weff, jb._weff)
    assert pb._weff.shape == w.shape and pb._weff.dtype == w.dtype
    assert pb.gain_updates == jb.gain_updates == (case == "set_gains")
    plain, _ = _bf_run("port", x, dict(_BHDR), w, 4, 4)
    assert np.array_equal(got, plain) == (case == "cal_applied")


@pytest.mark.parametrize("storage", ["f32", "ci8"])
def test_masked_station_equals_zeroed_input(storage):
    """station_mask folded into the weights is bitwise the run whose
    input voltages were zeroed by hand (tests/test_dq.py:128-173)."""
    rng = np.random.default_rng(6)
    shape = (16, 3, 4, 2)
    hdr = dict(_BHDR)
    if storage == "f32":
        x = (rng.standard_normal(shape) +
             1j * rng.standard_normal(shape)).astype(np.complex64)
        w = _cplx(rng, 3, 8)
        x0 = x.copy()
        x0[:, :, 1] = 0
    else:
        x = rng.integers(-90, 90, shape + (2,)).astype(np.int8)
        hdr["dtype"] = "ci8"
        w = _cplx(rng, 2, 8)
        x0 = x.copy()
        x0[:, :, 1] = 0
    mask = np.array([False, True, False, False])
    a, blk = _bf_run("port", x, hdr, w, 16, 8, station_mask=mask)
    b, _ = _bf_run("port", x0, hdr, w, 16, 8)
    np.testing.assert_array_equal(a, b)
    c, _ = _bf_run("port", x, hdr, w, 16, 8)
    assert not np.array_equal(a, c)
    if storage == "ci8":
        assert blk._raw_reads == 2


# ------------------------------------------------------- X-engine fold
def _xc_run(side, x, hdr, update=None, **kw):
    return _run(side, lambda bl, r: bl.correlate(r, 16, gulp_nframe=8,
                                                 **kw), x, hdr, 8, update)


@pytest.mark.parametrize("case", ["callback", "header", "cal_applied",
                                  "set_gains"])
def test_correlate_gain_sources_match_jax(case):
    rng = np.random.default_rng(7)
    x = _cplx(rng, 32, 4, 3, 2)
    g = _cplx(rng, 3)
    hdr = {"labels": ["time", "freq", "station", "pol"]}
    kw, update = {}, None
    if case == "callback":
        kw = dict(gain_callback=lambda h: g)
    elif case in ("header", "cal_applied"):
        hdr["cal_gains"] = encode_gains(g)
        hdr["cal_applied"] = case == "cal_applied"
    else:
        # the first gulp uncalibrated, the rest with g
        def update(c):
            c.set_gains(g)
    want, jc = _xc_run("jax", x, hdr, update, **kw)
    got, pc = _xc_run("port", x, hdr, update, **kw)
    assert got.shape == want.shape == (2, 4, 3, 2, 3, 2)
    assert pc.gain_updates == jc.gain_updates == (case == "set_gains")
    gg = np.repeat(g, 2).reshape(3, 2)
    if case == "cal_applied":
        gg = None
    elif case == "set_gains":
        gg = np.maximum(np.abs(gg), 1.0)
    assert (np.abs(got - want) <= 2 * _vis_bound(x, 16, gg)).all()
    plain, _ = _xc_run("port", x, {"labels": hdr["labels"]})
    assert np.array_equal(got, plain) == (case == "cal_applied")
