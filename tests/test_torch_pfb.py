"""The F-engine of the port against the JAX package, on the CPU: the FIR
MAC (kernel K2's plain version, bifrost_tpu_torch/ops/fir_kernel.py)
against `bifrost_tpu.ops.fir_pallas.fir_tiled` in its 'mac' twin and in
Pallas interpret mode, and the PFB plan and block against the JAX `Pfb`
and `PfbBlock`, on the same seeded numpy input.

Tolerances:
- The MAC is bitwise on integer-valued x and h (every product and sum is
  exact).  On float data XLA:CPU may contract a multiply and an add into
  one FMA, the port never does: rtol 1e-6 (a few f32 roundings of ntap
  terms).
- The PFB's DFT is a matmul in another summation order than XLA's dot:
  |port - jax| <= 8 * nchan * 2**-24 * peak (an nchan-term f32 sum per
  output, with room for the 4-tap MAC).  Against the f64 scipy/FFT golden
  the JAX test's own tolerance, rtol = atol = 2e-5.
- Within the port, split gulps equal one long gulp bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bifrost_tpu.ops.fir_pallas import fir_tiled as j_fir_tiled
from bifrost_tpu.ops.pfb import Pfb as JPfb
from bifrost_tpu_torch import config
from bifrost_tpu_torch.ndarray import (complex_view, logical_shape,
                                       pair_to_structured, storage_view,
                                       structured_to_pair)
from bifrost_tpu_torch.ops import Pfb, pfb, pfb_coeffs
from bifrost_tpu_torch.ops.fir_kernel import fir_mac_plain, fir_tiled
from bifrost_tpu_torch.ops.pfb_kernel import _dft_mats, fold_bank
from bifrost_tpu_torch.ops.runtime import (staged_unpack,
                                           staged_unpack_canonical)

EPS = 2.0 ** -24


def _fir_inputs(rng, ntime, lanes, ntap, integer):
    if integer:
        x = rng.integers(-100, 100, (ntime, lanes)).astype(np.float32)
        h = rng.integers(-5, 6, (ntap, lanes)).astype(np.float32)
        s = rng.integers(-100, 100, (ntap - 1, lanes)).astype(np.float32)
    else:
        x = rng.standard_normal((ntime, lanes)).astype(np.float32)
        h = rng.standard_normal((ntap, lanes)).astype(np.float32)
        s = rng.standard_normal((ntap - 1, lanes)).astype(np.float32)
    return x, h, s


@pytest.mark.parametrize("mode", ["mac", "interpret"])
@pytest.mark.parametrize("ntap", [1, 4, 8])
@pytest.mark.parametrize("decim", [1, 2, 4])
def test_fir_mac_matches_jax_fir_tiled(decim, ntap, mode):
    """Two calls with the history carried between them (ntime 300, not a
    multiple of the JAX tile), on integer-valued data (bitwise) and on
    float data (rtol 1e-6)."""
    rng = np.random.default_rng(10 * decim + ntap)
    lanes = 5
    for integer in (True, False):
        x, h, s = _fir_inputs(rng, 600, lanes, ntap, integer)
        jstate, pstate = jnp.asarray(s), torch.from_numpy(s)
        for part in (x[:300], x[300:]):
            jy, jstate = j_fir_tiled(jnp.asarray(part), jnp.asarray(h),
                                     jstate, decim=decim, mode=mode)
            py, pstate = fir_tiled(torch.from_numpy(part),
                                   torch.from_numpy(h), pstate, decim=decim)
            jy, py = np.asarray(jy), py.numpy()
            assert py.shape == jy.shape == (300 // decim, lanes)
            if integer:
                np.testing.assert_array_equal(py, jy)
            else:
                np.testing.assert_allclose(py, jy, rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(pstate.numpy(), np.asarray(jstate))


def test_fir_split_and_folded_prototype_bitwise():
    """Within the port: one long gulp == two split gulps, bitwise; int8
    input == its f32 lift; the prototype indexed with `rep` == the folded
    bank of `fold_bank`."""
    rng = np.random.default_rng(3)
    nchan, rep, ntap = 6, 4, 4
    proto = rng.standard_normal((ntap, nchan)).astype(np.float32)
    x8 = torch.from_numpy(rng.integers(-128, 128, (64, nchan * rep))
                          .astype(np.int8))
    state = torch.zeros(ntap - 1, nchan * rep)
    c = torch.from_numpy(proto)
    whole, _ = fir_tiled(x8, c, state, rep=rep)
    a, st = fir_tiled(x8[:24], c, state, rep=rep)
    b, _ = fir_tiled(x8[24:], c, st, rep=rep)
    assert torch.equal(torch.cat([a, b]), whole)
    assert torch.equal(fir_mac_plain(x8.float(), c, state, rep=rep), whole)
    bank = torch.from_numpy(fold_bank(proto, rep, 1))
    assert torch.equal(fir_mac_plain(x8, bank, state), whole)


def test_ci8_views_and_staged_unpack():
    rng = np.random.default_rng(4)
    pairs = rng.integers(-128, 128, (5, 3, 2, 2)).astype(np.int8)
    st = pair_to_structured(pairs, "ci8")
    assert st.dtype.names == ("re", "im") and st.shape == (5, 3, 2)
    np.testing.assert_array_equal(structured_to_pair(st), pairs)
    assert logical_shape(pairs.shape, "ci8") == (5, 3, 2)
    z = complex_view(torch.from_numpy(pairs), "ci8")
    assert z.dtype == torch.complex64
    np.testing.assert_array_equal(z.numpy().real, pairs[..., 0])
    assert torch.equal(storage_view(z, "ci8"), torch.from_numpy(pairs))
    re, im = staged_unpack(torch.from_numpy(pairs), "ci8")
    assert re.dtype == torch.float32 and torch.equal(re, z.real)
    re2, im2 = staged_unpack_canonical(torch.from_numpy(pairs), "ci8",
                                       (1, 0, 2))
    assert torch.equal(re2, re.permute(1, 0, 2))
    assert torch.equal(im2, im.permute(1, 0, 2))
    with pytest.raises(ValueError):
        staged_unpack(torch.from_numpy(pairs), "f32")


# ------------------------------------------------------------------ PFB
def _pfb_tol(nchan, peak):
    return 8 * nchan * EPS * peak


def _ci8(rng, ntime, nstand=3, npol=2):
    return rng.integers(-8, 8, (ntime, nstand, npol, 2)).astype(np.int8)


def test_pfb_matches_jax_real_complex_raw():
    rng = np.random.default_rng(11)
    nchan, ntap = 16, 4
    xr = rng.standard_normal((nchan * 9, 3)).astype(np.float32)
    xc = (rng.standard_normal((nchan * 9, 2, 2)) +
          1j * rng.standard_normal((nchan * 9, 2, 2))).astype(np.complex64)
    raw = _ci8(rng, nchan * 9)
    for method in ("jnp", "pallas"):
        for x in (xr, xc):
            jp = JPfb(method=method)
            jp.pallas_interpret = True
            want = np.asarray(jp.init(nchan, ntap=ntap).execute(x))
            got = Pfb().init(nchan, ntap=ntap).execute(x).numpy()
            assert got.shape == want.shape and got.dtype == np.complex64
            assert np.abs(got - want).max() <= \
                _pfb_tol(nchan, np.abs(want).max())
        jp = JPfb(method=method)
        jp.pallas_interpret = True
        want = np.asarray(jp.init(nchan, ntap=ntap).execute_raw(raw, "ci8"))
        got = Pfb().init(nchan, ntap=ntap).execute_raw(
            torch.from_numpy(raw), "ci8").numpy()
        assert got.shape == want.shape == (9, nchan, 3, 2)
        assert np.abs(got - want).max() <= \
            _pfb_tol(nchan, np.abs(want).max())


def test_pfb_split_gulps_bitwise_and_raw_equals_logical():
    rng = np.random.default_rng(12)
    nchan = 8
    raw = _ci8(rng, nchan * 12)
    one = Pfb().init(nchan, ntap=4)
    whole = one.execute_raw(torch.from_numpy(raw), "ci8")
    split = Pfb().init(nchan, ntap=4)
    parts = [split.execute_raw(torch.from_numpy(raw[a:b]), "ci8")
             for a, b in ((0, 8), (8, 40), (40, 96))]
    assert torch.equal(torch.cat(parts), whole)
    logical = Pfb().init(nchan, ntap=4).execute(
        complex_view(torch.from_numpy(raw), "ci8"))
    assert torch.equal(logical, whole)
    plain = Pfb(method="plain").init(nchan, ntap=4)
    assert torch.equal(plain.execute_raw(torch.from_numpy(raw), "ci8"),
                       whole)
    # A structured ci8 array goes in as its logical value.
    assert torch.equal(pfb(pair_to_structured(raw), nchan), whole)


def test_pfb_scipy_fft_golden():
    """The f64 golden of benchmarks/e2e_tpu.py:286-298 (scipy lfilter per
    branch, then np.fft), at the JAX test's tolerance."""
    from scipy.signal import lfilter
    rng = np.random.default_rng(13)
    nchan, ntap = 8, 4
    raw = _ci8(rng, nchan * 12)
    got = Pfb().init(nchan, ntap=ntap).execute_raw(
        torch.from_numpy(raw), "ci8").numpy()
    x = raw[..., 0].astype(np.float64) + 1j * raw[..., 1]
    c = pfb_coeffs(nchan, ntap)
    frames = x.reshape((-1, nchan) + x.shape[1:])
    z = np.empty_like(frames)
    for k in range(nchan):
        z[:, k] = lfilter(c[:, k], [1.0], frames[:, k], axis=0)
    golden = np.fft.fft(z, axis=1)
    np.testing.assert_allclose(got, golden, rtol=2e-5, atol=2e-5)


def test_pfb_plan_report_and_dft_mats():
    plan = Pfb().init(8, ntap=3)
    plan.execute(np.zeros((16, 2), np.float32))
    rep = plan.plan_report()
    assert rep["op"] == "pfb" and rep["method"] == "cuda"
    assert rep["nchan"] == 8 and rep["ntap"] == 3
    for key in ("origin", "plan_build_s", "cache"):
        assert key in rep
    from bifrost_tpu.ops.pfb_pallas import _dft_mats as j_dft_mats
    for a, b in zip(_dft_mats(64), j_dft_mats(64)):
        np.testing.assert_array_equal(a, b)
    from bifrost_tpu.ops.pfb import pfb_coeffs as j_pfb_coeffs
    np.testing.assert_array_equal(pfb_coeffs(64, 4), j_pfb_coeffs(64, 4))
    with pytest.raises(ValueError):
        Pfb(method="pallas")


# ---------------------------------------------------------------- block
_HDR = {"dtype": "ci8", "labels": ["time", "station", "pol"],
        "scales": [[0, 1e-3], None, None], "units": ["s", None, None],
        "cfreq": 40.0, "cfreq_units": "MHz"}


def _jax_pfb_chain(data, nchan, gulp):
    from bifrost_tpu import blocks
    from bifrost_tpu.blocks.testing import array_source, gather_sink
    from bifrost_tpu.pipeline import Pipeline
    got, headers = [], []
    with Pipeline() as pipe:
        src = array_source(data, gulp, header=_HDR)
        p = blocks.pfb(blocks.copy(src, space="tpu"), nchan, ntap=4)
        gather_sink(p, got, headers)
        pipe.run()
    return np.concatenate(got), headers[0]


def _port_pfb_chain(data, nchan, gulp):
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.pipeline import Pipeline
    got, headers = [], []
    with Pipeline(device="cpu") as pipe:
        src = blocks.array_source(data, gulp, header=_HDR)
        p = blocks.pfb(blocks.copy(src, space="cuda"), nchan, ntap=4)
        blocks.gather_sink(p, got, headers)
        pipe.run()
    return np.concatenate(got), headers[0], p


def test_pfb_block_matches_jax_block():
    """The block chain on a stream whose last gulp is partial, against the
    JAX block chain: same header, same spectra (DFT tolerance), the
    remainder frames dropped with a warning, and the raw ci8 read taken
    on every gulp."""
    rng = np.random.default_rng(14)
    nchan = 8
    raw = _ci8(rng, nchan * 11 + 3)     # 5 gulps of 16 + 11 frames
    want, jhdr = _jax_pfb_chain(pair_to_structured(raw), nchan, 2 * nchan)
    with pytest.warns(UserWarning, match="dropping 3 trailing"):
        got, phdr, blk = _port_pfb_chain(raw, nchan, 2 * nchan)
    assert phdr["_tensor"] == jhdr["_tensor"]
    assert phdr["gulp_nframe"] == jhdr["gulp_nframe"] == 2
    assert got.shape == want.shape == (11, nchan, 3, 2)
    assert np.abs(got - want).max() <= _pfb_tol(nchan, np.abs(want).max())
    assert blk._raw_reads == 6
    assert blk._raw_read_nbyte == nchan * 11 * 3 * 2 * 2
    assert blk.output_nframes_for_gulp(0, 16) == [2]
    assert blk.output_nframes_for_gulp(16, 11) == [1]


def test_pfb_block_latches_method():
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.pipeline import Pipeline
    errs = []

    def poke(_):
        try:
            config.set("pfb_method", "plain")
        except RuntimeError as e:
            errs.append(str(e))

    # 4 gulps against an output ring of 3: the block must wait for the
    # sink before it can end its sequence, so the latch is still held
    # when the sink pokes the flag.
    raw = _ci8(np.random.default_rng(15), 32)
    with Pipeline(device="cpu") as pipe:
        src = blocks.array_source(raw, 8, header={
            "dtype": "ci8", "labels": ["time", "station", "pol"]})
        p = blocks.pfb(blocks.copy(src, space="cuda"), 4, ntap=3)
        blocks.callback_sink(p, on_data=poke)
        pipe.run()
    assert errs and "pfb_method" in errs[0]
    assert p.plan_report()["method"] == "cuda"
    config.reset("pfb_method")


@pytest.mark.parametrize("ntap", [1, 2, 4, 8, 9, 16, 17])
@pytest.mark.parametrize("int8", [True, False])
def test_fir_vectors_route(int8, ntap):
    """K2's route decision: the vector kernel where a thread's V lanes
    (LANES_INT8 or LANES_F32 up to SHORT_TAP taps, LANES_LONG for int8
    above) tile every row (a lane count that is a multiple of V) and x,
    out and state start 16-byte aligned, for ntap within the
    instantiated range (1 to 16 for int8 x, 1 to 8 for f32); the scalar
    kernel otherwise.  decim and the coefficient columns do not enter
    it."""
    from bifrost_tpu_torch.ops.fir_kernel import (LANES_F32, LANES_INT8,
                                                  LANES_LONG, MAX_TAP,
                                                  SHORT_TAP, fir_vectors)
    assert (SHORT_TAP, MAX_TAP) == (8, 16)
    v = LANES_LONG if ntap > SHORT_TAP else \
        LANES_INT8 if int8 else LANES_F32
    dt = torch.int8 if int8 else torch.float32
    lanes = 4 * v
    tap_ok = 1 <= ntap <= (MAX_TAP if int8 else SHORT_TAP)

    def x_at(offset, lanes=lanes, rows=8):
        return torch.zeros(rows * lanes + offset, dtype=dt)[offset:] \
            .view(rows, lanes)

    st = torch.zeros(max(ntap - 1, 1), lanes)
    out = torch.zeros(8, lanes)
    for decim in (1, 2, 4, 5):
        assert fir_vectors(x_at(0), st, out[:8 // decim], ntap) == tap_ok
    # unaligned bases of x, out and the state (ntap 1 reads no state)
    assert not fir_vectors(x_at(1), st, out, ntap)
    assert not fir_vectors(x_at(0), st, torch.zeros(8 * lanes + 1)[1:]
                           .view(8, lanes), ntap)
    st_off = torch.zeros((ntap - 1) * lanes + 1)[1:].view(ntap - 1, lanes)
    assert fir_vectors(x_at(0), st_off, out, ntap) == (ntap == 1 and tap_ok)
    # lane counts that are not a multiple of V, odd ones, and a base one
    # row into a buffer of an odd lane count
    for n in (v + 2, 2 * v - 1, 63):
        xo = torch.zeros(9, n, dtype=dt)[1:]
        assert not fir_vectors(xo, torch.zeros(max(ntap - 1, 1), n),
                               torch.zeros(8, n), ntap)


def _ci4_of(pairs):
    """ci8 (re, im) int8 pairs with values in [-8, 7] -> the packed ci4
    bytes of the same values (re in the high nibble)."""
    return (((pairs[..., 0] & 0xF).astype(np.uint8) << 4) |
            (pairs[..., 1] & 0xF).astype(np.uint8))


def test_pfb_ci4_raw_read_matches_ci8_twin_and_jax():
    """Packed ci4 voltages through `execute_raw` and through the block's
    raw read: bitwise their ci8 twin (the same values), within the DFT
    tolerance of the JAX plan and block fed the ci4 bytes, and the block
    reads 1 B/sample."""
    rng = np.random.default_rng(15)
    nchan = 8
    raw = _ci8(rng, nchan * 11 + 3)
    packed = _ci4_of(raw)
    whole8 = Pfb().init(nchan, ntap=4).execute_raw(
        torch.from_numpy(raw[:nchan * 11]), "ci8")
    whole4 = Pfb().init(nchan, ntap=4).execute_raw(
        torch.from_numpy(packed[:nchan * 11]), "ci4")
    assert torch.equal(whole4, whole8)
    jp = JPfb(method="jnp")
    want = np.asarray(jp.init(nchan, ntap=4).execute_raw(
        packed[:nchan * 11], "ci4"))
    assert np.abs(whole4.numpy() - want).max() <= \
        _pfb_tol(nchan, np.abs(want).max())
    hdr = dict(_HDR, dtype="ci4")
    saved = _HDR.copy()
    try:
        _HDR.update(hdr)
        jwant, jhdr = _jax_pfb_chain(packed, nchan, 2 * nchan)
        with pytest.warns(UserWarning, match="dropping 3 trailing"):
            got, phdr, blk = _port_pfb_chain(packed, nchan, 2 * nchan)
    finally:
        _HDR.clear()
        _HDR.update(saved)
    with pytest.warns(UserWarning, match="dropping 3 trailing"):
        got8, _, _ = _port_pfb_chain(raw, nchan, 2 * nchan)
    assert phdr["_tensor"] == jhdr["_tensor"]
    assert np.array_equal(got, got8)
    assert np.abs(got - jwant).max() <= _pfb_tol(nchan, np.abs(jwant).max())
    assert blk._raw_reads == 6
    assert blk._raw_read_nbyte == nchan * 11 * 3 * 2
