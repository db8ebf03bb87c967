"""The port's `ops.linalg.LinAlg` and `ConvertVisibilitiesBlock` against
the JAX package's, on the CPU, on the same seeded numpy input (mirrors
tests/test_ops.py:539-570).

Tolerances:
- LinAlg: a K-term complex dot product in f32 is within 2 K 2**-24 * M
  of the exact one, M = sum_k |a_ik| |b_kj| (f64), on either side (the
  port's torch.matmul and XLA sum in their own orders), so |port - jax|
  <= 4 K 2**-24 M (+ 2**-24 |beta| |out| for the accumulate).  On
  integer-valued ci8/ci4 inputs with small K every partial sum is an
  integer below 2**24: bitwise.
- convert_visibilities: selects and conjugates, bitwise.
"""

import numpy as np
import pytest
import torch

from bifrost_tpu import ndarray as jndarray
from bifrost_tpu.ops import LinAlg as JLinAlg

from bifrost_tpu_torch.ops import LinAlg

EPS = 2.0 ** -24


def _c(rng, shape):
    return (rng.random(shape) + 1j * rng.random(shape)).astype(np.complex64)


def _jax(alpha, a, b, beta, out):
    o = np.array(out).view(jndarray)
    JLinAlg().matmul(alpha, a, b, beta, o)
    return np.asarray(o)


def _bound(a, b, k, beta=0.0, out=None):
    m = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    extra = 0 if out is None else EPS * abs(beta) * np.abs(out)
    return 4 * k * EPS * m + extra + 1e-30


@pytest.mark.parametrize("form", ["general", "a_herm", "b_herm"])
def test_matmul_matches_jax(form):
    rng = np.random.default_rng({"general": 1, "a_herm": 2,
                                 "b_herm": 3}[form])
    if form == "general":
        a, b = _c(rng, (2, 4, 8)), _c(rng, (2, 8, 3))
        args, lhs, rhs = (a, b), a, b
    elif form == "a_herm":
        a = _c(rng, (3, 5, 7))
        args, lhs, rhs = (a, None), a, np.conj(a).transpose(0, 2, 1)
        b = None
    else:
        b = _c(rng, (3, 7, 5))
        args, lhs, rhs = (None, b), np.conj(b).transpose(0, 2, 1), b
    out = np.zeros(np.broadcast_shapes(lhs.shape[:-1] + (rhs.shape[-1],)),
                   np.complex64)
    want = _jax(1.0, args[0], args[1], 0.0, out)
    got = LinAlg().matmul(1.0, args[0], args[1], 0.0, None).numpy()
    assert got.shape == want.shape
    bound = _bound(lhs, rhs, lhs.shape[-1])
    assert (np.abs(got - want) <= 2 * bound).all()
    exact = lhs.astype(np.complex128) @ rhs.astype(np.complex128)
    assert (np.abs(got - exact) <= bound).all()


def test_beta_accumulate_into_out():
    """Mirrors test_linalg_beta_accumulate: out = 2 a a^H + 1 * out, into
    a tensor and into a numpy array."""
    rng = np.random.default_rng(4)
    a = _c(rng, (4, 6))
    acc = np.ones((4, 4), np.complex64)
    want = _jax(2.0, a, None, 1.0, acc)
    t = torch.ones(4, 4, dtype=torch.complex64)
    res = LinAlg().matmul(2.0, torch.from_numpy(a), None, 1.0, t)
    assert res is t
    host = np.ones((4, 4), np.complex64)
    LinAlg().matmul(2.0, a, None, 1.0, host)
    assert np.array_equal(host, t.numpy())
    ah = np.conj(a).T
    bound = _bound(2 * a, ah, 6, 1.0, acc)
    assert (np.abs(t.numpy() - want) <= 2 * bound).all()
    with pytest.raises(ValueError, match="at least one"):
        LinAlg().matmul(1.0, None, None, 0.0, None)


@pytest.mark.parametrize("dtype", ["ci8", "ci4"])
def test_integer_inputs_lift_to_complex_bitwise(dtype):
    """ci8 pairs and packed ci4 lift to complex first; integer-exact, so
    bitwise the JAX product of the same logical values (the correlator
    form b^H b)."""
    rng = np.random.default_rng(5)
    re = rng.integers(-8, 8, (2, 9, 6)).astype(np.int8)
    im = rng.integers(-8, 8, (2, 9, 6)).astype(np.int8)
    z = (re + 1j * im.astype(np.float32)).astype(np.complex64)
    if dtype == "ci8":
        b = torch.from_numpy(np.stack([re, im], -1))
    else:
        b = torch.from_numpy(((re & 0xF).astype(np.uint8) << 4) |
                             (im & 0xF).astype(np.uint8))
    got = LinAlg().matmul(1.0, None, b, 0.0, None, b_dtype=dtype)
    want = _jax(1.0, None, z, 0.0, np.zeros((2, 6, 6), np.complex64))
    assert np.array_equal(got.numpy(), want)
    st = np.empty(re.shape, [("re", "i1"), ("im", "i1")])
    st["re"], st["im"] = re, im
    assert np.array_equal(LinAlg().matmul(1.0, None, st, 0.0, None).numpy(),
                          want)


# ---------------------------------------------------- convert_visibilities
def _vis(seed=6, ntime=3, nchan=2, nstand=4, npol=2):
    """A Hermitian visibility matrix with the upper station triangle
    zeroed off the diagonal (a lower-triangle correlator's output), and
    some zero baselines."""
    rng = np.random.default_rng(seed)
    shape = (ntime, nchan, nstand, npol)
    x = (rng.integers(-5, 6, shape) + 1j * rng.integers(-5, 6, shape)) \
        .astype(np.complex64).reshape(ntime, nchan, -1)
    v = np.einsum("tci,tcj->tcij", np.conj(x), x).reshape(
        ntime, nchan, nstand, npol, nstand, npol)
    for i in range(nstand):
        for j in range(i + 1, nstand):
            v[:, :, i, :, j, :] = 0
    v[:, :, 2, :, 0, :] = 0                   # a dead baseline
    return v.astype(np.complex64)


HDR = {"dtype": "cf32",
       "labels": ["time", "freq", "station_i", "pol_i", "station_j",
                  "pol_j"],
       "scales": [[0, 1.0], [40.0, 0.1], None, None, None, None],
       "units": ["s", "MHz", None, None, None, None]}


@pytest.mark.parametrize("fmt", ["matrix", "storage"])
def test_convert_visibilities_matches_jax_block(fmt):
    from bifrost_tpu import blocks as jb
    from bifrost_tpu.blocks.testing import array_source as jsrc
    from bifrost_tpu.blocks.testing import gather_sink as jgather
    from bifrost_tpu.pipeline import Pipeline as JPipeline
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.pipeline import Pipeline
    v = _vis()
    jgot, jh = [], []
    with JPipeline() as pipe:
        c = jb.convert_visibilities(
            jb.copy(jsrc(v, 2, header=dict(HDR)), space="tpu"), fmt)
        jgather(jb.copy(c, space="system"), jgot, jh)
        pipe.run()
    pgot, ph = [], []
    with Pipeline(device="cpu") as pipe:
        c = blocks.convert_visibilities(
            blocks.copy(blocks.array_source(v, 2, header=dict(HDR)),
                        space="cuda"), fmt)
        blocks.gather_sink(c, pgot, ph)
        pipe.run()
    got, want = np.concatenate(pgot), np.concatenate(jgot)
    assert np.array_equal(got, want)
    assert ph[0]["_tensor"] == jh[0]["_tensor"]
    assert ph[0].get("matrix_fill_mode") == jh[0].get("matrix_fill_mode")
    if fmt == "matrix":
        full = np.einsum("tcipjq->tcjqip", np.conj(got))
        # Hermitian except where both triangles were zero
        assert np.array_equal(got, full) or \
            np.array_equal(got[:, :, 2, :, 0, :], 0 * got[:, :, 2, :, 0, :])
    else:
        assert got.shape == (3, 2, 10, 2, 2)
    with pytest.raises(ValueError, match="format"):
        blocks.convert_visibilities(None, "triangle")
