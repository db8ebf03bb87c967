"""The B-engine of the port against the JAX package, on the CPU: the
`Beamform` plan (kernel K4's plain version, bifrost_tpu_torch/ops/
beamform_kernel.py) against the JAX `Beamform` in its single-device 'jnp'
and 'pallas' (interpret) methods, and the `BeamformBlock` against the
JAX block, on the same seeded numpy input.  The JAX mesh-sharded paths
are not a reference here (ROADMAP Queue C).

Tolerances:
- Bitwise where every partial sum is an integer below 2**24: integer
  voltages and weights small enough that |beam|**2 summed over time
  stays below it.
- Otherwise the port sums stations one by one and XLA in its own order:
  |port - jax| <= (4 * nsp + 2 * ntime) * 2**-24 * M, with M[b, c] =
  sum_t (sum_i |w[b, i]| |x[t, c, i]|)**2, an f32 error bound for an
  nsp-term complex sum, its square and an ntime-term sum.
"""

import warnings

import numpy as np
import pytest
import torch

from bifrost_tpu.ops import Beamform as JBeamform
from bifrost_tpu_torch import config
from bifrost_tpu_torch.blocks._common import (_canonical_permutation,
                                              integrate_chunks)
from bifrost_tpu_torch.ndarray import pair_to_structured
from bifrost_tpu_torch.ops import Beamform, beamform_kernel
from bifrost_tpu_torch.ops.beamform_kernel import beamform_power_plain

EPS = 2.0 ** -24


def _jax(w, method):
    jp = JBeamform()
    jp.pallas_interpret = True
    return jp.init(w, method=method)


def _bound(x, w):
    mag = np.einsum("bi,tci->tcb", np.abs(w).astype(np.float64),
                    np.abs(x).astype(np.float64)) ** 2
    ntime, _, nsp = x.shape
    return (4 * nsp + 2 * ntime) * EPS * mag.sum(axis=0).T


@pytest.mark.parametrize("method", ["jnp", "pallas"])
@pytest.mark.parametrize("nbeam", [1, 2, 8])
def test_beamform_matches_jax(nbeam, method):
    rng = np.random.default_rng(nbeam)
    ntime, nchan, nsp = 21, 5, 6
    # integer voltages and weights: exact partial sums -> bitwise
    raw = rng.integers(-8, 8, (ntime, nchan, 3, 2, 2)).astype(np.int8)
    wi = rng.integers(-3, 4, (nbeam, nsp)) + \
        1j * rng.integers(-3, 4, (nbeam, nsp))
    wi = wi.astype(np.complex64)
    want = np.asarray(_jax(wi, method).execute_raw(raw, "ci8"))
    got = Beamform().init(wi).execute_raw(torch.from_numpy(raw), "ci8")
    assert got.shape == (nbeam, nchan)
    np.testing.assert_array_equal(got.numpy(), want)
    xl = (raw[..., 0] + 1j * raw[..., 1]).reshape(ntime, nchan, nsp) \
        .astype(np.complex64)
    np.testing.assert_array_equal(
        Beamform().init(wi).execute(xl).numpy(), want)
    # random f32 voltages and weights: the stated bound
    x = (rng.standard_normal((ntime, nchan, nsp)) +
         1j * rng.standard_normal((ntime, nchan, nsp))).astype(np.complex64)
    w = (rng.standard_normal((nbeam, nsp)) +
         1j * rng.standard_normal((nbeam, nsp))).astype(np.complex64)
    want = np.asarray(_jax(w, method).execute(x))
    got = Beamform().init(w).execute(x).numpy()
    assert (np.abs(got - want) <= _bound(x, w)).all()


def test_beamform_raw_perm_batch_and_report():
    """Raw ci8 in another header order == the logical path; a batch ==
    its members; the plan report; the kernel's order for real input."""
    rng = np.random.default_rng(20)
    raw = rng.integers(-100, 100, (6, 3, 2, 4, 2)).astype(np.int8)  # t s p c
    w = (rng.standard_normal((2, 6)) +
         1j * rng.standard_normal((2, 6))).astype(np.complex64)
    plan = Beamform().init(w, method="plain")
    perm, roles = _canonical_permutation(["time", "stand", "pol", "chan"])
    assert perm == [0, 3, 1, 2] and roles == ["time", "chan", "stand", "pol"]
    got = plan.execute_raw(torch.from_numpy(raw), "ci8", perm)
    xl = torch.complex(torch.from_numpy(raw[..., 0]).float(),
                       torch.from_numpy(raw[..., 1]).float())
    xl = xl.permute(0, 3, 1, 2).reshape(6, 4, 6)
    assert torch.equal(got, plan.execute(xl))
    batch = torch.stack([xl, xl.flip(0)])
    res = plan.execute(batch)
    assert torch.equal(res[0], plan.execute(xl))
    assert torch.equal(res[1], plan.execute(xl.flip(0)))
    rep = plan.plan_report()
    assert rep["op"] == "beamform" and rep["method"] == "plain"
    assert rep["nbeam"] == 2 and rep["nsp"] == 6
    assert rep["weights_origin"] == "host"
    real = torch.from_numpy(rng.standard_normal((4, 3, 6)).astype(np.float32))
    assert torch.equal(plan.execute(real),
                       beamform_power_plain(real.to(torch.complex64),
                                            torch.from_numpy(w)))


@pytest.mark.parametrize("ntime,nchan,nsp,nbeam,elt,base", [
    (16, 4096, 512, 8, 8, 0), (16, 4096, 512, 8, 2, 0), (0, 5, 300, 1, 8, 0),
    (1, 5, 300, 3, 8, 0), (33, 13, 513, 9, 8, 0), (260, 3, 520, 128, 2, 0),
    (5, 30, 1, 2, 2, 0), (16, 9, 512, 8, 8, 8)])
def test_launch_geometry(ntime, nchan, nsp, nbeam, elt, base):
    """K4's launch: every frame of a channel in one block, all of a call's
    frames in one tile up to the block's rows; channels a block filling
    the rows; beam groups of GROUP up to 128 beams; 16-byte copies only
    where x and a row's bytes are 16-byte aligned; shared memory within
    the 227 KB a block may use, and two blocks an SM at the flagship's
    complex64 gulp."""
    g = beamform_kernel.launch_geometry(ntime, nchan, nsp, nbeam, elt, base)
    k = beamform_kernel
    assert (k.GROUP, k.MAX_BEAMS) == (8, 128)
    assert g["frames"] == max(1, min(ntime, k.ROWS))
    assert g["chans"] == k.ROWS // g["frames"] >= 1
    assert (g["groups"] - 1) * k.GROUP < nbeam <= g["groups"] * k.GROUP
    assert g["blocks"] == -(-nchan // g["chans"]) * g["groups"]
    assert g["vec"] == (base % 16 == 0 and nsp * elt % 16 == 0)
    assert g["smem"] <= k.SMEM_LIMIT
    if (ntime, nchan, nsp, elt) == (16, 4096, 512, 8):
        assert g["blocks"] == 4096 // (k.ROWS // 16)
        assert 2 * (g["smem"] + 1024) <= 233472


def test_kernel_wrapper_refusals():
    """Off the CPU the K4 and K5a wrappers launch or raise: a device
    that is neither CUDA nor the CPU is refused before any launch."""
    from bifrost_tpu_torch.ops import dq_kernel
    x = torch.zeros(2, 3, 4, dtype=torch.complex64, device="meta")
    w = torch.zeros(1, 4, dtype=torch.complex64, device="meta")
    before = beamform_kernel.beamform_power.launches
    with pytest.raises(ValueError, match="unsupported device"):
        beamform_kernel.beamform_power(x, w)
    assert beamform_kernel.beamform_power.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        dq_kernel.masked_fill(x[0], torch.zeros(1, 4, dtype=torch.bool,
                                                device="meta"), None, 2)


def test_integrate_chunks_splits_at_boundaries():
    calls = []

    def engine(k0, k1):
        calls.append((k0, k1))
        return torch.tensor(float(k1 - k0))

    outs, carry = integrate_chunks(engine, 5, (None, 0), 3)
    assert calls == [(0, 3), (3, 5)]
    assert [float(o) for o in outs] == [3.0] and carry[1] == 2
    outs, carry = integrate_chunks(engine, 4, carry, 3)
    assert calls[2:] == [(0, 1), (1, 4)]
    assert [float(o) for o in outs] == [3.0, 3.0] and carry == (None, 0)


# ---------------------------------------------------------------- block
_HDR = {"dtype": "ci8", "labels": ["time", "freq", "station", "pol"],
        "scales": [[0, 1e-3], [40.0, 0.1], None, None],
        "units": ["s", "MHz", None, None]}


def _jax_block_chain(data, w, n_int, gulp):
    from bifrost_tpu import blocks
    from bifrost_tpu.blocks.testing import array_source, gather_sink
    from bifrost_tpu.pipeline import Pipeline
    got, headers = [], []
    with Pipeline() as pipe:
        src = array_source(data, gulp, header=_HDR)
        b = blocks.beamform(blocks.copy(src, space="tpu"), w,
                            nframe_per_integration=n_int)
        gather_sink(b, got, headers)
        pipe.run()
    return np.concatenate(got), headers[0]


def _port_block_chain(data, w, n_int, gulp):
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.pipeline import Pipeline
    got, headers = [], []
    with Pipeline(device="cpu") as pipe:
        src = blocks.array_source(data, gulp, header=_HDR)
        b = blocks.beamform(blocks.copy(src, space="cuda"), w,
                            nframe_per_integration=n_int)
        blocks.gather_sink(b, got, headers)
        pipe.run()
    return np.concatenate(got), headers[0], b


def test_beamform_block_mid_gulp_boundaries_matches_jax():
    """2 spectra per gulp, n_int = 3 (boundaries fall mid-gulp) and a
    partial final gulp: the same integrations as the JAX block, bitwise
    (integer voltages and weights), the trailing partial integration
    dropped with a warning, and every gulp read in raw ci8 form."""
    rng = np.random.default_rng(21)
    ntime, nchan = 13, 4
    raw = rng.integers(-8, 8, (ntime, nchan, 3, 2, 2)).astype(np.int8)
    w = (rng.integers(-3, 4, (2, 6)) +
         1j * rng.integers(-3, 4, (2, 6))).astype(np.complex64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, jhdr = _jax_block_chain(pair_to_structured(raw), w, 3, 2)
    with pytest.warns(UserWarning, match="partial integration"):
        got, phdr, blk = _port_block_chain(raw, w, 3, 2)
    assert phdr["_tensor"] == jhdr["_tensor"]
    assert phdr["gulp_nframe"] == jhdr["gulp_nframe"] == 1
    assert got.shape == want.shape == (4, 2, nchan)
    np.testing.assert_array_equal(got, want)
    assert blk._raw_reads == 7
    assert blk._raw_read_nbyte == ntime * nchan * 6 * 2
    assert [blk.output_nframes_for_gulp(r, 2)[0] for r in range(0, 12, 2)] \
        == [0, 1, 1, 0, 1, 1]


def test_beamform_block_latches_method_and_checks_gulp():
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.pipeline import Pipeline, PipelineInitError
    rng = np.random.default_rng(22)
    # 6 integrations against an output ring of 3 frames: the block must
    # wait for the sink before it can end its sequence, so the latch is
    # still held when the sink pokes the flag.
    raw = rng.integers(-8, 8, (24, 4, 3, 2, 2)).astype(np.int8)
    w = np.ones((2, 6), np.complex64)
    errs = []

    def poke(_):
        try:
            config.set("beamform_method", "plain")
        except RuntimeError as e:
            errs.append(str(e))

    with Pipeline(device="cpu") as pipe:
        src = blocks.array_source(raw, 4, header=_HDR)
        b = blocks.beamform(blocks.copy(src, space="cuda"), w,
                            nframe_per_integration=4)
        blocks.callback_sink(b, on_data=poke)
        pipe.run()
    assert errs and "beamform_method" in errs[0]
    assert b.bf.plan_report()["method"] == "cuda"
    config.reset("beamform_method")
    with Pipeline(device="cpu") as pipe:
        src = blocks.array_source(raw, 4, header=_HDR)
        blocks.beamform(blocks.copy(src, space="cuda"), w,
                        nframe_per_integration=2)
        with pytest.raises((PipelineInitError, ValueError),
                           match="exceeds"):
            pipe.run()


def test_beamform_ci4_raw_read_matches_ci8_twin_and_jax():
    """Packed ci4 voltages through `execute_raw` (another header order
    too) and through the block's raw read: bitwise their ci8 twin and
    the JAX plan and block fed the ci4 bytes (integer voltages and
    weights), at 1 B/sample."""
    rng = np.random.default_rng(22)
    ntime, nchan = 13, 4
    raw = rng.integers(-8, 8, (ntime, nchan, 3, 2, 2)).astype(np.int8)
    packed = (((raw[..., 0] & 0xF).astype(np.uint8) << 4) |
              (raw[..., 1] & 0xF).astype(np.uint8))
    w = (rng.integers(-3, 4, (2, 6)) +
         1j * rng.integers(-3, 4, (2, 6))).astype(np.complex64)
    plan = Beamform().init(w, method="plain")
    p4 = plan.execute_raw(torch.from_numpy(packed), "ci4")
    assert torch.equal(p4, plan.execute_raw(torch.from_numpy(raw), "ci8"))
    np.testing.assert_array_equal(
        p4.numpy(), np.asarray(_jax(w, "jnp").execute_raw(packed, "ci4")))
    perm = (0, 3, 1, 2)                    # header (time, stand, pol, chan)
    hp = np.ascontiguousarray(packed.transpose(0, 2, 3, 1))
    assert torch.equal(plan.execute_raw(torch.from_numpy(hp), "ci4", perm),
                       p4)
    with pytest.raises(ValueError, match="ci4 or ci8"):
        plan.execute_raw(torch.zeros(2, 1, 1, 1, 2, dtype=torch.int16),
                         "ci16")
    saved = _HDR.copy()
    try:
        _HDR["dtype"] = "ci4"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want, jhdr = _jax_block_chain(packed, w, 3, 2)
        with pytest.warns(UserWarning, match="partial integration"):
            got, phdr, blk = _port_block_chain(packed, w, 3, 2)
    finally:
        _HDR.clear()
        _HDR.update(saved)
    with pytest.warns(UserWarning, match="partial integration"):
        got8, _, _ = _port_block_chain(raw, w, 3, 2)
    assert phdr["_tensor"] == jhdr["_tensor"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, got8)
    assert blk._raw_reads == 7
    assert blk._raw_read_nbyte == ntime * nchan * 6
