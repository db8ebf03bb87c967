"""The LWA beam-search slice end to end: the port's chain
(bifrost_tpu_torch.service.lwa_beam_search_pipeline on device='cpu')
against the same chain built from the JAX package's blocks in the order
of `lwa_instrument_spec`'s unfused B branch (bifrost_tpu/service.py:
486-534), as benchmarks/e2e_tpu.py builds its subchain:

    array_source (ci8 [time, station, pol]) -> copy -> pfb -> beamform
    -> transpose(['beam', 'freq', 'time']) -> fdmt -> CandidateDetectBlock

on the same seeded numpy voltages, at nstand 3, npol 2, nchan 8, ntap 4,
n_int 4, nbeam 2, max_delay 4.

Tolerances: the beam powers and the dedispersed frames agree with the
JAX chain to 1e-5 of their peak (the PFB's DFT matmul and the beam sums
run in other f32 summation orders: about (8 * nchan + 4 * nsp + 2 *
n_int) * 2**-24 of the peak, 6e-6 here); the candidates are identical
(none: each FDMT gulp is one frame, so its MAD is 0); the beam powers
agree with the f64 numpy golden of benchmarks/e2e_tpu.py:384-410 to
rel 1e-4, that check's own limit.
"""

import numpy as np
import pytest
import torch

from bifrost_tpu_torch.ndarray import pair_to_structured
from bifrost_tpu_torch.ops import pfb_coeffs
from bifrost_tpu_torch.service import (default_beam_weights,
                                       lwa_beam_search_pipeline)
from bifrost_tpu_torch.weights import carry_over

NSTAND, NPOL, NCHAN, NTAP, N_INT, NBEAM, MAX_DELAY = 3, 2, 8, 4, 4, 2, 4
NINT = 10                        # integrations in the stream
GULP = N_INT * NCHAN
F0, DT = 40.0, 1e-6
TOL = 1e-5


def _voltages(seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 8, (NINT * N_INT * NCHAN, NSTAND, NPOL, 2)) \
        .astype(np.int8)


def _jax_chain(volt, w):
    from bifrost_tpu import blocks
    from bifrost_tpu.blocks.testing import array_source, gather_sink
    from bifrost_tpu.pipeline import Pipeline
    from bifrost_tpu.service import CandidateDetectBlock, FrameLedger
    beams, dd = [], []
    ledger = FrameLedger()
    with Pipeline() as pipe:
        src = array_source(pair_to_structured(volt), GULP, header={
            "dtype": "ci8", "labels": ["time", "station", "pol"],
            "scales": [[0.0, DT], None, None], "units": ["s", None, None],
            "cfreq": F0, "cfreq_units": "MHz"}, name="ingest")
        dev = blocks.copy(src, space="tpu", name="fengine_h2d")
        f = blocks.pfb(dev, NCHAN, ntap=NTAP, name="fengine_pfb")
        b = blocks.beamform(f, w, nframe_per_integration=N_INT,
                            name="bengine")
        t = blocks.transpose(b, ["beam", "freq", "time"], name="bdetect_t")
        d = blocks.fdmt(t, max_delay=MAX_DELAY, name="bdetect_fdmt")
        det = CandidateDetectBlock(d, threshold=8.0, name="bdetect")
        det.ledger = ledger
        gather_sink(b, beams)
        gather_sink(d, dd)
        pipe.run()
    return {"beams": [np.asarray(x) for x in beams],
            "dedispersed": [np.asarray(x) for x in dd],
            "det": det, "ledger": ledger, "f": f, "b": b, "d": d}


def _port_chain(volt, gulp=GULP, **kwargs):
    # The unfused chain, the JAX chain's topology (test_torch_fusion.py
    # holds the fused one).
    g = {"beams": [], "dedispersed": []}
    pipe, det, ledger = lwa_beam_search_pipeline(
        volt, nstand=NSTAND, npol=NPOL, nchan=NCHAN, ntap=NTAP, n_int=N_INT,
        nbeam=NBEAM, max_delay=MAX_DELAY, f0_mhz=F0, dt_s=DT,
        gulp_nframe=gulp, device="cpu", gather=g, fuse=False, **kwargs)
    pipe.run()
    return dict(g, det=det, ledger=ledger, pipe=pipe)


@pytest.fixture(scope="module")
def runs():
    volt = _voltages()
    w = default_beam_weights(NBEAM, NSTAND * NPOL)
    return volt, _jax_chain(volt, w), _port_chain(volt)


def _close(a, b):
    a, b = np.concatenate(a, -1), np.concatenate(b, -1)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    assert np.isfinite(a).all()
    assert np.abs(a - b).max() <= TOL * np.abs(b).max()


def test_beam_powers_and_dedispersed_match_jax(runs):
    _, j, p = runs
    assert len(p["beams"]) == len(j["beams"]) == NINT
    assert p["beams"][0].shape == (1, NBEAM, NCHAN)
    _close(p["beams"], j["beams"])
    nout = NINT - MAX_DELAY
    assert len(p["dedispersed"]) == len(j["dedispersed"]) == nout
    assert p["dedispersed"][0].shape == (NBEAM, MAX_DELAY, 1)
    _close(p["dedispersed"], j["dedispersed"])


def test_candidates_ledger_and_rings(runs):
    _, j, p = runs
    assert p["det"].candidates == j["det"].candidates == []
    s = p["ledger"].summary()
    assert s == {k: j["ledger"].summary()[k] for k in s}
    assert s["lost_frames"] == s["duplicated_frames"] == 0
    assert s["committed_frames"] == NINT - MAX_DELAY
    spaces = {r.name: r.space for r in p["pipe"].rings}
    assert p["pipe"].blocks[0].orings[0].space == "system"   # the replay
    for name in ("fengine_h2d", "fengine_pfb", "bengine", "bdetect_t",
                 "bdetect_fdmt"):
        assert spaces[name + ".out0"] == "cuda"
    blocks = {b.name: b for b in p["pipe"].blocks}
    assert blocks["fengine_pfb"]._raw_reads == NINT
    assert blocks["fengine_pfb"].plan_report()["method"] == "cuda"


def test_ci4_voltages_match_their_ci8_twin(runs):
    """The same values as packed ci4 bytes, stated by voltage_dtype='ci4':
    beam powers and dedispersed gulps bitwise the ci8 run's, the PFB
    reading both raw.  A dtype that does not match the array raises."""
    volt, _, p = runs
    packed = ((volt[..., 0] & 0xF).astype(np.uint8) << 4) | \
        (volt[..., 1] & 0xF).astype(np.uint8)
    q = _port_chain(packed, voltage_dtype="ci4")
    for key in ("beams", "dedispersed"):
        assert len(q[key]) == len(p[key])
        assert all(np.array_equal(a, b) for a, b in zip(q[key], p[key]))
    blocks = {b.name: b for b in q["pipe"].blocks}
    assert blocks["fengine_pfb"]._raw_reads == NINT
    for v, dt in ((packed, "ci8"), (volt, "ci4")):
        with pytest.raises(TypeError, match="voltage_dtype"):
            _port_chain(v, voltage_dtype=dt)
    with pytest.raises(ValueError, match="voltage_dtype"):
        _port_chain(volt, voltage_dtype="ci2")


def test_beam_power_golden(runs):
    """p[b, c] = sum_t |sum_i w[b, i] s[t, c, i]|**2 per integration over
    the f64 scipy + np.fft PFB golden (benchmarks/e2e_tpu.py:286-298,
    384-410), rel err <= 1e-4."""
    from scipy.signal import lfilter
    volt, _, p = runs
    x = volt[..., 0].astype(np.float64) + 1j * volt[..., 1]
    c = pfb_coeffs(NCHAN, NTAP)
    frames = x.reshape((-1, NCHAN) + x.shape[1:])
    z = np.empty_like(frames)
    for k in range(NCHAN):
        z[:, k] = lfilter(c[:, k], [1.0], frames[:, k], axis=0)
    s = np.fft.fft(z, axis=1).reshape(-1, NCHAN, NSTAND * NPOL)
    w = default_beam_weights(NBEAM, NSTAND * NPOL).astype(np.complex128)
    beams = np.einsum("bi,tci->tbc", w, s)
    power = beams.real ** 2 + beams.imag ** 2
    golden = np.stack([power[k:k + N_INT].sum(axis=0)
                       for k in range(0, len(power), N_INT)])
    out = np.concatenate(p["beams"])
    assert out.shape == golden.shape
    err = np.abs(out - golden).max() / np.abs(golden).max()
    assert np.isfinite(err) and err <= 1e-4


def test_carried_parameters_and_split_gulps(runs):
    """The JAX plans' parameters carried over (`carry_over`) give the
    port's default run bitwise, the port's FDMT plan has the JAX plan's
    tables, and one spectrum per gulp (integration boundaries inside
    every fourth gulp) gives the same outputs bitwise."""
    volt, j, p = runs
    jbf, jpfb, jfd = j["b"].bf, j["f"].pfb, j["d"].fdmt
    args = carry_over(
        weight_planes=tuple(np.asarray(a) for a in jbf._w_planes),
        nbeam=jbf.nbeam, nsp=jbf.nsp,
        pfb_bank=np.asarray(jpfb.staged_bank(NSTAND * NPOL, 2)),
        nchan=NCHAN,
        fdmt_tables={k: getattr(jfd, k) for k in
                     ("_steps", "_buckets", "_init_perm",
                      "_init_chans_by_d")},
        fdmt_geometry=dict(nchan=jfd.nchan, max_delay=jfd.max_delay,
                           f0=jfd.f0, df=jfd.df, exponent=jfd.exponent))
    np.testing.assert_array_equal(
        args["weights"], default_beam_weights(NBEAM, NSTAND * NPOL))
    np.testing.assert_array_equal(
        args["coeffs"], pfb_coeffs(NCHAN, NTAP).astype(np.float32))
    pfd = {b.name: b for b in p["pipe"].blocks}["bdetect_fdmt"].fdmt
    mine, theirs = pfd.tables(), args["fdmt"].tables()
    for a, b in zip(mine["_steps"], theirs["_steps"]):
        for ta, tb in zip(a, b):
            np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(mine["_init_perm"], theirs["_init_perm"])
    carried = _port_chain(volt, weights=args["weights"],
                          coeffs=args["coeffs"])
    split = _port_chain(volt, gulp=NCHAN)
    for other in (carried, split):
        for key in ("beams", "dedispersed"):
            assert len(other[key]) == len(p[key])
            for a, b in zip(other[key], p[key]):
                np.testing.assert_array_equal(a, b)
