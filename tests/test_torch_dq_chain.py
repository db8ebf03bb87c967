"""The data-quality plane end to end on the CPU, the port against the
JAX package on the same seeded numpy input:

- the flagged FRB search: `frb_search_pipeline(rfi_flag=...)` against
  the body of `frb_search_spec` run through the JAX `Service` (a custom
  array source, then the flag, transpose, fdmt and detect stages), on a
  narrowband storm.  u8 power keeps the flagger's statistics and every
  FDMT sum exact, so the dedispersed gulps are bitwise equal (the FRB
  chain test's tolerance), and the candidates and ledgers equal;
- the flagged, calibrated beam search (ci8 -> PFB -> rfi_flag -> gaincal
  -> beamform -> transpose -> FDMT -> detect) built from blocks on both
  sides, at toy geometry with a tone on one station: the masks equal,
  the beam powers and dedispersed frames within the bengine chain
  test's 1e-5 of their peak (the DFT and K5b round differently);
- the `dq_flag_method` / `dq_cal_method` latch.
"""

import time

import numpy as np
import pytest

from bifrost_tpu_torch import config
from bifrost_tpu_torch.blocks.testing import (inject_burst, inject_tone,
                                              narrowband_storm)
from bifrost_tpu_torch.ndarray import pair_to_structured
from bifrost_tpu_torch.service import (default_beam_weights,
                                       frb_search_pipeline)

NCHAN, MAX_DELAY, GULP, NGULP = 64, 32, 128, 6
F0, DF, DT = 40.0, 0.00928, 1e-3
DM_ROW, T0 = 20, 4 * GULP + 40
FLAG = dict(algo="mad", thresh=6.0, mad_factor=4.0, window=16)


def _storm_data():
    rng = np.random.default_rng(2024)
    data = rng.integers(0, 32, (GULP * NGULP, NCHAN)).astype(np.uint8)
    inject_burst(data, T0, DM_ROW, F0, DF, amp=60)
    chans, on = narrowband_storm(data, frame0=2 * GULP, n_storm=6,
                                 seed=7)
    return data, chans, on


def _jax_service(data):
    from bifrost_tpu.blocks.testing import array_source, gather_sink
    from bifrost_tpu.service import Service, ServiceSpec, StageSpec
    chunks = []

    def tap(up, **kw):
        gather_sink(up, chunks, gulp_nframe=GULP)
        return up

    spec = ServiceSpec([
        StageSpec("custom", name="capture", params=dict(
            factory=lambda _up, **kw: array_source(data, GULP, header={
                "labels": ["time", "freq"],
                "scales": [[0.0, DT], [F0, DF]], "units": ["s", "MHz"]}))),
        StageSpec("flag", params=dict(FLAG, gulp_nframe=GULP)),
        StageSpec("transpose", params=dict(axes=["freq", "time"],
                                           gulp_nframe=GULP)),
        StageSpec("fdmt", params=dict(max_delay=MAX_DELAY,
                                      gulp_nframe=GULP)),
        StageSpec("custom", name="tap", params=dict(factory=tap)),
        StageSpec("detect", params=dict(threshold=8.0, gulp_nframe=GULP)),
    ], heartbeat_interval_s=1.0, heartbeat_misses=60)
    svc = Service(spec)
    svc.start()
    deadline = time.monotonic() + 120.0
    while svc.running and time.monotonic() < deadline:
        time.sleep(0.05)
    report = svc.stop()
    return chunks, svc.blocks["detect"], report.ledger, svc.blocks["flag"]


@pytest.fixture(scope="module")
def frb_runs():
    data, chans, on = _storm_data()
    jchunks, jdet, jledger, jflag = _jax_service(data)
    pchunks = []
    pipe, pdet, pledger = frb_search_pipeline(
        data, GULP, MAX_DELAY, F0, DF, DT, device="cpu", gather=pchunks,
        rfi_flag=FLAG)
    pipe.run()
    pflag = {b.name: b for b in pipe.blocks}["flag"]
    return (jchunks, jdet, jledger, jflag), (pchunks, pdet, pledger, pflag), \
        chans, on


def test_flagged_frb_chain_matches_jax_service(frb_runs):
    (jc, jdet, jled, jflag), (pc, pdet, pled, pflag), chans, on = frb_runs
    assert len(pc) == len(jc) == NGULP
    for j, p in zip(jc, pc):
        j = np.asarray(j, np.float32)
        assert p.shape == j.shape
        np.testing.assert_array_equal(p.view(np.uint32), j.view(np.uint32))
    assert pdet.candidates == jdet.candidates
    best = max(pdet.candidates, key=lambda c: c["snr"])
    assert abs(best["dm_index"] - DM_ROW) <= 2
    assert abs(best["frame"] - (T0 - MAX_DELAY)) <= 2
    s = pled.summary()
    assert s == {k: jled[k] for k in s}
    assert s["lost_frames"] == s["duplicated_frames"] == 0
    assert s["committed_frames"] == GULP * NGULP - MAX_DELAY
    assert pflag.flagged_fraction == jflag.flagged_fraction > 0
    np.testing.assert_array_equal(pflag.last_mask, jflag.last_mask)


def test_storm_cells_flagged(frb_runs):
    """Every storm cell on for more than half of a window's frames is
    flagged in that window (the last gulp's masks)."""
    _, (_, _, _, pflag), chans, on = frb_runs
    w = FLAG["window"]
    last = on[-GULP:].reshape(GULP // w, w, len(chans)).sum(axis=1) > w // 2
    assert last.any()
    assert pflag.last_mask[:, chans][last].all()
    assert pflag.plan_report()["method"] == "cuda"


# --------------------------------------------- flagged, calibrated B
NSTAND, NPOL, BCHAN, NTAP, N_INT, NBEAM, B_MAX_DELAY = 3, 2, 8, 4, 4, 2, 4
NINT = 10
B_GULP = N_INT * BCHAN
TONE = dict(t0=4 * B_GULP, station=1, chan=3, nchan=BCHAN, amp=40)


def _voltages():
    rng = np.random.default_rng(5)
    v = rng.integers(-8, 8, (NINT * B_GULP, NSTAND, NPOL, 2)).astype(np.int8)
    inject_tone(v, **TONE)
    return v


def _gains():
    rng = np.random.default_rng(6)
    return (0.5 + rng.random(NSTAND) +
            0.3j * rng.standard_normal(NSTAND)).astype(np.complex64)


def _bchain(side, volt, g, w):
    if side == "jax":
        from bifrost_tpu import blocks
        from bifrost_tpu.blocks.testing import array_source, gather_sink
        from bifrost_tpu.pipeline import Pipeline
        from bifrost_tpu.service import CandidateDetectBlock, FrameLedger
        space, pkw, volt = "tpu", {}, pair_to_structured(volt)
    else:
        from bifrost_tpu_torch import blocks
        from bifrost_tpu_torch.blocks import array_source, gather_sink
        from bifrost_tpu_torch.pipeline import Pipeline
        from bifrost_tpu_torch.service import (CandidateDetectBlock,
                                               FrameLedger)
        space, pkw = "cuda", {"device": "cpu"}
    beams, dd, masks = [], [], []
    ledger = FrameLedger()
    with Pipeline(**pkw) as pipe:
        src = array_source(volt, B_GULP, header={
            "dtype": "ci8", "labels": ["time", "station", "pol"],
            "scales": [[0.0, 1e-6], None, None], "units": ["s", None, None],
            "cfreq": 40.0, "cfreq_units": "MHz"})
        f = blocks.pfb(blocks.copy(src, space=space), BCHAN, ntap=NTAP)
        fl = blocks.rfi_flag(f, window=N_INT, algo="mad",
                             on_mask=masks.append)
        cal = blocks.gaincal(fl, g, axis="station")
        b = blocks.beamform(cal, w, nframe_per_integration=N_INT)
        t = blocks.transpose(b, ["beam", "freq", "time"])
        d = blocks.fdmt(t, max_delay=B_MAX_DELAY)
        det = CandidateDetectBlock(d, threshold=8.0)
        det.ledger = ledger
        gather_sink(b, beams)
        gather_sink(d, dd)
        pipe.run()
    return {"beams": [np.asarray(a) for a in beams],
            "dedispersed": [np.asarray(a) for a in dd],
            "masks": [np.asarray(m) for m in masks], "det": det,
            "ledger": ledger, "cal": cal}


@pytest.fixture(scope="module")
def b_runs():
    volt, g = _voltages(), _gains()
    w = default_beam_weights(NBEAM, NSTAND * NPOL)
    return _bchain("jax", volt, g, w), _bchain("port", volt, g, w)


def test_flagged_calibrated_beam_search_matches_jax(b_runs):
    j, p = b_runs
    assert len(p["masks"]) == len(j["masks"]) == NINT
    for a, b in zip(p["masks"], j["masks"]):
        assert a.shape == (1, BCHAN, NSTAND, NPOL)
        np.testing.assert_array_equal(a, b)
    # the tone's cells are flagged in every window from its onset
    onset = TONE["t0"] // B_GULP
    for m in p["masks"][onset:]:
        assert m[0, TONE["chan"], TONE["station"]].all()
    for key, n in (("beams", NINT), ("dedispersed", NINT - B_MAX_DELAY)):
        a, b = np.concatenate(p[key], -1), np.concatenate(j[key], -1)
        assert len(p[key]) == len(j[key]) == n
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert p["det"].candidates == j["det"].candidates
    s = p["ledger"].summary()
    assert s == {k: j["ledger"].summary()[k] for k in s}
    assert s["committed_frames"] == NINT - B_MAX_DELAY


def test_gaincal_equals_the_weight_fold(b_runs):
    """gaincal(g) -> beamform(w) against beamform(w, gains=g) on the
    same flagged stream: one calibrates the samples (K5b), the other the
    weights."""
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.pipeline import Pipeline
    volt, g = _voltages(), _gains()
    w = default_beam_weights(NBEAM, NSTAND * NPOL)
    a, b = [], []
    with Pipeline(device="cpu") as pipe:
        src = blocks.array_source(volt, B_GULP, header={
            "dtype": "ci8", "labels": ["time", "station", "pol"]})
        f = blocks.pfb(blocks.copy(src, space="cuda"), BCHAN, ntap=NTAP)
        fl = blocks.rfi_flag(f, window=N_INT)
        cal = blocks.gaincal(fl, g, axis="station")
        blocks.gather_sink(blocks.beamform(cal, w, N_INT), a)
        blocks.gather_sink(blocks.beamform(fl, w, N_INT, gains=g), b)
        pipe.run()
    a, b = np.concatenate(a), np.concatenate(b)
    assert a.shape == b.shape == (NINT, NBEAM, BCHAN)
    assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert b_runs[1]["cal"].plan_report()["ngain"] == BCHAN * NSTAND * NPOL


def test_dq_method_flags_latch_per_sequence():
    """Both flags are read once per sequence and latched while it runs;
    more gulps than the rings hold, so the blocks wait for the sink
    while it pokes the flags (ROADMAP Queue C's race note)."""
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.pipeline import Pipeline
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((16 * 32, 6)) +
         1j * rng.standard_normal((16 * 32, 6))).astype(np.complex64)
    errs = []

    def poke(_):
        for name in ("dq_flag_method", "dq_cal_method"):
            try:
                config.set(name, "plain")
            except RuntimeError as e:
                errs.append(str(e))

    def run():
        with Pipeline(device="cpu") as pipe:
            src = blocks.array_source(x, 16)
            fl = blocks.rfi_flag(blocks.copy(src, space="cuda"), window=16)
            cal = blocks.gaincal(fl, np.ones(6, np.complex64))
            blocks.callback_sink(cal, on_data=poke)
            pipe.run()
        return fl, cal

    try:
        fl, cal = run()
        assert any("dq_flag_method" in e for e in errs)
        assert any("dq_cal_method" in e for e in errs)
        assert fl.plan_report()["method"] == "cuda"
        assert cal.plan_report()["method"] == "cuda"
        config.set("dq_flag_method", "plain")
        config.set("dq_cal_method", "plain")
        fl, cal = run()
        assert fl.plan_report()["method"] == "plain"
        assert cal.plan_report()["method"] == "plain"
    finally:
        config.reset("dq_flag_method")
        config.reset("dq_cal_method")
