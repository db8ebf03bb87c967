"""The zero-copy host plane on the port's chains: the FRB search
(`frb_search_pipeline`) and the ci8 beam search
(`lwa_beam_search_pipeline`, unfused and fused) built on the CPU with the
source publishing its gulps (`ArraySourceBlock.zero_copy`, True by
default) and copying them (the attribute set to False on the built
pipeline): the outputs are bitwise equal to each other
and hold the JAX chains as before (the FRB search bitwise, the beam
search within test_torch_bengine_chain.py's 1e-5 of the peak), and the
zero-copy runs published every gulp."""

import numpy as np
import pytest

from bifrost_tpu_torch.service import (default_beam_weights,
                                       frb_search_pipeline,
                                       lwa_beam_search_pipeline)
from test_torch_bengine_chain import (MAX_DELAY as B_MAX_DELAY, N_INT,
                                      NBEAM, NCHAN as B_NCHAN, NINT, NPOL,
                                      NSTAND, NTAP, F0 as B_F0, DT as B_DT,
                                      GULP as B_GULP, _close, _voltages,
                                      _jax_chain as _jax_beams)
from test_torch_frb_chain import (DF, DT, F0, GULP, MAX_DELAY, NGULP,
                                  THRESHOLD, _data, _jax_chain as _jax_frb)


def _source_ring(pipe):
    return next(r for r in pipe.rings
                if type(r.owner).__name__ == "ArraySourceBlock")


def _frb(data, zero_copy):
    chunks = []
    pipe, det, _ = frb_search_pipeline(
        data, GULP, MAX_DELAY, F0, DF, DT, threshold=THRESHOLD,
        device="cpu", gather=chunks)
    _source_ring(pipe).owner.zero_copy = zero_copy
    pipe.run()
    return chunks, det.candidates, _source_ring(pipe).published_spans


def test_frb_search_zero_copy_equals_copying_and_jax():
    data = _data()
    before = data.copy()
    zc, zc_cands, published = _frb(data, True)
    cp, cp_cands, copied = _frb(data, False)
    assert (published, copied) == (NGULP, 0)
    assert len(zc) == len(cp) == NGULP
    for a, b in zip(zc, cp):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert zc_cands == cp_cands and zc_cands
    jchunks, jdet, _ = _jax_frb(data)
    for a, j in zip(zc, jchunks):
        np.testing.assert_array_equal(
            a.view(np.uint32), np.asarray(j, np.float32).view(np.uint32))
    # The publisher's array is read, never written.
    np.testing.assert_array_equal(data, before)


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_beam_search_zero_copy_equals_copying_and_jax(fuse):
    volt = _voltages()
    runs = {}
    for zc in (True, False):
        g = {"beams": [], "dedispersed": []}
        pipe, _, _ = lwa_beam_search_pipeline(
            volt, nstand=NSTAND, npol=NPOL, nchan=B_NCHAN, ntap=NTAP,
            n_int=N_INT, nbeam=NBEAM, max_delay=B_MAX_DELAY, f0_mhz=B_F0,
            dt_s=B_DT, gulp_nframe=B_GULP, device="cpu", gather=g,
            fuse=fuse)
        _source_ring(pipe).owner.zero_copy = zc
        pipe.run()
        runs[zc] = (g, _source_ring(pipe).published_spans)
    (zg, published), (cg, copied) = runs[True], runs[False]
    assert (published, copied) == (NINT, 0)
    for key in ("beams", "dedispersed"):
        assert len(zg[key]) == len(cg[key]) > 0
        for a, b in zip(zg[key], cg[key]):
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
    j = _jax_beams(volt, default_beam_weights(NBEAM, NSTAND * NPOL))
    _close(zg["beams"], j["beams"])
    _close(zg["dedispersed"], j["dedispersed"])
