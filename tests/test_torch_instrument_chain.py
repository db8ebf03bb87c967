"""The whole LWA instrument end to end: the port's
`lwa_instrument_pipeline(device='cpu')` against the JAX package's
`lwa_instrument_spec(voltages=..., fuse=False, pallas_interpret=True)`
run through `service.Service`, as benchmarks/e2e_tpu.py:154-210 runs it,
at that file's GEOM (:150-151) on seeded voltages: both engine branches
fanned out from one PFB ring, the imaging branch ending in `on_image`.

The port grids with the numbers the JAX plans used: the JAX gridder's
host plan state and the X-engine gains are carried over
(`weights.carry_over`).

Tolerances:
- Images, port against JAX: 1e-5 of the image peak.  Each image is the
  FFT of gridded visibilities, each visibility a sum over n_int spectra
  of products of two PFB outputs, which agree to (8 nchan) 2**-24 of
  their peak (the DFT's summation order, test_torch_bengine_chain.py);
  the product doubles that, the sums over n_int spectra, over a grid
  cell's <= 36 contributions and through the FFT's log2(ngrid**2) = 8
  stages add (n_int + 36 + 8) 2**-24 relative to the sum of magnitudes,
  which at this geometry is within a factor of 2 of the peak: about
  (2 * 32 + 47) * 2 * 2**-24 = 1.3e-5 in the worst case and far less in
  practice, where the errors are not all of one sign.  Measured: below
  1e-6.
- Beam powers and dedispersed frames: 1e-5 of their peak
  (test_torch_bengine_chain.py's bound).
- Candidates and the frame ledger: identical.
- Images against an f64 numpy golden (the scipy/FFT PFB golden, then
  s^H s per integration, `np.add.at` gridding and `np.fft.fft2`): rel
  1e-4 of the peak, benchmarks/e2e_tpu.py's own limit.
"""

import numpy as np
import pytest

from bifrost_tpu_torch.ndarray import pair_to_structured
from bifrost_tpu_torch.ops import pfb_coeffs
from bifrost_tpu_torch.service import (default_grid_kernel, default_uvw,
                                       lwa_instrument_pipeline)
from bifrost_tpu_torch.weights import carry_over

GEOM = dict(nstand=3, npol=2, nchan=4, ntap=4, n_int=3, nbeam=2, ngrid=16,
            max_delay=4)
NINT = 8                                  # integrations in the stream
NFRAME = NINT * GEOM["n_int"] * GEOM["nchan"]
TOL = 1e-5


def _voltages(seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 8, (NFRAME, GEOM["nstand"], GEOM["npol"], 2)) \
        .astype(np.int8)


def _gains(seed=8):
    rng = np.random.default_rng(seed)
    shape = (GEOM["nstand"], GEOM["npol"])
    return (rng.integers(1, 4, shape) + 1j * rng.integers(-2, 3, shape)) \
        .astype(np.complex64)


def _jax(volt, kernels, gains):
    from bifrost_tpu import service
    images, cands = [], []
    spec = service.lwa_instrument_spec(
        voltages=pair_to_structured(volt), fuse=False, pallas_interpret=True,
        kernels=kernels, gains=gains,
        on_image=lambda d: images.append(np.array(d)),
        on_candidate=cands.append, **GEOM)
    svc = service.Service(spec, name="instrument_ref")
    svc.start()
    finished = svc.wait(timeout=300)
    svc.stop()
    assert finished and svc._run_error is None
    blocks = {b.name: b for b in svc.pipeline.blocks}
    return {"images": images, "candidates": cands, "ledger": svc.ledger,
            "romein": blocks["image_grid"].romein,
            "gains": blocks["xengine"].gains}


def _port(volt, **kwargs):
    images, cands = [], []
    gather = {"beams": [], "dedispersed": []}
    pipe, det, ledger = lwa_instrument_pipeline(
        volt, device="cpu", on_image=lambda d: images.append(d.numpy().copy()),
        on_candidate=cands.append, gather=gather, fuse=False, **GEOM,
        **kwargs)
    pipe.run()
    return dict(gather, images=images, candidates=cands, ledger=ledger,
                det=det, pipe=pipe)


def _non_rank1_kernels():
    nvis = (GEOM["nstand"] * GEOM["npol"]) ** 2
    rng = np.random.default_rng(9)
    return (rng.standard_normal((1, nvis, 3, 3)) +
            1j * rng.standard_normal((1, nvis, 3, 3))).astype(np.complex64)


@pytest.fixture(scope="module", params=["default", "non_rank1"])
def runs(request):
    volt = _voltages()
    kernels = None if request.param == "default" else _non_rank1_kernels()
    j = _jax(volt, kernels, _gains())
    args = carry_over(romein_state=(j["romein"]._pos_np,
                                    j["romein"]._kern_np),
                      gains=j["gains"])
    p = _port(volt, uvw=args["positions"], kernels=args["kernels"],
              gains=args["gains"])
    return request.param, volt, j, p


def _close(a, b, tol):
    a, b = np.concatenate(a), np.concatenate(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.isfinite(a).all()
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= tol, err


def test_images_match_jax(runs):
    kind, _, j, p = runs
    assert len(p["images"]) == len(j["images"]) == NINT
    assert p["images"][0].shape == (GEOM["nchan"], GEOM["ngrid"],
                                    GEOM["ngrid"], 1)
    assert p["images"][0].dtype == np.complex64
    _close(p["images"], j["images"], TOL)
    grid = {b.name: b for b in p["pipe"].blocks}["image_grid"]
    rep = grid.plan_report()
    assert rep["method"] == "cuda"
    assert rep["kernel"] == ("separable" if kind == "default"
                             else "general")
    np.testing.assert_array_equal(grid.romein.positions,
                                  j["romein"]._pos_np)


def test_b_branch_candidates_and_ledger_match_jax(runs):
    from bifrost_tpu_torch.service import lwa_beam_search_pipeline
    _, volt, j, p = runs
    assert p["candidates"] == j["candidates"]
    s = p["ledger"].summary()
    assert s == {k: j["ledger"].summary()[k] for k in s}
    assert s["lost_frames"] == s["duplicated_frames"] == 0
    assert s["committed_frames"] == NINT - GEOM["max_delay"]
    # the B branch, fanned out beside the X branch, is the beam search
    g = {"beams": [], "dedispersed": []}
    geom = {k: v for k, v in GEOM.items() if k != "ngrid"}
    lwa_beam_search_pipeline(volt, device="cpu", gather=g, fuse=False,
                             **geom)[0].run()
    for key in ("beams", "dedispersed"):
        assert len(p[key]) == len(g[key]) > 0
        for a, b in zip(p[key], g[key]):
            np.testing.assert_array_equal(a, b)


def test_images_match_f64_golden(runs):
    """The PFB golden (scipy lfilter + np.fft), s^H s per integration,
    np.add.at gridding with the carried positions and kernels, fft2."""
    from scipy.signal import lfilter
    kind, volt, j, p = runs
    nchan, ntap, n_int = GEOM["nchan"], GEOM["ntap"], GEOM["n_int"]
    ngrid = GEOM["ngrid"]
    nsp = GEOM["nstand"] * GEOM["npol"]
    x = (volt[..., 0].astype(np.float64) + 1j * volt[..., 1]) * \
        _gains().astype(np.complex128)
    c = pfb_coeffs(nchan, ntap)
    frames = x.reshape((-1, nchan) + x.shape[1:])
    z = np.empty_like(frames)
    for k in range(nchan):
        z[:, k] = lfilter(c[:, k], [1.0], frames[:, k], axis=0)
    s = np.fft.fft(z, axis=1).reshape(-1, n_int, nchan, nsp)
    vis = np.einsum("ktci,ktcj->kcij", np.conj(s), s).reshape(
        NINT, nchan, nsp * nsp)
    pos = j["romein"]._pos_np.reshape(2, -1)
    kern = np.broadcast_to(j["romein"]._kern_np, (1, nsp * nsp, 3, 3)) \
        .astype(np.complex128)[0]
    grid = np.zeros((NINT, nchan, ngrid, ngrid), np.complex128)
    for jj in range(3):
        for kk in range(3):
            yy, xx = pos[1] + jj, pos[0] + kk
            ok = (yy >= 0) & (yy < ngrid) & (xx >= 0) & (xx < ngrid)
            np.add.at(grid, (slice(None), slice(None), yy[ok], xx[ok]),
                      vis[..., ok] * kern[ok, jj, kk])
    golden = np.fft.fft2(grid, axes=(-2, -1))
    got = np.stack(p["images"])[..., 0]
    err = np.abs(got - golden).max() / np.abs(golden).max()
    assert np.isfinite(err) and err <= 1e-4


def test_defaults_are_the_specs():
    from bifrost_tpu import service
    volt = _voltages()[:GEOM["nchan"] * GEOM["n_int"]]
    spec = service.lwa_instrument_spec(voltages=pair_to_structured(volt),
                                       fuse=False, **GEOM)
    svc = service.Service(spec, name="instrument_defaults")
    svc.start()
    assert svc.wait(timeout=300)
    svc.stop()
    r = {b.name: b for b in svc.pipeline.blocks}["image_grid"].romein
    uvw = default_uvw(GEOM["nstand"], GEOM["npol"], GEOM["ngrid"])
    np.testing.assert_array_equal(uvw, r._pos_np)
    assert uvw.dtype == r._pos_np.dtype
    np.testing.assert_array_equal(default_grid_kernel(), r._kern_np)
    pipe = lwa_instrument_pipeline(volt, device="cpu", engine="int8",
                                   fuse=False, **GEOM)[0]
    x = {b.name: b for b in pipe.blocks}["xengine"]
    assert x.engine == "int8"
    with pytest.raises(ValueError, match="engine"):
        lwa_instrument_pipeline(volt, device="cpu", engine="bf16", **GEOM)


def _pfb_int8(volt):
    """The F-engine's output cast to int8 as the X-engine casts it, from
    the JAX `Pfb` and the port's, on the same voltages."""
    import torch
    from bifrost_tpu.ops.pfb import Pfb as JPfb
    from bifrost_tpu_torch.blocks.correlate import int8_pairs
    from bifrost_tpu_torch.ops.pfb import Pfb as PPfb
    x = (volt[..., 0] + 1j * volt[..., 1].astype(np.float32)) \
        .astype(np.complex64)
    jp = JPfb(method="jnp")
    jp.init(GEOM["nchan"], ntap=GEOM["ntap"])
    jy = np.array(jp.execute(x))
    pp = PPfb(method="plain")
    pp.init(GEOM["nchan"], ntap=GEOM["ntap"])
    py = pp.execute(torch.from_numpy(x))
    return (int8_pairs(torch.from_numpy(jy)), int8_pairs(py),
            np.abs(jy).max())


def test_int8_engine_matches_jax():
    """engine='int8' end to end against JAX lwa_instrument_spec(engine=
    'int8'): full-range ci8 voltages drive the PFB output past +-127 and
    through fractions, so the X-engine's saturating, truncating cast is
    exercised.  The two PFBs round apart (their DFTs sum in other
    orders), and a cast can flip where an output lies within that
    rounding of an integer; the test first checks that the two casts
    agree on this input, so the X-engine sees the same int8 planes and
    the images fall within TOL as the f32 engine's do."""
    rng = np.random.default_rng(17)
    volt = rng.integers(-128, 128, (NFRAME, GEOM["nstand"], GEOM["npol"],
                                    2)).astype(np.int8)
    j8, p8, peak = _pfb_int8(volt)
    assert peak > 127 and (np.abs(p8.numpy()) == 127).any()
    assert np.array_equal(j8.numpy(), p8.numpy())
    from bifrost_tpu import service
    images = []
    spec = service.lwa_instrument_spec(
        voltages=pair_to_structured(volt), fuse=False, engine="int8",
        pallas_interpret=True, on_image=lambda d: images.append(np.array(d)),
        **GEOM)
    svc = service.Service(spec, name="instrument_int8_ref")
    svc.start()
    assert svc.wait(timeout=300)
    svc.stop()
    assert svc._run_error is None
    r = {b.name: b for b in svc.pipeline.blocks}["image_grid"].romein
    args = carry_over(romein_state=(r._pos_np, r._kern_np))
    p = _port(volt, uvw=args["positions"], kernels=args["kernels"],
              engine="int8")
    assert len(p["images"]) == len(images) == NINT
    _close(p["images"], images, TOL)
