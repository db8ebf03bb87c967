"""The port's gridder (bifrost_tpu_torch.ops.romein, kernels K6a/K6b in
their plain versions on the CPU) against the JAX package's `Romein`, in
its 'pallas' method (interpret mode: the one-hot MXU kernels
`_gridder_fn` and `_gridder_sep_fn`) and its 'scatter' method, on the
JAX tests' own geometries (tests/test_ops.py:571-747, :932), and against
their brute-force golden; and the `GridderBlock` and `FftBlock` against
the JAX blocks on a [pol, vis, time] stream.

Tolerance, per grid cell: the port sums a cell's n contributions in one
order and XLA in another, each contribution a complex product of at most
two roundings per part (K6b: two products).  With S the f64 sum over the
cell's contributions of |d| |K| and nmax the largest cell count, each
side is within (nmax + 6) * 2**-24 * S of the exact sum.  Rank-1
kernels are gridded from the factors u, v that `separate_kernels`
accepts when |u v - K| <= 1e-5 max|K| elementwise, which adds 1e-5 *
max|K| * D, D the cell's sum of |d|.  So |port - golden| <= B = (nmax +
6) 2**-24 S (+ 1e-5 max|K| D for rank-1 kernels) against the f64 golden
and |port - jax| <= 2 B.
"""

import numpy as np
import pytest
import torch

from bifrost_tpu import ndarray
from bifrost_tpu.ops import Romein as JRomein
from bifrost_tpu.ops.romein_pallas import (PallasGridder,
                                           separate_kernels as jsep)
from bifrost_tpu_torch import config
from bifrost_tpu_torch.ops import Romein, separate_kernels
from bifrost_tpu_torch.ops.romein import build_plan
from bifrost_tpu_torch.ops.romein_kernel import (grid_general,
                                                 grid_general_plain,
                                                 grid_separable)

EPS = 2.0 ** -24


@pytest.fixture(scope="module", autouse=True)
def _jax_fft_method_default():
    """The JAX references run at the JAX package's default `fft_method`:
    tests/test_fusion.py's latch test sets it from a sink callback, and
    under load a call that lands after the latch is released succeeds and
    stays set in that process ('matmul', 4e-3 off the 'xla' images)."""
    from bifrost_tpu import config as jconfig
    jconfig.reset("fft_method")


def _golden(vis, xs, ys, kern, ngrid):
    """f64 brute force -> (grid, S, D, nmax): the grid, the per-cell sums
    of |d| |K| and of |d|, and the largest number of contributions in a
    cell."""
    npol, ndata = vis.shape
    m = kern.shape[-1]
    kb = np.broadcast_to(kern, (npol, ndata, m, m)).astype(np.complex128)
    grid = np.zeros((npol, ngrid, ngrid), np.complex128)
    mag = np.zeros((npol, ngrid, ngrid))
    dsum = np.zeros((npol, ngrid, ngrid))
    count = np.zeros((ngrid, ngrid), np.int64)
    for d in range(ndata):
        for j in range(m):
            for k in range(m):
                yy, xx = ys[d] + j, xs[d] + k
                if 0 <= yy < ngrid and 0 <= xx < ngrid:
                    c = vis[:, d].astype(np.complex128) * kb[:, d, j, k]
                    grid[:, yy, xx] += c
                    mag[:, yy, xx] += np.abs(vis[:, d]) * \
                        np.abs(kb[:, d, j, k])
                    dsum[:, yy, xx] += np.abs(vis[:, d])
                    count[yy, xx] += 1
    return grid, mag, dsum, int(count.max())


def _jax(vis, pos, kern, ngrid, method):
    plan = JRomein()
    plan.pallas_interpret = True
    plan.init(pos, kern, ngrid, method=method)
    grid = np.zeros((vis.shape[0], ngrid, ngrid), np.complex64) \
        .view(ndarray)
    plan.execute(vis, grid)
    return np.asarray(grid), plan


def _port(vis, pos, kern, ngrid, method="cuda"):
    plan = Romein().init(pos, kern, ngrid, method=method)
    out = plan.execute(torch.from_numpy(vis))
    return out.numpy(), plan


def _cases():
    """The JAX tests' geometries: (name, vis, pos (2, 1, ndata), kern,
    ngrid, rank-1?)."""
    out = []
    np.random.seed(2)                                   # test_ops.py:571
    ngrid, m, nd = 32, 4, 10
    vis = (np.random.rand(1, nd) + 1j * np.random.rand(1, nd)) \
        .astype(np.complex64)
    pos = np.random.randint(0, ngrid - m, (2, 1, nd)).astype(np.int32)
    out.append(("ones_kernel", vis, pos,
                np.ones((1, nd, m, m), np.complex64), ngrid, True))
    rng = np.random.default_rng(11)                     # test_ops.py:658
    ngrid, m, nd, npol = 150, 5, 64, 2
    vis = (rng.standard_normal((npol, nd)) +
           1j * rng.standard_normal((npol, nd))).astype(np.complex64)
    pos = rng.integers(-m, ngrid + 2, (2, 1, nd)).astype(np.int32)
    kern = (rng.standard_normal((npol, nd, m, m)) +
            1j * rng.standard_normal((npol, nd, m, m))).astype(np.complex64)
    out.append(("per_vis_complex_straddling", vis, pos, kern, ngrid, False))
    rng = np.random.default_rng(21)                     # test_ops.py:709
    ngrid, m, nd = 96, 6, 80
    u = (rng.standard_normal((1, nd, m)) +
         1j * rng.standard_normal((1, nd, m))).astype(np.complex64)
    v = (rng.standard_normal((1, nd, m)) +
         1j * rng.standard_normal((1, nd, m))).astype(np.complex64)
    kern = (u[..., :, None] * v[..., None, :]).astype(np.complex64)
    vis = (rng.standard_normal((1, nd)) +
           1j * rng.standard_normal((1, nd))).astype(np.complex64)
    xs = rng.integers(-m, ngrid + 2, nd).astype(np.int32)
    ys = rng.integers(-m, ngrid + 2, nd).astype(np.int32)
    out.append(("rank1_outer_products", vis, np.stack([xs, ys])[:, None],
                kern, ngrid, True))
    rng = np.random.default_rng(12)                     # test_ops.py:687
    ngrid, m, nd = 64, 4, 32
    vis = (rng.standard_normal((1, nd)) +
           1j * rng.standard_normal((1, nd))).astype(np.complex64)
    pos = rng.integers(0, ngrid - m, (2, 1, nd)).astype(np.int32)
    out.append(("shared_plane_many_pols", np.repeat(vis, 3, axis=0), pos,
                np.ones((m, m), np.complex64), ngrid, True))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("method", ["pallas", "scatter"])
def test_gridding_matches_jax_and_golden(case, method):
    name, vis, pos, kern, ngrid, rank1 = case
    want, jplan = _jax(vis, pos, kern, ngrid, method)
    got, plan = _port(vis, pos, kern, ngrid)
    if method == "pallas":
        assert jplan.last_method == "pallas"
    assert plan.separable is rank1
    assert plan.plan_report()["kernel"] == \
        ("separable" if rank1 else "general")
    golden, mag, dsum, nmax = _golden(vis, pos[0, 0], pos[1, 0], kern,
                                      ngrid)
    bound = (nmax + 6) * EPS * mag
    if rank1:
        bound = bound + 1e-5 * np.abs(kern).max() * dsum
    assert got.shape == want.shape == golden.shape
    assert np.isfinite(got).all()
    assert (np.abs(got - golden) <= bound + 1e-30).all()
    assert (np.abs(got - want) <= 2 * bound + 1e-30).all()


def test_negative_positions_drop():
    """A patch west and north of the grid drops, only its in-grid corner
    lands (the JAX regression test_romein_scatter_drops_negative_positions;
    jax's .at[] would wrap index -1 onto the far edge)."""
    ngrid, m = 16, 4
    vis = np.ones((1, 1), np.complex64)
    pos = np.array([-2, -2]).reshape(2, 1, 1).astype(np.int32)
    kern = np.ones((1, 1, m, m), np.complex64)
    got, _ = _port(vis, pos, kern, ngrid)
    want, _ = _jax(vis, pos, kern, ngrid, "scatter")
    golden = np.zeros((1, ngrid, ngrid), np.complex64)
    golden[0, 0:2, 0:2] = 1.0
    np.testing.assert_array_equal(got, golden)
    np.testing.assert_array_equal(want, golden)
    # every side: east and south of the grid drop too
    pos = np.array([[[ngrid - 1, -3]], [[ngrid - 2, ngrid - 1]]], np.int32)
    vis = np.ones((1, 2), np.complex64)
    kern = np.ones((1, 2, m, m), np.complex64)
    got, _ = _port(vis, pos, kern, ngrid)
    golden = np.zeros((1, ngrid, ngrid), np.complex64)
    golden[0, ngrid - 2:, ngrid - 1] = 1.0
    golden[0, ngrid - 1, 0] = 1.0
    np.testing.assert_array_equal(got, golden)


@pytest.mark.parametrize("case", CASES + [
    ("non_rank1", None, None,
     (np.random.default_rng(3).standard_normal((1, 8, 4, 4)) +
      1j * np.random.default_rng(4).standard_normal((1, 8, 4, 4)))
     .astype(np.complex64), None, False),
    ("zero_kernel", None, None, np.zeros((2, 3, 3, 3), np.complex64), None,
     True)], ids=[c[0] for c in CASES] + ["non_rank1", "zero_kernel"])
def test_separate_kernels_bitwise_vs_jax(case):
    kern = np.asarray(case[3])
    kern = kern.reshape((1,) * (4 - kern.ndim) + kern.shape)
    mine, theirs = separate_kernels(kern), jsep(kern)
    assert (mine is None) == (theirs is None) == (not case[5])
    if mine is not None:
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype == np.complex64
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))
    # the JAX planner takes the same branch
    if kern.shape[1] > 1:
        g = PallasGridder(np.zeros(kern.shape[1], np.int32),
                          np.zeros(kern.shape[1], np.int32), kern, 32,
                          kern.shape[-1], kern.shape[0], interpret=True,
                          chunk=8)
        assert g.separable == case[5]


@pytest.mark.parametrize("case", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_reruns_bitwise_equal_and_accumulate(case):
    _, vis, pos, kern, ngrid, _ = case
    a, plan = _port(vis, pos, kern, ngrid)
    b, _ = _port(vis, pos, kern, ngrid)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    # execute adds onto a given grid (the JAX execute's grid + gridded)
    g0 = torch.from_numpy(np.full(a.shape, 1 + 2j, np.complex64))
    plan.execute(torch.from_numpy(vis), g0)
    np.testing.assert_array_equal(
        g0.numpy().view(np.uint32),
        (np.full(a.shape, 1 + 2j, np.complex64) + a).view(np.uint32))


def test_plan_keeps_broadcast_kernels_and_cpu_runs_plain():
    """A shared kernel stays one plane, a per-visibility one stays one
    plane per visibility; the plan lists each in-grid contribution once,
    sorted by cell; on the CPU the wrappers run the plain version and
    count no launch."""
    ngrid, m, nd, npol = 20, 3, 30, 5
    rng = np.random.default_rng(9)
    pos = rng.integers(-2, ngrid, (2, nd)).astype(np.int32)
    vis = (rng.standard_normal((npol, nd)) +
           1j * rng.standard_normal((npol, nd))).astype(np.complex64)
    ns = (rng.standard_normal((1, nd, m, m)) +
          1j * rng.standard_normal((1, nd, m, m))).astype(np.complex64)
    plan = Romein().init(pos, ns, ngrid)
    grid = plan.execute(torch.from_numpy(vis))
    p = plan._last_plan
    assert not p.separable and tuple(p.kern.shape) == (1, nd, m, m)
    plan2 = Romein().init(pos, np.ones((m, m), np.complex64), ngrid)
    plan2.execute(torch.from_numpy(vis))
    p2 = plan2._last_plan
    assert p2.separable and tuple(p2.u.shape) == (1, 1, m)
    off, ent = build_plan(pos[0], pos[1], m, ngrid)
    lin = []
    for code in ent:
        d, jk = divmod(int(code), m * m)
        lin.append((pos[1, d] + jk // m) * ngrid + pos[0, d] + jk % m)
    assert lin == sorted(lin) and len(ent) == off[-1] == p.ncontrib
    for c in range(ngrid * ngrid):
        seg = ent[off[c]:off[c + 1]]
        assert list(seg) == sorted(seg)
    before = (grid_general.launches, grid_separable.launches)
    out = torch.zeros(npol, ngrid, ngrid, dtype=torch.complex64)
    grid_general(torch.from_numpy(vis), p.offsets, p.entries, p.kern, out)
    assert (grid_general.launches, grid_separable.launches) == before
    ref = grid_general_plain(torch.from_numpy(vis), p.offsets, p.entries,
                             p.kern, torch.zeros_like(out))
    assert torch.equal(out, ref) and torch.equal(out, grid)


def test_methods_and_refusals():
    ngrid, m, nd = 8, 2, 4
    pos = np.zeros((2, nd), np.int32)
    kern = np.ones((m, m), np.complex64)
    vis = torch.ones(1, nd, dtype=torch.complex64)
    a = Romein().init(pos, kern, ngrid, method="plain").execute(vis)
    b = Romein().init(pos, kern, ngrid).execute(vis)
    assert torch.equal(a, b) and a[0, 0, 0] == nd
    for method in ("pallas", "scatter", "sorted"):
        with pytest.raises(ValueError, match="'cuda'"):
            Romein().init(pos, kern, ngrid, method=method)
    with pytest.raises(ValueError, match="f32 only"):
        Romein().init(pos, kern, ngrid, precision="bf16")
    # Positions given as a tensor build the plan where the tensor lies
    # (origin 'device'), the same plan as from host arrays.
    d = Romein().init(torch.zeros(2, nd, dtype=torch.int32), kern, ngrid)
    assert torch.equal(d.execute(vis), b)
    assert d.plan_report()["origin"] == "device"
    config.set("romein_method", "plain")
    try:
        plan = Romein().init(pos, kern, ngrid)
        plan.execute(vis)
        assert plan.plan_report()["method"] == "plain"
    finally:
        config.reset("romein_method")


def test_shared_kernel_plane_broadcasts_over_planes():
    """A (1, nvis, m, m) kernel plane serves every data plane, as the JAX
    'pallas' path broadcasts it.  The JAX 'scatter' path reshapes it to
    (npol, -1, m, m) instead and raises for npol > 1 (ROADMAP Queue C,
    noted against the reference)."""
    rng = np.random.default_rng(13)
    npol, nd, m, ngrid = 3, 40, 3, 24
    vis = (rng.standard_normal((npol, nd)) +
           1j * rng.standard_normal((npol, nd))).astype(np.complex64)
    pos = rng.integers(-2, ngrid, (2, 1, nd)).astype(np.int32)
    kern = (rng.standard_normal((1, nd, m, m)) +
            1j * rng.standard_normal((1, nd, m, m))).astype(np.complex64)
    want, _ = _jax(vis, pos, kern, ngrid, "pallas")
    got, plan = _port(vis, pos, kern, ngrid)
    assert tuple(plan._last_plan.kern.shape) == (1, nd, m, m)
    golden, mag, _, nmax = _golden(vis, pos[0, 0], pos[1, 0], kern, ngrid)
    bound = (nmax + 6) * EPS * mag
    assert (np.abs(got - golden) <= bound + 1e-30).all()
    assert (np.abs(got - want) <= 2 * bound + 1e-30).all()
    with pytest.raises(TypeError, match="reshape"):
        _jax(vis, pos, kern, ngrid, "scatter")


def test_gridder_and_fft_blocks_match_jax_and_latch():
    """GridderBlock then FftBlock on a [pol, vis, time] stream against the
    JAX blocks ('pallas' gridder in interpret mode): positions from the
    header key 'uvw', kernels from a callable; output headers equal.  The
    `romein_method` and `fft_method` flags are latched while the
    sequence runs (30 frames against output rings of 9, so the blocks
    wait for the sink that pokes the flags)."""
    from bifrost_tpu import blocks as jb
    from bifrost_tpu.blocks.testing import array_source as jsrc
    from bifrost_tpu.blocks.testing import gather_sink as jgather
    from bifrost_tpu.pipeline import Pipeline as JPipeline
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.pipeline import Pipeline
    rng = np.random.default_rng(17)
    ntime, npol, nd, m, ngrid = 30, 2, 20, 3, 16
    x = (rng.standard_normal((ntime, npol, nd)) +
         1j * rng.standard_normal((ntime, npol, nd))).astype(np.complex64)
    pos = rng.integers(-2, ngrid, (2, nd)).astype(np.int32)
    kern = (rng.standard_normal((1, nd, m, m)) +
            1j * rng.standard_normal((1, nd, m, m))).astype(np.complex64)
    hdr = {"labels": ["time", "pol", "vis"],
           "scales": [[0.0, 1.0], None, None], "units": ["s", None, None],
           "uvw": pos.tolist()}
    jgot, jh = [], []
    with JPipeline() as pipe:
        t = jb.transpose(jb.copy(jsrc(x, 3, header=dict(hdr)), space="tpu"),
                         ["pol", "vis", "time"])
        g = jb.romein(t, ngrid, lambda h: kern, method="pallas",
                      pallas_interpret=True)
        f = jb.fft(g, axes=["v", "u"], axis_labels=["m", "l"])
        jgather(jb.copy(f, space="system"), jgot, jh)
        pipe.run()
    got, ph, errs = [], [], []

    def poke(d):
        got.append(d.numpy().copy())
        for flag in ("romein_method", "fft_method"):
            try:
                config.set(flag, "plain" if flag == "romein_method"
                           else "torch")
            except RuntimeError as e:
                errs.append(str(e))

    with Pipeline(device="cpu") as pipe:
        t = blocks.transpose(
            blocks.copy(blocks.array_source(x, 3, header=dict(hdr)),
                        space="cuda"), ["pol", "vis", "time"])
        g = blocks.romein(t, ngrid, lambda h: kern)
        f = blocks.fft(g, axes=["v", "u"], axis_labels=["m", "l"])
        blocks.callback_sink(f, on_sequence=ph.append, on_data=poke)
        pipe.run()
    config.reset()
    assert any("romein_method" in e for e in errs)
    assert any("fft_method" in e for e in errs)
    assert g.plan_report()["method"] == "cuda"
    assert g.plan_report()["kernel"] == "general"
    assert ph[0]["_tensor"] == jh[0]["_tensor"]
    assert ph[0]["_tensor"]["labels"] == ["pol", "m", "l", "time"]
    want = np.concatenate(jgot, axis=-1)
    mine = np.concatenate(got, axis=-1)
    assert mine.shape == want.shape == (npol, ngrid, ngrid, ntime)
    # The gridding bound (module docstring) summed over a plane's cells
    # carries through the FFT, which adds 2 log2(ngrid**2) roundings of
    # at most sum|grid| at every output; twice that between two sides.
    bound = np.empty((npol, 1, 1, ntime))
    for k in range(ntime):
        gk, mag, _, nmax = _golden(x[k], pos[0], pos[1], kern, ngrid)
        bound[:, 0, 0, k] = EPS * (
            (nmax + 6) * mag.sum(axis=(1, 2)) +
            2 * np.log2(ngrid * ngrid) * np.abs(gk).sum(axis=(1, 2)))
    assert np.isfinite(mine).all()
    assert (np.abs(mine - want) <= 2 * bound).all()


def test_gridding_packed_ci4_matches_logical_and_jax():
    """Mirrors tests/test_ops.py:610 and :749: packed ci4 visibilities
    grid bitwise as their logical values (`execute(..., dtype='ci4')`),
    within the bound of the golden and of the JAX plan fed the same ci4
    bytes ('scatter' and 'pallas' interpret), host positions."""
    from bifrost_tpu.ops import quantize as jq
    import bifrost_tpu as jbf
    np.random.seed(3)
    ngrid, m, ndata = 32, 4, 16
    re = np.random.randint(-8, 8, (1, ndata)).astype(np.float32)
    im = np.random.randint(-8, 8, (1, ndata)).astype(np.float32)
    vis = (re + 1j * im).astype(np.complex64)
    q = jbf.empty((1, ndata), dtype="ci4")
    jq(vis, q, scale=1.0)
    packed = np.asarray(q)
    xs = np.random.randint(0, ngrid - m, (2, 1, ndata)).astype(np.int32)
    kern = np.ones((1, ndata, m, m), dtype=np.complex64)
    plan = Romein().init(xs, kern, ngrid)
    got = plan.execute(torch.from_numpy(packed), dtype="ci4").numpy()
    logical = Romein().init(xs, kern, ngrid).execute(
        torch.from_numpy(vis)).numpy()
    assert np.array_equal(got, logical)
    golden, mag, _, nmax = _golden(vis, xs[0, 0], xs[1, 0], kern, ngrid)
    bound = (nmax + 6) * EPS * mag
    assert (np.abs(got - golden) <= bound).all()
    for method in ("scatter", "pallas"):
        jplan = JRomein()
        jplan.pallas_interpret = True
        jplan.init(xs, kern, ngrid, method=method)
        jgrid = np.zeros((1, ngrid, ngrid), np.complex64).view(ndarray)
        jplan.execute(q, jgrid)
        assert (np.abs(got - np.asarray(jgrid)) <= 2 * bound).all()


def test_gridder_block_raw_ci4_ingest():
    """Mirrors tests/test_blocks.py:445: a ci4 [pol, vis, time] stream on
    a 'cuda' ring is read in storage form (1 B/sample; the counters book
    storage bytes) and grids bitwise as the same values in complex64."""
    from bifrost_tpu.ops import quantize as jq
    import bifrost_tpu as jbf
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.ops.runtime import storage_nbyte_per_sample
    from bifrost_tpu_torch.pipeline import Pipeline
    rng = np.random.default_rng(47)
    ngrid, m, nvis, ntime = 32, 3, 10, 8
    vis = (rng.integers(-7, 8, (ntime, 1, nvis)) +
           1j * rng.integers(-7, 8, (ntime, 1, nvis))).astype(np.complex64)
    q = jbf.empty(vis.shape, dtype="ci4")
    jq(vis, q, scale=1.0)
    packed = np.asarray(q)
    xs = rng.integers(0, ngrid - m, (2, 1, nvis)).astype(np.int32)
    kern = (rng.standard_normal((1, nvis, m, m)) +
            1j * rng.standard_normal((1, nvis, m, m))).astype(np.complex64)

    def run(data, dtype):
        got = []
        hdr = {"labels": ["time", "pol", "vis"], "uvw": xs.tolist()}
        if dtype:
            hdr["dtype"] = dtype
        with Pipeline(device="cpu") as pipe:
            t = blocks.transpose(
                blocks.copy(blocks.array_source(data, 4, header=hdr),
                            space="cuda"), ["pol", "vis", "time"])
            g = blocks.romein(t, ngrid, kern)
            blocks.gather_sink(g, got)
            pipe.run()
        return np.concatenate(got, axis=-1), g

    out4, g4 = run(packed, "ci4")
    outc, gc = run(vis, None)
    assert np.array_equal(out4, outc)
    assert g4._raw_reads == 2 and gc._raw_reads == 0
    assert g4._raw_read_nbyte == \
        storage_nbyte_per_sample("ci4") * nvis * ntime
