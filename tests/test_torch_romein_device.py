"""The gridder's plan built from tensors (origin 'device',
ops/romein_plan.py) against the host builders of ops/romein.py and
against the JAX package's device-origin plan (positions and kernels as
jax arrays: the jitted `bin_to_tiles_device` path).

On the CPU the "device" is torch's CPU: a `torch.Tensor` takes the torch
builders whatever its device, as a card tensor does on the H100
(tests/test_torch_gpu.py and chip_smoke's [kernels] hold the same there).

Parity:
- every plan table (CSR offsets and entries, the seven tiled-plan
  tables, the kernel or u/v planes): bitwise against the host builders;
- images: bitwise between the two origins (the same tables, walked by
  the same plain kernels); against the JAX package's device-origin
  image, within test_torch_romein.py's bound, 2 B per cell, where B =
  (nmax + 6) 2**-24 S (+ 1e-5 max|K| D for rank-1 kernels), S the f64
  sum over a cell's contributions of |d| |K|, D that of |d| and nmax the
  largest cell count.
"""

import os

import numpy as np
import pytest
import torch

from bifrost_tpu import ndarray
from bifrost_tpu.ops import Romein as JRomein
from bifrost_tpu_torch.ops import Romein, romein_plan
from bifrost_tpu_torch.ops import romein as host
from bifrost_tpu_torch.ops.romein_kernel import CHUNK, TILE

EPS = 2.0 ** -24


def _golden(vis, xs, ys, kern, ngrid):
    """f64 brute force -> (grid, S, D, nmax)."""
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
                    grid[:, yy, xx] += vis[:, d].astype(np.complex128) * \
                        kb[:, d, j, k]
                    mag[:, yy, xx] += np.abs(vis[:, d]) * \
                        np.abs(kb[:, d, j, k])
                    dsum[:, yy, xx] += np.abs(vis[:, d])
                    count[yy, xx] += 1
    return grid, mag, dsum, int(count.max(initial=0))


def _geometry(name):
    """-> (vis (npol, ndata) complex64, positions (2, 1, ndata) int32,
    kernels, ngrid, the visibilities as a JAX ci4 array or None) of one
    case."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def cvis(npol, nd):
        return (rng.standard_normal((npol, nd)) +
                1j * rng.standard_normal((npol, nd))).astype(np.complex64)

    def ckern(*shape):
        return (rng.standard_normal(shape) +
                1j * rng.standard_normal(shape)).astype(np.complex64)

    packed = None
    if name.startswith("774"):
        # tests/test_ops.py:774: out-of-grid drops on every side
        ngrid, m, nd, npol = 96, 4, 48, 2
        pos = rng.integers(-m, ngrid + 2, (2, 1, nd)).astype(np.int32)
        kern = ckern(npol, nd, m, m) if name.endswith("general") else \
            np.ones((npol, nd, m, m), np.complex64)
        vis = cvis(npol, nd)
    elif name == "808-ci4":
        # :808: packed ci4 visibilities
        import bifrost_tpu as jbf
        from bifrost_tpu.ops import quantize
        ngrid, m, nd = 64, 4, 24
        re = rng.integers(-8, 8, (1, nd)).astype(np.float32)
        im = rng.integers(-8, 8, (1, nd)).astype(np.float32)
        vis = (re + 1j * im).astype(np.complex64)
        q = jbf.empty((1, nd), dtype="ci4")
        quantize(vis, q, scale=1.0)
        packed = q
        pos = rng.integers(0, ngrid - m, (2, 1, nd)).astype(np.int32)
        kern = np.ones((1, nd, m, m), np.complex64)
    elif name.startswith("835"):
        # :835: ngrid 150 (not a multiple of TILE), straddling patches
        ngrid, m, nd, npol = 150, 5, 64, 2
        pos = rng.integers(-m, ngrid + 2, (2, 1, nd)).astype(np.int32)
        if name.endswith("separable"):
            u, v = ckern(npol, nd, m), ckern(npol, nd, m)
            kern = (u[..., :, None] * v[..., None, :]).astype(np.complex64)
        else:
            kern = ckern(npol, nd, m, m)
        vis = cvis(npol, nd)
    elif name == "881-crowded":
        # :881 pins an undersized npad and expects the overflow dropped.
        # The port's tiled plan has no npad: a tile takes as many chunks
        # of CHUNK slots as its visibilities need, so 2 CHUNK + 5
        # visibilities in tile 0 and 4 in tile 1 all grid.
        ngrid, m = 2 * TILE, 4
        nd = 2 * CHUNK + 9
        xs = np.array([5] * (nd - 4) + [TILE + 5] * 4, np.int32)
        pos = np.stack([xs, np.full(nd, 5, np.int32)])[:, None]
        kern = ckern(1, nd, m, m)
        vis = cvis(1, nd)
    elif name == "902-real":
        # :902: real-valued per-visibility kernels
        ngrid, m, nd = 48, 3, 40
        pos = rng.integers(-m, ngrid + 2, (2, 1, nd)).astype(np.int32)
        kern = (rng.standard_normal((1, nd, m, m)) + 0j).astype(np.complex64)
        vis = cvis(1, nd)
    elif name == "shared-plane":
        # the instrument's form: one (m, m) plane for every visibility
        ngrid, m, nd, npol = 40, 3, 200, 3
        pos = rng.integers(-2, ngrid, (2, 1, nd)).astype(np.int32)
        kern = np.ones((m, m), np.complex64)
        vis = cvis(npol, nd)
    elif name == "empty":
        # every patch off the grid, on every side
        ngrid, m, nd = 24, 3, 12
        xs = np.array([-3, 24, 30, -10] * 3, np.int32)
        pos = np.stack([xs, xs[::-1].copy()])[:, None]
        kern = ckern(1, nd, m, m)
        vis = cvis(1, nd)
    else:
        raise KeyError(name)
    return vis, pos, kern, ngrid, packed


CASES = ["774-general", "774-separable", "808-ci4", "835-separable",
         "835-general", "881-crowded", "902-real", "shared-plane", "empty"]


def _tables(plan):
    out = {"offsets": plan.offsets, "entries": plan.entries}
    if plan.separable:
        out.update(u=plan.u, v=plan.v)
    else:
        out["kern"] = plan.kern
    return out


def _same(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("name", CASES)
def test_device_origin_plan_bitwise_and_images_match_jax(name):
    """Mirrors tests/test_ops.py:774, :808, :835, :881 and :902: positions
    and kernels given as tensors build the plan with the torch builders
    (origin 'device'); every table, the tiled plan's seven included, is
    bitwise the host builders'; the images of both origins are bitwise
    equal and, against the JAX package's device-origin plan ('pallas'
    in interpret mode), within 2 B."""
    import jax
    from bifrost_tpu.ndarray import to_jax
    vis, pos, kern, ngrid, packed = _geometry(name)
    npol, nd = vis.shape
    m = kern.shape[-1]
    data = torch.from_numpy(np.asarray(packed) if packed is not None
                            else vis)
    dtype = "ci4" if packed is not None else None

    hplan = Romein().init(pos, kern, ngrid)
    himg = hplan.execute(data, dtype=dtype)
    dplan = Romein().init(torch.from_numpy(pos), torch.from_numpy(kern),
                          ngrid)
    dimg = dplan.execute(data, dtype=dtype)
    assert hplan.plan_report()["origin"] == "host"
    assert dplan.plan_report()["origin"] == "device"
    assert dplan.plan_report()["method"] == "cuda"
    ph, pd = hplan._last_plan, dplan._last_plan
    assert (ph.origin, pd.origin) == ("host", "device")
    assert ph.separable == pd.separable
    th, td = _tables(ph), _tables(pd)
    assert th.keys() == td.keys()
    for k in th:
        assert _same(th[k], td[k]), k
    tiles_h = host.build_tiles(ph.offsets.numpy(), ph.entries.numpy(), m,
                               ngrid, nd)
    tiles_d = romein_plan.build_tiles(pd.offsets, pd.entries, m, ngrid, nd)
    for k in tiles_h:
        assert _same(torch.from_numpy(tiles_h[k]), tiles_d[k]), k
    assert _same(himg, dimg)

    jplan = JRomein()
    jplan.pallas_interpret = True
    jplan.init(jax.device_put(pos), to_jax(kern), ngrid, method="pallas")
    jgrid = np.zeros((npol, ngrid, ngrid), np.complex64).view(ndarray)
    jplan.execute(packed if packed is not None else vis, jgrid)
    assert jplan.last_origin == "device"
    golden, mag, dsum, nmax = _golden(vis, pos[0, 0], pos[1, 0],
                                      np.asarray(kern), ngrid)
    bound = (nmax + 6) * EPS * mag
    if pd.separable:
        bound = bound + 1e-5 * np.abs(kern).max() * dsum
    got = dimg.numpy()
    assert (np.abs(got - golden) <= bound + 1e-30).all()
    assert (np.abs(got - np.asarray(jgrid)) <= 2 * bound + 1e-30).all()
    if name == "empty":
        assert pd.ncontrib == 0 and not got.any()


def test_plan_cache_keys_origin_identity_and_version():
    """The plan cache key carries the origin and, for a device origin,
    each tensor's identity and version (the JAX key at
    bifrost_tpu/ops/romein.py:256-259): the same tensors hit the cache,
    an in-place edit of the positions builds a new plan from the edited
    values, and plan_build_s times whichever builder ran (0 on a hit)."""
    rng = np.random.default_rng(5)
    ngrid, m, nd = 32, 3, 30
    pos = torch.from_numpy(rng.integers(0, ngrid - m, (2, nd))
                           .astype(np.int32))
    kern = torch.ones(m, m, dtype=torch.complex64)
    vis = torch.ones(1, nd, dtype=torch.complex64)
    plan = Romein().init(pos, kern, ngrid)
    a = plan.execute(vis)
    rep = plan.plan_report()
    assert rep["origin"] == "device" and rep["cache"]["misses"] == 1
    assert rep["plan_build_s"] > 0
    b = plan.execute(vis)
    rep = plan.plan_report()
    assert rep["cache"]["hits"] == 1 and rep["plan_build_s"] == 0.0
    assert torch.equal(a, b)
    pos[0] += 1                        # in place: a new version
    c = plan.execute(vis)
    assert plan.plan_report()["cache"]["misses"] == 2
    want = Romein().init(pos.numpy().copy(), kern.numpy(), ngrid) \
        .execute(vis)
    assert torch.equal(c, want) and not torch.equal(a, c)
    assert Romein().init(pos.numpy(), kern.numpy(), ngrid).state_origin \
        == "host"
    # A mixed origin (numpy positions, tensor kernels) is a device one.
    mixed = Romein().init(pos.numpy(), kern, ngrid)
    assert torch.equal(mixed.execute(vis), want)
    assert mixed.plan_report()["origin"] == "device"


def test_device_builders_raise_as_the_host_builders():
    """The int32-overflow and m < 256 checks raise on both origins."""
    nd = 2 ** 31 // (255 * 255) + 1
    xs = np.zeros(nd, np.int32)
    for fn, a in ((host.build_plan, xs),
                  (romein_plan.build_plan, torch.from_numpy(xs))):
        with pytest.raises(ValueError, match="overflow"):
            fn(a, a, 255, 8)
    off = np.zeros(65, np.int32)
    ent = np.zeros(0, np.int32)
    for fn, o, e in ((host.build_tiles, off, ent),
                     (romein_plan.build_tiles, torch.from_numpy(off),
                      torch.from_numpy(ent))):
        with pytest.raises(ValueError, match="m < 256"):
            fn(o, e, 256, 8, 1)
    for fn, k in ((host.kernel_planes, np.ones((2, 3, 3), np.complex64)),
                  (romein_plan.kernel_planes,
                   torch.ones(2, 3, 3, dtype=torch.complex64))):
        with pytest.raises(ValueError, match="do not broadcast"):
            fn(k, 1, 5, 3)


def _vis_stream(seed, nvis, ntime):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((ntime, 1, nvis)) +
            1j * rng.standard_normal((ntime, 1, nvis))).astype(np.complex64)


@pytest.mark.parametrize("origin", ["host", "device"])
def test_gridder_block_streaming(origin):
    """Mirrors tests/test_blocks.py::test_gridder_block_streaming: host
    positions from the header, device ones (and the kernels) from
    callbacks returning tensors.  Both origins give bitwise the same
    images, within 2 B of the JAX block's device-origin run, and the
    `<name>/romein_plan` proclog row carries the JAX keys with the
    plan's origin."""
    import jax
    from bifrost_tpu import blocks as jb
    from bifrost_tpu.blocks.testing import array_source as jsrc
    from bifrost_tpu.blocks.testing import gather_sink as jgather
    from bifrost_tpu.ndarray import to_jax
    from bifrost_tpu.pipeline import Pipeline as JPipeline
    from bifrost_tpu_torch import blocks, proclog
    from bifrost_tpu_torch.pipeline import Pipeline
    rng = np.random.default_rng(41)
    ngrid, m, nvis, ntime = 48, 3, 20, 12
    x = _vis_stream(41, nvis, ntime)
    pos = rng.integers(-m, ngrid + 2, (2, 1, nvis)).astype(np.int32)
    kern = (rng.standard_normal((1, nvis, m, m)) +
            1j * rng.standard_normal((1, nvis, m, m))).astype(np.complex64)

    def run(orig):
        got = []
        hdr = {"labels": ["time", "pol", "vis"]}
        if orig == "host":
            hdr["uvw"] = pos.tolist()
            kw = dict(kernels=kern)
        else:
            kw = dict(kernels=lambda h: torch.from_numpy(kern),
                      positions=lambda h: torch.from_numpy(pos))
        with Pipeline(device="cpu") as pipe:
            t = blocks.transpose(
                blocks.copy(blocks.array_source(x, 5, header=hdr),
                            space="cuda"), ["pol", "vis", "time"])
            g = blocks.romein(t, ngrid, name=f"grid_{orig}", **kw)
            blocks.gather_sink(g, got)
            pipe.run()
            row = proclog.load_by_pid(os.getpid())[f"grid_{orig}"][
                "romein_plan"]
        return np.concatenate(got, axis=-1), g, row

    out, g, row = run(origin)
    other, _, _ = run("device" if origin == "host" else "host")
    assert np.array_equal(out.view(np.uint32), other.view(np.uint32))
    assert set(row) == {"method", "origin", "plan_build_s", "ngrid", "m"}
    assert (row["method"], row["origin"], row["ngrid"], row["m"]) == \
        ("cuda", origin, ngrid, m)
    assert row["plan_build_s"] >= 0.0
    assert g.plan_report()["origin"] == origin

    jgot = []
    with JPipeline() as pipe:
        t = jb.transpose(jb.copy(jsrc(x, 5, header={
            "labels": ["time", "pol", "vis"]}), space="tpu"),
            ["pol", "vis", "time"])
        jg = jb.romein(t, ngrid, lambda h: to_jax(kern),
                       positions=lambda h: jax.device_put(pos),
                       pallas_interpret=True)
        jgather(jb.copy(jg, space="system"), jgot)
        pipe.run()
    want = np.concatenate(jgot, axis=-1)
    assert jg.plan_report["origin"] == "device"
    assert out.shape == want.shape == (1, ngrid, ngrid, ntime)
    for k in range(ntime):
        _, mag, _, nmax = _golden(x[k], pos[0, 0], pos[1, 0], kern, ngrid)
        bound = (nmax + 6) * EPS * mag
        assert (np.abs(out[..., k] - want[..., k]) <= 2 * bound + 1e-30
                ).all()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_sub_byte_real_stream_refused_as_jax(package):
    """A sub-byte real stream (i4) cannot reach the gridder in either
    package: its input axes end in the frame axis 'time', and a packed
    type's ring needs a non-frame last axis, so the ring ahead of the
    gridder refuses it with the JAX ring's own message
    (bifrost_tpu/ring.py:170)."""
    rng = np.random.default_rng(3)
    ngrid, m, nvis, ntime = 16, 3, 16, 8
    packed = rng.integers(0, 256, (ntime, 1, nvis // 2)).astype(np.uint8)
    pos = rng.integers(0, ngrid - m, (2, 1, nvis)).astype(np.int32)
    kern = np.ones((1, nvis, m, m), np.complex64)
    hdr = {"labels": ["time", "pol", "vis"], "uvw": pos.tolist(),
           "dtype": "i4"}
    if package == "jax":
        from bifrost_tpu import blocks as b
        from bifrost_tpu.pipeline import Pipeline
        kw, space, src = {"method": "scatter"}, "tpu", None
        from bifrost_tpu.blocks.testing import array_source as src
        from bifrost_tpu.blocks.testing import gather_sink as sink
        pipe = Pipeline()
    else:
        from bifrost_tpu_torch import blocks as b
        from bifrost_tpu_torch.pipeline import Pipeline
        kw, space = {}, "cuda"
        src, sink = b.array_source, b.gather_sink
        pipe = Pipeline(device="cpu")
    got = []
    with pytest.raises(Exception, match="packed dtype requires a "
                                        "non-frame last axis"):
        with pipe:
            t = b.transpose(b.copy(src(packed, 4, header=dict(hdr)),
                                   space=space), ["pol", "vis", "time"])
            sink(b.romein(t, ngrid, kern, **kw), got)
            pipe.run()
    assert got == []


def test_instrument_with_tensor_uvw_is_bitwise_the_host_run():
    """`lwa_instrument_pipeline` passes `uvw` and `kernels` given as
    tensors through to the gridder, which builds a device-origin plan:
    the images are bitwise the host-origin run's."""
    from bifrost_tpu_torch.service import (default_grid_kernel,
                                           default_uvw,
                                           lwa_instrument_pipeline)
    geom = dict(nstand=3, npol=2, nchan=4, ntap=4, n_int=3, nbeam=2,
                ngrid=16, max_delay=4)
    rng = np.random.default_rng(7)
    volt = rng.integers(-8, 8, (4 * 3 * 4, 3, 2, 2)).astype(np.int8)
    uvw = default_uvw(3, 2, 16)
    runs = {}
    for origin in ("host", "device"):
        images = []
        kw = {} if origin == "host" else dict(
            uvw=torch.from_numpy(uvw), kernels=torch.from_numpy(
                default_grid_kernel()))
        pipe, _, _ = lwa_instrument_pipeline(
            volt, device="cpu", fuse=False,
            on_image=lambda d: images.append(d.numpy().copy()), **geom,
            **kw)
        pipe.run()
        grid = next(b for b in pipe.blocks if b.name == "image_grid")
        runs[origin] = (np.stack(images), grid.plan_report())
    (a, ra), (b, rb) = runs["host"], runs["device"]
    assert a.shape == (4, 4, 16, 16, 1) and np.isfinite(a).all()
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    assert (ra["origin"], rb["origin"]) == ("host", "device")
    assert ra["kernel"] == rb["kernel"] == "separable"
