"""The port's mesh layer (bifrost_tpu_torch/parallel/) on a virtual mesh
of 8 CPU positions, beside tests/test_parallel.py and
tests/test_parallel_pipeline.py.

The JAX tests run on 8 virtual CPU devices (tests/conftest.py); the port
asks for its virtual mesh explicitly, `virtual_devices(8, 'cpu')`.  The
same seeded numpy input goes through both packages:

- the FX step is held to the JAX `fx_step_reference` and to the JAX
  sharded step within a tolerance of f32 eps times the summation depth
  and the FFT depth (`_fx_tol`);
- the sharded correlate (the JAX mesh X-engine runs) is held to the JAX
  mesh chain and to both packages' single-device chains: bitwise on
  integer-valued voltages, within 1e-5 relative on Gaussian ones;
- the sharded beamform is held to the JAX *single-device* beamform (the
  JAX mesh B-engine fails under JAX 0.9's shard_map at
  bifrost_tpu/ops/beamform.py:168): bitwise on integer-valued data,
  within 1e-4 relative on Gaussian data (another summation order);
- the layout helpers against the JAX helpers on the same labels.
"""

import math

import numpy as np
import pytest

from bifrost_tpu import blocks as jblocks
from bifrost_tpu.blocks.testing import array_source as j_array_source
from bifrost_tpu.blocks.testing import gather_sink as j_gather_sink
from bifrost_tpu.parallel import make_mesh as j_make_mesh
from bifrost_tpu.parallel import make_fx_step as j_make_fx_step
from bifrost_tpu.parallel import mesh_axes_for as j_mesh_axes_for
from bifrost_tpu.parallel import partition_spec as j_partition_spec
from bifrost_tpu.parallel.fx import fx_step_reference
from bifrost_tpu.parallel.mesh import device_mesh_shape as j_mesh_shape
from bifrost_tpu.pipeline import Pipeline as JaxPipeline

import torch

from bifrost_tpu_torch import blocks
from bifrost_tpu_torch.blocks._common import deepcopy_header
from bifrost_tpu_torch.blocks.testing import array_source, gather_sink
from bifrost_tpu_torch.parallel import (device_mesh_shape, make_fx_step,
                                        make_mesh, mesh_axes_for,
                                        partition_spec, shard_put,
                                        virtual_devices)
from bifrost_tpu_torch.parallel.mesh import Mesh, MeshDevice
from bifrost_tpu_torch.pipeline import Pipeline, TransformBlock

LABELS = ["time", "freq", "station", "pol"]


def vmesh(axes=("time", "freq"), n=8):
    return make_mesh(devices=virtual_devices(n, "cpu"), axis_names=axes)


class ShardProbe(TransformBlock):
    """Pass-through that records each gulp's layout (`ReadSpan.sharding`)."""

    def __init__(self, iring, seen, **kwargs):
        super().__init__(iring, **kwargs)
        self.seen = seen

    def on_sequence(self, iseq):
        return deepcopy_header(iseq.header)

    def on_data(self, ispan, ospan):
        self.seen.append(ispan.sharding)
        ospan.data.copy_(ispan.data)


def _fx_input(ntime=32, nchan=8, nstand=4, npol=2, seed=0, integer=False):
    rng = np.random.default_rng(seed)
    shape = (ntime, nchan, nstand, npol)
    if integer:
        x = rng.integers(-8, 8, shape) + 1j * rng.integers(-8, 8, shape)
    else:
        x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return x.astype(np.complex64), {"labels": list(LABELS)}


def _run_port(x, header, mesh=None, shard=None, build=None, gulp=16,
              probe=None):
    out = []
    kwargs = {"device": "cpu"}
    if mesh is not None:
        kwargs["mesh"] = mesh
    if shard is not None:
        kwargs["shard"] = shard
    with Pipeline(**kwargs) as pipe:
        src = array_source(x, gulp, header=header)
        dev = blocks.copy(src, space="cuda")
        if probe is not None:
            dev = ShardProbe(dev, probe)
        gather_sink(build(blocks, dev), out)
        pipe.run()
    return np.concatenate(out, axis=0)


def _run_jax(x, header, mesh=None, build=None, gulp=16):
    out = []
    kwargs = {"mesh": mesh} if mesh is not None else {}
    with JaxPipeline(**kwargs) as pipe:
        src = j_array_source(x, gulp, header=header)
        dev = jblocks.copy(src, space="tpu")
        j_gather_sink(build(jblocks, dev), out)
        pipe.run()
    return np.concatenate(out, axis=0)


# ------------------------------------------------- test_parallel.py (4)
@pytest.mark.parametrize("n,axes", [
    (8, ("time", "freq")), (4, ("time", "freq")), (1, ("time", "freq")),
    (6, ("time", "freq")), (7, ("time", "freq")), (8, ("freq",)),
    (8, ("time", "freq", "stand")), (4, ("time", "freq", "stand"))])
def test_mesh_shape_factoring(n, axes):
    """`device_mesh_shape` is the JAX function's copy: equal on every
    count and axis set, (4, 2) for 8 and (7, 1) for the 7 survivors of
    an eviction."""
    assert device_mesh_shape(n, axes) == j_mesh_shape(n, axes)
    assert device_mesh_shape(8) == (4, 2)
    assert device_mesh_shape(7) == (7, 1)


def _fx_tol(golden, nfine, nterms):
    """f32 rounding bound of the FX step: eps32 times (the FFT's depth,
    log2(nfine) butterfly stages, plus the `nterms` summed products)
    times the output's magnitude."""
    eps = float(np.finfo(np.float32).eps)
    return eps * (math.log2(nfine) + 2 + nterms) * float(np.abs(golden).max())


@pytest.mark.parametrize("axes,ntime", [(("time", "freq"), 32),
                                        (("time", "freq", "stand"), 16)])
def test_fx_step_matches_reference(axes, ntime):
    """The sharded FX step on (time, freq) = (4, 2) and on the station
    tensor-parallel (time, freq, stand) = (2, 2, 2) mesh against the JAX
    numpy reference and the JAX sharded step on the same input, within
    `_fx_tol`; the collectives are the layout's (3 all-reduces without a
    station axis; with one, 1 all-gather and 5 all-reduces)."""
    from bifrost_tpu_torch.parallel import collective_stats
    rng = np.random.default_rng(11)
    nchan, nstand, npol, nfine, nbeam = 4, 6, 2, 4, 3
    x = rng.integers(-8, 8, (ntime, nchan, nstand, npol, 2)).astype(np.int8)
    w = (rng.random((nbeam, nstand * npol)) +
         1j * rng.random((nbeam, nstand * npol))).astype(np.complex64)
    step = make_fx_step(vmesh(axes), nfine=nfine)
    got = [o.numpy() for o in step(x, w)]
    ref = fx_step_reference(x, w, nfine)
    jax_out = [np.asarray(o) for o in
               j_make_fx_step(j_make_mesh(8, axes), nfine=nfine)(x, w)]
    nsp = nstand * npol
    nblock = ntime // nfine
    for g, r, j, nterms in zip(got, ref, jax_out,
                               (nblock, nblock * nsp, nblock * nsp)):
        tol = _fx_tol(r, nfine, nterms)
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= tol
        assert np.abs(g - j).max() <= tol
    stats = collective_stats(step, x, w)
    expect = {"all-reduce": 3} if "stand" not in axes else \
        {"all-reduce": 5, "all-gather": 1}
    assert stats["ops"] == expect and stats["bytes"] > 0


def test_fx_step_output_sharding():
    step = make_fx_step(vmesh(), nfine=4)
    x = np.zeros((16, 4, 4, 2, 2), dtype=np.int8)
    w = np.zeros((2, 8), dtype=np.complex64)
    vis, beam_pow, spec = step(x, w)
    assert tuple(vis.shape) == (16, 8, 8)
    assert tuple(beam_pow.shape) == (2, 16)
    assert tuple(spec.shape) == (16,)
    assert step.guard_name == "fx_step"


# --------------------------------------- test_parallel_pipeline.py (6)
def _correlate(nint, gulp):
    return lambda blk, dev: blk.correlate(dev, nint, gulp_nframe=gulp)


@pytest.mark.parametrize("integer", [True, False])
def test_sharded_correlate_matches_single_device(integer):
    """The (time, freq) = (4, 2) mesh X-engine against the single-device
    chains and the JAX mesh chain; the H2D copy committed the gulps laid
    out over the mesh, sharded on time and freq."""
    x, header = _fx_input(integer=integer)
    seen = []
    mesh_out = _run_port(x, header, vmesh(), build=_correlate(32, 16),
                         probe=seen)
    single = _run_port(x, header, build=_correlate(32, 16))
    jax_mesh = _run_jax(x, header, j_make_mesh(8, ("time", "freq")),
                        build=_correlate(32, 16))
    jax_single = _run_jax(x, header, build=_correlate(32, 16))
    if integer:
        assert np.array_equal(mesh_out, single)
        assert np.array_equal(mesh_out, jax_mesh)
        assert np.array_equal(mesh_out, jax_single)
    else:
        for ref in (single, jax_mesh, jax_single):
            np.testing.assert_allclose(mesh_out, ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max())
    assert seen
    for sh in seen:
        assert tuple(sh.mesh.axis_names) == ("time", "freq")
        assert sh.spec[:2] == ("time", "freq")
        assert len(sh.device_set) == 8


def _beamform(w, nint, gulp):
    return lambda blk, dev: blk.beamform(dev, w, nint, gulp_nframe=gulp)


def _check_vs_jax_single(out, ref, integer):
    if integer:
        assert np.array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("integer", [True, False])
def test_sharded_beamform_matches_single_device(integer):
    """The (time, freq) = (4, 2) mesh B-engine against the JAX
    single-device beamform (the JAX mesh B-engine does not run: module
    docstring) and the port's single-device block."""
    x, header = _fx_input(integer=integer)
    rng = np.random.default_rng(1)
    nbeam, nsp = 3, x.shape[2] * x.shape[3]
    if integer:
        w = (rng.integers(-4, 4, (nbeam, nsp)) +
             1j * rng.integers(-4, 4, (nbeam, nsp))).astype(np.complex64)
    else:
        w = (rng.standard_normal((nbeam, nsp)) +
             1j * rng.standard_normal((nbeam, nsp))).astype(np.complex64)
    out = _run_port(x, header, vmesh(), build=_beamform(w, 32, 16))
    jax_single = _run_jax(x, header, build=_beamform(w, 32, 16))
    _check_vs_jax_single(out, jax_single, integer)
    single = _run_port(x, header, build=_beamform(w, 32, 16))
    _check_vs_jax_single(out, single, integer)


@pytest.mark.parametrize("integer", [True, False])
def test_sharded_beamform_stand_tp_matches_single_device(integer):
    """Station tensor parallelism: a (time, freq, stand) = (2, 2, 2) mesh
    with the station label mapped onto 'stand'.  Partial complex beams
    psum over 'stand' before detection; held to the JAX single-device
    beamform.  The gulps on the ring are station-sharded."""
    x, header = _fx_input(integer=integer)
    rng = np.random.default_rng(2)
    nbeam, nsp = 3, x.shape[2] * x.shape[3]
    if integer:
        w = (rng.integers(-4, 4, (nbeam, nsp)) +
             1j * rng.integers(-4, 4, (nbeam, nsp))).astype(np.complex64)
    else:
        w = (rng.standard_normal((nbeam, nsp)) +
             1j * rng.standard_normal((nbeam, nsp))).astype(np.complex64)
    seen = []
    out = _run_port(x, header, vmesh(("time", "freq", "stand")),
                    shard={"station": "stand"}, build=_beamform(w, 32, 16),
                    probe=seen)
    jax_single = _run_jax(x, header, build=_beamform(w, 32, 16))
    _check_vs_jax_single(out, jax_single, integer)
    assert seen and all(sh.spec[2] == "stand" for sh in seen)


def test_correlate_axis_order_tolerance():
    """Axis roles are found by label: a (time, pol, stand, chan) stream
    correlates as the canonical one, on the mesh as off it, and as the
    JAX mesh chain does."""
    x, _ = _fx_input(ntime=16, nchan=4, integer=True)
    xt = np.ascontiguousarray(x.transpose(0, 3, 2, 1))
    header = {"labels": ["time", "pol", "stand", "chan"]}
    shard = {"chan": "freq"}
    out = _run_port(xt, header, vmesh(), shard=shard,
                    build=_correlate(16, 8), gulp=8)
    canon = _run_port(x, {"labels": list(LABELS)},
                      build=_correlate(16, 8), gulp=8)
    assert np.array_equal(out, canon)
    jout = _run_jax(xt, header, j_make_mesh(8, ("time", "freq")),
                    build=_correlate(16, 8), gulp=8)
    assert np.array_equal(out, jout)


def test_shard_helpers():
    """`mesh_axes_for` / `partition_spec` against the JAX helpers on the
    same labels: default mapping, overrides, each mesh axis once, the
    ragged fallback; the spec is a plain tuple."""
    mesh, jmesh = vmesh(), j_make_mesh(8, ("time", "freq"))
    cases = [
        (["time", "freq", "station", "pol"], None, None),
        (["t", "chan"], {"t": "time", "chan": "freq"}, None),
        (["time", "time2"], {"time2": "time"}, None),
        (["time", "freq"], None, (8, 3)),
        (["time", "freq"], None, (6, 4)),
    ]
    for labels, shard, shape in cases:
        assert mesh_axes_for(mesh, labels, shard, shape=shape) == \
            j_mesh_axes_for(jmesh, labels, shard, shape=shape)
    spec = partition_spec(mesh, ["time", "freq"], shape=(8, 3), ndim=3)
    assert spec == ("time", None, None)
    assert spec == tuple(j_partition_spec(jmesh, ["time", "freq"],
                                          shape=(8, 3), ndim=3))


def test_shard_put_roundtrip():
    """A ShardedTensor is the tensor and its spec: every position's shard
    is the view the spec selects, no bytes move, and the shards tile the
    global array."""
    mesh = vmesh()
    x = np.arange(4 * 4 * 2 * 2, dtype=np.float32).reshape(16, 4)
    st = shard_put(x, mesh, ["time", "freq"])
    assert len(st.sharding.device_set) == 8
    assert st.sharding.spec == ("time", "freq")
    np.testing.assert_array_equal(np.asarray(st), x)
    for flat in range(8):
        t, f = mesh.coords(flat)
        np.testing.assert_array_equal(
            st.shard(flat).numpy(), x[t * 4:(t + 1) * 4, f * 2:(f + 1) * 2])
        assert st.shard(flat).data_ptr() >= st.data.data_ptr()


@pytest.mark.parametrize("raw,gulp_spectra,sharded", [
    (True, 16, True), (False, 16, True), (True, 4, False)])
def test_pfb_time_sharded_bitwise_vs_single_device(monkeypatch, raw,
                                                   gulp_spectra, sharded):
    """The PFB under a (time, freq) = (4, 2) mesh: each gulp's 4 time
    shards run the MAC from the shard before's last ntap-1 folded frames
    (one collective-permute a gulp), bitwise the port's whole-gulp PFB,
    and within test_torch_pfb.py's DFT bound (8 nchan 2**-24 peak) of the
    JAX PfbBlock; with fewer than ntap-1 spectra a shard the gulp runs
    whole (one MAC call, no collective).  ci8 raw and complex input."""
    from bifrost_tpu_torch.ndarray import pair_to_structured
    from bifrost_tpu_torch.ops import fir_kernel
    from bifrost_tpu_torch.parallel import collective
    nchan, ntap, ngulp = 64, 4, 3
    rng = np.random.default_rng(gulp_spectra)
    pairs = rng.integers(-8, 8, (ngulp * gulp_spectra * nchan, 4, 2, 2)) \
        .astype(np.int8)
    labels = ["time", "station", "pol"]
    calls = []
    plain = fir_kernel.fir_mac_plain

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)
    monkeypatch.setattr(fir_kernel, "fir_mac_plain", counted)

    def port(mesh):
        out = []
        kw = {"device": "cpu"}
        if mesh is not None:
            kw["mesh"] = mesh
        with Pipeline(**kw) as pipe:
            data = pairs if raw else \
                (pairs[..., 0] + 1j * pairs[..., 1]).astype(np.complex64)
            hdr = {"labels": labels}
            if raw:
                hdr["dtype"] = "ci8"
            src = array_source(data, gulp_spectra * nchan, header=hdr)
            gather_sink(blocks.pfb(blocks.copy(src, space="cuda"), nchan,
                                   ntap=ntap), out)
            del calls[:]
            collective.reset_totals()
            pipe.run()
        return np.concatenate(out), len(calls), collective.totals()

    single, nsingle, _ = port(None)
    sharded_out, nmesh, coll = port(vmesh())
    assert np.array_equal(sharded_out.view(np.uint32), single.view(np.uint32))
    assert nsingle == ngulp
    if sharded:
        assert nmesh == ngulp * 4
        assert coll["ops"] == {"collective-permute": ngulp}
    else:
        assert nmesh == ngulp and coll["count"] == 0
    jout = []
    with JaxPipeline() as pipe:
        src = j_array_source(pair_to_structured(pairs), gulp_spectra * nchan,
                             header={"dtype": "ci8", "labels": labels})
        j_gather_sink(jblocks.pfb(jblocks.copy(src, space="tpu"), nchan,
                                  ntap=ntap), jout)
        pipe.run()
    jout = np.concatenate(jout)
    tol = 8 * nchan * 2.0 ** -24 * float(np.abs(jout).max())
    assert sharded_out.shape == jout.shape
    assert np.abs(sharded_out - jout).max() <= tol


def test_block_shard_array_lays_out_over_the_scope_mesh():
    """Block.shard_array: in a mesh scope a tensor comes back laid out by
    its labels, the scope's shard= override applied (strict='axes': a
    key for a label this tensor lacks falls through), no bytes moved;
    outside a mesh scope the tensor itself."""
    from bifrost_tpu_torch.parallel.shard import ShardedTensor
    from bifrost_tpu_torch.pipeline import block_scope
    x = torch.zeros(8, 6)
    with Pipeline(device="cpu") as pipe:
        src = array_source(np.zeros((8, 6), np.float32), 8)
        with block_scope(mesh=vmesh(), shard={"chan": "freq",
                                              "beam": "freq"}):
            blk = ShardProbe(src, [])
        plain = ShardProbe(src, [])
        st = blk.shard_array(x, ["time", "chan"])
        assert isinstance(st, ShardedTensor) and st.data is x
        assert st.sharding.spec == ("time", "freq")
        assert plain.shard_array(x, ["time", "chan"]) is x
        pipe.shutdown()


# ---------------------------------------------------- mesh construction
def test_make_mesh_too_many_devices_raises():
    """More devices than exist raises, naming the count and the virtual
    form; a CUDA position on a card that is not there raises at Mesh
    construction too."""
    with pytest.raises(ValueError, match="only 8 device") as e:
        make_mesh(9, ("freq",), devices=virtual_devices(8, "cpu"))
    assert "virtual_devices" in str(e.value)
    ncuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="virtual_devices"):
        make_mesh(ncuda + 1, ("freq",))
    with pytest.raises(ValueError, match=f"only {ncuda} CUDA"):
        Mesh(np.array([MeshDevice(f"cuda:{ncuda}")], dtype=object),
             ("freq",))


def test_virtual_positions_keys_and_equality():
    """A virtual mesh's positions are distinct keys on one device; meshes
    compare (and hash) by content, as jax meshes do."""
    mesh = vmesh()
    keys = [str(d) for d in mesh.devices.flat]
    assert keys == [f"cpu/{i}" for i in range(8)]
    assert {d.device for d in mesh.devices.flat} == {torch.device("cpu")}
    assert mesh.shape == {"time": 4, "freq": 2}
    again = vmesh()
    assert again == mesh and hash(again) == hash(mesh)
    assert vmesh(("time", "beam")) != mesh
    exact = make_mesh(8, ("freq",), devices=virtual_devices(8, "cpu"))
    assert exact.devices.size == 8
