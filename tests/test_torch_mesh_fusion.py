"""Deferred mesh reduction and sharded chain fusion in the port, beside
tests/test_mesh_fusion.py, tests/test_fusion_engines.py's mesh case and
tests/test_beamform_fir.py's mesh case.

A mesh-sharded chain communicates like one program: per-shard partials
carried across gulps and fused constituents, exactly one psum per emit,
with fused-sharded, per-block-sharded and single-device runs bitwise
equal.  Every parity case uses small-integer inputs and weights, so any
summation order gives the same bits: what deferral changes.

The JAX mesh X-engine runs, so the correlate chains are held to the JAX
mesh chains bitwise and the collective counts to the JAX HLO audit's
(`collective_stats`: count, bytes and op names).  The JAX mesh B-engine does
not run under JAX 0.9 (bifrost_tpu/ops/beamform.py:168), so the
beamform chains are held to the JAX single-device beamform and their
counts to the contract of bifrost_tpu/parallel/fuse.py's docstring: no
collective per gulp, one all-reduce per emit.
"""

import threading
import warnings

import numpy as np
import pytest

from bifrost_tpu import blocks as jblocks
from bifrost_tpu import config as jconfig
from bifrost_tpu.blocks.testing import array_source as j_array_source
from bifrost_tpu.blocks.testing import gather_sink as j_gather_sink
from bifrost_tpu.parallel import make_mesh as j_make_mesh
from bifrost_tpu.pipeline import Pipeline as JaxPipeline

import torch

from bifrost_tpu_torch import blocks, config
from bifrost_tpu_torch.blocks.testing import array_source, gather_sink
from bifrost_tpu_torch.parallel import (fuse, make_mesh, shard_put,
                                        virtual_devices)
from bifrost_tpu_torch.pipeline import MeshFusedBlock, Pipeline

from tests.test_torch_mesh import ShardProbe

LABELS = ["time", "freq", "station", "pol"]


def vmesh(axes=("time", "freq"), n=8):
    return make_mesh(devices=virtual_devices(n, "cpu"), axis_names=axes)


def _int_fx_input(ntime=64, nchan=8, nstand=4, npol=2, seed=0):
    rng = np.random.default_rng(seed)
    shape = (ntime, nchan, nstand, npol)
    x = (rng.integers(-8, 8, shape) +
         1j * rng.integers(-8, 8, shape)).astype(np.complex64)
    return x, {"labels": list(LABELS)}


def _vis_windows(x, nacc):
    """Golden: one integrated visibility frame per `nacc` input frames."""
    xf = x.reshape(x.shape[0], x.shape[1], -1)
    frames = []
    for t0 in range(0, x.shape[0] - nacc + 1, nacc):
        w = xf[t0:t0 + nacc]
        frames.append(np.einsum("tci,tcj->cij", np.conj(w), w))
    nchan, nstand, npol = x.shape[1], x.shape[2], x.shape[3]
    return np.stack(frames).reshape(len(frames), nchan, nstand, npol,
                                    nstand, npol).astype(np.complex64)


def _run_chain(side, x, header, mesh, defer, fuse_scope, gulp=8, nint=16,
               nacc_tail=2, fused_seen=None, engine="f32", report=None):
    cfg = config if side == "port" else jconfig
    cfg.set("mesh_defer_reduce", defer)
    try:
        out = []
        kwargs = {"device": "cpu"} if side == "port" else {}
        if mesh is not None:
            kwargs["mesh"] = mesh
        if fuse_scope:
            kwargs["fuse"] = True
        P, blk, src_fn, snk_fn, space = \
            (Pipeline, blocks, array_source, gather_sink, "cuda") \
            if side == "port" else \
            (JaxPipeline, jblocks, j_array_source, j_gather_sink, "tpu")
        with P(**kwargs) as pipe:
            src = src_fn(x, gulp, header=header)
            dev = blk.copy(src, space=space)
            cor = blk.correlate(dev, nint, gulp_nframe=gulp, engine=engine)
            acc = blk.accumulate(cor, nacc_tail)
            snk_fn(acc, out)
            pipe.run()
            if fused_seen is not None:
                fused_seen.extend(b for b in pipe.blocks
                                  if type(b).__name__ == "MeshFusedBlock")
            if report is not None:
                report.append(pipe.fusion_report())
        return np.concatenate(out, axis=0)
    finally:
        cfg.reset("mesh_defer_reduce")


def _jmesh(axes=("time", "freq")):
    return j_make_mesh(8, axes)


# ---------------------------------------------- test_mesh_fusion.py (8)
@pytest.mark.parametrize("engine", ["f32", "int8"])
def test_fused_chain_bitwise_parity_all_modes(engine):
    """Fused-sharded == per-block-sharded == deferred-unfused ==
    single-device == the JAX fused mesh chain, bitwise, for correlate ->
    accumulate on the (4, 2) virtual mesh, both engines."""
    x, header = _int_fx_input()
    mesh = vmesh()
    seen = []
    single = _run_chain("port", x, header, None, True, False,
                        engine=engine)
    fused = _run_chain("port", x, header, mesh, True, True,
                       fused_seen=seen, engine=engine)
    per_block = _run_chain("port", x, header, mesh, False, True,
                           engine=engine)
    deferred_unfused = _run_chain("port", x, header, mesh, True, False,
                                  engine=engine)
    jax_fused = _run_chain("jax", x, header, _jmesh(), True, True,
                           engine=engine)
    assert seen, "fuse scope + mesh chain did not build a MeshFusedBlock"
    assert np.array_equal(single, _vis_windows(x, 32))
    for got in (fused, per_block, deferred_unfused, jax_fused):
        assert np.array_equal(got, single)


def test_per_block_baseline_keeps_unfused_blocks():
    """mesh_defer_reduce=False keeps the per-block chain (no
    MeshFusedBlock), with the JAX planner's reasons for each block."""
    x, header = _int_fx_input(ntime=32)
    seen, rep, jrep = [], [], []
    _run_chain("port", x, header, vmesh(), False, True, fused_seen=seen,
               report=rep)
    _run_chain("jax", x, header, _jmesh(), False, True, report=jrep)
    assert not seen

    def reasons(r):
        return sorted((name.split("_")[0], why)
                      for name, why in r["refused"].items())
    assert reasons(rep[0]) == reasons(jrep[0])
    assert rep[0]["flags"]["mesh_defer_reduce"] is False


def test_fused_plan_report_matches_jax_planner():
    """With deferral on, the mesh_chain rule builds one group from the
    correlate and its accumulate tail: the same group, rule, hops and
    refusals as the JAX planner's."""
    x, header = _int_fx_input(ntime=32)
    rep, jrep = [], []
    _run_chain("port", x, header, vmesh(), True, True, report=rep)
    _run_chain("jax", x, header, _jmesh(), True, True, report=jrep)

    def shape(r):
        return ([(g["rule"], [c.split("_")[0] for c in g["constituents"]],
                  g["ring_hops_eliminated"]) for g in r["groups"]],
                sorted((n.split("_")[0], why)
                       for n, why in r["refused"].items()))
    assert shape(rep[0]) == shape(jrep[0])
    assert rep[0]["groups"][0]["rule"] == "mesh_chain"


def test_fused_chain_collective_counts():
    """The per-gulp partial steps run no collective, the emit's reduce
    exactly one all-reduce, the per-block engine one per gulp: the
    correlate counts and op names equal the JAX HLO audit's; the
    beamform ones follow the JAX docstring's contract (time+beam and
    freq-only meshes)."""
    import jax.numpy as jnp
    from bifrost_tpu.blocks.correlate import (
        _xengine_mesh as j_xmesh, _xengine_mesh_partial as j_xpart)
    from bifrost_tpu.parallel import fuse as jfuse
    from bifrost_tpu.parallel import shard_put as j_shard_put
    from bifrost_tpu_torch.blocks.beamform import _bengine_mesh_partial
    from bifrost_tpu_torch.blocks.correlate import (_xengine_mesh,
                                                    _xengine_mesh_partial)

    mesh, jmesh = vmesh(), _jmesh()
    x = shard_put(torch.zeros((8, 8, 8), dtype=torch.complex64), mesh,
                  ["time", "freq"])
    jx = j_shard_put(jnp.zeros((8, 8, 8), jnp.complex64), jmesh,
                     ["time", "freq"])
    base = fuse.collective_stats(_xengine_mesh(mesh, "time", "freq"), x)
    jbase = jfuse.collective_stats(j_xmesh(jmesh, "time", "freq", "f32"),
                                   jx)
    assert base == jbase
    part = _xengine_mesh_partial(mesh, "time", "freq")
    pacc = part(x)
    jpart = j_xpart(jmesh, "time", "freq", "f32")
    assert fuse.count_collectives(part, x) == 0 == \
        jfuse.count_collectives(jpart, jx)
    assert fuse.count_collectives(
        _xengine_mesh_partial(mesh, "time", "freq", with_acc=True),
        x, pacc) == 0
    red = fuse.collective_stats(
        fuse.make_reduce(mesh, "time", ("freq", None, None)), pacc)
    jred = jfuse.collective_stats(
        jfuse.make_reduce(jmesh, "time", ("freq", None, None)),
        jpart(jx))
    assert red["count"] == 1 and red["ops"] == {"all-reduce": 1}
    # bytes too: one shard's result, (4 channels, 8, 8) complex64
    assert red == jred and red["bytes"] == 4 * 8 * 8 * 8

    # The beam axis is collective-free: a time+beam mesh's partial
    # B-engine runs no collective and its reduce exactly one.
    mesh_tb = vmesh(("time", "beam"))
    xb = shard_put(torch.zeros((8, 4, 8), dtype=torch.complex64), mesh_tb,
                   ["time", "freq"])
    wb = shard_put(torch.zeros((4, 8), dtype=torch.complex64), mesh_tb,
                   ["beam"])
    bpart = _bengine_mesh_partial(mesh_tb, "time", None, None, "beam")
    bacc = bpart(xb, wb)
    assert fuse.count_collectives(bpart, xb, wb) == 0
    bred = fuse.collective_stats(
        fuse.make_reduce(mesh_tb, "time", ("beam", None)), bacc)
    assert bred["count"] == 1 and bred["ops"] == {"all-reduce": 1}
    # Freq-only deferral needs no collective at all, even at the emit.
    mesh_f = vmesh(("freq",))
    xf = shard_put(torch.zeros((8, 8, 8), dtype=torch.complex64), mesh_f,
                   ["time", "freq"])
    pf = _xengine_mesh_partial(mesh_f, None, "freq")
    assert fuse.count_collectives(pf, xf) == 0
    assert fuse.count_collectives(
        fuse.make_reduce(mesh_f, None, ("freq", None, None)), pf(xf)) == 0


def test_beam_sharded_beamform_bitwise_vs_replicated():
    """The multi-beam mesh B-engine: beams on a mesh axis, the weights
    sharded instead of replicated, bitwise against the replicated-weight
    (time, freq) engine, the port's single-device op, the per-gulp-psum
    engine, an f64 golden and the JAX single-device beamform; the staged
    weights are beam-sharded plan state."""
    x, header = _int_fx_input(ntime=64, nchan=8, nstand=4, npol=2)
    nbeam, nsp = 4, 8
    rng = np.random.default_rng(3)
    w = (rng.integers(-4, 4, (nbeam, nsp)) +
         1j * rng.integers(-4, 4, (nbeam, nsp))).astype(np.complex64)
    staged = {}

    def run(mesh, defer=True):
        config.set("mesh_defer_reduce", defer)
        try:
            out = []
            kwargs = {"device": "cpu"}
            if mesh is not None:
                kwargs["mesh"] = mesh
            with Pipeline(**kwargs) as pipe:
                src = array_source(x, 16, header=header)
                dev = blocks.copy(src, space="cuda")
                bfm = blocks.beamform(dev, w, 32, gulp_nframe=16)
                gather_sink(bfm, out)
                pipe.run()
                if mesh is not None and "beam" in mesh.axis_names:
                    staged["wdev"] = bfm._wdev
                    staged["wspec"] = bfm._wspec
            return np.concatenate(out, axis=0)
        finally:
            config.reset("mesh_defer_reduce")

    beam_sharded = run(vmesh(("time", "beam")))
    replicated = run(vmesh(("time", "freq")))
    single = run(None)
    immediate = run(vmesh(("time", "beam")), defer=False)
    assert np.array_equal(beam_sharded, replicated)
    assert np.array_equal(beam_sharded, single)
    assert np.array_equal(immediate, single)
    xm = x.reshape(x.shape[0], x.shape[1], nsp).astype(np.complex128)
    golden = np.stack([
        (lambda b: (b.real ** 2 + b.imag ** 2).sum(axis=0).T)(
            np.einsum("bi,tci->tcb", w.astype(np.complex128),
                      xm[t0:t0 + 32]))
        for t0 in (0, 32)]).astype(np.float32)
    assert np.array_equal(single, golden)
    jout = []
    with JaxPipeline() as pipe:
        src = j_array_source(x, 16, header=header)
        dev = jblocks.copy(src, space="tpu")
        j_gather_sink(jblocks.beamform(dev, w, 32, gulp_nframe=16), jout)
        pipe.run()
    assert np.array_equal(beam_sharded, np.concatenate(jout, axis=0))
    assert staged["wspec"][0] == "beam"
    assert staged["wdev"].sharding.spec[0] == "beam"


def test_sharded_residency_through_intermediate_transform():
    """The layout rides the ring: a generic device transform (transpose)
    between the sharded H2D landing and the consumer keeps its gulps
    sharded over the mesh, time and freq, on all 8 positions."""
    x, header = _int_fx_input(ntime=32, nchan=8)
    out, seen_pre, seen_post = [], [], []
    with Pipeline(device="cpu", mesh=vmesh()) as pipe:
        src = array_source(x, 8, header=header)
        dev = blocks.copy(src, space="cuda")
        p0 = ShardProbe(dev, seen_pre)
        tr = blocks.transpose(p0, ["time", "freq", "pol", "station"])
        p1 = ShardProbe(tr, seen_post)
        cor = blocks.correlate(p1, 32, gulp_nframe=8)
        gather_sink(cor, out)
        pipe.run()
    assert np.array_equal(np.concatenate(out, axis=0), _vis_windows(x, 32))
    assert seen_pre and seen_post
    for sh in seen_post:
        assert len(sh.device_set) == 8
        assert sh.spec[:2] == ("time", "freq")


def test_mesh_gulp_factor_scales_sharded_gulps():
    """mesh_gulp_factor multiplies resolved gulps under a mesh scope
    (source and compute blocks alike), leaves non-mesh pipelines alone,
    exempts the gulp-pinned accumulate, and keeps the output bitwise."""
    x, header = _int_fx_input(ntime=64)
    gulps_seen = []

    def run(factor, mesh):
        config.set("mesh_gulp_factor", factor)
        try:
            out = []
            kwargs = {"device": "cpu"}
            if mesh is not None:
                kwargs["mesh"] = mesh
            with Pipeline(**kwargs) as pipe:
                src = array_source(x, 8, header=header)
                dev = blocks.copy(src, space="cuda")
                cor = blocks.correlate(dev, 32, gulp_nframe=8)
                acc = blocks.accumulate(cor, 2)
                gather_sink(acc, out)
                gulps_seen.append((src.gulp_nframe, cor.gulp_nframe,
                                   acc.gulp_nframe))
                pipe.run()
            return np.concatenate(out, axis=0)
        finally:
            config.reset("mesh_gulp_factor")

    base = run(4, None)
    assert gulps_seen[-1] == (8, 8, 1)
    scaled = run(4, vmesh())
    assert np.array_equal(base, scaled)
    assert gulps_seen[-1] == (32, 32, 1)
    with pytest.raises(ValueError):
        config.set("mesh_gulp_factor", 0)


def test_bounded_fx_cache():
    """The sharded FX step builder is a bounded LRU: every degraded mesh
    is a new key (the JAX builder's retention contract)."""
    from bifrost_tpu_torch.parallel.fx import _build_fx_step
    assert _build_fx_step.cache_info().maxsize == 64


def test_mesh_fused_eviction_realign_continuity():
    """A shard eviction under a fused group: the group's guarded dispatch
    wedges (a position marked lost), the watchdog turns the stall into a
    supervised ShardFault attributed to the fused block, the position is
    evicted, and the group resumes on the 7-survivor mesh (nchan 56 keeps
    its freq slices): bitwise continuity with only the faulted window
    shed, the counters booked on the fused group."""
    from bifrost_tpu_torch.faultinject import FaultPlan
    from bifrost_tpu_torch.parallel import faultdomain
    from bifrost_tpu_torch.supervise import RestartPolicy, Supervisor

    nchan, gulp, nint, ntail = 56, 8, 8, 2
    nacc_in = nint * ntail
    x, header = _int_fx_input(ntime=64, nchan=nchan, nstand=2, npol=2,
                              seed=7)
    mesh = vmesh(("freq",))
    lost_dev = str(mesh.devices.flat[5])
    faultdomain.reset()
    config.set("mesh_defer_reduce", True)
    config.set("mesh_collective_timeout_s", 0.25)
    release = threading.Event()      # never set: the watchdog aborts it
    events = []
    try:
        out, headers = [], []
        with Pipeline(device="cpu", mesh=mesh, fuse=True) as pipe:
            src = array_source(x, gulp, header=header)
            dev = blocks.copy(src, space="cuda")
            cor = blocks.correlate(dev, nint, gulp_nframe=gulp)
            acc = blocks.accumulate(cor, ntail)
            gather_sink(acc, out, headers=headers)
            fused_name = f"MeshFused_{cor.name}+{acc.name}"
            pipe._fuse_device_chains()
            assert any(isinstance(b, MeshFusedBlock) for b in pipe.blocks)

            def on_ev(ev):
                events.append((ev.kind, ev.block))

            sup = Supervisor(policy=RestartPolicy(max_restarts=3,
                                                  backoff=0.01),
                             on_event=on_ev)
            plan = FaultPlan(seed=11)
            # The fused group's guarded dispatches: gulp 0's step (#0),
            # gulp 1's step (#1) and emit (#2), gulp 2's step (#3): the
            # position dies there and the dispatch wedges.
            plan.lose_shard_at("shard.lost", lost_dev, block=fused_name,
                               nth=3)
            plan.wedge_at("shard.dispatch", block=fused_name, nth=3,
                          release=release, timeout=30.0)
            plan.attach(pipe)
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")   # the trailing window
                    pipe.run(supervise=sup)
            finally:
                plan.detach()
        got = np.concatenate(out, axis=0)
        expect = np.concatenate([_vis_windows(x[:16], nacc_in),
                                 _vis_windows(x[24:], nacc_in)], axis=0)
        assert got.shape == expect.shape
        assert np.array_equal(got, expect)
        assert len(headers) == 2
        assert sup.counters["shard_faults"] == 1
        assert sup.counters["shard_evictions"] == 1
        assert sup.counters["escalations"] == 0
        assert ("shard_fault", fused_name) in events
        assert faultdomain.is_evicted(lost_dev)
        assert faultdomain.effective_mesh(mesh).devices.size == 7
        faultdomain.mark_restored(lost_dev)
        faultdomain.restore(lost_dev)
        assert faultdomain.effective_mesh(mesh) is mesh
    finally:
        release.set()
        faultdomain.reset()
        for flag in ("mesh_collective_timeout_s", "mesh_defer_reduce"):
            config.reset(flag)


# ----------------------------------- test_fusion_engines.py mesh case
def test_mesh_sharded_gains_bitwise_vs_single_device():
    """CorrelateBlock(gains=) on ci8 voltages under the (4, 2) mesh: the
    gain fold rides each shard's partial and stays bitwise with the
    single-device run, the JAX mesh chain and an f64 golden (integer
    voltages and gains keep every sum exact), both engines."""
    from bifrost_tpu_torch.ndarray import pair_to_structured
    rng = np.random.default_rng(0)
    data = rng.integers(-8, 8, (64, 8, 4, 2, 2)).astype(np.int8)
    nsp = 4 * 2
    gains = ((np.arange(nsp) % 3) + 1 +
             1j * ((np.arange(nsp) % 2))).astype(np.complex64)
    hdr = {"dtype": "ci8", "labels": list(LABELS)}

    def run(side, mesh, engine):
        chunks = []
        if side == "port":
            P, blk, src_fn, snk, space, kw = (Pipeline, blocks,
                                              array_source, gather_sink,
                                              "cuda", {"device": "cpu"})
        else:
            P, blk, src_fn, snk, space, kw = (JaxPipeline, jblocks,
                                              j_array_source,
                                              j_gather_sink, "tpu", {})
        kw["fuse"] = True
        if mesh is not None:
            kw["mesh"] = mesh
        with P(**kw) as pipe:
            src = src_fn(pair_to_structured(data), 8, header=dict(hdr))
            dev = blk.copy(src, space=space)
            cor = blk.correlate(dev, 16, gulp_nframe=8, gains=gains,
                                engine=engine)
            snk(cor, chunks)
            pipe.run()
        return np.concatenate(chunks, axis=0)

    xg = (data[..., 0].astype(np.float64) + 1j * data[..., 1]) \
        .reshape(64, 8, -1) * gains.astype(np.complex128)
    golden = np.stack([
        np.einsum("tci,tcj->cij", np.conj(xg[t:t + 16]), xg[t:t + 16])
        for t in range(0, 64, 16)]).astype(np.complex64)
    for engine in ("f32", "int8"):
        single = run("port", None, engine)
        sharded = run("port", vmesh(), engine)
        jax_sharded = run("jax", _jmesh(), engine)
        assert np.array_equal(sharded, single)
        assert np.array_equal(sharded, jax_sharded)
        assert np.array_equal(single.reshape(golden.shape), golden)


# ------------------------------------- test_beamform_fir.py mesh case
def test_beamform_mesh_freq_sharded_bitwise_vs_single_device():
    """Freq-only sharding has no reduction across shards and each shard
    keeps the whole local time extent, so on Gaussian data the mesh
    output is bitwise the port's single-device block (K4's order per
    channel is the same) and within 1e-4 relative of the JAX
    single-device beamform; on integer data bitwise the JAX one too."""
    rng = np.random.default_rng(20)
    ntime, nchan, nstand, npol, nbeam = 32, 8, 2, 2, 3
    hdr = {"labels": list(LABELS)}
    for integer in (False, True):
        if integer:
            x = (rng.integers(-8, 8, (ntime, nchan, nstand, npol)) + 1j *
                 rng.integers(-8, 8, (ntime, nchan, nstand, npol)))
            w = (rng.integers(-4, 4, (nbeam, nstand * npol)) + 1j *
                 rng.integers(-4, 4, (nbeam, nstand * npol)))
        else:
            x = (rng.standard_normal((ntime, nchan, nstand, npol)) + 1j *
                 rng.standard_normal((ntime, nchan, nstand, npol)))
            w = (rng.standard_normal((nbeam, nstand * npol)) + 1j *
                 rng.standard_normal((nbeam, nstand * npol)))
        x, w = x.astype(np.complex64), w.astype(np.complex64)

        def run(mesh):
            chunks = []
            kw = {"device": "cpu"}
            if mesh is not None:
                kw["mesh"] = mesh
            with Pipeline(**kw) as pipe:
                src = array_source(x, 32, header=dict(hdr))
                dev = blocks.copy(src, space="cuda")
                gather_sink(blocks.beamform(dev, w, 32, gulp_nframe=32),
                            chunks)
                pipe.run()
            return np.concatenate(chunks, axis=0)

        out_mesh = run(vmesh(("freq",)))
        assert np.array_equal(out_mesh, run(None))
        jout = []
        with JaxPipeline() as pipe:
            src = j_array_source(x, 32, header=dict(hdr))
            dev = jblocks.copy(src, space="tpu")
            j_gather_sink(jblocks.beamform(dev, w, 32, gulp_nframe=32,
                                           method="jnp"), jout)
            pipe.run()
        jout = np.concatenate(jout, axis=0)
        if integer:
            assert np.array_equal(out_mesh, jout)
        else:
            np.testing.assert_allclose(out_mesh, jout, rtol=1e-4,
                                       atol=1e-4 * np.abs(jout).max())
