"""The B and X engines as members of the port's fused groups (the
integrator stages of bifrost_tpu_torch/fuse.py), beside
tests/test_fusion_engines.py.

`CorrelateBlock` and `BeamformBlock` join a fused group behind its H2D
head through the fused-carry protocol: the group calls their own gulp
code on the chunks their ring reads would present, so fused equals
unfused bitwise, for integration boundaries on the gulp grid, inside
gulps, and a partial final gulp.  ci8 voltages of small integers and
small-integer beam weights keep every sum exact in f32, so the port is
also bitwise equal to the JAX fused chain (the JAX test's f32 engine;
the int8 X-engine and ci4 ingest are not ported).  The refusals:
`gulp_pinned` for an integrator with its own gulp_nframe, the chain cut
in front of an integrator behind another one, never `cross_gulp_state`.
The mesh-sharded cases need the mesh layer (not ported).
"""

import numpy as np
import pytest

import bifrost_tpu as jbf
from bifrost_tpu import blocks as jblocks
from bifrost_tpu import config as jconfig
from bifrost_tpu.blocks.testing import array_source as j_array_source
from bifrost_tpu.blocks.testing import gather_sink as j_gather_sink
from bifrost_tpu.pipeline import Pipeline as JaxPipeline

import bifrost_tpu_torch as pbf
from bifrost_tpu_torch import blocks as pblocks
from bifrost_tpu_torch import config as pconfig
from bifrost_tpu_torch.blocks.testing import array_source as p_array_source
from bifrost_tpu_torch.blocks.testing import gather_sink as p_gather_sink
from bifrost_tpu_torch.ndarray import pair_to_structured
from bifrost_tpu_torch.pipeline import Pipeline as PortPipeline

HDR_LABELS = ["time", "freq", "station", "pol"]


def _volt(ntime, nchan=4, nstand=3, npol=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 8, (ntime, nchan, nstand, npol, 2)) \
        .astype(np.int8)


def _run(side, data, fuse_on, engine_of, gulp=8):
    """src -> H2D -> engine under a fuse scope, gathered through a D2H
    copy -> (output frames, fusion report)."""
    config = jconfig if side == "jax" else pconfig
    config.set("pipeline_fuse", fuse_on)
    try:
        chunks = []
        if side == "jax":
            pipe, bfm, blk, src_fn, snk_fn, space = \
                JaxPipeline(), jbf, jblocks, j_array_source, \
                j_gather_sink, "tpu"
            data = pair_to_structured(data)
        else:
            pipe, bfm, blk, src_fn, snk_fn, space = \
                PortPipeline(device="cpu"), pbf, pblocks, p_array_source, \
                p_gather_sink, "cuda"
        with pipe:
            src = src_fn(data, gulp, header={"dtype": "ci8",
                                             "labels": HDR_LABELS})
            with bfm.block_scope(fuse=True):
                dev = blk.copy(src, space=space, name="h2d")
                x = engine_of(blk, dev)
            back = blk.copy(x, space="system", name="d2h")
            snk_fn(back, chunks)
            pipe.run()
            rep = pipe.fusion_report()
        return (np.concatenate([np.asarray(c) for c in chunks], axis=0)
                if chunks else None), rep
    finally:
        config.reset("pipeline_fuse")


def _bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


GRID = [
    (48, 8, 16),          # integration boundaries on the gulp grid
    (48, 8, 12),          # boundaries inside gulps
    (44, 8, 12),          # a partial final gulp (44 = 5 * 8 + 4)
]


@pytest.mark.parametrize("ntime,gulp,n_int", GRID)
def test_correlate_joins_fused_chain_bitwise(ntime, gulp, n_int):
    data = _volt(ntime)

    def corr(blk, dev):
        return blk.correlate(dev, n_int, name="xengine")

    fused, rep = _run("port", data, True, corr, gulp)
    unfused, urep = _run("port", data, False, corr, gulp)
    assert rep["groups"] == [{
        "name": "Fused_h2d+xengine", "rule": "stateful_chain",
        "constituents": ["h2d", "xengine"], "ring_hops_eliminated": 1}]
    assert not urep["groups"]
    assert fused.shape == (ntime // n_int, 4, 3, 2, 3, 2)
    assert _bits(fused, unfused)
    jfused, jrep = _run("jax", data, True, corr, gulp)
    assert [g["constituents"] for g in jrep["groups"]] == \
        [g["constituents"] for g in rep["groups"]]
    assert _bits(fused, jfused)


@pytest.mark.parametrize("ntime,gulp,n_int", GRID)
def test_correlate_int8_joins_fused_chain_bitwise(ntime, gulp, n_int):
    """The int8 cases of tests/test_fusion_engines.py's
    test_correlate_joins_fused_chain_bitwise: the raw ci8 head fused
    (one group, as the JAX planner's), bitwise the unfused run and the
    JAX fused chain."""
    data = _volt(ntime)

    def corr(blk, dev):
        return blk.correlate(dev, n_int, engine="int8", name="xengine")

    fused, rep = _run("port", data, True, corr, gulp)
    unfused, _ = _run("port", data, False, corr, gulp)
    assert [g["constituents"] for g in rep["groups"]] == [["h2d",
                                                          "xengine"]]
    assert _bits(fused, unfused)
    jfused, jrep = _run("jax", data, True, corr, gulp)
    assert [g["constituents"] for g in jrep["groups"]] == \
        [g["constituents"] for g in rep["groups"]]
    assert _bits(fused, jfused)


@pytest.mark.parametrize("ntime,gulp,n_int", GRID)
def test_beamform_joins_fused_chain_bitwise(ntime, gulp, n_int):
    data = _volt(ntime)
    nbeam, nsp = 3, 3 * 2
    w = ((np.arange(nbeam * nsp).reshape(nbeam, nsp) % 5) - 2) \
        .astype(np.complex64)

    def beam(blk, dev):
        return blk.beamform(dev, w, nframe_per_integration=n_int,
                            name="bengine")

    fused, rep = _run("port", data, True, beam, gulp)
    unfused, _ = _run("port", data, False, beam, gulp)
    assert [g["constituents"] for g in rep["groups"]] == \
        [["h2d", "bengine"]]
    assert fused.shape == (ntime // n_int, nbeam, 4)
    assert _bits(fused, unfused)
    jfused, jrep = _run("jax", data, True, beam, gulp)
    assert [g["constituents"] for g in jrep["groups"]] == \
        [g["constituents"] for g in rep["groups"]]
    assert _bits(fused, jfused)


class _Integrator(pbf.TransformBlock):
    """A stand-in integrator stage for the planner (never run)."""

    fused_carry_nframe_per_integration = 4

    def on_sequence(self, iseq):
        return dict(iseq.header)

    def device_kernel_carry(self):
        return lambda x, carry, consts: (x, carry)


def test_integrator_refusal_reasons():
    """An integrator with its own gulp_nframe refuses as gulp_pinned (on
    both packages); an integrator behind another integrator is cut off
    the chain, so the stream it integrates is chunked as its ring read
    would chunk it; none refuses as cross_gulp_state."""
    from bifrost_tpu_torch import fuse
    data = _volt(32)

    def pinned(blk, dev):
        return blk.correlate(dev, 8, gulp_nframe=4, name="xengine")

    for side in ("port", "jax"):
        _, rep = _run(side, data, True, pinned)
        assert rep["refused"]["xengine"] == "gulp_pinned", rep
        assert rep["refused"]["h2d"] == "singleton", rep
        assert "cross_gulp_state" not in rep["refused"].values()

    with PortPipeline(device="cpu") as pipe:
        src = p_array_source(np.zeros((8, 4), np.float32), 4)
        with pbf.block_scope(fuse=True):
            dev = pblocks.copy(src, space="cuda", name="h2d")
            i1 = _Integrator(dev, name="i1")
            i2 = _Integrator(i1, name="i2")
            t = pblocks.transpose(i2, [0, 1], name="t")
        p_gather_sink(t, [])
    rep = fuse.plan(pipe).report()
    assert [g["constituents"] for g in rep["groups"]] == \
        [["h2d", "i1"], ["i2", "t"]]
    assert "cross_gulp_state" not in rep["refused"].values()


def test_beamform_with_accumulate_tail_bitwise():
    """beamform -> transpose -> accumulate: the integrator's emits feed
    the group's carried integration; bitwise against the unfused
    chain."""
    data = _volt(96)
    w = ((np.arange(2 * 6).reshape(2, 6) % 3) - 1).astype(np.complex64)

    def chain(blk, dev):
        b = blk.beamform(dev, w, nframe_per_integration=8, name="bengine")
        t = blk.transpose(b, ["time", "freq", "beam"], name="bt")
        return blk.accumulate(t, 3, name="acc")

    fused, rep = _run("port", data, True, chain)
    unfused, _ = _run("port", data, False, chain)
    assert [g["constituents"] for g in rep["groups"]] == \
        [["h2d", "bengine", "bt", "acc"]]
    assert fused.shape == (96 // 8 // 3, 4, 2)
    assert _bits(fused, unfused)
    _, jrep = _run("jax", data, True, chain)
    assert [g["constituents"] for g in jrep["groups"]] == \
        [g["constituents"] for g in rep["groups"]]


# ----------------------------------------------------- supervised groups
def _restart_run(side, data, n_int, gulp):
    """A fault armed on the CONSTITUENT correlate name (gulp 1) of a
    fused copy -> correlate group, supervised -> (frames, events, plan,
    the fused groups' constituent lists)."""
    if side == "jax":
        from bifrost_tpu.faultinject import FaultPlan
        from bifrost_tpu.supervise import RestartPolicy, Supervisor
        pipe, bfm, blk, src_fn, snk_fn, space = \
            JaxPipeline(), jbf, jblocks, j_array_source, j_gather_sink, "tpu"
        data = pair_to_structured(data)
    else:
        from bifrost_tpu_torch.faultinject import FaultPlan
        from bifrost_tpu_torch.supervise import RestartPolicy, Supervisor
        pipe, bfm, blk, src_fn, snk_fn, space = \
            PortPipeline(device="cpu"), pbf, pblocks, p_array_source, \
            p_gather_sink, "cuda"
    got, events = [], []
    with pipe:
        src = src_fn(data, gulp, header={"dtype": "ci8",
                                         "labels": HDR_LABELS})
        with bfm.block_scope(fuse=True):
            dev = blk.copy(src, space=space)
            cor = blk.correlate(dev, nframe_per_integration=n_int,
                                engine="f32")
        back = blk.copy(cor, space="system")
        snk_fn(back, got)
        pipe._fuse_device_chains()     # fuse first, then arm/attach
        sup = Supervisor(policy=RestartPolicy(max_restarts=3, backoff=0.01),
                         on_event=events.append)
        plan = FaultPlan(seed=3)
        plan.raise_at("block.on_data", block=cor.name, nth=1)
        plan.attach(pipe)
        try:
            pipe.run(supervise=sup)
        finally:
            plan.detach()
        groups = [list(b.constituent_names) for b in pipe.blocks
                  if getattr(b, "constituent_names", None)]
    return np.concatenate(got, axis=0), events, plan, groups, cor.name


def test_fused_integrator_restart_resets_carry_with_attribution():
    """tests/test_fusion_engines.py's case on the port (its 'f32'
    engine: the int8 X-engine is not ported): a fault armed on the
    constituent correlate name fires on the fused group; the supervised
    restart sheds the faulted gulp and RESETS the integration carry (the
    surviving frames integrate from zero, bitwise the f64 golden of
    small integers), the restart event names the constituents, and the
    JAX group under the same plan gives the same frames and events."""
    data = _volt(40, seed=5)
    n_int = gulp = 8                   # aligned: one emission per gulp
    out, events, plan, groups, cor = _restart_run("port", data, n_int, gulp)
    assert any(cor in g for g in groups)
    assert plan.fired(site="block.on_data")
    x = (data[..., 0].astype(np.float64) + 1j * data[..., 1]) \
        .reshape(len(data), data.shape[1], -1)
    keep = np.concatenate([x[:8], x[16:]], axis=0)
    golden = np.stack([
        np.einsum("tci,tcj->cij", np.conj(keep[t:t + 8]), keep[t:t + 8])
        for t in range(0, len(keep) - 7, 8)])
    assert np.array_equal(out.reshape(golden.shape),
                          golden.astype(np.complex64))
    restarts = [ev for ev in events if ev.kind == "restart"]
    assert restarts, [e.as_dict() for e in events]
    assert cor in restarts[0].details["constituents"]
    j_out, j_events, _, _, j_cor = _restart_run("jax", data, n_int, gulp)
    assert _bits(out, j_out.reshape(out.shape))
    assert [(e.kind, len(e.details.get("constituents", ())))
            for e in events] == \
        [(e.kind, len(e.details.get("constituents", ()))) for e in j_events]
