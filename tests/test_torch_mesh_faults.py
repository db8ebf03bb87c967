"""Mesh fault domains in the port (bifrost_tpu_torch/parallel/faultdomain.py
and its seams in supervise, faultinject, service and fleet), beside
tests/test_faultdomain.py, tests/test_supervise.py's mesh case and
tests/test_fleet.py's eviction cases, on a virtual mesh of 8 CPU
positions (`virtual_devices(8, 'cpu')`, keys ``cpu/0`` .. ``cpu/7``).

The collective watchdog turns a dispatch that misses
`mesh_collective_timeout_s` into a ShardFault attributed to the lost
position; the supervisor evicts it and restarts the block onto the
survivors; the service books the skipped gulp as shed by a shard and
restores the position once its health returns; the fleet preempts where
an eviction over-commits the shared mesh.  The supervised service case
runs the same scenario on the JAX service (its mesh block a shard_map)
and holds the port's report to it.
"""

import threading
import time

import numpy as np
import pytest

import torch

from bifrost_tpu_torch import config
from bifrost_tpu_torch.blocks.testing import array_source
from bifrost_tpu_torch.faultinject import FaultPlan
from bifrost_tpu_torch.parallel import (faultdomain, make_fx_step,
                                        make_mesh, mesh_axes_for,
                                        shard_put, virtual_devices)
from bifrost_tpu_torch.parallel.collective import psum
from bifrost_tpu_torch.parallel.faultdomain import ShardFault
from bifrost_tpu_torch.parallel.shard import shard_views
from bifrost_tpu_torch.pipeline import (Pipeline, SinkBlock, TransformBlock,
                                        block_scope)
from bifrost_tpu_torch.supervise import RestartPolicy, Supervisor


def vmesh(axes=("freq",), n=8):
    return make_mesh(devices=virtual_devices(n, "cpu"), axis_names=axes)


@pytest.fixture(autouse=True)
def _clean_registry():
    faultdomain.reset()
    yield
    config.reset("mesh_collective_timeout_s")
    faultdomain.reset()


class MeshDouble(TransformBlock):
    """Freq-sharded x * 2 plus a (zero) psum over the freq axis, so every
    gulp crosses a collective; the dispatch runs under the watchdog."""

    def on_sequence(self, iseq):
        return dict(iseq.header)

    def on_data(self, ispan, ospan):
        mesh = self.bound_mesh
        x = ispan.data
        fax = mesh_axes_for(mesh, ["time", "freq"], shape=tuple(x.shape))[1]

        def fn(x):
            if fax is None:
                return x * 2
            v = shard_views(mesh, x, (None, fax))
            z = psum(v.map(lambda t: t.sum() * 0), fax)
            return v.zip_map(lambda t, s: t * 2 + s, z).assemble()
        ospan.data.copy_(self.mesh_dispatch(fn, x, mesh=mesh))


class GatherSink(SinkBlock):
    def __init__(self, iring, **kwargs):
        super().__init__(iring, **kwargs)
        self.chunks = []
        self.nseqs = 0

    def on_sequence(self, iseq):
        self.nseqs += 1

    def on_data(self, ispan):
        self.chunks.append(np.array(ispan.data))


# ------------------------------------------------------------- watchdog
def test_guard_inert_without_timeout():
    holder = faultdomain._GuardHolder("probe")
    assert faultdomain.guarded_call(holder, vmesh(n=2),
                                    lambda a, b: a + b, (1, 2)) == 3


def test_watchdog_declares_shard_fault_with_attribution():
    """An overdue dispatch raises ShardFault when it returns; the suspect
    is the lost position inside the dispatch's mesh."""
    mesh = vmesh(n=4)
    faultdomain.mark_lost("cpu/2")
    faultdomain.mark_lost("not_a_mesh_device")
    config.set("mesh_collective_timeout_s", 0.15)
    holder = faultdomain._GuardHolder("probe")
    t0 = time.monotonic()
    with pytest.raises(ShardFault) as exc_info:
        faultdomain.guarded_call(holder, mesh, lambda: time.sleep(0.5), ())
    assert time.monotonic() - t0 >= 0.5
    fault = exc_info.value
    assert (fault.device, fault.block) == ("cpu/2", "probe")
    assert "deadline" in fault.reason


def test_watchdog_fast_dispatch_unharmed():
    config.set("mesh_collective_timeout_s", 5.0)
    holder = faultdomain._GuardHolder("probe")
    assert faultdomain.guarded_call(holder, vmesh(n=2), lambda: 7, ()) == 7
    assert holder._shard_abort is None


def test_guarded_wrapper_carries_its_own_holder():
    """make_fx_step's guarded wrapper: a watchdog deadline set, a fast
    step passes; the wrapped step is the unguarded function."""
    config.set("mesh_collective_timeout_s", 30.0)
    step = make_fx_step(vmesh(("time", "freq"), n=4), nfine=2)
    assert step.guard_name == "fx_step"
    x = np.zeros((4, 2, 2, 2, 2), dtype=np.int8)
    w = np.zeros((1, 4), dtype=np.complex64)
    vis, beam, spec = step(x, w)
    assert tuple(spec.shape) == (4,)
    assert step.__wrapped__ is not step


# ------------------------------------------------ eviction / effective
def test_effective_mesh_identity_without_evictions():
    mesh = vmesh(("time", "freq"))
    assert faultdomain.effective_mesh(mesh) is mesh
    assert faultdomain.effective_mesh(None) is None


def test_evict_rebuilds_and_restore_returns():
    """8 - 1 = 7 survivors re-factor to (7,) on a freq mesh and to (7, 1)
    on a (time, freq) one, the axis names kept; cached per eviction set;
    a restore returns the mesh itself."""
    mesh = vmesh()
    mesh2 = vmesh(("time", "freq"))
    assert faultdomain.evict("cpu/3") is True
    assert faultdomain.evict("cpu/3") is False
    degraded = faultdomain.effective_mesh(mesh)
    assert degraded.devices.shape == (7,)
    assert "cpu/3" not in {str(d) for d in degraded.devices.flat}
    assert faultdomain.effective_mesh(mesh2).devices.shape == (7, 1)
    assert faultdomain.effective_mesh(mesh2).axis_names == ("time", "freq")
    assert faultdomain.effective_mesh(mesh) is degraded
    faultdomain.restore("cpu/3")
    assert faultdomain.effective_mesh(mesh) is mesh


def test_evict_all_devices_raises():
    mesh = vmesh(n=2)
    for d in mesh.devices.flat:
        faultdomain.evict(str(d))
    with pytest.raises(ShardFault, match="every device"):
        faultdomain.effective_mesh(mesh)


def test_realign_stale_sharded_args():
    """A gulp laid out on the full mesh feeds a dispatch on the degraded
    one: the realign re-binds its layout (the freq spec kept, 56 divides
    7) without moving a byte; other arguments pass through, and with
    no realignment needed the tuple itself."""
    mesh = vmesh()
    x = torch.arange(4 * 56, dtype=torch.float32).reshape(4, 56)
    st = shard_put(x, mesh, ["time", "freq"])
    faultdomain.evict("cpu/5")
    degraded = faultdomain.effective_mesh(mesh)
    (rx,) = faultdomain._realign_args(degraded, (st,))
    assert rx.sharding.mesh == degraded and rx.sharding.spec == (None,
                                                                 "freq")
    assert rx.data.data_ptr() == x.data_ptr()
    args = (x, rx)
    assert faultdomain._realign_args(degraded, args) is args
    # ragged: 64 channels divide 8 but not 7, so freq goes replicated
    st64 = shard_put(torch.zeros(4, 64), mesh, ["time", "freq"])
    assert st64.sharding.spec == (None, "freq")
    (r64,) = faultdomain._realign_args(degraded, (st64,))
    assert r64.sharding.spec == (None, None)


def test_partial_of_old_geometry_faults_loudly():
    """A partial carried from the 8-position mesh cannot be added into
    the 7-survivor one, nor reduced on it: the shape-strict add and the
    reduce raise."""
    from bifrost_tpu_torch.blocks.correlate import _xengine_mesh_partial
    from bifrost_tpu_torch.parallel import fuse
    mesh = vmesh()
    x = torch.zeros((8, 56, 4), dtype=torch.complex64)
    pacc = _xengine_mesh_partial(mesh, None, "freq")(x)
    faultdomain.evict("cpu/5")
    degraded = faultdomain.effective_mesh(mesh)
    with pytest.raises(ValueError, match="geometr"):
        _xengine_mesh_partial(degraded, None, "freq", with_acc=True)(x,
                                                                      pacc)
    with pytest.raises(ValueError, match="geometry"):
        fuse.make_reduce(degraded, None, ("freq", None, None))(pacc)


def test_note_geometry_change_rebuilds_and_realigns():
    """A fleet resize bumps the epoch: the realign scan runs, the
    transition is booked and the listeners fire."""
    seen = []
    cb = faultdomain.add_transition_listener(
        lambda kind, key: seen.append((kind, key)))
    try:
        assert faultdomain._evict_epoch == 0
        faultdomain.note_geometry_change("fleet:hi")
        assert faultdomain._evict_epoch == 1
        assert seen == [("resize", "fleet:hi")]
        mesh = vmesh()
        other = vmesh(("time", "freq"))
        st = shard_put(torch.zeros(8, 8), other, ["time", "freq"])
        (r,) = faultdomain._realign_args(mesh, (st,))
        assert r.sharding.mesh == mesh
    finally:
        faultdomain.remove_transition_listener(cb)


# -------------------------------------------------------- availability
def test_availability_accounting():
    assert faultdomain.availability_pct() == 100.0
    faultdomain._register_mesh(vmesh(n=4))
    assert faultdomain.availability_pct() == 100.0
    assert faultdomain.tracked_devices() == [f"cpu/{i}" for i in range(4)]
    faultdomain.evict("cpu/1")
    time.sleep(0.05)
    assert faultdomain.availability_pct() < 100.0
    assert faultdomain.downtime_by_device()["cpu/1"] > 0.0
    faultdomain.restore("cpu/1")
    frozen = faultdomain.downtime_by_device()
    time.sleep(0.02)
    assert faultdomain.downtime_by_device()["cpu/1"] == frozen["cpu/1"]
    assert [k for k, _d, _t in faultdomain.transitions()] == \
        ["evict", "restore"]


def test_guarded_dispatch_registers_its_mesh():
    """With the watchdog armed, a guarded dispatch folds its mesh's
    positions into availability (the shard-health snapshot)."""
    config.set("mesh_collective_timeout_s", 5.0)
    faultdomain.guarded_call(faultdomain._GuardHolder("p"), vmesh(n=2),
                             lambda: None, ())
    faultdomain.mark_lost("cpu/0")
    faultdomain.evict("cpu/0")
    health = faultdomain.shard_health()
    assert health["cpu/0"]["healthy"] is False
    assert health["cpu/0"]["evicted"] is True
    assert health["cpu/1"] == {"healthy": True, "evicted": False,
                               "evicted_for_s": None}


# ------------------------------------------------- faultinject plumbing
def test_wedge_unparked_by_shard_abort():
    class FakeBlock(object):
        name = "blk"
        _supervisor = None
        _shard_abort = None

    block = FakeBlock()
    plan = FaultPlan()
    release = threading.Event()
    plan.wedge_at("shard.dispatch", block="blk", release=release,
                  timeout=30.0)
    done = []

    def park():
        plan._run_action(plan.points[0], "shard.dispatch", block, block)
        done.append(time.monotonic())

    t = threading.Thread(target=park, daemon=True)
    t0 = time.monotonic()
    t.start()
    time.sleep(0.1)
    assert not done
    block._shard_abort = ShardFault(block="blk")
    t.join(5.0)
    assert done and done[0] - t0 < 5.0


def test_lose_shard_at_marks_device_lost():
    plan = FaultPlan()
    plan.lose_shard_at("shard.lost", "cpu/2", block="blk")
    plan._run_action(plan.points[0], "shard.lost", None, None)
    assert faultdomain.is_lost("cpu/2")


@pytest.mark.parametrize("site", ["collective.enter", "shard.lost",
                                  "shard.dispatch"])
def test_collective_site_fires_on_a_mesh_block(site):
    """Each collective site armed on a mesh block fires on its guarded
    dispatches, in the JAX order (collective.enter, shard.lost,
    shard.dispatch, once a dispatch), and a raise there is a supervised
    restart that sheds the gulp."""
    data = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    order = []
    with Pipeline(device="cpu", mesh=vmesh()) as pipe:
        src = array_source(data, 8, header={"labels": ["time", "freq"]})
        blk = MeshDouble(src)
        sink = GatherSink(blk)
        plan = FaultPlan(seed=1)
        for s in ("collective.enter", "shard.lost", "shard.dispatch"):
            plan.call_at(s, lambda s_, b, o: order.append(s_),
                         block=blk.name, nth=0, count=None)
        plan.raise_at(site, block=blk.name, nth=3)
        plan.attach(pipe)
        sup = Supervisor(policy=RestartPolicy(max_restarts=3,
                                              backoff=0.01))
        try:
            pipe.run(supervise=sup)
        finally:
            plan.detach()
    assert order[:3] == ["collective.enter", "shard.lost",
                         "shard.dispatch"]
    assert sup.counters["restarts"] == 1
    got = np.concatenate(sink.chunks, axis=0)
    expect = np.concatenate([data[:24] * 2, data[32:] * 2])
    assert np.array_equal(got, expect)
    assert len(plan.fired(site=site)) >= 1


# ------------------------------------- supervised end to end (supervise)
def test_mesh_shard_wedge_supervised_restart_continuity():
    """A freq-sharded transform's dispatch wedges with its position
    marked lost; the watchdog declares a ShardFault within the deadline,
    the position is evicted (the block resumes on the 7 survivors; 56
    channels keep their slices), the chain keeps streaming: bitwise
    continuity with one gulp shed, and the shard returns on restore."""
    nchan, gulp = 56, 8
    data = np.arange(64 * nchan, dtype=np.float32).reshape(64, nchan)
    mesh = vmesh()
    lost = "cpu/5"
    config.set("mesh_collective_timeout_s", 0.25)
    release = threading.Event()
    try:
        with Pipeline(device="cpu", mesh=mesh) as pipe:
            src = array_source(data, gulp,
                               header={"labels": ["time", "freq"]})
            sq = MeshDouble(src)
            sink = GatherSink(sq)
            sup = Supervisor(policy=RestartPolicy(max_restarts=3,
                                                  backoff=0.01))
            plan = FaultPlan(seed=3)
            plan.lose_shard_at("shard.lost", lost, block=sq.name, nth=2)
            plan.wedge_at("shard.dispatch", block=sq.name, nth=2,
                          release=release, timeout=30.0)
            plan.attach(pipe)
            try:
                pipe.run(supervise=sup)
            finally:
                plan.detach()
        out = np.concatenate(sink.chunks, axis=0)
        expect = np.concatenate([data[:16] * 2, data[24:] * 2], axis=0)
        assert np.array_equal(out, expect)
        assert sink.nseqs == 2
        assert sup.counters["escalations"] == 0
        assert sup.counters["shard_faults"] == 1
        assert sup.counters["shard_evictions"] == 1
        assert sup.counters["restarts"] == 1
        sf = [e for e in sup.events if e.kind == "shard_fault"]
        assert sf and sf[0].details["device"] == lost
        assert sf[0].details["timeout_s"] == 0.25
        restart = sup.events_for(sq.name, "restart")[0]
        assert restart.details["shard_device"] == lost
        assert restart.details["shed_nframe"] == gulp
        assert sup.shard_recovery_stats()["count"] == 1
        assert faultdomain.evicted_devices() == [lost]
        assert faultdomain.effective_mesh(mesh).devices.size == 7
        faultdomain.mark_restored(lost)
        assert faultdomain.restorable_devices() == [lost]
        faultdomain.restore(lost)
        assert faultdomain.effective_mesh(mesh) is mesh
        assert faultdomain.availability_pct() < 100.0
    finally:
        release.set()


def test_shard_seams_record_events():
    """record_shard_fault / record_shard_restore book their events and
    counters (the seams the watchdog and the service call)."""
    sup = Supervisor()
    sup.record_shard_fault("b", ShardFault(device="cpu/1", block="b",
                                           gulp=8), timeout_s=0.5)
    sup.record_shard_restore("cpu/1")
    assert sup.counters["shard_faults"] == 1
    assert sup.counters["shard_restores"] == 1
    ev = [e for e in sup.events if e.kind == "shard_fault"][0]
    assert (ev.details["device"], ev.details["gulp"],
            ev.details["timeout_s"]) == ("cpu/1", 8, 0.5)
    assert sup.shard_recovery_stats()["count"] == 0


# -------------------------------------------------- service: degrade
def _service_case(side):
    """A supervised Service with a mesh stage whose gulp-2 dispatch
    wedges after its position is marked lost -> (exit report, health
    while degraded, health after the auto-restore, output)."""
    nchan, gulp = 56, 8
    data = np.arange(64 * nchan, dtype=np.float32).reshape(64, nchan)
    out = []
    if side == "port":
        from bifrost_tpu_torch import config as cfg
        from bifrost_tpu_torch import service as S
        from bifrost_tpu_torch.faultinject import FaultPlan as FP
        from bifrost_tpu_torch.parallel import faultdomain as fd
        from bifrost_tpu_torch.supervise import RestartPolicy as RP
        mesh = vmesh()
        lost = "cpu/5"
        src_fn = array_source

        def stage(up, **k):
            with block_scope(mesh=mesh):
                return MeshDouble(up, name="mesh_stage")

        def sink(up, **k):
            return GatherSink(up, name="sink")
        kw = {"device": "cpu"}
    else:
        import jax
        import jax.numpy as jnp
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        from bifrost_tpu import config as cfg
        from bifrost_tpu import service as S
        from bifrost_tpu.blocks.testing import array_source as src_fn
        from bifrost_tpu.blocks.testing import gather_sink
        from bifrost_tpu.faultinject import FaultPlan as FP
        from bifrost_tpu.parallel import faultdomain as fd
        from bifrost_tpu.parallel import make_mesh as jmm
        from bifrost_tpu.parallel import mesh_axes_for as jmaf
        from bifrost_tpu.pipeline import TransformBlock as JT
        from bifrost_tpu.pipeline import block_scope as jbs
        from bifrost_tpu.supervise import RestartPolicy as RP
        mesh = jmm(8, ("freq",))
        lost = str(jax.devices()[5])

        class JMeshDouble(JT):
            """The JAX form of MeshDouble: a shard_map with a zero psum."""

            def on_sequence(self, iseq):
                return dict(iseq.header)

            def on_data(self, ispan, ospan):
                m = self.bound_mesh
                fax = jmaf(m, ["time", "freq"], shape=ispan.data.shape)[1]
                if fax is None:
                    fn = jax.jit(lambda x: x * 2)
                else:
                    fn = jax.jit(shard_map(
                        lambda x: x * 2 + jax.lax.psum(jnp.sum(x) * 0,
                                                       fax),
                        mesh=m, in_specs=P(None, fax),
                        out_specs=P(None, fax)))
                ospan.data = self.mesh_dispatch(fn, ispan.data, mesh=m)

        def stage(up, **k):
            with jbs(mesh=mesh):
                return JMeshDouble(up, name="mesh_stage")

        def sink(up, **k):
            return gather_sink(up, out, name="sink")
        kw = {}

    fd.reset()
    release = threading.Event()
    cfg.set("mesh_collective_timeout_s", 2.0)
    try:
        stages = [
            S.StageSpec("custom", name="source", params=dict(
                factory=lambda _up, **k: src_fn(
                    data, gulp, header={"labels": ["time", "freq"]},
                    name="src"))),
            S.StageSpec("custom", name="mesh_stage",
                        params=dict(factory=stage),
                        restart=RP(max_restarts=4, window_s=30.0,
                                   backoff=0.01)),
            S.StageSpec("custom", name="sink", params=dict(factory=sink)),
        ]
        spec = S.ServiceSpec(stages, degrade_shards=True,
                             health_interval_s=0.05)
        svc = S.Service(spec, **kw)
        svc.pipeline._fuse_device_chains()
        plan = FP(seed=5)
        plan.lose_shard_at("shard.lost", lost, block="mesh_stage", nth=2)
        plan.wedge_at("shard.dispatch", block="mesh_stage", nth=2,
                      release=release, timeout=30.0)
        plan.attach(svc.pipeline)
        svc.start()
        svc.wait(timeout=60)
        degraded = svc.health()
        fd.mark_restored(lost)
        deadline = time.monotonic() + 10
        while svc.health()["shard_degraded"] and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        healed = svc.health()
        rep = svc.stop(timeout=10)
        plan.detach()
        if side == "port":
            out = [c for b in svc.pipeline.blocks if b.name == "sink"
                   for c in b.chunks]
        return rep, degraded, healed, np.concatenate(out, axis=0), data
    finally:
        release.set()
        cfg.reset("mesh_collective_timeout_s")
        fd.reset()


def test_service_degrade_shards_sheds_and_restores():
    """degrade_shards: the eviction puts the service in degraded-mesh
    state instead of escalating, the skipped gulp is booked as shed by a
    shard (never lost), the health loop restores the position once its
    health returns and the state clears; availability drops below 100.
    The port's report is held to the JAX service's on the same
    scenario."""
    rep, degraded, healed, got, data = _service_case("port")
    jrep, jdegraded, jhealed, jgot, _ = _service_case("jax")
    expect = np.concatenate([data[:16] * 2, data[24:] * 2])
    assert np.array_equal(got, expect)
    assert np.array_equal(jgot, expect)
    assert degraded["shard_degraded"] is True
    assert healed["shard_degraded"] is False
    assert degraded["shard_degraded"] == jdegraded["shard_degraded"]
    assert healed["shard_degraded"] == jhealed["shard_degraded"]
    for r in (rep, jrep):
        assert r.ledger["shard_shed_frames"] == 8
        assert r.ledger["lost_frames"] == 0
        assert r.counters["shard_faults"] == 1
        assert r.counters["shard_evictions"] == 1
        assert r.counters["shard_restores"] == 1
        assert r.counters["escalations"] == 0
        assert r.availability["availability_pct"] < 100.0
        assert r.availability["shard_recovery"]["count"] == 1
        assert r.availability["shard_degrade_episodes"] == 1
    assert rep.exit_code == jrep.exit_code
    assert rep.ledger["shard_shed_frames"] == jrep.ledger["shard_shed_frames"]


# ------------------------------------------------- fleet: shared mesh
def _mesh_tenant(data, mesh, pace_s=0.05):
    from bifrost_tpu_torch.service import ServiceSpec, StageSpec

    class Paced(MeshDouble):
        def on_data(self, ispan, ospan):
            time.sleep(pace_s)
            super().on_data(ispan, ospan)

    def stage(up, **k):
        with block_scope(mesh=mesh):
            return Paced(up)
    return lambda: ServiceSpec([
        StageSpec("custom", name="source", params=dict(
            factory=lambda _up, **k: array_source(
                data, 16, header={"labels": ["time", "freq"]}))),
        StageSpec("custom", name="mesh", params=dict(factory=stage)),
        StageSpec("detect", params=dict(threshold=1e9, gulp_nframe=16)),
    ], heartbeat_interval_s=1.0, heartbeat_misses=30)


ENDLESS = (np.arange(16384 * 56, dtype=np.float32).reshape(16384, 56) % 23)


def test_priority_preemption_on_shard_eviction_and_restore():
    """Two tenants share an 8-position virtual mesh: evicting one
    position preempts the lower-priority tenant while the other streams
    on, its mesh stage resolving the 7 survivors; the restore re-admits
    the preempted one and the mesh is whole again."""
    from bifrost_tpu_torch.fleet import (EXIT_DEGRADED, FleetScheduler,
                                         TenantSpec)
    mesh = vmesh()
    fleet = FleetScheduler(device="cpu", devices_total=8)
    hi = fleet.submit(TenantSpec("hi", _mesh_tenant(ENDLESS, mesh),
                                 priority=10, devices=4))
    lo = fleet.submit(TenantSpec("lo", _mesh_tenant(ENDLESS, mesh),
                                 priority=1, devices=4))
    assert hi.state == lo.state == "running"
    faultdomain.mark_lost("cpu/3")
    faultdomain.evict("cpu/3")
    fleet.poll()
    assert lo.state == "preempted" and hi.state == "running"
    assert fleet.counters["evictions_seen"] == 1
    assert fleet.devices_effective() == 7
    stage = hi.service.blocks["mesh"]
    assert stage.bound_mesh.devices.size == 7
    faultdomain.restore("cpu/3")
    fleet.poll()
    assert lo.state == "running" and lo.admissions == 2
    assert stage.bound_mesh is mesh
    rep = fleet.stop(timeout=5.0)
    assert rep.exit_code == EXIT_DEGRADED
    assert rep.counters["preempted"] == 1


def test_resize_collides_with_shard_eviction_same_tick():
    """A grow and an eviction in one tick: the grow preempts the lower
    tenant against the evicted budget, and the resize's geometry change
    makes every guarded dispatch re-resolve its mesh (the realign scan
    on) while the running tenant keeps streaming on the survivors."""
    from bifrost_tpu_torch.fleet import FleetScheduler, TenantSpec
    mesh = vmesh()
    fleet = FleetScheduler(device="cpu", devices_total=8)
    hi = fleet.submit(TenantSpec("hi", _mesh_tenant(ENDLESS, mesh),
                                 priority=10, devices=4))
    lo = fleet.submit(TenantSpec("lo", _mesh_tenant(ENDLESS, mesh),
                                 priority=1, devices=4))
    faultdomain.evict("cpu/0")            # 8 -> 7, not yet polled
    epoch = faultdomain._evict_epoch
    rec = fleet.resize("hi", 6)
    assert rec["preempted"] == ["lo"]     # 6 + 4 > 7
    assert faultdomain._evict_epoch == epoch + 1
    fleet.poll()
    assert fleet.counters["evictions_seen"] == 1
    assert fleet.counters["resizes_seen"] >= 1
    snap = fleet.snapshot()
    assert snap["devices"]["effective"] == 7
    assert snap["devices"]["committed"] <= 7
    assert hi.state == "running"
    assert lo.state in ("preempted", "queued")
    assert hi.service.blocks["mesh"].bound_mesh.devices.size == 7
    fleet.stop(timeout=5.0)
