"""The port's fleet scheduler (bifrost_tpu_torch/fleet.py) on the CPU.

The first twenty-six tests mirror tests/test_fleet.py's cases on the
port (`device='cpu'`), on the same small socket-free chains of 'custom'
stages with named fake devices in the device registry
(parallel/faultdomain.py), driven with `poll()` where a test needs
determinism: admission (accept, queue, reject), the ring and staging
budgets, the fleet staging pool's quotas, ring-byte sampling, priority
preemption on eviction and its reaping order, tenant isolation, the
snapshot and its ProcLog row, the exit codes, the supervisor's
aggregate seams, live respec, resize, rolling redeploy and the
starvation guard.

Then the parity script: one seeded sequence of submissions, a fault, a
respec, evictions, a restore, a resize and a redeploy, driven through
the JAX `FleetScheduler` and the port's with `poll()` alone.  Their
admission, queue, rejection and preemption decisions, counters, event
kinds, exit codes, the ledgers of every run that ended on its own (lost
== dup == 0 in every run), snapshot keys and `fleet_metrics` row keys
are equal, and each tenant's candidates are the JAX tenant's on the
same numpy data.  Last, the five fleet flags against the JAX registry's
defaults and validation, and the kernel cache's flag and directory.
"""

import os
import threading
import time

import numpy as np
import pytest

from bifrost_tpu_torch.blocks.testing import array_source
from bifrost_tpu_torch.fleet import (EXIT_CLEAN, EXIT_DEGRADED,
                                     EXIT_ESCALATED, FleetScheduler,
                                     FleetStagingPool, TenantSpec)
from bifrost_tpu_torch.parallel import faultdomain
from bifrost_tpu_torch.pipeline import TransformBlock
from bifrost_tpu_torch.service import ServiceSpec, StageSpec
from bifrost_tpu_torch.supervise import RestartPolicy, Supervisor

DATA = (np.arange(256 * 8, dtype=np.float32).reshape(256, 8) % 23)
LONG_DATA = (np.arange(1024 * 8, dtype=np.float32).reshape(1024, 8) % 23)
# A stream that cannot finish before a scheduler action lands (1024
# gulps paced at 0.05 s or more); _stop() preempt-quiesces it.
ENDLESS_DATA = (np.arange(16384 * 8, dtype=np.float32).reshape(16384, 8)
                % 23)
GULP = 16


def Fleet(**kw):
    return FleetScheduler(device="cpu", **kw)


class FlakyTransform(TransformBlock):
    """Copy transform raising `nfaults` times at gulp `fault_gulp`."""

    def __init__(self, iring, fault_gulp=2, nfaults=1, **kwargs):
        super().__init__(iring, **kwargs)
        self.fault_gulp = fault_gulp
        self.nfaults = nfaults
        self._gulps = 0

    def on_sequence(self, iseq):
        return dict(iseq.header)

    def on_data(self, ispan, ospan):
        g = self._gulps
        self._gulps += 1
        if g >= self.fault_gulp and self.nfaults > 0:
            self.nfaults -= 1
            raise RuntimeError("injected tenant fault")
        ospan.data[...] = ispan.data
        return ispan.nframe


class PacedTransform(TransformBlock):
    """Copy transform with per-gulp pacing, so that a chain is still
    streaming when a scheduler action lands."""

    def __init__(self, iring, pace_s=0.01, **kwargs):
        super().__init__(iring, **kwargs)
        self.pace_s = pace_s

    def on_sequence(self, iseq):
        return dict(iseq.header)

    def on_data(self, ispan, ospan):
        time.sleep(self.pace_s)
        ospan.data[...] = ispan.data
        return ispan.nframe


def _chain_spec(data=DATA, gulp=GULP, flaky=None, pace_s=0.0, **kw):
    stages = [StageSpec("custom", name="source", params=dict(
        factory=lambda _up, **k: array_source(data, gulp)))]
    if flaky is not None:
        fault_gulp, nfaults = flaky
        stages.append(StageSpec("custom", name="flaky", params=dict(
            factory=lambda up, **k: FlakyTransform(
                up, fault_gulp=fault_gulp, nfaults=nfaults,
                name="flaky")),
            restart=RestartPolicy(max_restarts=4, window_s=30.0,
                                  backoff=0.01)))
    if pace_s:
        stages.append(StageSpec("custom", name="paced", params=dict(
            factory=lambda up, **k: PacedTransform(up, pace_s=pace_s))))
    stages.append(StageSpec("detect", params=dict(threshold=1e9,
                                                  gulp_nframe=gulp)))
    kw.setdefault("heartbeat_interval_s", 1.0)
    kw.setdefault("heartbeat_misses", 30)
    return lambda: ServiceSpec(stages, **kw)


@pytest.fixture(autouse=True)
def _clean_faultdomain():
    faultdomain.reset()
    yield
    faultdomain.reset()


def _stop(fleet, timeout=5.0):
    return fleet.stop(timeout=timeout)


# ---------------------------------------------------------------- admission
def test_admission_accept_queue_reject():
    fleet = Fleet(devices_total=4, max_queue=1)
    a = fleet.submit(TenantSpec("a", _chain_spec(pace_s=0.02),
                                priority=5, devices=2))
    b = fleet.submit(TenantSpec("b", _chain_spec(pace_s=0.02),
                                priority=5, devices=2))
    assert a.state == "running" and b.state == "running"
    c = fleet.submit(TenantSpec("c", _chain_spec(), priority=1, devices=2))
    assert c.state == "queued"
    d = fleet.submit(TenantSpec("d", _chain_spec(), priority=1, devices=2))
    assert d.state == "rejected"
    assert "queue is full" in d.reject_reason
    e = fleet.submit(TenantSpec("e", _chain_spec(), devices=5))
    assert e.state == "rejected"
    assert "exceeds fleet total" in e.reject_reason
    assert fleet.counters["rejected"] == 2
    assert fleet.wait(timeout=30.0, drain_queue=True)
    assert c.admissions == 1
    rep = _stop(fleet)
    assert rep.counters["admitted"] == 3
    assert rep.tenants["d"]["state"] == "rejected"


def test_duplicate_tenant_name_rejected_loudly():
    fleet = Fleet(devices_total=2)
    fleet.submit(TenantSpec("a", _chain_spec(), devices=1))
    with pytest.raises(ValueError, match="already submitted"):
        fleet.submit(TenantSpec("a", _chain_spec(), devices=1))
    _stop(fleet)


def test_ring_and_staging_budgets_gate_admission():
    fleet = Fleet(ring_bytes_total=1 << 20, staging_bytes_total=1 << 20)
    a = fleet.submit(TenantSpec("a", _chain_spec(pace_s=0.02),
                                ring_bytes=768 << 10))
    b = fleet.submit(TenantSpec("b", _chain_spec(), ring_bytes=512 << 10))
    assert a.state == "running"
    assert b.state == "queued"          # 768k + 512k > 1M
    c = fleet.submit(TenantSpec("c", _chain_spec(),
                                staging_bytes=2 << 20))
    assert c.state == "rejected"        # can never fit
    assert fleet.wait(timeout=30.0, drain_queue=True)
    _stop(fleet)


# ------------------------------------------------------------------ quotas
def test_fleet_staging_pool_per_tenant_retention_quota():
    pool = FleetStagingPool(total_bytes=0)
    view = pool.view("a", quota_bytes=2048)
    b1 = view.acquire(1024)
    b2 = view.acquire(1024)
    b3 = view.acquire(1024)                    # burst past quota
    assert view.stats()["over_quota_allocs"] == 1
    view.release(b1)
    view.release(b2)
    assert view.stats()["retained_bytes"] == 2048
    view.release(b3)                           # over quota: dropped
    assert view.stats()["retained_bytes"] == 2048
    assert pool.stats()["dropped"] == 1
    allocs = view.stats()["allocated"]
    b4 = view.acquire(1024)                    # from the free list
    assert view.stats()["allocated"] == allocs
    view.release(b4)


def test_fleet_staging_pool_fleet_wide_cap():
    pool = FleetStagingPool(total_bytes=1024)
    va = pool.view("a", quota_bytes=0)
    vb = pool.view("b", quota_bytes=0)
    a1 = va.acquire(1024)
    b1 = vb.acquire(1024)
    va.release(a1)
    assert pool.stats()["retained_bytes"] == 1024
    vb.release(b1)                             # fleet cap: dropped
    assert pool.stats()["retained_bytes"] == 1024
    assert vb.stats()["retained_bytes"] == 0


def test_fleet_staging_pool_pins_where_the_fleet_runs_on_the_card():
    """The pool protocol is `acquire(nbyte)`, as in the JAX package: a
    fleet's pool pins its buffers iff its device is a CUDA one, and the
    CPU fleet's views hand out plain host memory."""
    fleet = FleetScheduler(name="pinless", device="cpu")
    try:
        assert fleet.staging_pool.pin is False
        view = fleet.staging_pool.view("a", quota_bytes=4096)
        buf = view.acquire(1024)
        assert buf.device.type == "cpu" and not buf.is_pinned()
        view.release(buf)
    finally:
        _stop(fleet)
    assert FleetStagingPool(pin=True).pin is True


def test_fleet_staging_pool_drain_and_view_reuse():
    pool = FleetStagingPool()
    view = pool.view("a", quota_bytes=4096)
    view.release(view.acquire(512))
    assert view.stats()["retained_bytes"] == 512
    view.drain()
    assert view.stats()["retained_bytes"] == 0
    assert pool.stats()["retained_bytes"] == 0
    assert pool.view("a", quota_bytes=8192) is view
    assert view.quota_bytes == 8192


def test_ring_byte_usage_sampled_and_violations_booked():
    fleet = Fleet(ring_bytes_total=0)
    t = fleet.submit(TenantSpec("a", _chain_spec(pace_s=0.02),
                                ring_bytes=1))
    deadline = time.monotonic() + 15.0
    while t.quota_violations == 0 and time.monotonic() < deadline:
        fleet.poll()
        time.sleep(0.05)
    assert t.quota_violations == 1
    fleet.poll()
    assert t.quota_violations == 1      # edge-triggered
    snap = fleet.snapshot()
    assert snap["tenants"]["a"]["ring_bytes_used"] > 1
    fleet.wait(timeout=30.0)
    _stop(fleet)


# -------------------------------------------------------------- preemption
def test_priority_preemption_on_shard_eviction_and_restore():
    fleet = Fleet(devices_total=4)
    hi = fleet.submit(TenantSpec(
        "hi", _chain_spec(data=ENDLESS_DATA, pace_s=0.05),
        priority=10, devices=2))
    lo = fleet.submit(TenantSpec(
        "lo", _chain_spec(data=ENDLESS_DATA, pace_s=0.05),
        priority=1, devices=2))
    assert hi.state == lo.state == "running"
    faultdomain.mark_lost("FakeDev0")
    faultdomain.evict("FakeDev0")
    fleet.poll()
    assert lo.state == "preempted"
    assert lo.preemptions == 1
    assert hi.state == "running"
    assert hi.preemptions == 0
    assert fleet.counters["preempted"] == 1
    assert fleet.counters["evictions_seen"] == 1
    assert fleet.devices_effective() == 3
    faultdomain.restore("FakeDev0")
    fleet.poll()
    assert lo.state == "running"
    assert lo.admissions == 2
    assert fleet.counters["restores_seen"] == 1
    rep = _stop(fleet)
    assert rep.exit_code == EXIT_DEGRADED
    assert rep.counters["preempted"] == 1


def test_preemption_sheds_lowest_priority_first():
    fleet = Fleet(devices_total=6)
    names = [("hi", 10), ("mid", 5), ("lo", 1)]
    tenants = {n: fleet.submit(TenantSpec(
        n, _chain_spec(data=ENDLESS_DATA, pace_s=0.05), priority=p,
        devices=2)) for n, p in names}
    assert all(t.state == "running" for t in tenants.values())
    faultdomain.evict("FakeDevA")
    faultdomain.evict("FakeDevB")
    fleet.poll()
    assert tenants["lo"].state == "preempted"
    assert tenants["mid"].state == "running"
    assert tenants["hi"].state == "running"
    faultdomain.evict("FakeDevC")
    fleet.poll()
    assert tenants["mid"].state == "preempted"
    assert tenants["hi"].state == "running"
    _stop(fleet)


def test_poll_reaps_finished_before_preempting():
    fleet = Fleet(devices_total=4)
    a = fleet.submit(TenantSpec("a", _chain_spec(), priority=5,
                                devices=2))
    b = fleet.submit(TenantSpec(
        "b", _chain_spec(data=ENDLESS_DATA, pace_s=0.05), priority=1,
        devices=2))
    svc = a.service
    deadline = time.monotonic() + 20.0
    while svc.running and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not svc.running
    assert a.state == "running"                      # not yet reaped
    faultdomain.evict("FakeDev0")
    fleet.poll()
    assert a.state == "stopped"
    assert b.state == "running"
    assert b.preemptions == 0
    assert fleet.counters["preempted"] == 0
    _stop(fleet)


# --------------------------------------------------------------- isolation
def test_tenant_isolation_fault_in_a_leaves_b_untouched():
    fleet = Fleet()
    a = fleet.submit(TenantSpec("tenant_a",
                                _chain_spec(flaky=(2, 1), pace_s=0.01)))
    b = fleet.submit(TenantSpec("tenant_b", _chain_spec(pace_s=0.01)))
    assert fleet.wait(timeout=30.0)
    rep = _stop(fleet)
    a_exit = rep.tenants["tenant_a"]["exit"]
    b_exit = rep.tenants["tenant_b"]["exit"]
    assert a_exit["counters"]["restarts"] == 1
    assert a_exit["ledger"]["restart_shed_frames"] == GULP
    assert b_exit["counters"]["faults"] == 0
    assert b_exit["counters"]["restarts"] == 0
    assert b_exit["ledger"]["restart_shed_frames"] == 0
    for exit_rep in (a_exit, b_exit):
        assert exit_rep["ledger"]["lost_frames"] == 0
        assert exit_rep["ledger"]["duplicated_frames"] == 0
    assert a.exit_codes == [EXIT_CLEAN]
    assert b.exit_codes == [EXIT_CLEAN]


def test_isolation_budgets_of_b_stay_full_while_a_faults():
    fleet = Fleet()
    fleet.submit(TenantSpec("a", _chain_spec(flaky=(1, 2), pace_s=0.02)))
    b = fleet.submit(TenantSpec("b", _chain_spec(pace_s=0.02)))
    deadline = time.monotonic() + 15.0
    sampled = False
    while time.monotonic() < deadline:
        sup = b.supervisor()
        if sup is not None:
            budgets = sup.budget_remaining()
            if budgets:
                assert all(v == sup.policies.get(
                    name, sup.policy).max_restarts
                    for name, v in budgets.items())
                sampled = True
                break
        time.sleep(0.02)
    assert sampled
    fleet.wait(timeout=30.0)
    _stop(fleet)


# ------------------------------------------------------- snapshot + reports
SNAPSHOT_KEYS = ("name", "state", "uptime_s", "devices", "ring_bytes",
                 "staging", "tenants", "queue", "queue_depth", "counters",
                 "restarts", "ledger", "recovery", "shard_recovery",
                 "availability_pct")
TENANT_KEYS = ("state", "service_state", "priority", "devices",
               "ring_bytes", "ring_bytes_used", "staging", "restarts",
               "budget_remaining", "budget_min", "ledger", "admissions",
               "preemptions", "quota_violations", "reject_reason")


def test_fleet_snapshot_schema():
    fleet = Fleet(devices_total=4, staging_bytes_total=1 << 20)
    fleet.submit(TenantSpec("a", _chain_spec(pace_s=0.02), priority=3,
                            devices=2, staging_bytes=512 << 10))
    snap = fleet.snapshot()
    for key in SNAPSHOT_KEYS:
        assert key in snap, key
    assert snap["devices"] == {"total": 4, "effective": 4, "committed": 2}
    ten = snap["tenants"]["a"]
    for key in TENANT_KEYS:
        assert key in ten, key
    assert ten["priority"] == 3
    assert snap["recovery"]["count"] == 0
    assert snap["availability_pct"] == 100.0
    fleet.wait(timeout=30.0)
    _stop(fleet)


def test_fleet_proclog_row_published():
    from bifrost_tpu_torch.proclog import fleet_metrics, load_by_pid
    fleet = Fleet(name="fleet_proclog_test")
    fleet.submit(TenantSpec("a", _chain_spec()))
    fleet.wait(timeout=30.0)
    fleet._push_health()
    rows = fleet_metrics(load_by_pid(os.getpid()))
    row = next(r for r in rows if "fleet_proclog_test" in r["name"])
    assert row["admitted"] == 1
    assert row["lost_frames"] == 0
    _stop(fleet)


def test_exit_code_aggregation_clean_degraded_escalated():
    fleet = Fleet()
    fleet.submit(TenantSpec("a", _chain_spec()))
    fleet.submit(TenantSpec("b", _chain_spec()))
    fleet.wait(timeout=30.0)
    assert _stop(fleet).exit_code == EXIT_CLEAN

    fleet = Fleet()
    fleet.submit(TenantSpec("a", _chain_spec(
        flaky=(1, 3), pace_s=0.02)))       # 3 faults vs budget 4
    fleet.submit(TenantSpec("b", _chain_spec()))
    fleet.wait(timeout=30.0)
    rep = _stop(fleet)
    assert rep.exit_code == EXIT_DEGRADED
    assert rep.tenants["a"]["exit"]["exit_code"] == EXIT_DEGRADED
    assert rep.tenants["b"]["exit"]["exit_code"] == EXIT_CLEAN

    fleet = Fleet()
    t = fleet.submit(TenantSpec("a", _chain_spec(flaky=(1, 9),
                                                 pace_s=0.02)))
    fleet.submit(TenantSpec("b", _chain_spec()))
    fleet.wait(timeout=30.0)
    rep = _stop(fleet)
    assert rep.exit_code == EXIT_ESCALATED
    assert EXIT_ESCALATED in t.exit_codes


def test_queued_at_stop_degrades_exit():
    fleet = Fleet(devices_total=2)
    fleet.submit(TenantSpec("a", _chain_spec(pace_s=0.05), devices=2))
    q = fleet.submit(TenantSpec("b", _chain_spec(), devices=2))
    assert q.state == "queued"
    rep = fleet.stop(timeout=5.0)
    assert rep.exit_code == EXIT_DEGRADED
    assert rep.counters["queued_at_stop"] == 1
    assert rep.tenants["b"]["state"] == "queued"


# ------------------------------------------- supervisor aggregate satellites
def test_supervisor_budget_remaining_aggregate_form():
    fleet = Fleet()
    t = fleet.submit(TenantSpec("a", _chain_spec(flaky=(2, 1),
                                                 pace_s=0.02)))
    svc = t.service
    fleet.wait(timeout=30.0)
    sup = svc.supervisor
    budgets = sup.budget_remaining()
    assert isinstance(budgets, dict) and budgets
    assert budgets["flaky"] == 3
    assert sup.budget_remaining("flaky") == 3
    _stop(fleet)


def test_supervisor_aggregate_recovery_stats_merges_tenants():
    sup_a, sup_b = Supervisor(), Supervisor()
    sup_a._recovery_times.extend([0.1, 0.2])
    sup_b._recovery_times.extend([0.4])
    agg = Supervisor.aggregate_recovery_stats([sup_a, sup_b, None])
    assert agg["count"] == 3
    assert agg["p50_s"] == 0.2
    assert agg["max_s"] == 0.4
    assert agg["last_s"] == 0.4
    samples = sup_a.recovery_samples()
    samples.append(9.9)
    assert sup_a.recovery_samples() == [0.1, 0.2]
    sup_a._shard_recovery_times.append(0.05)
    shard = Supervisor.aggregate_recovery_stats([sup_a, sup_b],
                                                shard_only=True)
    assert shard["count"] == 1 and shard["p50_s"] == 0.05


# ------------------------------------------------------------ elastic fleet
def _paced_stage(name, pace_s):
    """A respec-able paced copy stage: its factory names the block after
    the stage, so a replacement splices in under the same name."""
    return StageSpec("custom", name=name, params=dict(
        factory=lambda up, **k: PacedTransform(up, pace_s=pace_s,
                                               name=name)))


def _respec_chain(pace_s=0.02, data=LONG_DATA):
    stages = [
        StageSpec("custom", name="source", params=dict(
            factory=lambda _up, **k: array_source(data, GULP))),
        _paced_stage("paced", pace_s),
        StageSpec("detect", params=dict(threshold=1e9, gulp_nframe=GULP)),
    ]
    return lambda: ServiceSpec(stages, heartbeat_interval_s=1.0,
                               heartbeat_misses=30)


def test_live_respec_ledger_contiguous_across_splice():
    fleet = Fleet(devices_total=4)
    t = fleet.submit(TenantSpec("a", _respec_chain(pace_s=0.02),
                                devices=2))
    assert t.state == "running"
    svc = t.service
    deadline = time.monotonic() + 15.0
    while svc.ledger.summary()["committed_frames"] < 4 * GULP and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    rec = fleet.respec("a", "paced", _paced_stage("paced", 0.002))
    assert rec["outcome"] in ("drained", "interrupted")
    assert not rec["rolled_back"]
    assert fleet.wait(timeout=30.0)
    rep = _stop(fleet)
    exit_a = rep.tenants["a"]["exit"]
    assert exit_a["ledger"]["committed_frames"] == LONG_DATA.shape[0]
    assert exit_a["ledger"]["lost_frames"] == 0
    assert exit_a["ledger"]["duplicated_frames"] == 0
    assert rep.counters["respecs"] == 1
    assert rep.tenants["a"]["downtime"]["respec_s"] > 0.0


def test_resize_grow_reclaims_lower_priority_shrink_backfills():
    fleet = Fleet(devices_total=8)
    hi = fleet.submit(TenantSpec(
        "hi", _chain_spec(data=ENDLESS_DATA, pace_s=0.05), priority=10,
        devices=4))
    lo = fleet.submit(TenantSpec(
        "lo", _chain_spec(data=ENDLESS_DATA, pace_s=0.05), priority=1,
        devices=4))
    assert hi.state == lo.state == "running"
    rec = fleet.resize("hi", 8)
    assert rec["preempted"] == ["lo"]
    assert lo.state == "preempted"
    assert fleet.counters["resizes"] == 1
    assert fleet.counters["resize_preemptions"] == 1
    fleet.poll()
    assert fleet.counters["resizes_seen"] >= 1
    rec2 = fleet.resize("hi", 4)
    assert "lo" in rec2["admitted"]
    assert lo.state == "running" and lo.admissions == 2
    with pytest.raises(RuntimeError, match="reclaimable"):
        fleet.resize("lo", 8)
    assert hi.state == lo.state == "running"
    assert fleet.counters["resize_preemptions"] == 1
    snap = fleet.snapshot()
    assert snap["tenants"]["hi"]["downtime"]["resize_s"] > 0.0
    _stop(fleet)


def test_resize_collides_with_shard_eviction_same_tick():
    fleet = Fleet(devices_total=6)
    hi = fleet.submit(TenantSpec(
        "hi", _chain_spec(data=ENDLESS_DATA, pace_s=0.05), priority=10,
        devices=2))
    lo = fleet.submit(TenantSpec(
        "lo", _chain_spec(data=ENDLESS_DATA, pace_s=0.05), priority=1,
        devices=2))
    faultdomain.evict("FakeDev0")        # 6 -> 5, not yet polled
    rec = fleet.resize("hi", 4)
    assert rec["preempted"] == ["lo"]    # 4 + 2 > 5
    fleet.poll()
    assert fleet.counters["evictions_seen"] == 1
    assert fleet.counters["resizes_seen"] >= 1
    snap = fleet.snapshot()
    assert snap["devices"]["effective"] == 5
    assert snap["devices"]["committed"] <= snap["devices"]["effective"]
    assert hi.state == "running"
    assert lo.state in ("preempted", "queued")
    _stop(fleet)


def test_preemption_mid_respec_never_half_spliced():
    """An eviction's preemption lands while a respec holds the splice:
    the service's stop lock makes the stop wait for the splice, so the
    tenant is never torn down half-spliced and its ledger stays
    contiguous."""
    from bifrost_tpu_torch.faultinject import FaultPlan
    fleet = Fleet(devices_total=2)
    t = fleet.submit(TenantSpec("a", _respec_chain(pace_s=0.01),
                                priority=5, devices=2))
    svc = t.service
    entered, release = threading.Event(), threading.Event()
    plan = FaultPlan(seed=18)
    plan.wedge_at("block.on_data", block="paced", nth=3, release=release,
                  entered=entered, timeout=60.0, stamp_heartbeat=True)
    plan.attach(svc.pipeline)
    rec_box = {}

    def do_respec():
        try:
            rec_box["rec"] = fleet.respec(
                "a", "paced", _paced_stage("paced", 0.001))
        except Exception as e:  # noqa: BLE001 — asserted below
            rec_box["err"] = e

    try:
        assert entered.wait(15.0)
        th = threading.Thread(target=do_respec, daemon=True)
        th.start()
        time.sleep(0.1)          # respec in its quiesce, stop lock held
        faultdomain.evict("FakeDev0")        # 2 -> 1: preempts "a"
        poller = threading.Thread(target=fleet.poll, daemon=True)
        poller.start()           # blocks in svc.stop on the stop lock
        time.sleep(0.05)
        release.set()            # the wedged gulp ends, the splice lands
        th.join(timeout=30.0)
        poller.join(timeout=30.0)
        assert not th.is_alive() and not poller.is_alive()
    finally:
        release.set()
        plan.detach()
    assert t.state == "preempted"
    assert "err" not in rec_box, rec_box.get("err")
    assert rec_box["rec"]["outcome"] in ("drained", "interrupted")
    led = t.exit_report.ledger
    assert led["lost_frames"] == 0
    assert led["duplicated_frames"] == 0
    _stop(fleet)


def test_redeploy_rolls_ascending_priority_with_warm_start():
    fleet = Fleet(devices_total=8)
    fleet.submit(TenantSpec(
        "a", _chain_spec(data=ENDLESS_DATA, pace_s=0.03), priority=9,
        devices=2))
    fleet.submit(TenantSpec(
        "b", _chain_spec(data=ENDLESS_DATA, pace_s=0.03), priority=2,
        devices=2))
    time.sleep(0.2)
    seen_warm = {}

    def warm_factory(name):
        def factory(warm_start=None):
            seen_warm[name] = warm_start
            return _chain_spec()()
        return factory

    roll = fleet.redeploy(
        [TenantSpec("a", warm_factory("a"), priority=9, devices=2),
         TenantSpec("b", warm_factory("b"), priority=2, devices=2)],
        deadline_s=60.0)
    assert roll["status"] == "completed"
    assert roll["replaced"] == ["b", "a"]
    assert roll["survivors"] == []
    for name in ("a", "b"):
        assert seen_warm[name] is not None
        assert "exit_code" in seen_warm[name]
        assert "ledger" in seen_warm[name]
    snap = fleet.snapshot()
    assert snap["elastic"]["redeploys"] == 1
    assert sorted(snap["elastic"]["retired"]) == ["a", "b"]
    assert snap["tenants"]["a"]["downtime"]["redeploy_s"] > 0.0
    fleet.wait(timeout=30.0)
    rep = _stop(fleet)
    assert any(k.startswith("a@") for k in rep.tenants)
    assert any(k.startswith("b@") for k in rep.tenants)


def test_redeploy_deadline_and_abort_leave_survivors_intact():
    fleet = Fleet(devices_total=6)
    fleet.submit(TenantSpec(
        "a", _chain_spec(data=ENDLESS_DATA, pace_s=0.05), priority=1,
        devices=2))
    b = fleet.submit(TenantSpec(
        "b", _chain_spec(data=ENDLESS_DATA, pace_s=0.05), priority=5,
        devices=2))
    c = fleet.submit(TenantSpec(
        "c", _chain_spec(data=ENDLESS_DATA, pace_s=0.05), priority=9,
        devices=2))
    svc_b, svc_c = b.service, c.service

    def newspec(n, p):
        return TenantSpec(n, _chain_spec(data=ENDLESS_DATA, pace_s=0.05),
                          priority=p, devices=2)

    roll = fleet.redeploy([newspec("a", 1), newspec("b", 5),
                           newspec("c", 9)], deadline_s=0.01)
    assert roll["status"] == "deadline"
    assert "c" not in roll["replaced"]
    assert "c" in roll["survivors"]
    assert fleet.counters["redeploy_aborts"] == 1
    assert c.service is svc_c and c.state == "running"
    if "b" in roll["survivors"]:
        assert b.service is svc_b and b.state == "running"
    box = {}

    def do_roll():
        box["roll"] = fleet.redeploy([newspec("b", 5), newspec("c", 9)])

    th = threading.Thread(target=do_roll, daemon=True)
    th.start()
    deadline = time.monotonic() + 10.0
    while not fleet._rolling and th.is_alive() and \
            time.monotonic() < deadline:
        time.sleep(0.002)
    fleet.abort_roll()
    th.join(timeout=30.0)
    assert not th.is_alive()
    roll2 = box["roll"]
    assert roll2["status"] in ("aborted", "completed")
    if roll2["status"] == "aborted":
        assert roll2["survivors"] == ["c"]
        assert c.service is svc_c and c.state == "running"
    _stop(fleet)


def test_starvation_guard_promotes_queue_head():
    from bifrost_tpu_torch import config
    config.set("fleet_starvation_s", 0.02)
    try:
        fleet = Fleet(devices_total=2)
        fleet.submit(TenantSpec("churn0", _chain_spec(pace_s=0.02),
                                priority=10, devices=2))
        starved = fleet.submit(TenantSpec("starved", _chain_spec(),
                                          priority=1, devices=2))
        assert starved.state == "queued"
        i = 1
        deadline = time.monotonic() + 30.0
        while starved.state == "queued" and time.monotonic() < deadline:
            if not any(t.state == "queued" and t.name.startswith("churn")
                       for t in fleet.tenants.values()):
                fleet.submit(TenantSpec(
                    f"churn{i}", _chain_spec(pace_s=0.02), priority=10,
                    devices=2))
                i += 1
            fleet.poll()
            time.sleep(0.01)
        assert starved.state in ("running", "stopped")
        assert starved.admissions == 1
        assert fleet.counters["starvation_promotions"] > 0
        snap = fleet.snapshot()
        assert snap["elastic"]["starvation_promotions"] > 0
        _stop(fleet)
    finally:
        config.set("fleet_starvation_s", 0.0)


ELASTIC_KEYS = ("respecs", "resizes", "resize_preemptions", "redeploys",
                "starvation_promotions", "rolling", "last_roll", "retired",
                "admission_samples", "admission_p50_s", "admission_p99_s",
                "kernel_cache")


def test_snapshot_elastic_section_and_kernel_cache_info():
    fleet = Fleet(devices_total=2)
    fleet.submit(TenantSpec("a", _chain_spec(pace_s=0.02), devices=2))
    snap = fleet.snapshot()
    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline:
        fleet.poll()
        snap = fleet.snapshot()
        if snap["elastic"]["admission_samples"]:
            break
        time.sleep(0.02)
    el = snap["elastic"]
    for key in ELASTIC_KEYS:
        assert key in el, key
    assert el["admission_samples"] >= 1
    assert el["admission_p99_s"] is not None
    assert el["admission_p99_s"] >= el["admission_p50_s"] >= 0.0
    assert set(el["kernel_cache"]) >= {"enabled", "path", "entries"}
    ten = snap["tenants"]["a"]
    assert "effective_priority" in ten
    assert set(ten["downtime"]) == {"respec_s", "resize_s", "redeploy_s"}
    fleet.wait(timeout=30.0)
    _stop(fleet)


# ------------------------------------------------ the port against the JAX
# One seeded script through both schedulers, driven by poll() alone.
# Tenant streams: SCRIPT_NGULP gulps of GULP frames paced PACE_S a gulp,
# a bright sample at SPIKES (frame, channel) before any action lands, so
# that each tenant's candidates are fixed by the data.
# hi's stream is HI_NGULP gulps, so that it outlives the eviction, the
# restore and the resize.
SCRIPT_NGULP, HI_NGULP, PACE_S = 48, 160, 0.03
SPIKES = ((5, 3), (20, 6))


def _script_data(seed, ngulp=SCRIPT_NGULP):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 23, (ngulp * GULP, 8)).astype(np.float32)
    for f, c in SPIKES:
        x[f, c] = 4000.0
    return x


class _Pkg(object):
    """The names the script needs from one package."""

    def __init__(self, which):
        if which == "jax":
            from bifrost_tpu import fleet, service
            from bifrost_tpu.blocks.testing import array_source as src
            from bifrost_tpu.parallel import faultdomain as fd
            from bifrost_tpu.pipeline import TransformBlock as TB
            from bifrost_tpu.proclog import fleet_metrics, load_by_pid
            from bifrost_tpu.supervise import RestartPolicy as RP
            self.kw = {}
        else:
            from bifrost_tpu_torch import fleet, service
            from bifrost_tpu_torch.blocks.testing import array_source as src
            from bifrost_tpu_torch.parallel import faultdomain as fd
            from bifrost_tpu_torch.pipeline import TransformBlock as TB
            from bifrost_tpu_torch.proclog import fleet_metrics, load_by_pid
            from bifrost_tpu_torch.supervise import RestartPolicy as RP
            self.kw = {"device": "cpu"}
        self.which = which
        self.fleet, self.service, self.src, self.fd = fleet, service, src, fd
        self.TB, self.RP = TB, RP
        self.fleet_metrics, self.load_by_pid = fleet_metrics, load_by_pid

    def copy_block(self, pace_s, fault_gulp=None):
        pkg = self

        class Copy(pkg.TB):
            def __init__(self, iring, **kwargs):
                super().__init__(iring, **kwargs)
                self._gulps = 0
                self.fault_gulp = fault_gulp

            def on_sequence(self, iseq):
                return dict(iseq.header)

            def on_data(self, ispan, ospan):
                g = self._gulps
                self._gulps += 1
                if self.fault_gulp is not None and g == self.fault_gulp:
                    self.fault_gulp = None
                    raise RuntimeError("scripted tenant fault")
                time.sleep(pace_s)
                ospan.data[...] = ispan.data
                return ispan.nframe
        return Copy

    def spec(self, tag, seed, cands, fault_gulp=None, ngulp=SCRIPT_NGULP):
        """source -> <tag>_pace (paced) -> <tag>_copy (faulting once
        where asked; the stage a respec replaces) -> detect, on
        _script_data(seed, ngulp).  The paced stage sets the stream's
        rate and its ring holds 16 gulps of one sequence, so the ring the
        copy stage reads stays far from full: the JAX splice releases the
        read guarantee for a moment and reopens the ring's earliest
        sequence, so a writer that filled the ring, or an older sequence
        still in it, would change what its replacement reads."""
        S = self.service
        data = _script_data(seed, ngulp)
        pace = self.copy_block(PACE_S)
        copy = self.copy_block(0.0, fault_gulp)

        def factory():
            return S.ServiceSpec([
                S.StageSpec("custom", name="source", params=dict(
                    factory=lambda _up, **k: self.src(data, GULP))),
                S.StageSpec("custom", name="pace", params=dict(
                    factory=lambda up, **k: pace(up, name=f"{tag}_pace",
                                                 buffer_factor=16))),
                S.StageSpec("custom", name="copy", params=dict(
                    factory=lambda up, **k: copy(up, name=f"{tag}_copy")),
                    restart=self.RP(max_restarts=4, window_s=30.0,
                                    backoff=0.01)),
                S.StageSpec("detect", name="detect", params=dict(
                    threshold=8.0, gulp_nframe=GULP,
                    name=f"{tag}_detect",
                    on_candidate=cands.setdefault(tag, []).append)),
            ], heartbeat_interval_s=1.0, heartbeat_misses=30)
        return factory

    def copy_stage(self, tag):
        copy = self.copy_block(0.0)
        return self.service.StageSpec("custom", name="copy", params=dict(
            factory=lambda up, **k: copy(up, name=f"{tag}_copy")))


def _until(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "scripted condition timed out"
        time.sleep(0.005)


def _run_script(which):
    """The seeded script on one package -> everything the parity test
    compares."""
    pkg = _Pkg(which)
    fd = pkg.fd
    fd.reset()
    cands = {}
    F = pkg.fleet
    fleet = F.FleetScheduler(name=f"parity_{which}", devices_total=4,
                             max_queue=1, **pkg.kw)
    decisions = []

    def submit(name, seed, **kw):
        fault = kw.pop("fault_gulp", None)
        ngulp = kw.pop("ngulp", SCRIPT_NGULP)
        t = fleet.submit(F.TenantSpec(
            name, pkg.spec(name, seed, cands, fault_gulp=fault,
                           ngulp=ngulp), **kw))
        decisions.append(("submit", name, t.state, t.reject_reason))
        return t

    def poll():
        r = fleet.poll()
        decisions.append(("poll", sorted(r["reaped"]),
                          sorted(r["preempted"]), sorted(r["admitted"])))

    def committed(t, n):
        return t.service is not None and \
            t.service.ledger.summary()["committed_frames"] >= n

    hi = submit("hi", 1, priority=10, devices=2, fault_gulp=2,
                ngulp=HI_NGULP)
    lo = submit("lo", 2, priority=1, devices=2)
    submit("q", 3, priority=5, devices=2)
    submit("full", 4, priority=0, devices=2)
    submit("huge", 5, devices=5)
    _until(lambda: committed(hi, 4 * GULP) and committed(lo, 2 * GULP))
    # A live respec of hi's copy stage, after its fault and restart.
    rec = fleet.respec("hi", "copy", pkg.copy_stage("hi"))
    decisions.append(("respec", rec["rolled_back"],
                      rec["outcome"] in ("drained", "interrupted")))
    # An eviction sheds the lowest priority; the queue stays blocked.
    fd.mark_lost("FakeDev0")
    fd.evict("FakeDev0")
    poll()
    # Health returns: the restore admits the queue head (q, priority 5).
    fd.mark_restored("FakeDev0")
    fd.restore("FakeDev0")
    poll()
    # q shrinks to one device: lo does not fit yet (2 + 1 + 2 > 4).
    decisions.append(("resize", fleet.resize("q", 1)["admitted"]))
    poll()
    # q and hi finish their streams, one poll reaps both and re-admits
    # lo, which is then redeployed.
    q = fleet.tenants["q"]
    _until(lambda: not q.service.running and not hi.service.running)
    poll()
    _until(lambda: committed(lo, GULP))
    roll = fleet.redeploy([F.TenantSpec("lo", pkg.spec("lo2", 6, cands),
                                        priority=1, devices=2)])
    decisions.append(("roll", roll["status"], roll["replaced"],
                      roll["survivors"]))
    snap = fleet.snapshot()
    lo2 = fleet.tenants["lo"]
    _until(lambda: lo2.service is None or not lo2.service.running)
    poll()
    fleet._push_health()
    rows = pkg.fleet_metrics(pkg.load_by_pid(os.getpid()))
    row = next(r for r in rows if f"parity_{which}" in r["name"])
    rep = fleet.stop(timeout=10.0)
    fd.reset()
    ledgers = {}
    for key, t in rep.tenants.items():
        ex = t["exit"]
        if ex is not None:
            ledgers[key] = ex["ledger"]
    return {"decisions": decisions, "counters": rep.counters,
            "events": [e["kind"] for e in fleet.events],
            "exit_code": rep.exit_code,
            "exit_codes": {k: t["exit_codes"]
                           for k, t in rep.tenants.items()},
            "states": {k: t["state"] for k, t in rep.tenants.items()},
            "ledgers": ledgers,
            "snapshot_keys": (set(snap), {k: set(v) for k, v in
                                          snap["tenants"].items()},
                              set(snap["elastic"])),
            "row_keys": set(row) - {"name"},
            "cands": cands,
            "preempted_runs": [(t.name, t.preemptions)
                               for t in fleet.tenants.values()]}


@pytest.fixture(scope="module")
def parity_runs():
    return {which: _run_script(which) for which in ("port", "jax")}


def test_parity_scheduling_decisions_and_counters(parity_runs):
    p, j = parity_runs["port"], parity_runs["jax"]
    assert p["decisions"] == j["decisions"]
    assert p["counters"] == j["counters"]
    assert p["events"] == j["events"]
    assert p["exit_code"] == j["exit_code"] == EXIT_DEGRADED
    assert p["exit_codes"] == j["exit_codes"]
    assert p["states"] == j["states"]
    # The script's own expectations, so that a change of both schedulers
    # at once still shows.
    assert ("submit", "q", "queued", None) in p["decisions"]
    assert p["counters"]["preempted"] == 1
    assert p["counters"]["rejected"] == 2
    assert p["counters"]["respecs"] == 1


def test_parity_ledgers_and_candidates(parity_runs):
    p, j = parity_runs["port"], parity_runs["jax"]
    for key, led in p["ledgers"].items():
        assert led["lost_frames"] == led["duplicated_frames"] == 0, key
    # Every run that ended on its own: the stream whole, once.
    for key in ("hi", "q", "lo"):
        assert p["ledgers"][key] == j["ledgers"][key], key
    assert p["ledgers"]["hi"]["restart_shed_frames"] == GULP
    assert p["cands"]["q"] == j["cands"]["q"] and p["cands"]["q"]
    assert p["cands"]["lo2"] == j["cands"]["lo2"] and p["cands"]["lo2"]
    assert p["cands"]["hi"] == j["cands"]["hi"] and p["cands"]["hi"]


def test_parity_snapshot_and_proclog_row_keys(parity_runs):
    p, j = parity_runs["port"], parity_runs["jax"]
    assert p["snapshot_keys"] == j["snapshot_keys"]
    assert p["row_keys"] == j["row_keys"]


# ---------------------------------------------------- flags and the cache
@pytest.mark.parametrize("flag,bad,good,default", [
    ("fleet_health_interval_s", 0.0, 0.5, 1.0),
    ("fleet_max_queue", -1, 4, 16),
    ("fleet_preempt_quiesce_s", 0.0, 2.0, 5.0),
    ("fleet_starvation_s", -1.0, 0.5, 0.0),
    ("kernel_cache", None, "on", ""),
])
def test_fleet_flags_defaults_and_validation(flag, bad, good, default):
    """The fleet and kernel-cache flags carry the JAX package's names,
    environment variables, defaults and validation
    (bifrost_tpu/config.py:150-155, 284-317)."""
    from bifrost_tpu import config as jconfig
    from bifrost_tpu_torch import config
    assert config.get(flag) == jconfig.get(flag) == default
    assert config.FLAGS[flag].env == jconfig.FLAGS[flag].env
    if bad is not None:
        with pytest.raises(ValueError, match=flag):
            config.set(flag, bad)
    config.set(flag, good)
    try:
        assert config.get(flag) == good
    finally:
        config.reset(flag)


def test_kernel_cache_flag_moves_the_build_directory(tmp_path, monkeypatch):
    from bifrost_tpu_torch import build, cache, config
    assert cache.maybe_enable_from_config() is None
    assert cache.kernel_cache_info()["path"] == str(build.DEFAULT_BUILD_DIR)
    target = tmp_path / "kc"
    monkeypatch.setenv("BIFROST_TPU_KERNEL_CACHE", str(target))
    try:
        assert cache.maybe_enable_from_config() == str(target)
        assert build.BUILD_DIR == target
        assert build.MAP_BUILD_DIR == target / "map"
        (target / "map").mkdir(parents=True)
        (target / "libx-0.so").write_bytes(b"")
        (target / "map" / "liby.so").write_bytes(b"")
        info = cache.kernel_cache_info()
        assert info == {"enabled": True, "path": str(target), "entries": 2}
        cache.clear_kernel_disk_cache()
        assert not target.exists()
    finally:
        cache.disable_kernel_disk_cache()
        monkeypatch.delenv("BIFROST_TPU_KERNEL_CACHE")
    assert build.BUILD_DIR == build.DEFAULT_BUILD_DIR
    assert config.get("kernel_cache") == ""
    assert cache._resolve_dir("on") == cache.DEFAULT_CACHE_DIR
    assert cache._resolve_dir("off") is None


@pytest.mark.parametrize("how", ["explicit_path", "no_argument"])
def test_kernel_cache_info_and_clear_follow_the_builds(how, tmp_path,
                                                       monkeypatch):
    """Enabled by a call while the flag is off, the cache reports and
    clears the directory the builds go to, never the package's build/."""
    from bifrost_tpu_torch import build, cache, config
    assert config.get("kernel_cache") == ""
    if how == "explicit_path":
        target = tmp_path / "kc"
        assert cache.enable_kernel_disk_cache(str(target)) == str(target)
    else:
        target = tmp_path / "home" / "kc"
        monkeypatch.setattr(cache, "DEFAULT_CACHE_DIR", str(target))
        assert cache.enable_kernel_disk_cache() == str(target)
    try:
        assert build.BUILD_DIR == target
        (target / "libx-0.so").write_bytes(b"")
        info = cache.kernel_cache_info()
        assert info == {"enabled": True, "path": str(target), "entries": 1}
        default_existed = build.DEFAULT_BUILD_DIR.exists()
        cache.clear_kernel_disk_cache()
        assert not target.exists()
        assert build.DEFAULT_BUILD_DIR.exists() == default_existed
    finally:
        cache.disable_kernel_disk_cache()
    assert cache.kernel_cache_info()["path"] == str(build.DEFAULT_BUILD_DIR)


def test_fleet_needs_a_card_or_a_device(monkeypatch):
    """No card and no device named: the scheduler raises, as Service()
    does; nothing falls back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetScheduler()
