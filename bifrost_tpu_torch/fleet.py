"""Fleet scheduler: many tenant ServiceSpec chains sharing one card
(counterpart of bifrost_tpu/fleet.py).

`service.Service` runs one supervised chain; its restart budgets, frame
ledger and degraded modes are scoped to that chain.  `FleetScheduler`
runs many such chains (tenants) on one device:

- **Admission control**: `submit(TenantSpec)` admits, queues or rejects
  a tenant against fleet-wide budgets of three metered resources:
  devices (the device registry's, parallel/faultdomain.py), ring bytes
  and pinned staging-buffer bytes, each declared per tenant (0 =
  unmetered).  A demand that can never fit, or that arrives at a full
  queue, is rejected at submit; one that fits runs at once; the rest
  wait in a priority-ordered queue (ties first come first served),
  backfilled whenever capacity returns.  When evictions shrink the
  device budget below the running tenants' demand, the lowest-priority
  tenants are preempted (bounded quiesce, `fleet_preempt_quiesce_s`,
  exit report recorded, back to the queue) until the rest fit; a
  restore re-admits them by priority.
- **Shared-resource arbitration**: `FleetStagingPool` carries the egress
  plane's pinned staging buffers (egress.py) fleet-wide: each tenant's
  `DeviceSinkBlock`s draw from a quota-accounted view of one pool.  A
  tenant may burst past its quota (those buffers are allocated, counted
  and never retained), but it cannot keep pinned pool memory beyond it.
  Ring bytes are reserved at admission, and the control loop samples
  each tenant's ring capacity, booking `quota_violations` when a
  tenant's rings outgrow its claim.
- **Per-tenant isolation**: every tenant is a full `Service`, with its
  own pipeline, supervisor, ledger, degrade state and exit code; a
  fault in one restarts its block under its own budget and touches no
  other.  Each tenant's blocks run on their own CUDA streams; tenants
  share the card and nothing else.
- **Aggregate observability**: `snapshot()` (per-tenant state, restarts,
  budgets, ledgers; the queue; the counters; fleet-wide recovery
  percentiles merged with `Supervisor.aggregate_recovery_stats`;
  availability; the `elastic` section with the kernel cache) is pushed
  by the control loop to a `<fleet>/fleet` ProcLog
  (proclog.fleet_metrics), and `stop()` folds every tenant's exit
  report into a `FleetExitReport`.
- **Elastic operations**: `respec(tenant, stage, new_stage)` splices a
  replacement stage into a running tenant's chain (Service.respec);
  `resize(tenant, n)` changes a tenant's declared device share,
  reclaiming from strictly lower-priority tenants when it grows, and
  takes effect through the effective-mesh rebuild and realign
  (`faultdomain.note_geometry_change`); `redeploy(specs)` rolls
  replacement specs through the fleet one tenant at a time (ascending
  priority, each predecessor's exit report handed to its successor's
  factory as `warm_start`), bounded by a deadline and abortable
  (`abort_roll()`).  A starvation guard (`fleet_starvation_s`) ages the
  queue's effective priorities.  Each is booked in the tenant's
  downtime ledger.

Exit codes (`FleetExitReport.exit_code`): 0 when every admitted tenant
exited clean, none was preempted and none was left waiting; 1 when a
tenant exited degraded, was preempted, or was still queued at stop; 2
when a tenant escalated or the scheduler itself failed.  Rejections are
policy and leave the exit code alone.

    fleet = FleetScheduler(device="cuda", ring_bytes_total=8 << 30)
    t = fleet.submit(TenantSpec("beam0", spec, priority=10))
    fleet.start()                    # the control loop
    snap = fleet.snapshot()
    report = fleet.stop()

`submit()` admits synchronously (a fitting tenant's service is built and
started before it returns); the control loop only does maintenance, so
a caller can drive the scheduler with `poll()` and never start it.
`device`: the torch device every tenant's Service runs on, the card when
None (raising where there is none), as `Service(device=None)`.
"""

from __future__ import annotations

import inspect
import json
import threading
import time
import weakref

from . import config, telemetry
from . import device as _device
from .egress import DeviceSinkBlock, _alloc_staging_buffer
from .parallel import faultdomain
from .proclog import ProcLog
from .service import (EXIT_CLEAN, EXIT_DEGRADED, EXIT_ESCALATED, Service,
                      ServiceSpec)
from .supervise import Supervisor

__all__ = ["FleetScheduler", "TenantSpec", "Tenant", "FleetStagingPool",
           "FleetExitReport", "EXIT_CLEAN", "EXIT_DEGRADED",
           "EXIT_ESCALATED", "pipeline_ring_bytes"]


def pipeline_ring_bytes(pipeline):
    """The ring capacity `pipeline` holds, in bytes (of the card for its
    'cuda' rings): what a tenant's `ring_bytes` claim is metered in."""
    return sum(int(r.capacity) * max(1, int(r.nringlet))
               for r in pipeline.rings)


class TenantSpec(object):
    """One tenant: a name, its chain's ServiceSpec (or a factory of one,
    called afresh at every admission; a factory taking `warm_start`
    gets the predecessor's exit report in a rolling redeploy), its
    priority (higher runs first and is preempted last) and its declared
    demand: `devices` (of the fleet's device budget), `ring_bytes` (the
    ring capacity its pipeline holds), `staging_bytes` (pinned staging
    bytes its sinks may retain in the fleet pool).  0 = unmetered."""

    def __init__(self, name, spec, priority=0, devices=0, ring_bytes=0,
                 staging_bytes=0):
        if not name:
            raise ValueError("a tenant needs a name")
        if not (isinstance(spec, ServiceSpec) or callable(spec)):
            raise TypeError(f"spec must be a ServiceSpec or a factory "
                            f"returning one, got {type(spec).__name__}")
        self.name = str(name)
        self.spec = spec
        self.priority = int(priority)
        self.devices = int(devices)
        self.ring_bytes = int(ring_bytes)
        self.staging_bytes = int(staging_bytes)
        for field in ("devices", "ring_bytes", "staging_bytes"):
            if getattr(self, field) < 0:
                raise ValueError(f"{field} must be >= 0")

    def resolve_spec(self, warm_start=None):
        """The ServiceSpec: a factory is called, with `warm_start` where
        it takes one (the rolling-redeploy hand-off)."""
        if callable(self.spec) and not isinstance(self.spec, ServiceSpec):
            if warm_start is not None and self._accepts_warm_start():
                spec = self.spec(warm_start=warm_start)
            else:
                spec = self.spec()
        else:
            spec = self.spec
        if not isinstance(spec, ServiceSpec):
            raise TypeError(f"tenant {self.name!r}: spec factory returned "
                            f"{type(spec).__name__}, not a ServiceSpec")
        return spec

    def _accepts_warm_start(self):
        try:
            params = inspect.signature(self.spec).parameters.values()
        except (TypeError, ValueError):
            return False
        return any(p.name == "warm_start" or
                   p.kind == inspect.Parameter.VAR_KEYWORD for p in params)

    def __repr__(self):
        return (f"TenantSpec(name={self.name!r}, priority={self.priority}, "
                f"devices={self.devices}, ring_bytes={self.ring_bytes}, "
                f"staging_bytes={self.staging_bytes})")


# Tenant lifecycle states.
QUEUED = "queued"          # waiting for resources
RUNNING = "running"        # admitted; its Service is live
PREEMPTED = "preempted"    # shed by priority; back in the queue
RETIRING = "retiring"      # being replaced by a rolling-redeploy step
STOPPED = "stopped"        # ran and exited
REJECTED = "rejected"      # refused at submit


class Tenant(object):
    """The scheduler's handle of one submitted tenant."""

    def __init__(self, spec, seq):
        self.spec = spec
        self.name = spec.name
        self.priority = spec.priority
        self.seq = seq              # submission order (the tie-break)
        self.state = QUEUED
        self.service = None         # the live Service while RUNNING
        self.exit_report = None     # the last ServiceExitReport
        self.exit_codes = []        # one per completed run
        self.admissions = 0
        self.preemptions = 0
        self.quota_violations = 0
        self.reject_reason = None
        self.admitted_t = None      # time.perf_counter at admission
        self._ring_over = False     # violation edge detector
        self.pool_view = None       # its view of the fleet staging pool
        self.warm_start = None      # the predecessor's exit report
        self.queued_since = None    # monotonic enqueue time (ageing)
        self.boost = 0              # starvation-guard priority steps
        self._adm_sampled = False   # admission -> first gulp, once
        self.downtime = {"respec_s": 0.0, "resize_s": 0.0,
                         "redeploy_s": 0.0}

    @property
    def effective_priority(self):
        """Declared priority plus the starvation guard's boost (the queue
        sorts on it)."""
        return self.priority + self.boost

    def ledger_summary(self):
        """The live service's frame ledger, else the last exit
        report's."""
        if self.service is not None:
            return self.service.ledger.summary()
        if self.exit_report is not None:
            return dict(self.exit_report.ledger)
        return None

    def supervisor(self):
        return self.service.supervisor if self.service is not None else None

    def __repr__(self):
        return (f"Tenant(name={self.name!r}, state={self.state!r}, "
                f"priority={self.priority})")


# ------------------------------------------------------- staging arbitration
class _TenantStagingView(object):
    """One tenant's view of the fleet staging pool: the egress pool
    protocol (`acquire(nbyte)`, `release(buf)`, `allocated`) with
    byte accounting.  A released buffer is kept for reuse only while the
    tenant's retained bytes stay within its quota and the fleet's within
    its budget; otherwise it is freed, so an over-quota burst is served
    (and counted in `over_quota_allocs`) but never keeps pinned memory.
    Its buffers are pinned where the fleet's are (`FleetStagingPool.pin`)."""

    MAX_SIZES = 2   # size buckets kept per tenant (the egress discipline)

    def __init__(self, fleet_pool, tenant, quota_bytes):
        self._fleet = fleet_pool
        self.tenant = tenant
        self.quota_bytes = int(quota_bytes)
        self._free = {}             # nbyte -> [buffers], LRU first
        self.retained_bytes = 0     # free bytes kept back
        self.in_use_bytes = 0       # acquired, not released
        self.allocated = 0          # lifetime allocations
        self.over_quota_allocs = 0  # allocations made while over quota

    def acquire(self, nbyte):
        nbyte = int(nbyte)
        fleet = self._fleet
        with fleet._lock:
            free = self._free.pop(nbyte, None)
            if free is not None:
                self._free[nbyte] = free       # most recent
                if free:
                    buf = free.pop()
                    self.retained_bytes -= nbyte
                    fleet.retained_bytes -= nbyte
                    self.in_use_bytes += nbyte
                    return buf
            self.in_use_bytes += nbyte
            self.allocated += 1
            fleet.allocated += 1
            if self.quota_bytes and \
                    self.in_use_bytes + self.retained_bytes > \
                    self.quota_bytes:
                self.over_quota_allocs += 1
        return _alloc_staging_buffer(nbyte, fleet.pin)

    def release(self, buf):
        if buf is None:
            return
        nbyte = int(buf.nbytes)
        fleet = self._fleet
        with fleet._lock:
            self.in_use_bytes = max(0, self.in_use_bytes - nbyte)
            over_tenant = self.quota_bytes and \
                self.retained_bytes + nbyte > self.quota_bytes
            over_fleet = fleet.total_bytes and \
                fleet.retained_bytes + nbyte > fleet.total_bytes
            if over_tenant or over_fleet:
                fleet.dropped += 1
                return                          # never kept past quota
            free = self._free.pop(nbyte, [])
            self._free[nbyte] = free            # most recent size
            free.append(buf)
            self.retained_bytes += nbyte
            fleet.retained_bytes += nbyte
            while len(self._free) > self.MAX_SIZES:
                stale_key = next(iter(self._free))
                stale = self._free.pop(stale_key)
                drop = stale_key * len(stale)
                self.retained_bytes -= drop
                fleet.retained_bytes -= drop

    def drain(self):
        """Drop every kept buffer (the tenant stopped or was
        preempted)."""
        with self._fleet._lock:
            drop = sum(k * len(v) for k, v in self._free.items())
            self._free.clear()
            self.retained_bytes = 0
            self._fleet.retained_bytes -= drop

    def stats(self):
        with self._fleet._lock:
            return {"quota_bytes": self.quota_bytes,
                    "retained_bytes": self.retained_bytes,
                    "in_use_bytes": self.in_use_bytes,
                    "allocated": self.allocated,
                    "over_quota_allocs": self.over_quota_allocs}


class FleetStagingPool(object):
    """The fleet-wide staging pool: one budget of retained pinned bytes
    (`total_bytes`, 0 = unmetered; the per-tenant quotas still bind),
    carved into per-tenant quota-accounted views (`view()`), each an
    egress pool a tenant's sinks plug into (`EgressStager(pool=view)`).
    `pin`: the buffers are pinned (the fleet's tenants run on the card)."""

    def __init__(self, total_bytes=0, pin=False):
        self.total_bytes = int(total_bytes)
        self.pin = bool(pin)
        self._lock = threading.Lock()
        self.retained_bytes = 0
        self.allocated = 0
        self.dropped = 0
        self._views = {}

    def view(self, tenant, quota_bytes=0):
        """The (single, reused) view of `tenant`."""
        with self._lock:
            v = self._views.get(tenant)
            if v is None:
                v = _TenantStagingView(self, tenant, quota_bytes)
                self._views[tenant] = v
            else:
                v.quota_bytes = int(quota_bytes)
            return v

    def stats(self):
        with self._lock:
            views = dict(self._views)
            head = {"total_bytes": self.total_bytes,
                    "retained_bytes": self.retained_bytes,
                    "allocated": self.allocated,
                    "dropped": self.dropped}
        head["tenants"] = {name: v.stats() for name, v in views.items()}
        return head


# ----------------------------------------------------------- exit reporting
class FleetExitReport(object):
    """A fleet run's outcome: per-tenant exit reports and final states,
    the fleet counters, fleet-wide recovery percentiles, availability,
    and the exit code (module docstring)."""

    def __init__(self, exit_code, state, uptime_s, counters, tenants,
                 recovery, shard_recovery, availability_pct, error=None):
        self.exit_code = exit_code
        self.state = state
        self.uptime_s = uptime_s
        self.counters = dict(counters)
        self.tenants = dict(tenants)
        self.recovery = dict(recovery)
        self.shard_recovery = dict(shard_recovery)
        self.availability_pct = availability_pct
        self.error = error

    @property
    def clean(self):
        return self.exit_code == EXIT_CLEAN

    def as_dict(self):
        return {
            "exit_code": self.exit_code,
            "state": self.state,
            "uptime_s": self.uptime_s,
            "counters": dict(self.counters),
            "tenants": {k: dict(v) for k, v in self.tenants.items()},
            "recovery": dict(self.recovery),
            "shard_recovery": dict(self.shard_recovery),
            "availability_pct": self.availability_pct,
            "error": self.error,
        }

    def __repr__(self):
        return f"FleetExitReport({json.dumps(self.as_dict(), default=str)})"


# --------------------------------------------------------------- scheduler
class FleetScheduler(object):
    """Admit, run and supervise many tenant chains on one device (module
    docstring)."""

    instance_count = 0
    MAX_EVENTS = 1024

    def __init__(self, name=None, devices_total=None, ring_bytes_total=0,
                 staging_bytes_total=0, max_queue=None,
                 health_interval_s=None, preempt_quiesce_s=None,
                 device=None):
        FleetScheduler.instance_count += 1
        self.name = name or f"fleet_{FleetScheduler.instance_count - 1}"
        self.device = _device.resolve_device(device)
        # None: the device dimension is unmetered (no device admission
        # control, no eviction-driven preemption); an int is the device
        # budget tenant `devices` demands are admitted against and
        # registry evictions shrink.
        self.devices_total = None if devices_total is None \
            else int(devices_total)
        self.ring_bytes_total = int(ring_bytes_total)
        self.staging_bytes_total = int(staging_bytes_total)
        self.max_queue = int(config.get("fleet_max_queue")
                             if max_queue is None else max_queue)
        self._health_interval = float(
            config.get("fleet_health_interval_s")
            if health_interval_s is None else health_interval_s)
        self._preempt_quiesce = float(
            config.get("fleet_preempt_quiesce_s")
            if preempt_quiesce_s is None else preempt_quiesce_s)
        self.staging_pool = FleetStagingPool(
            self.staging_bytes_total, pin=self.device.type == "cuda")
        self.tenants = {}           # name -> Tenant (every submission)
        self._queue = []            # waiting Tenants, priority-ordered
        self.events = []            # bounded event log
        self.counters = {"submitted": 0, "admitted": 0, "queued": 0,
                         "rejected": 0, "preempted": 0, "completed": 0,
                         "quota_violations": 0, "evictions_seen": 0,
                         "restores_seen": 0, "resizes_seen": 0,
                         "respecs": 0, "resizes": 0,
                         "resize_preemptions": 0, "redeploys": 0,
                         "redeploy_steps": 0, "redeploy_aborts": 0,
                         "starvation_promotions": 0}
        self._lock = threading.RLock()
        self._started_t = time.monotonic()
        # Registry transitions parked by the listener for the next
        # poll(): the listener runs on the transitioning thread and must
        # not take the scheduler lock (a preemption holding it joins
        # block threads).
        self._pending_transitions = []
        self._seq = 0
        # Rolling-redeploy predecessors (kept for the exit aggregation),
        # the last roll's report, and the admission -> first gulp
        # samples.
        self.retired = []
        self.last_roll = None
        self._rolling = False
        self._abort_roll = threading.Event()
        self._admission_samples = []
        self._state = "built"
        self._stop_evt = threading.Event()
        self._poke = threading.Event()
        self._thread = None
        self._error = None
        self.exit_report = None
        self._proclog = ProcLog(f"{self.name}/fleet")
        # Registry transitions are observed from construction on, so a
        # poll()-driven scheduler sees them too.  The listener holds a
        # weak reference: the registry's listener list outlives reset(),
        # and must not keep an abandoned scheduler alive; a dead
        # reference unregisters itself at the next transition.
        self_ref = weakref.ref(self)

        def _listener(kind, device):
            sched = self_ref()
            if sched is None:
                faultdomain.remove_transition_listener(_listener)
                return
            sched._on_shard_transition(kind, device)

        self._listener = _listener
        faultdomain.add_transition_listener(self._listener)

    # ------------------------------------------------------------- events
    def _note(self, kind, tenant, **detail):
        ev = {"kind": kind, "tenant": getattr(tenant, "name", tenant),
              "time": time.time(), **detail}
        with self._lock:
            self.events.append(ev)
            del self.events[:-self.MAX_EVENTS]
        telemetry.track(f"fleet:{kind}")
        return ev

    def events_for(self, kind=None, tenant=None):
        with self._lock:
            return [e for e in self.events
                    if (kind is None or e["kind"] == kind) and
                    (tenant is None or e["tenant"] == tenant)]

    # --------------------------------------------------------- accounting
    def devices_effective(self):
        """The device budget less the registry's evictions (None when
        unmetered)."""
        if self.devices_total is None:
            return None
        return max(0, self.devices_total -
                   len(faultdomain.evicted_devices()))

    def _committed(self):
        """(devices, ring_bytes, staging_bytes) of the RUNNING tenants.
        Caller holds the lock."""
        dev = ring = stg = 0
        for t in self.tenants.values():
            if t.state == RUNNING:
                dev += t.spec.devices
                ring += t.spec.ring_bytes
                stg += t.spec.staging_bytes
        return dev, ring, stg

    def _never_fits(self, spec):
        if self.devices_total is not None and \
                spec.devices > self.devices_total:
            return (f"devices demand {spec.devices} exceeds fleet total "
                    f"{self.devices_total}")
        if self.ring_bytes_total and \
                spec.ring_bytes > self.ring_bytes_total:
            return (f"ring_bytes demand {spec.ring_bytes} exceeds fleet "
                    f"total {self.ring_bytes_total}")
        if self.staging_bytes_total and \
                spec.staging_bytes > self.staging_bytes_total:
            return (f"staging_bytes demand {spec.staging_bytes} exceeds "
                    f"fleet total {self.staging_bytes_total}")
        return None

    def _fits_now(self, spec):
        dev, ring, stg = self._committed()
        eff = self.devices_effective()
        if eff is not None and dev + spec.devices > eff:
            return False
        if self.ring_bytes_total and \
                ring + spec.ring_bytes > self.ring_bytes_total:
            return False
        if self.staging_bytes_total and \
                stg + spec.staging_bytes > self.staging_bytes_total:
            return False
        return True

    # ---------------------------------------------------------- admission
    def submit(self, spec, warm_start=None):
        """Submit a TenantSpec -> its Tenant, RUNNING (admitted, its
        service live), QUEUED or REJECTED (`reject_reason` says why).
        `warm_start` (a predecessor's exit-report dict) goes to the spec
        factory at every admission where it takes one."""
        if not isinstance(spec, TenantSpec):
            raise TypeError("submit() takes a TenantSpec")
        with self._lock:
            if self._state == "stopped":
                raise RuntimeError("fleet scheduler is stopped")
            if spec.name in self.tenants:
                raise ValueError(f"tenant {spec.name!r} already submitted")
            self.counters["submitted"] += 1
            tenant = Tenant(spec, self._seq)
            tenant.warm_start = warm_start
            self._seq += 1
            self.tenants[spec.name] = tenant
            reason = self._never_fits(spec)
            if reason is None and len(self._queue) >= self.max_queue and \
                    not self._fits_now(spec):
                reason = (f"admission queue is full "
                          f"({len(self._queue)}/{self.max_queue})")
            if reason is not None:
                tenant.state = REJECTED
                tenant.reject_reason = reason
                self.counters["rejected"] += 1
                self._note("reject", tenant, reason=reason)
                return tenant
            if self._starvation_window() > 0 and self._queue:
                # With the guard on, the aged queue is backfilled first,
                # so fresh high-priority submissions cannot overtake a
                # starved queue head every time capacity frees.
                self._admission_pass()
            if self._fits_now(spec):
                self._admit(tenant)
            else:
                self._enqueue(tenant)
            return tenant

    def _enqueue(self, tenant):
        # caller holds the lock; effective priority first, then FIFO
        if tenant.queued_since is None:
            tenant.queued_since = time.monotonic()
        self._queue.append(tenant)
        self._queue.sort(key=lambda t: (-t.effective_priority, t.seq))
        if tenant.state != PREEMPTED:
            tenant.state = QUEUED
        self.counters["queued"] += 1
        self._note("queue", tenant, priority=tenant.priority)

    @staticmethod
    def _starvation_window():
        return float(config.get("fleet_starvation_s"))

    def _age_queue(self):
        """The starvation guard (caller holds the lock): each full
        `fleet_starvation_s` a tenant has waited raises its effective
        priority one step.  Off at 0 (the default)."""
        window = self._starvation_window()
        if window <= 0 or not self._queue:
            return
        now = time.monotonic()
        changed = False
        for t in self._queue:
            if t.queued_since is None:
                t.queued_since = now
                continue
            steps = int((now - t.queued_since) / window)
            if steps > t.boost:
                self.counters["starvation_promotions"] += steps - t.boost
                t.boost = steps
                changed = True
                self._note("starvation_promote", t,
                           effective_priority=t.effective_priority,
                           waited_s=round(now - t.queued_since, 3))
        if changed:
            self._queue.sort(key=lambda t: (-t.effective_priority, t.seq))

    def _admit(self, tenant):
        """Build and start the tenant's Service (caller holds the
        lock)."""
        spec = tenant.spec.resolve_spec(warm_start=tenant.warm_start)
        svc = Service(spec, name=tenant.name, device=self.device)
        # Every device sink stages through the tenant's view of the
        # fleet pool.
        tenant.pool_view = self.staging_pool.view(
            tenant.name, tenant.spec.staging_bytes)
        for b in svc.pipeline.blocks:
            if isinstance(b, DeviceSinkBlock):
                b.egress_pool = tenant.pool_view
        tenant.service = svc
        tenant.state = RUNNING
        tenant.admissions += 1
        tenant.admitted_t = time.perf_counter()
        tenant._ring_over = False
        tenant._adm_sampled = False
        tenant.queued_since = None
        tenant.boost = 0
        self.counters["admitted"] += 1
        self._note("admit", tenant, priority=tenant.priority,
                   devices=tenant.spec.devices)
        svc.start()
        return tenant

    def _admission_pass(self):
        """Admit every queued tenant that fits, best effective priority
        first (a small tenant may pass a big one that cannot fit yet).
        Caller holds the lock."""
        self._age_queue()
        admitted = []
        for tenant in list(self._queue):
            if self._fits_now(tenant.spec):
                self._queue.remove(tenant)
                self._admit(tenant)
                admitted.append(tenant)
        return admitted

    # --------------------------------------------------------- preemption
    def _preempt_until_fits(self):
        """Shed the lowest-priority running tenants until the device
        demand fits the effective budget (caller holds the lock)."""
        eff = self.devices_effective()
        if eff is None:
            return []
        victims = []
        while True:
            running = [t for t in self.tenants.values()
                       if t.state == RUNNING and t.spec.devices > 0]
            if sum(t.spec.devices for t in running) <= eff:
                break
            # Lowest priority first; ties shed the youngest admission.
            victim = min(running, key=lambda t: (t.priority, -t.seq))
            self._preempt(victim)
            victims.append(victim)
        return victims

    def _preempt(self, tenant):
        svc = tenant.service
        self.counters["preempted"] += 1
        tenant.preemptions += 1
        self._note("preempt", tenant, priority=tenant.priority,
                   devices=tenant.spec.devices)
        if svc is not None:
            self._sample_admission(tenant)
            report = svc.stop(timeout=self._preempt_quiesce)
            tenant.exit_report = report
            tenant.exit_codes.append(report.exit_code)
        if tenant.pool_view is not None:
            tenant.pool_view.drain()
        tenant.service = None
        tenant.state = PREEMPTED
        self._queue.append(tenant)
        self._queue.sort(key=lambda t: (-t.effective_priority, t.seq))

    # ------------------------------------------------------------ reaping
    def _reap_finished(self):
        """Collect tenants whose run ended on its own (a finite stream,
        an escalation): record the exit report, free their resources.
        Caller holds the lock."""
        reaped = []
        for tenant in self.tenants.values():
            svc = tenant.service
            if tenant.state != RUNNING or svc is None or svc.running:
                continue
            self._sample_admission(tenant)
            report = svc.stop()       # idempotent; builds the report
            tenant.exit_report = report
            tenant.exit_codes.append(report.exit_code)
            if tenant.pool_view is not None:
                tenant.pool_view.drain()
            tenant.service = None
            tenant.state = STOPPED
            self.counters["completed"] += 1
            self._note("complete", tenant, exit_code=report.exit_code)
            reaped.append(tenant)
        return reaped

    # ------------------------------------------------------ usage sampling
    @staticmethod
    def _tenant_ring_bytes(tenant):
        """The ring capacity the tenant's pipeline holds, in bytes."""
        svc = tenant.service
        return 0 if svc is None else pipeline_ring_bytes(svc.pipeline)

    def _sample_usage(self):
        """Each running tenant's ring bytes against its claim: rings that
        outgrew it book one quota violation (edge-triggered).  Caller
        holds the lock."""
        usage = {}
        for tenant in self.tenants.values():
            if tenant.state != RUNNING:
                continue
            self._sample_admission(tenant)
            used = self._tenant_ring_bytes(tenant)
            usage[tenant.name] = used
            quota = tenant.spec.ring_bytes
            over = bool(quota) and used > quota
            if over and not tenant._ring_over:
                tenant.quota_violations += 1
                self.counters["quota_violations"] += 1
                self._note("quota_violation", tenant, resource="ring_bytes",
                           used=used, quota=quota)
            tenant._ring_over = over
        return usage

    def _sample_admission(self, tenant):
        """One admission -> first committed sink gulp sample per
        admission (FrameLedger.first_sink_t, perf_counter).  Caller holds
        the lock; called from usage sampling and every teardown path."""
        if tenant._adm_sampled or tenant.admitted_t is None:
            return
        svc = tenant.service
        if svc is None:
            return
        first = svc.ledger.first_sink_t
        if first is None:
            return
        tenant._adm_sampled = True
        self._admission_samples.append(max(0.0, first - tenant.admitted_t))
        del self._admission_samples[:-4096]

    @staticmethod
    def _pctl(vals, q):
        if not vals:
            return None
        s = sorted(vals)
        return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]

    # ---------------------------------------------------------- lifecycle
    def start(self):
        """Start the control loop (admission, reaping, preemption, health
        push) -> self."""
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("fleet scheduler already started")
            if self._state == "stopped":
                raise RuntimeError("fleet scheduler is stopped")
            # The kernel_cache flag: every admission, restart and respec
            # rebuild finds what an earlier process built (cache.py).
            from . import cache as _kcache
            _kcache.maybe_enable_from_config()
            self._state = "running"
            self._thread = threading.Thread(
                target=self._control_loop, name=f"{self.name}.control",
                daemon=True)
            self._thread.start()
        return self

    def _on_shard_transition(self, kind, device):
        # On the transitioning thread: park and poke, nothing more.
        if kind in ("evict", "restore", "resize") and \
                len(self._pending_transitions) < self.MAX_EVENTS:
            self._pending_transitions.append((kind, device))
            self._poke.set()

    def _drain_transitions(self):
        # caller holds the lock
        while self._pending_transitions:
            kind, device = self._pending_transitions.pop(0)
            if kind == "evict":
                self.counters["evictions_seen"] += 1
                self._note("evict_seen", "mesh", device=device)
            elif kind == "restore":
                self.counters["restores_seen"] += 1
                self._note("restore_seen", "mesh", device=device)
            else:
                self.counters["resizes_seen"] += 1
                self._note("resize_seen", "mesh", tag=device)

    def poll(self):
        """One control pass: reap finished tenants, preempt where
        evictions over-commit the device budget, admit what now fits,
        sample usage.  The control loop calls it each tick; a caller may
        call it instead for deterministic scheduling."""
        with self._lock:
            if self._state == "stopped":
                return
            self._drain_transitions()
            # Reap first: a finished tenant still counts as committed
            # until reaped, and preempting a live one for room a dead one
            # is vacating would be a spurious shed.
            reaped = self._reap_finished()
            preempted = self._preempt_until_fits()
            admitted = self._admission_pass()
            self._sample_usage()
        return {"preempted": [t.name for t in preempted],
                "reaped": [t.name for t in reaped],
                "admitted": [t.name for t in admitted]}

    # ------------------------------------------------- elastic operations
    def respec(self, tenant_name, stage_name, new_stage, timeout=None):
        """Replace one stage of a RUNNING tenant's chain (Service.respec)
        and book the downtime in the tenant's ledger.  The splice runs
        outside the scheduler lock; the service's stop lock serialises
        it against a preemption's stop, so a chain is never torn down
        half-spliced."""
        with self._lock:
            tenant = self.tenants.get(tenant_name)
            if tenant is None:
                raise KeyError(f"no tenant {tenant_name!r}")
            if tenant.state != RUNNING or tenant.service is None:
                raise RuntimeError(
                    f"tenant {tenant_name!r} is {tenant.state}; only a "
                    f"running tenant's chain can be respecced")
            svc = tenant.service
        rec = svc.respec(stage_name, new_stage, timeout=timeout)
        with self._lock:
            self.counters["respecs"] += 1
            tenant.downtime["respec_s"] += (
                rec.get("downtime_s") or rec.get("splice_s") or 0.0)
            self._note("respec", tenant, stage=stage_name,
                       outcome=rec.get("outcome"),
                       rolled_back=rec.get("rolled_back"),
                       downtime_s=rec.get("downtime_s"))
        return rec

    def resize(self, name, ndevices):
        """Change a tenant's declared device share, live.  A shrink frees
        capacity at once (an admission pass backfills the queue); a grow
        reclaims from strictly lower-priority running tenants, lowest
        first, after a feasibility check (an infeasible grow raises and
        sheds no one).  The running tenant is not restarted: the new
        share takes effect through `faultdomain.note_geometry_change()`,
        the effective-mesh rebuild and realign, so every guarded dispatch
        re-resolves its mesh at its next gulp edge."""
        ndevices = int(ndevices)
        if ndevices < 0:
            raise ValueError("ndevices must be >= 0")
        t0 = time.monotonic()
        with self._lock:
            tenant = self.tenants.get(name)
            if tenant is None:
                raise KeyError(f"no tenant {name!r}")
            if tenant.state in (STOPPED, REJECTED, RETIRING):
                raise RuntimeError(
                    f"tenant {name!r} is {tenant.state}; only queued or "
                    f"running tenants can be resized")
            old = tenant.spec.devices
            if self.devices_total is not None and \
                    ndevices > self.devices_total:
                raise ValueError(
                    f"devices demand {ndevices} exceeds fleet total "
                    f"{self.devices_total}")
            preempted = []
            if ndevices != old:
                self.counters["resizes"] += 1
                if tenant.state == RUNNING:
                    if ndevices > old and self.devices_total is not None:
                        dev, _, _ = self._committed()
                        eff = self.devices_effective() or 0
                        need = dev - old + ndevices - eff
                        lower = [v for v in self.tenants.values()
                                 if v is not tenant and v.state == RUNNING
                                 and v.spec.devices > 0
                                 and v.priority < tenant.priority]
                        reclaimable = sum(v.spec.devices for v in lower)
                        if need > reclaimable:
                            raise RuntimeError(
                                f"cannot grow {name!r} to {ndevices} "
                                f"devices: need {need} more, only "
                                f"{reclaimable} reclaimable from lower-"
                                f"priority tenants")
                        while need > 0:
                            victim = min(lower,
                                         key=lambda v: (v.priority, -v.seq))
                            lower.remove(victim)
                            self._preempt(victim)
                            self.counters["resize_preemptions"] += 1
                            preempted.append(victim.name)
                            need -= victim.spec.devices
                    tenant.spec.devices = ndevices
                    faultdomain.note_geometry_change(f"{self.name}:{name}")
                else:
                    # Queued or preempted: the demand is declared anew; one
                    # that can never fit becomes a rejection.
                    tenant.spec.devices = ndevices
                    reason = self._never_fits(tenant.spec)
                    if reason is not None:
                        if tenant in self._queue:
                            self._queue.remove(tenant)
                        tenant.state = REJECTED
                        tenant.reject_reason = reason
                        self.counters["rejected"] += 1
                        self._note("reject", tenant, reason=reason)
                admitted = self._admission_pass()
            else:
                admitted = []
            downtime = round(time.monotonic() - t0, 6)
            tenant.downtime["resize_s"] += downtime
            self._note("resize", tenant, devices_from=old,
                       devices_to=ndevices, preempted=preempted,
                       downtime_s=downtime)
            return {"tenant": name, "devices_from": old,
                    "devices_to": ndevices, "state": tenant.state,
                    "preempted": preempted,
                    "admitted": [t.name for t in admitted],
                    "downtime_s": downtime}

    def redeploy(self, specs, deadline_s=None):
        """Rolling redeploy: replace the named tenants one at a time,
        ascending predecessor priority (the most important streams on
        the old spec the longest), each predecessor's exit report handed
        to its successor as `warm_start`.  Bounded by `deadline_s`,
        abortable with `abort_roll()`; a cut-off leaves the tenants not
        yet rolled on their old specs.  -> the roll report (also
        `last_roll`)."""
        specs = list(specs)
        for s in specs:
            if not isinstance(s, TenantSpec):
                raise TypeError("redeploy() takes TenantSpecs")
        t0 = time.monotonic()
        deadline = None if deadline_s is None else t0 + float(deadline_s)
        with self._lock:
            if self._state == "stopped":
                raise RuntimeError("fleet scheduler is stopped")
            if self._rolling:
                raise RuntimeError("a rolling redeploy is already in "
                                   "progress")
            order = []
            for s in specs:
                pred = self.tenants.get(s.name)
                if pred is None:
                    raise KeyError(f"redeploy: no tenant {s.name!r}")
                order.append((pred.priority, pred.seq, s))
            order.sort(key=lambda x: (x[0], x[1]))
            self._rolling = True
            self._abort_roll.clear()
            self.counters["redeploys"] += 1
            self._note("roll_start", self.name,
                       tenants=[s.name for _, _, s in order],
                       deadline_s=deadline_s)
        steps = []
        status = "completed"
        try:
            for _, _, spec in order:
                if self._abort_roll.is_set():
                    status = "aborted"
                    break
                if deadline is not None and time.monotonic() > deadline:
                    status = "deadline"
                    break
                steps.append(self._roll_step(spec))
        finally:
            rolled = {s["tenant"] for s in steps}
            with self._lock:
                self._rolling = False
                self.counters["redeploy_steps"] += len(steps)
                if status != "completed":
                    self.counters["redeploy_aborts"] += 1
                self.last_roll = {
                    "status": status,
                    "duration_s": round(time.monotonic() - t0, 6),
                    "steps": steps,
                    "replaced": [s["tenant"] for s in steps
                                 if s.get("ok")],
                    "survivors": [s.name for _, _, s in order
                                  if s.name not in rolled],
                }
                self._note("roll_end", self.name, status=status,
                           replaced=len(steps),
                           duration_s=self.last_roll["duration_s"])
        return dict(self.last_roll)

    def _roll_step(self, spec):
        """One redeploy step: retire the predecessor (bounded quiesce,
        exit report recorded, name freed), then submit the successor
        with the predecessor's exit report as `warm_start`."""
        ts = time.monotonic()
        with self._lock:
            pred = self.tenants.get(spec.name)
            if pred is None:
                return {"tenant": spec.name, "ok": False,
                        "error": "tenant disappeared mid-roll"}
            svc = pred.service
            if pred in self._queue:
                self._queue.remove(pred)
            if pred.state == RUNNING:
                self._sample_admission(pred)
            # RETIRING keeps the reaper and the preemptor off it while its
            # service stops outside the lock.
            pred.state = RETIRING
        report = svc.stop(timeout=self._preempt_quiesce) \
            if svc is not None else None
        with self._lock:
            if report is not None:
                pred.exit_report = report
                pred.exit_codes.append(report.exit_code)
            if pred.pool_view is not None:
                pred.pool_view.drain()
            pred.service = None
            pred.state = STOPPED
            self.counters["completed"] += 1
            self._note("retire", pred,
                       exit_code=report.exit_code
                       if report is not None else None)
            # Out of the live table (the successor takes the name), kept
            # for stop()'s aggregation.
            self.retired.append(pred)
            del self.tenants[pred.name]
        warm = pred.exit_report.as_dict() \
            if pred.exit_report is not None else None
        try:
            successor = self.submit(spec, warm_start=warm)
        except Exception as e:  # noqa: BLE001 — reported per step
            return {"tenant": spec.name, "ok": False,
                    "predecessor_exit": report.exit_code
                    if report is not None else None,
                    "error": repr(e),
                    "downtime_s": round(time.monotonic() - ts, 6)}
        downtime = round(time.monotonic() - ts, 6)
        with self._lock:
            successor.downtime["redeploy_s"] += downtime
        return {"tenant": spec.name,
                "ok": successor.state in (RUNNING, QUEUED),
                "state": successor.state,
                "predecessor_exit": report.exit_code
                if report is not None else None,
                "warm_start": warm is not None,
                "downtime_s": downtime}

    def abort_roll(self):
        """Cut a rolling redeploy at its next step boundary (the current
        step completes; the rest keep their old specs)."""
        self._abort_roll.set()
        self._poke.set()

    def _control_loop(self):
        while True:
            self._poke.wait(self._health_interval)
            self._poke.clear()
            if self._stop_evt.is_set():
                return
            try:
                self.poll()
                self._push_health()
            except Exception as e:  # noqa: BLE001 — surfaced in stop()
                self._error = e

    def wait(self, timeout=None, poll_s=0.05, drain_queue=False):
        """Block until no tenant is RUNNING (and, with `drain_queue`, the
        queue is empty) -> True, or False at `timeout`."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._thread is None:
                self.poll()     # no control loop: schedule here
            with self._lock:
                active = any(t.state == RUNNING
                             for t in self.tenants.values())
                if drain_queue:
                    active = active or bool(self._queue)
            if not active:
                return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(poll_s)

    def stop(self, timeout=None):
        """Stop the control loop and every running tenant (bounded
        quiesce each, highest priority last) and fold the
        FleetExitReport (idempotent)."""
        with self._lock:
            if self.exit_report is not None:
                return self.exit_report
            self._stop_evt.set()
            self._poke.set()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
        with self._lock:
            if self._listener is not None:
                faultdomain.remove_transition_listener(self._listener)
                self._listener = None
            self._drain_transitions()
            self._reap_finished()
            running = sorted(
                (t for t in self.tenants.values() if t.state == RUNNING),
                key=lambda t: (t.priority, t.seq))
            for tenant in running:
                svc = tenant.service
                report = svc.stop(timeout=timeout) if svc is not None \
                    else None
                if report is not None:
                    tenant.exit_report = report
                    tenant.exit_codes.append(report.exit_code)
                if tenant.pool_view is not None:
                    tenant.pool_view.drain()
                tenant.service = None
                tenant.state = STOPPED
                self.counters["completed"] += 1
                self._note("complete", tenant,
                           exit_code=report.exit_code
                           if report is not None else None)
            residual = [t.name for t in self._queue]
            del self._queue[:]
            uptime = round(time.monotonic() - self._started_t, 3)
            tenants = {}
            worst = EXIT_CLEAN
            # Retired predecessors count too, keyed name@seq (their names
            # went to the successors).
            rows = [(t.name, t) for t in self.tenants.values()] + \
                [(f"{t.name}@{t.seq}", t) for t in self.retired]
            for key, t in rows:
                rep = t.exit_report
                tenants[key] = {
                    "state": t.state,
                    "priority": t.priority,
                    "admissions": t.admissions,
                    "preemptions": t.preemptions,
                    "quota_violations": t.quota_violations,
                    "exit_codes": list(t.exit_codes),
                    "reject_reason": t.reject_reason,
                    "downtime": dict(t.downtime),
                    "exit": rep.as_dict() if rep is not None else None,
                }
                if any(c == EXIT_ESCALATED for c in t.exit_codes):
                    worst = EXIT_ESCALATED
                elif worst != EXIT_ESCALATED and (
                        any(c == EXIT_DEGRADED for c in t.exit_codes) or
                        t.preemptions or t.state in (QUEUED, PREEMPTED)):
                    worst = EXIT_DEGRADED
            if self._error is not None:
                worst = EXIT_ESCALATED
            state = {EXIT_CLEAN: "stopped", EXIT_DEGRADED: "degraded",
                     EXIT_ESCALATED: "escalated"}[worst]
            self._state = "stopped"
            self.exit_report = FleetExitReport(
                exit_code=worst, state=state, uptime_s=uptime,
                counters=dict(self.counters, queued_at_stop=len(residual)),
                tenants=tenants,
                recovery=self._aggregate_recovery(),
                shard_recovery=self._aggregate_recovery(shard_only=True),
                availability_pct=self._availability_pct(),
                error=repr(self._error) if self._error is not None
                else None)
        self._push_health()
        return self.exit_report

    # ------------------------------------------------------------- health
    def _live_supervisors(self):
        return [t.service.supervisor for t in self.tenants.values()
                if t.service is not None]

    def _aggregate_recovery(self, shard_only=False):
        """Fleet-wide recovery percentiles over the live tenants'
        supervisors (stopped tenants' summaries are in their exit
        reports)."""
        return Supervisor.aggregate_recovery_stats(
            self._live_supervisors(), shard_only=shard_only)

    @staticmethod
    def _availability_pct():
        return round(faultdomain.availability_pct(), 4)

    @property
    def state(self):
        with self._lock:
            return self._state

    def snapshot(self):
        """The fleet's health snapshot (what the control loop pushes to
        the `<fleet>/fleet` ProcLog)."""
        from .cache import kernel_cache_info
        now = time.monotonic()
        with self._lock:
            dev, ring, stg = self._committed()
            tenants = {}
            agg_ledger = {"committed_frames": 0, "lost_frames": 0,
                          "duplicated_frames": 0, "shed_frames": 0,
                          "restart_shed_frames": 0, "shard_shed_frames": 0}
            restarts = 0
            for t in self.tenants.values():
                svc = t.service
                sup = t.supervisor()
                budgets = sup.budget_remaining() if sup is not None \
                    else None
                ledger = t.ledger_summary()
                if ledger:
                    for k in agg_ledger:
                        agg_ledger[k] += int(ledger.get(k, 0))
                nrestarts = (sup.counters.get("restarts", 0)
                             if sup is not None else
                             (t.exit_report.counters.get("restarts", 0)
                              if t.exit_report is not None else 0))
                restarts += nrestarts
                live_respecs = len(svc.respecs) if svc is not None else 0
                live_respec_dt = svc.respec_downtime_s \
                    if svc is not None else 0.0
                tenants[t.name] = {
                    "state": t.state,
                    "service_state": svc.state if svc is not None
                    else None,
                    "priority": t.priority,
                    "effective_priority": t.effective_priority,
                    "devices": t.spec.devices,
                    "ring_bytes": t.spec.ring_bytes,
                    "ring_bytes_used": self._tenant_ring_bytes(t),
                    "staging": t.pool_view.stats()
                    if t.pool_view is not None else None,
                    "restarts": nrestarts,
                    "budget_remaining": budgets,
                    "budget_min": min(budgets.values())
                    if budgets else None,
                    "ledger": ledger,
                    "admissions": t.admissions,
                    "preemptions": t.preemptions,
                    "quota_violations": t.quota_violations,
                    "reject_reason": t.reject_reason,
                    "respecs": live_respecs,
                    # max, not sum: fleet.respec books the splice the live
                    # service accumulated too.
                    "downtime": dict(
                        t.downtime,
                        respec_s=round(max(t.downtime["respec_s"],
                                           live_respec_dt), 6)),
                }
            queue = [t.name for t in self._queue]
            counters = dict(self.counters)
            try:
                kcache = kernel_cache_info()
            except Exception:  # noqa: BLE001 — observability only
                kcache = None
            adm = list(self._admission_samples)
            elastic = {
                "respecs": counters["respecs"],
                "resizes": counters["resizes"],
                "resize_preemptions": counters["resize_preemptions"],
                "redeploys": counters["redeploys"],
                "starvation_promotions": counters["starvation_promotions"],
                "rolling": self._rolling,
                "last_roll": dict(self.last_roll)
                if self.last_roll is not None else None,
                "retired": [t.name for t in self.retired],
                "admission_samples": len(adm),
                "admission_p50_s": round(self._pctl(adm, 0.50), 6)
                if adm else None,
                "admission_p99_s": round(self._pctl(adm, 0.99), 6)
                if adm else None,
                "kernel_cache": kcache,
            }
            return {
                "name": self.name,
                "state": self._state,
                "uptime_s": round(now - self._started_t, 3),
                "devices": {"total": self.devices_total,
                            "effective": self.devices_effective(),
                            "committed": dev},
                "ring_bytes": {"total": self.ring_bytes_total,
                               "committed": ring},
                "staging": self.staging_pool.stats(),
                "tenants": tenants,
                "queue": queue,
                "queue_depth": len(queue),
                "counters": counters,
                "restarts": restarts,
                "elastic": elastic,
                "ledger": agg_ledger,
                "recovery": self._aggregate_recovery(),
                "shard_recovery": self._aggregate_recovery(shard_only=True),
                "availability_pct": self._availability_pct(),
            }

    def _push_health(self):
        try:
            snap = self.snapshot()
            nrun = sum(1 for t in snap["tenants"].values()
                       if t["state"] == RUNNING)
            entry = {
                "state": snap["state"],
                "uptime_s": snap["uptime_s"],
                "tenants_running": nrun,
                "tenants_queued": snap["queue_depth"],
                "admitted": snap["counters"]["admitted"],
                "rejected": snap["counters"]["rejected"],
                "preempted": snap["counters"]["preempted"],
                "completed": snap["counters"]["completed"],
                "quota_violations": snap["counters"]["quota_violations"],
                "restarts": snap["restarts"],
                "availability_pct": snap["availability_pct"],
                "committed_frames": snap["ledger"]["committed_frames"],
                "lost_frames": snap["ledger"]["lost_frames"],
                "duplicated_frames": snap["ledger"]["duplicated_frames"],
            }
            rec = snap["recovery"]
            if rec["count"]:
                entry["recovery_p50_s"] = round(rec["p50_s"], 6)
                entry["recovery_p99_s"] = round(rec["p99_s"], 6)
            entry["snapshot"] = json.dumps(snap, default=str)
            self._proclog.update(entry)
        except Exception:  # noqa: BLE001 — observability only
            pass
