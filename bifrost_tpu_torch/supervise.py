"""Pipeline supervision: restart policies, the heartbeat watchdog, shed
and degrade accounting (counterpart of bifrost_tpu/supervise.py).

`Pipeline.run()` stays fail-fast; a stream opts in:

    from bifrost_tpu_torch.supervise import RestartPolicy
    pipe.run(supervise=RestartPolicy(max_restarts=3, window_s=60.0))

- **Restart per policy**: a supervised block that raises mid-sequence
  ends its output sequences (downstream sees end-of-sequence), runs
  `on_sequence` again and resumes at the next gulp of its input.  The
  faulted gulp's output reservations are cancelled behind a fence event
  and its input spans held until it (pipeline._abandon_gulp), so no
  ring byte goes back while stream work may still touch it.  Each
  restart counts against `RestartPolicy(max_restarts, window_s)`; an
  exhausted budget escalates to a pipeline shutdown that raises a
  `SupervisorEscalation` from `Pipeline.run`.
- **Heartbeat watchdog**: every block thread stamps `_heartbeat` once a
  gulp.  A block that misses `heartbeat_misses` periods of
  `heartbeat_interval_s` gets the deadman: its rings are interrupted
  with generations aimed at its token (ring.py), which raise
  RingInterrupted out of any ring wait; the block acknowledges exactly
  the generations it saw and restarts per policy.  A block that still
  does not stamp (wedged outside a ring wait: a stream synchronisation,
  an event wait, a hung copy) escalates one horizon later, so the run
  ends in bounded time.  Blocks woken by a peer's deadman resume their
  wait in place, uncounted.
- **Overload shedding** (sources): `SourceBlock(on_overrun=
  'drop_oldest')` drops gulps under back-pressure; the shed frames
  surface as `shed` events.

Every event is kept in `Supervisor.events`, counted in a
`<pipeline>/supervise` ProcLog (proclog.supervise_metrics) and tracked
in `telemetry`.  A fused group's events name its `constituents`.

Live respec (service.Service.respec) rides `replace_block`, which hands
a spliced-out block's watchdog slot to its replacement, and
`record_respec`, which books the splice.  A controller over many
supervisors (fleet.FleetScheduler) reads `budget_remaining()` (every
block at once) and merges `recovery_samples()` across tenants with
`Supervisor.aggregate_recovery_stats`.

Mesh pipelines add shard fault domains (parallel/faultdomain.py): a
sharded dispatch that misses its `mesh_collective_timeout_s` deadline is
declared a `ShardFault(device, block, gulp)` by the collective watchdog
(a `shard_fault` event, `record_shard_fault`), handled here as an
ordinary supervised restart that also evicts the attributed device
(`shard_evict`), so the restarted sequence runs on the survivors;
`record_shard_restore` books the device's return, and
`shard_recovery_stats()` summarizes the shard-fault recoveries.

Heartbeat tuning: a block idle in a ring wait behind a slow upstream
looks like a wedged one, so `heartbeat_interval_s * heartbeat_misses`
must exceed the longest normal stall, first-sequence set-up included
(`service.Service.start()` builds the CUDA kernels before it arms the
watchdog).
"""

from __future__ import annotations

import json
import threading
import time

from . import telemetry
from .pipeline import OverrunError
from .proclog import ProcLog
from .ring import RingInterrupted

__all__ = ["RestartPolicy", "Supervisor", "SupervisorEscalation",
           "OverrunError", "SuperviseEvent"]


class SupervisorEscalation(RuntimeError):
    """Supervision gave up: restart budget exhausted or a block wedged
    beyond the deadman's reach.  `report` is the structured failure
    record (block, reason, restart count, last error, event tail)."""

    def __init__(self, report):
        self.report = dict(report)
        super().__init__(
            "pipeline supervision escalated: " + json.dumps(self.report))


class RestartPolicy(object):
    """Per-block restart budget: at most `max_restarts` restarts within
    any sliding `window_s` seconds window, with `backoff * 2**k` seconds
    of delay before the k-th consecutive restart (capped at 10 s)."""

    def __init__(self, max_restarts=3, window_s=60.0, backoff=0.1):
        if max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        self.max_restarts = int(max_restarts)
        self.window_s = float(window_s)
        self.backoff = float(backoff)

    def __repr__(self):
        return (f"RestartPolicy(max_restarts={self.max_restarts}, "
                f"window_s={self.window_s}, backoff={self.backoff})")


class SuperviseEvent(object):
    """One supervision event: kind + block + free-form details."""

    __slots__ = ("kind", "block", "time", "details")

    def __init__(self, kind, block, details):
        self.kind = kind
        self.block = block
        self.time = time.time()
        self.details = details

    def as_dict(self):
        return {"kind": self.kind, "block": self.block, "time": self.time,
                **self.details}

    def __repr__(self):
        return f"SuperviseEvent({self.as_dict()!r})"


class _BlockState(object):
    """Supervisor-side bookkeeping for one block."""

    __slots__ = ("policy", "restart_times", "consecutive", "last_error",
                 "deadman_time", "deadman_pending", "deadman_gens",
                 "recovering")

    def __init__(self, policy):
        self.policy = policy
        self.restart_times = []     # monotonic stamps inside the window
        self.consecutive = 0        # consecutive restarts (backoff key)
        self.last_error = None
        self.deadman_time = None    # monotonic stamp of last deadman fire
        self.deadman_pending = False
        # (restart SuperviseEvent, fault monotonic stamp) while a restart
        # is in flight: the first healthy gulp after it stamps the
        # recovery time into the event (Supervisor.note_progress).
        self.recovering = None
        # The (ring, generation) pairs the deadman fired at this block.
        # Resolution acks exactly these generations — a bounded ack can
        # never retire a later fire aimed at a peer on a shared ring,
        # unlike the old single-shot latch clear.
        self.deadman_gens = []


class Supervisor(object):
    """Watches a Pipeline's blocks: restart budget accounting, the
    heartbeat watchdog thread, and the supervise event stream.

    Created implicitly by `Pipeline.run(supervise=RestartPolicy(...))`
    (one policy for every block), or explicitly for per-block policies:

        sup = Supervisor(policy=RestartPolicy(2),
                         policies={"fragile_block": RestartPolicy(10)})
        pipe.run(supervise=sup)
    """

    MAX_EVENTS = 1024  # in-memory event ring; proclog keeps the counters

    # Default watchdog horizon: interval * misses = 60 s, above the
    # routine stalls of a healthy pipeline (a first sequence's set-up:
    # kernel builds, FFT plans, first allocations; a source held in
    # back-pressure), because a deadman on a healthy block costs restart
    # budget and, mid-sequence, a sequence teardown.  Lower it where
    # latency matters.
    def __init__(self, policy=None, policies=None,
                 heartbeat_interval_s=5.0, heartbeat_misses=12,
                 on_event=None):
        self.policy = policy if policy is not None else RestartPolicy()
        self.policies = dict(policies or {})
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.heartbeat_misses = int(heartbeat_misses)
        self.on_event = on_event
        self.events = []
        self.failure = None         # SupervisorEscalation, set once
        self.pipeline = None
        self._states = {}           # id(block) -> _BlockState
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._proclog = None
        self._counters = {"faults": 0, "restarts": 0, "heartbeat_misses": 0,
                          "deadman_interrupts": 0, "shed_frames": 0,
                          "escalations": 0, "recoveries": 0, "degrades": 0,
                          "shard_faults": 0, "shard_evictions": 0,
                          "shard_restores": 0, "respecs": 0}
        # Recovery times (fault -> first healthy gulp after the restart),
        # bounded like the event ring; recovery_stats() summarizes.
        # Shard-fault restarts also land in the shard list, which the
        # service publishes as shard-recovery p50/p99.
        self._recovery_times = []
        self._shard_recovery_times = []
        self._by_name = {}          # block name -> _BlockState

    # ------------------------------------------------------------ lifecycle
    def attach(self, pipeline):
        if self.pipeline is not None and self.pipeline is not pipeline:
            raise ValueError("Supervisor is already attached to a pipeline")
        self.pipeline = pipeline
        self._proclog = ProcLog(f"{pipeline.pname}/supervise")
        unmatched = set(self.policies) - {b.name for b in pipeline.blocks}
        # attach() runs after device-chain fusion: a policy keyed by a
        # pre-fusion CONSTITUENT name re-keys onto the fused group that
        # absorbed it (first policied constituent in chain order wins),
        # so ServiceSpec stage policies survive fusion instead of
        # silently reverting the group to the default budget.
        for b in pipeline.blocks:
            cns = [cn for cn in (getattr(b, "constituent_names", ()) or ())
                   if cn in self.policies]
            if not cns:
                continue
            if b.name not in self.policies:
                self.policies[b.name] = self.policies[cns[0]]
            unmatched.difference_update(cns)
        if unmatched:
            # What remains is a typo (or a block that never got built):
            # it would otherwise be IGNORED silently and the block would
            # run under the default budget.
            import warnings
            warnings.warn(
                f"supervision policies for unknown blocks "
                f"{sorted(unmatched)} — misspelled, or absorbed into a "
                f"fused block? (post-fusion names: "
                f"{sorted(b.name for b in pipeline.blocks)})",
                stacklevel=3)
        for i, b in enumerate(pipeline.blocks):
            b._supervisor = self
            # Interrupt target token: stamped into every generation the
            # deadman fires at this block, so waiters (and operators
            # reading ring.interrupt_info()) can attribute a wakeup.
            b._intr_token = i + 1
            state = _BlockState(self.policies.get(b.name, self.policy))
            self._states[id(b)] = state
            self._by_name[b.name] = state
        # A deadman interrupt wakes EVERY waiter on the target's rings;
        # this hook (ring.Ring._wait_for) lets innocent waiters spin
        # in place instead of dying with the target's fault.
        for ring in pipeline.rings:
            ring._interrupt_retry = self._spurious_retry
            ring._progress_hook = self._note_alive
        self._flush_proclog()
        return self

    def replace_block(self, old, new, policy=None):
        """Hand `old`'s watchdog slot to its replacement across a live
        splice (service.Service.respec): `new` gets a fresh restart
        budget under `policy` (default: old's policy; a respec is a
        deliberate replacement, not a fault, so its strikes do not carry
        over) and old's interrupt token, which names the pipeline slot."""
        with self._lock:
            st = self._states.pop(id(old), None)
            pol = policy if policy is not None else \
                (st.policy if st is not None else self.policy)
            state = _BlockState(pol)
            self._states[id(new)] = state
            self._by_name[new.name] = state
            self.policies[new.name] = pol
        new._supervisor = self
        new._intr_token = getattr(old, "_intr_token", 0) or \
            (len(self.pipeline.blocks) + 1 if self.pipeline else 0)
        new._heartbeat = time.monotonic()
        # The adopted rings carry the hooks already; a ring the
        # replacement made afresh gets them too.
        if self.pipeline is not None:
            for ring in self.pipeline.rings:
                ring._interrupt_retry = self._spurious_retry
                ring._progress_hook = self._note_alive
        return state

    def _block_of_thread(self):
        pipe = self.pipeline
        ident = threading.get_ident()
        for b in (pipe.blocks if pipe is not None else ()):
            owns = getattr(b, "owns_thread", None)
            if (owns(ident) if owns is not None
                    else getattr(b, "_thread_ident", None) == ident):
                return b
        return None

    def _note_alive(self):
        """Ring-progress hook, on a reader's thread (under the ring's
        lock: it only stamps): the writer of the ring this block waits
        on committed, so the block is waiting on a live upstream, not
        wedged.  Without it a sink behind a long warm-up (the flagship
        beam FDMT commits empty spans for its first max_delay = 64
        integrations) can miss the default 30 s horizon."""
        block = self._block_of_thread()
        if block is not None:
            block._heartbeat = time.monotonic()

    def _spurious_retry(self):
        """Ring-wakeup arbitration, called on the WAITER's thread after a
        blocking ring call returned INTERRUPTED: True = spurious for this
        thread, retry the wait; False = surface RingInterrupted (pipeline
        shutdown, or this thread's block is the deadman's target)."""
        pipe = self.pipeline
        if pipe is None or pipe.shutdown_requested:
            return False
        block = self._block_of_thread()
        if block is not None:
            if getattr(block, "_splice_stop", False):
                # Live-respec quiesce (pipeline.quiesce_block): the
                # interrupt IS for this thread and the right outcome is
                # a clean exit, not a supervised restart.
                return False
            if getattr(block, "_deadman_fired", False):
                if getattr(block, "_supervised_region", False):
                    return False  # restartable: surface RingInterrupted
                # Deadman hit a wait the restart machinery cannot resume
                # (between input sequences).  Surfacing would kill the
                # block silently (Block._run swallows RingInterrupted),
                # truncating the stream with a "successful" run — absorb
                # in place instead: ack the observed generations and
                # keep waiting.
                block._deadman_fired = False
                state = self._states.get(id(block))
                if state is not None:
                    with self._lock:
                        state.deadman_pending = False
                        state.deadman_time = None
                self._ack_deadman_interrupts(block)
                self._emit("deadman_absorbed", block,
                           where="inter-sequence wait")
            # A retrying waiter is alive, just woken collaterally — keep
            # its heartbeat fresh so the watchdog does not cascade.
            block._heartbeat = time.monotonic()
        time.sleep(0.01)  # pace retries while the target clears the latch
        return True

    def start(self):
        """Start the watchdog (once the pipeline's block threads exist).

        Every block gets an initial heartbeat stamp here: a block that
        wedges BEFORE its first gulp (hung create_reader, a stuck
        device compile in on_sequence) would otherwise be invisible to
        the watchdog forever.  Consequently the heartbeat timeout must
        also cover legitimate initialization time (first-compile)."""
        if self._thread is None:
            now = time.monotonic()
            for b in (self.pipeline.blocks if self.pipeline else []):
                if b._heartbeat is None:
                    b._heartbeat = now
            self._thread = threading.Thread(
                target=self._watchdog, name="supervisor", daemon=True)
            self._thread.start()

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)

    # ------------------------------------------------------------- events
    def _emit(self, kind, block, **details):
        # Fused groups (the fusion compiler's FusedChainBlock /
        # MeshFusedBlock products) carry their constituent list on every
        # event, so operators and ledgers can attribute a group fault to
        # the original chain (docs/fault-tolerance.md).
        cn = getattr(block, "constituent_names", None)
        if cn and "constituents" not in details:
            details["constituents"] = list(cn)
        ev = SuperviseEvent(kind, getattr(block, "name", str(block)),
                            details)
        with self._lock:
            self.events.append(ev)
            del self.events[:-self.MAX_EVENTS]
            key = {"block_fault": "faults", "restart": "restarts",
                   "heartbeat_miss": "heartbeat_misses",
                   "deadman_interrupt": "deadman_interrupts",
                   "escalate": "escalations",
                   "degrade": "degrades",
                   "shard_fault": "shard_faults",
                   "shard_evict": "shard_evictions",
                   "shard_restore": "shard_restores",
                   "respec": "respecs"}.get(kind)
            if key is not None:
                self._counters[key] += 1
            if kind == "shed":
                self._counters["shed_frames"] += int(
                    details.get("nframe", 0))
            counters = dict(self._counters)
        telemetry.track(f"supervise:{kind}")
        self._flush_proclog(counters, ev)
        cb = self.on_event
        if cb is not None:
            try:
                cb(ev)
            except Exception:
                pass  # observer only — must never break supervision
        return ev

    def _flush_proclog(self, counters=None, last_event=None):
        if self._proclog is None:
            return
        entry = dict(counters if counters is not None else self._counters)
        if entry.get("recoveries"):
            rs = self.recovery_stats()
            entry["recovery_p50_s"] = round(rs["p50_s"], 6)
            entry["recovery_p99_s"] = round(rs["p99_s"], 6)
        if last_event is not None:
            entry["last_event"] = json.dumps(last_event.as_dict())
        try:
            self._proclog.update(entry)
        except Exception:
            pass  # observability only

    def events_for(self, block_name, kind=None):
        with self._lock:
            return [e for e in self.events
                    if e.block == block_name and
                    (kind is None or e.kind == kind)]

    @property
    def counters(self):
        with self._lock:
            return dict(self._counters)

    @staticmethod
    def _summarize_times(times):
        if not times:
            return {"count": 0, "last_s": None, "p50_s": None,
                    "p99_s": None, "max_s": None}
        ordered = sorted(times)

        def pct(p):
            # Nearest-rank: ceil(p/100 * n) - 1.  A plain int(p/100*n)
            # index is one rank high — it reports the max as the median
            # for n=2 and always serves p99 == max.
            import math
            return ordered[max(0, math.ceil(p / 100.0 * len(ordered)) - 1)]

        return {"count": len(ordered), "last_s": times[-1],
                "p50_s": pct(50), "p99_s": pct(99), "max_s": ordered[-1]}

    def recovery_stats(self):
        """Summary of restart recovery times (fault -> first healthy gulp
        after the restart): {count, last_s, p50_s, p99_s, max_s}.  The
        percentile fields are None until a recovery has completed, so a
        harness can report p50/p99 without parsing the event stream."""
        with self._lock:
            times = list(self._recovery_times)
        return self._summarize_times(times)

    def shard_recovery_stats(self):
        """Summary of the recoveries of restarts that followed a
        collective-watchdog ShardFault (fault -> first healthy gulp on
        the survivors); the service publishes them as shard-recovery
        p50/p99."""
        with self._lock:
            times = list(self._shard_recovery_times)
        return self._summarize_times(times)

    def recovery_samples(self, shard_only=False):
        """A copy of the raw recovery-time samples, for a controller over
        many supervisors to merge (`aggregate_recovery_stats`)."""
        with self._lock:
            return list(self._shard_recovery_times if shard_only
                        else self._recovery_times)

    @staticmethod
    def aggregate_recovery_stats(supervisors, shard_only=False):
        """One recovery summary over many supervisors (None entries
        skipped): their samples merged, summarised with
        `recovery_stats()`'s schema; `last_s` is the last sample of the
        last supervisor that has any."""
        merged = []
        for sup in supervisors:
            if sup is not None:
                merged.extend(sup.recovery_samples(shard_only=shard_only))
        return Supervisor._summarize_times(merged)

    def budget_remaining(self, block=None):
        """Restarts left in `block`'s sliding policy window right now
        (block object or name; None for an unknown block).  The service
        layer reads this to enter degraded mode BEFORE the budget
        exhausts and escalates.  With `block=None`: {block name:
        restarts left} of every supervised block, in one pass under one
        lock (a fleet snapshot's per-tenant budgets)."""
        now = time.monotonic()
        if block is None:
            with self._lock:
                return {
                    name: max(0, st.policy.max_restarts -
                              sum(1 for t in st.restart_times
                                  if now - t < st.policy.window_s))
                    for name, st in self._by_name.items()}
        state = self._states.get(id(block)) if not isinstance(block, str) \
            else self._by_name.get(block)
        if state is None and not isinstance(block, str):
            state = self._by_name.get(getattr(block, "name", None))
        if state is None:
            return None
        with self._lock:
            live = sum(1 for t in state.restart_times
                       if now - t < state.policy.window_s)
        return max(0, state.policy.max_restarts - live)

    # ---------------------------------------------------- fault handling
    def record_shed(self, block, nframe):
        """A source's overrun policy dropped `nframe` frames."""
        self._emit("shed", block, nframe=int(nframe))

    def record_degrade(self, block, **details):
        """A policy layer (service.py) degraded operation around `block`
        instead of letting its restart budget exhaust into an
        escalation; the event stream and counters record it.  A
        `recovered=True` detail records the EXIT from degraded mode as
        its own event kind, so the `degrades` counter stays a count of
        episodes, not transitions."""
        kind = "degrade_recover" if details.get("recovered") else "degrade"
        self._emit(kind, block, **details)

    def record_respec(self, block, **details):
        """A policy layer (service.Service.respec) replaced `block` at a
        gulp edge; the event stream and the `respecs` counter record the
        splice."""
        self._emit("respec", block, **details)

    def on_block_fault(self, block, exc):
        """Decide a faulted supervised block's fate.

        Called on the BLOCK's own thread from its restart wrapper.
        Returns the frame offset to resume the current input sequence at
        (sources ignore the value and rebuild their reader), or None to
        propagate the exception (fail-fast / escalation).
        """
        pipeline = self.pipeline
        if pipeline is None or pipeline.shutdown_requested:
            return None
        state = self._states.get(id(block))
        if state is None:
            return None
        loop_frame = getattr(block, "_loop_frame", 0)
        gulp = getattr(block, "_loop_gulp", None)
        if isinstance(exc, RingInterrupted):
            # Ring-wait wakeup.  Three cases: pipeline shutdown (handled
            # above — propagate), this block's own deadman (a counted
            # restart, same frame: the data it was waiting on may arrive
            # yet), or collateral from a peer's deadman (resume in place,
            # uncounted).
            deadman = getattr(block, "_deadman_fired", False)
            block._deadman_fired = False
            with self._lock:
                state.deadman_pending = False
                state.deadman_time = None
            block._heartbeat = time.monotonic()
            self._ack_deadman_interrupts(block)
            if pipeline.shutdown_requested:
                return None  # shutdown raced the clear: let it win
            if not deadman:
                return loop_frame
            resume = loop_frame
            shed_nframe = 0
        else:
            # A genuine block exception: the faulted gulp is shed; resume
            # at the next one.  (With no loop underway — a fault in
            # on_sequence — retry the sequence from where it stood.)
            resume = loop_frame + gulp if gulp else loop_frame
            shed_nframe = resume - loop_frame
        shard_extra = None
        from .parallel.faultdomain import ShardFault
        if isinstance(exc, ShardFault):
            # A collective-watchdog fault: evict the attributed device, so
            # every mesh consumer (bound_mesh -> effective_mesh) resolves
            # the survivors from here on.  The restart event carries the
            # attribution, so the service's ledger books the skipped gulp
            # as shed by a shard, not lost.  evict() reports the
            # transition: of two blocks faulting on one device, only the
            # one that evicted books the event.
            shard_extra = {"shard_device": exc.device,
                           "shard_reason": exc.reason}
            if exc.device is not None:
                from .parallel import faultdomain
                if faultdomain.evict(exc.device):
                    self._emit("shard_evict", block, device=exc.device,
                               gulp=exc.gulp)
        return self._count_restart(block, state, exc, resume, shed_nframe,
                                   shard_extra)

    def record_shard_fault(self, block, fault, timeout_s=None):
        """Called by the mesh collective watchdog (parallel/faultdomain)
        on its monitor thread when `block`'s sharded dispatch missed the
        `mesh_collective_timeout_s` deadline.  Event and counter only:
        the fault itself is raised on the dispatching thread and handled
        by `on_block_fault`."""
        self._emit("shard_fault", block, device=fault.device,
                   gulp=fault.gulp, reason=fault.reason,
                   timeout_s=timeout_s)

    def record_shard_restore(self, device, block="mesh"):
        """An evicted shard returned to the mesh (the service's
        auto-restore, or an operator)."""
        self._emit("shard_restore", block, device=device)

    def _count_restart(self, block, state, exc, resume, shed_nframe=0,
                       shard_extra=None):
        now = time.monotonic()
        with self._lock:
            # repr, not the exception object: a live exception pins its
            # traceback (and every frame in it — including ring spans
            # held by the faulted loop) for the supervisor's lifetime.
            state.last_error = repr(exc)
            state.restart_times = [
                t for t in state.restart_times
                if now - t < state.policy.window_s]
            if len(state.restart_times) >= state.policy.max_restarts:
                over_budget = True
            else:
                over_budget = False
                state.restart_times.append(now)
                state.consecutive += 1
                backoff = min(
                    state.policy.backoff * 2 ** (state.consecutive - 1),
                    10.0)
        if over_budget:
            self._escalate(block, "restart budget exhausted", exc=exc,
                           restarts=len(state.restart_times))
            return None
        fault_detail = {"error": repr(exc)}
        # A fused-group fault annotated during constituent header
        # composition (pipeline._constituent_on_sequence) names the
        # STAGE, not just the group.
        constituent = getattr(exc, "_bt_fused_constituent", None)
        if constituent is not None:
            fault_detail["constituent"] = constituent
        self._emit("block_fault", block, **fault_detail)
        # Sources ignore the resume frame — a reader fault re-creates
        # the reader (streams cannot be seeked) while a deadman in the
        # output reserve resumes the wait in place — so reporting a
        # resume_frame would mislead an operator debugging replayed
        # data.  Name what actually happens instead.
        if getattr(block, "_restart_semantics", "resume") == \
                "reader_rebuild":
            detail = {"restart_kind": "wait_resumed_in_place"
                      if isinstance(exc, RingInterrupted)
                      else "reader_rebuilt"}
        else:
            detail = {"resume_frame": resume}
        if shed_nframe:
            # Frames the restart skips over (the faulted gulp): the
            # frame-continuity ledger reads this instead of inferring it
            # from resume arithmetic.
            detail["shed_nframe"] = shed_nframe
        if shard_extra:
            detail.update({k: v for k, v in shard_extra.items()
                           if v is not None})
        ev = self._emit("restart", block,
                        restarts=len(state.restart_times),
                        backoff_s=backoff, **detail)
        # Recovery clock: fault observed `now`; the first healthy gulp
        # after the restart stamps `recovery_s` into this event and the
        # recoveries counter (note_progress).  Backoff time counts — it
        # is part of what the pipeline's consumers actually waited.
        with self._lock:
            state.recovering = (ev, now, shard_extra is not None)
        # Backoff on the block's own thread, in slices that keep the
        # heartbeat fresh (a backoff is not a wedge); bail on shutdown.
        deadline = time.monotonic() + backoff
        while not self.pipeline.shutdown_requested:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            block._heartbeat = time.monotonic()
            self.pipeline._shutdown_event.wait(min(remaining, 0.2))
        block._heartbeat = time.monotonic()
        if self.pipeline.shutdown_requested:
            return None
        return resume

    def absorb_stale_deadman(self, block):
        """Absorb a deadman the block OUTLIVED: the interrupt fired while
        it idled between sequences, but the next sequence arrived before
        the block re-entered a blocking call, so the pending generation
        would otherwise surface MID-sequence — a counted restart and a
        spurious output-sequence split for a demonstrably alive block.
        Called on the block's thread at sequence entry (generations close
        the lost-interrupt race; this closes the late-observation one)."""
        if not getattr(block, "_deadman_fired", False):
            return
        block._deadman_fired = False
        state = self._states.get(id(block))
        if state is not None:
            with self._lock:
                state.deadman_pending = False
                state.deadman_time = None
        block._heartbeat = time.monotonic()
        self._ack_deadman_interrupts(block)
        self._emit("deadman_absorbed", block, where="sequence entry")

    def note_progress(self, block):
        """A block completed a gulp: reset its consecutive-restart run and
        stamp the recovery time of any restart in flight (fault -> this
        first healthy gulp) into the restart event + counters.  Healthy
        blocks take only the attribute checks — no lock, no allocation."""
        state = self._states.get(id(block))
        if state is None or not (state.consecutive or state.recovering):
            return
        with self._lock:
            state.consecutive = 0
            state.deadman_time = None
            state.deadman_pending = False
            rec, state.recovering = state.recovering, None
            if rec is not None:
                ev, fault_t, is_shard = rec
                recovery_s = time.monotonic() - fault_t
                ev.details["recovery_s"] = round(recovery_s, 6)
                self._recovery_times.append(recovery_s)
                del self._recovery_times[:-self.MAX_EVENTS]
                if is_shard:
                    self._shard_recovery_times.append(recovery_s)
                    del self._shard_recovery_times[:-self.MAX_EVENTS]
                self._counters["recoveries"] += 1
                counters = dict(self._counters)
        if rec is not None:
            self._flush_proclog(counters, ev)

    @staticmethod
    def _block_rings(block):
        return [getattr(r, "base_ring", r)
                for r in list(getattr(block, "irings", []) or []) +
                list(getattr(block, "orings", []) or [])]

    def _ack_deadman_interrupts(self, block):
        """Retire the generations the deadman fired at `block` — and ONLY
        those.  The ack is bounded by the recorded generation per ring,
        so it can never swallow a later (or concurrently fired) interrupt
        aimed at a peer sharing the ring — the race that let the old
        blanket clear leave a peer's `deadman_pending` stuck and escalate
        a healthy pipeline (ROADMAP deadman-latch item)."""
        state = self._states.get(id(block))
        if state is None:
            return
        with self._lock:
            gens, state.deadman_gens = state.deadman_gens, []
        for base, gen in gens:
            try:
                base.ack_interrupt(gen)
            except Exception:
                pass

    # ---------------------------------------------------------- watchdog
    def _escalate(self, block, reason, exc=None, **details):
        report = {"block": getattr(block, "name", str(block)),
                  "reason": reason, **details}
        if exc is not None:
            report["error"] = repr(exc)
        with self._lock:
            recent = [e.as_dict() for e in self.events[-8:]]
        report["recent_events"] = recent
        self._emit("escalate", block, reason=reason,
                   **({"error": repr(exc)} if exc is not None else {}))
        if self.failure is None:
            failure = SupervisorEscalation(report)
            failure.__cause__ = exc
            self.failure = failure
        self.pipeline.shutdown()

    def _watchdog(self):
        interval = self.heartbeat_interval_s
        timeout = interval * self.heartbeat_misses
        pipeline = self.pipeline
        while not self._stop.wait(interval):
            if pipeline.shutdown_requested:
                # Re-interrupt each tick until stop: a supervised block's
                # interrupt-clear may have raced the shutdown broadcast.
                for ring in pipeline.rings:
                    try:
                        ring.interrupt()
                    except Exception:
                        pass
                continue
            now = time.monotonic()
            for b in pipeline.blocks:
                hb = getattr(b, "_heartbeat", None)
                if hb is None:
                    continue  # not streaming yet
                if getattr(b, "_thread_done", False):
                    continue  # finished cleanly: frozen heartbeat is fine
                state = self._states.get(id(b))
                if state is None:
                    continue
                stale = now - hb
                if stale < timeout:
                    state.deadman_time = None
                    state.deadman_pending = False
                    continue
                if state.deadman_pending and state.deadman_time is not None:
                    if now - state.deadman_time >= timeout:
                        # The interrupt did not wake it: wedged outside
                        # any ring wait (hung device call, stuck I/O).
                        self._escalate(
                            b, "block unresponsive after deadman "
                               "interrupt", stale_s=round(stale, 3))
                    else:
                        # Re-fire while pending: generations make the ack
                        # race-free, and this closes the residual window
                        # where the target was between ring waits when
                        # the original generation fired and got retired.
                        # New generations on the same rings supersede the
                        # recorded ones; the eventual bounded ack covers
                        # both.
                        self._fire_deadman_interrupts(b, state)
                    continue
                self._emit("heartbeat_miss", b, stale_s=round(stale, 3),
                           timeout_s=timeout)
                self._deadman(b, state)

    def _deadman(self, block, state):
        state.deadman_time = time.monotonic()
        state.deadman_pending = True
        self._emit("deadman_interrupt", block)
        # Blocks wedged in EXTERNAL blocking resources (shm rings,
        # sockets) may provide an `on_deadman()` hook that interrupts
        # them restartably; without one, only internal ring waits can be
        # woken and an external wedge escalates after the next timeout
        # (bounded, but pipeline-fatal).  `on_shutdown` is deliberately
        # NOT reused here: shutdown hooks may tear resources down
        # permanently, which would make every restart impossible.
        hook = getattr(block, "on_deadman", None)
        if hook is not None:
            try:
                hook()
            except Exception:
                pass
        self._fire_deadman_interrupts(block, state)

    def _fire_deadman_interrupts(self, block, state):
        """Fire one interrupt generation per ring of `block`, targeted at
        its token, and record the (ring, gen) pairs for the bounded ack.

        Ordering matters: `_deadman_fired` becomes visible only AFTER the
        generations are recorded.  A waiter that wakes mid-fire sees the
        flag unset, treats the wakeup as collateral and retries — the
        generation stays pending, so it re-observes the interrupt once
        the flag (and the recorded gens its handler will ack) are in
        place.  No fire can be consumed before it is accounted."""
        token = getattr(block, "_intr_token", 0)
        gens = []
        for base in self._block_rings(block):
            try:
                gens.append((base, base.interrupt(target=token)))
            except Exception:
                pass
        with self._lock:
            state.deadman_gens = gens
        block._deadman_fired = True
