"""Pipeline framework: thread-per-block gulp streaming over rings
(counterpart of bifrost_tpu/pipeline.py; reference python/bifrost/
pipeline.py).

BlockScope hierarchical defaults, a Pipeline with an init barrier, the
Source / MultiTransform / Transform / Sink block classes with the
synchronous gulp loop: input overlap (`define_input_overlap_nframe`),
the exact emit schedule (`output_nframes_for_gulp`), and skip handling;
and the header views (`RingView`, `SequenceView`, `block_view`).

The async gulp executor (`pipeline_async_depth` > 1): a source,
transform or sink that touches the card runs its gulps, in order, on a
worker thread (`_GulpDispatcher`) bound to the block's CUDA stream,
while the block thread reserves and acquires the next gulp's spans (a
source also stages it: `_source_loop_async`; transforms and sinks:
`_sequence_loop_async`).  `strict_sync` keeps every block synchronous
and synchronised each gulp; `serialize_dispatch` puts one lock around
every block's device scope (`_device_lock`).  The same worker class
carries the egress stager (egress.py) and the fused groups' gulps.

Fusion: `Pipeline.run` first runs the fusion compiler (fuse.py), which
replaces each maximal run of fuse-scoped device blocks
(`block_scope(fuse=True)`) with one `FusedTransformBlock`;
`Pipeline.fusion_report()` returns its decisions.

Supervision (supervise.py): `Pipeline.run(supervise=...)` attaches a
Supervisor; every block then stamps `_heartbeat` once a gulp, a
supervised block that faults is torn down and restarted per its policy
(`_supervised_sequence`, the source's restart loop), and a source may
shed or refuse load under back-pressure (`SourceBlock(on_overrun=)`).
With `supervise=None` a block error still shuts the pipeline down.
`shutdown(timeout=)` is the bounded quiesce, returning a `DrainReport`;
`quiesce_block` stops one block at a gulp edge.

The live splice (service.Service.respec; bifrost_tpu/pipeline.py:
525-595, 703-725): `quiesce_block` stops one block at a gulp edge and
leaves its output rings' writing open; a replacement built under a
`Pipeline._ring_adoptions` entry takes those rings over in
`create_ring` (refusing another space), inherits the open writing
(`_adopted_began_writing`), and takes over its predecessor's place in
the input stream: its sequence cursors (`ring.SequenceCursor`, so the read
guarantee is held across the splice), the open input sequences where
the quiesce broke out of one (`_splice_mid_sequence`), and the frame to
resume them at (`_splice_resume_frame`: the sync loop's next gulp, the
async executor's dispatch frontier after its worker drained).  A
spliced-out block synchronises its CUDA stream before its thread ends,
so nothing it queued is still running when the replacement starts;
`splice_forget` and `splice_start` swap the blocks in the roster.

Each block writes its
`bind`, `in`, `out`, `sequence0` and (at most every
`proclog.PERF_FLUSH_S`) `perf` logs (proclog.py) under its log name
(`Block.log_name`): the block's name, or `<name>#2`, `#3`, ... where a
live block of the process already logs under it (two pipelines of one
topology in one process), the rule of the ring logs (ring.py).  The JAX
package keys block logs by name alone.

The mesh (parallel/): the `mesh=` and `shard=` scope settings lay a
scope's device gulps out over a `parallel.Mesh` (`bound_mesh`, through
`faultdomain.effective_mesh`, so an eviction is seen at the next read;
`shard_labels`); `mesh_gulp_factor` scales a mesh scope's gulps; every
sharded dispatch runs through `Block.mesh_dispatch`, under the
collective watchdog; `MeshFusedBlock` runs a mesh compute block and its
accumulate tail as one deferred-reduction group.

Device handling: a pipeline runs on one torch device, the card unless
the caller passes ``device='cpu'``; with no card and no device named,
`Pipeline()` raises.  Each block thread runs on its own CUDA stream.
Blocks hand device spans across streams through the rings' commit and
release events (ring.py), so a gulp whose outputs stay on the device
needs no host synchronisation; one whose outputs are host memory is
synchronised before its commit.
"""

from __future__ import annotations

import contextlib
import copy as _copy
import json
import queue
import threading
import time
import warnings

import torch

from . import affinity
from . import device as _device
from .proclog import PERF_FLUSH_S, ProcLog
from .ring import (EndOfDataStop, ReadSequence, Ring, RingInterrupted,
                   SequenceCursor, TensorInfo)
from .trace import trace_scope

__all__ = ["Pipeline", "get_default_pipeline", "block_scope", "BlockScope",
           "Block", "SourceBlock", "SinkBlock", "TransformBlock",
           "MultiTransformBlock", "PipelineInitError", "RingView",
           "SequenceView", "block_view", "DrainReport", "OverrunError"]


class PipelineInitError(RuntimeError):
    pass


class OverrunError(RuntimeError):
    """A source with on_overrun='fail' hit downstream back-pressure."""


class DrainReport(object):
    """Outcome of a bounded quiesce (`Pipeline.shutdown(timeout=)`),
    bifrost_tpu/pipeline.py:44-100.

    `blocks` maps block name -> {"outcome", "wait_s"[, "queued_gulps"]
    [, "constituents"]}: "drained" (exited in the cooperative window),
    "interrupted" (exited after the deadline's interrupts), "wedged"
    (still running when the quiesce returned; its daemon thread is
    abandoned).  "queued_gulps" counts a straggler's gulps in flight on
    its worker or egress stager at the deadline; a fused group lists its
    "constituents"."""

    def __init__(self, timeout):
        self.timeout = float(timeout)
        self.started = time.monotonic()
        self.elapsed_s = None
        self.blocks = {}

    def _record(self, name, outcome, queued=None, constituents=None):
        entry = {"outcome": outcome,
                 "wait_s": round(time.monotonic() - self.started, 3)}
        if queued is not None:
            entry["queued_gulps"] = queued
        if constituents:
            entry["constituents"] = list(constituents)
        self.blocks[name] = entry

    @property
    def clean(self):
        """Every block drained cooperatively."""
        return all(v["outcome"] == "drained" for v in self.blocks.values())

    @property
    def wedged(self):
        return [name for name, v in self.blocks.items()
                if v["outcome"] == "wedged"]

    def as_dict(self):
        return {"timeout_s": self.timeout, "elapsed_s": self.elapsed_s,
                "clean": self.clean, "blocks": dict(self.blocks)}

    def __repr__(self):
        return f"DrainReport({self.as_dict()!r})"


_tls = threading.local()


def _scope_stack():
    if not hasattr(_tls, "scopes"):
        _tls.scopes = []
    return _tls.scopes


# The pipeline made where a block is built with none entered, shared by
# every thread.
_default_pipelines = []


def _pipeline_stack():
    """The pipelines this thread has entered: one thread's `with pipe:`
    (a fleet admitting a tenant, a respec building a stage) never
    captures the blocks another thread builds at the same time."""
    if not hasattr(_tls, "pipelines"):
        _tls.pipelines = []
    return _tls.pipelines


def get_default_pipeline():
    """The innermost active Pipeline (reference pipeline.py:74)."""
    stack = _pipeline_stack()
    if stack:
        return stack[-1]
    if not _default_pipelines:
        _default_pipelines.append(Pipeline())
    return _default_pipelines[-1]


class BlockScope(object):
    """Hierarchical defaults resolved by parent walk
    (reference pipeline.py:87-165)."""

    _settable = ("gulp_nframe", "buffer_nframe", "buffer_factor", "core",
                 "device", "fuse", "share_temp_storage", "mesh", "shard")
    instance_count = 0

    def __init__(self, name=None, parent=None, **kwargs):
        for key in kwargs:
            if key not in self._settable:
                raise TypeError(f"unexpected scope setting: {key}")
        self._settings = {k: kwargs.get(k) for k in self._settable}
        if name is None:
            name = f"scope_{BlockScope.instance_count}"
        BlockScope.instance_count += 1
        self.scope_name = name
        stack = _scope_stack()
        self._parent = parent if parent is not None else \
            (stack[-1] if stack else None)

    def _lookup(self, key, default=None):
        scope = self
        while scope is not None:
            val = scope._settings.get(key)
            if val is not None:
                return val
            scope = scope._parent
        return default

    def __enter__(self):
        _scope_stack().append(self)
        return self

    def __exit__(self, *exc):
        _scope_stack().pop()

    # Scaled by the `mesh_gulp_factor` flag under a mesh scope; blocks
    # whose semantics pin the gulp (AccumulateBlock's one-frame loop)
    # opt out.
    mesh_gulp_scale_ok = True

    @property
    def gulp_nframe(self):
        g = self._lookup("gulp_nframe")
        if g and self.mesh_gulp_scale_ok and \
                self._lookup("mesh") is not None:
            from . import config
            f = config.get("mesh_gulp_factor")
            if f > 1:
                return g * int(f)
        return g

    @property
    def buffer_factor(self):
        return self._lookup("buffer_factor", 3)

    @property
    def buffer_nframe(self):
        return self._lookup("buffer_nframe")

    @property
    def device(self):
        """The torch device this scope's blocks run on."""
        return self._lookup("device")

    @property
    def bound_device(self):
        """The device setting of the nearest scope that names one (the
        JAX package's name for `device`)."""
        return self._lookup("device")

    @property
    def core(self):
        """The CPU core this scope's block threads are pinned to, or None."""
        return self._lookup("core")

    @property
    def bound_mesh(self):
        """The parallel.Mesh of the nearest `mesh=` scope setting, through
        `faultdomain.effective_mesh`: once a shard is evicted, every mesh
        consumer resolves the survivors at its next read, so a restarted
        block rebuilds its layout without the bad device while the
        others keep streaming.  With no eviction on record this is the
        scope setting itself."""
        mesh = self._lookup("mesh")
        if mesh is None:
            return None
        from .parallel.faultdomain import effective_mesh
        return effective_mesh(mesh)

    @property
    def shard_labels(self):
        """{header axis label: mesh axis name} from the `shard=` setting."""
        return self._lookup("shard")

    @property
    def share_temp_storage(self):
        """Accepted for the reference's API: the port's blocks keep no
        shared scratch (temp_storage.TempStorage is the allocator)."""
        return self._lookup("share_temp_storage")


def block_scope(**kwargs):
    """`with bf.block_scope(gulp_nframe=4096, core=2): ...`; `core` pins
    the threads of the blocks built inside to that CPU core; `fuse=True`
    marks them as candidates for the fusion compiler; `mesh=` (a
    parallel.Mesh) lays their device gulps out over a mesh, `shard=`
    ({label: mesh axis}) maps header labels to mesh axes."""
    return BlockScope(**kwargs)


class Pipeline(BlockScope):
    """The root scope: owns blocks and rings, runs them on threads
    (reference pipeline.py:226-308).  `device` is the torch device of
    the 'cuda' space: the card when None (raising where there is none),
    or what the caller names, e.g. 'cpu'."""

    instance_count = 0

    def __init__(self, device=None, **kwargs):
        kwargs["device"] = _device.resolve_device(device)
        Pipeline.instance_count += 1
        self.pname = f"pipeline_{Pipeline.instance_count - 1}"
        super().__init__(name=self.pname, parent=None, **kwargs)
        self.blocks = []
        self.rings = []
        self._shutdown_event = threading.Event()
        self._quiesce_event = threading.Event()
        self._quiesce_lock = threading.Lock()
        self._init_queue = queue.Queue()
        self._all_initialized = threading.Event()
        self._threads = []
        self._fusion_plan = None
        self._log_names = []     # block log names claimed, freed at run end
        self.drain_report = None
        # Live splice: block name -> the output rings its replacement
        # adopts in create_ring (service.Service._splice_build).
        self._ring_adoptions = {}
        # The Supervisor of a supervised run, for a controller thread
        # (service.py) to read while run() blocks; None when fail-fast.
        self.supervisor = None
        self.proclog = ProcLog(f"{self.pname}/info")

    def __enter__(self):
        _pipeline_stack().append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _pipeline_stack().pop()
        return super().__exit__(*exc)

    def as_default(self):
        return self

    def synchronize_block_initializations(self):
        """Barrier: every block reports init before data flows
        (reference pipeline.py:241-253)."""
        waiting = set(self.blocks)
        while waiting:
            try:
                block, ok, err = self._init_queue.get(timeout=0.25)
            except queue.Empty:
                if self._shutdown_event.is_set():
                    return
                continue
            waiting.discard(block)
            if not ok:
                self.shutdown()
                raise PipelineInitError(
                    f"block {block.name} failed to initialize: {err}")
        self._all_initialized.set()

    def _fuse_device_chains(self):
        """Run the fusion compiler (fuse.py) over the block graph.
        Idempotent: a caller may run it before `run()`, which runs it
        again, to inspect the fused topology."""
        from . import fuse
        return fuse.apply(self)

    def fusion_report(self):
        """The fusion compiler's decisions for this pipeline: the groups
        (rule, constituents, ring hops eliminated) and every refused
        block with its reason (fuse.REASONS).  Applies fusion first if
        it has not run yet."""
        if self._fusion_plan is None:
            self._fuse_device_chains()
        return self._fusion_plan.report()

    def run(self, supervise=None):
        """Fuse the device chains, then run every block on its own thread
        until the sources end and the end of data has flowed through.

        `supervise`: None (fail-fast: the first block error shuts the
        pipeline down and is re-raised here), a `supervise.RestartPolicy`
        (every block restarts per that policy, the watchdog at its
        defaults) or a `supervise.Supervisor`; a supervised run that
        escalates raises its `SupervisorEscalation`."""
        self._fuse_device_chains()
        supervisor = None
        if supervise is not None:
            from .supervise import Supervisor
            supervisor = supervise if isinstance(supervise, Supervisor) \
                else Supervisor(policy=supervise)
            supervisor.attach(self)      # after fusion: the final blocks
            self.supervisor = supervisor
        try:
            self._threads = []
            for b in self.blocks:
                t = threading.Thread(target=b._run, name=b.name,
                                     daemon=True)
                b._thread = t
                self._threads.append(t)
                t.start()
            # The watchdog starts before the init barrier: a block wedged
            # in its first sequence's set-up is then seen too.
            if supervisor is not None:
                supervisor.start()
            try:
                self.synchronize_block_initializations()
            finally:
                for t in self._threads:
                    while t.is_alive():
                        t.join(timeout=0.25)
                        if self._shutdown_event.is_set():
                            t.join(timeout=5.0)
                            break
            if supervisor is not None:
                supervisor.stop()
                if supervisor.failure is not None:
                    raise supervisor.failure
            errs = [b for b in self.blocks if b.error is not None]
            if errs:
                raise errs[0].error
        finally:
            if supervisor is not None:
                supervisor.stop()
            # The run is over: its blocks' log names are free for the
            # next pipeline of this topology (the logs stay).
            for name, owner_id in self._log_names:
                _release_block_log_name(name, owner_id)
            del self._log_names[:]

    def shutdown(self, timeout=None, join_grace=1.0):
        """Stop the pipeline.

        With no `timeout`: interrupt every ring (a broadcast generation)
        and run the blocks' `on_shutdown` hooks; whatever the rings hold
        is abandoned.  -> None.

        With `timeout` (seconds), the bounded quiesce: (a) sources end
        their sequences at the next gulp edge, (b) the end of data drains
        downstream while every block thread is joined until the deadline,
        (c) stragglers then get the interrupts above, (d) and `join_grace`
        seconds more.  -> a `DrainReport`; it returns within timeout +
        join_grace and scheduling slack, from any thread."""
        if timeout is not None:
            return self._quiesce(float(timeout), float(join_grace))
        self._shutdown_event.set()
        self._all_initialized.set()
        for ring in self.rings:
            ring.interrupt()
        for b in self.blocks:
            hook = getattr(b, "on_shutdown", None)
            if hook is not None:
                try:
                    hook()
                except Exception:  # noqa: BLE001 — best effort on shutdown
                    pass
        return None

    def _quiesce(self, timeout, join_grace):
        with self._quiesce_lock:
            report = DrainReport(timeout)
            deadline = report.started + timeout
            self._quiesce_event.set()          # (a) sources only

            def names(b):
                return getattr(b, "constituent_names", None)

            pending = [b for b in self.blocks
                       if b._thread is not None and b._thread.is_alive()]
            for b in self.blocks:
                if b not in pending:
                    report._record(b.name, "drained", constituents=names(b))
            while pending:                     # (b)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                pending[0]._thread.join(timeout=min(0.05, remaining))
                still = []
                for b in pending:
                    if b._thread.is_alive():
                        still.append(b)
                    else:
                        report._record(b.name, "drained",
                                       constituents=names(b))
                pending = still
            if pending:                        # (c), (d)
                queued = {b.name: b._async_queue_depth() for b in pending}
                self.shutdown()
                grace = time.monotonic() + join_grace
                for b in pending:
                    b._thread.join(timeout=max(0.0,
                                               grace - time.monotonic()))
                for b in pending:
                    report._record(
                        b.name, "wedged" if b._thread.is_alive()
                        else "interrupted", queued=queued.get(b.name),
                        constituents=names(b))
            # The pipeline is down either way: release a run() still at
            # the init barrier (a source stopped before its first
            # sequence never reports).
            self._shutdown_event.set()
            self._all_initialized.set()
            report.elapsed_s = round(time.monotonic() - report.started, 3)
            self.drain_report = report
            return report

    def quiesce_block(self, block, timeout=5.0, join_grace=1.0):
        """Stop one block at a gulp edge (bifrost_tpu/pipeline.py:
        525-572): its sequence loops exit and end their output
        sequences, not its output rings' writing.  Past `timeout` the
        block's rings get one interrupt generation each, aimed at it, and
        acknowledged after the join.  -> "drained", "interrupted" or
        "wedged" (still running: it must not be replaced)."""
        block._splice_stop = True
        t = block._thread
        if t is None or not t.is_alive():
            return "drained"
        deadline = time.monotonic() + float(timeout)
        while t.is_alive() and time.monotonic() < deadline:
            t.join(timeout=0.05)
        if not t.is_alive():
            return "drained"
        gens = []
        for r in list(block.irings) + list(block.orings):
            base = getattr(r, "base_ring", r)
            gens.append((base, base.interrupt(target=block._intr_token)))
        grace = time.monotonic() + float(join_grace)
        while t.is_alive() and time.monotonic() < grace:
            t.join(timeout=0.05)
        for base, gen in gens:
            base.ack_interrupt(gen)
        return "wedged" if t.is_alive() else "interrupted"

    def splice_start(self, block):
        """Start a replacement block's thread in the running pipeline; it
        joins the threads `run()` waits for."""
        t = threading.Thread(target=block._run, name=block.name,
                             daemon=True)
        block._thread = t
        self._threads.append(t)
        t.start()
        return t

    def splice_forget(self, block):
        """Drop a spliced-out block from the roster (its thread has
        exited; its rings stay, adopted by the replacement)."""
        try:
            self.blocks.remove(block)
        except ValueError:
            pass

    @property
    def shutdown_requested(self):
        return self._shutdown_event.is_set()

    @property
    def quiesce_requested(self):
        """True once a bounded shutdown asked the sources to wind down."""
        return self._quiesce_event.is_set()

    def dot_graph(self):
        """Graphviz text of the block and ring graph, in the JAX package's
        format (bifrost_tpu/pipeline.py:607-624; reference
        pipeline.py:166-206): a node a block, an edge a ring labelled with
        its space."""
        lines = ["digraph pipeline {", "  rankdir=LR;",
                 '  node [shape=box, style=rounded];']
        for b in self.blocks:
            label = b.name.replace('"', "'")
            lines.append(f'  "{b.name}" [label="{label}"];')
        for b in self.blocks:
            for ring in getattr(b, "irings", []):
                src = getattr(ring, "owner", None)
                base = getattr(ring, "base_ring", ring)
                srcname = src.name if src is not None else base.name
                space = getattr(base, "space", "system")
                lines.append(f'  "{srcname}" -> "{b.name}" '
                             f'[label="{space}"];')
        lines.append("}")
        return "\n".join(lines)


def izip(*iterables):
    return zip(*iterables)


_BLOCK_LOG_NAMES = {}   # log name -> id of the live block that holds it
_BLOCK_LOG_LOCK = threading.Lock()


def _claim_block_log_name(name, owner):
    """`name`, else `name#k` for the least k >= 2 no live block of this
    process logs as (the ring logs' rule, ring._claim_log_name)."""
    with _BLOCK_LOG_LOCK:
        cand, k = name, 1
        while cand in _BLOCK_LOG_NAMES:
            k += 1
            cand = f"{name}#{k}"
        _BLOCK_LOG_NAMES[cand] = id(owner)
        return cand


def _release_block_log_name(name, owner_id):
    # No lock: __del__ may run inside _claim_block_log_name on this
    # thread.  Only the holder frees a name (a block collected after its
    # run's release must not free a successor's claim).
    if _BLOCK_LOG_NAMES.get(name) == owner_id:
        _BLOCK_LOG_NAMES.pop(name, None)


def _ring_log_name(ring):
    """The log name (`Ring.log_name`) of `ring` or of the ring a view
    wraps, which the tools join a block's in/out logs by."""
    base = getattr(ring, "base_ring", ring)
    return getattr(base, "log_name", getattr(base, "name", "?"))


class Block(BlockScope):
    """Base block: owns output rings and a thread
    (reference pipeline.py:329-441)."""

    instance_count = 0
    _exec_async_depth = 0        # the executor's depth this sequence

    def __init__(self, irings, name=None, type_=None, **kwargs):
        self.pipeline = get_default_pipeline()
        type_ = type_ or type(self).__name__
        if name is None:
            name = f"{type_}_{Block.instance_count}"
        Block.instance_count += 1
        if kwargs.get("device") is not None:
            kwargs["device"] = _device.resolve_device(kwargs["device"])
        super().__init__(name=name, **kwargs)
        self.name = name
        self.type = type_
        self.error = None
        self._init_reported = False
        self._held_latches = []
        # Cumulative host seconds per loop phase (acquire = waiting for
        # input, reserve = waiting for output room, process = on_data up
        # to the commit-ready point, commit).  Device work is
        # asynchronous: `process` counts its enqueue, not its run.
        self.perf_totals = {}
        self._init_supervision_state()
        # Inputs may be Rings or other Blocks (their first output ring).
        self.irings = [i.orings[0] if isinstance(i, Block) else i
                       for i in irings]
        self.orings = []
        self.pipeline.blocks.append(self)
        self._init_proclogs()

    def _init_supervision_state(self):
        """Supervision bookkeeping (supervise.py); None/False is the
        fail-fast default.  Shared with FusedTransformBlock, which skips
        Block.__init__."""
        self._supervisor = None
        self._intr_token = 0         # interrupt target token (attach)
        self._heartbeat = None
        self._deadman_fired = False
        # Mesh fault domains (parallel/faultdomain): the collective
        # watchdog stamps a pending ShardFault here (the faultinject wedge
        # loop breaks on it), and the collective fault sites ride the
        # hook.
        self._shard_abort = None
        self._collective_fault_hook = None
        self._thread = None
        self._thread_ident = None
        # The block thread and its worker threads (fused groups, egress):
        # supervision and fault injection attribute a thread to its block
        # through this set.
        self._thread_idents = set()
        self._thread_done = False
        # The live splice (module docstring): quiesce_block asks the block
        # to exit at a gulp edge, leaving its output rings' writing open
        # for the replacement, which inherits it (_adopted_began_writing),
        # takes over its sequence cursors and, where the quiesce broke out
        # of an input sequence, that sequence and the frame to resume it
        # at.
        self._splice_stop = False
        self._began_writing = False
        self._adopted_began_writing = False
        self._splice_mid_sequence = False
        self._splice_resume_frame = None
        # (sequence cursors, open input sequences or None): handed out at
        # a splice exit, taken over by the replacement.
        self._splice_handoff = None
        self._adopted_handoff = None
        # True inside a restartable sequence; a deadman landing outside
        # one (waiting for the next input sequence) is absorbed in place.
        self._supervised_region = False
        self._loop_frame = 0         # input frame of the gulp in hand
        self._loop_gulp = None
        self._perf_flush_t = 0.0
        # The async gulp executor (base blocks' `pipeline_async_depth`
        # loops and the fused groups' worker): its worker, the block's
        # CUDA stream the worker runs on, whether the block has a 'cuda'
        # ring on either side (`_device_lock`), and a lock for the perf
        # totals both threads write.
        self._dispatcher = None
        self._stream = None
        self._touches_device = None
        self._perf_lock = threading.Lock()

    def _init_proclogs(self):
        """The block's logs (bifrost_tpu/pipeline.py:651-661) under its
        log name (module docstring); the input log names the base rings,
        so tools can join the graph."""
        if getattr(self, "log_name", None) is None:
            self.log_name = _claim_block_log_name(self.name, self)
            self.pipeline._log_names.append((self.log_name, id(self)))
        ln = self.log_name
        self.bind_proclog = ProcLog(f"{ln}/bind")
        self.in_proclog = ProcLog(f"{ln}/in")
        self.out_proclog = ProcLog(f"{ln}/out")
        self.sequence_proclog = ProcLog(f"{ln}/sequence0")
        self.perf_proclog = ProcLog(f"{ln}/perf")
        self.in_proclog.update({
            f"ring{i}": _ring_log_name(r) for i, r in enumerate(self.irings)})

    def __del__(self):
        # A block collected before its pipeline ran frees its log name.
        name = getattr(self, "log_name", None)
        if name is not None:
            _release_block_log_name(name, id(self))

    def mesh_dispatch(self, fn, *args, mesh=None):
        """Run one sharded dispatch under the collective watchdog
        (parallel/faultdomain): with `mesh_collective_timeout_s` set, a
        dispatch that does not return within the deadline surfaces as a
        supervised ShardFault(device, block, gulp) through this block's
        restart machinery instead of stalling every shard.  Also the home
        of the `collective.enter` / `shard.lost` / `shard.dispatch`
        faultinject seams.  With no mesh the call is a plain
        `fn(*args)`."""
        mesh = mesh if mesh is not None else self.bound_mesh
        if mesh is None:
            return fn(*args)
        from .parallel.faultdomain import guarded_call
        return guarded_call(self, mesh, fn, args)

    def shard_array(self, x, labels):
        """Lay tensor `x` out over the scope's mesh by axis label -> a
        parallel.shard.ShardedTensor (`x` as is without a `mesh=`
        setting), as a guarded dispatch."""
        mesh = self.bound_mesh
        if mesh is None or labels is None:
            return x
        from .parallel.shard import shard_put
        # strict="axes": a scope-wide shard= override may name labels
        # other headers of the chain carry; an unknown mesh axis raises.
        return self.mesh_dispatch(
            lambda a: shard_put(a, mesh, labels, self.shard_labels,
                                strict="axes"), x, mesh=mesh)

    def create_ring(self, space="system"):
        # A replacement built under a ring-adoption entry takes over the
        # spliced-out block's output ring: downstream readers hold it.
        pend = self.pipeline._ring_adoptions.get(self.name)
        if pend:
            ring = pend.pop(0)
            base = getattr(ring, "base_ring", ring)
            if base.space != space:
                raise ValueError(
                    f"{self.name}: splice replacement wants a {space!r}-"
                    f"space output ring but the adopted ring {base.name!r} "
                    f"is {base.space!r}: a respec cannot change a stage's "
                    f"output space")
            ring.owner = self
            return ring
        ring = Ring(space=space, name=f"{self.name}.out{len(self.orings)}",
                    device=self.device, core=self.core)
        ring.owner = self
        # The scope's mesh, against which readers resolve the layout a
        # sharded stream's header carries (ReadSpan.sharding).
        ring.mesh = self._lookup("mesh")
        self.pipeline.rings.append(ring)
        return ring

    def mark_initialized(self, ok=True, err=None):
        if not self._init_reported:
            self._init_reported = True
            self.pipeline._init_queue.put((self, ok, err))
            if ok:
                self.pipeline._all_initialized.wait()

    def _run(self):
        try:
            self._thread_ident = threading.get_ident()
            self._thread_idents.add(self._thread_ident)
            core = self.core
            if core is not None:
                affinity.set_core(core)
            affinity.set_thread_name(self.name[:15])
            self.bind_proclog.update({"core": core if core is not None
                                      else -1, "device": str(self.device)})
            if self.orings:
                self.out_proclog.update({
                    f"ring{i}": _ring_log_name(r)
                    for i, r in enumerate(self.orings)})
            _device.set_device(self.device)
            with _device.block_stream(self.device) as stream, \
                    trace_scope(f"block:{self.name}"):
                self._stream = stream
                returned = False
                try:
                    self.main()
                    returned = True
                finally:
                    # On a splice exit too: the replacement runs on a
                    # stream of its own, so nothing of this block's may
                    # still be queued.
                    if returned or self._splice_stop:
                        _device.stream_synchronize(self.device)
        except (EndOfDataStop, RingInterrupted):
            pass
        except Exception as e:  # noqa: BLE001 — block errors surface in run()
            self.error = e
            self.mark_initialized(ok=False, err=e)
            self.pipeline.shutdown()
        finally:
            # A finished block's heartbeat freezes: the watchdog must not
            # deadman it.
            self._thread_done = True
            try:
                self.shutdown()
            finally:
                self._close_dispatcher()
                self._release_flag_latches()
                self.mark_initialized()   # unblock the barrier on early exit

    def main(self):
        raise NotImplementedError

    def shutdown(self):
        """Hook run on the block's thread when it ends, however it ends:
        a block that holds a file, a socket or a worker releases it here
        (idempotent; the JAX package's `Block.shutdown`)."""

    # -- supervision seams
    def owns_thread(self, ident):
        """Is `ident` this block's thread or one of its workers?"""
        return ident == self._thread_ident or ident in self._thread_idents

    def _async_queue_depth(self):
        """Gulps in flight on this block's worker, or None without one."""
        d = getattr(self, "_dispatcher", None)
        return d.inflight() if d is not None else None

    def _supervised_resume(self, exc):
        """Ask the supervisor, if any, to absorb a fault: -> the input
        frame to resume the sequence at, or None to propagate."""
        sup = self._supervisor
        if sup is None:
            return None
        return sup.on_block_fault(self, exc)

    def _gulp_done(self, t_end, instant):
        """After each gulp: the heartbeat, the throttled perf log and the
        supervisor's progress note."""
        self._heartbeat = time.monotonic()
        if t_end - self._perf_flush_t > PERF_FLUSH_S:
            self._perf_flush_t = t_end
            self._flush_perf_proclog(instant)
        sup = self._supervisor
        if sup is not None:
            sup.note_progress(self)

    def _flush_perf_proclog(self, instant=None):
        """Cumulative (and, given, this gulp's) phase times to the perf
        log; callers throttle, and a sequence's end writes the totals."""
        entry = {f"total_{k}_time": v for k, v in self.perf_totals.items()}
        if instant:
            entry.update(instant)
        if entry:
            self.perf_proclog.update(entry)

    def _fault_fence(self):
        """An event after the stream work this thread has queued, or None
        on the CPU: the spans a fault gives back wait on it (ring.py)."""
        return _device.record_event(self.device)

    def _hold_flag_latch(self, flag):
        """Latch a config flag for the current sequence (config.py)."""
        from . import config
        config.hold_latch(flag, self.name)
        self._held_latches.append(flag)

    def _release_flag_latches(self):
        from . import config
        while self._held_latches:
            config.release_latch(self._held_latches.pop(), self.name)

    def _perf_add(self, **phases):
        # The async executor books acquire/reserve on the block thread and
        # process/commit on its worker.
        with self._perf_lock:
            for k, v in phases.items():
                self.perf_totals[k] = self.perf_totals.get(k, 0.0) + v

    def _device_lock(self):
        """Scope of this block's gulp work (bifrost_tpu/pipeline.py:728):
        the dispatch lock (`device.dispatch_lock`) for a block with a
        'cuda' ring on either side; a host-only block does no device work
        and skips it."""
        if self._touches_device is None:
            self._touches_device = any(
                getattr(r, "space", None) == "cuda"
                for r in list(self.irings) + list(self.orings)
                if r is not None)
        if self._touches_device:
            return _device.dispatch_lock()
        return contextlib.nullcontext()

    def _sink_gulp_sync(self):
        """Does a gulp with no output rings synchronise before its input
        spans go back?  (MultiTransformBlock decides for sinks.)"""
        return False

    def _sync_before_commit(self, ospans):
        """Host-space outputs must hold their bytes before the commit
        hands them on; device outputs ride the ring's commit event.  A
        sink synchronises where its reader needs it (`_sink_gulp_sync`),
        and under `strict_sync` every gulp leaves nothing in flight."""
        if any(os_.ring.space != "cuda" for os_ in ospans) or \
                (not ospans and self._sink_gulp_sync()) or \
                _device.needs_strict_sync():
            _device.stream_synchronize(self.device)

    def _bind_worker_thread(self):
        """Executor worker start: the worker counts as one of the block's
        threads (supervision, fault injection) and runs on the block's
        device and CUDA stream, so its launches, commit and release
        events follow the block thread's work on that stream."""
        self._thread_idents.add(threading.get_ident())
        _device.set_device(self.device)
        if self._stream is not None:
            torch.cuda.set_stream(self._stream)

    def _executor(self, depth):
        """The block's worker at `depth`, made anew where the depth
        changed between sequences (the old one is idle by then)."""
        if self._dispatcher is not None and self._dispatcher.depth != depth:
            self._close_dispatcher()
        if self._dispatcher is None:
            self._dispatcher = _GulpDispatcher(
                f"{self.name}.exec", depth=depth,
                on_worker_start=self._bind_worker_thread)
        return self._dispatcher

    def _close_dispatcher(self):
        """Drain and close the worker (idempotent).  A worker still in a
        hung call after the drain's 5 s is left behind as a daemon, with
        a warning, as is a worker exception the drain swallowed."""
        d = self._dispatcher
        if d is None:
            return
        d.drain(raise_exc=False, timeout=5)
        d.close()
        if d._thread.is_alive():
            warnings.warn(f"{self.name}: executor worker still alive after "
                          f"its 5 s shutdown drain (a hung device call?); "
                          f"leaving the daemon thread", RuntimeWarning,
                          stacklevel=2)
        if d._exc is not None:
            warnings.warn(f"{self.name}: executor worker held an exception "
                          f"at shutdown: {d._exc!r}", RuntimeWarning,
                          stacklevel=2)
        self._dispatcher = None

    def _retire_outstanding(self, outstanding, drained):
        """Teardown of an executor loop: the gulps its worker did not
        retire are given back, newest first (a cancel is legal only for a
        ring's final reservation), behind a fence after the stream work
        already queued; their input spans are held until the fence and
        released.  A worker that never went idle may still use them: they
        are left to it, with a warning."""
        if not outstanding:
            return
        if not drained:
            warnings.warn(f"{self.name}: abandoning {len(outstanding)} "
                          f"in-flight gulp(s) behind an undrained executor "
                          f"worker", RuntimeWarning, stacklevel=2)
            return
        fence = self._fault_fence()
        for ispans, ospans in reversed(list(outstanding)):
            _cancel_reservations(ospans, fence)
            for sp in ispans:
                sp.hold_until(fence)
                sp.release()
        del outstanding[:]


def _cancel_reservations(spans, fence=None):
    """Cancel uncommitted reservations, newest first (each is then the
    ring's final one), so a fault leaves none that would wedge the ring's
    in-order commit; the bytes go back behind `fence` (ring.py)."""
    for sp in reversed(spans):
        try:
            sp.cancel(fence)
        except Exception:  # noqa: BLE001 — best effort on a fault path
            try:
                sp.commit(0)
            except Exception:  # noqa: BLE001
                pass


def _abandon_gulp(block, ispans, ospans):
    """A gulp faulted: hold its input spans until the fence and cancel
    its output reservations behind it."""
    fence = block._fault_fence()
    for sp in ispans:
        sp.hold_until(fence)
    _cancel_reservations(ospans, fence)


class _ShedSpan(object):
    """A stand-in write span for a gulp that a source's overrun policy
    sheds: `on_data` writes or publishes it like a WriteSpan, nothing is
    committed."""

    def __init__(self, oseq, nframe):
        self.ring = oseq.ring
        self.tensor = oseq.tensor
        self.nframe = nframe
        self.commit_nframe = nframe
        self.frame_offset = 0
        dev = self.ring.device if self.ring.space == "cuda" else "cpu"
        self.data = torch.empty(self.tensor.span_shape(nframe),
                                dtype=self.tensor.torch_dtype, device=dev)

    def publish_external(self, arr, nframe=None):
        if nframe is not None:
            self.commit_nframe = nframe

    def commit(self, nframe=None):
        pass


class SourceBlock(Block):
    """Generates sequences from external sources
    (reference pipeline.py:442-521).

    `on_overrun`, the overload policy when downstream back-pressure
    would stall the source (bifrost_tpu/pipeline.py:1010-1023):
    'backpressure' (default) blocks in the output reserve; 'drop_oldest'
    reserves without blocking and, when that fails, lets `on_data` write
    a throwaway span and drops the gulp (counted in `shed_frames` and as
    supervise events); 'fail' raises `OverrunError`, a restartable fault
    under supervision.  Under supervision a fault re-creates the reader
    and starts the source's sequence over (a reader cannot be seeked)."""

    _restart_semantics = "reader_rebuild"

    def __init__(self, sourcenames, gulp_nframe, space="system", name=None,
                 on_overrun="backpressure", **kwargs):
        if on_overrun not in ("backpressure", "drop_oldest", "fail"):
            raise ValueError(f"unknown on_overrun policy {on_overrun!r}")
        super().__init__(irings=[], name=name, gulp_nframe=gulp_nframe,
                         **kwargs)
        self.sourcenames = sourcenames
        self.on_overrun = on_overrun
        self.shed_frames = 0
        self._shed_pending = 0
        self._shed_flush_t = 0.0
        self._shed_cache = None
        self.orings = [self.create_ring(space=space)]

    # -- subclass interface
    def create_reader(self, sourcename):
        raise NotImplementedError

    def on_sequence(self, reader, sourcename):
        """-> list of output headers (dicts with `_tensor`)."""
        raise NotImplementedError

    def on_data(self, reader, ospans):
        """-> list of nframe written per output span."""
        raise NotImplementedError

    def main(self):
        self.orings[0].begin_writing()
        try:
            for sourcename in self.sourcenames:
                if self.pipeline.shutdown_requested or \
                        self.pipeline.quiesce_requested:
                    break
                self._supervised_region = True
                try:
                    while True:
                        try:
                            self._run_source_sequence(sourcename)
                            break
                        except (EndOfDataStop, StopIteration):
                            raise
                        except BaseException as e:  # noqa: BLE001
                            if self._supervised_resume(e) is None:
                                raise
                finally:
                    self._supervised_region = False
        finally:
            self.orings[0].end_writing()

    def _reserve_or_shed(self, oseqs, gulp):
        """-> (spans, shed) per the overrun policy.  A deadman wakeup of
        the blocking reserve is absorbed here, in place: the sequence is
        intact, and restarting it would replay the stream."""
        got = []
        if self.on_overrun == "backpressure":
            while True:
                try:
                    for oseq in oseqs:
                        got.append(oseq.reserve(gulp))
                    return got, False
                except RingInterrupted as e:
                    _cancel_reservations(got)
                    del got[:]
                    if self._supervised_resume(e) is None:
                        raise
                except BaseException:
                    _cancel_reservations(got)
                    raise
        try:
            for oseq in oseqs:
                got.append(oseq.reserve(gulp, nonblocking=True))
        except BlockingIOError:
            _cancel_reservations(got)
            if self.on_overrun == "fail":
                raise OverrunError(
                    f"{self.name}: output ring full (downstream "
                    f"back-pressure) with on_overrun='fail'") from None
            c = self._shed_cache
            if c is None or c[1] != gulp or len(c[0]) != len(oseqs) or \
                    any(a is not b for a, b in zip(c[0], oseqs)):
                c = self._shed_cache = (list(oseqs), gulp,
                                        [_ShedSpan(o, gulp) for o in oseqs])
            return c[2], True
        except BaseException:
            _cancel_reservations(got)
            raise
        return got, False

    def _note_shed(self, nframe, flush=False):
        """Count shed frames; report them to the supervisor at most every
        0.25 s (and at the sequence's end)."""
        self.shed_frames += nframe
        self._shed_pending += nframe
        now = time.monotonic()
        if self._shed_pending and (flush or
                                   now - self._shed_flush_t > 0.25):
            sup = self._supervisor
            if sup is not None:
                sup.record_shed(self, self._shed_pending)
            self._shed_pending = 0
            self._shed_flush_t = now

    def _resolve_exec_async(self):
        """The async executor's depth for the next sequence, or 0 for the
        synchronous loop (bifrost_tpu/pipeline.py:1129-1146): only under
        the 'backpressure' policy (shedding must see the nonblocking
        reserve's outcome at once), only for a block that touches the
        card (eager staging overlaps a copy; a host-only source would
        only pay the hand-off), never under `strict_sync`."""
        from . import config
        depth = config.get("pipeline_async_depth")
        if depth <= 1 or self.on_overrun != "backpressure" or \
                _device.needs_strict_sync():
            return 0
        self._device_lock()          # resolves _touches_device
        return depth if self._touches_device else 0

    def _run_source_sequence(self, sourcename):
        self._loop_frame = 0
        self._loop_gulp = None
        with self.create_reader(sourcename) as reader:
            oheaders = self.on_sequence(reader, sourcename)
            for oh in oheaders:
                oh.setdefault("name", str(sourcename))
                oh.setdefault("time_tag", 0)
                oh.setdefault("gulp_nframe", self.gulp_nframe)
            self.sequence_proclog.update(
                {"header": json.dumps(oheaders[0])})
            gulp = self._loop_gulp = self.gulp_nframe
            # Latched for the sequence: a toggle mid-stream cannot move
            # later gulps onto the other loop.
            depth = self._exec_async_depth = self._resolve_exec_async()
            if depth:
                self._hold_flag_latch("pipeline_async_depth")
            buf_nframe = self.buffer_nframe or gulp * self.buffer_factor
            if depth:
                # The stager runs up to `depth` gulps ahead of the
                # worker's commits: that much more room, so the lookahead
                # does not eat the readers' share.
                buf_nframe += gulp * depth
            oseqs = [ring.begin_sequence(oh, gulp, buf_nframe)
                     for ring, oh in zip(self.orings, oheaders)]
            self.mark_initialized()
            try:
                if depth:
                    self._source_loop_async(reader, oseqs, gulp, depth)
                else:
                    self._source_loop_sync(reader, oseqs, gulp)
            finally:
                for oseq in oseqs:
                    oseq.end()
                self._release_flag_latches()
                self._note_shed(0, flush=True)
                self._flush_perf_proclog()

    def _source_loop_sync(self, reader, oseqs, gulp):
        while not (self.pipeline.shutdown_requested or
                   self.pipeline.quiesce_requested):
            self._heartbeat = time.monotonic()
            t0 = time.perf_counter()
            ospans, shed = self._reserve_or_shed(oseqs, gulp)
            try:
                t1 = time.perf_counter()
                with self._device_lock():
                    ostrides = self.on_data(reader, ospans)
                    if not shed:
                        self._sync_before_commit(ospans)
                t2 = time.perf_counter()
                done = False
                for ospan, n in zip(ospans, ostrides):
                    n = 0 if n is None else n
                    ospan.commit(n)
                    done = done or n < gulp
            except BaseException:
                if not shed:
                    _abandon_gulp(self, [], ospans)
                raise
            if shed:
                self._note_shed((ostrides[0] or 0) if ostrides else 0)
            t3 = time.perf_counter()
            self._perf_add(reserve=t1 - t0, process=t2 - t1,
                           commit=t3 - t2)
            self._loop_frame += gulp
            self._gulp_done(t3, {"reserve_time": t1 - t0,
                                 "process_time": t2 - t1,
                                 "commit_time": t3 - t2})
            if done:
                break

    def _source_loop_async(self, reader, oseqs, gulp, depth):
        """The eager-staging loop (`pipeline_async_depth` > 1;
        bifrost_tpu/pipeline.py:1251-1346).  The block thread reserves
        gulp N+1's spans and runs `on_data`, which for a 'cuda' ring is
        the staging copy onto the card, on the block's stream, while the
        worker commits gulp N, in order.  A host output ring is
        synchronised before its gulp goes to the worker.  Quiesce stops
        the loop at a gulp edge; the worker then retires what is queued.
        On a fault the worker finishes what it runs, and the gulps it did
        not commit are cancelled, newest first."""
        disp = self._executor(depth)
        outstanding = []             # (ispans, ospans), retired in order
        host = any(o.ring.space != "cuda" for o in oseqs)

        def abort():
            return self.pipeline.shutdown_requested
        drained = False
        try:
            while not (self.pipeline.shutdown_requested or
                       self.pipeline.quiesce_requested):
                self._heartbeat = time.monotonic()
                t0 = time.perf_counter()
                ospans, _ = self._reserve_or_shed(oseqs, gulp)
                t1 = time.perf_counter()
                rec = ([], list(ospans))
                outstanding.append(rec)
                with self._device_lock():
                    ostrides = self.on_data(reader, ospans)
                    if host:
                        _device.stream_synchronize(self.device)
                commit = [0 if n is None else n
                          for n in (ostrides or [0] * len(ospans))]
                done = any(n < gulp for n in commit)
                t2 = time.perf_counter()
                disp.submit(self._async_source_item(rec, commit,
                                                    outstanding),
                            abort=abort)
                t3 = time.perf_counter()
                # A full queue's wait is downstream back-pressure: booked
                # as 'reserve'; the worker books the commits.
                self._perf_add(reserve=(t1 - t0) + (t3 - t2),
                               process=t2 - t1)
                self._loop_frame += gulp
                self._gulp_done(t3, {"reserve_time": t1 - t0,
                                     "process_time": t2 - t1})
                if done:
                    break
            disp.drain()
            drained = True
        except BaseException:
            drained = disp.drain(raise_exc=False, clear_exc=True,
                                 timeout=5.0)
            raise
        finally:
            self._retire_outstanding(outstanding, drained)

    def _async_source_item(self, rec, commit, outstanding):
        """The worker's part of one staged source gulp: the in-order
        commits (their events recorded on the block's stream, after the
        staging copy), then the gulp leaves the teardown registry."""
        def item():
            self._heartbeat = time.monotonic()
            t0 = time.perf_counter()
            for ospan, n in zip(rec[1], commit):
                ospan.commit(n)
            if outstanding and outstanding[0] is rec:
                outstanding.pop(0)
            self._perf_add(commit=time.perf_counter() - t0)
        return item


class MultiTransformBlock(Block):
    """N input rings -> M output rings, the gulp hot loop
    (reference pipeline.py:523-694 — see SURVEY.md §3.3)."""

    # A block whose output frames are not proportional to its input
    # frames sizes a final partial gulp's reservation with
    # `define_output_nframes` rather than by scaling a full gulp's
    # (bifrost_tpu/pipeline.py:1753); an exact emit hook wins over both.
    exact_output_nframes = False

    def __init__(self, irings, guarantee=True, name=None, **kwargs):
        super().__init__(irings=irings, name=name, **kwargs)
        self.guarantee = guarantee
        nout = getattr(self, "noutputs", 1)
        self.orings = [self.create_ring(space=self._output_space())
                       for _ in range(nout)]

    # -- subclass interface
    def _on_sequence(self, iseqs):
        return self.on_sequence(iseqs)

    def _on_data(self, ispans, ospans):
        return self.on_data(ispans, ospans)

    def define_valid_input_spaces(self):
        """The spaces each input may live in ('any': every space)."""
        return ["any"] * len(self.irings)

    def define_input_overlap_nframe(self, iseqs):
        """Frames of overlap carried between gulps (FDMT/FIR state)."""
        return 0

    def define_output_nframes(self, input_nframe):
        """Output frames per input gulp for each output ring."""
        return [input_nframe] * len(self.orings)

    def on_sequence(self, iseqs):
        """-> list of output headers."""
        raise NotImplementedError

    def on_sequence_end(self, iseqs):
        pass

    def on_data(self, ispans, ospans):
        """Process one gulp; return list of frames written per output
        (None -> all)."""
        raise NotImplementedError

    def on_skip(self, islice, ospans):
        """Zero-fill outputs for skipped (overwritten) input frames."""
        for ospan in ospans:
            ospan.data.zero_()

    def _output_space(self):
        """Space for created output rings: input space by default."""
        return self.irings[0].space

    def _sink_gulp_sync(self):
        """A sink gulp synchronises before its spans go back where its
        reader needs it (bifrost_tpu/pipeline.py:1928-1944): a lossy
        reader checks for overwritten input only after its reads are done,
        and a host input ring has no release event to hold the writer off
        device work still reading it.  A guaranteed reader of a 'cuda'
        ring does not: the release event orders the writer."""
        if not self.guarantee:
            return True
        return getattr(self.irings[0], "space", None) != "cuda"

    def main(self):
        cursors, pending = self._adopted_handoff or (
            [iring.cursor(self.guarantee) for iring in self.irings],
            None)
        self._adopted_handoff = None
        self._began_writing = self._adopted_began_writing
        iseqs = None
        try:
            while True:
                if pending is not None:
                    iseqs, pending = pending, None
                else:
                    iseqs = [c.next() for c in cursors]
                if self.pipeline.shutdown_requested or self._splice_stop:
                    if self._splice_stop:
                        # Opened, not begun: the replacement begins it
                        # where this block would have.
                        self._splice_mid_sequence = True
                        self._loop_frame = self._splice_resume_frame or 0
                    break
                if not self._began_writing:
                    for oring in self.orings:
                        oring.begin_writing()
                    self._began_writing = True
                self._supervised_sequence(iseqs)
                if self._splice_stop:
                    break
        except StopIteration:
            pass
        finally:
            # The worker lets go of its spans before their sequences
            # close.
            self._close_dispatcher()
            if self._splice_stop and not self.pipeline.shutdown_requested:
                # A splice exit hands the read position on, guarantees
                # held: the cursors, and the input sequences where the
                # quiesce broke out of one.
                self._splice_handoff = (
                    cursors, iseqs if self._splice_mid_sequence else None)
            else:
                for c in cursors:
                    c.close()
            # A splice target leaves writing open: its replacement
            # adopts the rings and ends writing when it finishes.
            if self._began_writing and not self._splice_stop:
                for oring in self.orings:
                    oring.end_writing()

    def _supervised_sequence(self, iseqs):
        """One input sequence.  Under supervision a fault is absorbed per
        the restart policy: the output sequences end, `on_sequence` runs
        again and the loop resumes at the frame the supervisor chose.
        Unsupervised this is one `_run_sequence` call."""
        resume = 0
        if self._splice_resume_frame is not None:
            # A spliced-in replacement resumes its predecessor's sequence
            # where it stopped, as a supervised restart resumes its own.
            resume = self._splice_resume_frame
            self._splice_resume_frame = None
        self._supervised_region = True
        sup = self._supervisor
        if sup is not None:
            sup.absorb_stale_deadman(self)
        try:
            while True:
                try:
                    self._run_sequence(iseqs, resume)
                    return
                except (EndOfDataStop, StopIteration):
                    raise
                except BaseException as e:  # noqa: BLE001 — policy decides
                    if self._splice_stop:
                        # A splice quiesce interrupted this sequence: exit
                        # it, unrestarted, to be resumed by the
                        # replacement.
                        self._splice_mid_sequence = True
                        raise
                    resume = self._supervised_resume(e)
                    if resume is None:
                        raise
        finally:
            self._supervised_region = False

    def _run_sequence(self, iseqs, begin_nframe=0):
        self._loop_frame = begin_nframe
        self._loop_gulp = None
        self.sequence_proclog.update(
            {"header": json.dumps(iseqs[0].header)})
        oheaders = self._on_sequence(iseqs)
        for oh in oheaders:
            oh.setdefault("name", iseqs[0].header.get("name", ""))
            oh.setdefault("time_tag", iseqs[0].header.get("time_tag", 0))
        gulp = self.gulp_nframe or iseqs[0].header.get("gulp_nframe", 1)
        overlap = self.define_input_overlap_nframe(iseqs)
        onframes = self.define_output_nframes(gulp)
        # The executor, resolved and latched for the sequence: it carries
        # spans across gulps, so a toggle mid-sequence cannot apply.
        depth = self._exec_async_depth = self._resolve_exec_async(iseqs)
        if depth:
            self._hold_flag_latch("pipeline_async_depth")
        buf_factor = self.buffer_factor
        # An overlap reader's first acquire wants gulp + overlap committed
        # frames while the writer needs room for its next gulp: two
        # windows at least.
        in_buf_factor = max(buf_factor, 2) if overlap else buf_factor
        if depth:
            # The block thread acquires and reserves up to `depth` gulps
            # ahead of the worker's releases and commits: both rings get
            # that much more room.
            in_buf_factor = max(in_buf_factor, buf_factor + depth)
            buf_factor += depth
        for oh, onf in zip(oheaders, onframes):
            oh.setdefault("gulp_nframe", onf)
        for iseq in iseqs:
            # Sized from this reader's span plus overlap (bfRingResize):
            # the ghost covers the largest span, so a wrapped read stays
            # one view.  A restart finds the rings sized already.
            iseq.resize(gulp + overlap, (gulp + overlap) * in_buf_factor)
        oseqs = [oring.begin_sequence(oh, onframe, onframe * buf_factor)
                 for oring, oh, onframe in
                 zip(self.orings, oheaders, onframes)]
        self.mark_initialized()
        try:
            self._sequence_loop(iseqs, oseqs, gulp, overlap, onframes,
                                begin_nframe)
        finally:
            # Output sequences END even on a fault: downstream readers
            # must see end-of-sequence, never a dangling hang.
            self.on_sequence_end(iseqs)
            for oseq in oseqs:
                oseq.end()
            self._release_flag_latches()
            self._flush_perf_proclog()

    # FusedTransformBlock runs its own worker discipline: False there.
    _base_async_ok = True

    # The executor's reservation discipline (bifrost_tpu/pipeline.py:
    # 1579-1604).  True: the block thread reserves gulp N+1's output
    # spans while gulp N is in flight, which needs `on_data` to commit the
    # whole reservation of a whole gulp (a shrinking commit is legal only
    # for a ring's final reservation).  Blocks that emit on an
    # integration phase set it False, and the worker reserves, one open
    # reservation at a time; an exact `output_nframes_for_gulp` hook
    # restores the reserve-ahead (the worker's commit must then equal the
    # hook's count on every gulp).
    async_reserve_ahead = True

    def _resolve_exec_async(self, iseqs):
        """The executor's depth for this sequence, or 0 for the
        synchronous loop (bifrost_tpu/pipeline.py:1606-1635): only for a
        guaranteed reader (a lossy one checks for overwritten input right
        after its gulp), whose sequences can hold a manual guarantee, in a
        block that touches the card (a host-only block would only pay the
        hand-off), never under `strict_sync`."""
        from . import config
        depth = config.get("pipeline_async_depth")
        if depth <= 1 or not self._base_async_ok or not self.guarantee or \
                _device.needs_strict_sync():
            return 0
        if any(not hasattr(iseq, "set_guarantee_manual") for iseq in iseqs):
            return 0
        self._device_lock()          # resolves _touches_device
        return depth if self._touches_device else 0

    def _sequence_loop(self, iseqs, oseqs, gulp, overlap, onframes,
                       begin_nframe=0):
        self._loop_gulp = gulp
        if self._exec_async_depth:
            self._sequence_loop_async(iseqs, oseqs, gulp, overlap,
                                      onframes, begin_nframe)
            return
        span_gens = [iseq.read(gulp + overlap, gulp, begin_nframe)
                     for iseq in iseqs]
        # Exact-schedule phase emitters (guaranteed readers only: the
        # schedule is relative to sequence entry).
        emit_hook = getattr(self, "output_nframes_for_gulp", None) \
            if self.guarantee else None
        rel_frame = 0
        try:
            while True:
                self._heartbeat = time.monotonic()
                t_acq = time.perf_counter()
                ispans = []
                for g in span_gens:
                    try:
                        ispans.append(next(g))
                    except StopIteration:
                        return
                if self.pipeline.shutdown_requested or self._splice_stop:
                    self._splice_mid_sequence = self._splice_stop
                    return
                in_nframe = max(0, ispans[0].nframe - overlap)
                if in_nframe == 0:
                    return
                frac = in_nframe / gulp
                if emit_hook is not None:
                    out_nframes = [int(n) for n in
                                   emit_hook(rel_frame, in_nframe)]
                elif frac < 1 and self.exact_output_nframes:
                    out_nframes = self.define_output_nframes(in_nframe)
                else:
                    out_nframes = [max(1, int(round(onf * frac)))
                                   if frac < 1 else onf for onf in onframes]
                ospans = []
                t0 = time.perf_counter()
                try:
                    for oseq, onf in zip(oseqs, out_nframes):
                        ospans.append(oseq.reserve(onf))
                    t1 = time.perf_counter()
                    with self._device_lock():
                        ostrides = self._run_gulp(ispans, ospans,
                                                  out_nframes,
                                                  emit_hook is not None)
                    if not self.guarantee and any(
                            isp.nframe_overwritten > 0 for isp in ispans):
                        # Lossy catch-up: input overwritten while read.
                        self.on_skip(ispans, ospans)
                    t2 = time.perf_counter()
                    for ospan, n in zip(ospans, ostrides):
                        ospan.commit(n)
                except BaseException:
                    _abandon_gulp(self, ispans, ospans)
                    raise
                t3 = time.perf_counter()
                self._perf_add(acquire=t0 - t_acq, reserve=t1 - t0,
                               process=t2 - t1, commit=t3 - t2)
                rel_frame += gulp
                self._loop_frame += gulp
                self._gulp_done(t3, {"acquire_time": t0 - t_acq,
                                     "reserve_time": t1 - t0,
                                     "process_time": t2 - t1,
                                     "commit_time": t3 - t2})
                if ispans[0].nframe < gulp + overlap:
                    return   # partial gulp == sequence end
        finally:
            for g in span_gens:
                g.close()

    def _run_gulp(self, ispans, ospans, out_nframes, exact):
        """One gulp's `on_data` (`on_skip` over overwritten input) and the
        synchronisation its commit needs -> frames to commit per output.
        `exact`: the exact emit schedule's count must be what `on_data`
        committed."""
        if any(isp.nframe_skipped > 0 for isp in ispans):
            self.on_skip(ispans, ospans)
            ostrides = list(out_nframes)
        else:
            ostrides = self._on_data(list(ispans), ospans)
            if ostrides is None:
                ostrides = out_nframes
            ostrides = [o if o is not None else onf
                        for o, onf in zip(ostrides, out_nframes)]
            if exact and list(ostrides) != list(out_nframes):
                raise RuntimeError(
                    f"{self.name}: output_nframes_for_gulp promised "
                    f"{list(out_nframes)} output frame(s) but on_data "
                    f"committed {list(ostrides)}")
        self._sync_before_commit(ospans)
        return ostrides

    def _sequence_loop_async(self, iseqs, oseqs, gulp, overlap, onframes,
                             begin_nframe=0):
        """The double-buffered loop (`pipeline_async_depth` > 1;
        bifrost_tpu/pipeline.py:1664-1849).  The block thread acquires
        gulp N+1's input spans (and, with reserve-ahead, reserves its
        output spans) while up to `depth` gulps run on the worker, in
        order, on the block's CUDA stream: each item runs `on_data`, the
        synchronisation its commit needs, the commits and releases, and
        moves the input guarantee on by one gulp's stride (an overlap
        tail stays pinned).  Spans are acquired directly, not through the
        read generators, whose release on the next pull would free bytes
        the worker still reads; and the readers hold a manual guarantee,
        since an acquire ahead would otherwise let the writer reclaim
        them.

        A worker fault surfaces on the block thread at its next submit or
        drain: the gulps behind the faulted one are dropped and cancelled
        newest first, and a supervised restart resumes past the dispatch
        frontier (`_loop_frame`), so no frame is committed twice.  A ring
        wait's deadman or quiesce lands in the block thread's acquire or
        reserve as in the synchronous loop; a full queue's wait polls the
        pipeline's shutdown, so a wedged worker cannot make the block
        unkillable."""
        disp = self._executor(self._exec_async_depth)
        outstanding = []             # (ispans, ospans), retired in order
        for iseq in iseqs:
            iseq.set_guarantee_manual()

        def abort():
            return self.pipeline.shutdown_requested
        emit_hook = getattr(self, "output_nframes_for_gulp", None)
        reserve_ahead = self.async_reserve_ahead or emit_hook is not None
        frame = begin_nframe
        drained = False
        try:
            while True:
                self._heartbeat = time.monotonic()
                t_acq = time.perf_counter()
                ispans = []
                stop = False
                for iseq in iseqs:
                    try:
                        ispans.append(iseq.acquire(frame, gulp + overlap))
                    except EndOfDataStop:
                        stop = True
                        break
                in_nframe = max(0, ispans[0].nframe - overlap) \
                    if ispans and not stop else 0
                if in_nframe == 0 or self.pipeline.shutdown_requested or \
                        self._splice_stop:
                    if self._splice_stop and in_nframe:
                        # The replacement resumes at the dispatch
                        # frontier, once the drain below has committed
                        # every gulp dispatched before it.
                        self._splice_mid_sequence = True
                    for sp in ispans:
                        sp.release()
                    break
                t0 = time.perf_counter()
                frac = in_nframe / gulp
                if emit_hook is not None:
                    # Frames relative to this loop's entry: on_sequence
                    # has just reset the block's phase.
                    out_nframes = [int(n) for n in
                                   emit_hook(frame - begin_nframe,
                                             in_nframe)]
                elif frac < 1 and self.exact_output_nframes:
                    out_nframes = self.define_output_nframes(in_nframe)
                else:
                    out_nframes = [max(1, int(round(onf * frac)))
                                   if frac < 1 else onf for onf in onframes]
                ospans = []
                if reserve_ahead:
                    try:
                        for oseq, onf in zip(oseqs, out_nframes):
                            ospans.append(oseq.reserve(onf))
                    except BaseException:
                        # Each ring's newest reservations: cancellable
                        # without the in-order commit wait.
                        _cancel_reservations(ospans)
                        for sp in ispans:
                            sp.release()
                        raise
                rec = (ispans, ospans)
                outstanding.append(rec)
                partial = ispans[0].nframe < gulp + overlap
                t1 = time.perf_counter()
                disp.submit(self._async_gulp_item(
                    rec, out_nframes, outstanding, gulp,
                    None if reserve_ahead else oseqs, emit_hook is not None),
                    abort=abort)
                # A full queue's wait is downstream back-pressure, booked
                # as 'reserve'.
                self._perf_add(acquire=t0 - t_acq,
                               reserve=time.perf_counter() - t0)
                # The dispatch frontier: a worker fault resumes past it, a
                # deadman in this thread's wait resumes at it.
                self._loop_frame = frame + gulp
                if partial:
                    break
                frame += gulp
            disp.drain()
            drained = True
        except BaseException:
            drained = disp.drain(raise_exc=False, clear_exc=True,
                                 timeout=5.0)
            raise
        finally:
            self._retire_outstanding(outstanding, drained)
            for iseq in iseqs:
                iseq.set_guarantee_manual(False)

    def _async_gulp_item(self, rec, out_nframes, outstanding, gulp,
                         reserve_oseqs, exact):
        """The worker's part of one gulp: the output reservations where
        the block thread did not reserve ahead (`reserve_oseqs`), the
        gulp under the device scope, the in-order commits and releases,
        and the input guarantee moved on by one stride."""
        ispans, ospans = rec

        def item():
            self._heartbeat = time.monotonic()
            t0 = time.perf_counter()
            if reserve_oseqs is not None:
                # Into the shared record: a fault before the commit is
                # then cancelled by the teardown.
                for oseq, onf in zip(reserve_oseqs, out_nframes):
                    ospans.append(oseq.reserve(onf))
                self._perf_add(reserve=time.perf_counter() - t0)
            t1 = time.perf_counter()
            with self._device_lock():
                ostrides = self._run_gulp(ispans, ospans, out_nframes, exact)
            t2 = time.perf_counter()
            for ospan, n in zip(ospans, ostrides):
                ospan.commit(n)
            for sp in ispans:
                sp.release()
                if sp.rseq.guarantee:
                    sp.rseq.advance_guarantee(
                        sp.offset + min(gulp * sp.tensor.frame_nbyte,
                                        sp.nbyte))
            if outstanding and outstanding[0] is rec:
                outstanding.pop(0)
            t3 = time.perf_counter()
            self._perf_add(process=t2 - t1, commit=t3 - t2)
            self._gulp_done(t3, {"process_time": t2 - t1,
                                 "commit_time": t3 - t2})
        return item


class TransformBlock(MultiTransformBlock):
    """One input ring -> one output ring (reference pipeline.py:696-748).
    Subclasses define `on_sequence(iseq)` -> header and
    `on_data(ispan, ospan)`."""

    noutputs = 1

    def __init__(self, iring, *args, **kwargs):
        super().__init__([iring], *args, **kwargs)
        self.iring = self.irings[0]

    def _on_sequence(self, iseqs):
        oh = self.on_sequence(iseqs[0])
        return oh if isinstance(oh, list) else [oh]

    def on_sequence(self, iseq):
        raise NotImplementedError

    def _on_data(self, ispans, ospans):
        return [self.on_data(ispans[0], ospans[0])]

    def on_data(self, ispan, ospan):
        raise NotImplementedError


class SinkBlock(MultiTransformBlock):
    """One input ring, no outputs (reference pipeline.py:750-785).
    Subclasses define `on_sequence(iseq)` and `on_data(ispan)`."""

    noutputs = 0

    def __init__(self, iring, *args, **kwargs):
        super().__init__([iring], *args, **kwargs)
        self.iring = self.irings[0]

    def define_output_nframes(self, input_nframe):
        return []

    def _on_sequence(self, iseqs):
        self.on_sequence(iseqs[0])
        return []

    def on_sequence(self, iseq):
        raise NotImplementedError

    def _on_data(self, ispans, ospans):
        self.on_data(ispans[0])
        return []

    def on_data(self, ispan):
        raise NotImplementedError


class _GulpDispatcher(object):
    """One worker thread with a bounded in-order queue (counterpart of
    bifrost_tpu/pipeline.py:2456-2618).

    `submit(fn)` enqueues and returns once there is room; the worker runs
    the items strictly in submission order.  A worker exception surfaces
    on the submitting thread at the next `submit()` or `drain()`, and the
    items queued behind the failed one are dropped (they are tagged with
    an epoch that a fault bumps).  `on_worker_start` runs once on the
    worker before any item (to bind the pipeline's device); if it fails
    the dispatcher closes and every later submit raises.
    """

    DEPTH = 2

    def __init__(self, name, depth=None, on_worker_start=None):
        self.depth = int(depth) if depth else self.DEPTH
        self._cv = threading.Condition()
        self._queue = []          # [(epoch, fn)]
        self._busy = False
        self._exc = None
        self._epoch = 0
        self._closed = False
        self._on_worker_start = on_worker_start
        self._thread = threading.Thread(target=self._run, name=name[:15],
                                        daemon=True)
        self._thread.start()

    def inflight(self):
        """Items submitted but not yet finished (queued + running)."""
        with self._cv:
            return len(self._queue) + (1 if self._busy else 0)

    def _run(self):
        if self._on_worker_start is not None:
            try:
                self._on_worker_start()
            except Exception as e:  # noqa: BLE001 — surfaces at submit
                with self._cv:
                    if self._exc is None:
                        self._exc = e
                    self._epoch += 1
                    self._closed = True
                    del self._queue[:]
                    self._cv.notify_all()
                return
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed:
                    # Reached only after a drain that timed out: the
                    # pipeline is tearing down, so the rest is dropped.
                    del self._queue[:]
                    self._cv.notify_all()
                    return
                if self._exc is not None or self._queue[0][0] != self._epoch:
                    # Items queued behind a failed one must not run.
                    self._queue = [it for it in self._queue
                                   if it[0] == self._epoch]
                    self._cv.notify_all()
                    continue
                fn = self._queue.pop(0)[1]
                self._busy = True
            exc = None
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — surfaces on submit
                exc = e
            with self._cv:
                self._busy = False
                if exc is not None:
                    self._epoch += 1
                    if self._exc is None:
                        self._exc = exc
                self._cv.notify_all()

    def _raise_pending_locked(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def submit(self, fn, abort=None):
        """Enqueue `fn`; blocks while the queue is full.  `abort`
        (optional callable) is polled during that wait: when it returns
        True the submit gives up with RingInterrupted.  -> the epoch the
        item was queued in (it runs unless a failure moves the epoch on
        first)."""
        with self._cv:
            while len(self._queue) + (1 if self._busy else 0) >= self.depth:
                self._raise_pending_locked()
                if abort is not None and abort():
                    raise RingInterrupted(
                        "dispatch queue wait aborted (shutdown)")
                self._cv.wait(None if abort is None else 0.05)
            self._raise_pending_locked()
            if self._closed:
                raise RuntimeError("dispatcher closed")
            self._queue.append((self._epoch, fn))
            self._cv.notify_all()
            return self._epoch

    def drain(self, raise_exc=True, timeout=None, clear_exc=False):
        """Wait until every submitted item has finished; False if
        `timeout` (seconds) ran out first.  `clear_exc` drops a worker
        exception that is not raised (a restart already handles the
        fault that surfaced it)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._queue or self._busy:
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        if raise_exc:
                            self._raise_pending_locked()
                        return False
                    self._cv.wait(remaining)
                else:
                    self._cv.wait()
            if raise_exc:
                self._raise_pending_locked()
            elif clear_exc:
                self._exc = None
        return True

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5)


# -------------------------------------------------------------------- views
class RingView(object):
    """Zero-copy header-transform view over a ring (counterpart of
    bifrost_tpu/pipeline.py:2138-2169): readers see each sequence's
    header rewritten by `header_transform`; the bytes are the ring's."""

    def __init__(self, base_ring, header_transform):
        self._parent = base_ring if isinstance(base_ring, RingView) else None
        self.base_ring = getattr(base_ring, "base_ring", base_ring)
        self.header_transform = header_transform
        self.owner = getattr(base_ring, "owner", None)
        self.name = f"{self.base_ring.name}.view"

    @property
    def space(self):
        return self.base_ring.space

    def transform_header(self, header):
        """The header a reader of this view sees (parent views first)."""
        if self._parent is not None:
            header = self._parent.transform_header(header)
        hdr = json.loads(json.dumps(header))    # deep copy
        out = self.header_transform(hdr)
        return hdr if out is None else out

    def cursor(self, guarantee=True):
        """-> a `SequenceCursor` over the base ring showing each sequence
        through this view."""
        return SequenceCursor(
            self.base_ring, guarantee,
            wrap=lambda seq: SequenceView(seq,
                                          self.transform_header(seq.header)))

    def read(self, guarantee=True):
        return self.cursor(guarantee).sequences()


class SequenceView(ReadSequence):
    """A ReadSequence with a rewritten header (counterpart of
    bifrost_tpu/pipeline.py:2171-2242): frame-unit math follows the new
    header's tensor info; guarantees, open spans and closing are the base
    sequence's (byte offsets are the same under any view)."""

    def __init__(self, base, header):
        self.base = base
        self.ring = base.ring
        self._seq = base._seq
        self.guarantee = base.guarantee
        self.name = header.get("name", base.name)
        self.time_tag = header.get("time_tag", base.time_tag)
        self.begin = base.begin
        self.header = header
        self.tensor = TensorInfo(header) if "_tensor" in header else None

    @property
    def _closed(self):
        return self.base._closed

    @property
    def _open_spans(self):
        return self.base._open_spans

    def close(self):
        self.base.close()

    def _acquire(self, offset, size, nonblocking):
        return self.base._acquire(offset, size, nonblocking)

    def set_guarantee_manual(self, manual=True):
        self.base.set_guarantee_manual(manual)

    def advance_guarantee(self, offset):
        self.base.advance_guarantee(offset)


def block_view(block, header_transform):
    """Wrap a block so that its output rings present transformed headers
    (counterpart of bifrost_tpu/pipeline.py:2245-2251)."""
    proxy = _copy.copy(block)
    proxy.orings = [RingView(r, header_transform) for r in block.orings]
    return proxy


# ------------------------------------------------------- block-chain fusion
def _view_transforms(ring):
    """Header transforms of the RingView stack over `ring`, in the order
    they apply (the innermost view first)."""
    ts = []
    v = ring
    while isinstance(v, RingView):
        ts.append(v.header_transform)
        v = v._parent
    return list(reversed(ts))


class _HeaderSeq(object):
    """The sequence a constituent's `on_sequence` sees inside a fused
    group: a header and its tensor info."""

    def __init__(self, header):
        self.header = header
        self.tensor = TensorInfo(header) if "_tensor" in header else None


def _constituent_on_sequence(group, c, hdr):
    """Run constituent `c`'s `on_sequence` for the header flow; a fault
    names the constituent as well as the group."""
    try:
        oh = c.on_sequence(_HeaderSeq(hdr))
    except Exception as e:
        if getattr(e, "_bt_fused_constituent", None) is None:
            e._bt_fused_constituent = c.name
            if hasattr(e, "add_note"):
                e.add_note(f"[fused group {group.name}: fault in "
                           f"constituent {c.name}.on_sequence]")
        raise
    return oh[0] if isinstance(oh, (list, tuple)) else oh


def _reshape_frames(x, shape):
    """`x` reshaped to `shape`, a span shape with -1 at the frame axis:
    the physical side of the header views between two stages."""
    per = 1
    for n in shape:
        if n != -1:
            per *= n
    return x.reshape([x.numel() // per if n == -1 else n for n in shape])


class _GulpHold(object):
    """Holds an input span whose gulp runs on a group's worker
    (`ReadSpan.hold_until`): `synchronize()` returns once the worker has
    enqueued the gulp's work on the group's stream, which the span's
    release event then follows, after waiting for `event`, the copy of
    a pinned host span read in place, where the worker set one.  An item
    that never ran (not queued, or dropped behind a failed one) read
    nothing, and the hold lets go."""

    def __init__(self):
        self.event = None
        self._disp = None
        self._epoch = None
        self._done = threading.Event()

    def queued(self, disp, epoch):
        self._disp, self._epoch = disp, epoch

    def set(self):
        self._done.set()

    def synchronize(self):
        d = self._disp
        if d is None:
            return
        while not self._done.wait(0.05):
            if d._epoch != self._epoch or d._closed:
                return
        if self.event is not None:
            self.event.synchronize()


class FusedTransformBlock(TransformBlock):
    """A run of fuse-scoped device blocks executed as one block
    (counterpart of bifrost_tpu/pipeline.py:2624-3023): one thread, one
    CUDA stream, and no ring between its stages.

    Built by the fusion compiler (fuse.py) from fully constructed
    blocks: it adopts the first constituent's input ring and the last's
    output ring (the tail's, where an accumulate ends the run), runs
    each constituent's `on_sequence` for the header flow, applying the
    header views between stages, and per gulp calls the constituents'
    `device_kernel()` functions back to back.  Each stage gets what its
    ring read would have handed it: the stage before's output cast to
    its ring's storage type, contiguous, and reshaped by the views in
    between.  The JAX group compiles the chain into one XLA program;
    here the stages are the blocks' own eager calls, so a fused run
    launches the unfused run's kernels, one for one.

    Input spans: a span is a view of ring bytes the writer reuses.  A
    device span is read by work on the group's stream, which its release
    event follows; an H2D head that copies a pinned host span in place
    holds the span until the copy's event (`ReadSpan.hold_until`).

    Accumulate tail: the integration is carried by the group and folded
    frame by frame as `AccumulateBlock.fold` folds it.  Under
    `fused_async` (guaranteed readers) a gulp that completes no
    integration goes to the group's worker (`_GulpDispatcher`), which
    runs it on the group's stream while this thread goes on to the next
    gulp's ring work; its span is held until the worker has enqueued it
    (`_GulpHold`).  Gulps that emit drain the worker first.
    """

    # A short final gulp can still complete an integration of the tail
    # mid-gulp: its reservation comes from define_output_nframes.
    exact_output_nframes = True

    def __init__(self, constituents, pre_transforms, tail=None,
                 tail_transforms=None):
        first = constituents[0]
        last = tail if tail is not None else constituents[-1]
        # No super().__init__: the rings exist already, and the blocks
        # around the group hold references to them.
        self.pipeline = first.pipeline
        self.type = type(self).__name__
        self.name = "Fused_" + "+".join(
            c.name for c in list(constituents) + ([tail] if tail else []))
        self.error = None
        self._init_reported = False
        self._held_latches = []
        self.perf_totals = {}
        self._init_supervision_state()
        self.constituents = list(constituents)
        self._pre_transforms = list(pre_transforms)
        self.tail = tail
        self._tail_transforms = list(tail_transforms or [])
        self.irings = list(first.irings)
        self.iring = self.irings[0]
        self.orings = list(last.orings)
        self.guarantee = first.guarantee
        # Scope settings (gulp_nframe, buffers, device, fuse) resolve from
        # the first constituent's place in the scope tree.
        self._lookup = first._lookup
        self._async_latched = None
        self._init_proclogs()

    # The base blocks' executor loops would drive the group's worker a
    # second way: the group hands gulps to it itself (`fused_async`).
    _base_async_ok = False

    # ------------------------------------------------------- dispatching
    def _resolve_async(self):
        """The worker serves guaranteed readers only (a lossy reader
        checks for overwritten input right after on_data), and never
        under `strict_sync`."""
        from . import config
        return bool(self.guarantee and config.get("fused_async") and
                    not _device.needs_strict_sync())

    def _use_async(self):
        if self._async_latched is not None:
            return self._async_latched
        return self._resolve_async()

    def _device_lock(self):
        # With the worker on, its items take the dispatch lock: held here
        # around the hand-off, it would stall this thread behind the
        # worker's gulp and undo the overlap.
        if self._use_async():
            return contextlib.nullcontext()
        return super()._device_lock()

    def shutdown(self):
        self._close_dispatcher()

    def _drain_dispatcher(self, raise_exc=True):
        if self._dispatcher is not None:
            self._dispatcher.drain(raise_exc=raise_exc)

    def _sequence_loop(self, *args, **kwargs):
        # The worker must be idle before the sequence's output spans end.
        # On a fault it finishes what it runs, the items behind a failed
        # one are dropped (their spans' holds let go: they read nothing),
        # and the exception that surfaced the fault is not raised again
        # into a restarted sequence.
        try:
            super()._sequence_loop(*args, **kwargs)
        except BaseException:
            if self._dispatcher is not None:
                self._dispatcher.drain(raise_exc=False, clear_exc=True)
            raise
        self._drain_dispatcher()

    # ------------------------------------------------------- composition
    def on_sequence(self, iseq):
        from . import config
        from .blocks.copy import CopyBlock
        # In-flight work and the carried integration land before the
        # stages are rebuilt.
        self._drain_dispatcher()
        self._async_latched = self._resolve_async()
        depth = _GulpDispatcher.DEPTH
        if self._async_latched:
            depth = max(depth, config.get("pipeline_async_depth"))
            self._hold_flag_latch("fused_async")
            if depth > _GulpDispatcher.DEPTH:
                self._hold_flag_latch("pipeline_async_depth")
        if self._dispatcher is not None and self._dispatcher.depth != depth:
            self._close_dispatcher()
        self._async_depth = depth
        dev = torch.device(self.device)
        self._stream = torch.cuda.current_stream(dev) \
            if dev.type == "cuda" else None
        self._head = isinstance(self.constituents[0], CopyBlock)
        hdr = iseq.header
        self._shapes = []              # stage input span shapes (-1: frames)
        self._in_fax = []              # stage input frame axes
        self._in_dtypes = []           # stage input DataTypes
        self._out_torch = []           # stage output storage torch dtypes
        self._stage_out_frame_axes = []
        self._stage_pre_ratios = []    # per-stage view gulp ratios
        self._stage_gulp_ratios = []
        for i, (c, transforms) in enumerate(zip(self.constituents,
                                                self._pre_transforms)):
            pre = []
            for t in transforms:
                g0 = hdr.get("gulp_nframe")
                h = json.loads(json.dumps(hdr))
                hdr = t(h) or h
                g1 = hdr.get("gulp_nframe")
                if g0 and g1 and g0 != g1:
                    self._stage_gulp_ratios.append((g1, g0))
                    pre.append((g1, g0))
            self._stage_pre_ratios.append(pre)
            ti = TensorInfo(hdr)
            self._shapes.append(ti.span_shape(-1))
            self._in_fax.append(ti.frame_axis)
            self._in_dtypes.append(ti.dtype)
            hdr = _constituent_on_sequence(self, c, hdr)
            to = TensorInfo(hdr)
            self._out_torch.append(to.torch_dtype)
            self._stage_out_frame_axes.append(to.frame_axis)
        if self.tail is not None:
            for t in self._tail_transforms:
                h = json.loads(json.dumps(hdr))
                hdr = t(h) or h
            ti = TensorInfo(hdr)
            self._tail_frame_axis = ti.frame_axis
            self._tail_in_shape = ti.span_shape(-1)
            hdr = _constituent_on_sequence(self, self.tail, hdr)
            self._acc = None
            self._acc_phase = 0
        self._fns = self._build_stage_fns()
        self._nfr_cache = {}
        return hdr

    def _build_stage_fns(self):
        """The stages' functions: each constituent's `device_kernel()`,
        the H2D head's returning (tensor, hold event)."""
        return tuple(c.device_kernel() for c in self.constituents)

    def _release_flag_latches(self):
        # The constituents latched their flags under their own names in
        # their on_sequence; they release with the group's.
        super()._release_flag_latches()
        for c in self.constituents:
            c._release_flag_latches()
        if self.tail is not None:
            self.tail._release_flag_latches()

    def _chain_out_nframes(self, in_nframe):
        """Chain-output frames for an `in_nframe` input gulp (before any
        accumulate tail)."""
        n = in_nframe
        for g1, g0 in self._stage_gulp_ratios:
            n = n * g1 // g0
        for c in self.constituents:
            n = c.define_output_nframes(n)[0]
        return n

    def define_output_nframes(self, input_nframe):
        n = self._chain_out_nframes(input_nframe)
        if self.tail is not None:
            # The most integrations one gulp can complete.
            n = max(1, (n + self.tail.nframe - 1) // self.tail.nframe)
        return [n]

    # ------------------------------------------------------------ stages
    def _take(self, i, x):
        """Stage `i`'s input from the stage before's output: reshaped to
        the stage's input header, or None where it holds no frames (the
        unfused block would get no gulp)."""
        x = _reshape_frames(x, self._shapes[i])
        return None if x.shape[self._in_fax[i]] == 0 else x

    def _put(self, i, y):
        """Stage `i`'s output as its ring would store it: the ring's
        storage type, contiguous."""
        if y.dtype != self._out_torch[i]:
            y = y.to(self._out_torch[i])
        return y.contiguous()

    def _gulp_input(self, ispan, hold=None):
        """The chain's input for one gulp: the H2D head's device copy of
        the host span (its hold event on `hold`, or on the span), or the
        device span as its ring read presents it."""
        x = ispan.data
        if not self._head:
            return x
        y, ev = self._fns[0](x)
        if ev is not None:
            if hold is not None:
                hold.event = ev
            else:
                ispan.hold_until(ev)
        return self._put(0, y)

    def _plan_gulp(self, ispan):
        """-> (chain-output frames of this gulp, the chain's per-gulp
        arguments)."""
        nfr = self._nfr_cache.get(ispan.nframe)
        if nfr is None:
            nfr = self._nfr_cache[ispan.nframe] = \
                self._chain_out_nframes(ispan.nframe)
        return nfr, None

    def _run_chain(self, x, ctx):
        """The stages after the input, back to back -> the chain's
        output, or None where a stage got no frames."""
        for i in range(1 if self._head else 0, len(self._fns)):
            x = self._take(i, x)
            if x is None:
                return None
            x = self._put(i, self._fns[i](x))
        return x

    def _fold(self, y, phase, nfr, ospan):
        """Fold the chain's `nfr` output frames into the carried
        integration, frame by frame as the unfused tail does, and store
        the completed integrations -> their number."""
        if not nfr:
            return 0
        from .blocks._common import store
        y = _reshape_frames(y, self._tail_in_shape)
        fax, nacc = self._tail_frame_axis, self.tail.nframe
        outs, acc, cnt = [], self._acc, phase
        for i in range(nfr):
            acc = self.tail.fold(acc, y.narrow(fax, i, 1))
            cnt += 1
            if cnt == nacc:
                outs.append(acc)
                acc, cnt = None, 0
        self._acc = acc
        if outs:
            store(ospan, outs[0] if len(outs) == 1 else
                  torch.cat(outs, dim=fax))
        return len(outs)

    def on_data(self, ispan, ospan):
        from .blocks._common import store
        nfr, ctx = self._plan_gulp(ispan)
        if self.tail is None:
            y = self._run_chain(self._gulp_input(ispan), ctx)
            if nfr:
                store(ospan, y)
            return nfr
        nacc = self.tail.nframe
        phase = self._acc_phase
        self._acc_phase = (phase + nfr) % nacc
        if self._use_async() and 0 < nfr and phase + nfr <= nacc:
            # No integration boundary inside this gulp: the worker runs
            # it.  It alone touches the carried integration and carries
            # until the next drain.
            emit = phase + nfr == nacc
            hold = _GulpHold()
            ispan.hold_until(hold)

            def work():
                try:
                    with _device.dispatch_lock():
                        y = self._run_chain(self._gulp_input(ispan, hold),
                                            ctx)
                        self._fold(y, phase, nfr, ospan)
                finally:
                    hold.set()

            if self._dispatcher is None:
                self._dispatcher = _GulpDispatcher(
                    f"{self.name}.disp", depth=self._async_depth,
                    on_worker_start=self._bind_worker_thread)
            hold.queued(self._dispatcher, self._dispatcher.submit(
                work, abort=lambda: self.pipeline.shutdown_requested))
            if emit:
                # The loop commits the output span when this returns.
                self._dispatcher.drain()
                return 1
            return 0
        self._drain_dispatcher()
        y = self._run_chain(self._gulp_input(ispan), ctx)
        return self._fold(y, phase, nfr, ospan)


class MeshFusedBlock(TransformBlock):
    """A mesh-dispatched compute block and its accumulate tail run as one
    deferred-reduction group (counterpart of bifrost_tpu/pipeline.py:
    3026-3170).

    Built by the fusion compiler's `mesh_chain` rule (fuse.py) from fully
    constructed blocks: it adopts the head's input ring and the tail's
    output ring and runs the head's `mesh_chain_plan()` across the whole
    fused window: one collective-free sharded step per gulp, per-shard
    partials carried across every gulp and the constituent boundary, and
    one psum at each emit (the head's integration length times the
    tail's depth, in input frames).  The per-block chain pays a psum a
    gulp and the tail's adds; the group pays one psum an emitted frame,
    and its stream is bitwise the chain's where the data are integer
    valued (the sums are exact in any order).

    Every sharded dispatch runs through this block's own `mesh_dispatch`,
    so the collective watchdog, the realign and the fault seams guard the
    group as one unit: a shard fault sheds the carried partial through
    the supervised restart, and the group resumes on the effective mesh.
    A FaultPlan armed on the group must attach after fusion: call
    `pipe._fuse_device_chains()` (idempotent) before `plan.attach(pipe)`.
    """

    # The exact emit schedule (the correlate/accumulate contract): zero-
    # frame reservations on gulps that emit nothing.
    async_reserve_ahead = False
    # The group runs its gulps itself: no base executor loop.
    _base_async_ok = False

    def output_nframes_for_gulp(self, rel_frame0, in_nframe):
        n = self._nacc_in
        return [(rel_frame0 + in_nframe) // n - rel_frame0 // n]

    def __init__(self, head, tail, tail_transforms):
        # No super().__init__: the rings exist already and the blocks
        # around the group hold references to them.
        self.pipeline = head.pipeline
        self.type = type(self).__name__
        self.name = f"MeshFused_{head.name}+{tail.name}"
        self.error = None
        self._init_reported = False
        self._held_latches = []
        self.perf_totals = {}
        self._init_supervision_state()
        self.head = head
        self.tail = tail
        self._tail_transforms = list(tail_transforms or [])
        self.irings = list(head.irings)
        self.iring = self.irings[0]
        self.orings = list(tail.orings)
        self.guarantee = head.guarantee
        # Scope settings (gulp, device, mesh, shard, fuse) resolve from
        # the head's place in the scope tree.
        self._lookup = head._lookup
        self._plan = None
        self.nframe_integrated = 0
        self._init_proclogs()

    fusion_rule = "mesh_chain"

    @property
    def constituent_names(self):
        """The names of the blocks the group absorbed."""
        return [self.head.name, self.tail.name]

    def define_output_nframes(self, input_nframe):
        return [1]

    def on_sequence(self, iseq):
        # Header flow: head -> the views between -> tail, as the unfused
        # chain composes it (the head's on_sequence also resolves its
        # axis roles, checks the gulp and stages its weights).
        hdr = _constituent_on_sequence(self, self.head, iseq.header)
        for t in self._tail_transforms:
            h = json.loads(json.dumps(hdr))
            hdr = t(h) or h
        hdr = _constituent_on_sequence(self, self.tail, hdr)
        self._nacc_in = self.head.nframe_per_integration * self.tail.nframe
        self.nframe_integrated = 0
        self._plan = self.head.mesh_chain_plan()
        # The head latched its flags under its own name; the group holds
        # the deferral flag for its sequence too.
        self._hold_flag_latch("mesh_defer_reduce")
        return hdr

    def _release_flag_latches(self):
        # The constituents latched flags in their on_sequence calls.
        super()._release_flag_latches()
        self.head._release_flag_latches()
        self.tail._release_flag_latches()

    def on_data(self, ispan, ospan):
        from .blocks._common import store
        x, raw = self.head._read(ispan)
        self._plan.step(self, x, raw)
        self.nframe_integrated += ispan.nframe
        if self.nframe_integrated >= self._nacc_in:
            store(ospan, self._plan.emit(self))
            self.nframe_integrated = 0
            return 1
        return 0

    def on_sequence_end(self, iseqs):
        # A trailing partial window has no output slot: dropped, and said.
        if self.nframe_integrated:
            warnings.warn(
                f"{self.name}: dropping a trailing partial fused "
                f"integration ({self.nframe_integrated}/{self._nacc_in} "
                f"frames) at sequence end", stacklevel=1)
            self.nframe_integrated = 0
            self._plan.reset()
