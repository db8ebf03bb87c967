"""Egress plane: staged device->host copies feeding sinks (counterpart of
bifrost_tpu/egress.py).

- `EgressStager`: a per-sink staging engine.  `stage()` issues a gulp's
  copy to the host on a side CUDA stream, into a buffer of a small pool
  of pinned host buffers, and hands the gulp to a bounded in-order
  worker (`pipeline._GulpDispatcher`) that waits for the copy and hands
  back an `EgressTicket`.  The consumer drains gulp N while gulp N+1's
  copy runs.  A pooled gulp is one copy; a gulp bound for a sink's own
  destination is copied in frame-aligned chunks (`egress_chunk_nbyte`)
  that the worker hands on as each lands.
- `DeviceSinkBlock`: the sink base class over the stager.  Subclasses
  implement `on_sink_sequence(iseq)`, `on_sink_data(arr, frame_offset)`
  (`arr`: a host numpy array in the header's logical axis order, valid
  for the call only) and optionally `on_sink_sequence_end(iseq)` and the
  destination protocol `open_dest(nbyte, nframe, frame_offset)` -> an
  `EgressDest`.  Staging engages per sequence when the `egress_staging`
  flag is on, `strict_sync` is off and the input ring is in the 'cuda'
  space; anything else
  takes the blocking path, one whole-gulp copy on the block thread,
  byte-identical to the staged one.
- `_materialize` and `_start_transfer`: the module-level seams every
  copy goes through (rebindable, so a test or benchmark can slow, fail
  or time them on both sides of a comparison).

Span lifetime.  A span is a view of ring bytes that the writer reuses
once the span is released (ring.py), unlike the immutable `jax.Array`
the JAX stager holds.  So `stage()`, on the block thread, orders the
copy stream after the block stream (which waited for the span's commit
events in `ReadSpan.data`), issues the gulp's copies, records an event
after them and makes the block stream wait on it.  The release event the
ring records on the block stream when the span is released therefore
follows the copies, and the writer's stream waits on that before it
writes the bytes again: no host wait on the block thread.  On a CPU
pipeline a gulp is copied when it is staged.  A pooled buffer goes back
to the pool only after the consumer has drained its gulp.

Logical form: complex integers (ci8 and wider) reach `on_sink_data` as
complex64, as the JAX plane hands them; on the card the lift runs on the
device before the copy.  A host ('system') ring hands over its span as a
zero-copy numpy view (complex integers as the structured (re, im) array,
the JAX package's host form).

Wire order.  A sink whose transport is one byte stream
(`DeviceSinkBlock.wire_frame_major`: shm, DADA) receives a stream with
ringlets (frame axis not first) frame by frame, in time order: the gulp is
moved to frame-major on the card before its copy (on the host on the
blocking path), so the bytes on the wire do not depend on the gulp sizes,
and the sink's header says so (`DeviceSinkBlock.wire_header`: the
`_tensor` with its frame axis first, `ring.frame_major_header`).

Staging buffers on a CUDA pipeline are pinned (`torch.empty(...,
pin_memory=True)`): a failure to pin raises, there is no fallback to
pageable memory.  A staging fault surfaces on the block thread at the
next in-order handoff and fails the run (or, supervised, restarts the
sink); the gulps staged before it are still emitted at the sequence-end
drain.  The fault-injection sites `egress.stage` / `egress.drain`
(faultinject.py) fire on the sink's thread just before a gulp is handed
to / retired from the stager, and the stager's counters go to the
`<sink>/egress` ProcLog at each sequence end.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time

import numpy as np
import torch

from . import config
from . import device as _device
from .ndarray import complex_view
from .pipeline import SinkBlock, _GulpDispatcher
from .proclog import ProcLog
from .ring import RingInterrupted, TensorInfo, frame_major_header

__all__ = ["EgressStager", "EgressTicket", "EgressDest", "DeviceSinkBlock"]


class _Landing(object):
    """A chunk whose copy to the host was started: it lands in `host` (a
    flat uint8 CPU tensor) once `event` has completed (None: landed)."""

    __slots__ = ("host", "event")

    def __init__(self, host, event):
        self.host = host
        self.event = event


def _typed(dst_bytes, src):
    """The flat byte tensor `dst_bytes` seen as `src`'s dtype and shape."""
    return dst_bytes.view(src.dtype).view(src.shape)


def _default_start_transfer(dst_bytes, src):
    """Start one chunk's copy into `dst_bytes` (a flat uint8 CPU tensor)
    without waiting for it: for a CUDA `src` an asynchronous copy on the
    current stream into pinned memory with an event recorded after it;
    for a CPU `src` the copy itself.  -> the `_Landing` that
    `_materialize` completes."""
    if src.is_cuda:
        _typed(dst_bytes, src).copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Landing(dst_bytes, event)
    _typed(dst_bytes, src).copy_(src)
    return _Landing(dst_bytes, None)


def _default_materialize(dst_bytes, src):
    """Land one chunk in a host destination (`dst_bytes`: a writable flat
    uint8 CPU tensor).  `src` is a `_Landing` (the staged path: wait for
    its copy, then copy on if it landed elsewhere) or a tensor (the
    blocking path: one synchronous copy)."""
    if isinstance(src, _Landing):
        if src.event is not None:
            src.event.synchronize()
        if src.host.data_ptr() != dst_bytes.data_ptr():
            dst_bytes.copy_(src.host)
        return
    _typed(dst_bytes, src).copy_(src)


# The active seams (rebindable; every staged and blocking copy goes
# through them).
_materialize = _default_materialize
_start_transfer = _default_start_transfer


def _chunk_frames(nframe, frame_nbyte, chunk_nbyte):
    """Frames per staging chunk for a gulp of `nframe` frames of
    `frame_nbyte` host bytes each; 0 (or a chunk larger than the gulp)
    stages the gulp whole."""
    if chunk_nbyte <= 0 or nframe <= 1:
        return max(1, nframe)
    return min(nframe, max(1, int(chunk_nbyte) // max(1, int(frame_nbyte))))


def _logical(data, tensor):
    """A span's storage tensor in logical form: complex integers of 8
    bits or more lift to complex64 (a new tensor), the rest is `data`."""
    dt = tensor.dtype
    if dt.is_complex and dt.is_integer and dt.nbit >= 8:
        return complex_view(data, dt)
    return data


def _host_bytes(buf):
    """A destination buffer (numpy or a CPU tensor) as a flat uint8 CPU
    tensor over the same memory."""
    if isinstance(buf, torch.Tensor):
        return buf.reshape(-1).view(torch.uint8)
    return torch.from_numpy(np.asarray(buf).reshape(-1).view(np.uint8))


def _alloc_staging_buffer(nbyte, pin):
    """One host staging buffer: pinned on a CUDA pipeline (a failure to
    pin raises), plain host memory on a CPU one."""
    return torch.empty(int(nbyte), dtype=torch.uint8, pin_memory=bool(pin))


class _StagingPool(object):
    """Reusable host staging buffers, recycled by exact byte size.

    Steady streaming cycles through at most depth+1 buffers of one size;
    a new size (a partial final gulp) allocates once, and at most
    MAX_SIZES sizes are kept, the least recently used dropped first.
    `allocated` counts lifetime allocations.  Safe across threads.

    This is also the protocol of a pool handed in from outside
    (`EgressStager(pool=...)`, a fleet tenant's view of the fleet pool,
    fleet.py): `acquire(nbyte)`, `release(buf)` and an `allocated`
    lifetime counter, safe under concurrent stagers.  A pool knows
    whether its buffers are pinned: a CUDA stager's private pool pins,
    and a fleet pins where its tenants run on the card."""

    MAX_SIZES = 2

    def __init__(self, max_free=4, pin=False):
        self.max_free = int(max_free)
        self.pin = bool(pin)
        self._free = {}       # nbyte -> [buffers], least recently used first
        self._lock = threading.Lock()
        self.allocated = 0

    def acquire(self, nbyte):
        nbyte = int(nbyte)
        with self._lock:
            free = self._free.pop(nbyte, None)
            if free is not None:
                self._free[nbyte] = free     # most recent
                if free:
                    return free.pop()
            self.allocated += 1
        return _alloc_staging_buffer(nbyte, self.pin)

    def release(self, buf):
        if buf is None:
            return
        with self._lock:
            k = int(buf.nbytes)
            free = self._free.pop(k, [])
            self._free[k] = free
            if len(free) < self.max_free:
                free.append(buf)
            while len(self._free) > self.MAX_SIZES:
                self._free.pop(next(iter(self._free)))


class EgressDest(object):
    """Destination protocol for staged gulps (bifrost_tpu/egress.py:213).

    A `DeviceSinkBlock` subclass returns one from `open_dest()` (called
    on the block thread, in gulp order) to have the stager land bytes in
    its own transport.  The worker then calls, in order, per chunk:
    `chunk_view(nbyte)` (a writable flat byte view of exactly `nbyte`
    destination bytes, numpy or a CPU tensor, or None; may block on the
    destination's back-pressure), then `advance(nbyte)` once the chunk
    landed in it, or, when there was no view, `write(flat_u8)` (may
    block); and `commit()` once after the gulp's last chunk."""

    def chunk_view(self, nbyte):
        return None

    def advance(self, nbyte):
        pass

    def write(self, flat_u8):
        raise NotImplementedError

    def commit(self):
        pass


class EgressTicket(object):
    """One staged gulp in flight: the in-order handoff token between the
    stager's worker and the consumer."""

    __slots__ = ("nframe", "frame_offset", "nbyte", "dest", "array",
                 "_pool_buf", "_event", "exc")

    def __init__(self, nframe, frame_offset, nbyte, dest=None):
        self.nframe = nframe
        self.frame_offset = frame_offset
        self.nbyte = nbyte
        self.dest = dest
        self.array = None        # the pooled logical view (dest is None)
        self._pool_buf = None
        self._event = threading.Event()
        self.exc = None

    @property
    def ready(self):
        return self._event.is_set()

    def wait(self, abort=None):
        """Block until this gulp is staged; re-raise its fault.  `abort`
        (optional callable) is polled so that a consumer waiting behind a
        stalled worker still honours a pipeline shutdown."""
        while not self._event.wait(0.05):
            if abort is not None and abort():
                raise RingInterrupted(
                    "egress handoff wait aborted (shutdown)")
        if self.exc is not None:
            raise self.exc


class EgressStager(object):
    """Bounded in-order device->host staging engine for one sink.

    `stage()` issues one gulp's copies and returns an `EgressTicket`
    at once; it blocks while `depth` gulps are already in flight, which
    is egress back-pressure (`DeviceSinkBlock` books it as the sink's
    'reserve' phase).  `device` is the pipeline's device: on a CUDA
    device the copies run on a stream of the stager's own and the pool
    pins its buffers.  `pool`: a staging pool owned outside (the
    `_StagingPool` protocol; a fleet scheduler hands each tenant's sinks
    a quota-accounted view of the fleet's pool), else a private one."""

    def __init__(self, name, depth=2, chunk_nbyte=None,
                 on_worker_start=None, device="cpu", pool=None):
        self.name = name
        self.depth = max(2, int(depth))
        # The chunk size of a gulp bound for a destination; a sink sets
        # it anew each sequence.
        self.chunk_nbyte = int(config.get("egress_chunk_nbyte")
                               if chunk_nbyte is None else chunk_nbyte)
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.pool = pool if pool is not None \
            else _StagingPool(max_free=self.depth + 1, pin=cuda)
        self.staged_gulps = 0
        self.staged_bytes = 0
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._disp = _GulpDispatcher(f"{name[:11]}.egr", depth=self.depth,
                                     on_worker_start=on_worker_start)

    def stage(self, data, tensor, nframe, frame_offset, dest=None,
              abort=None):
        """Submit one gulp; -> EgressTicket.

        `data` is the span's tensor (storage form, from `ReadSpan.data`
        on the calling thread, whose stream already waits for the span's
        commits), `tensor` its ring.TensorInfo.  With `dest` None the
        gulp lands in a pooled buffer, one copy, shown as `ticket.array`;
        with an `EgressDest` the worker hands it to the destination chunk
        by chunk (`chunk_nbyte`) and commits."""
        nbyte = tensor.host_span_nbyte(nframe)
        ticket = EgressTicket(nframe, frame_offset, nbyte, dest)
        ticket._pool_buf = self.pool.acquire(nbyte)
        if dest is None:
            ticket.array = tensor.host_span_view(ticket._pool_buf, nframe)
        src = _logical(data, tensor)
        fax = tensor.frame_axis
        frame_nbyte = nbyte // max(1, nframe)
        # A pooled gulp is one copy: the consumer sees nothing before its
        # last byte has landed.  A destination takes chunks as they land.
        # Frame-axis chunks land at byte ranges [f0, f1) * frame_nbyte:
        # right only when the frame axis is outermost, so a stream with
        # ringlets stages whole gulps.
        step = (_chunk_frames(nframe, frame_nbyte, self.chunk_nbyte)
                if dest is not None and fax == 0 else max(1, nframe))
        cuda = src.is_cuda
        if cuda:
            block_stream = torch.cuda.current_stream(src.device)
            self._stream.wait_stream(block_stream)
        chunks = []
        with (torch.cuda.stream(self._stream) if cuda
              else contextlib.nullcontext()):
            for f0 in range(0, nframe, step):
                f1 = min(nframe, f0 + step)
                chunk = src if (f0 == 0 and f1 >= nframe) \
                    else src.narrow(fax, f0, f1 - f0)
                part = ticket._pool_buf[f0 * frame_nbyte:f1 * frame_nbyte]
                chunks.append((f0, f1, _start_transfer(part, chunk)))
            if cuda:
                copied = torch.cuda.Event()
                copied.record()
        if cuda:
            # The copies read `src` on the stager stream: a lifted or
            # moved copy is kept until they are done.
            src.record_stream(self._stream)
            # The span's release event, recorded on the block stream,
            # then follows the copies: the writer cannot reuse the bytes
            # before they have left.
            block_stream.wait_event(copied)

        def item():
            try:
                self._stage_one(ticket, chunks, frame_nbyte)
            except BaseException as e:   # noqa: BLE001 — re-raised at handoff
                ticket.exc = e
                raise
            finally:
                ticket._event.set()
        try:
            self._disp.submit(item, abort=abort)
        except BaseException:
            # Refused (an earlier worker fault, closed, or shutdown): the
            # item never runs.  Resolve the ticket so that no drain hangs
            # on it, and hand its buffer back once its copies are done.
            ticket.exc = ticket.exc or RuntimeError(
                f"{self.name}: gulp at frame {frame_offset} was never "
                "staged (stager refused the submission)")
            ticket._event.set()
            self.sync()
            self.release(ticket)
            raise
        self.staged_gulps += 1
        self.staged_bytes += nbyte
        return ticket

    def _stage_one(self, ticket, chunks, frame_nbyte):
        """Worker body: land the gulp's chunks in frame order (wait for
        their copies; for a destination, hand each chunk on)."""
        dest = ticket.dest
        if dest is None:
            flat = ticket._pool_buf
            for f0, f1, chunk in chunks:
                _materialize(flat[f0 * frame_nbyte:f1 * frame_nbyte], chunk)
            return
        for f0, f1, chunk in chunks:
            nb = (f1 - f0) * frame_nbyte
            view = dest.chunk_view(nb)
            if view is not None:
                _materialize(_host_bytes(view), chunk)
                dest.advance(nb)
                continue
            part = ticket._pool_buf[f0 * frame_nbyte:f1 * frame_nbyte]
            _materialize(part, chunk)
            dest.write(part.numpy())
        dest.commit()

    def inflight(self):
        """Gulps submitted but not yet fully staged (queued and running)."""
        return self._disp.inflight()

    def release(self, ticket):
        """Return a drained ticket's staging buffer to the pool."""
        self.pool.release(ticket._pool_buf)
        ticket._pool_buf = None
        ticket.array = None

    def drain(self, raise_exc=True, timeout=None):
        """Wait until every submitted gulp is staged; a worker's fault is
        raised here when `raise_exc`."""
        return self._disp.drain(raise_exc=raise_exc, timeout=timeout)

    def sync(self):
        """Wait until every copy issued so far has landed (before a
        buffer whose gulp was never drained goes back to the pool)."""
        if self._stream is not None:
            self._stream.synchronize()

    def close(self):
        self._disp.drain(raise_exc=False, timeout=5)
        self._disp.close()


class DeviceSinkBlock(SinkBlock):
    """Sink base class over the egress plane (bifrost_tpu/egress.py:456).

    Subclass interface (this class implements the SinkBlock hooks):
    `on_sink_sequence(iseq)`; `on_sink_data(arr, frame_offset)`, one
    staged gulp as a host numpy array in the header's logical axis
    order, valid for the call only; `on_sink_sequence_end(iseq)`
    (optional); `open_dest(nbyte, nframe, frame_offset)` (optional: an
    `EgressDest` to land the gulp in, in which case `on_sink_data` is not
    called for it, or None for the pooled path).

    Staging engages per sequence when `egress_staging` is on,
    `strict_sync` off and the input ring in the 'cuda' space, with depth
    max(2, `pipeline_async_depth`) and a destination's chunks of
    `egress_chunk_nbyte`; the three flags are latched for the sequence.
    Otherwise the gulp is copied whole on the block thread.  Subclasses
    that override `shutdown()` call `super().shutdown()`.  `egress_pool`
    (None: a private pool), set before the sequence opens (a fleet
    scheduler sets it at admission), is the pool the stager draws its
    buffers from.  `wire_frame_major` (class attribute): hand a stream
    with ringlets on frame-major, and describe it so in `wire_header`
    (module docstring, wire order).
    """

    wire_frame_major = False

    def wire_header(self, header):
        """The sequence header as the sink puts it on its wire: with
        `wire_frame_major` and ringlets, the `_tensor` with its frame axis
        first, as the bytes are sent; else `header` itself."""
        if self.wire_frame_major and TensorInfo(header).frame_axis > 0:
            return frame_major_header(header)
        return header

    def __init__(self, iring, *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        self._egress = None
        self._egress_pending = []     # staged, not yet drained, in order
        self._egress_staging = False
        self._egress_drained_gulps = 0
        self._egress_fault_hook = None   # fault injection (faultinject.py)
        self.egress_pool = None
        self.egress_proclog = ProcLog(f"{self.log_name}/egress")

    # -- subclass interface
    def on_sink_sequence(self, iseq):
        raise NotImplementedError

    def on_sink_data(self, arr, frame_offset):
        raise NotImplementedError

    def on_sink_sequence_end(self, iseq):
        pass

    def open_dest(self, nbyte, nframe, frame_offset):
        """A destination for one gulp, or None (pooled path).  Called on
        the block thread in gulp order."""
        return None

    # -- egress plumbing
    def _resolve_egress(self, iseq):
        # strict_sync leaves nothing in flight: the blocking copy.
        if not bool(config.get("egress_staging")) or \
                _device.needs_strict_sync():
            return False
        return self.iring.space == "cuda"

    def _bind_worker(self):
        # The stager's worker counts as one of the sink's threads.
        self._thread_idents.add(threading.get_ident())
        _device.set_device(self.device)

    def on_sequence(self, iseq):
        # A previous sequence's end drained its tickets: anything left is
        # dropped here, not emitted into the new sequence.
        self._flush_egress(emit=False, raise_exc=False)
        staging = self._resolve_egress(iseq)
        if staging:
            depth = max(2, int(config.get("pipeline_async_depth")))
            chunk_nbyte = int(config.get("egress_chunk_nbyte"))
            for flag in ("egress_staging", "pipeline_async_depth",
                         "egress_chunk_nbyte"):
                self._hold_flag_latch(flag)
            if self._egress is not None and self._egress.depth != depth:
                self._egress.close()
                self._egress = None
            if self._egress is None:
                self._egress = EgressStager(
                    self.name, depth=depth, device=self.device,
                    pool=self.egress_pool,
                    on_worker_start=self._bind_worker)
            self._egress.chunk_nbyte = chunk_nbyte
        self._egress_staging = staging
        self.on_sink_sequence(iseq)

    def on_data(self, ispan):
        tensor, nframe = ispan.tensor, ispan.nframe
        moved = self.wire_frame_major and tensor.frame_axis > 0
        if not self._egress_staging:
            arr = _blocking_materialize(ispan)
            if moved:
                arr = np.ascontiguousarray(
                    np.moveaxis(arr, tensor.frame_axis, 0))
            self.on_sink_data(arr, ispan.frame_offset)
            return
        hook = self._egress_fault_hook
        if hook is not None:
            hook("egress.stage", self)
        data = ispan.data
        if moved:
            data = data.movedim(tensor.frame_axis, 0).contiguous()
            tensor = tensor.frame_major()
        t0 = time.perf_counter()
        dest = self.open_dest(tensor.host_span_nbyte(nframe), nframe,
                              ispan.frame_offset)
        ticket = self._egress.stage(
            data, tensor, nframe, ispan.frame_offset, dest=dest,
            abort=lambda: self.pipeline.shutdown_requested)
        waited = time.perf_counter() - t0
        # Waiting for a destination or a stager slot is back-pressure:
        # booked as 'reserve', out of 'process'.
        self._perf_add(reserve=waited, process=-waited)
        self._egress_pending.append(ticket)
        # Retire what is staged; block on the oldest once the stager's
        # depth is in use (gulp N-1 drains while gulp N stages).
        while self._egress_pending and (
                len(self._egress_pending) >= self._egress.depth or
                self._egress_pending[0].ready):
            self._drain_one_egress()

    def _drain_one_egress(self):
        hook = self._egress_fault_hook
        if hook is not None:
            hook("egress.drain", self)
        ticket = self._egress_pending[0]
        ticket.wait(abort=lambda: self.pipeline.shutdown_requested)
        self._egress_pending.pop(0)
        try:
            if ticket.dest is None:
                self.on_sink_data(ticket.array, ticket.frame_offset)
        finally:
            self._egress.release(ticket)
        self._egress_drained_gulps += 1

    def _flush_egress(self, emit=True, raise_exc=True):
        """Retire every pending gulp in order.  `emit` hands each staged
        gulp to the sink until one faulted, which stops the emission (the
        output stays a prefix of the stream) and is re-raised unless
        `raise_exc` is False; the rest are released unemitted."""
        exc = None
        while self._egress_pending:
            if emit and exc is None:
                try:
                    self._drain_one_egress()
                    continue
                except BaseException as e:   # noqa: BLE001
                    exc = e
                    continue
            ticket = self._egress_pending.pop(0)
            if self._egress is not None:
                self._egress.sync()
                self._egress.release(ticket)
        if exc is not None and raise_exc:
            raise exc

    def on_sequence_end(self, iseqs):
        # Drain before the subclass closes its files.  While an exception
        # propagates, a collateral egress fault must not mask it.
        propagating = sys.exc_info()[0] is not None
        self._flush_egress(emit=True, raise_exc=not propagating)
        try:
            self.on_sink_sequence_end(iseqs[0] if iseqs else None)
        finally:
            self._update_egress_proclog()

    def _update_egress_proclog(self):
        """The stager's counters (bifrost_tpu/egress.py:662-675)."""
        e = self._egress
        self.egress_proclog.update({
            "staging": int(self._egress_staging),
            "depth": e.depth if e is not None else 0,
            "chunk_nbyte": e.chunk_nbyte if e is not None else 0,
            "staged_gulps": e.staged_gulps if e is not None else 0,
            "staged_bytes": e.staged_bytes if e is not None else 0,
            "drained_gulps": self._egress_drained_gulps,
            "pool_allocs": e.pool.allocated if e is not None else 0,
        })

    def _async_queue_depth(self):
        """Gulps on the executor's worker plus staged gulps not yet
        retired: the in-flight work a bounded quiesce reports as
        `queued_gulps` for this sink."""
        base = super()._async_queue_depth()
        pending = len(self._egress_pending) if self._egress_staging else None
        if base is None and pending is None:
            return None
        return (base or 0) + (pending or 0)

    def main(self):
        try:
            super().main()
        finally:
            self.shutdown()

    def shutdown(self):
        self._flush_egress(emit=False, raise_exc=False)
        if self._egress is not None:
            self._egress.close()
            self._egress = None


def _host_span(data, tensor):
    """A host ring's span as a zero-copy numpy view in the JAX package's
    host form (complex integers as the structured (re, im) array)."""
    a = data.numpy()
    dt = tensor.dtype
    if dt.is_complex and dt.is_integer and dt.nbit >= 8:
        a = a.view(dt.as_numpy_dtype())[..., 0]
    return a


def _blocking_materialize(ispan):
    """The blocking path: a host ring's span as a zero-copy view; a
    'cuda' ring's span copied whole on the calling thread (its stream,
    after the span's commits) through the `_materialize` seam."""
    t = ispan.tensor
    data = ispan.data
    if ispan.ring.space != "cuda":
        return _host_span(data, t)
    buf = torch.empty(t.host_span_nbyte(ispan.nframe), dtype=torch.uint8)
    _materialize(buf, _logical(data, t))
    return t.host_span_view(buf, ispan.nframe)
