"""Rings: sequences with JSON tensor headers, frame-unit spans, guaranteed
readers with back-pressure, and input overlap (counterpart of
bifrost_tpu/ring.py; reference python/bifrost/ring2.py).

Headers are JSON dicts with a `_tensor` entry: {'dtype': 'u8', 'shape':
[-1, nchan], 'labels': [...], 'scales': [[off, step], ...], 'units':
[...]}, where -1 marks the frame (time) axis.  Axes before the frame axis
are ringlets.

Control plane: the ring engine of the JAX package's C++ core
(cpp/src/ring.cpp) restated in Python over one `threading.Condition` per
ring — byte offsets that only grow (tail <= head <= reserve_head),
in-order commits, guaranteed readers whose lowest read position pins the
tail, sequences that begin at the reserve head and end at the commit
head.

Data plane: one uint8 tensor of shape (nringlet, capacity + ghost) in the
ring's space, the original Bifrost layout (SURVEY.md §2.1).  The ghost
region mirrors bytes [0, ghost) after the end of each ringlet row, so a
span that wraps is still one strided view: a writer that runs past the
capacity writes into the ghost and the commit copies that part down to
the row's head; a write inside [0, ghost) is copied up into the ghost.
For a 'cuda' ring the tensor is on the device and two kinds of CUDA
events keep streams apart: each commit records one on the writer's
stream, which a reader's stream waits on before it reads the span; each
release records one on the reader's stream, which the writer's stream
waits on before it writes the bytes it reclaimed.

Interrupts are generation-counted (cpp/src/ring.cpp btRingInterruptGen /
btRingAckInterrupt): `interrupt(target=)` fires generation g and wakes
every waiter with RingInterrupted while g is pending, `ack_interrupt(g)`
retires every generation up to g and no later one, so an ack bounded by
the generation its issuer saw never retires a fire aimed at a peer.  A
supervisor installs `_interrupt_retry`, which a woken waiter asks
whether the fire was meant for its thread (supervise.py); with no hook,
every pending fire raises (the shutdown path).  A reader waiting for
data while the writer commits is alive: `_progress_hook` stamps its
heartbeat at each such commit.  `_fault_hook`
(faultinject.py) fires before the ring.open / ring.reserve /
ring.acquire waits.  `WriteSpan.cancel(fence)` retires the ring's final
reservation without committing it; the writer's next reservation of
those bytes waits on `fence`, an event after the stream work that
touched them.

The zero-copy host plane (bifrost_tpu/ring.py:322-329): a writer on a
host ring may `WriteSpan.publish_external` a buffer of its own instead of
writing the ring's bytes; the commit files (offset, nbyte, buffer) in a
side plane keyed by byte offset, and readers of those bytes get a tensor
that aliases the publisher's memory.  The ring's control plane is
unchanged: only the payload lives elsewhere.

Every ring writes the ProcLog `rings/<name>` (cpp/src/ring.cpp:183-207):
its geometry at each resize, and its frontiers at commits, at most every
`GEOMETRY_LOG_S` seconds; the snapshot is taken under the ring's lock and
written after it is released.  The log's name (`Ring.log_name`) is unique
among the process's live rings: where a live ring already logs as
`<name>` (two pipelines of one topology in one process), the next logs
as `<name>#2`, `<name>#3`, ...; a ring unlinks only its own log.
"""

from __future__ import annotations

import collections
import json
import threading
import time

import numpy as np
import torch

from . import device as _device
from .DataType import DataType
from .memory import SPACEMAP, Space, alloc_bytes
from .ndarray import tensor_shape
from .proclog import ProcLog

_ALIGN = 16   # default capacity/ghost granularity: every element divides it
GEOMETRY_LOG_S = 0.25   # least seconds between two commit-time ring logs
_LOG_NAMES = set()      # the log names of the process's live rings
_LOG_NAMES_LOCK = threading.Lock()


def _claim_log_name(name):
    """`name`, else `name#k` for the least k >= 2 that no live ring of
    this process logs as; claimed until `_release_log_name`."""
    with _LOG_NAMES_LOCK:
        cand, k = name, 1
        while cand in _LOG_NAMES:
            k += 1
            cand = f"{name}#{k}"
        _LOG_NAMES.add(cand)
        return cand


def _release_log_name(name):
    # No lock: Ring.__del__ calls this whenever the collector runs, which
    # may be inside _claim_log_name on the same thread; set.discard is
    # atomic on its own.
    _LOG_NAMES.discard(name)


_OPEN_MODES = ("earliest", "latest", "name", "at", "next")


class EndOfDataStop(Exception):
    """The sequence or ring has no more data."""


class RingInterrupted(Exception):
    """A blocked ring call was woken by `Ring.interrupt()`."""


def _round_up(n, m):
    return (int(n) + m - 1) // m * m


def frame_major_header(header):
    """A copy of `header` whose `_tensor` has its frame axis moved first,
    the ringlet axes after it; `labels`, `scales` and `units` move with
    their axes."""
    tensor = dict(header["_tensor"])
    shape = list(tensor["shape"])
    fax = shape.index(-1)
    order = [fax] + [i for i in range(len(shape)) if i != fax]
    for key in ("shape", "labels", "scales", "units"):
        axes = tensor.get(key)
        if isinstance(axes, (list, tuple)) and len(axes) == len(shape):
            tensor[key] = [axes[i] for i in order]
    out = dict(header)
    out["_tensor"] = tensor
    return out


class TensorInfo(object):
    """Parsed `_tensor` header info (frame axis, ringlets, byte sizes)."""

    def __init__(self, header):
        tensor = header["_tensor"]
        self.dtype = DataType(tensor["dtype"])
        self.shape = list(tensor["shape"])
        self.labels = tensor.get("labels")
        self.scales = tensor.get("scales")
        self.units = tensor.get("units")
        frame_axes = [i for i, s in enumerate(self.shape) if s == -1]
        if len(frame_axes) != 1:
            raise ValueError(
                f"_tensor shape {self.shape} must have exactly one -1 "
                "(frame/time) axis")
        self.frame_axis = frame_axes[0]
        self.ringlet_shape = self.shape[:self.frame_axis]
        self.frame_shape = self.shape[self.frame_axis + 1:]
        self.nringlet = int(np.prod(self.ringlet_shape)) \
            if self.ringlet_shape else 1
        self.torch_dtype = self.dtype.as_torch_dtype()
        if not self.frame_shape and self.dtype.itemsize_bits < 8:
            # ci4 packs one sample a byte, so its frame axis may be last.
            raise ValueError("packed dtype requires a non-frame last axis")
        # Tensor shape of one frame: storage shape plus the (re, im) axis
        # of complex integers.
        self.frame_tensor_shape = tensor_shape(self.frame_shape, self.dtype) \
            if self.frame_shape else tensor_shape((), self.dtype)
        self.itemsize = torch.empty((), dtype=self.torch_dtype) \
            .element_size()
        self.frame_nbyte = int(np.prod(self.frame_tensor_shape)) * \
            self.itemsize

    def frame_major(self):
        """This tensor with its frame axis moved first, the ringlet axes
        after it: the layout of a stream put on a wire frame by frame
        (egress.DeviceSinkBlock.wire_frame_major)."""
        return TensorInfo(frame_major_header({"_tensor": {
            "dtype": str(self.dtype), "shape": self.shape}}))

    def span_shape(self, nframe):
        """Tensor shape of an nframe span in the header's axis order."""
        return tuple(self.ringlet_shape) + (nframe,) + \
            tuple(self.frame_tensor_shape)

    # ---------------------------------------------- host-destination views
    @property
    def host_view_dtype(self):
        """numpy dtype of a span landed on the host in logical form (the
        egress plane's form, bifrost_tpu/ring.py:257-266): complex
        integers lift to complex64, packed types stay uint8 storage,
        everything else is its storage type."""
        dt = self.dtype
        if dt.is_complex and dt.is_integer and dt.nbit >= 8:
            return np.dtype(np.complex64)
        return np.dtype(dt.as_jax_dtype())

    def host_span_shape(self, nframe):
        """Logical shape of an nframe span: the storage shape without the
        (re, im) axis of complex integers."""
        shape = self.span_shape(nframe)
        dt = self.dtype
        if dt.is_complex and dt.is_integer and dt.nbit >= 8:
            shape = shape[:-1]
        return tuple(shape)

    def host_span_nbyte(self, nframe):
        """Host bytes of an nframe span in logical form (the size of the
        egress plane's staging buffer for the gulp)."""
        return int(np.prod(self.host_span_shape(nframe))) * \
            self.host_view_dtype.itemsize

    def host_span_view(self, buf, nframe):
        """`buf` (a C-contiguous byte buffer of at least
        host_span_nbyte(nframe) bytes: numpy or a CPU uint8 tensor) as a
        numpy array in this tensor's logical axis order."""
        if isinstance(buf, torch.Tensor):
            buf = buf.numpy()
        flat = np.frombuffer(buf, dtype=np.uint8,
                             count=self.host_span_nbyte(nframe))
        return flat.view(self.host_view_dtype).reshape(
            self.host_span_shape(nframe))

    def span_view(self, rows, nframe):
        """Typed view of `rows`, a (nringlet, nframe * frame_nbyte) uint8
        view of ring bytes, in the header's axis order."""
        typed = rows.view(self.torch_dtype)
        if not self.ringlet_shape:
            typed = typed[0]
        return typed.view(self.span_shape(nframe))


class _Sequence(object):
    def __init__(self, sid, name, time_tag, header, nringlet, begin):
        self.id = sid
        self.name = name
        self.time_tag = time_tag
        self.header = header          # JSON text, as the C engine stores it
        self.nringlet = nringlet
        self.begin = begin
        self.end = None               # None while open

    @property
    def finished(self):
        return self.end is not None


class _HostBytes(object):
    """`nbyte` bytes of host memory at `ptr` for np.asarray, holding
    `keep` (the buffers that own them) as long as the array lives."""

    def __init__(self, ptr, nbyte, keep):
        self.__array_interface__ = {"data": (int(ptr), False),
                                    "shape": (int(nbyte),),
                                    "typestr": "|u1", "version": 3}
        self._keep = keep


class Ring(object):
    instance_count = 0

    def __init__(self, space="system", name=None, device=None, core=None):
        self.space = str(Space(space))
        # The CPU core of the block that writes it (a scope's `core`),
        # recorded: the ring's memory is placed by PyTorch's allocator,
        # not bound to that core's NUMA node.
        self.core = core
        if name is None:
            name = f"ring_{Ring.instance_count}"
        Ring.instance_count += 1
        self.name = name
        if device is None:
            device = "cpu" if self.space == "system" else \
                _device.resolve_device(None)
        self.device = torch.device(device)
        self._cond = threading.Condition()
        self._buf = None
        self.capacity = 0
        self.ghost = 0
        self.nringlet = 1
        self.tail = 0            # earliest valid offset
        self.head = 0            # committed frontier
        self.reserve_head = 0    # reserved frontier
        self._writing = False
        self._writing_ended = False
        self._intr_fired = 0          # latest fired generation (0: never)
        self._intr_acked = 0          # generations <= this are retired
        self._intr_target = 0         # target token of the latest fire
        # Supervision and fault-injection hooks (module docstring).
        self._interrupt_retry = None
        self._progress_hook = None
        self._fault_hook = None
        self._ncommit = 0             # commits so far, empty ones included
        self._next_seq_id = 0
        self._sequences = collections.deque()
        self._open_wseq = None
        self._open_wspans = collections.deque()
        self._nread_open = 0
        self._guarantees = []            # read positions of guaranteed readers
        # CUDA stream handoff (module docstring)
        self._commit_events = collections.deque()   # (begin, end, event)
        self._release_events = []
        # The zero-copy host plane: sorted (offset, nbyte, ptr, keepref) of
        # published payloads, and how many spans were published.
        self._ext_store = []
        self.published_spans = 0
        self.log_name = _claim_log_name(name)
        try:
            self._proclog = ProcLog(f"rings/{self.log_name}")
        except OSError:
            self._proclog = None          # the log is best-effort
        self._geom_log_t = 0.0

    def __del__(self):
        # A ring's log goes with it, as the C engine's ring destroys its
        # ProcLog (cpp/src/ring.cpp ~BTring_impl); the name is this
        # ring's alone, so no live ring's log is unlinked.
        log = getattr(self, "_proclog", None)
        if log is not None:
            log.remove()
        log_name = getattr(self, "log_name", None)
        if log_name is not None:
            _release_log_name(log_name)

    @property
    def _on_cuda(self):
        return self._buf is not None and self._buf.is_cuda

    # ----------------------------------------------------------- waiting
    def _intr_pending(self):
        return self._intr_fired > self._intr_acked

    def _wait_for(self, pred, reader=False):
        """Condition wait that honours interrupts (caller holds _cond
        once).  A pending interrupt surfaces only where the call really
        blocks; a supervised waiter woken by a fire that was not meant
        for it asks `_interrupt_retry` (without the lock) and waits
        again.  A `reader` waiting for data is alive while the writer
        commits, even empty spans (an FDMT's warm-up): each commit that
        does not end its wait calls `_progress_hook`, which stamps its
        heartbeat."""
        while True:
            if pred():
                return
            n0 = self._ncommit
            self._cond.wait_for(lambda: self._intr_pending() or pred() or
                                (reader and self._ncommit != n0))
            if not self._intr_pending():
                if pred():
                    return
                hook = self._progress_hook
                if hook is not None:
                    hook()
                continue
            retry = self._interrupt_retry
            if retry is None:
                raise RingInterrupted(f"ring {self.name} interrupted")
            self._cond.release()
            try:
                again = retry()
            finally:
                self._cond.acquire()
            if not again:
                raise RingInterrupted(f"ring {self.name} interrupted")

    def interrupt(self, target=0):
        """Fire a generation-counted interrupt: every blocked caller wakes
        with RingInterrupted until the generation is acknowledged.
        `target` is an opaque token (0: everyone) naming whom the fire is
        for.  -> the fired generation."""
        with self._cond:
            self._intr_fired += 1
            self._intr_target = int(target)
            gen = self._intr_fired
            self._cond.notify_all()
        return gen

    def ack_interrupt(self, gen):
        """Retire every generation <= `gen` (never past the latest fire):
        a later fire stays pending for its own target."""
        with self._cond:
            bound = min(int(gen), self._intr_fired)
            if bound > self._intr_acked:
                self._intr_acked = bound
            self._cond.notify_all()

    def interrupt_info(self):
        """-> (fired generation, acked generation, latest fire's target)."""
        with self._cond:
            return self._intr_fired, self._intr_acked, self._intr_target

    # ----------------------------------------------------------- ring log
    def _geometry(self):
        """The ring log's text (cpp/src/ring.cpp format_geometry; caller
        holds _cond).  `guarantee` is the slowest guaranteed reader's
        frontier, else the head: tools read the backlog as reserve_head
        - guarantee.  `space` is numbered as the JAX engine logs it."""
        g = self._min_guarantee()
        return (f"capacity : {self.capacity}\nghost : {self.ghost}\n"
                f"nringlet : {self.nringlet}\ntail : {self.tail}\n"
                f"head : {self.head}\nreserve_head : {self.reserve_head}\n"
                f"guarantee : {self.head if g is None else g}\n"
                f"space : {SPACEMAP[self.space]}\n")

    def _log(self, text):
        if self._proclog is not None:
            self._proclog.update(text)

    def _geometry_if_due(self):
        """The ring log's text if the last commit-time write is older than
        GEOMETRY_LOG_S, else None (caller holds _cond)."""
        now = time.monotonic()
        if now - self._geom_log_t <= GEOMETRY_LOG_S:
            return None
        self._geom_log_t = now
        return self._geometry()

    # ----------------------------------------------------------- geometry
    def resize(self, contiguous_bytes, total_bytes=None, nringlet=1,
               align=_ALIGN):
        """Grow the ring to hold spans of `contiguous_bytes` per ringlet
        and `total_bytes` per ringlet in all (never shrinks); waits until
        no span is open, then re-lays out the live bytes
        (cpp/src/ring.cpp btRingResize).  Capacity and ghost are
        multiples of `align`, the element size of the sequences' typed
        views: a ring of many ringlets of one 8-byte frame each (a
        time-last stream) then holds 16 bytes per ringlet, not 32."""
        if total_bytes is None:
            total_bytes = contiguous_bytes * 4
        nringlet = max(int(nringlet), 1)
        with self._cond:
            ghost = _round_up(max(self.ghost, contiguous_bytes), align)
            cap = _round_up(max(self.capacity, total_bytes, ghost), align)
            nring = max(self.nringlet, nringlet)
            if (cap, ghost, nring) == (self.capacity, self.ghost,
                                       self.nringlet):
                return
            self._wait_for(lambda: not self._open_wspans and
                           self._nread_open == 0)
            nbuf = alloc_bytes((nring, cap + ghost), self.space, self.device)
            nbuf.zero_()
            old = self._buf
            if old is not None and self.reserve_head > self.tail:
                if nring != self.nringlet:
                    raise RuntimeError(
                        "cannot change nringlet while the ring holds data")
                if old.is_cuda:
                    # Commits in flight on writer streams must land before
                    # their bytes move.
                    torch.cuda.synchronize(old.device)
                off, hi = self.tail, self.reserve_head
                while off < hi:
                    run = min(hi - off, self.capacity - off % self.capacity,
                              cap - off % cap)
                    src = off % self.capacity
                    dst = off % cap
                    nbuf[:, dst:dst + run].copy_(old[:, src:src + run])
                    off += run
                nbuf[:, cap:cap + ghost].copy_(nbuf[:, :ghost])
            if nbuf.is_cuda:
                # The zero fill and copies ran on this thread's stream;
                # the writer's stream must not overtake them.
                torch.cuda.synchronize(nbuf.device)
            self._buf = nbuf
            self.capacity, self.ghost, self.nringlet = cap, ghost, nring
            self._cond.notify_all()
            text = self._geometry()
        self._log(text)

    # ------------------------------------------------------------ writing
    def begin_writing(self):
        with self._cond:
            if self._writing:
                raise RuntimeError(f"ring {self.name!r} already has a writer")
            self._writing = True
            self._writing_ended = False
        return RingWriter(self)

    def end_writing(self):
        with self._cond:
            seq = self._open_wseq
            if seq is not None and not seq.finished:
                seq.end = self.head
            self._open_wseq = None
            self._writing = False
            self._writing_ended = True
            self._cond.notify_all()

    def begin_sequence(self, header, gulp_nframe=1, buf_nframe=None):
        return WriteSequence(self, header, gulp_nframe, buf_nframe)

    def _sequence_begin(self, header, nringlet, time_tag=None):
        """Open a sequence; its time tag is the header's "time_tag" unless
        `time_tag` is given (a writer that passes it separately, as the
        capture engine does)."""
        if time_tag is None:
            time_tag = header.get("time_tag", 0)
        with self._cond:
            if not self._writing:
                raise RuntimeError(
                    f"sequence_begin before begin_writing on {self.name!r}")
            if self._open_wseq is not None and not self._open_wseq.finished:
                raise RuntimeError(
                    f"previous sequence still open on {self.name!r}")
            if nringlet > self.nringlet:
                raise ValueError(
                    f"sequence nringlet {nringlet} exceeds ring nringlet "
                    f"{self.nringlet} — resize first")
            seq = _Sequence(self._next_seq_id, str(header.get("name", "")),
                            int(time_tag),
                            json.dumps(header), nringlet, self.reserve_head)
            self._next_seq_id += 1
            self._sequences.append(seq)
            self._open_wseq = seq
            self._cond.notify_all()
            return seq

    def _sequence_end(self, seq):
        with self._cond:
            if not seq.finished:
                seq.end = self.head
            if self._open_wseq is seq:
                self._open_wseq = None
            self._cond.notify_all()

    def _min_guarantee(self):
        return min(self._guarantees) if self._guarantees else None

    def _reserve(self, size, nonblocking):
        """-> (begin offset, token, release events to wait on) of a new
        reservation of `size` bytes."""
        with self._cond:
            if not self._writing:
                raise RuntimeError("span_reserve before begin_writing")
            if size > self.capacity or size > self.ghost:
                raise ValueError(
                    f"span size {size} exceeds ring geometry (capacity "
                    f"{self.capacity}, ghost {self.ghost}) — resize first")
            begin = self.reserve_head

            def needed_tail():
                return max(begin + size - self.capacity, 0)

            def can_advance():
                g = self._min_guarantee()
                need = needed_tail()
                return (g is None or g >= need) and self.head >= need

            if needed_tail() > self.tail:
                # Back-pressure: bytes a guaranteed reader still pins, or
                # that the writer has not committed, cannot be reclaimed.
                if not can_advance():
                    if nonblocking:
                        raise BlockingIOError(
                            f"ring {self.name}: reserve would block")
                    self._wait_for(can_advance)
                self.tail = max(self.tail, needed_tail())
                while self._sequences and self._sequences[0].finished and \
                        self._sequences[0].end <= self.tail:
                    self._sequences.popleft()
                while self._commit_events and \
                        self._commit_events[0][1] <= self.tail:
                    self._commit_events.popleft()
            self.reserve_head = begin + size
            token = object()
            self._open_wspans.append(token)
            released, self._release_events = self._release_events, []
            self._cond.notify_all()
        return begin, token, released

    def _commit(self, token, begin, size, commit_size, ext=None):
        """Commit `commit_size` bytes of the reservation at `begin`;
        `ext`: (ptr, keepref) of a published payload (WriteSpan.
        publish_external), filed in the side plane instead of the ring's
        bytes, whose ghost mirror it then needs no copy for."""
        with self._cond:
            if commit_size > size:
                raise ValueError("commit larger than the reservation")
            self._wait_for(lambda: self._open_wspans and
                           self._open_wspans[0] is token)
            if commit_size < size:
                if begin + size != self.reserve_head:
                    raise RuntimeError("partial commit of a non-final span")
                self.reserve_head = begin + commit_size
                for s in self._sequences:
                    if s.finished and s.end > self.reserve_head:
                        s.end = self.reserve_head
            if commit_size and ext is not None:
                self._plane_put((begin, commit_size) + tuple(ext))
                self.published_spans += 1
            elif commit_size and self._buf is not None:
                self._sync_ghost(begin, commit_size)
                ev = _device.record_event(self.device) if self._on_cuda \
                    else None
                if ev is not None:
                    self._commit_events.append((begin, begin + commit_size,
                                                ev))
            self.head = begin + commit_size
            self._open_wspans.popleft()
            self._ncommit += 1
            self._cond.notify_all()
            text = self._geometry_if_due()
        if text is not None:
            self._log(text)

    # ------------------------------------------------- zero-copy host plane
    def _plane_put(self, entry):
        """File (offset, nbyte, ptr, keepref) in the side plane and expire
        the entries the tail has passed, which pin their buffers
        (bifrost_tpu/ring.py:395-411; caller holds _cond).  Commits come
        in offset order, so this appends."""
        store = self._ext_store
        store.append(entry)
        while store and store[0][0] + store[0][1] <= self.tail:
            store.pop(0)

    def _ext_get(self, offset, nbyte):
        """-> a uint8 CPU tensor of [offset, offset + nbyte) where published
        payload covers any of it, else None (bifrost_tpu/ring.py:462-520).
        Entries that are consecutive slices of one buffer give a view of
        the publisher's memory; anything else (separate buffers, a span
        published only in part) is assembled into a copy, the ring's bytes
        first and the published ranges laid over them, so a published
        range is never served from unwritten ring bytes.  The tensor keeps
        the buffers alive while it lives."""
        if not self._ext_store:
            return None
        with self._cond:
            entries = [e for e in self._ext_store
                       if e[0] < offset + nbyte and e[0] + e[1] > offset]
            rows = self._rows(offset, nbyte)[0] if entries else None
        if not entries:
            return None
        covered, ptr0, keep, alias = offset, None, [], True
        for eoff, enb, eptr, ref in entries:
            if eoff > covered:
                alias = False                 # a gap: copied ring bytes
            lo = max(offset, covered, eoff)
            hi = min(offset + nbyte, eoff + enb)
            if hi <= lo:
                continue
            p = eptr + (lo - eoff)
            if ptr0 is None:
                alias = alias and lo == offset
                ptr0 = p
            elif p != ptr0 + (lo - offset):
                alias = False                 # separate source buffers
            keep.append(ref)
            covered = hi
        if alias and covered >= offset + nbyte:
            return torch.from_numpy(np.asarray(_HostBytes(ptr0, nbyte,
                                                          keep)))
        buf = rows.clone()
        out = buf.numpy()
        for eoff, enb, eptr, ref in entries:
            lo = max(offset, eoff)
            hi = min(offset + nbyte, eoff + enb)
            if hi > lo:
                out[lo - offset:hi - offset] = np.asarray(
                    _HostBytes(eptr + (lo - eoff), hi - lo, ref))
        return buf

    def _cancel(self, token, begin, size, fence):
        """Retire the final reservation uncommitted (btRingSpanCancel).
        On a 'cuda' ring the writer's next reservation waits on `fence`;
        on a host ring the fence has completed before the bytes go back."""
        if fence is not None and not self._on_cuda:
            fence.synchronize()
        with self._cond:
            if begin + size != self.reserve_head:
                raise RuntimeError(f"ring {self.name!r}: cancel of a "
                                   f"non-final span")
            self.reserve_head = begin
            for s in self._sequences:
                if s.finished and s.end > self.reserve_head:
                    s.end = self.reserve_head
            self._open_wspans.remove(token)
            if fence is not None and self._on_cuda:
                self._release_events.append(fence)
            self._cond.notify_all()

    def _sync_ghost(self, begin, n):
        """Keep the ghost mirror coherent for newly committed bytes (on
        the committing thread's stream, before the commit event)."""
        cap, ghost, buf = self.capacity, self.ghost, self._buf
        p = begin % cap
        if p + n > cap:                       # wrote into the ghost
            glen = min(p + n - cap, ghost)
            buf[:, :glen].copy_(buf[:, cap:cap + glen])
        if p < ghost:                         # wrote under the mirror
            hi = min(p + n, cap, ghost)
            buf[:, cap + p:cap + hi].copy_(buf[:, p:hi])

    def _rows(self, begin, size):
        """(nringlet, size) uint8 view of the bytes at `begin`."""
        p = begin % self.capacity
        return self._buf[:, p:p + size]

    # ------------------------------------------------------------ reading
    def open_sequence(self, which="earliest", name=None, time_tag=0,
                      guarantee=True, nonblocking=False, cur=None):
        """Open a sequence for reading (cpp/src/ring.cpp
        btRingSequenceOpen): 'earliest' (the first not yet overwritten),
        'latest', 'name' (the first named `name`), 'at' (the sequence
        containing `time_tag`: the latest whose tag is <= it; a tag before
        every live sequence raises ValueError) or 'next' (after `cur`).
        Waits for such a sequence unless `nonblocking`, which raises
        BlockingIOError instead; EndOfDataStop once writing has ended."""
        if which not in _OPEN_MODES:
            raise ValueError(f"unknown open mode {which!r}")
        hook = self._fault_hook
        if hook is not None:
            hook("ring.open", self)
        with self._cond:
            def find():
                seqs = self._sequences
                if which == "earliest":
                    return next((s for s in seqs if not (
                        s.finished and s.end <= self.tail)), None)
                if which == "latest":
                    return seqs[-1] if seqs else None
                if which == "name":
                    return next((s for s in seqs if name and
                                 s.name == name), None)
                if which == "at":
                    best = None
                    for s in seqs:
                        if s.time_tag <= time_tag:
                            best = s
                    return best
                return next((s for s in seqs if cur is not None and
                             s.id > cur._seq.id), None)

            found = [find()]
            if found[0] is None and which == "at" and self._sequences:
                raise ValueError(f"ring {self.name}: time_tag {time_tag} "
                                 f"precedes every live sequence")

            def ready():
                found[0] = find()
                return found[0] is not None or self._writing_ended

            if not ready():
                if nonblocking:
                    raise BlockingIOError(f"ring {self.name}: open would "
                                          f"block")
                self._wait_for(ready, reader=True)
            if found[0] is None:
                raise EndOfDataStop(f"ring {self.name}: no more sequences")
            seq = found[0]
            pos = None
            if guarantee:
                pos = max(self.tail, seq.begin)
                self._guarantees.append(pos)
        return ReadSequence(self, seq, guarantee, pos)

    def open_earliest_sequence(self, guarantee=True):
        return self.open_sequence("earliest", guarantee=guarantee)

    def open_latest_sequence(self, guarantee=True):
        return self.open_sequence("latest", guarantee=guarantee)

    def open_sequence_by_name(self, name, guarantee=True):
        return self.open_sequence("name", name=name, guarantee=guarantee)

    def open_sequence_at(self, time_tag, guarantee=True):
        return self.open_sequence("at", time_tag=time_tag,
                                  guarantee=guarantee)

    def cursor(self, guarantee=True):
        """-> a `SequenceCursor` over this ring's sequences."""
        return SequenceCursor(self, guarantee)

    def read(self, guarantee=True):
        """Generator over sequences as they appear (reference
        ring2.py:149); closes each sequence as it advances."""
        return self.cursor(guarantee).sequences()


class SequenceCursor(object):
    """One reader's walk through a ring's sequences: open the earliest,
    then each next one, closing the one before, until writing has ended.
    The position is held in the object rather than in a generator's
    frame, so a pipeline splice can hand it to a replacement block: the
    current sequence, and its read guarantee, stay open across the
    hand-off, and a wait interrupted in `next` leaves the position as it
    was.  `wrap`, where given, maps each opened sequence to what the
    reader sees (a header view's `SequenceView`)."""

    def __init__(self, ring, guarantee=True, wrap=None):
        self.ring = ring
        self.guarantee = guarantee
        self.wrap = wrap
        self.cur = None
        self.done = False

    def next(self):
        """-> the next sequence (StopIteration at the end of writing)."""
        if self.done:
            raise StopIteration
        try:
            if self.cur is None:
                nxt = self.ring.open_sequence("earliest",
                                              guarantee=self.guarantee)
            else:
                nxt = self.ring.open_sequence("next", cur=self.cur,
                                              guarantee=self.guarantee)
        except EndOfDataStop:
            self.done = True
            raise StopIteration from None
        if self.cur is not None:
            self.cur.close()
        self.cur = nxt
        return nxt if self.wrap is None else self.wrap(nxt)

    def close(self):
        if self.cur is not None:
            self.cur.close()
            self.cur = None
        self.done = True

    def sequences(self):
        """Generator over the remaining sequences; closes the cursor when
        it ends or is closed."""
        try:
            while True:
                try:
                    seq = self.next()
                except StopIteration:
                    return
                yield seq
        finally:
            self.close()


class RingWriter(object):
    """Context manager for a write epoch (reference ring2.py:129-147)."""

    def __init__(self, ring):
        self.ring = ring

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.ring.end_writing()

    def begin_sequence(self, header, gulp_nframe=1, buf_nframe=None):
        return self.ring.begin_sequence(header, gulp_nframe, buf_nframe)


class WriteSequence(object):
    def __init__(self, ring, header, gulp_nframe=1, buf_nframe=None):
        self.ring = ring
        self.header = header
        self.tensor = TensorInfo(header)
        if buf_nframe is None:
            buf_nframe = gulp_nframe * 3
        self.gulp_nframe = gulp_nframe
        ring.resize(self.tensor.frame_nbyte * gulp_nframe,
                    self.tensor.frame_nbyte * buf_nframe,
                    self.tensor.nringlet, align=self.tensor.itemsize)
        self._seq = ring._sequence_begin(header, self.tensor.nringlet)
        self.begin = self._seq.begin
        self._ended = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()

    def end(self):
        if not self._ended:
            self.ring._sequence_end(self._seq)
            self._ended = True

    def reserve(self, nframe, nonblocking=False):
        return WriteSpan(self, nframe, nonblocking)


class WriteSpan(object):
    def __init__(self, wseq, nframe, nonblocking=False):
        ring = wseq.ring
        self.ring = ring
        self.tensor = wseq.tensor
        self.nframe = nframe
        self.nbyte = nframe * self.tensor.frame_nbyte
        hook = ring._fault_hook
        if hook is not None:
            hook("ring.reserve", ring)
        self.offset, self._token, released = ring._reserve(self.nbyte,
                                                           nonblocking)
        for ev in released:   # readers' streams are done with these bytes
            _device.wait_event(ev, ring.device)
        self.frame_offset = (self.offset - wseq.begin) // \
            self.tensor.frame_nbyte
        self.commit_nframe = nframe
        self._committed = False
        self._ext = None

    @property
    def data(self):
        """Writable tensor view of the span in the header's axis order."""
        rows = self.ring._rows(self.offset, self.nbyte)
        return self.tensor.span_view(rows[:self.tensor.nringlet],
                                     self.nframe)

    @data.setter
    def data(self, value):
        self.data.copy_(value)

    def publish_external(self, arr, nframe=None):
        """Commit `arr`'s bytes instead of the ring's: readers of this span
        get a tensor aliasing `arr` (the zero-copy host plane,
        bifrost_tpu/ring.py:703-733).  `arr`: a C-contiguous numpy array
        or CPU tensor in the span's storage layout (frame-major,
        frame_nbyte a frame) covering the frames to commit.  The caller
        keeps it alive and unmodified until the ring's tail has passed the
        span (an in-memory source: the run).  Host rings of one ringlet
        only; every span of a sequence is either published or written."""
        if self.ring.space == "cuda":
            raise ValueError("publish_external is for host rings; device "
                             "rings commit tensors via span.data")
        if self.tensor.nringlet != 1:
            raise ValueError("publish_external requires nringlet == 1")
        if isinstance(arr, torch.Tensor):
            if arr.device.type != "cpu":
                raise ValueError("publish_external needs a CPU tensor")
            contiguous = arr.is_contiguous()
            ptr, nbyte = arr.data_ptr(), arr.numel() * arr.element_size()
        else:
            arr = np.asarray(arr)
            contiguous = arr.flags.c_contiguous
            ptr, nbyte = arr.ctypes.data, arr.nbytes
        if not contiguous:
            raise ValueError("publish_external needs a C-contiguous buffer")
        n = self.commit_nframe if nframe is None else nframe
        need = n * self.tensor.frame_nbyte
        if nbyte < need:
            raise ValueError(f"external buffer holds {nbyte} bytes; span "
                             f"commit needs {need}")
        self._ext = (ptr, arr)
        self.commit_nframe = n

    def commit(self, nframe=None):
        if self._committed:
            return
        if nframe is None:
            nframe = self.commit_nframe
        self.ring._commit(self._token, self.offset, self.nbyte,
                          nframe * self.tensor.frame_nbyte, self._ext)
        self._committed = True

    def cancel(self, fence=None):
        """Retire this reservation uncommitted, without the in-order
        commit wait; legal for the ring's final reservation only (a batch
        is cancelled newest first).  `fence`: an event recorded after the
        stream work that may still write these bytes (module docstring).
        A committed span is left as it is."""
        if self._committed:
            return
        self.ring._cancel(self._token, self.offset, self.nbyte, fence)
        self._committed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        self.commit(None if exc_type is None else 0)


class ReadSequence(object):
    def __init__(self, ring, seq, guarantee, guarantee_pos):
        self.ring = ring
        self._seq = seq
        self.guarantee = guarantee
        self._gpos = guarantee_pos
        self.name = seq.name
        self.time_tag = seq.time_tag
        self.begin = seq.begin
        self.header = json.loads(seq.header) if seq.header else {}
        self.tensor = TensorInfo(self.header) \
            if "_tensor" in self.header else None
        self._closed = False
        self._open_spans = []
        self._manual = False

    def set_guarantee_manual(self, manual=True):
        """Stop span acquires from moving this reader's guarantee forward;
        the reader moves it itself with `advance_guarantee` (the async
        gulp executor acquires ahead of the gulps its worker still
        reads; bifrost_tpu/ring.py:835-842)."""
        self._manual = bool(manual)

    def advance_guarantee(self, offset):
        """Move this reader's guarantee forward to byte `offset`: the
        bytes before it become the writer's to reclaim."""
        ring = self.ring
        with ring._cond:
            if self._gpos is not None and offset > self._gpos:
                ring._guarantees.remove(self._gpos)
                self._gpos = int(offset)
                ring._guarantees.append(self._gpos)
                ring._cond.notify_all()

    def close(self):
        # Outstanding spans release before the guarantee goes away.
        for span in list(self._open_spans):
            span.release()
        ring = self.ring
        with ring._cond:
            if self._closed:
                return
            self._closed = True
            if self._gpos is not None:
                ring._guarantees.remove(self._gpos)
                self._gpos = None
            ring._cond.notify_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def resize(self, gulp_nframe, buf_nframe=None):
        if buf_nframe is None:
            buf_nframe = gulp_nframe * 3
        t = self.tensor
        self.ring.resize(t.frame_nbyte * gulp_nframe,
                         t.frame_nbyte * buf_nframe, t.nringlet,
                         align=t.itemsize)

    def acquire(self, frame_offset, nframe, nonblocking=False):
        """Acquire an absolute-frame-indexed span (frames since the
        sequence began)."""
        if self._closed:
            raise ValueError("sequence is closed")
        t = self.tensor
        return ReadSpan(self, self.begin + frame_offset * t.frame_nbyte,
                        nframe * t.frame_nbyte, nonblocking)

    def _acquire(self, offset, size, nonblocking):
        """-> (bytes available, bytes overwritten) at `offset`."""
        ring, s = self.ring, self._seq
        with ring._cond:
            if self._gpos is not None and offset > self._gpos and \
                    not self._manual:
                # Guarantee follows the read position forward.
                ring._guarantees.remove(self._gpos)
                self._gpos = offset
                ring._guarantees.append(offset)
                ring._cond.notify_all()

            def ready():
                return (ring.head >= offset + size or
                        (s.finished and ring.head >= min(offset + size,
                                                         s.end)) or
                        ring._writing_ended)

            if not ready():
                if nonblocking:
                    raise BlockingIOError(f"ring {ring.name}: acquire "
                                          f"would block")
                ring._wait_for(ready, reader=True)
            limit = s.end if s.finished else \
                ring.head if ring._writing_ended else offset + size
            if offset >= limit:
                raise EndOfDataStop("sequence exhausted")
            eff = min(offset + size, limit) - offset
            ring._nread_open += 1
            waits = [ev for (b, e, ev) in ring._commit_events
                     if b < offset + eff and e > offset]
            overwritten = min(max(ring.tail - offset, 0), eff)
        return eff, overwritten, waits

    def read(self, gulp_nframe, stride_nframe=None, begin_nframe=0):
        """Generator of ReadSpans (reference ring2.py:324-334)."""
        if stride_nframe is None:
            stride_nframe = gulp_nframe
        frame = begin_nframe
        while True:
            try:
                span = self.acquire(frame, gulp_nframe)
            except EndOfDataStop:
                return
            try:
                yield span
            finally:
                span.release()
            if span.nframe < gulp_nframe:
                return  # partial span at sequence end
            frame += stride_nframe


class ReadSpan(object):
    def __init__(self, rseq, offset, size, nonblocking=False):
        self.rseq = rseq
        self.ring = rseq.ring
        self.tensor = t = rseq.tensor
        hook = self.ring._fault_hook
        if hook is not None:
            hook("ring.acquire", self.ring)
        eff, overwritten, waits = rseq._acquire(offset, size, nonblocking)
        self.offset = offset
        self.nframe = eff // t.frame_nbyte
        self.nbyte = self.nframe * t.frame_nbyte
        self.frame_offset = (offset - rseq.begin) // t.frame_nbyte
        self.nframe_skipped = min(overwritten // t.frame_nbyte, self.nframe)
        self._waits = waits
        self._hold = []
        self._released = False
        rseq._open_spans.append(self)
        if self.nframe == 0:
            self.release()
            raise EndOfDataStop("sequence exhausted")

    @property
    def nframe_overwritten(self):
        """Frames of this span the writer has overwritten (lossy readers)."""
        with self.ring._cond:
            ow = min(max(self.ring.tail - self.offset, 0), self.nbyte)
        return min(ow // self.tensor.frame_nbyte, self.nframe)

    @property
    def data(self):
        """Tensor view of the span in the header's axis order.  On a cuda
        ring the caller's stream first waits for the commits that wrote
        these bytes.  Where the writer published the span
        (`WriteSpan.publish_external`), the view may alias the
        publisher's own memory: a reader must not write it."""
        for ev in self._waits:
            _device.wait_event(ev, self.ring.device)
        self._waits = []
        ext = self.ring._ext_get(self.offset, self.nbyte)
        if ext is not None:
            return self.tensor.span_view(ext.view(1, -1), self.nframe)
        rows = self.ring._rows(self.offset, self.nbyte)
        return self.tensor.span_view(rows[:self.tensor.nringlet],
                                     self.nframe)

    @property
    def data_storage(self):
        """The span in raw storage form for a complex-integer stream on a
        'cuda' ring (the int (re, im)-pair tensor of ci8 and wider, the
        packed uint8 bytes of ci4, as the H2D copy committed them), else
        None (the JAX ReadSpan.data_storage contract).  Storage here is
        already that form, so this is `data`."""
        dt = self.tensor.dtype
        if self.ring.space != "cuda" or not (dt.is_complex and
                                             dt.is_integer):
            return None
        return self.data

    @property
    def sharding(self):
        """The span's layout over its ring's mesh, a
        parallel.shard.NamedSharding: the {label: mesh axis} map a
        sharded stream's header carries (stamped by the H2D copy under a
        `mesh=` scope, carried on by the transforms after it) resolved
        against this span's labels and shape.  None for an unsharded
        stream."""
        from .parallel.shard import AXES_KEY, span_sharding
        mesh = getattr(self.ring, "mesh", None)
        axes = self.rseq.header.get(AXES_KEY)
        if mesh is None or not axes:
            return None
        t = self.tensor
        shape = list(t.span_shape(self.nframe))
        return span_sharding(mesh, list(t.labels or []), axes, shape)

    def hold_until(self, event):
        """Delay this span's release until `event` has completed on the
        host: an asynchronous copy still reads these bytes."""
        if event is not None:
            self._hold.append(event)

    def release(self):
        if self._released:
            return
        self._released = True
        for ev in self._hold:
            ev.synchronize()
        ring = self.ring
        ev = _device.record_event(ring.device) if ring._on_cuda else None
        try:
            self.rseq._open_spans.remove(self)
        except ValueError:
            pass
        with ring._cond:
            if ev is not None:
                ring._release_events.append(ev)
            ring._nread_open -= 1
            ring._cond.notify_all()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
