"""Rings: sequences with JSON tensor headers, frame-unit spans, guaranteed
readers with back-pressure, and input overlap (counterpart of
bifrost_tpu/ring.py; reference python/bifrost/ring2.py).

Headers are JSON dicts with a `_tensor` entry: {'dtype': 'u8', 'shape':
[-1, nchan], 'labels': [...], 'scales': [[off, step], ...], 'units':
[...]}, where -1 marks the frame (time) axis.  Axes before the frame axis
are ringlets.

Control plane: the port's ring engine, ``csrc/ring.cpp`` (its copy of
the JAX package's cpp/src/ring.cpp), built with the host C++ compiler at
first use (build.load_host('ring')) and called through ctypes.CDLL, so a
blocking call waits without the GIL — byte offsets that only grow (tail
<= head <= reserve_head), in-order commits, guaranteed readers whose
lowest read position pins the tail, sequences that begin at the reserve
head and end at the commit head, generation-counted interrupts.  A
failed build raises; there is no other engine.

Data plane: one uint8 tensor of shape (nringlet, capacity + ghost) in the
ring's space, the original Bifrost layout (SURVEY.md §2.1).  The ghost
region mirrors bytes [0, ghost) after the end of each ringlet row, so a
span that wraps is still one strided view: a writer that runs past the
capacity writes into the ghost and the commit copies that part down to
the row's head; a write inside [0, ghost) is copied up into the ghost.
The host spaces ('system', 'cuda_host') hold the engine's own bytes,
which this module views as that tensor: the engine keeps their mirror
(the copy up deferred to the first read across the capacity), a resize
moves them (the old bytes live on while a view of them does), and a
ring of a block built under `block_scope(core=N)` places them on core
N's NUMA node (`Ring(core=)`, best effort).  A 'cuda_host' ring on a
CUDA device registers its bytes pinned, or raises.  A 'cuda' ring's
engine keeps the offsets only: its bytes are a device tensor of this
module's, mirrored here at each commit, and two kinds of CUDA events keep
streams apart: each commit records one on the writer's stream, which a
reader's stream waits on before it reads the span; each release records
one on the reader's stream, which the writer's stream waits on before it
writes the bytes it reclaimed.

Interrupts are generation-counted (btpRingInterruptGen /
btpRingAckInterrupt): `interrupt(target=)` fires generation g and wakes
every waiter with RingInterrupted while g is pending, `ack_interrupt(g)`
retires every generation up to g and no later one, so an ack bounded by
the generation its issuer saw never retires a fire aimed at a peer.  A
supervisor installs `_interrupt_retry`, which a woken waiter asks,
outside the engine, whether the fire was meant for its thread
(supervise.py); with no hook, every pending fire raises (the shutdown
path).  A reader waiting for data while the writer commits is alive:
with `_progress_hook` installed the engine ends the wait at each such
commit, the hook stamps the reader's heartbeat, and the reader waits
again.  `_fault_hook` (faultinject.py) fires before the ring.open /
ring.reserve / ring.acquire waits.  `WriteSpan.cancel(fence)` retires
the ring's final reservation without committing it; the writer's next
reservation of those bytes waits on `fence`, an event after the stream
work that touched them.

The zero-copy host plane (bifrost_tpu/ring.py:322-329): a writer on a
host ring may `WriteSpan.publish_external` a buffer of its own instead of
writing the ring's bytes; the commit files (offset, nbyte, buffer) in a
side plane keyed by byte offset, and readers of those bytes get a tensor
that aliases the publisher's memory.  The ring's control plane is
unchanged: only the payload lives elsewhere.

Every ring writes the ProcLog `rings/<name>` (cpp/src/ring.cpp:183-207):
the engine writes its geometry at each resize, and its frontiers at
commits, at most every 0.25 s, into the file of this module's ProcLog.
The log's name (`Ring.log_name`) is unique among the process's live
rings: where a live ring already logs as `<name>` (two pipelines of one
topology in one process), the next logs as `<name>#2`, `<name>#3`, ...;
a ring unlinks only its own log.
"""

from __future__ import annotations

import collections
import ctypes
import json
import sys
import threading

import numpy as np
import torch

from . import device as _device
from .DataType import DataType
from .memory import SPACEMAP, Space, alloc_bytes
from .ndarray import _storage_shape, ndarray, tensor_shape
from .proclog import ProcLog

_ALIGN = 16   # default capacity/ghost granularity: every element divides it
GEOMETRY_LOG_S = 0.25   # the engine's least seconds between two commit logs
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
        self._view_lock = threading.Lock()
        self._view_cache = {}

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

    def full_shape(self, nframe):
        """Host storage shape of an nframe span in the header's axis order
        (the JAX package's: complex integers without their (re, im) axis,
        packed types folded)."""
        frame = _storage_shape(self.frame_shape, self.dtype) \
            if self.frame_shape else ()
        return tuple(self.ringlet_shape) + (nframe,) + tuple(frame)

    def span_array(self, data_ptr, ringlet_stride, nframe, space):
        """A host `ndarray` view of an nframe span at host address
        `data_ptr`, ringlets `ringlet_stride` bytes apart, in the header's
        axis order (bifrost_tpu/ring.py:179-200; reference
        ring2.py:430-446)."""
        np_dtype = self.dtype.as_numpy_dtype()
        frame = self.full_shape(nframe)[len(self.ringlet_shape) + 1:]
        itemstrides = [np_dtype.itemsize]
        for n in reversed(frame):
            itemstrides.append(itemstrides[-1] * n)
        ringlet_strides = []
        acc = ringlet_stride
        for n in reversed(self.ringlet_shape):
            ringlet_strides.insert(0, acc)
            acc *= n
        shape = tuple(self.ringlet_shape) + (nframe,) + \
            tuple(self.frame_shape)
        strides = tuple(ringlet_strides) + (self.frame_nbyte,) + \
            tuple(reversed(itemstrides[:-1]))
        arr = ndarray(shape=shape, dtype=self.dtype, buffer=data_ptr,
                      strides=strides, space=space)
        arr.bf.ownbuffer = False
        return arr

    def span_array_cached(self, data_ptr, ringlet_stride, nframe, space):
        """`span_array`, one view a (address, stride, nframe, space) for
        this TensorInfo's life: steady streaming cycles through a few
        slots, and the views alias the same bytes."""
        key = (data_ptr, ringlet_stride, nframe, space)
        with self._view_lock:
            arr = self._view_cache.get(key)
            if arr is None:
                if len(self._view_cache) > 64:   # the buffer moved
                    self._view_cache.clear()
                arr = self.span_array(data_ptr, ringlet_stride, nframe,
                                      space)
                self._view_cache[key] = arr
        return arr

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


class _RingInfo(ctypes.Structure):
    """BTPringInfo (csrc/ring_host.h)."""
    _fields_ = [("data", ctypes.c_void_p)] + \
        [(k, ctypes.c_uint64) for k in (
            "capacity", "ghost", "stride", "nringlet", "tail", "head",
            "reserve_head", "intr_fired", "intr_acked", "intr_target")] + \
        [(k, ctypes.c_int32) for k in (
            "nwspan", "writing_ended", "core", "space")]


class _SpanInfo(ctypes.Structure):
    """BTPspanInfo (csrc/ring_host.h)."""
    _fields_ = [("base", ctypes.c_void_p)] + \
        [(k, ctypes.c_uint64) for k in (
            "offset", "size", "capacity", "overwritten")]


_vp = ctypes.c_void_p
_u64 = ctypes.c_uint64
_int = ctypes.c_int
_vpp = ctypes.POINTER(ctypes.c_void_p)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_intp = ctypes.POINTER(ctypes.c_int)
_PROTOS = {
    "btpRingGetLastError": (ctypes.c_char_p, []),
    "btpRingCreate": (_int, [_vpp, ctypes.c_char_p, _int, ctypes.c_char_p]),
    "btpRingDestroy": (_int, [_vp, _vpp]),
    "btpRingFree": (_int, [_vp]),
    "btpRingGetInfo": (_int, [_vp, ctypes.POINTER(_RingInfo)]),
    "btpRingSetAffinity": (_int, [_vp, _int]),
    "btpRingResize": (_int, [_vp, _u64, _u64, _u64, _u64, _int, _intp]),
    "btpRingResizeDone": (_int, [_vp]),
    "btpRingTakeRetired": (_int, [_vp, _vpp]),
    "btpRingBeginWriting": (_int, [_vp]),
    "btpRingEndWriting": (_int, [_vp]),
    "btpRingInterruptGen": (_int, [_vp, _u64, _u64p]),
    "btpRingAckInterrupt": (_int, [_vp, _u64]),
    "btpRingSequenceBegin": (_int, [_vpp, _vp, ctypes.c_char_p, _u64, _u64,
                                    ctypes.c_char_p, _u64]),
    "btpRingSequenceEnd": (_int, [_vp]),
    "btpRingSpanReserve": (_int, [_vpp, _vp, _u64, _int,
                                  ctypes.POINTER(_SpanInfo)]),
    "btpRingSpanCommit": (_int, [_vp, _u64]),
    "btpRingSpanCancel": (_int, [_vp]),
    "btpRingSequenceOpen": (_int, [_vpp, _vp, _int, ctypes.c_char_p, _u64,
                                   _vp, _int, _int, _int]),
    "btpRingSequenceClose": (_int, [_vp]),
    "btpRingSequenceGuaranteeManual": (_int, [_vp, _int]),
    "btpRingSequenceAdvanceGuarantee": (_int, [_vp, _u64]),
    "btpRingSequenceGetInfo": (_int, [_vp, ctypes.POINTER(ctypes.c_char_p),
                                      _u64p, _vpp, _u64p, _u64p, _u64p]),
    "btpRingSequenceIsFinished": (_int, [_vp, _intp, _u64p]),
    "btpRingSpanAcquire": (_int, [_vpp, _vp, _u64, _u64, _int, _int,
                                  ctypes.POINTER(_SpanInfo)]),
    "btpRingSpanRelease": (_int, [_vp]),
}

# Statuses of csrc/ring_host.h (the JAX package's numbering).
STATUS_SUCCESS = 0
STATUS_END_OF_DATA = 1
STATUS_WOULD_BLOCK = 2
STATUS_INVALID_ARGUMENT = 9
STATUS_INVALID_SHAPE = 12
STATUS_MEM_ALLOC_FAILED = 16
STATUS_INTERRUPTED = 32
STATUS_PROGRESS = 35

_lib_lock = threading.Lock()
_lib_obj = None


def _lib():
    """The ring engine's library with its prototypes set (built with the
    host C++ compiler at first use; a failed build raises with the
    compiler's output)."""
    global _lib_obj
    with _lib_lock:
        if _lib_obj is None:
            from . import build
            lib = build.load_host("ring")
            for name, (restype, argtypes) in _PROTOS.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib_obj = lib
        return _lib_obj


def _error(status, what):
    """The exception of a failed engine call (the Python engine's
    exceptions, by status), carrying the engine's `status`."""
    detail = (_lib().btpRingGetLastError() or b"").decode() or what
    if status == STATUS_END_OF_DATA:
        err = EndOfDataStop(what or detail)
    elif status == STATUS_WOULD_BLOCK:
        err = BlockingIOError(f"{what} would block")
    elif status == STATUS_INTERRUPTED:
        err = RingInterrupted(f"{what} interrupted")
    elif status in (STATUS_INVALID_ARGUMENT, STATUS_INVALID_SHAPE):
        err = ValueError(detail)
    elif status == STATUS_MEM_ALLOC_FAILED:
        err = MemoryError(detail)
    else:
        err = RuntimeError(detail or f"ring status {status}")
    err.status = status
    return err


def _check(status, what=""):
    # Raised straight from `_error`'s return: no frame of the traceback
    # keeps the exception in a local, so the frames it holds
    # (generators' among them) go with it rather than with a collection.
    if status != STATUS_SUCCESS:
        raise _error(status, what)


_OPEN_WHICH = {"earliest": 0, "latest": 1, "name": 2, "at": 3, "next": 4}

# One guard for the check-and-set of a span's release and a write span's
# commit or cancel: the engine frees a span's handle at its end, so each
# may run once (the async executor's worker and its block thread race
# here).
_span_guard = threading.Lock()


class _HostBytes(object):
    """`nbyte` bytes of host memory at `ptr` for np.asarray, holding
    `keep` (the buffers that own them) as long as the array lives."""

    def __init__(self, ptr, nbyte, keep):
        self.__array_interface__ = {"data": (int(ptr), False),
                                    "shape": (int(nbyte),),
                                    "typestr": "|u1", "version": 3}
        self._keep = keep


class _EngineBytes(_HostBytes):
    """A host buffer of the engine's (`nbyte` bytes at `ptr`) for
    np.asarray.  The engine owns it until it hands it over (a resize
    retired it, or the ring went); then `owned` is set, and the buffer
    is unpinned and freed when the last view of it goes."""

    def __init__(self, ptr, nbyte):
        super().__init__(ptr, nbyte, None)
        self.ptr = int(ptr)
        self.nbyte = int(nbyte)
        self.owned = False
        self.pinned = False

    def __del__(self):
        if not self.owned or sys.is_finalizing():
            return
        try:
            _free_host(self.ptr, self.pinned)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def _free_host(ptr, pinned):
    if pinned:
        torch.cuda.cudart().cudaHostUnregister(ptr)
    _lib().btpRingFree(ptr)


class Ring(object):
    instance_count = 0

    def __init__(self, space="system", name=None, device=None, core=None):
        self.space = str(Space(space))
        if name is None:
            name = f"ring_{Ring.instance_count}"
        Ring.instance_count += 1
        self.name = name
        if device is None:
            device = "cpu" if self.space == "system" else \
                _device.resolve_device(None)
        self.device = torch.device(device)
        # The Python side's own state: the data view, the CUDA events, the
        # zero-copy side plane.
        self._cond = threading.Condition()
        self._buf = None         # (nringlet, capacity + ghost) uint8 view
        self._cap = 0            # the capacity `_buf` is laid out for
        self._ghost = 0
        self._host = None        # the _EngineBytes under `_buf`
        # Supervision and fault-injection hooks (module docstring).
        self._interrupt_retry = None
        self._progress_hook = None
        self._fault_hook = None
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
        self._obj = ctypes.c_void_p()
        path = self._proclog.path.encode() if self._proclog else None
        _check(_lib().btpRingCreate(ctypes.byref(self._obj), name.encode(),
                                    SPACEMAP[self.space], path))
        if core is not None:
            self.core = core

    def __del__(self):
        # A ring's log goes with it, as the C engine's ring destroys its
        # ProcLog (cpp/src/ring.cpp ~BTring_impl); the name is this
        # ring's alone, so no live ring's log is unlinked.
        obj = getattr(self, "_obj", None)
        # At interpreter exit a daemon thread may still be inside the
        # engine (a capture's recv): the ring and its bytes are left to
        # the process's end rather than freed under it.
        if obj and not sys.is_finalizing():
            try:
                self._take_retired()
                buf = ctypes.c_void_p()
                _lib().btpRingDestroy(obj, ctypes.byref(buf))
                self._obj = None
                self._hand_over(buf.value)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass
        log = getattr(self, "_proclog", None)
        if log is not None:
            log.remove()
        log_name = getattr(self, "log_name", None)
        if log_name is not None:
            _release_log_name(log_name)

    # ----------------------------------------------------------- engine
    def _info(self):
        info = _RingInfo()
        _check(_lib().btpRingGetInfo(self._obj, ctypes.byref(info)))
        return info

    def _blocking(self, call, reader=False):
        """Run a blocking engine call (`call(progress)` -> status) and
        settle its waits (bifrost_tpu/ring.py:50-69): a supervised
        waiter woken by a fire that was not meant for it asks
        `_interrupt_retry`, without any lock, and calls again; a `reader`
        waiting for data is alive while the writer commits, even empty
        spans (an FDMT's warm-up): each commit that does not end its wait
        calls `_progress_hook`, which stamps its heartbeat, and the call
        waits again.  -> the final status."""
        while True:
            hook = self._progress_hook if reader else None
            status = call(1 if hook is not None else 0)
            if status == STATUS_PROGRESS:
                if hook is not None:
                    hook()
                continue
            if status != STATUS_INTERRUPTED:
                return status
            retry = self._interrupt_retry
            if retry is None or not retry():
                return status

    @property
    def core(self):
        """The CPU core whose NUMA node the ring's host bytes prefer (a
        scope's `core`), or None."""
        core = self._info().core
        return None if core < 0 else core

    @core.setter
    def core(self, core):
        _check(_lib().btpRingSetAffinity(
            self._obj, -1 if core is None else int(core)))

    def page_nodes(self):
        """Where the ring's host bytes lie: ({NUMA node: pages}, memory
        policies) (affinity.page_nodes; None where the kernel keeps no
        NUMA maps); ({}, set()) for a 'cuda' ring or one not resized
        yet."""
        from .affinity import page_nodes
        info = self._info()
        if not info.data:
            return {}, set()
        return page_nodes(info.data, info.nringlet * info.stride)

    @property
    def capacity(self):
        return self._info().capacity

    @property
    def ghost(self):
        return self._info().ghost

    @property
    def nringlet(self):
        return self._info().nringlet

    @property
    def tail(self):
        """Earliest valid offset."""
        return self._info().tail

    @property
    def head(self):
        """Committed frontier."""
        return self._info().head

    @property
    def reserve_head(self):
        """Reserved frontier."""
        return self._info().reserve_head

    @property
    def _open_wspans(self):
        """Write spans open (reserved and not yet committed)."""
        return self._info().nwspan

    @property
    def _on_cuda(self):
        return self._buf is not None and self._buf.is_cuda

    # ----------------------------------------------------------- interrupts
    def _intr_pending(self):
        info = self._info()
        return info.intr_fired > info.intr_acked

    def interrupt(self, target=0):
        """Fire a generation-counted interrupt: every blocked caller wakes
        with RingInterrupted until the generation is acknowledged.
        `target` is an opaque token (0: everyone) naming whom the fire is
        for.  -> the fired generation."""
        gen = ctypes.c_uint64()
        _check(_lib().btpRingInterruptGen(self._obj, int(target),
                                          ctypes.byref(gen)))
        return gen.value

    def ack_interrupt(self, gen):
        """Retire every generation <= `gen` (never past the latest fire):
        a later fire stays pending for its own target."""
        _check(_lib().btpRingAckInterrupt(self._obj, int(gen)))

    def interrupt_info(self):
        """-> (fired generation, acked generation, latest fire's target)."""
        info = self._info()
        return info.intr_fired, info.intr_acked, info.intr_target

    def clear_interrupt(self):
        """Retire every generation fired so far (the JAX package's compat
        reset; supervised restarts ack the generation they saw)."""
        _check(_lib().btpRingAckInterrupt(self._obj, 2 ** 64 - 1))

    @property
    def writing_ended(self):
        """Has the writer called `end_writing`?"""
        return bool(self._info().writing_ended)

    # ----------------------------------------------------------- host bytes
    def _hand_over(self, ptr):
        """Take over a host buffer the engine handed out: the view's, if
        it has one (freed with its last view), else freed now (no view,
        so never pinned).  Caller holds no lock of the engine's."""
        if not ptr:
            return
        host = self._host
        if host is not None and host.ptr == ptr:
            host.owned = True
        else:
            _free_host(ptr, False)

    def _take_retired(self):
        ptr = ctypes.c_void_p()
        while True:
            _check(_lib().btpRingTakeRetired(self._obj, ctypes.byref(ptr)))
            if not ptr.value:
                return
            self._hand_over(ptr.value)

    def _ensure_view(self, base):
        """Make `_buf` view the engine's host bytes at `base` (a span's
        base pointer): a resize, in Python or in the capture engine, moves
        them."""
        host = self._host
        if base and (host is None or host.ptr != base):
            self._refresh()

    def _refresh(self):
        """View the engine's current host bytes as the (nringlet, capacity
        + ghost) uint8 tensor `_buf`; a 'cuda_host' ring's bytes are
        registered pinned on a CUDA device, or this raises.  Buffers the
        engine retired are taken over."""
        with self._cond:
            info = self._info()
            self._take_retired()
            host = self._host
            if not info.data or (host is not None and host.ptr == info.data):
                return
            host = _EngineBytes(info.data, info.nringlet * info.stride)
            if self.space == "cuda_host" and self.device.type == "cuda":
                err = torch.cuda.cudart().cudaHostRegister(host.ptr,
                                                           host.nbyte, 0)
                if int(getattr(err, "value", err)) != 0:
                    raise RuntimeError(f"ring {self.name!r}: cannot pin "
                                       f"{host.nbyte} bytes of 'cuda_host' "
                                       f"memory ({err})")
                host.pinned = True
            buf = torch.from_numpy(np.asarray(host)).view(
                int(info.nringlet), int(info.stride))
            if host.pinned and not buf.is_pinned():
                raise RuntimeError(f"ring {self.name!r}: 'cuda_host' bytes "
                                   f"are not pinned after registration")
            self._host, self._buf = host, buf
            self._cap, self._ghost = int(info.capacity), int(info.ghost)

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
        hold = self.space == "cuda"
        changed = ctypes.c_int()
        _check(self._blocking(lambda _p: _lib().btpRingResize(
            self._obj, int(contiguous_bytes), int(total_bytes),
            max(int(nringlet), 1), max(int(align), 1), int(hold),
            ctypes.byref(changed))), f"ring {self.name} resize")
        if not changed.value:
            return
        if not hold:
            self._refresh()
            return
        try:
            self._relayout_device()
        finally:
            _check(_lib().btpRingResizeDone(self._obj))

    def _relayout_device(self):
        """Move a 'cuda' ring's live bytes into a tensor of the engine's new
        geometry, while the engine holds the ring closed."""
        info = self._info()
        cap, ghost, nring = int(info.capacity), int(info.ghost), \
            int(info.nringlet)
        nbuf = alloc_bytes((nring, cap + ghost), self.space, self.device)
        nbuf.zero_()
        old, old_cap = self._buf, self._cap
        if old is not None and info.reserve_head > info.tail:
            if old.is_cuda:
                # Commits in flight on writer streams must land before
                # their bytes move.
                torch.cuda.synchronize(old.device)
            off, hi = int(info.tail), int(info.reserve_head)
            while off < hi:
                run = min(hi - off, old_cap - off % old_cap, cap - off % cap)
                src, dst = off % old_cap, off % cap
                nbuf[:, dst:dst + run].copy_(old[:, src:src + run])
                off += run
            nbuf[:, cap:cap + ghost].copy_(nbuf[:, :ghost])
        if nbuf.is_cuda:
            # The zero fill and copies ran on this thread's stream; the
            # writer's stream must not overtake them.
            torch.cuda.synchronize(nbuf.device)
        with self._cond:
            self._buf, self._cap, self._ghost = nbuf, cap, ghost

    # ------------------------------------------------------------ writing
    def begin_writing(self):
        _check(_lib().btpRingBeginWriting(self._obj))
        return RingWriter(self)

    def end_writing(self):
        _check(_lib().btpRingEndWriting(self._obj))

    def begin_sequence(self, header, gulp_nframe=1, buf_nframe=None):
        return WriteSequence(self, header, gulp_nframe, buf_nframe)

    def _sequence_begin(self, header, nringlet):
        """Open a sequence named and time-tagged by its header -> its
        engine handle."""
        raw = json.dumps(header).encode()
        seq = ctypes.c_void_p()
        _check(_lib().btpRingSequenceBegin(
            ctypes.byref(seq), self._obj,
            str(header.get("name", "")).encode(),
            int(header.get("time_tag", 0)), len(raw), raw, int(nringlet)))
        return seq

    def _sequence_end(self, seq):
        _check(_lib().btpRingSequenceEnd(seq))

    def _reserve(self, size, nonblocking):
        """-> (begin offset, engine span, release events to wait on) of a
        new reservation of `size` bytes."""
        span, info = ctypes.c_void_p(), _SpanInfo()
        _check(self._blocking(lambda _p: _lib().btpRingSpanReserve(
            ctypes.byref(span), self._obj, int(size), int(bool(nonblocking)),
            ctypes.byref(info))), f"ring {self.name}: reserve")
        self._ensure_view(info.base)
        begin = int(info.offset)
        reclaimed = begin + int(size) - int(info.capacity)
        with self._cond:
            while self._commit_events and \
                    self._commit_events[0][1] <= reclaimed:
                self._commit_events.popleft()
            released, self._release_events = self._release_events, []
        return begin, span, released

    def _commit(self, token, begin, size, commit_size, ext=None):
        """Commit `commit_size` bytes of the reservation `token` at
        `begin`; `ext`: (ptr, keepref) of a published payload
        (WriteSpan.publish_external), filed in the side plane instead of
        the ring's bytes.  A 'cuda' ring's ghost mirror and commit event
        are Python's; a host ring's mirror is the engine's."""
        if commit_size > size:
            raise ValueError("commit larger than the reservation")
        if commit_size and ext is not None:
            with self._cond:
                self._plane_put((begin, commit_size) + tuple(ext))
                self.published_spans += 1
        elif commit_size and self.space == "cuda" and self._buf is not None:
            self._sync_ghost(begin, commit_size)
            ev = _device.record_event(self.device) if self._on_cuda \
                else None
            if ev is not None:
                with self._cond:
                    self._commit_events.append((begin, begin + commit_size,
                                                ev))
        _check(self._blocking(lambda _p: _lib().btpRingSpanCommit(
            token, int(commit_size))), f"ring {self.name}: commit")

    # ------------------------------------------------- zero-copy host plane
    def _plane_put(self, entry):
        """File (offset, nbyte, ptr, keepref) in the side plane and expire
        the entries the tail has passed, which pin their buffers
        (bifrost_tpu/ring.py:395-411; caller holds _cond).  Commits come
        in offset order, so this appends."""
        store = self._ext_store
        store.append(entry)
        tail = self.tail
        while store and store[0][0] + store[0][1] <= tail:
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
        _check(_lib().btpRingSpanCancel(token))
        if fence is not None and self._on_cuda:
            with self._cond:
                self._release_events.append(fence)

    def _sync_ghost(self, begin, n):
        """Keep a 'cuda' ring's ghost mirror coherent for newly committed
        bytes (on the committing thread's stream, before the commit
        event)."""
        cap, ghost, buf = self._cap, self._ghost, self._buf
        p = begin % cap
        if p + n > cap:                       # wrote into the ghost
            glen = min(p + n - cap, ghost)
            buf[:, :glen].copy_(buf[:, cap:cap + glen])
        if p < ghost:                         # wrote under the mirror
            hi = min(p + n, cap, ghost)
            buf[:, cap + p:cap + hi].copy_(buf[:, p:hi])

    def _rows(self, begin, size):
        """(nringlet, size) uint8 view of the bytes at `begin`."""
        p = begin % self._cap
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
        if which not in _OPEN_WHICH:
            raise ValueError(f"unknown open mode {which!r}")
        hook = self._fault_hook
        if hook is not None:
            hook("ring.open", self)
        seq = ctypes.c_void_p()
        key = str(name).encode() if name else None
        cur_seq = cur._seq if cur is not None else None
        status = self._blocking(lambda progress: _lib().btpRingSequenceOpen(
            ctypes.byref(seq), self._obj, _OPEN_WHICH[which], key,
            int(time_tag), cur_seq, int(bool(guarantee)),
            int(bool(nonblocking)), progress), reader=True)
        _check(status, f"ring {self.name}: " + (
            "no more sequences" if status == STATUS_END_OF_DATA else "open"))
        return ReadSequence(self, seq, guarantee)

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
    current sequence, and its read guarantee in the engine, stay open
    across the hand-off, and a wait interrupted in `next` leaves the
    position as it was.  `wrap`, where given, maps each opened sequence
    to what the reader sees (a header view's `SequenceView`)."""

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
        begin = ctypes.c_uint64()
        _check(_lib().btpRingSequenceGetInfo(self._seq, None, None, None,
                                             None, None, ctypes.byref(begin)))
        self.begin = begin.value
        self._ended = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()

    def end(self):
        if not self._ended:
            self._ended = True
            self.ring._sequence_end(self._seq)

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

    def wait_ready(self):
        """Block until the work this thread queued for the span has run
        (a 'cuda' ring's span is written on the thread's stream); a host
        span is ready when its writes return."""
        if self.ring._on_cuda:
            _device.stream_synchronize(self.ring.device)

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

    def _claim(self):
        """Take the span's one end (commit or cancel) -> False if it was
        taken already."""
        with _span_guard:
            if self._committed:
                return False
            self._committed = True
            return True

    def commit(self, nframe=None):
        if not self._claim():
            return
        if nframe is None:
            nframe = self.commit_nframe
        try:
            self.ring._commit(self._token, self.offset, self.nbyte,
                              nframe * self.tensor.frame_nbyte, self._ext)
        except BaseException:
            # Still reserved (interrupted, or refused): a later commit or
            # cancel of it must not be a no-op.
            self._committed = False
            raise

    def cancel(self, fence=None):
        """Retire this reservation uncommitted, without the in-order
        commit wait; legal for the ring's final reservation only (a batch
        is cancelled newest first).  `fence`: an event recorded after the
        stream work that may still write these bytes (module docstring).
        A committed span is left as it is."""
        if not self._claim():
            return
        try:
            self.ring._cancel(self._token, self.offset, self.nbyte, fence)
        except BaseException:
            self._committed = False
            raise

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        self.commit(None if exc_type is None else 0)


class ReadSequence(object):
    def __init__(self, ring, seq, guarantee):
        self.ring = ring
        self._seq = seq               # the engine's read-sequence handle
        self.guarantee = guarantee
        name, hdr = ctypes.c_char_p(), ctypes.c_void_p()
        time_tag, hdr_size, nring, begin = (ctypes.c_uint64()
                                            for _ in range(4))
        _check(_lib().btpRingSequenceGetInfo(
            seq, ctypes.byref(name), ctypes.byref(time_tag),
            ctypes.byref(hdr), ctypes.byref(hdr_size), ctypes.byref(nring),
            ctypes.byref(begin)))
        self.name = name.value.decode() if name.value else ""
        self.time_tag = time_tag.value
        self.begin = begin.value
        raw = ctypes.string_at(hdr.value, hdr_size.value) \
            if hdr.value and hdr_size.value else b""
        self.header = json.loads(raw.decode()) if raw else {}
        self.tensor = TensorInfo(self.header) \
            if "_tensor" in self.header else None
        self._closed = False
        self._open_spans = []

    @property
    def finished(self):
        """Has the writer ended this sequence?"""
        fin = ctypes.c_int()
        _check(_lib().btpRingSequenceIsFinished(self._seq, ctypes.byref(fin),
                                                None))
        return bool(fin.value)

    def set_guarantee_manual(self, manual=True):
        """Stop span acquires from moving this reader's guarantee forward;
        the reader moves it itself with `advance_guarantee` (the async
        gulp executor acquires ahead of the gulps its worker still
        reads; bifrost_tpu/ring.py:835-842)."""
        _check(_lib().btpRingSequenceGuaranteeManual(self._seq,
                                                     int(bool(manual))))

    def advance_guarantee(self, offset):
        """Move this reader's guarantee forward to byte `offset`: the
        bytes before it become the writer's to reclaim."""
        _check(_lib().btpRingSequenceAdvanceGuarantee(self._seq,
                                                      int(offset)))

    def close(self):
        # Outstanding spans release before the guarantee goes away.
        for span in list(self._open_spans):
            span.release()
        with _span_guard:
            if self._closed:
                return
            self._closed = True
        _check(_lib().btpRingSequenceClose(self._seq))

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
        """-> (bytes available, bytes overwritten, commit events to wait
        on, the engine's span) at `offset`."""
        ring = self.ring
        span, info = ctypes.c_void_p(), _SpanInfo()
        status = ring._blocking(lambda progress: _lib().btpRingSpanAcquire(
            ctypes.byref(span), self._seq, int(offset), int(size),
            int(bool(nonblocking)), progress, ctypes.byref(info)),
            reader=True)
        _check(status, "sequence exhausted" if status == STATUS_END_OF_DATA
               else f"ring {ring.name}: acquire")
        ring._ensure_view(info.base)
        eff = int(info.size)
        waits = []
        if ring._commit_events:
            with ring._cond:
                waits = [ev for (b, e, ev) in ring._commit_events
                         if b < offset + eff and e > offset]
        return eff, int(info.overwritten), waits, span

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
        eff, overwritten, waits, self._obj = rseq._acquire(offset, size,
                                                           nonblocking)
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
        with _span_guard:
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
        if ev is not None:
            with ring._cond:
                ring._release_events.append(ev)
        _check(_lib().btpRingSpanRelease(self._obj))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
