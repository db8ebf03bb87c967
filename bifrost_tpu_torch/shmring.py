"""Named cross-process shared-memory ring: the inter-process data path
(counterpart of bifrost_tpu/shmring.py).

The engine is host C++ (``csrc/shmring.cpp``), the port's own copy of the
JAX package's, built by `build.load_host('shmring')` at first use and
called through ``ctypes.CDLL``, so the blocking waits run without the
GIL.  The ring's control state lives in the POSIX shm segment itself, so a
second process attaches by name alone, and the segment's layout is the JAX
engine's: a writer of either package and a reader of the other share one
ring.  Sequences carry the same JSON `_tensor` headers as in-process
rings, so a pipeline hands a stream to another process with its metadata
(blocks/shmring.py wires this into a sink and a source block).
"""

from __future__ import annotations

import ctypes
import json
import time

import numpy as np

from .ring import EndOfDataStop, RingInterrupted

__all__ = ["ShmRingWriter", "ShmRingReader", "ShmRingError", "ShmPeerDied",
           "unlink"]

STATUS_SUCCESS = 0
STATUS_END_OF_DATA = 1
STATUS_INSUFFICIENT_SPACE = 18
STATUS_INTERRUPTED = 32
STATUS_PEER_DIED = 41

_u64 = ctypes.c_uint64
_vp = ctypes.c_void_p
_PROTOS = {
    "btGetLastError": (ctypes.c_char_p, []),
    "btShmRingCreate": (ctypes.c_int, [ctypes.POINTER(_vp), ctypes.c_char_p,
                                       _u64, _u64]),
    "btShmRingAttach": (ctypes.c_int, [ctypes.POINTER(_vp),
                                       ctypes.c_char_p]),
    "btShmRingClose": (ctypes.c_int, [_vp]),
    "btShmRingUnlink": (ctypes.c_int, [ctypes.c_char_p]),
    "btShmRingInterrupt": (ctypes.c_int, [_vp]),
    "btShmRingAckInterrupt": (ctypes.c_int, [_vp]),
    "btShmRingSequenceBegin": (ctypes.c_int, [_vp, _u64, ctypes.c_char_p,
                                              _u64]),
    "btShmRingSequenceEnd": (ctypes.c_int, [_vp]),
    "btShmRingEndWriting": (ctypes.c_int, [_vp]),
    "btShmRingWrite": (ctypes.c_int, [_vp, _vp, _u64]),
    "btShmRingWriteReserve": (ctypes.c_int, [_vp, _u64,
                                             ctypes.POINTER(_vp),
                                             ctypes.POINTER(_u64)]),
    "btShmRingWriteCommit": (ctypes.c_int, [_vp, _u64]),
    "btShmRingNumReaders": (ctypes.c_int, [_vp,
                                           ctypes.POINTER(ctypes.c_int)]),
    "btShmRingReaderOpen": (ctypes.c_int, [_vp,
                                           ctypes.POINTER(ctypes.c_int)]),
    "btShmRingReaderClose": (ctypes.c_int, [_vp, ctypes.c_int]),
    "btShmRingReadSequence": (ctypes.c_int, [_vp, ctypes.c_int, _vp, _u64,
                                             ctypes.POINTER(_u64),
                                             ctypes.POINTER(_u64)]),
    "btShmRingRead": (ctypes.c_int, [_vp, ctypes.c_int, _vp, _u64,
                                     ctypes.POINTER(_u64)]),
}

_lib = None


def _bt():
    """The engine's library, built and bound at first use."""
    global _lib
    if _lib is None:
        from . import build
        lib = build.load_host("shmring")
        for name, (res, args) in _PROTOS.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
    return _lib


class ShmRingError(RuntimeError):
    """A failed shm ring call: `status` is the engine's code."""

    def __init__(self, status, detail=""):
        self.status = status
        super().__init__(f"shm ring status {status}: {detail}" if detail
                         else f"shm ring status {status}")


class ShmPeerDied(RuntimeError):
    """The ring's peer process died mid-stream: failure detected, not the
    normal end of data."""


def _check(status):
    if status == STATUS_SUCCESS:
        return
    detail = (_bt().btGetLastError() or b"").decode()
    if status == STATUS_END_OF_DATA:
        raise EndOfDataStop(detail or "shm ring writing ended")
    if status == STATUS_INTERRUPTED:
        raise RingInterrupted(detail or "shm ring interrupted")
    if status == STATUS_PEER_DIED:
        raise ShmPeerDied(detail or "shm ring peer died")
    raise ShmRingError(status, detail)


def unlink(name):
    """Remove the shm name (attached processes keep their mapping)."""
    _check(_bt().btShmRingUnlink(name.encode()))


class ShmRingWriter(object):
    """Create a named shm ring and stream sequences into it."""

    def __init__(self, name, data_capacity=1 << 24, hdr_capacity=1 << 16):
        self.name = name
        self.data_capacity = int(data_capacity)
        obj = _vp()
        _check(_bt().btShmRingCreate(ctypes.byref(obj), name.encode(),
                                     _u64(self.data_capacity),
                                     _u64(hdr_capacity)))
        self.obj = obj
        self._closed = False

    def num_readers(self):
        n = ctypes.c_int()
        _check(_bt().btShmRingNumReaders(self.obj, ctypes.byref(n)))
        return n.value

    def wait_for_readers(self, n=1, timeout=30.0, poll=0.01):
        """Block until at least n readers are attached (a producer that
        must deliver every frame; without it the writer free-runs past
        absent readers)."""
        deadline = time.monotonic() + timeout
        while self.num_readers() < n:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"shm ring {self.name}: {self.num_readers()}/{n} "
                    f"readers after {timeout}s")
            time.sleep(poll)

    def begin_sequence(self, header, time_tag=None):
        """header: a JSON-serializable dict (the `_tensor` convention)."""
        if time_tag is None:
            time_tag = int(header.get("time_tag", 0))
        blob = json.dumps(header).encode()
        _check(_bt().btShmRingSequenceBegin(self.obj, _u64(time_tag), blob,
                                            _u64(len(blob))))

    def write(self, arr):
        a = np.ascontiguousarray(arr)
        _check(_bt().btShmRingWrite(self.obj, a.ctypes.data_as(_vp),
                                    _u64(a.nbytes)))

    def reserve_view(self, max_nbyte):
        """A writable np.uint8 view of up to `max_nbyte` contiguous free
        bytes at the ring's head (shorter at the capacity wrap or under
        partial back-pressure: loop).  Blocks on back-pressure as `write`
        does; publish the filled bytes with `commit_view(n)`.  The egress
        plane lands a gulp in the shared segment through this pair."""
        ptr = _vp()
        got = _u64()
        _check(_bt().btShmRingWriteReserve(self.obj, _u64(int(max_nbyte)),
                                           ctypes.byref(ptr),
                                           ctypes.byref(got)))
        n = int(got.value)
        if n == 0:
            return np.empty(0, np.uint8)
        return np.ctypeslib.as_array(
            (ctypes.c_uint8 * n).from_address(ptr.value))

    def commit_view(self, nbyte):
        """Publish `nbyte` bytes filled through `reserve_view`."""
        _check(_bt().btShmRingWriteCommit(self.obj, _u64(int(nbyte))))

    def end_sequence(self):
        _check(_bt().btShmRingSequenceEnd(self.obj))

    def end_writing(self):
        _check(_bt().btShmRingEndWriting(self.obj))

    def interrupt(self):
        """Wake this handle's blocked calls (this process only)."""
        _bt().btShmRingInterrupt(self.obj)

    def clear_interrupt(self):
        """Retire this handle's fired interrupts so that blocking calls
        work again (the supervised restart of a shm block)."""
        _bt().btShmRingAckInterrupt(self.obj)

    def close(self, unlink=True):
        if not self._closed:
            self._closed = True
            _bt().btShmRingClose(self.obj)
            if unlink:
                _bt().btShmRingUnlink(self.name.encode())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end_writing()
        self.close()


class ShmRingReader(object):
    """Attach to a named shm ring (typically from another process)."""

    def __init__(self, name, header_cap=1 << 16, attach_timeout=30.0):
        self.name = name
        obj = _vp()
        deadline = time.monotonic() + attach_timeout
        while True:
            status = _bt().btShmRingAttach(ctypes.byref(obj), name.encode())
            if status == STATUS_SUCCESS:
                break
            if time.monotonic() > deadline:
                _check(status)   # raise with the engine's message
            time.sleep(0.02)     # the creator may not have made it yet
        self.obj = obj
        slot = ctypes.c_int()
        try:
            _check(_bt().btShmRingReaderOpen(self.obj, ctypes.byref(slot)))
        except Exception:
            _bt().btShmRingClose(self.obj)
            raise
        self.slot = slot.value
        self._hdr_buf = ctypes.create_string_buffer(header_cap)
        self._closed = False

    def read_sequence(self):
        """-> (header dict, time_tag); raises EndOfDataStop when done."""
        hdr_size = _u64()
        time_tag = _u64()
        while True:
            status = _bt().btShmRingReadSequence(
                self.obj, self.slot, self._hdr_buf, _u64(len(self._hdr_buf)),
                ctypes.byref(hdr_size), ctypes.byref(time_tag))
            if status != STATUS_INSUFFICIENT_SPACE:
                break
            # The writer's header is larger than this buffer: the engine
            # refused without consuming it, so grow and ask again.
            self._hdr_buf = ctypes.create_string_buffer(hdr_size.value)
        _check(status)
        raw = self._hdr_buf.raw[:hdr_size.value]
        return (json.loads(raw.decode()) if raw else {}), time_tag.value

    def readinto(self, arr):
        """Fill `arr` (or as much as the sequence holds); -> bytes read (0
        at the sequence's end); raises EndOfDataStop when writing ended."""
        if not isinstance(arr, np.ndarray):
            raise TypeError(
                "readinto requires a writable numpy array (a converted "
                "temporary would discard the data)")
        if not arr.flags.c_contiguous or not arr.flags.writeable:
            raise ValueError("readinto requires a C-contiguous writable "
                             "array")
        nread = _u64()
        total = 0
        view = arr.view(np.uint8).reshape(-1)
        base = view.ctypes.data
        while total < arr.nbytes:
            status = _bt().btShmRingRead(self.obj, self.slot,
                                         _vp(base + total),
                                         _u64(arr.nbytes - total),
                                         ctypes.byref(nread))
            if status == STATUS_END_OF_DATA:
                if total:
                    return total
                raise EndOfDataStop("shm ring writing ended")
            _check(status)
            if nread.value == 0:
                return total     # the sequence ended
            total += nread.value
        return total

    def sequences(self):
        """Generator over (header, time_tag) until writing ends."""
        while True:
            try:
                yield self.read_sequence()
            except EndOfDataStop:
                return

    def interrupt(self):
        """Wake this handle's blocked calls (this process only)."""
        _bt().btShmRingInterrupt(self.obj)

    def clear_interrupt(self):
        """Retire this handle's fired interrupts (see the writer's)."""
        _bt().btShmRingAckInterrupt(self.obj)

    def close(self):
        if not self._closed:
            self._closed = True
            _bt().btShmRingReaderClose(self.obj, ctypes.c_int(self.slot))
            _bt().btShmRingClose(self.obj)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
