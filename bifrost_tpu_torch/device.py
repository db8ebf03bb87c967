"""Device management: the torch device a pipeline runs on, a CUDA stream
per block thread, and event-based completion tracking (counterpart of
bifrost_tpu/device.py).

Entry points run on the card: with no device named, `resolve_device`
returns ``torch.device('cuda')`` and raises where there is none.  The
CPU is used only when a caller asks for it (``device='cpu'``), as the
tests do.  There is no fallback from one to the other.

Completion tracking: the JAX package keeps a per-thread registry of
in-flight ``jax.Array`` futures.  Here every block thread owns a CUDA
stream (`block_stream`); `stream_record` records an event on it and
`stream_synchronize` waits for the thread's recorded events and stream.

Dispatch discipline (bifrost_tpu/device.py:19,59-146): `dispatch_lock()`
is the scope of a block's device work.  Under the `serialize_dispatch`
flag it is one process-wide lock, so one block's device scope runs at a
time; under `strict_sync` (`needs_strict_sync`) a block synchronises its
stream before the scope ends, so nothing is left in flight.  Both are
off by default.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_tls = threading.local()
_dispatch_lock = threading.RLock()


def resolve_device(device=None):
    """-> torch.device.  None means the card; a CUDA device that is not
    there raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "bifrost_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def get_devices():
    """The devices the port runs on: every CUDA device, or the CPU alone
    where this thread was bound to it (`set_device('cpu')`); empty with
    neither."""
    bound = getattr(_tls, "device", None)
    if bound is not None and bound.type == "cpu":
        return [bound]
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def device_count():
    return len(get_devices())


def set_device(device):
    """Bind this thread to `device` (tensors that ops create from host
    input land there)."""
    _tls.device = resolve_device(device)
    if _tls.device.type == "cuda":
        torch.cuda.set_device(_tls.device)


def get_device():
    dev = getattr(_tls, "device", None)
    if dev is None:
        dev = _tls.device = resolve_device(None)
    return dev


@contextlib.contextmanager
def block_stream(device):
    """Run the body on a fresh CUDA stream of `device` (one per block
    thread), or as is on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        yield None
        return
    with torch.cuda.device(device):
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            yield stream


def record_event(device):
    """An event recorded on `device`'s current stream (None on the CPU,
    where work is done when the call returns)."""
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def wait_event(event, device):
    """Order `device`'s current stream after `event`."""
    if event is not None:
        torch.cuda.current_stream(device).wait_event(event)


def stream_record(device):
    """Record an event on this thread's stream and track it."""
    ev = record_event(device)
    if ev is not None:
        pend = getattr(_tls, "pending", None)
        if pend is None:
            pend = _tls.pending = []
        pend.append(ev)
        if len(pend) > 64:
            for e in pend[:-16]:
                e.synchronize()
            del pend[:-16]
    return ev


def stream_synchronize(device=None):
    """Block until this thread's recorded events and its current stream
    on `device` have completed."""
    pend = getattr(_tls, "pending", None)
    if pend:
        for e in pend:
            e.synchronize()
        pend.clear()
    device = torch.device(device) if device is not None else \
        getattr(_tls, "device", None)
    if device is not None and device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def needs_serialized_dispatch():
    """One block's device scope at a time?  (The `serialize_dispatch`
    flag; the port has no backend that needs it by default.)"""
    from . import config
    return bool(config.get("serialize_dispatch"))


def needs_strict_sync():
    """Leave nothing in flight when a block's device scope ends?  (The
    `strict_sync` flag.)"""
    from . import config
    return bool(config.get("strict_sync"))


@contextlib.contextmanager
def dispatch_lock():
    """Scope of a block's device work: the process-wide lock under
    `serialize_dispatch`, else nothing."""
    if needs_serialized_dispatch():
        with _dispatch_lock:
            yield
    else:
        yield


class ExternalStream(object):
    """Issue this thread's port work on a stream someone else owns
    (reference device.py:63-90): `stream` is a `torch.cuda.Stream` or a
    raw `cudaStream_t` address.  Inside the scope the stream is the
    thread's current one, so every op and block the thread runs there
    queues on it; on exit the scope synchronizes it.  With no stream
    (the JAX package's form) the scope only synchronizes the thread's
    work on exit."""

    def __init__(self, stream=None, device=None):
        if stream is not None and not isinstance(stream, torch.cuda.Stream):
            if not torch.cuda.is_available():
                raise RuntimeError("ExternalStream: a cudaStream_t needs "
                                   "a CUDA device, and none is available")
            stream = torch.cuda.ExternalStream(
                int(stream), device=resolve_device(device))
        self.stream = stream
        self._ctx = None

    def __enter__(self):
        if self.stream is not None:
            self._ctx = torch.cuda.stream(self.stream)
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            if self.stream is not None:
                self.stream.synchronize()
            else:
                stream_synchronize()
        finally:
            if self._ctx is not None:
                self._ctx.__exit__(*exc)
                self._ctx = None
        return False
