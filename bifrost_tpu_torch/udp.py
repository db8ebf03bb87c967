"""The UDP data plane of the port (counterpart of bifrost_tpu/udp.py;
reference: python/bifrost/udp_socket.py, udp_capture.py,
udp_transmit.py): sockets, packet capture into a ring, and packet
transmit with a paced replay schedule walker.

The engines are host C++ (``csrc/socket.cpp``, ``udp_capture.cpp``,
``udp_transmit.cpp``), the port's own copies of the JAX package's, built
by `build.load_host('udp')` at first use and called through
``ctypes.CDLL``, so the capture loop and the walker run without the GIL.

The capture engine scatters packet payloads into two consecutive ring
write spans (the reorder window), reserving and committing them through
the port's ring engine (``csrc/ring.cpp``, ring.py) from C, as the JAX
engine does: a `recv` enters Python only at a sequence boundary, for the
JSON header (the one callback).  A ring wait woken by an interrupt
unwinds the engine with status 32, which `recv` (or
`end_sequence`/`end`) raises as `RingInterrupted`.  The engine writes
the throttled `udp_capture_<ring>/stats` log of the JAX engine, with its
keys and cadence (every 16,384 good payloads, at each sequence end and
at teardown).  The capture ring must hold host memory ('system'): the
engine writes it.
"""

from __future__ import annotations

import ctypes
import json
import logging
import struct
import sys
import threading
import time

from .ring import RingInterrupted

__all__ = ["UDPSocket", "UDPCapture", "UDPTransmit", "UDPError",
           "TRANSMIT_RECORD_DTYPE", "pack_transmit_records",
           "batch_support", "set_core", "reuseport_senders"]

_log = logging.getLogger("bifrost_tpu_torch.udp")

STATUS_SUCCESS = 0
STATUS_WOULD_BLOCK = 2
STATUS_INTERRUPTED = 32

# numpy dtype of one packed schedule record (BTPtransmitRecord,
# csrc/udp_host.h): byte offset into the payload slab, datagram size,
# reserved flags, send time in ns after the schedule's start.
TRANSMIT_RECORD_DTYPE = [("offset", "<u8"), ("size", "<u4"),
                         ("flags", "<u4"), ("t_ns", "<u8")]
_RECORD_NBYTE = 24

_u64 = ctypes.c_uint64
_u64p = ctypes.POINTER(ctypes.c_uint64)
_intp = ctypes.POINTER(ctypes.c_int)
_uintp = ctypes.POINTER(ctypes.c_uint)
_voidpp = ctypes.POINTER(ctypes.c_void_p)
_vp = ctypes.c_void_p

# Sequence callback: (seq0, *time_tag, **hdr, *hdr_size, user) -> int
SEQUENCE_CALLBACK = ctypes.CFUNCTYPE(ctypes.c_int, _u64, _u64p, _voidpp,
                                     _u64p, _vp)


_PROTOS = {
    "btpGetLastError": (ctypes.c_char_p, []),
    "btpAffinitySetCore": (ctypes.c_int, [ctypes.c_int]),
    "btpSocketCreate": (ctypes.c_int, [_voidpp]),
    "btpSocketDestroy": (ctypes.c_int, [_vp]),
    "btpSocketEnableReuseport": (ctypes.c_int, [_vp]),
    "btpSocketBind": (ctypes.c_int, [_vp, ctypes.c_char_p, ctypes.c_int]),
    "btpSocketConnect": (ctypes.c_int, [_vp, ctypes.c_char_p, ctypes.c_int]),
    "btpSocketShutdown": (ctypes.c_int, [_vp]),
    "btpSocketSetTimeout": (ctypes.c_int, [_vp, ctypes.c_double]),
    "btpSocketGetTimeout": (ctypes.c_int,
                            [_vp, ctypes.POINTER(ctypes.c_double)]),
    "btpSocketGetMTU": (ctypes.c_int, [_vp, _intp]),
    "btpSocketGetFD": (ctypes.c_int, [_vp, _intp]),
    "btpSocketBatchSupport": (ctypes.c_int, [_intp, _intp]),
    "btpUdpCaptureCreate": (ctypes.c_int,
                            [_voidpp, ctypes.c_char_p, _vp, _vp, _u64,
                             _u64, _u64, _u64, _u64, SEQUENCE_CALLBACK, _vp,
                             ctypes.c_int, ctypes.c_char_p]),
    "btpUdpCaptureDestroy": (ctypes.c_int, [_vp]),
    "btpUdpCaptureSetBatch": (ctypes.c_int, [_vp, ctypes.c_uint]),
    "btpUdpCaptureGetBatch": (ctypes.c_int, [_vp, _uintp]),
    "btpUdpCaptureRecv": (ctypes.c_int, [_vp, _intp]),
    "btpUdpCaptureSequenceEnd": (ctypes.c_int, [_vp]),
    "btpUdpCaptureEnd": (ctypes.c_int, [_vp]),
    "btpUdpCaptureGetStats": (ctypes.c_int, [_vp] + [_u64p] * 5),
    "btpUdpCaptureGetWindows": (ctypes.c_int, [_vp, _u64p]),
    "btpUdpTransmitCreate": (ctypes.c_int, [_voidpp, _vp, ctypes.c_int]),
    "btpUdpTransmitDestroy": (ctypes.c_int, [_vp]),
    "btpUdpTransmitSend": (ctypes.c_int, [_vp, ctypes.c_char_p,
                                          ctypes.c_uint]),
    "btpUdpTransmitSendMany": (ctypes.c_int, [_vp, _vp, ctypes.c_uint,
                                              ctypes.c_uint, _uintp]),
    "btpUdpTransmitScheduleRun": (ctypes.c_int, [_vp, _vp, _u64, _vp, _u64,
                                                 ctypes.c_uint]),
    "btpUdpTransmitScheduleWait": (ctypes.c_int, [_vp]),
    "btpUdpTransmitScheduleStop": (ctypes.c_int, [_vp]),
    "btpUdpTransmitScheduleStats": (ctypes.c_int,
                                    [_vp] + [_u64p] * 4 + [_intp]),
}

_lib_lock = threading.Lock()
_lib_obj = None


def _lib():
    """The UDP host library with its prototypes set (built at first
    use; a failed build raises with the compiler's output)."""
    global _lib_obj
    with _lib_lock:
        if _lib_obj is None:
            from . import build
            lib = build.load_host("udp")
            for name, (restype, argtypes) in _PROTOS.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib_obj = lib
        return _lib_obj


class UDPError(RuntimeError):
    """A failed call into the UDP engines: `status` and the engine's
    detail."""

    def __init__(self, status, detail=""):
        self.status = status
        super().__init__(f"status {status}" + (f": {detail}" if detail
                                                else ""))


def _check(status):
    if status == STATUS_SUCCESS:
        return
    if status == STATUS_WOULD_BLOCK:
        raise IOError("would block")
    detail = (_lib().btpGetLastError() or b"").decode()
    if status == STATUS_INTERRUPTED:
        raise RingInterrupted(detail or "ring interrupted")
    raise UDPError(status, detail)


class _Native(object):
    """Owner of one native handle, destroyed at close()."""

    _destroy = None

    def __init__(self):
        self.obj = ctypes.c_void_p()
        self._destroyed = False

    def close(self):
        if not self._destroyed and self.obj:
            getattr(_lib(), self._destroy)(self.obj)
            self._destroyed = True

    def __del__(self):
        if sys.is_finalizing():
            return    # a daemon thread may still be inside the engine
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def batch_support():
    """Probed batch-syscall availability:
    ``{'recvmmsg': 1|0|-1, 'sendmmsg': 1|0|-1}`` (1 = batched path, 0 =
    per-packet fallback latched, -1 = not probed yet)."""
    rx, tx = ctypes.c_int(-1), ctypes.c_int(-1)
    _check(_lib().btpSocketBatchSupport(ctypes.byref(rx), ctypes.byref(tx)))
    return {"recvmmsg": rx.value, "sendmmsg": tx.value}


def set_core(core):
    """Pin the calling thread to one core (-1: all online cores) with the
    engines' own affinity call; a failure raises ValueError naming the
    core."""
    core = int(core)
    try:
        _check(_lib().btpAffinitySetCore(core))
    except UDPError as e:
        raise ValueError(f"cannot pin thread to core {core}: {e}") from None


def pack_transmit_records(entries):
    """Pack ``(offset, size, t_ns)`` tuples into the record buffer
    `UDPTransmit.start_schedule` takes (a numpy array of
    TRANSMIT_RECORD_DTYPE does the same for large schedules)."""
    rec = struct.Struct("<QIIQ")
    return b"".join(rec.pack(int(o), int(s), 0, int(t))
                    for (o, s, t) in entries)


class UDPSocket(_Native):
    _destroy = "btpSocketDestroy"

    def __init__(self):
        super().__init__()
        _check(_lib().btpSocketCreate(ctypes.byref(self.obj)))

    def bind(self, address, port, reuseport=False):
        """Bind; `reuseport=True` enables SO_REUSEPORT fanout first, so
        several captures split one stream by the kernel's flow hash."""
        if reuseport:
            _check(_lib().btpSocketEnableReuseport(self.obj))
        _check(_lib().btpSocketBind(self.obj, str(address).encode(),
                                    int(port)))
        return self

    def connect(self, address, port):
        _check(_lib().btpSocketConnect(self.obj, str(address).encode(),
                                       int(port)))
        return self

    def set_timeout(self, secs):
        _check(_lib().btpSocketSetTimeout(self.obj, float(secs)))
        return self

    def get_timeout(self):
        val = ctypes.c_double()
        _check(_lib().btpSocketGetTimeout(self.obj, ctypes.byref(val)))
        return val.value

    @property
    def mtu(self):
        val = ctypes.c_int()
        _check(_lib().btpSocketGetMTU(self.obj, ctypes.byref(val)))
        return val.value

    def fileno(self):
        val = ctypes.c_int()
        _check(_lib().btpSocketGetFD(self.obj, ctypes.byref(val)))
        return val.value

    def getsockname(self):
        """(address, port) the socket is bound to, read through a
        duplicated fd so this socket's ownership is left alone."""
        import os
        import socket as pysock
        s = pysock.socket(fileno=os.dup(self.fileno()))
        try:
            return s.getsockname()[:2]
        finally:
            s.close()

    @property
    def port(self):
        return self.getsockname()[1]

    def shutdown(self):
        _check(_lib().btpSocketShutdown(self.obj))


class UDPCapture(_Native):
    """Packet -> ring capture engine (bifrost_tpu/udp.py:UDPCapture).

    `header_callback(seq0) -> (time_tag, header_dict)` supplies the
    sequence header when a packet sequence begins.  `.stats` polls the
    packet counters (ngood/nmissing/ninvalid/nlate/nrepeat); with
    `stats_name=` every sequence boundary (and `end_sequence`/`end`/
    `close`) also writes them, with byte totals, to a
    `<stats_name>/packet_stats` ProcLog and tracks their deltas in
    telemetry ('udp:ngood', ...), which `proclog.capture_metrics` and
    `Service.health()` read.  The engine itself writes the JAX engine's
    throttled `udp_capture_<ring log name>/stats` log, which goes with
    the engine at `close`.
    """

    _destroy = "btpUdpCaptureDestroy"

    def __init__(self, fmt, sock, ring, nsrc, src0, max_payload_size,
                 buffer_ntime, slot_ntime, header_callback=None, core=-1,
                 stats_name=None, batch_npkt=None):
        super().__init__()
        if ring.space != "system":
            raise ValueError(f"UDPCapture writes host memory: ring "
                             f"{ring.name!r} must be in the 'system' "
                             f"space, not {ring.space!r}")
        from .proclog import ProcLog
        self.sock = sock
        self.ring = ring
        self.payload_size = int(max_payload_size)
        self.nsequence = 0       # sequences begun (callback invocations)
        self.last_seq0 = None
        self._stats_proclog = None
        self._stats_last = dict.fromkeys(
            ("ngood", "nmissing", "ninvalid", "nlate", "nrepeat"), 0)
        if stats_name is not None:
            self._stats_proclog = ProcLog(f"{stats_name}/packet_stats")
        try:
            self._engine_log = ProcLog(f"udp_capture_{ring.log_name}/stats")
        except OSError:
            self._engine_log = None       # the log is best-effort
        # Header buffers keyed by seq0: the engine may hold a header
        # pointer until the NEXT sequence callback or its destruction, so
        # the current and the previous sequence's buffers are kept (a
        # single slot overwritten per sequence would free a header the
        # engine may still read; keeping all would leak in a 24/7 run).
        self._hdr_bufs = {}
        self._hdr_error = None

        def _cb(seq0, time_tag_p, hdr_pp, hdr_size_p, user):
            try:
                if header_callback is None:
                    time_tag, hdr = seq0, {}
                else:
                    time_tag, hdr = header_callback(seq0)
                raw = json.dumps(hdr).encode()
                buf = ctypes.create_string_buffer(raw, len(raw))
                self._hdr_bufs[int(seq0)] = buf
                while len(self._hdr_bufs) > 2:  # keep current + previous
                    self._hdr_bufs.pop(next(iter(self._hdr_bufs)))
                time_tag_p[0] = int(time_tag)
                hdr_pp[0] = ctypes.cast(buf, ctypes.c_void_p)
                hdr_size_p[0] = len(raw)
                self.nsequence += 1
                self.last_seq0 = int(seq0)
                self.publish_stats()
                return 0
            except Exception as e:  # noqa: BLE001 — chained by recv
                self._hdr_error = e
                return -1

        self._c_callback = SEQUENCE_CALLBACK(_cb)
        _check(_lib().btpUdpCaptureCreate(
            ctypes.byref(self.obj), str(fmt).encode(), sock.obj, ring._obj,
            int(nsrc), int(src0), int(max_payload_size), int(buffer_ntime),
            int(slot_ntime), self._c_callback, None, int(core),
            self._engine_log.path.encode() if self._engine_log else None))
        if batch_npkt is not None:
            _check(_lib().btpUdpCaptureSetBatch(self.obj, int(batch_npkt)))

    def _call(self, fn, *args):
        status = fn(self.obj, *args)
        hdr_err, self._hdr_error = self._hdr_error, None
        try:
            _check(status)
        except UDPError as e:
            if hdr_err is None:
                raise
            raise e from hdr_err    # the header callback's own error

    @property
    def nwindow(self):
        """Slot windows the engine has committed to the ring so far."""
        val = ctypes.c_uint64()
        _check(_lib().btpUdpCaptureGetWindows(self.obj, ctypes.byref(val)))
        return val.value

    @property
    def batch_npkt(self):
        """recvmmsg packets per socket call (the `capture_batch_npkt`
        config flag's knob)."""
        val = ctypes.c_uint()
        _check(_lib().btpUdpCaptureGetBatch(self.obj, ctypes.byref(val)))
        return val.value

    def recv(self):
        """Run the capture loop for one window.  -> 0 (started a new
        sequence), 1 (continued one) or 3 (would block / socket timeout).

        Raises RingInterrupted when a ring wait inside the engine (the
        reserve under back-pressure, the in-order commit) was woken by an
        interrupt: the supervised-restart and shutdown seam."""
        res = ctypes.c_int()
        self._call(_lib().btpUdpCaptureRecv, ctypes.byref(res))
        return res.value

    def end_sequence(self):
        """End ONLY the current packet sequence: readers see its end and
        wait for the next; the next packet begins a fresh one (the
        supervised-restart seam).  `end()` also ends the writing, which
        readers see as the end of the stream."""
        self._call(_lib().btpUdpCaptureSequenceEnd)
        self.publish_stats()

    def end(self):
        self._call(_lib().btpUdpCaptureEnd)
        self.publish_stats()
        self._hdr_bufs.clear()     # the engine holds no header any more

    def close(self):
        if getattr(self, "obj", None) and not self._destroyed:
            try:
                self.publish_stats()
            except Exception:  # noqa: BLE001 — observability only
                pass
        super().close()
        self._hdr_bufs.clear()
        log = getattr(self, "_engine_log", None)
        if log is not None and self._destroyed:
            log.remove()       # as the JAX engine destroys its stats log

    @property
    def stats(self):
        vals = [ctypes.c_uint64() for _ in range(5)]
        _check(_lib().btpUdpCaptureGetStats(
            self.obj, *[ctypes.byref(v) for v in vals]))
        keys = ("ngood", "nmissing", "ninvalid", "nlate", "nrepeat")
        return dict(zip(keys, (v.value for v in vals)))

    def publish_stats(self):
        """Push the packet counters to the `packet_stats` ProcLog and
        telemetry (nothing without `stats_name=`; never raises), with
        byte totals, as the JAX engine's own stats log has them."""
        if self._stats_proclog is None or self._destroyed:
            return None
        try:
            stats = self.stats
        except Exception:  # noqa: BLE001 — engine torn down already
            return None
        try:
            from . import telemetry
            for key, val in stats.items():
                delta = val - self._stats_last[key]
                if delta:
                    telemetry.track(f"udp:{key}", delta)
                    self._stats_last[key] = val
            entry = dict(stats)
            entry["ngood_bytes"] = stats["ngood"] * self.payload_size
            entry["nmissing_bytes"] = stats["nmissing"] * self.payload_size
            entry["nsequence"] = self.nsequence
            entry["last_seq0"] = self.last_seq0 \
                if self.last_seq0 is not None else -1
            self._stats_proclog.update(entry)
        except Exception:  # noqa: BLE001 — observability only
            pass
        return stats


def reuseport_senders(rxs, address="127.0.0.1", probes=256,
                      timeout=2.0):
    """One sender socket for each socket of `rxs`, a SO_REUSEPORT group
    bound to one port: the kernel hashes each flow (its 4-tuple) to one
    socket of the group, so a sender is kept for the first socket its
    probe datagram lands on, until every socket has one.  The probes are
    read off the group through duplicated descriptors, so no engine sees
    them: call this before the captures run.  -> [UDPSocket] in the
    order of `rxs`; RuntimeError after `probes` senders."""
    import os
    import socket as pysock
    peeks = [pysock.socket(fileno=os.dup(rx.fileno())) for rx in rxs]
    chosen = {}
    try:
        for p in peeks:
            p.setblocking(False)
        for _ in range(int(probes)):
            sock = UDPSocket().connect(address, rxs[0].port)
            UDPTransmit(sock).send(b"probe")
            landed, deadline = None, time.monotonic() + timeout
            while landed is None and time.monotonic() < deadline:
                for i, p in enumerate(peeks):
                    try:
                        p.recv(64)
                        landed = i
                        break
                    except BlockingIOError:
                        pass
            if landed is None:
                raise RuntimeError("a reuseport probe datagram was lost")
            chosen.setdefault(landed, sock)
            if len(chosen) == len(rxs):
                return [chosen[i] for i in range(len(rxs))]
    finally:
        for p in peeks:
            p.close()
    raise RuntimeError(f"{probes} probe flows reached only sockets "
                       f"{sorted(chosen)} of {len(rxs)}")


class UDPTransmit(_Native):
    _destroy = "btpUdpTransmitDestroy"

    def __init__(self, sock, core=-1):
        super().__init__()
        self.sock = sock
        # Short-send accounting (sendmany): calls that delivered fewer
        # packets than asked after the bounded retries, the packets left
        # undelivered, and the retry rounds spent on back-pressure.
        self.short_sends = 0
        self.short_packets = 0
        self.send_retries = 0
        self._schedule_refs = None   # (slab, records) kept alive mid-walk
        _check(_lib().btpUdpTransmitCreate(ctypes.byref(self.obj), sock.obj,
                                           int(core)))

    def send(self, packet):
        buf = bytes(packet)
        _check(_lib().btpUdpTransmitSend(self.obj, buf, len(buf)))

    def sendmany(self, packets, packet_size, max_retries=8,
                 backoff_s=0.0005):
        """Send fixed-size packets from one contiguous buffer; -> the
        number handed to the kernel.  Back-pressure (EAGAIN/ENOBUFS, a
        short sendmmsg) is retried here with a bounded exponential
        backoff: `max_retries` rounds without progress from `backoff_s`.
        What is still undelivered after that is booked as a short send
        (`short_sends`, `short_packets`, telemetry 'udp:short_send' /
        'udp:short_packets') and logged; the caller retries the rest if
        it needs every packet delivered."""
        if packet_size <= 0:
            raise ValueError("packet_size must be positive")
        buf = bytes(packets)
        if len(buf) % packet_size:
            raise ValueError(f"buffer length {len(buf)} is not a multiple "
                             f"of packet_size {packet_size}")
        npackets = len(buf) // packet_size
        cbuf = ctypes.create_string_buffer(buf, len(buf))
        base = ctypes.addressof(cbuf)
        done = attempts = retried = 0
        delay = float(backoff_s)
        while done < npackets:
            nsent = ctypes.c_uint(0)
            status = _lib().btpUdpTransmitSendMany(
                self.obj, base + done * packet_size, packet_size,
                npackets - done, ctypes.byref(nsent))
            if status == STATUS_SUCCESS and nsent.value > 0:
                done += nsent.value
                attempts = 0
                delay = float(backoff_s)
                continue
            if status not in (STATUS_SUCCESS, STATUS_WOULD_BLOCK):
                _check(status)
            attempts += 1
            if attempts > max_retries:
                break
            retried += 1
            time.sleep(delay)
            delay = min(delay * 2, 0.016)
        from . import telemetry
        if retried:
            self.send_retries += retried
            telemetry.track("udp:send_retries", retried)
        if done < npackets:
            self.short_sends += 1
            self.short_packets += npackets - done
            telemetry.track("udp:short_send")
            telemetry.track("udp:short_packets", npackets - done)
            _log.warning("sendmany short send: %d/%d packets delivered "
                         "after %d backoff rounds", done, npackets, retried)
        return done

    # ------------------------------------------------------ schedule walker
    def start_schedule(self, slab, records, batch_npkt=64):
        """Start the schedule walker on its own thread: `slab` is one
        payload buffer, `records` packed records (a TRANSMIT_RECORD_DTYPE
        array or `pack_transmit_records` bytes), each naming (offset,
        size, t_ns) of one datagram, timestamps ascending.  Due records
        go out in sendmmsg batches of up to `batch_npkt`, paced by the
        timestamps.  Both buffers are kept alive here until
        `wait_schedule`/`stop_schedule`."""
        if self._schedule_refs is not None:
            raise RuntimeError("a schedule is already running on this "
                               "transmit (wait_schedule it first)")
        slab = bytes(slab)
        rec_buf = records.tobytes() if hasattr(records, "tobytes") \
            else bytes(records)
        if len(rec_buf) % _RECORD_NBYTE:
            raise ValueError(f"record buffer length {len(rec_buf)} is not "
                             f"a multiple of {_RECORD_NBYTE}")
        nrec = len(rec_buf) // _RECORD_NBYTE
        c_slab = ctypes.create_string_buffer(slab, len(slab))
        c_recs = ctypes.create_string_buffer(rec_buf, len(rec_buf))
        _check(_lib().btpUdpTransmitScheduleRun(
            self.obj, ctypes.addressof(c_slab), len(slab),
            ctypes.addressof(c_recs), nrec, int(batch_npkt)))
        self._schedule_refs = (c_slab, c_recs)
        return self

    def schedule_stats(self):
        """Walker counters, live or final: nsent / nretry / ndropped /
        wall_s / running."""
        vals = [ctypes.c_uint64() for _ in range(4)]
        running = ctypes.c_int()
        _check(_lib().btpUdpTransmitScheduleStats(
            self.obj, *[ctypes.byref(v) for v in vals],
            ctypes.byref(running)))
        return {"nsent": vals[0].value, "nretry": vals[1].value,
                "ndropped": vals[2].value,
                "wall_s": vals[3].value / 1e9,
                "running": bool(running.value)}

    def wait_schedule(self):
        """Join the walker; -> final stats.  Raises if the walk failed."""
        try:
            _check(_lib().btpUdpTransmitScheduleWait(self.obj))
        finally:
            self._schedule_refs = None
        return self.schedule_stats()

    def stop_schedule(self):
        """Ask the walker to stop, then join; -> final stats."""
        try:
            _check(_lib().btpUdpTransmitScheduleStop(self.obj))
        finally:
            self._schedule_refs = None
        return self.schedule_stats()

    def run_schedule(self, slab, records, batch_npkt=64):
        """start_schedule + wait_schedule; -> stats."""
        self.start_schedule(slab, records, batch_npkt=batch_npkt)
        return self.wait_schedule()
