"""The port's UDP data plane (bifrost_tpu_torch/udp.py over csrc/*.cpp) over
loopback: every case of tests/test_udp.py, one for one, on the port's
sockets, capture engine, ring and transmitter (a transmitter thread or the
schedule walker feeds the capture engine; ring contents, loss accounting,
header lifetime, the batch knob, the walker's contract).  Every socket
binds port 0 with a receive timeout of at most 0.2 s, every wait is
bounded, and the rates stay low enough that the kernel drops nothing.
Then the port's engine against the JAX package's on one seeded packet
schedule: ring bytes and stats equal."""

import json
import os
import struct
import threading
import time

import numpy as np
import pytest

from bifrost_tpu_torch.ring import Ring
from bifrost_tpu_torch.udp import UDPSocket, UDPCapture, UDPTransmit


PAYLOAD = 64   # bytes per (seq, src) cell
NSRC = 2


def _mk_packet(seq, src, fill):
    hdr = struct.pack("<QHH", seq, src, 0)
    return hdr + bytes([fill % 256]) * PAYLOAD


def _port_harness():
    """benchmarks_torch/frb_service.py, loaded under a name of its own (the
    JAX harness is also `frb_service`)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks_torch", "frb_service.py")
    spec = importlib.util.spec_from_file_location("torch_frb_service", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _header_cb(seq0):
    hdr = {
        "name": "udp_test",
        "time_tag": int(seq0),
        "_tensor": {
            "dtype": "u8",
            "shape": [-1, NSRC * PAYLOAD],
            "labels": ["time", "byte"],
            "scales": [[0, 1], [0, 1]],
            "units": [None, None],
        },
    }
    return seq0, hdr


def test_udp_capture_roundtrip():
    rx = UDPSocket().bind("127.0.0.1", 0)
    import socket as pysock
    s = pysock.socket(pysock.AF_INET, pysock.SOCK_DGRAM,
                      fileno=rx.fileno())
    port = s.getsockname()[1]
    s.detach()  # keep rx's ownership of the fd
    rx.set_timeout(0.2)

    ring = Ring(space="system", name="udpcap")
    cap = UDPCapture("simple", rx, ring, nsrc=NSRC, src0=0,
                     max_payload_size=PAYLOAD, buffer_ntime=64, slot_ntime=8,
                     header_callback=_header_cb)

    tx_sock = UDPSocket().connect("127.0.0.1", port)
    tx = UDPTransmit(tx_sock)

    NTIME = 32
    def sender():
        time.sleep(0.1)
        for t in range(NTIME):
            for src in range(NSRC):
                tx.send(_mk_packet(t, src, t))

    st = threading.Thread(target=sender, daemon=True)
    st.start()

    # run capture until the sender is done and the socket drains
    st.join()
    deadline = time.time() + 10
    while time.time() < deadline:
        res = cap.recv()
        if res == 3:  # drained
            break
    cap.end()

    iseq = ring.open_sequence("earliest", guarantee=True)
    hdr = iseq.header
    assert hdr["name"] == "udp_test"
    span = iseq.acquire(0, 16)
    data = np.array(span.data)
    # frame t is NSRC*PAYLOAD bytes all equal to t
    for t in range(16):
        assert (data[t] == t % 256).all(), f"frame {t} corrupted"
    span.release()
    iseq.close()
    stats = cap.stats
    assert stats["ngood"] >= 16 * NSRC


def test_udp_capture_missing_packets():
    rx = UDPSocket().bind("127.0.0.1", 0)
    import socket as pysock
    s = pysock.socket(pysock.AF_INET, pysock.SOCK_DGRAM, fileno=rx.fileno())
    port = s.getsockname()[1]
    s.detach()
    rx.set_timeout(0.2)

    ring = Ring(space="system", name="udpmiss")
    cap = UDPCapture("simple", rx, ring, nsrc=NSRC, src0=0,
                     max_payload_size=PAYLOAD, buffer_ntime=64, slot_ntime=8,
                     header_callback=_header_cb)
    tx_sock = UDPSocket().connect("127.0.0.1", port)
    tx = UDPTransmit(tx_sock)

    def sender():
        time.sleep(0.1)
        for t in range(24):
            for src in range(NSRC):
                if t == 3:  # drop both packets of frame 3
                    continue
                tx.send(_mk_packet(t, src, t))

    st = threading.Thread(target=sender, daemon=True)
    st.start()
    st.join()
    deadline = time.time() + 10
    while time.time() < deadline:
        res = cap.recv()
        if res == 3:  # drained
            break
    cap.end()

    iseq = ring.open_sequence("earliest", guarantee=True)
    span = iseq.acquire(0, 8)
    data = np.array(span.data)
    assert (data[3] == 0).all()       # dropped frame zero-filled
    assert (data[2] == 2).all()
    assert (data[4] == 4).all()
    span.release()
    iseq.close()
    assert cap.stats["nmissing"] >= 2


def test_reuseport_fanout_binds_and_receives():
    """SO_REUSEPORT fanout: two sockets bind the same port (which plain
    SO_REUSEADDR alone does not allow for UDP receivers) and traffic
    lands on them (kernel flow-hash; a single sender maps to one
    socket, so assert delivery, not distribution)."""
    import socket as pysock
    from bifrost_tpu_torch.udp import UDPSocket

    a = UDPSocket().bind("127.0.0.1", 0, reuseport=True)
    # discover the kernel-assigned port via the fd
    port = pysock.socket(fileno=os.dup(a.fileno())).getsockname()[1]
    b = UDPSocket().bind("127.0.0.1", port, reuseport=True)
    a.set_timeout(5)
    b.set_timeout(0.2)
    tx = pysock.socket(pysock.AF_INET, pysock.SOCK_DGRAM)
    for i in range(8):
        tx.sendto(b"pkt%d" % i, ("127.0.0.1", port))
    got = 0
    for sock in (a, b):
        s = pysock.socket(fileno=os.dup(sock.fileno()))
        s.settimeout(0.5)
        try:
            while True:
                got += len(s.recv(64)) > 0
        except (TimeoutError, OSError):
            pass
        s.close()
    assert got == 8, f"received {got}/8 packets across the fanout pair"
    tx.close()


def test_capture_two_sequence_header_buffers_stay_alive():
    """Regression: UDPCapture kept ONE header buffer slot, overwriting
    (and freeing) sequence A's header when sequence B's callback ran —
    while the C contract (btcore.h sequence callback) lets the capture
    engine hold the pointer until the next callback or capture
    destruction.  Per-sequence buffers keyed by seq0 must keep every
    handed-out header alive and byte-intact until end()/close.

    Drives the registered C callback directly (byte-for-byte what the
    engine does at a sequence boundary), so the test needs no packet
    I/O and runs on kernels where the recvmmsg roundtrip tests cannot.
    """
    import ctypes

    rx = UDPSocket().bind("127.0.0.1", 0)
    rx.set_timeout(0.1)
    ring = Ring(space="system", name="udphdrlife")

    def header_cb(seq0):
        return seq0, {"obs": f"seq{seq0}", "pad": "x" * 64}

    cap = UDPCapture("simple", rx, ring, nsrc=NSRC, src0=0,
                     max_payload_size=PAYLOAD, buffer_ntime=64, slot_ntime=8,
                     header_callback=header_cb)
    tt = ctypes.c_uint64()
    hp = ctypes.c_void_p()
    hs = ctypes.c_uint64()
    ptrs = {}
    for seq0 in (100, 200):
        rc = cap._c_callback(seq0, ctypes.byref(tt), ctypes.byref(hp),
                             ctypes.byref(hs), None)
        assert rc == 0
        assert tt.value == seq0
        ptrs[seq0] = (hp.value, hs.value)
    # both sequences' buffers are held (keyed by seq0)...
    assert set(cap._hdr_bufs) == {100, 200}
    # ...and the FIRST header still reads back intact AFTER the second
    # callback ran — a use-after-freeable dangling pointer before the fix
    for seq0, (ptr, size) in ptrs.items():
        hdr = json.loads(ctypes.string_at(ptr, size).decode())
        assert hdr["obs"] == f"seq{seq0}"
    # a third sequence prunes to the contract window (current+previous):
    # 24/7 captures must not accumulate one buffer per sequence forever
    rc = cap._c_callback(300, ctypes.byref(tt), ctypes.byref(hp),
                         ctypes.byref(hs), None)
    assert rc == 0
    assert set(cap._hdr_bufs) == {200, 300}
    hdr = json.loads(ctypes.string_at(ptrs[200][0], ptrs[200][1]).decode())
    assert hdr["obs"] == "seq200"   # previous sequence's header intact
    cap.end()
    assert cap._hdr_bufs == {}   # pruned on teardown
    cap.close()


def test_malformed_and_truncated_packets_ninvalid_accounting():
    """Malformed/truncated datagrams must only bump ninvalid — valid
    packets around them land intact (satellite of the 24/7 service PR:
    a hostile wire cannot corrupt the stream, only shrink it)."""
    rx = UDPSocket().bind("127.0.0.1", 0)
    port = rx.port
    rx.set_timeout(0.2)

    ring = Ring(space="system", name="udpmalformed")
    cap = UDPCapture("simple", rx, ring, nsrc=NSRC, src0=0,
                     max_payload_size=PAYLOAD, buffer_ntime=64, slot_ntime=8,
                     header_callback=_header_cb)
    tx_sock = UDPSocket().connect("127.0.0.1", port)
    tx = UDPTransmit(tx_sock)

    def sender():
        time.sleep(0.1)
        for t in range(16):
            for src in range(NSRC):
                tx.send(_mk_packet(t, src, t))
            if t % 4 == 0:
                tx.send(struct.pack("<QHH", t, 0, 0)[:6])      # runt header
                tx.send(struct.pack("<QHH", t, 0, 0) +
                        b"\x55" * (PAYLOAD // 2))              # short payload
                tx.send(b"\xde\xad\xbe\xef" * 3)               # garbage hdr
                tx.send(_mk_packet(t, 999, t))                 # bad source

    st = threading.Thread(target=sender, daemon=True)
    st.start()
    st.join()
    deadline = time.time() + 10
    while time.time() < deadline:
        if cap.recv() == 3:
            break
    cap.end()

    stats = cap.stats
    # 4 rounds x 4 malformed shapes; late kernel drops can only shrink it
    assert stats["ninvalid"] >= 8, stats
    assert stats["ngood"] >= 8 * NSRC, stats
    iseq = ring.open_sequence("earliest", guarantee=True)
    span = iseq.acquire(0, 8)
    data = np.array(span.data)
    for t in range(8):
        assert (data[t] == t % 256).all(), f"frame {t} corrupted"
    span.release()
    iseq.close()
    cap.close()


def test_header_lifetime_malformed_then_valid_sequence_flip():
    """Header-buffer lifetime when a sequence callback FAILS between two
    valid sequences: the failing flip must not free or clobber the
    previous sequence's header (the engine may still hold its pointer),
    and the next valid sequence must key a fresh buffer."""
    import ctypes

    rx = UDPSocket().bind("127.0.0.1", 0)
    rx.set_timeout(0.1)
    ring = Ring(space="system", name="udphdrflip")

    calls = {"n": 0}

    def header_cb(seq0):
        calls["n"] += 1
        if calls["n"] == 2:   # the malformed flip: callback blows up
            raise ValueError("malformed sequence header")
        return seq0, {"obs": f"seq{seq0}", "pad": "y" * 48}

    cap = UDPCapture("simple", rx, ring, nsrc=NSRC, src0=0,
                     max_payload_size=PAYLOAD, buffer_ntime=64, slot_ntime=8,
                     header_callback=header_cb)
    tt = ctypes.c_uint64()
    hp = ctypes.c_void_p()
    hs = ctypes.c_uint64()
    rc = cap._c_callback(100, ctypes.byref(tt), ctypes.byref(hp),
                         ctypes.byref(hs), None)
    assert rc == 0
    first = (hp.value, hs.value)
    # malformed flip: engine sees a callback failure (-1), no new buffer
    rc = cap._c_callback(200, ctypes.byref(tt), ctypes.byref(hp),
                         ctypes.byref(hs), None)
    assert rc == -1
    assert set(cap._hdr_bufs) == {100}
    # the prior sequence's header is still alive and byte-intact
    hdr = json.loads(ctypes.string_at(first[0], first[1]).decode())
    assert hdr["obs"] == "seq100"
    # a later valid sequence keys a fresh buffer; the old one survives
    # (current + previous window)
    rc = cap._c_callback(300, ctypes.byref(tt), ctypes.byref(hp),
                         ctypes.byref(hs), None)
    assert rc == 0
    assert set(cap._hdr_bufs) == {100, 300}
    hdr = json.loads(ctypes.string_at(first[0], first[1]).decode())
    assert hdr["obs"] == "seq100"
    cap.end()
    cap.close()


def test_bad_packets_leak_no_block_fault_through_capture_block():
    """A malformed stream through the PIPELINE capture block: ninvalid
    accounting only — no block fault, no supervise event, frames
    intact downstream (the service-chain robustness contract)."""
    import socket as pysock

    from bifrost_tpu_torch.blocks.testing import gather_sink
    from bifrost_tpu_torch.blocks.udp_capture import udp_capture
    from bifrost_tpu_torch.pipeline import Pipeline
    from bifrost_tpu_torch.supervise import RestartPolicy, Supervisor

    rx = UDPSocket().bind("127.0.0.1", 0)
    port = rx.port
    rx.set_timeout(0.05)

    chunks = []
    with Pipeline(device="cpu") as pipe:
        cap = udp_capture("simple", rx, NSRC, 0, PAYLOAD, buffer_ntime=256,
                          slot_ntime=8, header_callback=_header_cb,
                          name="capture")
        gather_sink(cap, chunks)
    sup = Supervisor(policy=RestartPolicy(max_restarts=2, backoff=0.01))

    tx = pysock.socket(pysock.AF_INET, pysock.SOCK_DGRAM)
    addr = ("127.0.0.1", port)

    def sender():
        time.sleep(0.3)
        for t in range(32):
            for src in range(NSRC):
                tx.sendto(_mk_packet(t, src, t), addr)
            if t % 3 == 0:
                tx.sendto(b"\x00" * 5, addr)                  # runt
                tx.sendto(_mk_packet(t, src, t)[:-10], addr)  # truncated

    threading.Thread(target=sender, daemon=True).start()

    def stopper():
        deadline = time.time() + 15
        while time.time() < deadline:
            if sum(len(c) for c in chunks) >= 24:
                break
            time.sleep(0.1)
        pipe.shutdown(timeout=5.0)

    threading.Thread(target=stopper, daemon=True).start()
    pipe.run(supervise=sup)

    assert sup.counters["faults"] == 0, sup.counters
    assert sup.counters["restarts"] == 0, sup.counters
    got = np.concatenate(chunks, axis=0)
    assert len(got) >= 24
    for t in range(24):
        assert (got[t] == t % 256).all(), f"frame {t} corrupted"


def test_capture_stats_published_to_proclog_per_sequence():
    """UDPCapture(stats_name=...) pushes full packet counters to a
    packet_stats proclog at sequence boundaries and teardown, readable
    through proclog.capture_metrics (satellite: stats were poll-only)."""
    import ctypes

    from bifrost_tpu_torch.proclog import capture_metrics, load_by_pid

    rx = UDPSocket().bind("127.0.0.1", 0)
    rx.set_timeout(0.1)
    ring = Ring(space="system", name="udpstatspush")
    cap = UDPCapture("simple", rx, ring, nsrc=NSRC, src0=0,
                     max_payload_size=PAYLOAD, buffer_ntime=64, slot_ntime=8,
                     header_callback=_header_cb, stats_name="cap_under_test")
    tt = ctypes.c_uint64()
    hp = ctypes.c_void_p()
    hs = ctypes.c_uint64()
    rc = cap._c_callback(10, ctypes.byref(tt), ctypes.byref(hp),
                         ctypes.byref(hs), None)
    assert rc == 0
    assert cap.nsequence == 1 and cap.last_seq0 == 10
    cap.end()  # final flush
    rows = capture_metrics(load_by_pid(os.getpid()))
    mine = [r for r in rows if r["name"] == "cap_under_test"]
    assert mine, f"no packet_stats row: {rows}"
    assert mine[0]["nsequence"] == 1
    assert "good" in mine[0] and "invalid" in mine[0]
    cap.close()


# --------------------------------------------------------------------------
# C-paced replay transmitter (schedule walker) + batched capture knobs
# --------------------------------------------------------------------------

def _collect(rx, n, idle_s=0.5):
    """Drain up to n datagrams off a bound UDPSocket (dup'd fd)."""
    import socket as pysock
    s = pysock.socket(pysock.AF_INET, pysock.SOCK_DGRAM,
                      fileno=os.dup(rx.fileno()))
    s.settimeout(idle_s)
    out = []
    try:
        while len(out) < n:
            out.append(s.recv(65536))
    except (TimeoutError, OSError):
        pass
    s.close()
    return out


def _loopback_pair():
    rx = UDPSocket().bind("127.0.0.1", 0)
    rx.set_timeout(0.2)
    tx_sock = UDPSocket().connect("127.0.0.1", rx.port)
    return rx, tx_sock, UDPTransmit(tx_sock)


def _simple_schedule(n, step_ns, payload=32, seq0=0):
    pkts = [struct.pack("<QHH", seq0 + i, 0, 0) + bytes([i % 256]) * payload
            for i in range(n)]
    slab = b"".join(pkts)
    recs, off = [], 0
    for i, p in enumerate(pkts):
        recs.append((off, len(p), i * step_ns))
        off += len(p)
    from bifrost_tpu_torch.udp import pack_transmit_records
    return slab, pack_transmit_records(recs), pkts


def test_transmit_schedule_walker_delivers_in_order():
    rx, tx_sock, tx = _loopback_pair()
    slab, recs, pkts = _simple_schedule(100, 0)
    stats = tx.run_schedule(slab, recs, batch_npkt=16)
    assert stats["nsent"] == 100 and stats["ndropped"] == 0, stats
    assert not stats["running"]
    got = _collect(rx, 100)
    assert got == pkts
    rx.shutdown()


@pytest.mark.parametrize("batch", [1, 7, 64, 100, 4096])
def test_transmit_schedule_batch_boundaries(batch):
    """Every batch depth — 1 (degenerate), a non-divisor (ragged final
    batch), exact count, and beyond the schedule — delivers the whole
    schedule in order."""
    rx, tx_sock, tx = _loopback_pair()
    slab, recs, pkts = _simple_schedule(100, 0)
    stats = tx.run_schedule(slab, recs, batch_npkt=batch)
    assert stats["nsent"] == 100, stats
    assert _collect(rx, 100) == pkts
    rx.shutdown()


def test_transmit_schedule_paces_from_timestamps():
    """The walker's token bucket refills along the schedule's own
    timestamps: a scripted span is never finished EARLY (late is
    allowed — loopback CI jitter), and a blast schedule (all-zero
    timestamps) runs much faster than a paced one."""
    rx, tx_sock, tx = _loopback_pair()
    n, step = 200, 50_000                      # 50us apart -> ~10ms span
    slab, recs, _pkts = _simple_schedule(n, step)
    paced = tx.run_schedule(slab, recs, batch_npkt=32)
    slab_b, recs_b, _ = _simple_schedule(n, 0)
    blast = tx.run_schedule(slab_b, recs_b, batch_npkt=32)
    span_s = (n - 1) * step / 1e9
    assert paced["wall_s"] >= 0.9 * span_s, (paced, span_s)
    assert blast["wall_s"] < paced["wall_s"], (blast, paced)
    rx.shutdown()


def test_transmit_schedule_validation_rejected_up_front():
    """Malformed schedules fail fast in btUdpTransmitScheduleRun — no
    walker thread, no partial wire traffic."""
    from bifrost_tpu_torch.udp import (TRANSMIT_RECORD_DTYPE, UDPError,
                                       pack_transmit_records)
    rx, tx_sock, tx = _loopback_pair()
    slab, recs, _ = _simple_schedule(4, 0)
    # batch bounds
    for bad_batch in (0, 4097):
        with pytest.raises((UDPError, ValueError)):
            tx.start_schedule(slab, recs, batch_npkt=bad_batch)
    # record past the slab
    bad = pack_transmit_records([(len(slab), 8, 0)])
    with pytest.raises(UDPError):
        tx.start_schedule(slab, bad)
    # timestamps must be non-decreasing
    bad = pack_transmit_records([(0, 8, 1000), (8, 8, 0)])
    with pytest.raises(UDPError):
        tx.start_schedule(slab, bad)
    # reserved flags must be zero
    arr = np.zeros(1, dtype=TRANSMIT_RECORD_DTYPE)
    arr[0] = (0, 8, 0, 0)
    arr["flags"] = 7
    with pytest.raises(UDPError):
        tx.start_schedule(slab, arr.tobytes())
    # records blob must be whole 24-byte records
    with pytest.raises(ValueError):
        tx.start_schedule(slab, recs[:-3])
    # after all rejections the transmitter still works
    stats = tx.run_schedule(slab, recs)
    assert stats["nsent"] == 4
    assert _collect(rx, 4)
    rx.shutdown()


def test_transmit_one_schedule_at_a_time():
    """A second start_schedule while one walks is refused loudly; after
    wait_schedule the transmitter accepts a new one."""
    rx, tx_sock, tx = _loopback_pair()
    # A long paced schedule keeps the walker busy while we poke it.
    slab, recs, _ = _simple_schedule(500, 200_000)   # ~0.1s span
    tx.start_schedule(slab, recs)
    with pytest.raises(RuntimeError):
        tx.start_schedule(slab, recs)
    st = tx.stop_schedule()
    assert not st["running"]
    stats = tx.run_schedule(*_simple_schedule(8, 0)[:2])
    assert stats["nsent"] == 8
    rx.shutdown()


def test_transmit_sendmany_counters_preserved():
    """The bounded-retry sendmany keeps the telemetry contract: full
    delivery books no short sends and no retries; the counters exist
    and never go backwards."""
    rx, tx_sock, tx = _loopback_pair()
    pkts = b"".join(_mk_packet(t, 0, t) for t in range(32))
    n = tx.sendmany(pkts, len(_mk_packet(0, 0, 0)))
    assert n == 32
    assert tx.short_sends == 0 and tx.short_packets == 0
    assert tx.send_retries == 0
    assert len(_collect(rx, 32)) == 32
    rx.shutdown()


def test_capture_batch_npkt_knob_bounds_and_default():
    """recvmmsg depth is a measured knob: constructor arg + property,
    validated [1, 4096]; the capture_batch_npkt config flag supplies
    the pipeline-block default."""
    from bifrost_tpu_torch import config
    from bifrost_tpu_torch.udp import UDPError
    rx = UDPSocket().bind("127.0.0.1", 0)
    rx.set_timeout(0.1)
    ring = Ring(space="system", name="udpbatchknob")
    cap = UDPCapture("simple", rx, ring, nsrc=NSRC, src0=0,
                     max_payload_size=PAYLOAD, buffer_ntime=64,
                     slot_ntime=8, header_callback=_header_cb,
                     batch_npkt=17)
    assert cap.batch_npkt == 17
    cap.end()
    cap.close()
    for bad in (0, -3, 4097):
        with pytest.raises((UDPError, ValueError)):
            UDPCapture("simple", rx, ring, nsrc=NSRC, src0=0,
                       max_payload_size=PAYLOAD, buffer_ntime=64,
                       slot_ntime=8, header_callback=_header_cb,
                       batch_npkt=bad)
    assert config.get("capture_batch_npkt") == 64
    with pytest.raises(ValueError):
        config.set("capture_batch_npkt", 0)
    with pytest.raises(ValueError):
        config.set("capture_batch_npkt", 4097)
    rx.shutdown()


def test_affinity_set_core_failure_names_core():
    """A failed pin is LOUD and names the core (satellite: it used to
    surface as a bare status code)."""
    from bifrost_tpu_torch import udp
    with pytest.raises(ValueError, match=r"core 99999"):
        udp.set_core(99999)


def test_loopback_capture_rate_smoke():
    """Wire-rate smoke: blast a compiled schedule through the capture
    engine and require sustained ingest well beyond the old Python
    sender's ~2.6k pkts/s ceiling.  Rate asserted only where the kernel
    actually batches (sandboxed kernels fall back to one-datagram
    syscalls — the recvmmsg probe discipline)."""
    from bifrost_tpu_torch.udp import batch_support
    rx, tx_sock, tx = _loopback_pair()
    ring = Ring(space="system", name="udpratesmoke")
    cap = UDPCapture("simple", rx, ring, nsrc=1, src0=0,
                     max_payload_size=PAYLOAD, buffer_ntime=1024,
                     slot_ntime=16, header_callback=_header_cb)
    n = 30_000
    slab, recs, _ = _simple_schedule(n, 0, payload=PAYLOAD)
    t0 = time.perf_counter()
    tx.start_schedule(slab, recs, batch_npkt=128)
    deadline = time.time() + 30
    while time.time() < deadline:
        if cap.recv() == 3 and not tx.schedule_stats()["running"]:
            break
    wall = time.perf_counter() - t0
    tx.wait_schedule()
    cap.end()
    stats = cap.stats
    rx.shutdown()
    assert stats["ngood"] > 0, stats
    sup = batch_support()
    if sup["recvmmsg"] != 1 or sup["sendmmsg"] != 1:
        pytest.skip(f"kernel lacks batched socket syscalls ({sup}); "
                    f"delivery verified, rate floor not asserted")
    rate = stats["ngood"] / wall
    assert rate >= 52_000, \
        f"sustained capture {rate:.0f} pkts/s below the 52k floor " \
        f"(ngood={stats['ngood']} wall={wall:.3f}s)"


def test_compiled_schedule_bitwise_parity_with_python_sender():
    """The C-paced replay path must put the SAME BYTES on the wire as
    the original Python sender for one seeded script — including runt /
    badsize / garbage malformed shapes and RFI-spec payloads — in the
    same order (the replay-signature bridge between old and new
    transmitters)."""
    frb_service = _port_harness()
    events = frb_service.build_schedule(
        3, 0, 128, drop_p=0.05, dup_p=0.08, reorder_p=0.15,
        malform_every=9, rfi=dict(n_storm=6, p_on=0.5, impulse_every=32))
    rx = UDPSocket().bind("127.0.0.1", 0)
    rx.set_timeout(0.2)
    import socket as pysock
    ptx = pysock.socket(pysock.AF_INET, pysock.SOCK_DGRAM)
    sent_py, malformed_py, _ = frb_service.send_schedule(
        ptx, ("127.0.0.1", rx.port), events, rate_pps=0)
    ptx.close()
    wire_py = _collect(rx, sent_py + malformed_py)
    tx_sock = UDPSocket().connect("127.0.0.1", rx.port)
    tx = UDPTransmit(tx_sock)
    sent_c, malformed_c, _ = frb_service.send_schedule_c(
        tx, events, rate_pps=0)
    wire_c = _collect(rx, sent_c + malformed_c)
    rx.shutdown()
    assert (sent_py, malformed_py) == (sent_c, malformed_c)
    assert malformed_c > 0, "script rendered no malformed shapes"
    assert wire_py == wire_c


# --------------------------------------------------------------------------
# Capture parity with the JAX engine
# --------------------------------------------------------------------------

def _ring_bytes(ring):
    """Every sequence of a ring (either package's ring API):
    [(time_tag, header, uint8 frames)]."""
    out = []
    for iseq in ring.read(guarantee=True):
        chunks = [np.array(span.data).copy()
                  for span in iseq.read(SLOT_PARITY)]
        out.append((iseq.time_tag, iseq.header,
                    np.concatenate(chunks) if chunks else None))
    return out


SLOT_PARITY = 16


def _capture_schedule(udp_mod, ring, slab, recs, hdr_cb, npkt):
    """Capture one compiled schedule with `udp_mod`'s engine into `ring`
    (NSRC 1 x 64 B frames, slot 16, a buffer holding the whole stream);
    -> the engine's stats."""
    rx = udp_mod.UDPSocket().bind("127.0.0.1", 0)
    rx.set_timeout(0.05)
    cap = udp_mod.UDPCapture("simple", rx, ring, nsrc=1, src0=0,
                             max_payload_size=PAYLOAD, buffer_ntime=4096,
                             slot_ntime=SLOT_PARITY, header_callback=hdr_cb)
    tx_sock = udp_mod.UDPSocket().connect("127.0.0.1", rx.port)
    tx = udp_mod.UDPTransmit(tx_sock)
    tx.start_schedule(slab, recs, batch_npkt=16)
    deadline = time.time() + 10
    while time.time() < deadline:
        if cap.recv() == 3 and not tx.schedule_stats()["running"]:
            break
    walk = tx.wait_schedule()
    assert walk["nsent"] == npkt and walk["ndropped"] == 0, walk
    cap.end()
    stats = cap.stats
    cap.close()
    rx.shutdown()
    return stats


def test_capture_parity_with_the_jax_engine():
    """One seeded schedule from the port harness's build_schedule (a drop
    range, seeded loss, reorders, duplicates, runts/badsize/garbage
    datagrams and a flap: a pause with a sequence jump the engine
    zero-fills) sent to the JAX UDPCapture and to the port's: the ring
    bytes (every sequence, every frame, headers and time tags) are
    bitwise equal and the stats dicts equal.  Paced at 20,000 packets/s
    so the kernel drops nothing; the stats depend only on packet order,
    which loopback keeps."""
    from bifrost_tpu import ring as jring
    from bifrost_tpu import udp as judp
    from bifrost_tpu_torch import udp as tudp

    harness = _port_harness()
    events = harness.build_schedule(
        11, 0, 600, drop_ranges=((100, 140),), drop_p=0.03, dup_p=0.06,
        reorder_p=0.12, malform_every=13, flaps={400: (0.05, 48)})
    slab, recs, sent, malformed = harness.compile_schedule(events, 20_000)
    assert malformed > 0
    npkt = sent + malformed

    def hdr_cb(seq0):
        return seq0, {"name": "parity", "_tensor": {
            "dtype": "u8", "shape": [-1, PAYLOAD], "labels": ["time", "freq"],
            "scales": [[0, 1], [0, 1]], "units": [None, None]}}

    jr = jring.Ring(space="system", name="parity_jax")
    js = _capture_schedule(judp, jr, slab, recs, hdr_cb, npkt)
    tr = Ring(space="system", name="parity_port")
    ts = _capture_schedule(tudp, tr, slab, recs, hdr_cb, npkt)
    assert ts == js
    assert ts["nmissing"] > 0 and ts["ninvalid"] > 0 and ts["nrepeat"] > 0
    jb, tb = _ring_bytes(jr), _ring_bytes(tr)
    assert len(tb) == len(jb) == 1
    for (jt, jh, jd), (tt, th, td) in zip(jb, tb):
        assert tt == jt and th == jh
        assert td.dtype == jd.dtype == np.uint8
        assert td.shape == jd.shape and np.array_equal(td, jd)
