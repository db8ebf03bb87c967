"""The port's ring (bifrost_tpu_torch.ring) on the cases of
tests/test_ring.py: wrap through the ghost region, a guaranteed reader's
back-pressure, overlapped reads and several sequences, checked with
checksums.  Each runs on the host spaces and on a 'cuda'-space ring,
which a CPU-bound pipeline keeps on the CPU.  Then what supervision
needs: generation-counted interrupts and their bounded ack, the retry
hook of an innocent waiter, `WriteSpan.cancel` with its fence, and the
fault-injection hooks."""

import threading
import time

import numpy as np
import pytest
import torch

from bifrost_tpu_torch.ring import EndOfDataStop, Ring, RingInterrupted

SPACES = ["system", "cuda_host", "cuda"]


def _ring(space, name):
    return Ring(space=space, name=name, device="cpu")


def _hdr(nchan=4, dtype="f32", name="seq0", shape=None, labels=None):
    return {
        "name": name,
        "time_tag": 0,
        "_tensor": {
            "dtype": dtype,
            "shape": shape or [-1, nchan],
            "labels": labels or ["time", "freq"],
            "scales": [[0, 1], [0, 1]],
            "units": ["s", "MHz"],
        },
    }


def _checksum(a):
    a = np.asarray(a, dtype=np.float64)
    return float((a * (1 + np.arange(a.size).reshape(a.shape) % 97)).sum())


@pytest.mark.parametrize("space", SPACES)
def test_write_read_roundtrip(space):
    ring = _ring(space, "rt")
    with ring.begin_writing() as writer:
        with writer.begin_sequence(_hdr(nchan=8), gulp_nframe=8,
                                   buf_nframe=32) as oseq:
            for g in range(4):
                with oseq.reserve(8) as ospan:
                    assert tuple(ospan.data.shape) == (8, 8)
                    ospan.data[...] = torch.arange(
                        g * 64, (g + 1) * 64, dtype=torch.float32).view(8, 8)
    got = []
    for iseq in ring.read(guarantee=True):
        for ispan in iseq.read(8):
            got.append(ispan.data.numpy().copy())
    np.testing.assert_array_equal(np.concatenate(got),
                                  np.arange(256, dtype=np.float32)
                                  .reshape(-1, 8))


@pytest.mark.parametrize("space", SPACES)
def test_ghost_region_wraparound(space):
    """Spans that wrap the physical end of the buffer read back as one
    view through the ghost region, on a concurrent reader."""
    ring = _ring(space, "ghost")
    results = []
    hdr = _hdr(nchan=3, dtype="i32")

    def reader(iseq):
        for ispan in iseq.read(5):
            results.append(ispan.data.numpy().copy())
        iseq.close()

    with ring.begin_writing() as writer:
        with writer.begin_sequence(hdr, gulp_nframe=5, buf_nframe=7) as oseq:
            iseq = ring.open_sequence("earliest", guarantee=True)
            t = threading.Thread(target=reader, args=(iseq,), daemon=True)
            t.start()
            for g in range(20):
                with oseq.reserve(5) as ospan:
                    ospan.data[...] = torch.arange(
                        g * 15, (g + 1) * 15, dtype=torch.int32).view(5, 3)
    t.join(timeout=10)
    assert not t.is_alive()
    data = np.concatenate(results)
    np.testing.assert_array_equal(
        data, np.arange(300, dtype=np.int32).reshape(-1, 3))
    # capacity is not a multiple of the gulp: some spans did wrap
    assert ring.capacity % (5 * 3 * 4)


@pytest.mark.parametrize("space", SPACES)
def test_backpressure_guaranteed_reader(space):
    """A guaranteed reader that stalls blocks the writer: no data lost."""
    ring = _ring(space, "bp")
    reader_go = threading.Event()
    progress, got = [], []

    def writer(oseq):
        for g in range(8):
            with oseq.reserve(4) as ospan:
                ospan.data[...] = g
            progress.append(g)

    def reader(iseq):
        for ispan in iseq.read(4):
            reader_go.wait()
            got.append(ispan.data.numpy().copy())
        iseq.close()

    w = ring.begin_writing()
    oseq = w.begin_sequence(_hdr(nchan=1, dtype="u8"), gulp_nframe=4,
                            buf_nframe=8)
    iseq = ring.open_sequence("earliest", guarantee=True)
    rt = threading.Thread(target=reader, args=(iseq,), daemon=True)
    wt = threading.Thread(target=writer, args=(oseq,), daemon=True)
    rt.start()
    wt.start()
    time.sleep(0.3)
    assert len(progress) < 8
    with pytest.raises(BlockingIOError):
        ring._reserve(4, nonblocking=True)
    reader_go.set()
    wt.join(timeout=10)
    assert not wt.is_alive()
    oseq.end()
    ring.end_writing()
    rt.join(timeout=10)
    assert not rt.is_alive()
    assert len(got) == 8
    for g, arr in enumerate(got):
        assert (arr == g).all()


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("gulp,overlap,ntotal", [(16, 8, 100), (12, 20, 97)])
def test_overlap_reads_checksums(space, gulp, overlap, ntotal):
    """Readers of gulp + overlap frames striding by gulp (the FDMT input
    pattern) on a ringlet ([freq, time]) stream, sized from the reader's
    span plus overlap: every span equals the source frames, wrapped or
    not, and the final span is short."""
    nchan = 5
    src = np.random.default_rng(gulp).integers(
        0, 1000, (nchan, ntotal)).astype(np.float32)
    ring = _ring(space, "ov")
    hdr = _hdr(shape=[nchan, -1], labels=["freq", "time"])
    spans = []

    def reader(iseq):
        iseq.resize(gulp + overlap, (gulp + overlap) * 2)
        ready.set()
        for ispan in iseq.read(gulp + overlap, gulp):
            spans.append((ispan.frame_offset, ispan.data.numpy().copy()))
        iseq.close()

    ready = threading.Event()
    with ring.begin_writing() as w:
        with w.begin_sequence(hdr, gulp_nframe=gulp,
                              buf_nframe=gulp * 3) as oseq:
            iseq = ring.open_sequence("earliest", guarantee=True)
            t = threading.Thread(target=reader, args=(iseq,), daemon=True)
            t.start()
            assert ready.wait(10)
            for f0 in range(0, ntotal, gulp):
                n = min(gulp, ntotal - f0)
                with oseq.reserve(gulp) as ospan:
                    ospan.data[:, :n] = torch.from_numpy(src[:, f0:f0 + n])
                    ospan.commit(n)
    t.join(timeout=10)
    assert not t.is_alive()
    assert [f for f, _ in spans] == list(range(0, len(spans) * gulp, gulp))
    for f, data in spans:
        want = src[:, f:f + gulp + overlap]
        assert data.shape == want.shape
        assert _checksum(data) == _checksum(want)
        np.testing.assert_array_equal(data, want)
    assert spans[-1][1].shape[1] < gulp + overlap


@pytest.mark.parametrize("space", SPACES)
def test_multiple_sequences(space):
    ring = _ring(space, "mseq")
    with ring.begin_writing() as w:
        for s in range(3):
            hdr = _hdr(nchan=2, dtype="u8", name=f"seq{s}")
            with w.begin_sequence(hdr, gulp_nframe=2,
                                  buf_nframe=16) as oseq:
                for g in range(s + 1):
                    with oseq.reserve(2) as ospan:
                        ospan.data[...] = 10 * s + g
    seen = []
    for iseq in ring.read(guarantee=True):
        vals = [ispan.data.numpy().copy() for ispan in iseq.read(2)]
        seen.append((iseq.header["name"], [int(v[0, 0]) for v in vals]))
    assert seen == [("seq0", [0]), ("seq1", [10, 11]),
                    ("seq2", [20, 21, 22])]


def test_partial_final_gulp_and_ringlets():
    ring = _ring("cuda", "partial")
    hdr = _hdr(shape=[3, -1, 2], labels=["beam", "time", "pol"], dtype="i32")
    with ring.begin_writing() as w:
        with w.begin_sequence(hdr, gulp_nframe=4) as oseq:
            with oseq.reserve(4) as ospan:
                assert tuple(ospan.data.shape) == (3, 4, 2)
                ospan.data[...] = torch.arange(24, dtype=torch.int32).view(
                    3, 4, 2)
            ospan = oseq.reserve(4)
            ospan.data[...] = -1
            ospan.commit(1)
    sizes = []
    for iseq in ring.read(guarantee=True):
        for ispan in iseq.read(4):
            sizes.append(ispan.nframe)
            if ispan.nframe == 4:
                np.testing.assert_array_equal(
                    ispan.data.numpy(),
                    np.arange(24, dtype=np.int32).reshape(3, 4, 2))
    assert sizes == [4, 1]


def test_nonguaranteed_reader_overwritten():
    ring = _ring("system", "ow")
    with ring.begin_writing() as w:
        with w.begin_sequence(_hdr(nchan=1, dtype="u8"), gulp_nframe=4,
                              buf_nframe=8) as oseq:
            iseq = ring.open_sequence("earliest", guarantee=False)
            for g in range(10):
                with oseq.reserve(4) as ospan:
                    ospan.data[...] = g
    span = iseq.acquire(0, 4)
    assert span.nframe_skipped == 4
    span.release()
    span = iseq.acquire(36, 4)
    assert span.nframe_skipped == 0
    assert (span.data.numpy() == 9).all()
    span.release()
    with pytest.raises(EndOfDataStop):
        iseq.acquire(40, 4)
    iseq.close()


def test_interrupt_unblocks_reader():
    ring = _ring("system", "intr")
    exc = []

    def reader():
        try:
            for _ in ring.read(guarantee=True):
                pass
        except RingInterrupted:
            exc.append("interrupted")

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    time.sleep(0.1)
    ring.interrupt()
    t.join(timeout=5)
    assert not t.is_alive()
    assert exc == ["interrupted"]


# --------------------------------------- generation interrupts, cancel
def test_interrupt_generations_and_bounded_ack():
    """interrupt() fires numbered generations; ack_interrupt(g) retires
    every generation <= g and never a later one (btRingAckInterrupt)."""
    ring = _ring("system", "gens")
    assert ring.interrupt_info() == (0, 0, 0)
    g1 = ring.interrupt(target=7)
    g2 = ring.interrupt(target=9)
    assert (g1, g2) == (1, 2)
    assert ring.interrupt_info() == (2, 0, 9)
    ring.ack_interrupt(g1)
    assert ring.interrupt_info()[:2] == (2, 1)
    assert ring._intr_pending()                # g2 is still pending
    ring.ack_interrupt(100)                    # bounded by the latest fire
    assert ring.interrupt_info()[:2] == (2, 2)
    assert not ring._intr_pending()


def test_pending_generation_wakes_only_real_waits():
    """A pending interrupt surfaces where a call really blocks, not where
    its predicate already holds; a later fire survives an ack of an
    earlier one, so a reader still wakes with RingInterrupted."""
    ring = _ring("system", "pending")
    ring.begin_writing()
    wseq = ring.begin_sequence(_hdr(), 4, 16)
    with wseq.reserve(4) as sp:
        sp.data.fill_(1.0)
    g1 = ring.interrupt(target=1)
    g2 = ring.interrupt(target=2)
    ring.ack_interrupt(g1)
    iseq = ring.open_sequence("earliest")      # ready: no wait, no raise
    span = iseq.acquire(0, 4)                  # committed: no wait
    span.release()
    with pytest.raises(RingInterrupted):       # frames 4..8 would block
        iseq.acquire(4, 4)
    ring.ack_interrupt(g2)
    got = []
    t = threading.Thread(target=lambda: got.append(
        iseq.acquire(4, 4).nframe), daemon=True)
    t.start()
    time.sleep(0.05)
    with wseq.reserve(4) as sp:
        sp.data.fill_(2.0)
    t.join(5)
    assert got == [4]


def test_interrupt_retry_hook_keeps_an_innocent_waiter():
    """A supervised waiter asks `_interrupt_retry` whether a fire was
    meant for it (without the ring's lock): True waits again until the
    data comes; False raises RingInterrupted."""
    ring = _ring("system", "retry")
    ring.begin_writing()
    wseq = ring.begin_sequence(_hdr(), 4, 16)
    iseq = ring.open_sequence("earliest")
    asked = []

    def retry():
        assert not ring._cond._is_owned()
        asked.append(1)
        time.sleep(0.01)
        return True

    ring._interrupt_retry = retry
    got = []
    t = threading.Thread(target=lambda: got.append(
        iseq.acquire(0, 4).nframe), daemon=True)
    t.start()
    time.sleep(0.05)
    gen = ring.interrupt(target=12345)         # aimed at nobody
    time.sleep(0.05)
    ring.ack_interrupt(gen)
    with wseq.reserve(4) as sp:
        sp.data.fill_(3.0)
    t.join(5)
    assert got == [4] and asked
    ring._interrupt_retry = lambda: False
    ring.interrupt()
    with pytest.raises(RingInterrupted):
        iseq.acquire(4, 4)


class _Fence(object):
    def __init__(self):
        self.synced = 0

    def synchronize(self):
        self.synced += 1


@pytest.mark.parametrize("space", SPACES)
def test_cancel_final_reservations_newest_first(space):
    """cancel() retires uncommitted reservations without the in-order
    commit wait, newest first; a non-final one refuses.  The next
    reservation reuses the bytes, and a host ring's fence has completed
    before they go back (a 'cuda' ring on the CPU has no stream)."""
    ring = _ring(space, "cancel")
    ring.begin_writing()
    wseq = ring.begin_sequence(_hdr(), 4, 16)
    with wseq.reserve(4) as sp:
        sp.data.fill_(1.0)
    head = ring.reserve_head
    a, b = wseq.reserve(4), wseq.reserve(4)
    with pytest.raises(RuntimeError, match="non-final"):
        a.cancel()
    fence = _Fence()
    b.cancel(fence)
    a.cancel(fence)
    a.cancel(fence)                            # idempotent
    assert ring.reserve_head == head and not ring._open_wspans
    assert fence.synced == 2
    c = wseq.reserve(4)
    assert c.offset == a.offset
    c.data.fill_(2.0)
    c.commit()
    wseq.end()
    ring.end_writing()
    iseq = ring.open_sequence("earliest")
    spans = [iseq.acquire(0, 4), iseq.acquire(4, 4)]
    assert [float(s.data.sum()) for s in spans] == [16.0, 32.0]
    with pytest.raises(EndOfDataStop):
        iseq.acquire(8, 4)


def test_fault_hooks_fire_before_each_wait():
    ring = _ring("system", "hooks")
    seen = []
    ring._fault_hook = lambda site, r: seen.append((site, r is ring))
    ring.begin_writing()
    wseq = ring.begin_sequence(_hdr(), 4, 16)
    with wseq.reserve(4) as sp:
        sp.data.fill_(1.0)
    iseq = ring.open_sequence("earliest")
    iseq.acquire(0, 4).release()
    assert seen == [("ring.reserve", True), ("ring.open", True),
                    ("ring.acquire", True)]
