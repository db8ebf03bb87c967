"""The port's ring (bifrost_tpu_torch.ring) on the rest of the JAX ring's
surface, each case run through a JAX `Ring` and a port `Ring` on the same
stream: opening a sequence by name, by time tag ('at': the sequence
containing the tag) and the latest, `nonblocking`; the zero-copy host
plane (`WriteSpan.publish_external`: readers alias the publisher's
buffer, straddling reads stitch, separate buffers and published spans
mixed with copied ones are assembled, a lossy reader past the tail); and
the cases of tests/test_ring.py that test_torch_ring.py lacks (the
delayed ghost straddle, the manual guarantee, a live resize, a reader
blocked until a commit, the ringlet layout).  Values are compared
bitwise."""

import threading
import time

import numpy as np
import pytest
import torch

from bifrost_tpu.ring import Ring as JaxRing
from bifrost_tpu_torch.ring import Ring as PortRing


class _Jax(object):
    name = "jax"

    @staticmethod
    def ring(name=None):
        return JaxRing(space="system", name=name)

    @staticmethod
    def write(span, arr):
        span.data[...] = arr

    @staticmethod
    def read(span):
        return np.array(span.data)

    @staticmethod
    def view(span):
        return np.asarray(span.data)


class _Port(object):
    name = "port"

    @staticmethod
    def ring(name=None):
        return PortRing(space="system", name=name, device="cpu")

    @staticmethod
    def write(span, arr):
        span.data.copy_(torch.from_numpy(np.ascontiguousarray(arr)))

    @staticmethod
    def read(span):
        return span.data.numpy().copy()

    @staticmethod
    def view(span):
        return span.data.numpy()


PKGS = [_Jax, _Port]


def _hdr(nchan=4, dtype="f32", name="seq0", time_tag=0):
    return {"name": name, "time_tag": time_tag, "_tensor": {
        "dtype": dtype, "shape": [-1, nchan], "labels": ["time", "freq"],
        "scales": [[0, 1.0], [0, 1.0]], "units": [None, None]}}


# ------------------------------------------------------ opening sequences
def _two_sequences(pkg):
    """A ring with sequences s100 (tag 100) and s200 (tag 200), whose
    writer stays open until `release` is set."""
    ring = pkg.ring()
    ready, release = threading.Event(), threading.Event()

    def writer():
        with ring.begin_writing() as w:
            for name, tt in (("s100", 100), ("s200", 200)):
                with w.begin_sequence(_hdr(1, "u8", name, tt), gulp_nframe=4,
                                      buf_nframe=64) as seq:
                    with seq.reserve(4) as span:
                        pkg.write(span, np.full((4, 1), tt // 100,
                                                np.uint8))
            ready.set()
            release.wait(timeout=30)

    t = threading.Thread(target=writer)
    t.start()
    assert ready.wait(timeout=30)
    return ring, release, t


def _outcome(fn):
    """-> the opened sequence's (name, time_tag, first byte), or the
    kind of error it raised."""
    try:
        seq = fn()
    except OSError:
        return "would block"
    except Exception as e:  # noqa: BLE001 — the two packages' types differ
        return "end of data" if type(e).__name__ == "EndOfDataStop" \
            else "invalid argument"
    try:
        with seq.acquire(0, 1) as span:
            first = int(np.asarray(span.data.numpy() if isinstance(
                span.data, torch.Tensor) else span.data).ravel()[0])
        return seq.name, int(seq.time_tag), first
    finally:
        seq.close()


def _queries(ring):
    return {
        "at150": lambda: ring.open_sequence_at(150, guarantee=False),
        "at200": lambda: ring.open_sequence_at(200, guarantee=False),
        "at999": lambda: ring.open_sequence_at(999, guarantee=False),
        "at50": lambda: ring.open_sequence_at(50, guarantee=False),
        "name_s100": lambda: ring.open_sequence_by_name("s100",
                                                        guarantee=False),
        "name_s200": lambda: ring.open_sequence_by_name("s200"),
        "latest": lambda: ring.open_latest_sequence(guarantee=False),
        "earliest": lambda: ring.open_earliest_sequence(),
        "name_missing_nb": lambda: ring.open_sequence(
            "name", name="nope", guarantee=False, nonblocking=True),
        "at_nb": lambda: ring.open_sequence("at", time_tag=150,
                                            nonblocking=True),
    }


def _open_outcomes(pkg):
    ring, release, t = _two_sequences(pkg)
    try:
        live = {k: _outcome(q) for k, q in _queries(ring).items()}
    finally:
        release.set()
        t.join(timeout=10)
    ended = {k: _outcome(q) for k, q in _queries(ring).items()}
    empty = pkg.ring()
    blocking = _outcome(lambda: empty.open_sequence("earliest",
                                                    nonblocking=True))
    return live, ended, blocking


def test_open_by_name_time_tag_and_latest_match_jax():
    jax, port = _open_outcomes(_Jax), _open_outcomes(_Port)
    assert port == jax
    live, ended, blocking = port
    assert live["at150"] == ("s100", 100, 1)     # the CONTAINING sequence
    assert live["at200"] == ("s200", 200, 2)
    assert live["at999"] == ("s200", 200, 2)
    assert live["at50"] == "invalid argument"    # before every sequence
    assert live["name_s100"] == ("s100", 100, 1)
    assert live["latest"] == ("s200", 200, 2)
    assert live["earliest"] == ("s100", 100, 1)
    assert live["name_missing_nb"] == "would block"
    assert ended["name_missing_nb"] == "end of data"
    assert blocking == "would block"


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_open_sequence_at_containing_semantics(pkg):
    """tests/test_ring.py:378 on both rings."""
    ring, release, t = _two_sequences(pkg)
    try:
        seq = ring.open_sequence_at(150, guarantee=False)
        assert seq.name == "s100"
        seq.close()
        seq = ring.open_sequence_at(200, guarantee=False)
        assert seq.name == "s200"
        seq.close()
        with pytest.raises(Exception):
            ring.open_sequence_at(50, guarantee=False)
    finally:
        release.set()
        t.join(timeout=10)


def test_open_waits_for_a_named_sequence_and_the_fault_hook_fires():
    ring = _Port.ring("waitname")
    sites, got = [], []
    ring._fault_hook = lambda site, r: sites.append(site)

    def reader():
        with ring.open_sequence_by_name("late") as seq:
            got.append(seq.time_tag)

    t = threading.Thread(target=reader)
    t.start()
    time.sleep(0.1)
    assert got == [] and sites == ["ring.open"]
    with ring.begin_writing() as w:
        with w.begin_sequence(_hdr(1, "u8", "early", 5), 1) as s:
            with s.reserve(1) as span:
                _Port.write(span, np.zeros((1, 1), np.uint8))
        time.sleep(0.1)
        assert got == []
        with w.begin_sequence(_hdr(1, "u8", "late", 7), 1) as s:
            with s.reserve(1) as span:
                _Port.write(span, np.zeros((1, 1), np.uint8))
        t.join(timeout=10)
    assert got == [7]


# -------------------------------------------------------- zero-copy plane
ZC_HDR = {"name": "zc", "time_tag": 0, "_tensor": {
    "dtype": "u8", "shape": [-1, 16], "labels": ["time", "x"],
    "scales": [[0, 1.0], [0, 1.0]], "units": [None, None]}}


def _zc_stream(pkg, plan, gulp=8, guarantee=True):
    """Write 2-frame spans, each published (plan 'p', from the array
    given) or copied (plan 'c'), and read gulps of `gulp` frames in a
    guaranteed reader -> [(gulp bytes, the reader's view)]."""
    ring = pkg.ring()
    got, done = [], threading.Event()

    def reader():
        with ring.open_earliest_sequence(guarantee=guarantee) as seq:
            for span in seq.read(gulp):
                view = pkg.view(span)
                got.append((view.copy(), view))
        done.set()

    t = threading.Thread(target=reader)
    with ring.begin_writing() as w:
        with w.begin_sequence(ZC_HDR, gulp_nframe=2, buf_nframe=64) as seq:
            t.start()
            for how, arr in plan:
                with seq.reserve(2) as span:
                    if how == "p":
                        span.publish_external(arr, 2)
                    else:
                        pkg.write(span, arr)
    assert done.wait(timeout=30)
    t.join(timeout=10)
    return got, ring


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_publish_external_zero_copy_plane(pkg):
    """tests/test_ring.py:420: reads straddling four published slices of
    one array alias it (no copy), and equal it."""
    src = np.arange(32 * 16, dtype=np.uint8).reshape(-1, 16)
    got, ring = _zc_stream(pkg, [("p", src[i:i + 2])
                                 for i in range(0, 32, 2)])
    np.testing.assert_array_equal(np.concatenate([g for g, _ in got]), src)
    assert all(np.shares_memory(v, src) for _, v in got)
    if pkg is _Port:
        assert ring.published_spans == 16


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_publish_external_discontiguous_assembles(pkg):
    """tests/test_ring.py:461: spans published from separate buffers are
    assembled into a correct copy."""
    srcs = [np.full((2, 16), 10 + i, np.uint8) for i in range(8)]
    got, _ = _zc_stream(pkg, [("p", s) for s in srcs])
    np.testing.assert_array_equal(np.concatenate([g for g, _ in got]),
                                  np.concatenate(srcs))
    assert not any(np.shares_memory(v, s) for _, v in got for s in srcs)


def test_mixed_published_and_copied_spans_match_jax():
    """Published and copied spans alternate (gulps of 4 and of 8 frames
    straddle both kinds): the ring's bytes under the copied ranges, the
    publisher's over the published, on both packages alike."""
    src = np.arange(32 * 16, dtype=np.uint8).reshape(-1, 16)
    plan = [("p" if i % 4 else "c", src[i:i + 2]) for i in range(0, 32, 2)]
    for gulp in (4, 8):
        out = {}
        for pkg in PKGS:
            got, _ = _zc_stream(pkg, plan, gulp)
            out[pkg.name] = np.concatenate([g for g, _ in got])
        np.testing.assert_array_equal(out["port"], src)
        np.testing.assert_array_equal(out["port"], out["jax"])


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_lossy_reader_past_the_tail(pkg):
    """A non-guaranteed reader lapped by a publishing writer: the spans
    the tail passed report every frame skipped, the newest span reads
    the publisher's bytes."""
    ring = pkg.ring()
    srcs = [np.full((4, 16), i, np.uint8) for i in range(10)]
    with ring.begin_writing() as w:
        with w.begin_sequence(ZC_HDR, gulp_nframe=4, buf_nframe=8) as seq:
            iseq = ring.open_earliest_sequence(guarantee=False)
            for s in srcs:
                with seq.reserve(4) as span:
                    span.publish_external(s, 4)
    span = iseq.acquire(0, 4)
    assert span.nframe_skipped == 4
    span.release()
    span = iseq.acquire(36, 4)
    assert span.nframe_skipped == 0
    np.testing.assert_array_equal(pkg.read(span), srcs[9])
    span.release()
    iseq.close()
    if pkg is _Port:
        # Expired entries let their buffers go: the plane holds only what
        # the tail has not passed.
        assert all(e[0] + e[1] > ring.tail for e in ring._ext_store)


def test_publish_external_refusals_and_tensor_buffers():
    src = torch.arange(4 * 16, dtype=torch.uint8).reshape(4, 16)
    ring = _Port.ring("zcref")
    got = []
    with ring.begin_writing() as w:
        with w.begin_sequence(ZC_HDR, gulp_nframe=4, buf_nframe=8) as seq:
            with seq.reserve(4) as span:
                with pytest.raises(ValueError, match="C-contiguous"):
                    span.publish_external(src.t())
                with pytest.raises(ValueError, match="needs 64"):
                    span.publish_external(src[:2].reshape(-1)[:32], 4)
                span.publish_external(src)           # a CPU tensor
            with ring.open_earliest_sequence() as r:
                with r.acquire(0, 4) as rs:
                    got.append(rs.data)
    assert torch.equal(got[0], src)
    assert got[0].data_ptr() == src.data_ptr()
    cuda = PortRing(space="cuda", name="zccuda", device="cpu")
    with cuda.begin_writing() as w:
        with w.begin_sequence(ZC_HDR, gulp_nframe=4) as seq:
            with seq.reserve(4) as span:
                with pytest.raises(ValueError, match="host rings"):
                    span.publish_external(src)
    many = PortRing(space="system", name="zcrl", device="cpu")
    hdr = {"name": "r", "time_tag": 0, "_tensor": {
        "dtype": "u8", "shape": [2, -1, 16]}}
    with many.begin_writing() as w:
        with w.begin_sequence(hdr, gulp_nframe=4) as seq:
            with seq.reserve(4) as span:
                with pytest.raises(ValueError, match="nringlet"):
                    span.publish_external(np.zeros((2, 4, 16), np.uint8))


# ------------------------------------------- tests/test_ring.py's mirrors
def _ghost_straddle(pkg):
    ring = pkg.ring("lazyghost")
    hdr = _hdr(nchan=4, dtype="i32")
    with ring.begin_writing() as writer:
        with writer.begin_sequence(hdr, gulp_nframe=3,
                                   buf_nframe=3) as oseq:
            iseq = ring.open_earliest_sequence(guarantee=False)
            for g in range(4):
                with oseq.reserve(1) as ospan:
                    pkg.write(ospan, np.full((1, 4), g, np.int32))
            with iseq.acquire(2, 2) as sp:
                got = pkg.read(sp)
            iseq.close()
    return got


def test_ghost_lazy_sync_delayed_straddle():
    """tests/test_ring.py:91: a read that wraps the capacity after
    aligned writes sees the current bytes."""
    got = _ghost_straddle(_Port)
    np.testing.assert_array_equal(got, np.array([[2] * 4, [3] * 4],
                                                np.int32))
    np.testing.assert_array_equal(got, _ghost_straddle(_Jax))


def _manual_guarantee(pkg):
    ring = pkg.ring("manualg")
    seen = []
    with ring.begin_writing() as writer:
        with writer.begin_sequence(_hdr(nchan=1, dtype="u8"), gulp_nframe=1,
                                   buf_nframe=2) as oseq:
            r1 = ring.open_earliest_sequence(guarantee=True)
            r2 = ring.open_earliest_sequence(guarantee=True)
            r1.set_guarantee_manual()
            for g in range(2):
                with oseq.reserve(1) as ospan:
                    pkg.write(ospan, np.full((1, 1), g, np.uint8))
            for f in range(2):
                with r1.acquire(f, 1) as sp:
                    seen.append(int(pkg.read(sp)[0, 0]))
            with pytest.raises(IOError):
                oseq.reserve(1, nonblocking=True)
            r1.advance_guarantee(0)             # backwards: a no-op
            with pytest.raises(IOError):
                oseq.reserve(1, nonblocking=True)
            r1.advance_guarantee(1)      # erases r1's entry, not r2's
            with pytest.raises(IOError):
                oseq.reserve(1, nonblocking=True)
            with r2.acquire(1, 1) as sp:
                seen.append(int(pkg.read(sp)[0, 0]))
            with oseq.reserve(1) as ospan:
                pkg.write(ospan, np.full((1, 1), 2, np.uint8))
            with r2.acquire(2, 1) as sp:
                seen.append(int(pkg.read(sp)[0, 0]))
            with pytest.raises(IOError):
                oseq.reserve(1, nonblocking=True)
            r1.advance_guarantee(2)
            with oseq.reserve(1) as ospan:
                pkg.write(ospan, np.full((1, 1), 3, np.uint8))
            with r2.acquire(3, 1) as sp:
                seen.append(int(pkg.read(sp)[0, 0]))
            r1.close()
            r2.close()
    return seen


def test_manual_guarantee_mode():
    """tests/test_ring.py:122 on the port's `set_guarantee_manual`:
    acquires leave a manual guarantee where it is, the writer stays
    blocked until `advance_guarantee`, advances are forward-only, and
    one reader's advance never frees another's equal guarantee."""
    seen = _manual_guarantee(_Port)
    assert seen == [0, 1, 1, 2, 3]
    assert seen == _manual_guarantee(_Jax)


def _live_resize(pkg):
    ring = pkg.ring("rsz")
    hdr = _hdr(nchan=2, dtype="i16")
    with ring.begin_writing() as w:
        with w.begin_sequence(hdr, gulp_nframe=4, buf_nframe=12) as oseq:
            iseq = ring.open_earliest_sequence(guarantee=True)
            for g in range(2):
                with oseq.reserve(4) as ospan:
                    pkg.write(ospan, np.full((4, 2), g, np.int16))
            ring.resize(4 * 4 * 2 * 2, 4 * 24 * 2, 1)
            for g in range(2, 6):
                with oseq.reserve(8) as ospan:
                    pkg.write(ospan, np.full((8, 2), g, np.int16))
    got = []
    for ispan in iseq.read(4):
        got.extend(pkg.read(ispan)[:, 0].tolist())
    iseq.close()
    return got


def test_live_resize():
    """tests/test_ring.py:246: growing the ring mid-stream keeps the
    committed data."""
    expect = [0] * 4 + [1] * 4 + sum(([g] * 8 for g in range(2, 6)), [])
    got = _live_resize(_Port)
    assert got == expect
    assert got == _live_resize(_Jax)


@pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
def test_reader_blocks_until_committed(pkg):
    """tests/test_ring.py:310."""
    ring = pkg.ring("blk")
    out = []

    def reader():
        for iseq in ring.read(guarantee=True):
            for ispan in iseq.read(4):
                out.append(pkg.read(ispan))

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    time.sleep(0.1)
    assert out == []
    with ring.begin_writing() as w:
        with w.begin_sequence(_hdr(nchan=1, dtype="u8"),
                              gulp_nframe=4) as oseq:
            time.sleep(0.1)
            assert out == []
            with oseq.reserve(4) as ospan:
                pkg.write(ospan, np.full((4, 1), 7, np.uint8))
    t.join(timeout=10)
    assert not t.is_alive()
    assert len(out) == 1 and (out[0] == 7).all()


def _ringlets(pkg):
    ring = pkg.ring("ringlets")
    hdr = {"name": "r", "time_tag": 0, "_tensor": {
        "dtype": "i32", "shape": [3, -1, 2],
        "labels": ["beam", "time", "pol"]}}
    want = np.arange(24, dtype=np.int32).reshape(3, 4, 2)
    with ring.begin_writing() as w:
        with w.begin_sequence(hdr, gulp_nframe=4) as oseq:
            with oseq.reserve(4) as ospan:
                assert tuple(ospan.data.shape) == (3, 4, 2)
                pkg.write(ospan, want)
    return [pkg.read(ispan) for iseq in ring.read(guarantee=True)
            for ispan in iseq.read(4)]


def test_ringlet_layout():
    """tests/test_ring.py:335: axes before the frame axis are ringlets,
    read back in the (ringlet, time, ...) layout."""
    got = _ringlets(_Port)
    assert len(got) == 1
    np.testing.assert_array_equal(
        got[0], np.arange(24, dtype=np.int32).reshape(3, 4, 2))
    np.testing.assert_array_equal(got[0], _ringlets(_Jax)[0])
