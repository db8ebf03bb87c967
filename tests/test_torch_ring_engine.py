"""The port's ring engine (bifrost_tpu_torch/csrc/ring.cpp under ring.py)
against the JAX package's (cpp/src/ring.cpp under bifrost_tpu/ring.py):
seeded sequences of ring operations (resize, sequence begin and end,
reserve, partial commit, cancel, open earliest / latest / by name / at a
time tag / next, acquire, release, manual guarantee and its advance,
interrupt generations and their ack) run on both rings, and after every
operation the tail, head, reserve head, interrupt state, the outcome
(value or status) and every byte read are equal.  Single-threaded: every
call that could wait is nonblocking, or blocking only where a pending
interrupt ends it at once.

Then what the engine gives the port beyond the old Python engine: the
capture engine enters Python once a sequence, not once a slot window,
and `Ring(core=)` binds its host pages to the core's NUMA node."""

import os
import sys
import time
import uuid

import numpy as np
import pytest
import torch

from bifrost_tpu import ring as jring
from bifrost_tpu.libbifrost_tpu import BifrostError
from bifrost_tpu.libbifrost_tpu import EndOfDataStop as JEndOfData
from bifrost_tpu.libbifrost_tpu import RingInterrupted as JInterrupted
from bifrost_tpu_torch import affinity
from bifrost_tpu_torch import ring as pring

FRAME = 32             # bytes a frame: u8 x 32 (sizes stay multiples of 16)
GULP, BUF = 4, 12      # frames a span at most, frames the ring holds
SEEDS = range(8)


def _outcome(fn):
    """('ok', value) or ('err', status) of one call on either package."""
    try:
        return ("ok", fn())
    except (JEndOfData, pring.EndOfDataStop):
        return ("err", 1)
    except (JInterrupted, pring.RingInterrupted):
        return ("err", 32)
    except BifrostError as e:
        return ("err", e.status)
    except OSError as e:          # WOULD_BLOCK: IOError / BlockingIOError
        return ("err", getattr(e, "status", 2))
    except (ValueError, RuntimeError, MemoryError) as e:
        return ("err", e.status)


def _header(name, tag):
    return {"name": name, "time_tag": int(tag), "_tensor": {
        "dtype": "u8", "shape": [-1, FRAME], "labels": ["time", "byte"]}}


class _Side(object):
    """One package's ring and the handles the schedule opened on it."""

    def __init__(self, mod, name):
        kw = {} if mod is jring else {"device": "cpu"}
        self.mod = mod
        self.ring = mod.Ring(space="system", name=name, **kw)
        self.wseq = None
        self.wspans = []       # open reservations, oldest first
        self.readers = []      # (ReadSequence, next frame)
        self.rspans = []       # held read spans
        self.gens = []

    def state(self):
        r = self.ring
        rh = r._info["reserve_head"] if self.mod is jring else r.reserve_head
        return (r.tail, r.head, rh, r.interrupt_info())

    def write(self, span, fill):
        if self.mod is jring:
            span.data[...] = fill
        else:
            span.data.copy_(torch.from_numpy(fill))

    def read(self, span):
        d = span.data
        return np.array(d if self.mod is jring else d.numpy()).copy()


def _step(rng, sides, ntag):
    """One seeded operation on both sides -> (op, outcomes)."""
    j, p = sides
    pending = j.ring.interrupt_info()[0] > j.ring.interrupt_info()[1]
    ops = ["reserve", "reserve", "commit", "commit", "partial", "cancel",
           "cancel_front", "open", "acquire", "acquire", "release", "close",
           "manual", "advance", "interrupt", "ack", "resize", "sequence"]
    op = ops[rng.integers(len(ops))]
    outs = []
    if op == "reserve":
        n = int(rng.integers(1, GULP + 1))
        for s in sides:
            outs.append(_outcome(lambda: s.wseq.reserve(
                n, nonblocking=not pending)))
        if outs[0][0] == "ok" and outs[1][0] == "ok":
            fill = rng.integers(0, 256, (n, FRAME), dtype=np.uint8)
            for s, o in zip(sides, outs):
                s.write(o[1], fill)
                s.wspans.append(o[1])
            outs = [("ok", (o[1].offset, o[1].nframe)) for o in outs]
    elif op in ("commit", "partial") and j.wspans:
        last = len(j.wspans) == 1
        n = j.wspans[0].nframe
        if op == "partial" and last:
            n = int(rng.integers(0, n + 1))
        for s in sides:
            outs.append(_outcome(lambda: s.wspans[0].commit(n)))
            s.wspans.pop(0)
    elif op in ("cancel", "cancel_front") and j.wspans:
        k = -1 if op == "cancel" else 0
        for s in sides:
            o = _outcome(lambda: s.wspans[k].cancel())
            outs.append(o)
            if o[0] == "ok":
                s.wspans.pop(k)
            else:
                s.wspans[k]._committed = False
    elif op == "open":
        which = ["earliest", "latest", "name", "at"][rng.integers(4)]
        name = f"seq{rng.integers(ntag + 1)}"
        tag = int(rng.integers(0, 40 * (ntag + 1)))
        guarantee = bool(rng.integers(2))
        for s in sides:
            o = _outcome(lambda: s.ring.open_sequence(
                which, name=name, time_tag=tag, guarantee=guarantee,
                nonblocking=not pending))
            if o[0] == "ok":
                s.readers.append([o[1], 0])
                o = ("ok", (o[1].name, o[1].time_tag, o[1].begin,
                            o[1].header))
            outs.append(o)
    elif op == "acquire" and j.readers:
        k = int(rng.integers(len(j.readers)))
        n = int(rng.integers(1, GULP + 1))
        hold = bool(rng.integers(2))
        for s in sides:
            rd = s.readers[k]
            o = _outcome(lambda: rd[0].acquire(rd[1], n,
                                               nonblocking=not pending))
            if o[0] == "ok":
                sp = o[1]
                rd[1] += sp.nframe
                o = ("ok", (sp.offset, sp.nframe, sp.nframe_skipped,
                            s.read(sp).tobytes()
                            if sp.nframe_skipped == 0 else None))
                if hold:
                    s.rspans.append(sp)
                else:
                    sp.release()
            outs.append(o)
    elif op == "release" and j.rspans:
        k = int(rng.integers(len(j.rspans)))
        for s in sides:
            outs.append(_outcome(lambda: s.rspans.pop(k).release()))
    elif op == "close" and j.readers:
        k = int(rng.integers(len(j.readers)))
        for s in sides:
            rseq = s.readers.pop(k)[0]
            s.rspans = [sp for sp in s.rspans if sp.rseq is not rseq]
            outs.append(_outcome(rseq.close))
    elif op == "manual" and j.readers:
        k = int(rng.integers(len(j.readers)))
        for s in sides:
            outs.append(_outcome(
                lambda: s.readers[k][0].set_guarantee_manual(True)))
    elif op == "advance" and j.readers:
        k = int(rng.integers(len(j.readers)))
        delta = int(rng.integers(0, 2 * GULP)) * FRAME
        for s in sides:
            rseq = s.readers[k][0]
            outs.append(_outcome(
                lambda: rseq.advance_guarantee(rseq.begin + delta)))
    elif op == "interrupt":
        target = int(rng.integers(1, 100))
        for s in sides:
            o = _outcome(lambda: s.ring.interrupt(target=target))
            s.gens.append(o[1])
            outs.append(o)
    elif op == "ack" and j.gens:
        g = j.gens[int(rng.integers(len(j.gens)))] + \
            int(rng.integers(0, 2))
        for s in sides:
            outs.append(_outcome(lambda: s.ring.ack_interrupt(g)))
    elif op == "resize" and (pending or not (j.wspans or j.rspans)):
        n = int(rng.integers(1, 4)) * GULP * FRAME
        for s in sides:
            outs.append(_outcome(lambda: s.ring.resize(n, 4 * n)))
    elif op == "sequence" and not j.wspans:
        tag = 40 * (ntag + 1)
        for s in sides:
            o1 = _outcome(s.wseq.end)
            o2 = _outcome(lambda: s.ring.begin_sequence(
                _header(f"seq{ntag + 1}", tag), GULP, BUF))
            if o2[0] == "ok":
                s.wseq = o2[1]
                o2 = ("ok", None)
            outs.append((o1, o2))
        return op, outs, ntag + 1
    return op, outs, ntag


def _drain(s):
    """What every reader still reads after the writer ended."""
    got = []
    for rd in s.readers:
        while True:
            o = _outcome(lambda: rd[0].acquire(rd[1], GULP,
                                               nonblocking=True))
            if o[0] != "ok":
                got.append(o)
                break
            sp = o[1]
            got.append((sp.offset, sp.nframe, sp.nframe_skipped,
                        s.read(sp).tobytes()
                        if sp.nframe_skipped == 0 else None))
            rd[1] += sp.nframe
            sp.release()
    return got


@pytest.mark.parametrize("seed", SEEDS)
def test_engine_schedule_matches_the_jax_engine(seed):
    rng = np.random.default_rng(seed)
    name = f"eng{seed}_{uuid.uuid4().hex[:8]}"
    sides = (_Side(jring, name + "_j"), _Side(pring, name + "_p"))
    for s in sides:
        s.ring.begin_writing()
        s.wseq = s.ring.begin_sequence(_header("seq0", 0), GULP, BUF)
    assert sides[0].state() == sides[1].state()
    ntag, seen = 0, set()
    for i in range(400):
        op, outs, ntag = _step(rng, sides, ntag)
        seen.add(op)
        assert outs[:1] == outs[1:] or not outs, (i, op, outs)
        assert sides[0].state() == sides[1].state(), (i, op)
    # Retire every fire, commit what is open, end: the readers drain.
    for s in sides:
        s.ring.clear_interrupt()
        for sp in s.rspans:
            sp.release()
        for sp in s.wspans:
            sp.commit()
        s.wseq.end()
        s.ring.end_writing()
    assert _drain(sides[0]) == _drain(sides[1])
    assert sides[0].state() == sides[1].state()
    assert {"reserve", "commit", "acquire", "open", "interrupt"} <= seen


# ------------------------------------------------- Python entries a window
def test_capture_enters_python_once_a_sequence():
    """A capture of many slot windows, with every Python function entered
    straight from inside the engine's recv counted (sys.setprofile: a
    frame whose caller is UDPCapture._call at its call into the engine),
    and every method of the port's ring classes counted: only the
    sequence-header callback runs, once, for the one sequence."""
    import inspect

    from bifrost_tpu_torch import udp
    from bifrost_tpu_torch.udp import UDPCapture, UDPSocket, UDPTransmit

    nsrc, payload, slot, nframe = 2, 64, 4, 256
    rx = UDPSocket().bind("127.0.0.1", 0)
    rx.set_timeout(0.05)
    ring = pring.Ring(space="system", name=f"entries_{uuid.uuid4().hex[:6]}")
    ncb = []

    def hdr_cb(seq0):
        ncb.append(seq0)
        return seq0, {"name": "entries", "_tensor": {
            "dtype": "u8", "shape": [-1, nsrc * payload]}}

    cap = UDPCapture("simple", rx, ring, nsrc=nsrc, src0=0,
                     max_payload_size=payload, buffer_ntime=nframe * 2,
                     slot_ntime=slot, header_callback=hdr_cb)
    recs, chunks, off = [], [], 0
    for t in range(nframe):
        for s in range(nsrc):
            pkt = np.array([t], "<u8").tobytes() + \
                np.array([s, 0], "<u2").tobytes() + bytes([t % 256]) * payload
            chunks.append(pkt)
            recs.append((off, len(pkt), (t * nsrc + s) * 50_000))
            off += len(pkt)
    tx_sock = UDPSocket().connect("127.0.0.1", rx.port)
    tx = UDPTransmit(tx_sock)

    counts = {}
    classes = (pring.Ring, pring.WriteSequence, pring.WriteSpan,
               pring.ReadSequence, pring.ReadSpan)
    saved = []
    for cls in classes:
        for key, fn in list(vars(cls).items()):
            if callable(fn) and not key.startswith("__"):
                def counted(*a, _fn=fn, _key=f"{cls.__name__}.{key}",
                            **k):
                    counts[_key] = counts.get(_key, 0) + 1
                    return _fn(*a, **k)
                saved.append((cls, key, fn))
                setattr(cls, key, counted)
    entries = []
    src, first = inspect.getsourcelines(UDPCapture._call)
    at_engine = first + next(i for i, ln in enumerate(src)
                             if "fn(self.obj" in ln)

    def prof(frame, event, arg):
        up = frame.f_back
        if event == "call" and up is not None and \
                up.f_code is UDPCapture._call.__code__ and \
                up.f_lineno == at_engine:
            entries.append(frame.f_code.co_name)

    try:
        tx.start_schedule(b"".join(chunks), udp.pack_transmit_records(recs),
                          batch_npkt=8)
        sys.setprofile(prof)
        try:
            deadline = time.time() + 20
            while time.time() < deadline:
                if cap.recv() == 3 and \
                        not tx.schedule_stats()["running"]:
                    break
        finally:
            sys.setprofile(None)
        walk = tx.wait_schedule()
        nwindow = cap.nwindow
    finally:
        for cls, key, fn in saved:
            setattr(cls, key, fn)
        tx_sock.shutdown()
    assert walk["nsent"] == nframe * nsrc and walk["ndropped"] == 0
    assert cap.stats["ngood"] >= (nframe - 2 * slot) * nsrc
    assert nwindow >= nframe // slot - 2
    assert counts == {}, counts
    assert ncb == [0] and entries == ["_cb"], entries
    cap.end()
    cap.close()
    rx.shutdown()


# --------------------------------------------------------------- NUMA
@pytest.mark.parametrize("bind", [True, False])
def test_ring_core_binds_host_pages_to_its_node(bind):
    """Ring(core=c) reports c back from the engine, and its host bytes,
    allocated at the first resize, prefer core c's NUMA node and lie on
    it (/proc/self/numa_maps, read only); a ring without a core keeps the
    default policy."""
    core = sorted(os.sched_getaffinity(0))[-1]
    node = affinity.core_node(core)
    ring = pring.Ring(space="system", name=f"numa_{uuid.uuid4().hex[:6]}",
                      core=core if bind else None)
    assert ring.core == (core if bind else None)
    assert ring.page_nodes() == ({}, set())
    ring.resize(1 << 20, 1 << 22)
    placed = ring.page_nodes()
    if placed is None or node is None:
        pytest.skip("this machine's kernel keeps no NUMA maps")
    nodes, policies = placed
    assert sum(nodes.values()) * os.sysconf("SC_PAGESIZE") >= 5 << 20
    if bind:
        assert f"prefer:{node}" in policies, policies
        assert node in nodes, nodes
    else:
        assert policies == {"default"}, policies
    ring.core = None
    assert ring.core is None
