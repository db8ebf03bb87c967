"""The port's named shm ring (bifrost_tpu_torch/shmring.py, its engine
csrc/shmring.cpp, and blocks/shmring.py) on the CPU: the cases of
tests/test_shmring.py and tests/test_shmring_faults.py on the port, and
the two packages on one segment across processes (a port writer read by
the JAX package's reader and the other way round), headers and bytes
equal.  Every wait on a child process has its own timeout.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from bifrost_tpu_torch.ring import EndOfDataStop
from bifrost_tpu_torch.shmring import (ShmPeerDied, ShmRingError,
                                       ShmRingReader, ShmRingWriter, unlink)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_shmring_roundtrip_in_process():
    name = f"torch_rt_{os.getpid()}"
    data = np.random.randint(0, 255, (3, 4096), dtype=np.uint8)
    hdr = {"name": "seq0", "time_tag": 42,
           "_tensor": {"dtype": "u8", "shape": [-1, 4096]}}
    got = {}
    attached = threading.Event()

    def consume():
        with ShmRingReader(name) as r:
            attached.set()
            h, tt = r.read_sequence()
            got["header"], got["tt"] = h, tt
            buf = np.empty_like(data)
            total = 0
            view = buf.reshape(-1)
            while total < buf.nbytes:
                n = r.readinto(view[total:])
                if n == 0:
                    break
                total += n
            got["data"] = buf
            got["nbyte"] = total

    with ShmRingWriter(name, data_capacity=8192) as w:   # forces wraparound
        t = threading.Thread(target=consume)
        t.start()
        attached.wait(timeout=10)
        w.begin_sequence(hdr)
        for row in data:
            w.write(row)
        w.end_sequence()
        t.join(timeout=30)
    assert got["header"] == hdr
    assert got["tt"] == 42
    assert got["nbyte"] == data.nbytes
    np.testing.assert_array_equal(got["data"], data)


def test_shmring_backpressure_no_overrun():
    """Writer must block rather than overrun a slow attached reader."""
    name = f"torch_bp_{os.getpid()}"
    nchunk, chunk = 64, 1024
    payload = np.random.randint(0, 255, nchunk * chunk, dtype=np.uint8)
    out = []
    attached = threading.Event()

    def consume():
        with ShmRingReader(name) as r:
            attached.set()
            r.read_sequence()
            buf = np.empty(chunk, np.uint8)
            while True:
                n = r.readinto(buf)
                if n == 0:
                    break
                out.append(buf[:n].copy())

    with ShmRingWriter(name, data_capacity=4096) as w:
        t = threading.Thread(target=consume)
        t.start()
        attached.wait(timeout=10)
        w.begin_sequence({"name": "bp"})
        w.write(payload)        # >> capacity: must interleave with reader
        w.end_sequence()
        t.join(timeout=30)
    np.testing.assert_array_equal(np.concatenate(out), payload)


CONSUMER = r"""
import sys, json
sys.path.insert(0, %(repo)r)
import numpy as np
from bifrost_tpu_torch.shmring import ShmRingReader
from bifrost_tpu_torch.ring import EndOfDataStop

name = sys.argv[1]
with ShmRingReader(name) as r:
    results = []
    for header, time_tag in r.sequences():
        buf = np.empty(header["_tensor"]["shape"][1] *
                       header["nframe_total"], np.float32)
        view = buf.view(np.uint8)
        total = 0
        while total < view.nbytes:
            n = r.readinto(view[total:])
            if n == 0:
                break
            total += n
        results.append((header["name"], time_tag, float(buf.sum())))
    print("RESULTS=" + json.dumps(results))
""" % {"repo": REPO}


def test_shmring_two_process_sequences():
    """The headline criterion: a second PROCESS attaches by name and
    receives sequences with headers intact."""
    name = f"torch_2p_{os.getpid()}"
    nframe, width = 16, 256
    rng = np.random.default_rng(3)
    seqs = [("scanA", 100, rng.random((nframe, width)).astype(np.float32)),
            ("scanB", 200, rng.random((nframe, width)).astype(np.float32))]

    with ShmRingWriter(name, data_capacity=1 << 20) as w:
        consumer = subprocess.Popen(
            [sys.executable, "-c", CONSUMER, name],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO)
        try:
            w.wait_for_readers(1, timeout=60)
            for sname, tt, data in seqs:
                w.begin_sequence({
                    "name": sname, "time_tag": tt,
                    "nframe_total": nframe,
                    "_tensor": {"dtype": "f32", "shape": [-1, width]}})
                for frame in data:
                    w.write(frame)
                w.end_sequence()
            w.end_writing()
            out, err = consumer.communicate(timeout=60)
        finally:
            if consumer.poll() is None:
                consumer.kill()
    assert consumer.returncode == 0, err[-2000:]
    import json
    line = [ln for ln in out.splitlines() if ln.startswith("RESULTS=")]
    assert line, out + err
    results = json.loads(line[0][len("RESULTS="):])
    assert len(results) == 2
    for (sname, tt, checksum), (wname, wtt, wdata) in zip(results, seqs):
        assert sname == wname and tt == wtt
        np.testing.assert_allclose(checksum, float(wdata.sum()), rtol=1e-6)


def test_shm_pipeline_blocks_cross_process():
    """Full pipeline integration: producer pipeline -> shm_send; a separate
    process runs shm_receive -> collect, headers and data intact."""
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.pipeline import Pipeline
    from bifrost_tpu_torch.blocks.testing import array_source

    name = f"torch_pipe_{os.getpid()}"
    data = np.random.rand(32, 64).astype(np.float32)

    consumer_code = r"""
import sys, json
sys.path.insert(0, %(repo)r)
import numpy as np
from bifrost_tpu_torch import blocks
from bifrost_tpu_torch.pipeline import Pipeline
from bifrost_tpu_torch.blocks.testing import callback_sink
chunks, headers = [], []
with Pipeline(device="cpu") as pipe:
    src = blocks.shm_receive(%(name)r, gulp_nframe=8)
    callback_sink(src, on_sequence=headers.append,
                  on_data=lambda d: chunks.append(np.array(d)))
    pipe.run()
out = np.concatenate(chunks, axis=0)
print("SHAPE=" + json.dumps(list(out.shape)))
print("SUM=%%.6f" %% float(out.sum()))
print("LABELS=" + json.dumps(headers[0]["_tensor"]["labels"]))
""" % {"repo": REPO, "name": name}

    consumer = subprocess.Popen(
        [sys.executable, "-c", consumer_code],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        with Pipeline(device="cpu") as pipe:
            src = array_source(data, 8, header={"labels": ["time", "x"]})
            snd = blocks.shm_send(src, name, min_readers=1)
            pipe.run()
            snd.shutdown()
        out, err = consumer.communicate(timeout=60)
    finally:
        if consumer.poll() is None:
            consumer.kill()
    assert consumer.returncode == 0, err[-2000:]
    import json
    vals = dict(ln.split("=", 1) for ln in out.splitlines() if "=" in ln)
    assert json.loads(vals["SHAPE"]) == [32, 64]
    np.testing.assert_allclose(float(vals["SUM"]), float(data.sum()),
                               rtol=1e-5)
    assert json.loads(vals["LABELS"]) == ["time", "x"]


def test_shmring_mid_sequence_attach_no_deadlock():
    """A reader attaching mid-sequence must not back-pressure the writer
    into deadlock; it skips the in-flight sequence and gets the next one."""
    name = f"torch_mid_{os.getpid()}"
    with ShmRingWriter(name, data_capacity=4096) as w:
        w.begin_sequence({"name": "first"})
        w.write(np.zeros(1024, np.uint8))       # data flowed: seq in flight
        got = {}
        attached = threading.Event()

        def consume():
            with ShmRingReader(name) as r:
                attached.set()                  # attached while seq1 rolls
                h, _ = r.read_sequence()        # must be the SECOND seq
                got["name"] = h["name"]
                buf = np.empty(8192, np.uint8)
                n = r.readinto(buf)
                got["sum"] = int(buf[:n].sum())

        t = threading.Thread(target=consume)
        t.start()
        attached.wait(timeout=10)
        # Writer keeps writing well past capacity with the lagging reader
        # attached: the old code deadlocked here.
        w.write(np.zeros(16384, np.uint8))
        w.end_sequence()
        w.begin_sequence({"name": "second"})
        w.write(np.full(8192, 7, np.uint8))
        w.end_sequence()
        t.join(timeout=30)
        assert not t.is_alive(), "reader deadlocked"
    assert got["name"] == "second"
    assert got["sum"] == 7 * 8192


def test_shmring_no_cross_sequence_bleed():
    """after a reader drains sequence N, the writer may
    begin N+1 (the begin gate passes) before the reader's next read call
    observes N's end.  That read must return 0 (sequence consumed), never
    N+1's bytes — and N+1 must then arrive intact via read_sequence."""
    name = f"torch_bleed_{os.getpid()}"
    data_a = np.full(1024, 1, np.uint8)
    data_b = np.full(2048, 2, np.uint8)
    with ShmRingWriter(name, data_capacity=1 << 16) as w:
        with ShmRingReader(name) as r:
            w.begin_sequence({"name": "A"})
            w.write(data_a)
            h, _ = r.read_sequence()
            assert h["name"] == "A"
            buf = np.empty_like(data_a)
            assert r.readinto(buf) == data_a.nbytes   # drain A fully
            # Reader has drained: the writer's SequenceBegin gate passes and
            # B begins + carries data before the reader sees A's end.
            w.end_sequence()
            w.begin_sequence({"name": "B"})
            w.write(data_b)
            # The bleed: old code recomputed the limit from B and returned
            # B's bytes as A's data here.
            tail_buf = np.empty(4096, np.uint8)
            assert r.readinto(tail_buf) == 0, \
                "read crossed into an unopened sequence"
            h, _ = r.read_sequence()
            assert h["name"] == "B"
            buf_b = np.empty_like(data_b)
            assert r.readinto(buf_b) == data_b.nbytes
            np.testing.assert_array_equal(buf_b, data_b)
            w.end_sequence()
            w.end_writing()


def test_shmring_create_refuses_live_segment():
    """a second creator must NOT silently unlink a
    segment whose writer is alive — that would split peers across two
    segments with no error."""
    name = f"torch_live_{os.getpid()}"
    w1 = ShmRingWriter(name, data_capacity=4096)
    try:
        with pytest.raises(Exception, match="live writer"):
            ShmRingWriter(name, data_capacity=4096)
    finally:
        w1.end_writing()
        # Close WITHOUT unlink: the segment stays linked with writer_pid
        # cleared, so the next create exercises the clean-close reclaim
        # path (EEXIST -> inspect -> pid released -> reclaim).
        w1.close(unlink=False)
    w2 = ShmRingWriter(name, data_capacity=4096)
    w2.close(unlink=True)


def test_shmring_create_reclaims_dead_writer_segment():
    """A segment whose creator died without closing (crashed run) is stale
    and must be reclaimed by the next creator."""
    name = f"torch_stale_{os.getpid()}"
    code = (f"import sys, os; sys.path.insert(0, {REPO!r})\n"
            f"from bifrost_tpu_torch.shmring import ShmRingWriter\n"
            f"w = ShmRingWriter({name!r}, data_capacity=4096)\n"
            f"os._exit(0)  # die without close/unlink\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
    w = ShmRingWriter(name, data_capacity=4096)   # must reclaim, not raise
    w.close(unlink=True)


def test_shmring_header_larger_than_reader_buffer():
    """a header bigger than the reader's buffer must be
    delivered intact (grow + retry), not silently truncated into a
    JSONDecodeError."""
    name = f"torch_bighdr_{os.getpid()}"
    big = {"name": "big", "blob": "x" * (100 * 1024),
           "_tensor": {"dtype": "u8", "shape": [-1]}}
    with ShmRingWriter(name, data_capacity=4096,
                       hdr_capacity=1 << 18) as w:
        with ShmRingReader(name) as r:           # default 64 KiB buffer
            w.begin_sequence(big)
            h, _ = r.read_sequence()
            assert h == big
            w.end_sequence()
            w.end_writing()


def test_shm_send_ends_writing_on_pipeline_completion():
    """when the producer pipeline completes normally,
    ShmSendBlock must end_writing() so the remote consumer terminates even
    if the user never calls shutdown()."""
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.pipeline import Pipeline
    from bifrost_tpu_torch.blocks.testing import array_source

    name = f"torch_eow_{os.getpid()}"
    data = np.random.rand(16, 32).astype(np.float32)

    consumer_code = r"""
import sys, json
sys.path.insert(0, %(repo)r)
import numpy as np
from bifrost_tpu_torch.shmring import ShmRingReader
with ShmRingReader(%(name)r) as r:
    total = 0.0
    for header, _ in r.sequences():      # terminates only on END_OF_DATA
        buf = np.empty(16 * 32, np.float32)
        view = buf.view(np.uint8)
        got = 0
        while got < view.nbytes:
            n = r.readinto(view[got:])
            if n == 0:
                break
            got += n
        total += float(buf[:got // 4].sum())
print("TOTAL=%%.6f" %% total)
""" % {"repo": REPO, "name": name}

    consumer = subprocess.Popen(
        [sys.executable, "-c", consumer_code],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    snd = None
    try:
        with Pipeline(device="cpu") as pipe:
            src = array_source(data, 8)
            snd = blocks.shm_send(src, name, min_readers=1)
            pipe.run()
            # Deliberately NO snd.shutdown() here: completion of main()
            # must be enough for the consumer to see END_OF_DATA.
        out, err = consumer.communicate(timeout=30)
    finally:
        if consumer.poll() is None:
            consumer.kill()
        if snd is not None:
            snd.shutdown()               # cleanup (unlink) only
    assert consumer.returncode == 0, err[-2000:]
    total = float(out.split("TOTAL=")[1].strip())
    np.testing.assert_allclose(total, float(data.sum()), rtol=1e-5)


def test_shm_receive_rejects_sub_byte_frames():
    """sub-byte frame sizes must raise a clear error, not
    a ZeroDivisionError in on_data."""
    import types
    from bifrost_tpu_torch.blocks.shmring import ShmReceiveBlock

    dummy = types.SimpleNamespace(_shm_name="x")
    with pytest.raises(ValueError, match="sub-byte"):
        ShmReceiveBlock._set_frame_geometry(
            dummy, {"_tensor": {"dtype": "i4", "shape": [-1, 3]}})
    with pytest.raises(ValueError, match="zero-byte"):
        ShmReceiveBlock._set_frame_geometry(
            dummy, {"_tensor": {"dtype": "f32", "shape": [-1, 0]}})


def test_shm_receive_shutdown_interrupt():
    """Pipeline shutdown must wake a blocked shm_receive thread so its
    reader slot is released (review: leaked slot stalls the producer)."""
    import time
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.pipeline import Pipeline
    from bifrost_tpu_torch.blocks.testing import callback_sink

    name = f"torch_int_{os.getpid()}"
    with ShmRingWriter(name, data_capacity=4096) as w:   # never writes
        done = {}

        def run_consumer():
            with Pipeline(device="cpu") as pipe:
                src = blocks.shm_receive(name)
                callback_sink(src, on_data=lambda d: None)
                t = threading.Timer(0.5, pipe.shutdown)
                t.start()
                pipe.run()
                t.cancel()
            done["ok"] = True

        th = threading.Thread(target=run_consumer)
        th.start()
        th.join(timeout=20)
        assert not th.is_alive(), "consumer pipeline did not shut down"
        assert done.get("ok")
        # the reader slot must be free again
        deadline = time.monotonic() + 5
        while w.num_readers() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert w.num_readers() == 0


def test_dada_header_roundtrip_cross_process():
    """DADA-compat shim (docs/dada-migration.md): producer sends with
    DADA ASCII headers over the shm transport; a consumer in another
    process uses the reference-signature read_psrdada_buffer with a
    header_callback over the parsed DADA dict."""
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.blocks.psrdada import (parse_dada_header,
                                            serialize_dada_header)
    from bifrost_tpu_torch.pipeline import Pipeline
    from bifrost_tpu_torch.blocks.testing import array_source

    # Unit round-trip of the ASCII format first.
    hdr = {"NCHAN": 64, "TSAMP": 1.28, "SOURCE": "J0000+0000"}
    parsed = parse_dada_header(serialize_dada_header(hdr) + "\0garbage")
    assert parsed == hdr

    name = f"torch_dada_{os.getpid()}"
    data = np.random.rand(32, 16).astype(np.float32)

    consumer_code = r"""
import sys, json
sys.path.insert(0, %(repo)r)
import numpy as np
from bifrost_tpu_torch import blocks
from bifrost_tpu_torch.pipeline import Pipeline
from bifrost_tpu_torch.blocks.testing import callback_sink

def header_callback(dada):
    assert dada["NCHAN"] == 16, dada
    return {"_tensor": {"dtype": "f32", "shape": [-1, dada["NCHAN"]],
                        "labels": ["time", "freq"]}}

chunks = []
with Pipeline(device="cpu") as pipe:
    src = blocks.read_psrdada_buffer(%(name)r, header_callback,
                                     gulp_nframe=8)
    callback_sink(src, on_data=lambda d: chunks.append(np.array(d)))
    pipe.run()
out = np.concatenate(chunks, axis=0)
print("SUM=%%.6f SHAPE=%%s" %% (float(out.sum()), out.shape))
""" % {"repo": REPO, "name": name}

    consumer = subprocess.Popen(
        [sys.executable, "-c", consumer_code],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        with Pipeline(device="cpu") as pipe:
            src = array_source(data, 8, header={
                "NCHAN": 16, "TSAMP": 1.28,
                "labels": ["time", "freq"]})
            blocks.dada_shm_send(src, name, min_readers=1)
            pipe.run()
        out, err = consumer.communicate(timeout=30)
    finally:
        if consumer.poll() is None:
            consumer.kill()
    assert consumer.returncode == 0, err[-2000:]
    np.testing.assert_allclose(float(out.split("SUM=")[1].split()[0]),
                               float(data.sum()), rtol=1e-5)


def test_shmring_interrupt_is_reARMable():
    """Handle-local shm interrupts are generation-counted: after an
    interrupt wakes a blocked reader (the supervised deadman shape),
    clear_interrupt() retires it and blocking use RESUMES on the same
    handle — impossible with the old one-way latch."""
    import uuid
    name = f"bt_torch_intr_{uuid.uuid4().hex[:8]}"
    with ShmRingWriter(name, data_capacity=1 << 16) as writer:
        reader = ShmRingReader(name)
        got = []

        def blocked_read():
            try:
                got.append(reader.read_sequence())
            except Exception as e:  # noqa: BLE001 — asserted below
                got.append(e)

        t = threading.Thread(target=blocked_read, daemon=True)
        t.start()
        import time
        time.sleep(0.2)
        reader.interrupt()
        t.join(timeout=5)
        assert not t.is_alive()
        assert isinstance(got[0], Exception)          # woke interrupted

        reader.clear_interrupt()                       # re-arm the handle
        writer.begin_sequence({"obs": "resumed"}, time_tag=5)
        hdr, tt = reader.read_sequence()               # blocks + succeeds
        assert hdr == {"obs": "resumed"} and tt == 5
        writer.end_sequence()
        reader.close()


def test_shmring_write_reserve_commit_view():
    """The zero-copy write-span pair (btShmRingWriteReserve/Commit):
    reserved views land bytes a reader receives exactly, runs shorten at
    the capacity wrap (the caller loops), and a commit past the proven
    free space is refused — the egress plane's shm destination contract
    (bifrost_tpu/egress.py / blocks/shmring.py _ShmSpanDest)."""
    name = f"torch_rsv_{os.getpid()}"
    data = np.random.default_rng(3).integers(
        0, 255, 3 * 4096, dtype=np.uint8).reshape(3, 4096)
    hdr = {"name": "seq0", "time_tag": 1,
           "_tensor": {"dtype": "u8", "shape": [-1, 4096]}}
    got = {}
    attached = threading.Event()

    def consume():
        with ShmRingReader(name) as r:
            attached.set()
            r.read_sequence()
            buf = np.empty_like(data).reshape(-1)
            total = 0
            while total < buf.nbytes:
                n = r.readinto(buf[total:])
                if n == 0:
                    break
                total += n
            got["data"], got["nbyte"] = buf.reshape(data.shape), total

    with ShmRingWriter(name, data_capacity=8192) as w:   # forces the wrap
        t = threading.Thread(target=consume)
        t.start()
        attached.wait(timeout=10)
        w.begin_sequence(hdr)
        flat = data.reshape(-1)
        done = 0
        runs = []
        while done < flat.nbytes:
            view = w.reserve_view(flat.nbytes - done)
            assert view.nbytes > 0
            runs.append(view.nbytes)
            view[...] = flat[done:done + view.nbytes]
            w.commit_view(view.nbytes)
            done += view.nbytes
        # 12288 B through an 8192 B ring: at least one run had to stop
        # short at the wrap.
        assert len(runs) >= 2
        # Publishing more than the reserve proved free is refused.
        with pytest.raises(ShmRingError, match="free space"):
            w.commit_view(8192 * 2)
        w.end_sequence()
        t.join(timeout=30)
    assert got["nbyte"] == data.nbytes
    np.testing.assert_array_equal(got["data"], data)


def test_shm_send_shutdown_interrupt_during_backpressure():
    """A producer pipeline stalled on shm-ring
    back-pressure (reader attached but not consuming) must be unblocked
    by Pipeline.shutdown() via ShmSendBlock.on_shutdown's writer
    interrupt — covering both the blocking write path (host input ring)
    and the egress worker's reserve_view wait (device input ring,
    staged)."""
    import time
    from bifrost_tpu_torch import blocks as bf_blocks, config
    from bifrost_tpu_torch.pipeline import Pipeline
    from bifrost_tpu_torch.blocks.testing import array_source

    for staged in (False, True):
        name = f"torch_bp{int(staged)}_{os.getpid()}"
        # 16 KiB of frames through a 4 KiB ring nobody drains.
        data = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
        stalled = {}

        def run_producer():
            config.set("egress_staging", staged)
            config.set("pipeline_async_depth", 4 if staged else 1)
            try:
                with Pipeline(device="cpu") as pipe:
                    src = array_source(data, 8)
                    up = bf_blocks.copy(src, space="cuda") if staged else src
                    bf_blocks.shm_send(up, name, data_capacity=4096,
                                       min_readers=1)
                    stalled["pipe"] = pipe
                    pipe.run()
                stalled["ok"] = True
            finally:
                config.reset("pipeline_async_depth")
                config.reset("egress_staging")

        th = threading.Thread(target=run_producer)
        th.start()
        # Attach a reader that consumes the sequence header and nothing
        # else: the writer fills the 4 KiB ring and blocks.
        deadline = time.monotonic() + 10
        reader = None
        while reader is None:
            try:
                reader = ShmRingReader(name)
            except Exception:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.02)
        try:
            reader.read_sequence()
            time.sleep(0.7)            # let the producer hit back-pressure
            assert th.is_alive(), "producer finished without back-pressure"
            stalled["pipe"].shutdown()
            th.join(timeout=20)
            assert not th.is_alive(), \
                f"shutdown did not unblock the stalled producer " \
                f"(staged={staged})"
        finally:
            reader.close()
            if th.is_alive():
                th.join(timeout=5)


# -------------------------------------------- peers dying mid-stream
READER_STALL = r"""
import sys, os, time
sys.path.insert(0, %(repo)r)
from bifrost_tpu_torch.shmring import ShmRingReader
r = ShmRingReader(%(name)r)
hdr, tt = r.read_sequence()
print("ATTACHED", flush=True)
time.sleep(600)          # stay alive but never read: pure backpressure
"""

WRITER_CRASH = r"""
import sys, os
sys.path.insert(0, %(repo)r)
import numpy as np
from bifrost_tpu_torch.shmring import ShmRingWriter
w = ShmRingWriter(%(name)r, data_capacity=1 << 16)
w.begin_sequence({"name": "s0", "time_tag": 1,
                  "_tensor": {"dtype": "u8", "shape": [-1, 256]}})
print("BEGUN", flush=True)
sys.stdin.readline()    # wait until the reader has joined s0
w.write((np.arange(256 * 8, dtype=np.uint32) %% 251).astype(np.uint8))
print("WROTE", flush=True)
os._exit(9)   # crash mid-sequence: no end_sequence, no close
"""


def test_killed_reader_slot_reaped():
    """Writer blocked on a dead consumer's backpressure must reap the
    slot and finish; a fresh consumer then streams the NEXT sequence
    uncorrupted."""
    name = f"torch_fault_rdr_{os.getpid()}"
    stall = subprocess.Popen(
        [sys.executable, "-c", READER_STALL % {"repo": REPO, "name": name}],
        stdout=subprocess.PIPE, text=True, cwd=REPO)
    try:
        # Small capacity: the stalled reader's tail back-pressures the
        # writer within a few gulps.
        with ShmRingWriter(name, data_capacity=1 << 14) as w:
            hdr = {"name": "s0", "time_tag": 7,
                   "_tensor": {"dtype": "u8", "shape": [-1, 256]}}
            w.begin_sequence(hdr)
            assert stall.stdout.readline().strip() == "ATTACHED"
            data = (np.arange(256 * 256, dtype=np.uint32) % 251).astype(
                np.uint8).reshape(256, 256)
            fault = threading.Event()

            def kill_later():
                fault.wait(timeout=30)
                time.sleep(0.2)          # let the writer block
                stall.kill()
                # reap the zombie: kill(pid, 0) keeps succeeding on an
                # unreaped child, so liveness can only see ESRCH after
                # the wait (real crashed consumers are reaped by init)
                stall.wait(timeout=10)

            t = threading.Thread(target=kill_later)
            t.start()
            # writes exceed capacity -> blocks on the stalled reader; the
            # kill thread then removes it and the reap must unblock us.
            fault.set()
            t0 = time.monotonic()
            for row in data:
                w.write(np.tile(row, 4))
            w.end_sequence()
            assert time.monotonic() - t0 < 20, "writer did not unwedge"
            t.join(timeout=10)

            # second sequence: a fresh consumer gets clean data
            got = {}
            attached = threading.Event()

            def consume():
                with ShmRingReader(name) as r:
                    attached.set()
                    h, tt = r.read_sequence()
                    buf = np.empty(256 * 64, np.uint8)
                    total = 0
                    while total < buf.nbytes:
                        n = r.readinto(buf[total:])
                        if n == 0:
                            break
                        total += n
                    got["data"] = buf[:total]
                    got["hdr"] = h

            c = threading.Thread(target=consume)
            c.start()
            assert attached.wait(timeout=10)
            payload = (np.arange(256 * 64, dtype=np.uint32) % 253).astype(
                np.uint8)
            w.begin_sequence({"name": "s1", "time_tag": 8,
                              "_tensor": {"dtype": "u8",
                                          "shape": [-1, 256]}})
            w.write(payload)
            w.end_sequence()
            c.join(timeout=30)
            assert not c.is_alive()
            np.testing.assert_array_equal(got["data"], payload)
            assert got["hdr"]["name"] == "s1"
    finally:
        if stall.poll() is None:
            stall.kill()
        stall.wait(timeout=10)


def test_killed_writer_detected_by_blocked_reader():
    """A reader blocked mid-sequence on a SIGKILLed producer gets
    ShmPeerDied (failure detection), with pre-fault bytes intact."""
    name = f"torch_fault_wtr_{os.getpid()}"
    crash = subprocess.Popen(
        [sys.executable, "-c", WRITER_CRASH % {"repo": REPO, "name": name}],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=REPO)
    assert crash.stdout.readline().strip() == "BEGUN"
    with ShmRingReader(name) as r:
        hdr, tt = r.read_sequence()   # join s0 before any data flows
        crash.stdin.write("go\n")
        crash.stdin.flush()
        assert crash.stdout.readline().strip() == "WROTE"
        crash.wait(timeout=15)
        assert hdr["name"] == "s0" and tt == 1
        buf = np.empty(256 * 8, np.uint8)
        total = 0
        while total < buf.nbytes:
            n = r.readinto(buf[total:])
            if n == 0:
                break
            total += n
        # committed bytes arrive uncorrupted
        np.testing.assert_array_equal(
            buf[:total],
            (np.arange(total, dtype=np.uint32) % 251).astype(np.uint8))
        # ...and the next blocking call reports the dead producer rather
        # than hanging or claiming normal end-of-data
        with pytest.raises((ShmPeerDied, EndOfDataStop)) as excinfo:
            while True:
                n = r.readinto(buf)
                if n == 0:
                    r.read_sequence()   # blocks for the next sequence
        assert excinfo.type is ShmPeerDied
    unlink(name)                        # the dead writer left its name


@pytest.mark.skipif(not os.environ.get("BIFROST_TPU_SOAK"),
                    reason="opt-in soak (set BIFROST_TPU_SOAK=seconds)")
def test_soak_kill_reattach_cycle():
    """Minutes-long churn: consumers repeatedly SIGKILLed mid-stream and
    replaced while one writer streams sequences; the writer must never
    wedge."""
    name = f"torch_fault_soak_{os.getpid()}"
    seconds = float(os.environ["BIFROST_TPU_SOAK"])
    deadline = time.monotonic() + seconds
    seq = 0
    with ShmRingWriter(name, data_capacity=1 << 15) as w:
        while time.monotonic() < deadline:
            stall = subprocess.Popen(
                [sys.executable, "-c",
                 READER_STALL % {"repo": REPO, "name": name}],
                stdout=subprocess.PIPE, text=True, cwd=REPO)
            w.begin_sequence({"name": f"s{seq}", "time_tag": seq,
                              "_tensor": {"dtype": "u8",
                                          "shape": [-1, 256]}})
            assert stall.stdout.readline().strip() == "ATTACHED"
            killer = threading.Timer(
                0.1, lambda: (stall.kill(), stall.wait(timeout=10)))
            killer.start()
            payload = (np.arange(256 * 128, dtype=np.uint32) %
                       (seq % 200 + 50)).astype(np.uint8)
            t0 = time.monotonic()
            w.write(payload)
            w.end_sequence()
            assert time.monotonic() - t0 < 20, "writer wedged"
            killer.join()
            stall.wait(timeout=10)
            seq += 1
    assert seq > 3


# ------------------------------------------ the two packages on one ring
def _child_env():
    return dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")


@pytest.mark.parametrize("writer_pkg", ["bifrost_tpu_torch", "bifrost_tpu"])
def test_a_writer_of_one_package_feeds_a_reader_of_the_other(writer_pkg):
    """One segment, both engines in one process: the port's writer and the
    JAX reader (and the other way round) move a sequence through the wrap
    with its header and bytes equal."""
    import importlib
    reader_pkg = ("bifrost_tpu" if writer_pkg == "bifrost_tpu_torch"
                  else "bifrost_tpu_torch")
    W = importlib.import_module(f"{writer_pkg}.shmring").ShmRingWriter
    R = importlib.import_module(f"{reader_pkg}.shmring").ShmRingReader
    name = f"torch_x_{writer_pkg[-5:]}_{os.getpid()}"
    data = np.random.default_rng(5).integers(0, 255, (5, 3000),
                                             dtype=np.uint8)
    hdr = {"name": "x", "time_tag": 9,
           "_tensor": {"dtype": "u8", "shape": [-1, 3000]}}
    got = {}

    def consume():
        with R(name) as r:
            got["hdr"], got["tt"] = r.read_sequence()
            buf = np.empty(data.size, np.uint8)
            total = 0
            while total < buf.nbytes:
                n = r.readinto(buf[total:])
                if n == 0:
                    break
                total += n
            got["data"] = buf[:total]

    with W(name, data_capacity=4096) as w:
        t = threading.Thread(target=consume)
        t.start()
        w.wait_for_readers(1, timeout=30)
        w.begin_sequence(hdr)
        for row in data:
            w.write(row)
        w.end_sequence()
        t.join(timeout=30)
        assert not t.is_alive()
    assert got["hdr"] == hdr and got["tt"] == 9
    np.testing.assert_array_equal(got["data"], data.reshape(-1))


_JAX_RECEIVER = r"""
import json, sys
import numpy as np
from bifrost_tpu import blocks
from bifrost_tpu.pipeline import Pipeline
chunks, headers = [], []
with Pipeline() as pipe:
    src = blocks.shm_receive(sys.argv[1], gulp_nframe=8)
    blocks.callback_sink(src, on_sequence=headers.append,
                         on_data=lambda d: chunks.append(np.array(d)))
    pipe.run()
np.concatenate(chunks).tofile(sys.argv[2])
print("HEADER=" + json.dumps(headers[0], sort_keys=True))
"""

_JAX_SENDER = r"""
import json, sys
import numpy as np
from bifrost_tpu import blocks
from bifrost_tpu.pipeline import Pipeline
from bifrost_tpu.blocks.testing import array_source
data = np.fromfile(sys.argv[2], np.float32).reshape(-1, 64)
headers = []
with Pipeline() as pipe:
    src = array_source(data, 8, header={"labels": ["time", "x"]})
    blocks.callback_sink(src, on_sequence=headers.append)
    blocks.shm_send(src, sys.argv[1], min_readers=1, reader_timeout=120)
    pipe.run()
print("HEADER=" + json.dumps(headers[0], sort_keys=True))
"""


def _header_line(out):
    line = [ln for ln in out.splitlines() if ln.startswith("HEADER=")]
    assert line, out
    return json.loads(line[0][len("HEADER="):])


def test_port_shm_send_is_read_by_the_jax_shm_receive(tmp_path):
    """A port pipeline's shm_send read by the JAX package's shm_receive in
    another process: the header and every byte arrive as sent."""
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.blocks.testing import array_source, gather_sink
    from bifrost_tpu_torch.pipeline import Pipeline
    name = f"torch_p2j_{os.getpid()}"
    data = np.random.default_rng(6).random((40, 64)).astype(np.float32)
    out_file = tmp_path / "got.bin"
    child = subprocess.Popen(
        [sys.executable, "-c", _JAX_RECEIVER, name, str(out_file)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=_child_env())
    try:
        headers = []
        with Pipeline(device="cpu") as pipe:
            src = array_source(data, 8, header={"labels": ["time", "x"]})
            gather_sink(src, [], headers)
            blocks.shm_send(src, name, min_readers=1, reader_timeout=120)
            pipe.run()
        out, err = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    assert child.returncode == 0, err[-2000:]
    assert _header_line(out) == json.loads(json.dumps(headers[0]))
    got = np.fromfile(out_file, np.float32).reshape(data.shape)
    assert np.array_equal(got.view(np.uint32), data.view(np.uint32))


def test_jax_shm_send_is_read_by_the_port_shm_receive(tmp_path):
    """The JAX package's shm_send read by the port's shm_receive: the
    header and every byte arrive as the JAX pipeline sent them."""
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.blocks.testing import gather_sink
    from bifrost_tpu_torch.pipeline import Pipeline
    name = f"torch_j2p_{os.getpid()}"
    data = np.random.default_rng(7).random((40, 64)).astype(np.float32)
    data_file = tmp_path / "sent.bin"
    data.tofile(data_file)
    child = subprocess.Popen(
        [sys.executable, "-c", _JAX_SENDER, name, str(data_file)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=_child_env())
    try:
        chunks, headers = [], []
        with Pipeline(device="cpu") as pipe:
            gather_sink(blocks.shm_receive(name, gulp_nframe=8), chunks,
                        headers)
            pipe.run()
        out, err = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    assert child.returncode == 0, err[-2000:]
    assert json.loads(json.dumps(headers[0])) == _header_line(out)
    got = np.concatenate(chunks)
    assert np.array_equal(got.view(np.uint32), data.view(np.uint32))


def test_ringlet_stream_goes_on_the_ring_frame_by_frame():
    """A stream whose frame axis is second (the FDMT's (dispersion, time))
    goes on the ring frame-major, staged and blocking alike, under a
    header that says so (frame axis first, labels moved with their axes),
    and the port's shm_receive reads it back, at another gulp size, as
    that (time, dispersion) stream."""
    from bifrost_tpu_torch import blocks, config
    from bifrost_tpu_torch.blocks.testing import array_source, gather_sink
    from bifrost_tpu_torch.pipeline import Pipeline
    data = np.random.default_rng(8).random((48, 6)).astype(np.float32)
    for staged in (True, False):
        name = f"torch_rl{int(staged)}_{os.getpid()}"
        config.set("egress_staging", staged)
        try:
            raw = {}

            def read_raw():
                with ShmRingReader(name) as r:
                    raw["hdr"], _ = r.read_sequence()
                    buf = np.empty(data.size, np.float32)
                    raw["n"] = r.readinto(buf)
                    raw["data"] = buf

            t = threading.Thread(target=read_raw)
            t.start()
            with Pipeline(device="cpu") as pipe:
                src = array_source(data, 10, header={"labels": ["time",
                                                             "dm"]})
                up = blocks.copy(src, space="cuda")
                tr = blocks.transpose(up, ["dm", "time"])
                blocks.shm_send(tr, name, data_capacity=200,
                                min_readers=1)
                pipe.run()
            t.join(timeout=30)
            assert raw["hdr"]["_tensor"]["shape"] == [-1, 6]
            assert raw["hdr"]["_tensor"]["labels"] == ["time", "dm"]
            assert raw["n"] == data.nbytes
            assert np.array_equal(raw["data"].reshape(data.shape), data)
        finally:
            config.reset("egress_staging")
    # Sender and receiver pipelines, the receiver at a gulp of 7 frames.
    name = f"torch_rl_rx_{os.getpid()}"
    got, err = [], []

    def send():
        try:
            with Pipeline(device="cpu") as pipe:
                src = array_source(data, 10, header={"labels": ["time",
                                                             "dm"]})
                tr = blocks.transpose(blocks.copy(src, space="cuda"),
                                      ["dm", "time"])
                blocks.shm_send(tr, name, data_capacity=200,
                                min_readers=1)
                pipe.run()
        except Exception as e:  # noqa: BLE001 — asserted below
            err.append(e)

    t = threading.Thread(target=send)
    t.start()
    try:
        with Pipeline(device="cpu") as pipe:
            gather_sink(blocks.shm_receive(name, gulp_nframe=7), got)
            pipe.run()
    finally:
        t.join(timeout=30)
    assert not t.is_alive() and not err, err
    assert np.array_equal(np.concatenate(got), data)


def test_shm_receive_refuses_a_ringlet_header():
    """A header whose frame axis is not first (the JAX package's sink
    sends such a stream ringlet-major, gulp by gulp) is refused, naming
    the stream and the axis."""
    import types
    from bifrost_tpu_torch.blocks.shmring import ShmReceiveBlock
    dummy = types.SimpleNamespace(_shm_name="rl")
    with pytest.raises(ValueError, match="'rl' has its frame axis at "
                       "position 1"):
        ShmReceiveBlock._set_frame_geometry(
            dummy, {"_tensor": {"dtype": "f32", "shape": [6, -1]}})


_JAX_RINGLET_SENDER = r"""
import sys
import numpy as np
from bifrost_tpu import blocks
from bifrost_tpu.pipeline import Pipeline
from bifrost_tpu.blocks.testing import array_source
data = np.zeros((40, 64), np.float32)
with Pipeline() as pipe:
    src = array_source(data, 8, header={"labels": ["time", "x"]})
    blocks.shm_send(blocks.transpose(src, ["x", "time"]), sys.argv[1],
                    min_readers=1, reader_timeout=120)
    pipe.run()
print("SENT", flush=True)
"""


def test_jax_ringlet_stream_is_refused_by_the_port_shm_receive():
    """The JAX package's shm_send of a (x, time) stream puts its gulps on
    the ring ringlet-major under the ringlet header, bytes that depend on
    its gulp size: the port's shm_receive refuses the sequence."""
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.blocks.testing import gather_sink
    from bifrost_tpu_torch.pipeline import Pipeline, PipelineInitError
    name = f"torch_jrl_{os.getpid()}"
    child = subprocess.Popen(
        [sys.executable, "-c", _JAX_RINGLET_SENDER, name],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=_child_env())
    try:
        with pytest.raises(PipelineInitError,
                           match="frame axis at position 1"):
            with Pipeline(device="cpu") as pipe:
                gather_sink(blocks.shm_receive(name, gulp_nframe=8), [])
                pipe.run()
        child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    assert child.returncode == 0


def test_port_ringlet_stream_is_read_frame_major_by_the_jax_shm_receive(
        tmp_path):
    """The port's shm_send of a (x, time) stream: the JAX package's
    shm_receive, in another process, takes the frame-major header at its
    word and receives the (time, x) source, bytes and labels."""
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.blocks.testing import array_source
    from bifrost_tpu_torch.pipeline import Pipeline
    name = f"torch_prl_{os.getpid()}"
    data = np.random.default_rng(9).random((40, 64)).astype(np.float32)
    out_file = tmp_path / "got.bin"
    child = subprocess.Popen(
        [sys.executable, "-c", _JAX_RECEIVER, name, str(out_file)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=_child_env())
    try:
        with Pipeline(device="cpu") as pipe:
            src = array_source(data, 8, header={"labels": ["time", "x"]})
            blocks.shm_send(blocks.transpose(src, ["x", "time"]), name,
                            min_readers=1, reader_timeout=120)
            pipe.run()
        out, err = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    assert child.returncode == 0, err[-2000:]
    tensor = _header_line(out)["_tensor"]
    assert tensor["shape"] == [-1, 64] and tensor["labels"] == ["time", "x"]
    got = np.fromfile(out_file, np.float32).reshape(data.shape)
    assert np.array_equal(got.view(np.uint32), data.view(np.uint32))
