"""The port's DADA plane (bifrost_tpu_torch/io/dada_ipc.py,
blocks/psrdada.py, dada_bridge.py) on the CPU: the cases of
tests/test_dada_bridge.py on the port, its bridge included (a DADA writer
process -> `python -m bifrost_tpu_torch.dada_bridge` -> the port's
shm_receive), the DADA header codec against the JAX package's on the same
strings, and a DADA HDU written by each package read by the other's
reader across processes.  Every wait on a child process has its own
timeout.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not sys.platform.startswith("linux"), reason="SysV IPC (linux only)")


WRITER = r"""
import sys
sys.path.insert(0, %(repo)r)
import numpy as np
from bifrost_tpu_torch.io.dada_ipc import DadaHDU

key, nframe, nchan, npol = 0x%(key)x, %(nframe)d, %(nchan)d, %(npol)d
hdu = DadaHDU(key, create=False)
try:
    hdu.write_header(
        "HDR_VERSION 1.0\nNBIT 8\nNDIM 2\nNCHAN %%d\nNPOL %%d\n"
        "OBS_ID synthtest\nBW 16.0\nFREQ 1400.0\n" %% (nchan, npol))
    rng = np.random.default_rng(7)
    payload = rng.integers(-8, 8, (nframe, nchan, npol, 2)).astype(np.int8)
    raw = payload.tobytes()
    hdu.data.start_of_data()
    off = 0
    while off < len(raw):
        buf, _ = hdu.data.open_write_buf(timeout=20)
        n = min(len(buf), len(raw) - off)
        buf[:n] = raw[off:off + n]
        hdu.data.mark_filled(n)
        off += n
    hdu.data.end_of_data()
    print("WRITER-DONE", flush=True)
finally:
    hdu.data.destroy_on_close = False
    hdu.header.destroy_on_close = False
    hdu.close()
"""


def test_dada_attach_abi_validation():
    """Attaching to a deliberately mangled sync page must raise a clear
    error naming the mismatch, never misread the geometry."""
    from bifrost_tpu_torch.io.dada_ipc import DadaRing, MAGIC

    key = 0x6E700000 + (os.getpid() % 256) * 0x400
    ring = DadaRing(key, nbufs=2, bufsz=4096, create=True)
    try:
        DadaRing(key, create=False).close()        # healthy attach works
        ring.sync.magic = 0x12345678               # not a DADA ring
        with pytest.raises(RuntimeError, match="magic"):
            DadaRing(key, create=False)
        ring.sync.magic = (MAGIC & ~0xFFFF) | 0x7F  # same family, new ver
        with pytest.raises(RuntimeError, match="version"):
            DadaRing(key, create=False)
        ring.sync.magic = MAGIC
        ring.sync.nbufs = 10 ** 6                  # corrupt geometry
        with pytest.raises(RuntimeError, match="nbufs"):
            DadaRing(key, create=False)
        ring.sync.nbufs = 2
        ring.sync.bufsz = 0
        with pytest.raises(RuntimeError, match="bufsz"):
            DadaRing(key, create=False)
        ring.sync.bufsz = 4096
        DadaRing(key, create=False).close()        # restored: attaches
    finally:
        ring.close()


def test_dada_attach_undersized_sync_segment():
    """A sync segment smaller than this implementation's IpcSync is a
    struct-size (ABI) mismatch and must be refused at attach."""
    from bifrost_tpu_torch.io import dada_ipc as di

    key = 0x6E700100 + (os.getpid() % 256) * 0x400
    shmid = di._shmget(key, 32, di.IPC_CREAT | di.IPC_EXCL | 0o666)
    semid = di._semget(key, 4, di.IPC_CREAT | di.IPC_EXCL | 0o666)
    try:
        if di._shm_segsz(shmid) is None:
            pytest.skip("shmid_ds IPC_STAT probe unavailable here")
        with pytest.raises(RuntimeError, match="sync segment"):
            di.DadaRing(key, create=False)
    finally:
        di._shm_rm(shmid)
        di._sem_rm(semid)


def test_dada_bridge_end_to_end(tmp_path):
    from bifrost_tpu_torch.io.dada_ipc import DadaHDU

    key = 0x6E700200 + (os.getpid() % 256) * 0x400
    nframe, nchan, npol = 512, 16, 2
    ring_name = f"torch_dadabridge_{os.getpid()}"

    # parent plays dada_db: owns (and finally destroys) the segments
    hdu = DadaHDU(key, nbufs=4, bufsz=8192, create=True)
    try:
        writer = subprocess.Popen(
            [sys.executable, "-c", WRITER % {
                "repo": REPO, "key": key, "nframe": nframe,
                "nchan": nchan, "npol": npol}],
            stdout=subprocess.PIPE, text=True, cwd=REPO)
        bridge = subprocess.Popen(
            [sys.executable, "-m", "bifrost_tpu_torch.dada_bridge",
             "--key", hex(key), "--name", ring_name, "--oneshot",
             "--gulp-frames", "64", "--timeout", "30"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))

        from bifrost_tpu_torch import blocks
        from bifrost_tpu_torch.pipeline import Pipeline

        got = []
        hdrs = []
        with Pipeline(device="cpu") as pipe:
            src = blocks.shm_receive(ring_name, gulp_nframe=64)
            blocks.callback_sink(
                src,
                on_sequence=lambda hdr: hdrs.append(hdr),
                on_data=lambda arr: got.append(np.asarray(arr).copy()))
            run_err = []

            def run():
                try:
                    pipe.run()
                except Exception as e:  # noqa: BLE001
                    run_err.append(e)

            t = threading.Thread(target=run)
            t.start()
            t.join(timeout=60)
            assert not t.is_alive(), "pipeline did not finish"
            assert not run_err, run_err

        wout, _ = writer.communicate(timeout=30)
        bout, berr = bridge.communicate(timeout=30)
        assert "WRITER-DONE" in wout
        assert bridge.returncode == 0, berr[-2000:]
        assert "forwarded 512 frames" in bout

        rng = np.random.default_rng(7)
        payload = rng.integers(-8, 8,
                               (nframe, nchan, npol, 2)).astype(np.int8)
        data = np.concatenate(got, axis=0)
        # ci8 gulps reach the port's sink in storage form: a trailing
        # (re, im) axis of int8.
        data = (data[..., 0].astype(np.float32) +
                1j * data[..., 1].astype(np.float32))
        golden = (payload[..., 0] + 1j * payload[..., 1]).astype(
            np.complex64)
        np.testing.assert_array_equal(data, golden)
        # translated header: dtype/labels from DADA keys, raw ASCII kept
        t0 = hdrs[0]["_tensor"]
        assert t0["dtype"] == "ci8"
        assert t0["labels"] == ["time", "freq", "pol"]
        assert t0["shape"][1:] == [nchan, npol]
        assert "NCHAN" in hdrs[0].get("__dada__", "")
    finally:
        hdu.close()   # destroys the SysV segments (created here)
        # The bridge leaves the ring's name for late readers.
        from bifrost_tpu_torch.shmring import unlink
        unlink(ring_name)


def test_dada_open_write_buf_timeout():
    """With every data buffer FULL and no reader
    clearing, `open_write_buf(timeout=)` returns None within the bound
    instead of blocking forever — the egress destination's stalled-
    consumer detection (blocks/psrdada.py _DadaBufDest)."""
    import time
    from bifrost_tpu_torch.io.dada_ipc import DadaRing

    key = 0x6E5A0000 | (os.getpid() & 0x7FFF)
    with DadaRing(key, nbufs=2, bufsz=128, create=True) as ring:
        for _ in range(2):
            buf, _idx = ring.open_write_buf(timeout=5)
            buf[:4] = b"full"
            ring.mark_filled(128)
        t0 = time.monotonic()
        got = ring.open_write_buf(timeout=0.3)
        dt = time.monotonic() - t0
        assert got is None
        assert 0.2 <= dt < 3.0


def test_dada_partial_mark_filled_roundtrip():
    """Partially-filled buffers (`mark_filled` short
    of bufsz — every gulp-per-buffer egress commit) surface their exact
    committed size to the reader via the per-buffer size records, and
    EOD follows cleanly."""
    from bifrost_tpu_torch.io.dada_ipc import DadaRing

    key = 0x6E5B0000 | (os.getpid() & 0x7FFF)
    payloads = [b"x" * 128, b"y" * 40, b"z" * 1]
    with DadaRing(key, nbufs=4, bufsz=128, create=True) as writer:
        reader = DadaRing(key, create=False)
        try:
            writer.start_of_data()
            for p in payloads:
                buf, _idx = writer.open_write_buf(timeout=5)
                buf[:len(p)] = p
                writer.mark_filled(len(p))
            writer.end_of_data()
            got = []
            while True:
                r = reader.open_read_buf(timeout=5)
                if r == "EOD":
                    break
                assert r is not None, "reader timed out before EOD"
                buf, nbyte = r
                got.append(bytes(buf[:nbyte]))
                reader.mark_cleared()
            assert got == payloads
        finally:
            reader.close()


def test_dada_egress_dest_timeout_raises():
    """The egress-plane DADA destination turns a full-ring timeout into
    a loud TimeoutError naming the key (instead of the stager silently
    wedging behind a dead archiver)."""
    import pytest
    from bifrost_tpu_torch.io.dada_ipc import DadaRing
    from bifrost_tpu_torch.blocks.psrdada import _DadaBufDest

    key = 0x6E5C0000 | (os.getpid() & 0x7FFF)
    with DadaRing(key, nbufs=1, bufsz=64, create=True) as ring:
        buf, _idx = ring.open_write_buf(timeout=5)
        ring.mark_filled(64)              # the only buffer is now FULL
        dest = _DadaBufDest(ring, timeout=0.2)
        with pytest.raises(TimeoutError, match=f"0x{key:x}"):
            dest.chunk_view(16)


def test_dada_interrupt_wakes_blocked_writer():
    """`DadaRing.interrupt()` (DadaIpcSinkBlock.on_shutdown)
    promptly wakes a writer blocked on the CLEAR wait behind a stalled
    consumer — raising InterruptedError instead of waiting out the
    full timeout."""
    import threading
    import time
    import pytest
    from bifrost_tpu_torch.io.dada_ipc import DadaRing

    key = 0x6E5D0000 | (os.getpid() & 0x7FFF)
    got = {}
    with DadaRing(key, nbufs=1, bufsz=64, create=True) as ring:
        buf, _idx = ring.open_write_buf(timeout=5)
        ring.mark_filled(64)              # the only buffer is now FULL

        def blocked():
            t0 = time.monotonic()
            try:
                with pytest.raises(InterruptedError, match="interrupted"):
                    ring.open_write_buf(timeout=30)
                got["dt"] = time.monotonic() - t0
            except Exception as e:  # noqa: BLE001 — asserted below
                got["err"] = e

        t = threading.Thread(target=blocked)
        t.start()
        time.sleep(0.3)
        ring.interrupt()
        t.join(timeout=10)
        assert not t.is_alive()
        assert "err" not in got, got.get("err")
        assert got["dt"] < 5.0            # woke well before the timeout
        # re-armed: the wait works again (and times out normally)
        ring.clear_interrupt()
        assert ring.open_write_buf(timeout=0.2) is None


# ------------------------------------------------ against the JAX package
_HEADERS = [
    "HDR_VERSION 1.0\nNBIT 8\nNDIM 2\nNCHAN 16\nNPOL 2\nOBS_ID synth\n"
    "BW 16.0\nFREQ 1400.0\n",
    "NCHAN 64\nTSAMP 1.28\nSOURCE J0000+0000\n\0garbage after the NUL",
    "KEY   spaced value  \n\nEMPTY_LINES_ABOVE 3\nHEX 0x10\nNEG -7\n",
    "GOOD 1\nmalformed_line_without_value\nNEVER_READ 2\n",
    "FLOAT 1e-3\nINF inf\nNAN nan\nTEXT 12abc\n",
]


@pytest.mark.parametrize("text", _HEADERS)
@pytest.mark.parametrize("cast_types", [True, False])
def test_dada_header_codec_matches_the_jax_package(text, cast_types):
    """parse_dada_header and serialize_dada_header give what the JAX
    package's give on the same strings (NaN compared as NaN)."""
    from bifrost_tpu.blocks import psrdada as jax_dada
    from bifrost_tpu_torch.blocks import psrdada as port_dada
    got = port_dada.parse_dada_header(text, cast_types)
    want = jax_dada.parse_dada_header(text, cast_types)
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is type(want[k])
        assert repr(got[k]) == repr(want[k])
    assert port_dada.serialize_dada_header(got) == \
        jax_dada.serialize_dada_header(want)
    nested = dict(got, _private=1, nested={"a": 1}, listed=[1, 2])
    assert port_dada.serialize_dada_header(nested) == \
        jax_dada.serialize_dada_header(nested)


_HDU_WRITER = r"""
import sys
import numpy as np
from %(pkg)s.io.dada_ipc import DadaHDU
key = int(sys.argv[1], 0)
payload = np.random.default_rng(11).integers(0, 255, 20000).astype(np.uint8)
hdu = DadaHDU(key, create=False)
try:
    hdu.write_header("NCHAN 8\nNBIT 8\nOBS_ID cross\n")
    hdu.data.start_of_data()
    off = 0
    while off < payload.size:
        buf, _ = hdu.data.open_write_buf(timeout=60)
        n = min(len(buf), payload.size - off)
        buf[:n] = payload[off:off + n].tobytes()
        hdu.data.mark_filled(n)
        off += n
    hdu.data.end_of_data()
finally:
    hdu.close()
"""

_HDU_READER = r"""
import sys
from %(pkg)s.io.dada_ipc import DadaHDU
key = int(sys.argv[1], 0)
hdu = DadaHDU(key, create=False)
try:
    header = hdu.read_header(timeout=60)
    got = []
    while True:
        r = hdu.data.open_read_buf(timeout=60)
        if r == "EOD":
            break
        assert r is not None, "no buffer within the timeout"
        buf, nbyte = r
        got.append(bytes(buf[:nbyte]))
        hdu.data.mark_cleared()
finally:
    hdu.close()
open(sys.argv[2], "wb").write(b"".join(got))
print("HEADER=" + header.replace("\n", "|"))
"""


@pytest.mark.parametrize("writer_pkg", ["bifrost_tpu_torch", "bifrost_tpu"])
def test_dada_hdu_written_by_one_package_is_read_by_the_other(
        writer_pkg, tmp_path):
    """A DADA HDU made here (the dada_db role) is written by one package's
    DadaHDU in one process and read by the other package's in another:
    the header and every byte arrive."""
    from bifrost_tpu_torch.io.dada_ipc import DadaHDU
    reader_pkg = ("bifrost_tpu" if writer_pkg == "bifrost_tpu_torch"
                  else "bifrost_tpu_torch")
    key = (0x6E5E0000 if writer_pkg == "bifrost_tpu_torch"
           else 0x6E5F0000) | ((os.getpid() & 0x3FFF) << 1)
    out = tmp_path / "got.bin"
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    hdu = DadaHDU(key, nbufs=3, bufsz=4096, create=True)
    procs = []
    try:
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _HDU_WRITER % {"pkg": writer_pkg},
             hex(key)], cwd=REPO, env=env, stderr=subprocess.PIPE,
            text=True))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _HDU_READER % {"pkg": reader_pkg},
             hex(key), str(out)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        _, werr = procs[0].communicate(timeout=120)
        rout, rerr = procs[1].communicate(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        hdu.close()
    assert procs[0].returncode == 0, werr[-2000:]
    assert procs[1].returncode == 0, rerr[-2000:]
    assert "HEADER=NCHAN 8|NBIT 8|OBS_ID cross|" in rout
    payload = np.random.default_rng(11).integers(0, 255, 20000) \
        .astype(np.uint8)
    assert out.read_bytes() == payload.tobytes()


def _dada_send_read_by_jax(tmp_path, key, data, ringlets):
    """A port pipeline array_source -> copy('cuda') [-> transpose to
    (x, time)] -> dada_ipc_send, read by the JAX package's DadaHDU in
    another process; -> (the reader's output, the bytes it received)."""
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.blocks.testing import array_source
    from bifrost_tpu_torch.pipeline import Pipeline
    out = tmp_path / "got.bin"
    reader = r"""
import sys, time
from bifrost_tpu.io.dada_ipc import DadaHDU
key = int(sys.argv[1], 0)
deadline = time.monotonic() + 60
while True:
    try:
        hdu = DadaHDU(key, create=False)
        break
    except (OSError, RuntimeError):
        if time.monotonic() > deadline:
            raise
        time.sleep(0.02)
""" + _HDU_READER.split("hdu = DadaHDU(key, create=False)\n", 1)[1] \
        % {"pkg": "bifrost_tpu"}
    child = subprocess.Popen(
        [sys.executable, "-c", reader, hex(key), str(out)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        with Pipeline(device="cpu") as pipe:
            src = array_source(data, 8, header={"labels": ["time", "x"]})
            d = blocks.copy(src, space="cuda")
            if ringlets:
                d = blocks.transpose(d, ["x", "time"])
            blocks.dada_ipc_send(d, key, nbufs=2,
                                 bufsz=8 * data.shape[1] * 4)
            pipe.run()
        rout, rerr = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
    assert child.returncode == 0, rerr[-2000:]
    return rout, out.read_bytes()


def test_dada_ipc_send_is_read_by_the_jax_dada_reader(tmp_path):
    """The port's dada_ipc_send (the HDU made by the sink) read by the
    JAX package's DadaHDU in another process: TENSOR_JSON and the bytes."""
    key = 0x6E600000 | ((os.getpid() & 0x3FFF) << 2)
    data = np.random.default_rng(12).random((24, 32)).astype(np.float32)
    rout, got = _dada_send_read_by_jax(tmp_path, key, data, False)
    assert 'TENSOR_JSON {"dtype": "f32", "shape": [-1, 32]' in rout
    assert got == data.tobytes()


def test_dada_ipc_send_of_ringlets_is_frame_major_under_its_tensor_json(
        tmp_path):
    """A (x, time) stream with ringlets goes into the HDU frame by frame,
    and TENSOR_JSON says so (frame axis first, labels moved with their
    axes): the JAX reader receives the (time, x) source's bytes."""
    key = 0x6E620000 | ((os.getpid() & 0x3FFF) << 2)
    data = np.random.default_rng(13).random((24, 32)).astype(np.float32)
    rout, got = _dada_send_read_by_jax(tmp_path, key, data, True)
    assert 'TENSOR_JSON {"dtype": "f32", "shape": [-1, 32], ' \
        '"labels": ["time", "x"]' in rout
    assert got == data.tobytes()


def test_read_psrdada_buffer_refuses_a_ringlet_header():
    """DADA data is time-ordered: a header_callback whose `_tensor` puts
    the frame axis after a ringlet axis is refused, naming the axis."""
    import types
    from bifrost_tpu_torch.blocks.psrdada import PsrDadaSourceBlock
    dummy = types.SimpleNamespace(_shm_name="dada_x")
    with pytest.raises(ValueError, match="frame axis at position 1"):
        PsrDadaSourceBlock._set_frame_geometry(
            dummy, {"_tensor": {"dtype": "u8", "shape": [16, -1]}})


def test_dada_ipc_send_removes_its_segments_after_the_reader_is_done():
    """A sink that made its HDU removes the segments at its end only after
    its reader has read every buffer and the end of data: a reader that
    clears each buffer late still receives every byte."""
    from bifrost_tpu_torch import blocks
    from bifrost_tpu_torch.blocks.testing import array_source
    from bifrost_tpu_torch.io.dada_ipc import DadaHDU
    from bifrost_tpu_torch.pipeline import Pipeline
    key = 0x6E640000 | ((os.getpid() & 0x3FFF) << 2)
    data = np.random.default_rng(14).random((48, 16)).astype(np.float32)
    got, err = [], []

    def read():
        try:
            deadline = time.monotonic() + 30
            while True:
                try:
                    hdu = DadaHDU(key, create=False)
                    break
                except (OSError, RuntimeError):
                    assert time.monotonic() < deadline
                    time.sleep(0.01)
            hdu.read_header(timeout=30)
            while True:
                r = hdu.data.open_read_buf(timeout=30)
                if r == "EOD":
                    break
                got.append(bytes(r[0][:r[1]]))
                time.sleep(0.1)
                hdu.data.mark_cleared()
            hdu.close()
        except Exception as e:  # noqa: BLE001 — asserted below
            err.append(e)

    t = threading.Thread(target=read)
    t.start()
    try:
        with Pipeline(device="cpu") as pipe:
            src = array_source(data, 8)
            blocks.dada_ipc_send(blocks.copy(src, space="cuda"), key,
                                 nbufs=3, bufsz=8 * 16 * 4)
            pipe.run()
    finally:
        t.join(timeout=60)
    assert not t.is_alive() and not err, err
    assert b"".join(got) == data.tobytes()
