"""The port's egress plane (bifrost_tpu_torch/egress.py) on the CPU: the
cases of tests/test_egress.py whose machinery is ported, and one stream
through a JAX `DeviceSinkBlock` subclass and the port's, which must hand
their sinks the same arrays at the same frame offsets.

On a CPU pipeline the 'cuda' ring lives in host memory, as the JAX
package's 'tpu' space runs on JAX's CPU backend in its tests, so the
stager engages exactly as on the card; only the copies are host copies.
The card's side (pinned buffers, the copy stream, span reuse) is held in
tests/test_torch_gpu.py."""

import threading
import time

import numpy as np
import pytest
import torch

from bifrost_tpu_torch import blocks, config, egress
from bifrost_tpu_torch.blocks.testing import array_source
from bifrost_tpu_torch.egress import (DeviceSinkBlock, EgressStager,
                                      _StagingPool)
from bifrost_tpu_torch.pipeline import Pipeline, SourceBlock, _GulpDispatcher
from bifrost_tpu_torch.ring import RingInterrupted, TensorInfo


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    for name in ("egress_staging", "egress_chunk_nbyte",
                 "pipeline_async_depth"):
        config.reset(name)


class CollectSink(DeviceSinkBlock):
    """Pooled-path sink: keeps a copy of each gulp (the staged view is
    valid for the call only) and its frame offset."""

    def __init__(self, iring, **kwargs):
        super().__init__(iring, **kwargs)
        self.chunks = []
        self.offsets = []
        self.stager_stats = None

    def on_sink_sequence(self, iseq):
        pass

    def on_sink_sequence_end(self, iseq):
        e = self._egress
        if e is not None:
            self.stager_stats = {"staged_gulps": e.staged_gulps,
                                 "staged_bytes": e.staged_bytes,
                                 "pool_allocs": e.pool.allocated}

    def on_sink_data(self, arr, frame_offset):
        self.chunks.append(np.array(arr))
        self.offsets.append(frame_offset)


def _run_device_chain(data, staged, depth=4, gulp=8, header=None,
                      sink_cls=CollectSink, **sink_kwargs):
    config.set("egress_staging", bool(staged))
    config.set("pipeline_async_depth", depth if staged else 1)
    try:
        with Pipeline(device="cpu") as pipe:
            src = array_source(data, gulp, header=header or {})
            dev = blocks.copy(src, space="cuda")
            snk = sink_cls(dev, **sink_kwargs)
            pipe.run()
        return snk
    finally:
        config.reset("pipeline_async_depth")
        config.reset("egress_staging")


class StoreDest(egress.EgressDest):
    """A destination that keeps each chunk it is handed (through its own
    view or through `write`) and marks each commit."""

    def __init__(self, store, use_view):
        self.store, self.use_view, self.buf = store, use_view, None

    def chunk_view(self, nbyte):
        if not self.use_view:
            return None
        self.buf = np.zeros(nbyte, np.uint8)
        return self.buf

    def advance(self, nbyte):
        self.store.append(self.buf.copy())

    def write(self, flat_u8):
        self.store.append(np.array(flat_u8))

    def commit(self):
        self.store.append("commit")


class DestSink(CollectSink):
    """A sink landing every gulp in a `StoreDest`."""

    def __init__(self, iring, use_view=True, **kwargs):
        super().__init__(iring, **kwargs)
        self.use_view, self.got = use_view, []

    def open_dest(self, nbyte, nframe, frame_offset):
        return StoreDest(self.got, self.use_view)


def _ci8(shape, seed):
    rng = np.random.default_rng(seed)
    raw = np.empty(shape, dtype=[("re", "i1"), ("im", "i1")])
    raw["re"] = rng.integers(-8, 8, shape)
    raw["im"] = rng.integers(-8, 8, shape)
    return raw


# ----------------------------------------------------------------- parity

def test_staged_blocking_bitwise_parity_f32():
    data = np.arange(48 * 12, dtype=np.float32).reshape(48, 12)
    blk = _run_device_chain(data, staged=False)
    stg = _run_device_chain(data, staged=True)
    assert not blk._egress_staging
    assert stg._egress_staging and stg._egress_drained_gulps == 6
    assert stg.stager_stats["staged_gulps"] == 6
    assert stg.stager_stats["staged_bytes"] == data.nbytes
    b = np.concatenate(blk.chunks, axis=0)
    s = np.concatenate(stg.chunks, axis=0)
    assert s.dtype == b.dtype and s.shape == b.shape
    assert np.array_equal(s.view(np.uint8), b.view(np.uint8))
    assert np.array_equal(b, data)


def test_staged_blocking_bitwise_parity_ci8():
    """Complex integers reach the sink as their complex64 lift on both
    paths, bitwise equal and equal to the complex golden."""
    raw = _ci8((40, 6), 11)
    header = {"dtype": "ci8", "labels": ["time", "chan"]}
    blk = _run_device_chain(raw, staged=False, header=header)
    stg = _run_device_chain(raw, staged=True, header=header)
    b = np.concatenate(blk.chunks, axis=0)
    s = np.concatenate(stg.chunks, axis=0)
    assert s.dtype == np.complex64
    assert np.array_equal(s.view(np.uint8), b.view(np.uint8))
    golden = (raw["re"].astype(np.float32) +
              1j * raw["im"].astype(np.float32)).astype(np.complex64)
    assert np.array_equal(b, golden)


def test_partial_final_gulp_staged():
    data = np.arange(44 * 8, dtype=np.float32).reshape(44, 8)   # 5*8 + 4
    stg = _run_device_chain(data, staged=True, gulp=8)
    assert np.array_equal(np.concatenate(stg.chunks, axis=0), data)
    assert stg.chunks[-1].shape[0] == 4


def test_in_order_handoff():
    data = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    stg = _run_device_chain(data, staged=True, depth=4)
    assert stg.offsets == list(range(0, 64, 8))


def test_chunked_staging_parity():
    """A gulp bound for a destination and larger than
    `egress_chunk_nbyte` lands chunk by chunk at the right byte ranges;
    a pooled gulp is one copy whatever the chunk size."""
    data = np.arange(64 * 512, dtype=np.float32).reshape(64, 512)
    calls = []
    real = egress._start_transfer

    def counted(dst, src):
        calls.append(src.shape[0])
        return real(dst, src)

    egress._start_transfer = counted
    try:
        config.set("egress_chunk_nbyte", 4096)      # 2 frames a chunk
        snk = _run_device_chain(data, staged=True, gulp=8,
                                sink_cls=DestSink)
        chunked, calls[:] = list(calls), []
        stg = _run_device_chain(data, staged=True, gulp=8)
    finally:
        egress._start_transfer = real
    assert chunked == [2] * 32
    payload = b"".join(x.tobytes() for x in snk.got if
                       not isinstance(x, str))
    assert payload == data.tobytes()
    assert calls == [8] * 8
    assert np.array_equal(np.concatenate(stg.chunks, axis=0), data)


def test_host_ring_fallback_stays_blocking():
    """A host-space input ring never engages staging; the sink sees
    zero-copy span views, equal to the source."""
    data = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)
    config.set("egress_staging", True)
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, 8)
        snk = CollectSink(src)
        pipe.run()
    assert snk._egress is None
    assert not snk._egress_staging
    assert np.array_equal(np.concatenate(snk.chunks, axis=0), data)


def test_host_ring_ci8_is_structured():
    """A host ring of complex integers hands over the JAX package's host
    form, the structured (re, im) array."""
    raw = _ci8((24, 5), 3)
    with Pipeline(device="cpu") as pipe:
        src = array_source(raw, 8, header={"dtype": "ci8"})
        snk = CollectSink(src)
        pipe.run()
    got = np.concatenate(snk.chunks, axis=0)
    assert got.dtype.names == ("re", "im")
    assert np.array_equal(got, raw)


def test_sequence_end_drains_all_pending():
    """Every gulp staged before the sequence ends is emitted by the
    sequence-end drain: a slow worker loses nothing."""
    real = egress._default_materialize

    def slow(dst, src):
        time.sleep(0.01)
        real(dst, src)

    data = np.arange(40 * 4, dtype=np.float32).reshape(40, 4)
    egress._materialize = slow
    try:
        stg = _run_device_chain(data, staged=True, depth=4)
    finally:
        egress._materialize = real
    assert np.array_equal(np.concatenate(stg.chunks, axis=0), data)
    assert stg._egress_drained_gulps == len(stg.chunks) == 5


def test_staging_pool_bounded_reuse():
    """Steady streaming recycles the pool: lifetime allocations stay
    within depth + 1."""
    data = np.arange(96 * 4, dtype=np.float32).reshape(96, 4)
    stg = _run_device_chain(data, staged=True, depth=3, gulp=8)
    assert stg.stager_stats["staged_gulps"] == 12
    assert stg.stager_stats["pool_allocs"] <= 4


def test_staging_pool_evicts_stale_sizes():
    pool = _StagingPool(max_free=4)
    for nbyte in (1024, 2048, 4096, 8192):
        pool.release(pool.acquire(nbyte))
    assert len(pool._free) == pool.MAX_SIZES == 2
    assert set(pool._free) == {4096, 8192}
    before = pool.allocated
    pool.release(pool.acquire(8192))
    assert pool.allocated == before


def test_staging_pool_on_the_cpu_is_not_pinned():
    """On a CPU pipeline there is nothing to pin for."""
    buf = _StagingPool(pin=False).acquire(4096)
    assert buf.dtype == torch.uint8 and buf.numel() == 4096
    assert not buf.is_pinned()


def test_egress_staging_latched_rejects_midsequence_toggle():
    """config.set('egress_staging', ...) mid-sequence is refused while a
    sink's sequence holds the latch.  The stream is 8 gulps, more than
    the sink's input ring holds."""
    errs = []

    class PokeSink(CollectSink):
        def on_sink_data(self, arr, frame_offset):
            try:
                config.set("egress_staging", False)
            except RuntimeError as e:
                errs.append(str(e))
            super().on_sink_data(arr, frame_offset)

    data = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    snk = _run_device_chain(data, staged=True, sink_cls=PokeSink)
    assert len(errs) == 8
    assert "egress_staging" in errs[0] and "latched" in errs[0]
    assert np.array_equal(np.concatenate(snk.chunks, axis=0), data)
    # Released at the sequence's end: the toggle works again.
    config.set("egress_staging", False)


def test_chunk_nbyte_latched_per_sequence():
    """`egress_chunk_nbyte` is read anew at each sequence and latched for
    it: a change between two sequences of one stream reaches the
    stager, one within a sequence is refused."""
    data = np.arange(16 * 512, dtype=np.float32).reshape(16, 512)
    sizes, errs = iter((4096, 8192)), []

    class TwoSeqSource(blocks.ArraySourceBlock):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.sourcenames = ["s0", "s1"]

    class SeqSink(DestSink):
        def on_sequence(self, iseq):
            self.got.append("sequence")
            config.set("egress_chunk_nbyte", next(sizes))
            super().on_sequence(iseq)

        def open_dest(self, nbyte, nframe, frame_offset):
            try:
                config.set("egress_chunk_nbyte", 0)
            except RuntimeError as e:
                errs.append(str(e))
            return super().open_dest(nbyte, nframe, frame_offset)

    config.set("egress_staging", True)
    config.set("pipeline_async_depth", 2)
    with Pipeline(device="cpu") as pipe:
        src = TwoSeqSource(data, 8)
        dev = blocks.copy(src, space="cuda")
        snk = SeqSink(dev)
        pipe.run()
    assert len(errs) == 4 and "latched" in errs[0]
    seqs = "".join(str(x.nbytes // 2048) if not isinstance(x, str) else
                   "|" if x == "sequence" else "c" for x in snk.got)
    # 2 gulps of 8 frames (2048 bytes each) a sequence: 2-frame chunks,
    # then 4-frame chunks.
    assert seqs == "|2222c2222c|44c44c"
    payload = b"".join(x.tobytes() for x in snk.got if
                       not isinstance(x, str))
    assert payload == data.tobytes() * 2


def test_flag_validators():
    with pytest.raises(ValueError):
        config.set("egress_chunk_nbyte", 100)
    with pytest.raises(ValueError):
        config.set("pipeline_async_depth", 0)
    config.set("egress_chunk_nbyte", 0)
    config.set("pipeline_async_depth", 16)
    assert config.get("egress_chunk_nbyte") == 0


# ------------------------------------------------------------ faults

def test_staging_fault_emits_prefix_only():
    """A fault on the staging worker fails the run at the next in-order
    handoff; the gulps staged before it are still emitted."""
    real = egress._default_materialize
    state = {"n": 0}

    def boom(dst, src):
        state["n"] += 1
        if state["n"] == 3:
            raise RuntimeError("staging boom")
        real(dst, src)

    data = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    config.set("egress_staging", True)
    config.set("pipeline_async_depth", 4)
    config.set("egress_chunk_nbyte", 0)
    egress._materialize = boom
    try:
        with Pipeline(device="cpu") as pipe:
            src = array_source(data, 8)
            dev = blocks.copy(src, space="cuda")
            snk = CollectSink(dev)
            with pytest.raises(RuntimeError, match="staging boom"):
                pipe.run()
    finally:
        egress._materialize = real
    got = np.concatenate(snk.chunks, axis=0)
    assert np.array_equal(got, data[:16])


def test_stager_refused_submission_resolves_ticket():
    """A stage() after the stager closed raises and hands its buffer
    back."""
    data = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    t = TensorInfo({"_tensor": {"dtype": "f32", "shape": [-1, 4],
                                "labels": ["time", "chan"]}})
    stager = EgressStager("t", depth=2, chunk_nbyte=0)
    stager.close()
    with pytest.raises(Exception):
        stager.stage(data, t, 8, 0)
    assert sum(len(v) for v in stager.pool._free.values()) == 1


def test_dispatcher_fault_drops_successors_and_surfaces():
    disp = _GulpDispatcher("t", depth=2)
    ran, gate = [], threading.Event()

    def bad():
        gate.wait(5)
        raise ValueError("first")

    disp.submit(bad)
    disp.submit(lambda: ran.append(1))
    gate.set()
    with pytest.raises(ValueError, match="first"):
        disp.drain()
    assert ran == []
    assert disp.inflight() == 0
    disp.submit(lambda: ran.append(2))
    disp.drain()
    assert ran == [2]
    disp.close()


def test_dispatcher_submit_aborts_when_full():
    disp = _GulpDispatcher("t", depth=1)
    gate = threading.Event()
    disp.submit(lambda: gate.wait(5))
    with pytest.raises(RingInterrupted):
        disp.submit(lambda: None, abort=lambda: True)
    gate.set()
    disp.drain()
    disp.close()


# ------------------------------------------------------------ layouts

def test_ringlet_stream_staged_parity():
    """A stream with a ringlet axis before the frame axis stages whole
    gulps (frame chunks would interleave wrongly), bitwise equal to the
    blocking path even when a gulp exceeds egress_chunk_nbyte."""
    data = np.arange(2 * 64 * 512, dtype=np.float32).reshape(2, 64, 512)

    class PolTimeSource(SourceBlock):
        def __init__(self, arr, gulp_nframe, **kwargs):
            super().__init__(["ringlet_test"], gulp_nframe, **kwargs)
            self.arr = arr
            self._cursor = 0

        def create_reader(self, name):
            import contextlib

            @contextlib.contextmanager
            def nullreader():
                self._cursor = 0
                yield self
            return nullreader()

        def on_sequence(self, reader, name):
            return [{"name": "ringlet_test", "time_tag": 0,
                     "_tensor": {"dtype": "f32", "shape": [2, -1, 512],
                                 "labels": ["pol", "time", "chan"]}}]

        def on_data(self, reader, ospans):
            ospan = ospans[0]
            n = min(ospan.nframe, self.arr.shape[1] - self._cursor)
            if n > 0:
                ospan.data[:, :n, :] = torch.from_numpy(
                    self.arr[:, self._cursor:self._cursor + n, :])
            self._cursor += n
            return [n]

    outs = {}
    config.set("egress_chunk_nbyte", 4096)
    for staged in (False, True):
        config.set("egress_staging", staged)
        config.set("pipeline_async_depth", 4 if staged else 1)
        try:
            with Pipeline(device="cpu") as pipe:
                src = PolTimeSource(data, 8)
                dev = blocks.copy(src, space="cuda")
                snk = CollectSink(dev)
                pipe.run()
        finally:
            config.reset("pipeline_async_depth")
            config.reset("egress_staging")
        outs[staged] = np.concatenate(snk.chunks, axis=1)
        if staged:
            assert snk._egress_staging and snk._egress_drained_gulps == 8
    assert np.array_equal(outs[False], data)
    assert np.array_equal(outs[True].view(np.uint8),
                          outs[False].view(np.uint8))


def test_tensor_host_span_views():
    t_f32 = TensorInfo({"_tensor": {"dtype": "f32", "shape": [-1, 12],
                                    "labels": ["time", "chan"]}})
    assert t_f32.host_view_dtype == np.float32
    assert t_f32.host_span_nbyte(8) == 8 * 12 * 4
    buf = np.zeros(t_f32.host_span_nbyte(8), np.uint8)
    view = t_f32.host_span_view(buf, 8)
    assert view.shape == (8, 12) and view.dtype == np.float32
    view[...] = 7.0
    assert buf.view(np.float32)[0] == 7.0      # aliases the buffer
    t_ci8 = TensorInfo({"_tensor": {"dtype": "ci8", "shape": [-1, 6],
                                    "labels": ["time", "chan"]}})
    assert t_ci8.host_view_dtype == np.complex64
    assert t_ci8.host_span_nbyte(4) == 4 * 6 * 8
    view = t_ci8.host_span_view(torch.zeros(t_ci8.host_span_nbyte(4),
                                            dtype=torch.uint8), 4)
    assert view.shape == (4, 6) and view.dtype == np.complex64


# ------------------------------------------------------ destinations

def test_dest_protocol_receives_every_byte():
    """A sink's `EgressDest` gets each chunk through `chunk_view` or,
    where it offers none, through `write`, then one commit a gulp."""
    data = np.arange(32 * 512, dtype=np.float32).reshape(32, 512)
    for use_view in (True, False):
        config.set("egress_chunk_nbyte", 4096)
        snk = _run_device_chain(data, staged=True, sink_cls=DestSink,
                                use_view=use_view)
        assert snk.chunks == []                 # no pooled handoff
        assert sum(isinstance(x, str) for x in snk.got) == 4
        assert isinstance(snk.got[-1], str)
        payload = b"".join(x.tobytes() for x in snk.got if
                           not isinstance(x, str))
        assert payload == data.tobytes()


# --------------------------------------------- against the JAX package

def test_device_sink_same_arrays_as_jax():
    """One stream through a JAX DeviceSinkBlock subclass and through the
    port's: the same arrays (dtype, shape, bytes) at the same frame
    offsets, f32 and ci8, staged."""
    from bifrost_tpu import blocks as jblocks
    from bifrost_tpu import config as jconfig
    from bifrost_tpu.blocks.testing import array_source as j_array_source
    from bifrost_tpu.egress import DeviceSinkBlock as JaxDeviceSinkBlock
    from bifrost_tpu.pipeline import Pipeline as JaxPipeline

    class JaxCollect(JaxDeviceSinkBlock):
        def __init__(self, iring, **kwargs):
            super().__init__(iring, **kwargs)
            self.chunks, self.offsets = [], []

        def on_sink_sequence(self, iseq):
            pass

        def on_sink_data(self, arr, frame_offset):
            self.chunks.append(np.array(arr))
            self.offsets.append(frame_offset)

    streams = [(np.random.default_rng(5).standard_normal((44, 6, 3))
                .astype(np.float32), {}),
               (_ci8((44, 6), 7), {"dtype": "ci8",
                                   "labels": ["time", "chan"]})]
    for data, header in streams:
        jconfig.set("egress_staging", True)
        jconfig.set("pipeline_async_depth", 4)
        try:
            with JaxPipeline() as pipe:
                src = j_array_source(data, 8, header=header)
                dev = jblocks.copy(src, space="tpu")
                jsnk = JaxCollect(dev)
                pipe.run()
        finally:
            jconfig.reset("pipeline_async_depth")
            jconfig.reset("egress_staging")
        psnk = _run_device_chain(data, staged=True, header=header)
        assert psnk.offsets == jsnk.offsets == [0, 8, 16, 24, 32, 40]
        for p, j in zip(psnk.chunks, jsnk.chunks):
            assert p.dtype == j.dtype and p.shape == j.shape
            assert np.array_equal(p.view(np.uint8), j.view(np.uint8))


def test_guppi_raw_sink_roundtrip(tmp_path):
    """GuppiRawSinkBlock on the staged path writes a ci8 stream that the
    GUPPI source reads back bit-exactly, with per-component NBITS and a
    whole-payload BLOCSIZE."""
    from bifrost_tpu_torch.blocks.testing import gather_sink
    from bifrost_tpu_torch.io import guppi_raw as gio

    nblock, nchan, ntime, npol = 4, 3, 16, 2
    raw = _ci8((nblock, nchan, ntime, npol), 13)
    config.set("egress_staging", True)
    config.set("pipeline_async_depth", 2)
    with Pipeline(device="cpu") as pipe:
        src = array_source(raw, 1, header={
            "dtype": "ci8", "labels": ["time", "freq", "fine_time", "pol"]})
        dev = blocks.copy(src, space="cuda")
        snk = blocks.write_guppi_raw(dev, path=str(tmp_path))
        pipe.run()
    assert snk._egress_drained_gulps == nblock
    with open(snk.filename, "rb") as f:
        hdr = gio.read_header(f)
    assert hdr["NBITS"] == 8
    assert hdr["BLOCSIZE"] == nchan * ntime * npol * 2
    assert hdr["NTIME"] == ntime
    chunks = []
    with Pipeline(device="cpu") as pipe:
        rd = blocks.read_guppi_raw([snk.filename], gulp_nframe=1)
        gather_sink(rd, chunks)
        pipe.run()
    got = np.concatenate(chunks, axis=0)          # (re, im) storage
    assert np.array_equal(got[..., 0], raw["re"])
    assert np.array_equal(got[..., 1], raw["im"])
