"""The port's async gulp executor (`pipeline_async_depth`, with the
`strict_sync` and `serialize_dispatch` flags) on the CPU, mirroring
tests/test_pipeline_async.py's 24 cases and tests/test_async_dispatch.py,
and held against the JAX package on the capture -> unpack -> correlate
chain.

- Parity: the port's chain at depths 1 and 4 and the JAX chain at depth 1
  are bitwise equal, and equal to the exact numpy golden.  Tolerance:
  none; the int8 X-engine is exact (every sum an integer below 2**24).
- The overlap happens: the event order of a transform's reserve and of a
  source's staging (reserved before gulp N's end; staged inside gulp N's
  commit), which the synchronous loops cannot produce.
- The syncs that stay: where the JAX case reads XLA's `block_until_ready`,
  this file counts the port's `device.stream_synchronize` calls by
  thread (a lossy sink synchronises each gulp, a guaranteed 'cuda'-ring
  sink does not; `ReadSpan.release` never does).
- Flags: validation, the per-sequence latches, `strict_sync` (nothing in
  flight, no executor, no fusion, no `fused_async`) and
  `serialize_dispatch` (one block's device scope at a time).
- Faults: quiesce with a wedged worker, the deadman behind a full queue,
  a worker fault failing the run fast, a supervised restart that sheds
  the in-flight batch without duplicates, the dispatcher's epochs, the
  worker's thread attribution and its failed bind.

Of tests/test_async_dispatch.py's six cases, two are covered already:
`test_async_and_sync_fused_chains_agree` by
tests/test_torch_fusion.py::test_gpuspec_chain_fused_vs_unfused_and_jax
(fused_async on and off, bitwise), and
`test_dispatcher_propagates_worker_exception` with
`test_dispatcher_drops_queued_items_after_failure` by
tests/test_torch_egress.py::test_dispatcher_fault_drops_successors_and_surfaces.
The other three are mirrored at the end.
"""

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import bifrost_tpu as jbf
from bifrost_tpu import blocks as jblocks
from bifrost_tpu import config as jconfig
from bifrost_tpu.blocks.testing import array_source as j_array_source
from bifrost_tpu.blocks.testing import gather_sink as j_gather_sink
from bifrost_tpu.ops import quantize as j_quantize
from bifrost_tpu.pipeline import Pipeline as JPipeline

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import blocks, config, views
from bifrost_tpu_torch import device as device_mod
from bifrost_tpu_torch import ring as ring_mod
from bifrost_tpu_torch.blocks.testing import (array_source, callback_sink,
                                              gather_sink)
from bifrost_tpu_torch.faultinject import FaultPlan
from bifrost_tpu_torch.pipeline import (Pipeline, SinkBlock, TransformBlock,
                                        _GulpDispatcher)
from bifrost_tpu_torch.supervise import (RestartPolicy, Supervisor,
                                         SupervisorEscalation)

ROOT = Path(__file__).resolve().parent.parent
FLAGS = ("pipeline_async_depth", "fused_async", "strict_sync",
         "serialize_dispatch")


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    for f in FLAGS:
        config.reset(f)


def _force_async_eligible(*blocks_):
    """The executor serves blocks that touch the card only (a host-only
    block would only pay the hand-off); these cases pin its semantics on
    cheap host chains, so the blocks are marked eligible."""
    for b in blocks_:
        b._touches_device = True


def _ci4_voltages(ntime, nchan=2, nstand=3, npol=2, seed=42):
    """Packed ci4 capture bytes (the JAX quantizer's) and their exact
    complex64 value."""
    rng = np.random.default_rng(seed)
    a = (rng.integers(-7, 8, (ntime, nchan, nstand, npol)) +
         1j * rng.integers(-7, 8, (ntime, nchan, nstand, npol))) \
        .astype(np.complex64)
    q = jbf.empty(a.shape, dtype="ci4")
    j_quantize(a, q, scale=1.0)
    return np.asarray(q), a


HDR = {"dtype": "ci4", "labels": ["time", "freq", "station", "pol"]}


def _run_capture_unpack_correlate(host_ci4, depth, gulp=8, n_int=16,
                                  stats=None):
    config.set("pipeline_async_depth", depth)
    try:
        chunks = []
        with Pipeline(device="cpu") as pipe:
            src = array_source(host_ci4, gulp, header=dict(HDR))
            u = blocks.unpack(src)                   # ci4 -> ci8 (host)
            dev = blocks.copy(u, space="cuda")       # H2D staging
            cor = blocks.correlate(dev, n_int, engine="int8")
            back = blocks.copy(cor, space="system")
            gather_sink(back, chunks)
            pipe.run()
        if stats is not None:
            stats.update({b.name: b._exec_async_depth for b in
                          (u, dev, cor, back)})
        return np.concatenate(chunks, axis=0)
    finally:
        config.reset("pipeline_async_depth")


def _run_jax_chain(host_ci4, gulp=8, n_int=16):
    chunks = []
    with JPipeline() as pipe:
        src = j_array_source(host_ci4, gulp, header=dict(HDR))
        u = jblocks.unpack(src)
        dev = jblocks.copy(u, space="tpu")
        cor = jblocks.correlate(dev, nframe_per_integration=n_int,
                                engine="int8")
        back = jblocks.copy(cor, space="system")
        j_gather_sink(back, chunks)
        pipe.run()
    return np.concatenate(chunks, axis=0)


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


# ------------------------------------------------------------- parity

def test_sync_async_bitwise_capture_unpack_correlate():
    """The chain at depth 1 and at depth 4 in the port, and at depth 1 in
    the JAX package: bitwise equal (the int8 engine is exact).  At depth
    4 the device blocks ran the executor, the host unpack did not."""
    host, _ = _ci4_voltages(32)
    stats = {}
    sync = _run_capture_unpack_correlate(host, depth=1)
    deep = _run_capture_unpack_correlate(host, depth=4, stats=stats)
    jax = _run_jax_chain(host)
    assert _bits(sync, deep)
    assert _bits(sync, jax.astype(np.complex64))
    assert sorted(stats.values()) == [0, 4, 4, 4]


def test_async_output_matches_golden():
    """The async path matches the numpy golden cross-correlation
    exactly."""
    host, a = _ci4_voltages(32)
    out = _run_capture_unpack_correlate(host, depth=3)
    ntime, nchan, nstand, npol = a.shape
    xm = a.reshape(ntime, nchan, nstand * npol)
    golden = np.stack([
        np.einsum("tci,tcj->cij", np.conj(xm[i * 16:(i + 1) * 16]),
                  xm[i * 16:(i + 1) * 16])
        for i in range(2)]).reshape(2, nchan, nstand, npol, nstand, npol)
    assert np.array_equal(out, golden)


def test_partial_final_gulp_async():
    """A frame total not divisible by the gulp: the short final gulp
    flows through the executor as through the synchronous loop."""
    host, _ = _ci4_voltages(28)      # 3 full gulps of 8 + a partial 4
    sync = _run_capture_unpack_correlate(host, depth=1, n_int=8)
    deep = _run_capture_unpack_correlate(host, depth=4, n_int=8)
    assert _bits(sync, deep)
    assert _bits(sync, _run_jax_chain(host, n_int=8).astype(np.complex64))


# ------------------------------------------------- event-order proofs

class _GatedTransform(TransformBlock):
    """A copy transform that logs its events and holds its first gulp's
    on_data until the test releases it."""

    def __init__(self, iring, events, gate, **kwargs):
        super().__init__(iring, **kwargs)
        self.events = events
        self.gate = gate
        self._ngulp = 0

    def on_sequence(self, iseq):
        return dict(iseq.header)

    def _perf_add(self, **phases):
        # The block thread books acquire + reserve right after gulp N's
        # spans are in hand (the executor's loop only).
        if "acquire" in phases:
            self.events.append("reserved")
        super()._perf_add(**phases)

    def on_data(self, ispan, ospan):
        i = self._ngulp
        self._ngulp += 1
        self.events.append(f"process_start:{i}")
        if i == 0:
            assert self.gate.wait(20), "test gate never released"
        ospan.data.copy_(ispan.data)
        self.events.append(f"process_end:{i}")
        return ispan.nframe


def test_event_order_reserve_overlaps_compute():
    """With gulp 0's on_data held open on the worker, the block thread
    acquires and reserves gulp 1 and more (up to the depth): gulp N+1's
    ring work happens during gulp N's compute, which the synchronous
    loop never does."""
    events = []
    gate = threading.Event()
    data = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)
    config.set("pipeline_async_depth", 4)
    chunks = []
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, 8)
        t = _GatedTransform(src, events, gate)
        sink = gather_sink(t, chunks)
        _force_async_eligible(t, sink)
        runner = threading.Thread(target=pipe.run, daemon=True)
        runner.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and events.count("reserved") < 2:
            time.sleep(0.005)
        try:
            assert events.count("reserved") >= 2, events
            assert "process_end:0" not in events, events
        finally:
            gate.set()
        runner.join(30)
        assert not runner.is_alive()
    assert np.array_equal(np.concatenate(chunks, axis=0), data)
    assert events.index("process_end:0") > \
        [i for i, e in enumerate(events) if e == "reserved"][1]


def test_event_order_eager_h2d_staging():
    """Source side: with the commits slowed on the worker, the source's
    staging (on_data) of gulp N+1 starts while gulp N's commit is in
    flight.  The synchronous source stages N+1 only after commit N."""
    events = []
    src_ring = []
    data = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    real_commit = ring_mod.WriteSpan.commit

    def logged_commit(span, nframe=None):
        mine = src_ring and span.ring.name == src_ring[0]
        if mine:
            events.append(("commit_start", span.frame_offset))
            time.sleep(0.02)
        real_commit(span, nframe)
        if mine:
            events.append(("commit_end", span.frame_offset))

    def run(depth):
        del events[:]
        del src_ring[:]
        config.set("pipeline_async_depth", depth)
        try:
            chunks = []
            with Pipeline(device="cpu") as pipe:
                src = array_source(data, 8)
                _force_async_eligible(src)
                src_ring.append(src.orings[0].name)
                real_on_data = type(src).on_data

                def logged_on_data(reader, ospans):
                    events.append(("stage", src._cursor))
                    return real_on_data(src, reader, ospans)
                src.on_data = logged_on_data
                gather_sink(src, chunks)
                pipe.run()
            return np.concatenate(chunks, axis=0)
        finally:
            config.reset("pipeline_async_depth")

    ring_mod.WriteSpan.commit = logged_commit
    try:
        assert np.array_equal(run(4), data)
        async_events = list(events)
        assert np.array_equal(run(1), data)
        sync_events = list(events)
    finally:
        ring_mod.WriteSpan.commit = real_commit

    def overlapped(ev):
        open_commit = False
        for e in ev:
            if e[0] == "commit_start":
                open_commit = True
            elif e[0] == "commit_end":
                open_commit = False
            elif e[0] == "stage" and open_commit and e[1] > 0:
                return True
        return False

    assert overlapped(async_events), async_events[:16]
    assert not overlapped(sync_events), sync_events[:16]


def test_source_on_cuda_ring_runs_the_executor():
    """A source writing a 'cuda' ring qualifies by itself (no forcing):
    at depth 4 its gulps are committed by its worker, bitwise the
    synchronous run's."""
    data = np.arange(40 * 6, dtype=np.float32).reshape(40, 6)
    outs, threads = {}, {}
    for depth in (1, 4):
        config.set("pipeline_async_depth", depth)
        commits = []
        real_commit = ring_mod.WriteSpan.commit

        def commit(span, nframe=None, _c=commits):
            _c.append(threading.get_ident())
            real_commit(span, nframe)
        ring_mod.WriteSpan.commit = commit
        try:
            chunks = []
            with Pipeline(device="cpu") as pipe:
                src = array_source(data, 8, space="cuda")
                gather_sink(src, chunks)
                pipe.run()
        finally:
            ring_mod.WriteSpan.commit = real_commit
            config.reset("pipeline_async_depth")
        outs[depth] = np.concatenate(chunks, axis=0)
        threads[depth] = set(commits) - {src._thread_ident}
    assert _bits(outs[1], data) and _bits(outs[4], data)
    assert not threads[1] and threads[4]
    assert all(src.owns_thread(t) for t in threads[4])


# ------------------------------------------- syncs that remain

class _DeviceSink(SinkBlock):
    """A bare 'cuda'-ring sink that keeps its threads' objects: its block
    thread and its executor worker.  Syncs are attributed to thread
    objects, never to raw idents, which Python reuses once a thread has
    exited (another block's thread could otherwise count as the
    sink's)."""

    def __init__(self, iring, **kwargs):
        super().__init__(iring, **kwargs)
        self.ngulps = 0
        self.thread_objs = []

    def _run(self):
        self.thread_objs.append(threading.current_thread())
        super()._run()

    def _bind_worker_thread(self):
        self.thread_objs.append(threading.current_thread())
        super()._bind_worker_thread()

    def syncs(self, calls):
        """Syncs made on this sink's threads."""
        return sum(n for t, n in calls.items()
                   if any(t is o for o in self.thread_objs))

    def on_sequence(self, iseq):
        pass

    def on_data(self, ispan):
        self.ngulps += 1
        ispan.data


def _run_device_sink(guarantee, depth, monkeypatch):
    """ci8 -> 'cuda' ring -> a bare sink -> (sink, {thread object: calls
    of device.stream_synchronize})."""
    raw = np.zeros((32, 2, 2), dtype=[("re", "i1"), ("im", "i1")])
    raw["re"] = np.arange(128, dtype=np.int8).reshape(32, 2, 2) % 7
    calls = {}
    real_sync = device_mod.stream_synchronize

    def counting_sync(device=None):
        t = threading.current_thread()
        calls[t] = calls.get(t, 0) + 1
        real_sync(device)

    monkeypatch.setattr(device_mod, "stream_synchronize", counting_sync)
    config.set("pipeline_async_depth", depth)
    with Pipeline(device="cpu") as pipe:
        src = array_source(raw, 8, header={
            "dtype": "ci8", "labels": ["time", "freq", "pol"]})
        dev = blocks.copy(src, space="cuda")
        sink = _DeviceSink(dev, guarantee=guarantee)
        pipe.run()
    return sink, calls


def test_release_never_host_syncs(monkeypatch):
    """A guaranteed 'cuda'-ring sink hands its spans back on the release
    event: neither its block thread nor its worker synchronises a gulp
    (the one call is the block thread's when its run ends)."""
    sink, calls = _run_device_sink(True, 4, monkeypatch)
    assert sink.ngulps == 4
    assert sink._exec_async_depth == 4
    assert sink.syncs(calls) == 1, calls


def test_lossy_sink_still_syncs(monkeypatch):
    """A lossy reader's overwrite check means something only after its
    gulp's reads are done: the lossy sink stays on the synchronous loop
    whatever the depth and synchronises every gulp."""
    sink, calls = _run_device_sink(False, 4, monkeypatch)
    assert sink.ngulps >= 1
    assert sink._exec_async_depth == 0
    assert sink.syncs(calls) >= sink.ngulps + 1, calls


def test_readspan_release_no_block_until_ready(monkeypatch):
    """ReadSpan.release itself never synchronises: no stream
    synchronisation, and only the events a span is held by."""
    calls = []
    monkeypatch.setattr(device_mod, "stream_synchronize",
                        lambda device=None: calls.append("sync"))

    class Held:
        def synchronize(self):
            calls.append("held")

    ring = ring_mod.Ring(space="cuda", name="relnosync", device="cpu")
    hdr = {"name": "s", "time_tag": 0,
           "_tensor": {"dtype": "f32", "shape": [-1, 4],
                       "labels": ["time", "x"]}}
    with ring.begin_writing() as writer:
        with writer.begin_sequence(hdr, gulp_nframe=2,
                                   buf_nframe=4) as wseq:
            with wseq.reserve(2) as ws:
                ws.data.fill_(1.0)
            rseq = ring.open_sequence("earliest", guarantee=True)
            span = rseq.acquire(0, 1)
            span.release()
            assert calls == []
            span = rseq.acquire(1, 1)
            span.hold_until(Held())
            span.release()
            rseq.close()
    assert calls == ["held"]


# ------------------------------------- config validation + latching

def test_depth_flag_validation():
    for bad in (0, -1, 17, 99):
        with pytest.raises(ValueError, match="pipeline_async_depth"):
            config.set("pipeline_async_depth", bad)
    with pytest.raises(ValueError, match="pipeline_async_depth"):
        config.set("pipeline_async_depth", True)
    with pytest.raises(ValueError, match="pipeline_async_depth"):
        config.set("pipeline_async_depth", "4")
    config.set("pipeline_async_depth", 16)
    config.reset("pipeline_async_depth")


def test_depth_env_value_validated_at_read(monkeypatch):
    """A bad value that bypassed `set` fails loudly at the first read.
    The port reads no environment: a raw entry in the override table
    stands in for the JAX case's environment variable."""
    monkeypatch.setitem(config._overrides, "pipeline_async_depth", 99)
    with pytest.raises(ValueError, match="pipeline_async_depth"):
        config.get("pipeline_async_depth")


def test_depth_latched_rejects_midsequence_toggle():
    """config.set('pipeline_async_depth') mid-sequence is rejected naming
    the latching block; released at the sequence's end."""
    data = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    errs = []

    def poke(_):
        try:
            config.set("pipeline_async_depth", 2)
        except RuntimeError as e:
            if not errs:
                errs.append(str(e))

    config.set("pipeline_async_depth", 3)
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, 8)
        sink = callback_sink(src, on_data=poke)
        _force_async_eligible(src, sink)
        pipe.run()
    config.reset("pipeline_async_depth")
    assert errs, "mid-sequence toggle was not rejected"
    assert "pipeline_async_depth" in errs[0] and "latched" in errs[0]
    config.set("pipeline_async_depth", 2)


def test_fused_async_latched_rejects_midsequence_toggle():
    """The fused group latches `fused_async` at on_sequence: a toggle
    mid-sequence is rejected naming the group."""
    rng = np.random.default_rng(3)
    raw = rng.integers(-8, 8, (40, 4, 64, 2, 2)).astype(np.int8)
    errs, got = [], []

    def poke(arr):
        got.append(arr.clone())
        if len(got) == 1:
            try:
                config.set("fused_async", False)
            except RuntimeError as e:
                errs.append(str(e))

    config.set("fused_async", True)
    with Pipeline(device="cpu") as pipe:
        src = array_source(raw, 1, header={
            "dtype": "ci8", "labels": ["time", "freq", "fine_time", "pol"]})
        with bt.block_scope(fuse=True):
            dev = blocks.copy(src, space="cuda")
            t = blocks.transpose(dev, ["time", "pol", "freq", "fine_time"])
            f = blocks.fft(t, axes="fine_time", axis_labels="fine_freq")
            d = blocks.detect(f, mode="stokes")
            m = views.merge_axes(d, "freq", "fine_freq", label="freq")
            a = blocks.accumulate(m, 2)
        callback_sink(a, on_data=poke)
        pipe.run()
    assert got
    assert errs, "mid-sequence fused_async toggle was not rejected"
    assert "fused_async" in errs[0] and "Fused_" in errs[0]


def test_sync_path_untouched_when_depth_is_one():
    """Depth 1 keeps the synchronous loops: no worker, no latch."""
    data = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)
    chunks = []
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, 8, space="cuda")
        sink = gather_sink(src, chunks)
        pipe.run()
    assert np.array_equal(np.concatenate(chunks, axis=0), data)
    assert src._dispatcher is None and sink._dispatcher is None
    assert sink._exec_async_depth == 0
    config.set("pipeline_async_depth", 2)      # nothing latched it


# ----------------------------- exact emit schedules (reserve-ahead)

def test_output_nframes_for_gulp_matches_on_data():
    """The exact-schedule contract against the blocks' own phase
    arithmetic: correlate (gulp dividing n_int, a short final gulp) and
    accumulate (gulp 1)."""
    from bifrost_tpu_torch.blocks.accumulate import AccumulateBlock
    from bifrost_tpu_torch.blocks.correlate import CorrelateBlock

    cor = CorrelateBlock.__new__(CorrelateBlock)
    cor.nframe_per_integration = 24
    phase, rel = 0, 0
    for in_nframe in [8, 8, 8, 8, 8, 8, 8, 4]:
        promised, = cor.output_nframes_for_gulp(rel, in_nframe)
        phase += in_nframe
        emitted = 1 if phase >= 24 else 0
        if emitted:
            phase = 0
        assert promised == emitted, (rel, in_nframe)
        rel += in_nframe

    acc = AccumulateBlock.__new__(AccumulateBlock)
    acc.nframe = 3
    assert [acc.output_nframes_for_gulp(r, 1)[0]
            for r in range(9)] == [0, 0, 1, 0, 0, 1, 0, 0, 1]
    # Every phase emitter of the JAX package moves its reserve onto the
    # worker, as here.
    from bifrost_tpu_torch.blocks import (BeamformBlock, FdmtBlock,
                                          GainCalBlock, GridderBlock,
                                          PfbBlock, RfiFlagBlock)
    for cls in (AccumulateBlock, BeamformBlock, GainCalBlock,
                CorrelateBlock, FdmtBlock, RfiFlagBlock, PfbBlock,
                GridderBlock):
        assert cls.async_reserve_ahead is False, cls


def test_emit_hook_restores_reserve_ahead():
    """A phase emitter with the exact hook reserves ahead: with gulp 0
    held on the worker, the block thread's reserve frontier runs >= 2
    gulps ahead despite async_reserve_ahead False."""
    events = []
    gate = threading.Event()
    data = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)

    class PhaseEmitter(TransformBlock):
        async_reserve_ahead = False

        def on_sequence(self, iseq):
            self._phase = 0
            hdr = dict(iseq.header)
            hdr["gulp_nframe"] = 1
            return hdr

        def define_output_nframes(self, input_nframe):
            return [1]

        def output_nframes_for_gulp(self, rel_frame0, in_nframe):
            return [(rel_frame0 + in_nframe) // 16 - rel_frame0 // 16]

        def _perf_add(self, **phases):
            if "acquire" in phases:
                events.append("reserved")
            super()._perf_add(**phases)

        def on_data(self, ispan, ospan):
            if len(events) and not events.count("process"):
                events.append("process")
                gate.wait(20)
            self._phase += ispan.nframe
            if self._phase >= 16:
                ospan.data.copy_(ispan.data[-1:])
                self._phase = 0
                return 1
            return 0

    config.set("pipeline_async_depth", 4)
    chunks = []
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, 8)
        t = PhaseEmitter(src)
        sink = gather_sink(t, chunks)
        _force_async_eligible(t, sink)
        runner = threading.Thread(target=pipe.run, daemon=True)
        runner.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and events.count("reserved") < 2:
            time.sleep(0.005)
        ahead = events.count("reserved")
        gate.set()
        runner.join(30)
        assert not runner.is_alive()
    assert ahead >= 2, events
    assert np.array_equal(np.concatenate(chunks, axis=0), data[15::16])


def test_emit_hook_exactness_violation_raises():
    """A hook that promises 0 while on_data commits 1 is a loud
    RuntimeError naming the contract."""
    data = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)

    class Liar(TransformBlock):
        async_reserve_ahead = False

        def on_sequence(self, iseq):
            return dict(iseq.header)

        def output_nframes_for_gulp(self, rel_frame0, in_nframe):
            return [0]

        def on_data(self, ispan, ospan):
            return 1

    config.set("pipeline_async_depth", 4)
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, 8)
        t = Liar(src)
        _force_async_eligible(t)
        gather_sink(t, [])
        with pytest.raises(RuntimeError, match="output_nframes_for_gulp"):
            pipe.run()


# ------------------------------------- fault-tolerance interplay

class _WedgeableSink(SinkBlock):
    def on_sequence(self, iseq):
        pass

    def on_data(self, ispan):
        ispan.data.sum()


def test_quiesce_drains_inflight_batch_within_deadline():
    """A FaultPlan wedges the sink's worker mid-batch (on_data runs on
    the worker): shutdown(timeout=) still returns within its bound, the
    block is reported, and the DrainReport carries the queued gulps."""
    release = threading.Event()
    entered = threading.Event()
    data = np.arange(256 * 4, dtype=np.float32).reshape(256, 4)
    config.set("pipeline_async_depth", 4)
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, 8)
        sink = _WedgeableSink(src)
        _force_async_eligible(sink)
        plan = FaultPlan()
        plan.wedge_at("block.on_data", block=sink.name, nth=1,
                      release=release, entered=entered, timeout=60.0)
        plan.attach(pipe)
        runner = threading.Thread(target=pipe.run, daemon=True)
        runner.start()
        try:
            assert entered.wait(20)
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and \
                    (sink._async_queue_depth() or 0) < 2:
                time.sleep(0.01)
            queued_before = sink._async_queue_depth()
            assert queued_before and queued_before >= 2
            t0 = time.monotonic()
            report = pipe.shutdown(timeout=1.0, join_grace=0.5)
            dt = time.monotonic() - t0
        finally:
            release.set()
        runner.join(30)
        plan.detach()
    assert not runner.is_alive()
    assert dt < 1.0 + 0.5 + 2.0
    entry = report.blocks[sink.name]
    assert entry["outcome"] in ("interrupted", "wedged")
    assert entry.get("queued_gulps", 0) >= 1
    assert not report.clean


def test_deadman_not_delayed_by_queued_dispatches():
    """A deadman ends an executor pipeline in bounded time with a full
    queue: the wedged worker stops the heartbeat, the watchdog deadmans
    the block, and neither the queued gulps nor the block thread's
    full-queue submit wait postpone the escalation."""
    release = threading.Event()
    entered = threading.Event()
    data = np.arange(512 * 4, dtype=np.float32).reshape(512, 4)

    class WedgeSink(SinkBlock):
        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            if not entered.is_set():
                entered.set()
                release.wait(120)

    config.set("pipeline_async_depth", 4)
    t0 = time.monotonic()
    try:
        with Pipeline(device="cpu") as pipe:
            src = array_source(data, 8)
            wsink = WedgeSink(src)
            _force_async_eligible(wsink)
            sup = Supervisor(policy=RestartPolicy(max_restarts=1,
                                                  backoff=0.01),
                             heartbeat_interval_s=0.2, heartbeat_misses=3)
            with pytest.raises(SupervisorEscalation):
                pipe.run(supervise=sup)
    finally:
        release.set()
    assert entered.is_set()
    assert time.monotonic() - t0 < 60
    assert sup.counters["deadman_interrupts"] >= 1


def test_worker_fault_surfaces_and_pipeline_fails_fast():
    """An exception raised by on_data on the worker surfaces on the
    block thread and fails the run (the fail-fast default)."""
    data = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)

    class BoomTransform(TransformBlock):
        def on_sequence(self, iseq):
            return dict(iseq.header)

        def on_data(self, ispan, ospan):
            if ispan.frame_offset >= 8:
                raise RuntimeError("worker boom")
            ospan.data.copy_(ispan.data)
            return ispan.nframe

    config.set("pipeline_async_depth", 4)
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, 8)
        t = BoomTransform(src)
        _force_async_eligible(t)
        gather_sink(t, [])
        with pytest.raises(RuntimeError, match="worker boom"):
            pipe.run()


def test_supervised_restart_sheds_batch_no_duplicates():
    """Under supervision a worker fault sheds the in-flight batch and the
    restarted sequence resumes at the dispatch frontier: no duplicated or
    reordered frame, a gap bounded by the depth."""
    gulp, depth, nframe = 8, 4, 256
    data = np.arange(nframe * 4, dtype=np.float32).reshape(nframe, 4)
    boom = {"armed": True}

    class FlakyTransform(TransformBlock):
        def on_sequence(self, iseq):
            return dict(iseq.header)

        def on_data(self, ispan, ospan):
            if boom["armed"] and ispan.frame_offset >= 16:
                boom["armed"] = False
                raise RuntimeError("transient")
            ospan.data.copy_(ispan.data)
            return ispan.nframe

    config.set("pipeline_async_depth", depth)
    chunks = []
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, gulp)
        t = FlakyTransform(src)
        _force_async_eligible(t)
        gather_sink(t, chunks)
        sup = Supervisor(policy=RestartPolicy(max_restarts=3, backoff=0.01))
        pipe.run(supervise=sup)
    out = np.concatenate(chunks, axis=0)
    assert sup.counters["restarts"] >= 1
    ids = out[:, 0].astype(np.int64) // 4
    assert np.all(np.diff(ids) > 0), "duplicated/reordered frames"
    assert len(out) >= nframe - (depth + 2) * gulp
    assert ids[-1] == nframe - 1
    assert list(ids[:2]) == [0, 1]


def test_dispatcher_drops_stale_successors_after_fault_race():
    """A submit that consumes the worker's pending exception before the
    worker takes its lock again: the successor queued behind the fault
    is epoch-tagged and still dropped; fresh work runs."""
    ran = []
    disp = _GulpDispatcher("race", depth=4)
    try:
        with disp._cv:
            disp._queue.append((disp._epoch, lambda: ran.append("stale")))
            disp._exc = RuntimeError("boom")
            disp._epoch += 1
            disp._cv.notify_all()
        with pytest.raises(RuntimeError, match="boom"):
            disp.submit(lambda: ran.append("fresh"))
        disp.submit(lambda: ran.append("fresh"))
        assert disp.drain(timeout=5)
    finally:
        disp.close()
    assert ran == ["fresh"]


def test_config_reset_honors_latch():
    """config.reset() obeys the same latch as config.set()."""
    config.set("pipeline_async_depth", 3)
    config.hold_latch("pipeline_async_depth", "TestBlock_0")
    try:
        with pytest.raises(RuntimeError, match="latched"):
            config.reset("pipeline_async_depth")
        with pytest.raises(RuntimeError, match="latched"):
            config.reset()
        config.reset("fft_method")     # no override to drop: allowed
    finally:
        config.release_latch("pipeline_async_depth", "TestBlock_0")
    config.reset("pipeline_async_depth")
    assert config.get("pipeline_async_depth") == 1


def test_worker_thread_attributed_to_block():
    """Supervision and fault injection attribute the worker to its block
    (Block.owns_thread)."""
    data = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    idents = []

    class RecordTransform(TransformBlock):
        def on_sequence(self, iseq):
            return dict(iseq.header)

        def on_data(self, ispan, ospan):
            idents.append(threading.get_ident())
            ospan.data.copy_(ispan.data)
            return ispan.nframe

    config.set("pipeline_async_depth", 3)
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, 8)
        t = RecordTransform(src)
        _force_async_eligible(t)
        gather_sink(t, [])
        pipe.run()
    assert idents
    worker = idents[0]
    assert worker != t._thread_ident
    assert t.owns_thread(worker) and t.owns_thread(t._thread_ident)
    assert not t.owns_thread(-1)


def test_worker_bind_failure_closes_dispatcher():
    """A worker whose bind fails runs nothing: the error surfaces at the
    next drain, later submits are refused."""
    def bind_fail():
        raise RuntimeError("bind fail")

    ran = []
    disp = _GulpDispatcher("bindfail", depth=2, on_worker_start=bind_fail)
    disp._thread.join(timeout=5)
    assert not disp._thread.is_alive()
    with pytest.raises(RuntimeError, match="bind fail"):
        disp.drain()
    with pytest.raises(RuntimeError, match="closed"):
        disp.submit(lambda: ran.append(1))
    assert disp.drain(timeout=1)
    assert ran == []
    disp.close()


def test_executor_stress_more_threads_than_cores():
    """Twelve chained transforms at depth 4 (a block thread and a worker
    each, more threads than cores), one-frame gulps, the interpreter
    switching threads every microsecond: every frame arrives once, in
    order, and no booking of the perf totals, which both threads of a
    block write, is lost."""
    data = np.arange(600 * 2, dtype=np.float32).reshape(600, 2)

    class Pass(TransformBlock):
        async_reserve_ahead = False      # the worker books 'reserve' too

        def on_sequence(self, iseq):
            self.bookings = []
            return dict(iseq.header)

        def _perf_add(self, **phases):
            self.bookings.append(1)
            super()._perf_add(n=1.0, **phases)

        def on_data(self, ispan, ospan):
            ospan.data.copy_(ispan.data)
            return ispan.nframe

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        config.set("pipeline_async_depth", 4)
        chunks = []
        with Pipeline(device="cpu") as pipe:
            b = array_source(data, 1)
            chain = []
            for _ in range(12):
                b = Pass(b)
                chain.append(b)
            _force_async_eligible(*chain)
            gather_sink(b, chunks)
            runner = threading.Thread(target=pipe.run, daemon=True)
            runner.start()
            runner.join(120)
            assert not runner.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert _bits(np.concatenate(chunks, axis=0), data)
    for blk in chain:
        assert blk._exec_async_depth == 4
        assert blk.perf_totals["n"] == len(blk.bookings) >= 2 * 600
        assert blk._dispatcher is None          # closed at the end


# ------------------------------------ strict_sync, serialize_dispatch

def _gpuspec_mini(data, n_int, scope=True):
    got = []
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, 1, header={
            "dtype": "ci8", "labels": ["time", "freq", "fine_time", "pol"]})
        with bt.block_scope(fuse=True) if scope else bt.block_scope():
            dev = blocks.copy(src, space="cuda")
            t = blocks.transpose(dev, ["time", "pol", "freq", "fine_time"])
            f = blocks.fft(t, axes="fine_time", axis_labels="fine_freq")
            d = blocks.detect(f, mode="stokes")
            m = views.merge_axes(d, "freq", "fine_freq", label="freq")
            a = blocks.accumulate(m, n_int)
        callback_sink(a, on_data=lambda arr: got.append(arr.clone()))
    return pipe, got


def test_strict_sync_leaves_nothing_in_flight(monkeypatch):
    """Under strict_sync every gulp of every device block synchronises
    its stream before its commit, at any depth: no executor, no fused
    group (the plan gives the 'strict_sync' reason), no fused_async;
    the output is bitwise the default run's."""
    rng = np.random.default_rng(5)
    raw = rng.integers(-8, 8, (12, 4, 32, 2, 2)).astype(np.int8)
    base_pipe, base = _gpuspec_mini(raw, 4)
    base_pipe.run()
    assert base_pipe.fusion_report()["groups"]

    calls = {}
    real_sync = device_mod.stream_synchronize

    def counting_sync(device=None):
        i = threading.get_ident()
        calls[i] = calls.get(i, 0) + 1
        real_sync(device)

    monkeypatch.setattr(device_mod, "stream_synchronize", counting_sync)
    config.set("strict_sync", True)
    config.set("pipeline_async_depth", 4)
    pipe, got = _gpuspec_mini(raw, 4)
    rep = pipe.fusion_report()
    pipe.run()
    assert not rep["groups"]
    strict = [n for n, r in rep["refused"].items() if r == "strict_sync"]
    assert len(strict) == 4, rep         # copy, transpose, fft, detect
    for b in pipe.blocks:
        assert b._dispatcher is None and not b._exec_async_depth, b.name
        if b._touches_device:
            # One call a gulp (12 frames, gulps of one: 3 integrations
            # into the sink) and the block thread's last.
            want = 12 + 1 if b.orings else 3 + 1
            assert calls.get(b._thread_ident, 0) >= want, (b.name, calls)
    assert all(_bits(a.numpy(), b.numpy()) for a, b in zip(got, base))
    assert len(got) == len(base) == 3


def test_strict_sync_turns_fused_async_off():
    """A fused group resolves fused_async off under strict_sync (its
    refusal keeps groups from being built; a group built before the
    flag was set still keeps nothing in flight)."""
    from bifrost_tpu_torch.fuse import FusedChainBlock
    rng = np.random.default_rng(6)
    raw = rng.integers(-8, 8, (8, 4, 32, 2, 2)).astype(np.int8)
    pipe, got = _gpuspec_mini(raw, 4)
    pipe._fuse_device_chains()
    group = next(b for b in pipe.blocks if isinstance(b, FusedChainBlock))
    assert group._resolve_async()
    config.set("strict_sync", True)
    assert not group._resolve_async()
    pipe.run()
    assert group._dispatcher is None and len(got) == 2


def test_serialize_dispatch_admits_one_device_scope_at_a_time():
    """Under serialize_dispatch one block's device scope runs at a time:
    two device blocks that each sit 5 ms in their scope never overlap;
    a host-only block takes no lock.  Output as without the flag."""
    data = np.arange(48 * 4, dtype=np.float32).reshape(48, 4)
    state = {"inside": 0, "most": 0}
    lock = threading.Lock()

    class Slow(TransformBlock):
        def on_sequence(self, iseq):
            return dict(iseq.header)

        def on_data(self, ispan, ospan):
            with lock:
                state["inside"] += 1
                state["most"] = max(state["most"], state["inside"])
            time.sleep(0.005)
            ospan.data.copy_(ispan.data)
            with lock:
                state["inside"] -= 1
            return ispan.nframe

    outs = {}
    for serialize in (True, False):
        state.update(inside=0, most=0)
        config.set("serialize_dispatch", serialize)
        chunks = []
        with Pipeline(device="cpu") as pipe:
            src = array_source(data, 4, space="cuda")
            a = Slow(src)
            b = Slow(a)
            host = blocks.copy(b, space="system")
            gather_sink(host, chunks)
            pipe.run()
        config.reset("serialize_dispatch")
        outs[serialize] = (np.concatenate(chunks, axis=0), state["most"])
        assert a._touches_device and b._touches_device
    assert outs[True][1] == 1
    assert _bits(outs[True][0], data) and _bits(outs[False][0], data)
    assert device_mod.needs_serialized_dispatch() is False


# ---------------------------- tests/test_async_dispatch.py (the rest)

def test_dispatcher_runs_in_submission_order():
    d = _GulpDispatcher("t")
    try:
        seen = []
        for i in range(20):
            d.submit(lambda i=i: seen.append(i))
        d.drain()
        assert seen == list(range(20))
    finally:
        d.close()


def test_dispatcher_bounded_backpressure():
    """submit() takes DEPTH items, then blocks until the head ends."""
    d = _GulpDispatcher("t")
    try:
        running = threading.Event()
        hold = threading.Event()
        d.submit(lambda: (running.set(), hold.wait(5)))
        assert running.wait(5)
        d.submit(lambda: None)
        t0 = time.perf_counter()
        release = threading.Timer(0.2, hold.set)
        release.start()
        d.submit(lambda: None)
        assert time.perf_counter() - t0 >= 0.15
        d.drain()
    finally:
        d.close()


def test_dispatcher_close_is_idempotent_and_joins():
    d = _GulpDispatcher("t")
    d.submit(lambda: None)
    d.drain()
    d.close()
    d.close()
    assert not d._thread.is_alive()


# ------------------------------------------------------- the benchmark

def test_pipeline_async_benchmark_check():
    """benchmarks_torch/pipeline_async.py --check on the CPU: the chain
    bitwise at depths 1 and 4 and against the golden, the overlap, the
    three disciplines' self-check."""
    res = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks_torch" / "pipeline_async.py"),
         "--check", "--device", "cpu"], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert '"pipeline_async_check": "ok"' in res.stdout
