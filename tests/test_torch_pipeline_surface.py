"""The pipeline, ring, egress and config names the port gained to match
the JAX package's surface, each held to the JAX package where both run:
`Pipeline.dot_graph` (the same text for the same topology), `izip`,
`as_default`, `bound_device`, the `Block.shutdown` hook,
`define_valid_input_spaces`, `exact_output_nframes`,
`EgressStager.inflight`/`drain`, `config.describe`, and the ring's
`clear_interrupt`, `writing_ended`, `ReadSequence.finished`,
`WriteSpan.wait_ready` and `TensorInfo.full_shape`/`span_array`."""

import numpy as np
import pytest

import bifrost_tpu.blocks as jblocks
import bifrost_tpu.pipeline as jpipeline
from bifrost_tpu.ring import TensorInfo as JTensorInfo

import bifrost_tpu_torch.blocks as tblocks
import bifrost_tpu_torch.pipeline as tpipeline
from bifrost_tpu_torch import config
from bifrost_tpu_torch.ring import Ring, TensorInfo


def _chain(pipeline_mod, blocks, pipe):
    data = np.arange(64, dtype=np.float32).reshape(16, 4)
    with pipe:
        src = blocks.array_source(data, 8)
        mid = blocks.copy(src, space="system", name="mid")
        blocks.callback_sink(mid, name="sink")
    return pipe


def test_dot_graph_is_the_jax_text_for_the_same_topology():
    jpipe = _chain(jpipeline, jblocks, jpipeline.Pipeline())
    tpipe = _chain(tpipeline, tblocks, tpipeline.Pipeline(device="cpu"))
    # array_source names its block by a per-process count: name it "src"
    # in both texts.
    dot = tpipe.dot_graph().replace(tpipe.blocks[0].name, "src")
    assert dot == jpipe.dot_graph().replace(jpipe.blocks[0].name, "src")
    assert dot.startswith("digraph pipeline {")
    assert '"src" -> "mid" [label="system"]' in dot


def test_izip_as_default_and_bound_device():
    assert list(tpipeline.izip("ab", [1, 2])) == \
        list(jpipeline.izip("ab", [1, 2]))
    pipe = tpipeline.Pipeline(device="cpu")
    assert pipe.as_default() is pipe
    with pipe:
        blk = tblocks.array_source(np.zeros((4, 2), np.float32), 2)
        with tpipeline.block_scope(gulp_nframe=2):
            inner = tblocks.copy(blk, space="system")
    assert blk.bound_device == blk.device == pipe.device
    assert inner.bound_device == pipe.device
    assert inner.define_valid_input_spaces() == ["any"]


def test_shutdown_hook_runs_on_the_block_thread_however_it_ends():
    calls = []

    class Sink(tpipeline.SinkBlock):
        def __init__(self, iring, fail, **kw):
            super().__init__(iring, **kw)
            self.fail = fail

        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            if self.fail:
                raise ValueError("sink fault")

        def shutdown(self):
            calls.append(self.name)

    for fail in (False, True):
        with tpipeline.Pipeline(device="cpu") as pipe:
            src = tblocks.array_source(np.zeros((8, 2), np.float32), 4)
            Sink(src, fail, name=f"sink_{fail}")
            if fail:
                with pytest.raises(ValueError, match="sink fault"):
                    pipe.run()
            else:
                pipe.run()
    assert calls == ["sink_False", "sink_True"]


def test_exact_output_nframes_sizes_a_partial_gulp():
    """A block whose output is not proportional to its input sizes a
    final partial gulp's reservation by define_output_nframes (the JAX
    loop's rule): 10 frames at gulps of 8, one output frame fewer than
    each gulp's input frames."""
    from bifrost_tpu.blocks.calibrate import GainCalBlock as JCal
    from bifrost_tpu.blocks.flag import RfiFlagBlock as JFlag
    from bifrost_tpu.blocks.pfb import PfbBlock as JPfb
    from bifrost_tpu_torch.blocks.calibrate import GainCalBlock
    from bifrost_tpu_torch.blocks.flag import RfiFlagBlock
    from bifrost_tpu_torch.blocks.pfb import PfbBlock
    for port, jax in ((GainCalBlock, JCal), (RfiFlagBlock, JFlag),
                      (PfbBlock, JPfb)):
        assert port.exact_output_nframes is jax.exact_output_nframes is True
    assert tpipeline.FusedTransformBlock.exact_output_nframes is True
    reserved = []

    class DropOne(tpipeline.TransformBlock):
        exact_output_nframes = True

        def on_sequence(self, iseq):
            return [iseq.header]

        def define_output_nframes(self, input_nframe):
            return [input_nframe - 1]

        def on_data(self, ispan, ospan):
            reserved.append(ospan.nframe)
            ospan.data[...] = ispan.data[1:]
            return ospan.nframe

    with tpipeline.Pipeline(device="cpu") as pipe:
        src = tblocks.array_source(np.arange(10, dtype=np.float32)
                                   .reshape(10, 1), 8)
        DropOne(src, guarantee=False, gulp_nframe=8)
        pipe.run()
    # Scaling the full gulp's 7 by 2/8 would reserve 2 for the last gulp.
    assert reserved == [7, 1]


def test_egress_stager_inflight_and_drain():
    import torch
    from bifrost_tpu_torch.egress import EgressStager
    st = EgressStager("stager", device="cpu")
    try:
        assert st.inflight() == 0
        hdr = {"_tensor": {"dtype": "f32", "shape": [-1, 4]}}
        t = TensorInfo(hdr)
        data = torch.arange(16, dtype=torch.float32).reshape(4, 4)
        ticket = st.stage(data, t, 4, 0)
        st.drain()
        assert st.inflight() == 0 and ticket.ready
        np.testing.assert_array_equal(ticket.array, data.numpy())
        st.release(ticket)
    finally:
        st.close()


def test_config_describe_lists_every_flag():
    """Two lines a flag, in the JAX package's layout: name, environment
    variable and value; then the description."""
    from bifrost_tpu import config as jconfig
    text, jtext = config.describe(), jconfig.describe()
    assert len(text.splitlines()) == 2 * len(config.FLAGS)
    assert len(jtext.splitlines()) == 2 * len(jconfig.FLAGS)
    for (head, desc), flag in zip(zip(*[iter(text.splitlines())] * 2),
                                  config.FLAGS.values()):
        assert head.split()[0] == flag.name
        assert head.endswith(f"= {flag.value()!r}")
        assert desc.strip() == flag.description


def test_ring_interrupt_reset_writing_ended_and_finished():
    ring = Ring(name="surface_ring")
    g1, g2 = ring.interrupt(), ring.interrupt()
    assert ring.interrupt_info()[:2] == (g2, 0)
    ring.clear_interrupt()
    assert ring.interrupt_info()[:2] == (g2, g2)
    assert not ring.writing_ended
    hdr = {"_tensor": {"dtype": "f32", "shape": [-1, 2]}}
    ring.begin_writing()
    oseq = ring.begin_sequence(hdr, gulp_nframe=2)
    with oseq.reserve(2) as ospan:
        ospan.data[...] = 1.0
        ospan.wait_ready()
    seqs = ring.read(guarantee=True)
    iseq = next(seqs)
    assert not iseq.finished
    oseq.end()
    assert iseq.finished
    ring.end_writing()
    assert ring.writing_ended
    seqs.close()


@pytest.mark.parametrize("dtype,shape", [("f32", [-1, 3, 4]),
                                         ("ci8", [2, -1, 4]),
                                         ("i4", [-1, 8])])
def test_tensor_info_host_views_match_the_jax_ring(dtype, shape):
    hdr = {"_tensor": {"dtype": dtype, "shape": shape}}
    t, j = TensorInfo(hdr), JTensorInfo(hdr)
    assert t.full_shape(5) == j.full_shape(5)
    assert t.frame_nbyte == j.frame_nbyte
    nframe, nbyte = 5, 4096
    buf = np.random.default_rng(1).integers(0, 255, nbyte, dtype=np.uint8)
    stride = 5 * t.frame_nbyte
    a = t.span_array(buf.ctypes.data, stride, nframe, "system")
    b = j.span_array(buf.ctypes.data, stride, nframe, "system")
    assert a.shape == b.shape and a.strides == b.strides
    assert a.tobytes() == b.tobytes()
    assert not a.bf.ownbuffer and str(a.bf.dtype) == dtype
    assert t.span_array_cached(buf.ctypes.data, stride, nframe, "system") \
        is t.span_array_cached(buf.ctypes.data, stride, nframe, "system")


def test_devices_and_external_stream_on_the_cpu(monkeypatch):
    """`get_devices` lists the CUDA devices, or the CPU alone where the
    caller bound it; `ExternalStream()` with no stream only syncs, and a
    raw stream address needs a card."""
    import threading
    from bifrost_tpu_torch import device
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    got = {}

    def run():
        got["unbound"] = device.get_devices()
        device.set_device("cpu")
        got["bound"] = device.get_devices()
        got["count"] = device.device_count()
        with device.ExternalStream() as scope:
            got["stream"] = scope.stream
        try:
            device.ExternalStream(12345)
        except RuntimeError as e:
            got["raw"] = str(e)
    th = threading.Thread(target=run)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    assert got["unbound"] == [] and got["bound"] == [torch.device("cpu")]
    assert got["count"] == 1 and got["stream"] is None
    assert "needs a CUDA device" in got["raw"]
