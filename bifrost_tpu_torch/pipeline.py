"""Pipeline framework: thread-per-block gulp streaming over rings
(counterpart of bifrost_tpu/pipeline.py; reference python/bifrost/
pipeline.py).

BlockScope hierarchical defaults, a Pipeline with an init barrier, the
Source / MultiTransform / Transform / Sink block classes with the
synchronous gulp loop: input overlap (`define_input_overlap_nframe`),
the exact emit schedule (`output_nframes_for_gulp`), and skip handling;
and the header views (`RingView`, `SequenceView`, `block_view`).

Device handling: a pipeline runs on one torch device, the card unless
the caller passes ``device='cpu'``; with no card and no device named,
`Pipeline()` raises.  Each block thread runs on its own CUDA stream.
Blocks hand device spans across streams through the rings' commit and
release events (ring.py), so a gulp whose outputs stay on the device
needs no host synchronisation; one whose outputs are host memory is
synchronised before its commit.
"""

from __future__ import annotations

import copy as _copy
import json
import queue
import threading
import time

from . import device as _device
from .ring import (EndOfDataStop, ReadSequence, Ring, RingInterrupted,
                   TensorInfo)

__all__ = ["Pipeline", "get_default_pipeline", "block_scope", "BlockScope",
           "Block", "SourceBlock", "SinkBlock", "TransformBlock",
           "MultiTransformBlock", "PipelineInitError", "RingView",
           "SequenceView", "block_view"]


class PipelineInitError(RuntimeError):
    pass


_tls = threading.local()


def _scope_stack():
    if not hasattr(_tls, "scopes"):
        _tls.scopes = []
    return _tls.scopes


_default_pipelines = []


def get_default_pipeline():
    """The innermost active Pipeline (reference pipeline.py:74)."""
    if not _default_pipelines:
        _default_pipelines.append(Pipeline())
    return _default_pipelines[-1]


class BlockScope(object):
    """Hierarchical defaults resolved by parent walk
    (reference pipeline.py:87-165)."""

    _settable = ("gulp_nframe", "buffer_nframe", "buffer_factor", "device")
    instance_count = 0

    def __init__(self, name=None, parent=None, **kwargs):
        for key in kwargs:
            if key not in self._settable:
                raise TypeError(f"unexpected scope setting: {key}")
        self._settings = {k: kwargs.get(k) for k in self._settable}
        if name is None:
            name = f"scope_{BlockScope.instance_count}"
        BlockScope.instance_count += 1
        self.scope_name = name
        stack = _scope_stack()
        self._parent = parent if parent is not None else \
            (stack[-1] if stack else None)

    def _lookup(self, key, default=None):
        scope = self
        while scope is not None:
            val = scope._settings.get(key)
            if val is not None:
                return val
            scope = scope._parent
        return default

    def __enter__(self):
        _scope_stack().append(self)
        return self

    def __exit__(self, *exc):
        _scope_stack().pop()

    @property
    def gulp_nframe(self):
        return self._lookup("gulp_nframe")

    @property
    def buffer_factor(self):
        return self._lookup("buffer_factor", 3)

    @property
    def buffer_nframe(self):
        return self._lookup("buffer_nframe")

    @property
    def device(self):
        """The torch device this scope's blocks run on."""
        return self._lookup("device")


def block_scope(**kwargs):
    """`with bf.block_scope(gulp_nframe=4096): ...`"""
    return BlockScope(**kwargs)


class Pipeline(BlockScope):
    """The root scope: owns blocks and rings, runs them on threads
    (reference pipeline.py:226-308).  `device` is the torch device of
    the 'cuda' space: the card when None (raising where there is none),
    or what the caller names, e.g. 'cpu'."""

    instance_count = 0

    def __init__(self, device=None, **kwargs):
        kwargs["device"] = _device.resolve_device(device)
        Pipeline.instance_count += 1
        self.pname = f"pipeline_{Pipeline.instance_count - 1}"
        super().__init__(name=self.pname, parent=None, **kwargs)
        self.blocks = []
        self.rings = []
        self._shutdown_event = threading.Event()
        self._init_queue = queue.Queue()
        self._all_initialized = threading.Event()
        self._threads = []

    def __enter__(self):
        _default_pipelines.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _default_pipelines.pop()
        return super().__exit__(*exc)

    def synchronize_block_initializations(self):
        """Barrier: every block reports init before data flows
        (reference pipeline.py:241-253)."""
        waiting = set(self.blocks)
        while waiting:
            try:
                block, ok, err = self._init_queue.get(timeout=0.25)
            except queue.Empty:
                if self._shutdown_event.is_set():
                    return
                continue
            waiting.discard(block)
            if not ok:
                self.shutdown()
                raise PipelineInitError(
                    f"block {block.name} failed to initialize: {err}")
        self._all_initialized.set()

    def run(self):
        """Run every block on its own thread until the sources end and
        the end of data has flowed through; re-raise the first block
        error."""
        self._threads = []
        for b in self.blocks:
            t = threading.Thread(target=b._run, name=b.name, daemon=True)
            b._thread = t
            self._threads.append(t)
            t.start()
        try:
            self.synchronize_block_initializations()
        finally:
            for t in self._threads:
                while t.is_alive():
                    t.join(timeout=0.25)
                    if self._shutdown_event.is_set():
                        t.join(timeout=5.0)
                        break
        errs = [b for b in self.blocks if b.error is not None]
        if errs:
            raise errs[0].error

    def shutdown(self):
        """Stop the pipeline: interrupt every ring so blocked blocks
        exit; whatever the rings buffer is abandoned."""
        self._shutdown_event.set()
        self._all_initialized.set()
        for ring in self.rings:
            ring.interrupt()

    @property
    def shutdown_requested(self):
        return self._shutdown_event.is_set()


class Block(BlockScope):
    """Base block: owns output rings and a thread
    (reference pipeline.py:329-441)."""

    instance_count = 0

    def __init__(self, irings, name=None, type_=None, **kwargs):
        self.pipeline = get_default_pipeline()
        type_ = type_ or type(self).__name__
        if name is None:
            name = f"{type_}_{Block.instance_count}"
        Block.instance_count += 1
        if kwargs.get("device") is not None:
            kwargs["device"] = _device.resolve_device(kwargs["device"])
        super().__init__(name=name, **kwargs)
        self.name = name
        self.type = type_
        self.error = None
        self._thread = None
        self._init_reported = False
        self._held_latches = []
        # Cumulative host seconds per loop phase (acquire = waiting for
        # input, reserve = waiting for output room, process = on_data up
        # to the commit-ready point, commit).  Device work is
        # asynchronous: `process` counts its enqueue, not its run.
        self.perf_totals = {}
        # Inputs may be Rings or other Blocks (their first output ring).
        self.irings = [i.orings[0] if isinstance(i, Block) else i
                       for i in irings]
        self.orings = []
        self.pipeline.blocks.append(self)

    def create_ring(self, space="system"):
        ring = Ring(space=space, name=f"{self.name}.out{len(self.orings)}",
                    device=self.device)
        ring.owner = self
        self.pipeline.rings.append(ring)
        return ring

    def mark_initialized(self, ok=True, err=None):
        if not self._init_reported:
            self._init_reported = True
            self.pipeline._init_queue.put((self, ok, err))
            if ok:
                self.pipeline._all_initialized.wait()

    def _run(self):
        try:
            _device.set_device(self.device)
            with _device.block_stream(self.device):
                self.main()
                _device.stream_synchronize(self.device)
        except (EndOfDataStop, RingInterrupted):
            pass
        except Exception as e:  # noqa: BLE001 — block errors surface in run()
            self.error = e
            self.mark_initialized(ok=False, err=e)
            self.pipeline.shutdown()
        finally:
            self._release_flag_latches()
            self.mark_initialized()   # unblock the barrier on early exit

    def main(self):
        raise NotImplementedError

    def _hold_flag_latch(self, flag):
        """Latch a config flag for the current sequence (config.py)."""
        from . import config
        config.hold_latch(flag, self.name)
        self._held_latches.append(flag)

    def _release_flag_latches(self):
        from . import config
        while self._held_latches:
            config.release_latch(self._held_latches.pop(), self.name)

    def _perf_add(self, **phases):
        for k, v in phases.items():
            self.perf_totals[k] = self.perf_totals.get(k, 0.0) + v

    def _sync_before_commit(self, ospans):
        """Host-space outputs must hold their bytes before the commit
        hands them on; device outputs ride the ring's commit event."""
        if any(os_.ring.space != "cuda" for os_ in ospans):
            _device.stream_synchronize(self.device)


def _cancel_reservations(spans):
    """Commit(0) uncommitted reservations, newest first, so a fault
    leaves no reservation that would wedge the ring's in-order commit."""
    for sp in reversed(spans):
        try:
            sp.commit(0)
        except Exception:  # noqa: BLE001 — best effort on a fault path
            pass


class SourceBlock(Block):
    """Generates sequences from external sources
    (reference pipeline.py:442-521)."""

    def __init__(self, sourcenames, gulp_nframe, space="system", name=None,
                 **kwargs):
        super().__init__(irings=[], name=name, gulp_nframe=gulp_nframe,
                         **kwargs)
        self.sourcenames = sourcenames
        self.orings = [self.create_ring(space=space)]

    # -- subclass interface
    def create_reader(self, sourcename):
        raise NotImplementedError

    def on_sequence(self, reader, sourcename):
        """-> list of output headers (dicts with `_tensor`)."""
        raise NotImplementedError

    def on_data(self, reader, ospans):
        """-> list of nframe written per output span."""
        raise NotImplementedError

    def main(self):
        self.orings[0].begin_writing()
        try:
            for sourcename in self.sourcenames:
                if self.pipeline.shutdown_requested:
                    break
                self._run_source_sequence(sourcename)
        finally:
            self.orings[0].end_writing()

    def _run_source_sequence(self, sourcename):
        with self.create_reader(sourcename) as reader:
            oheaders = self.on_sequence(reader, sourcename)
            for oh in oheaders:
                oh.setdefault("name", str(sourcename))
                oh.setdefault("time_tag", 0)
                oh.setdefault("gulp_nframe", self.gulp_nframe)
            gulp = self.gulp_nframe
            buf_nframe = self.buffer_nframe or gulp * self.buffer_factor
            oseqs = [ring.begin_sequence(oh, gulp, buf_nframe)
                     for ring, oh in zip(self.orings, oheaders)]
            self.mark_initialized()
            try:
                while not self.pipeline.shutdown_requested:
                    t0 = time.perf_counter()
                    ospans = [oseq.reserve(gulp) for oseq in oseqs]
                    try:
                        t1 = time.perf_counter()
                        ostrides = self.on_data(reader, ospans)
                        self._sync_before_commit(ospans)
                        t2 = time.perf_counter()
                        done = False
                        for ospan, n in zip(ospans, ostrides):
                            n = 0 if n is None else n
                            ospan.commit(n)
                            done = done or n < gulp
                    except BaseException:
                        _cancel_reservations(ospans)
                        raise
                    self._perf_add(reserve=t1 - t0, process=t2 - t1,
                                   commit=time.perf_counter() - t2)
                    if done:
                        break
            finally:
                for oseq in oseqs:
                    oseq.end()


class MultiTransformBlock(Block):
    """N input rings -> M output rings, the gulp hot loop
    (reference pipeline.py:523-694 — see SURVEY.md §3.3)."""

    def __init__(self, irings, guarantee=True, name=None, **kwargs):
        super().__init__(irings=irings, name=name, **kwargs)
        self.guarantee = guarantee
        nout = getattr(self, "noutputs", 1)
        self.orings = [self.create_ring(space=self._output_space())
                       for _ in range(nout)]

    # -- subclass interface
    def _on_sequence(self, iseqs):
        return self.on_sequence(iseqs)

    def _on_data(self, ispans, ospans):
        return self.on_data(ispans, ospans)

    def define_input_overlap_nframe(self, iseqs):
        """Frames of overlap carried between gulps (FDMT/FIR state)."""
        return 0

    def define_output_nframes(self, input_nframe):
        """Output frames per input gulp for each output ring."""
        return [input_nframe] * len(self.orings)

    def on_sequence(self, iseqs):
        """-> list of output headers."""
        raise NotImplementedError

    def on_sequence_end(self, iseqs):
        pass

    def on_data(self, ispans, ospans):
        """Process one gulp; return list of frames written per output
        (None -> all)."""
        raise NotImplementedError

    def on_skip(self, islice, ospans):
        """Zero-fill outputs for skipped (overwritten) input frames."""
        for ospan in ospans:
            ospan.data.zero_()

    def _output_space(self):
        """Space for created output rings: input space by default."""
        return self.irings[0].space

    def main(self):
        readers = [iring.read(guarantee=self.guarantee)
                   for iring in self.irings]
        began_writing = False
        try:
            for iseqs in zip(*readers):
                if self.pipeline.shutdown_requested:
                    break
                if not began_writing:
                    for oring in self.orings:
                        oring.begin_writing()
                    began_writing = True
                self._run_sequence(iseqs)
        finally:
            for r in readers:
                r.close()
            if began_writing:
                for oring in self.orings:
                    oring.end_writing()

    def _run_sequence(self, iseqs):
        oheaders = self._on_sequence(iseqs)
        for oh in oheaders:
            oh.setdefault("name", iseqs[0].header.get("name", ""))
            oh.setdefault("time_tag", iseqs[0].header.get("time_tag", 0))
        gulp = self.gulp_nframe or iseqs[0].header.get("gulp_nframe", 1)
        overlap = self.define_input_overlap_nframe(iseqs)
        onframes = self.define_output_nframes(gulp)
        buf_factor = self.buffer_factor
        # An overlap reader's first acquire wants gulp + overlap committed
        # frames while the writer needs room for its next gulp: two
        # windows at least.
        in_buf_factor = max(buf_factor, 2) if overlap else buf_factor
        for oh, onf in zip(oheaders, onframes):
            oh.setdefault("gulp_nframe", onf)
        for iseq in iseqs:
            # Sized from this reader's span plus overlap (bfRingResize):
            # the ghost covers the largest span, so a wrapped read stays
            # one view.
            iseq.resize(gulp + overlap, (gulp + overlap) * in_buf_factor)
        oseqs = [oring.begin_sequence(oh, onframe, onframe * buf_factor)
                 for oring, oh, onframe in
                 zip(self.orings, oheaders, onframes)]
        self.mark_initialized()
        try:
            self._sequence_loop(iseqs, oseqs, gulp, overlap, onframes)
        finally:
            # Output sequences END even on a fault: downstream readers
            # must see end-of-sequence, never a dangling hang.
            self.on_sequence_end(iseqs)
            for oseq in oseqs:
                oseq.end()
            self._release_flag_latches()

    def _sequence_loop(self, iseqs, oseqs, gulp, overlap, onframes):
        span_gens = [iseq.read(gulp + overlap, gulp) for iseq in iseqs]
        # Exact-schedule phase emitters (guaranteed readers only: the
        # schedule is relative to sequence entry).
        emit_hook = getattr(self, "output_nframes_for_gulp", None) \
            if self.guarantee else None
        rel_frame = 0
        try:
            while True:
                t_acq = time.perf_counter()
                ispans = []
                for g in span_gens:
                    try:
                        ispans.append(next(g))
                    except StopIteration:
                        return
                if self.pipeline.shutdown_requested:
                    return
                in_nframe = max(0, ispans[0].nframe - overlap)
                if in_nframe == 0:
                    return
                frac = in_nframe / gulp
                if emit_hook is not None:
                    out_nframes = [int(n) for n in
                                   emit_hook(rel_frame, in_nframe)]
                else:
                    out_nframes = [max(1, int(round(onf * frac)))
                                   if frac < 1 else onf for onf in onframes]
                ospans = []
                t0 = time.perf_counter()
                try:
                    for oseq, onf in zip(oseqs, out_nframes):
                        ospans.append(oseq.reserve(onf))
                    t1 = time.perf_counter()
                    if any(isp.nframe_skipped > 0 for isp in ispans):
                        self.on_skip(ispans, ospans)
                        ostrides = out_nframes
                    else:
                        ostrides = self._on_data(list(ispans), ospans)
                        if ostrides is None:
                            ostrides = out_nframes
                        ostrides = [o if o is not None else onf
                                    for o, onf in zip(ostrides, out_nframes)]
                        if emit_hook is not None and \
                                list(ostrides) != list(out_nframes):
                            raise RuntimeError(
                                f"{self.name}: output_nframes_for_gulp "
                                f"promised {list(out_nframes)} output "
                                f"frame(s) but on_data committed "
                                f"{list(ostrides)}")
                    self._sync_before_commit(ospans)
                    if not self.guarantee and any(
                            isp.nframe_overwritten > 0 for isp in ispans):
                        # Lossy catch-up: input overwritten while read.
                        self.on_skip(ispans, ospans)
                    t2 = time.perf_counter()
                    for ospan, n in zip(ospans, ostrides):
                        ospan.commit(n)
                except BaseException:
                    _cancel_reservations(ospans)
                    raise
                self._perf_add(acquire=t0 - t_acq, reserve=t1 - t0,
                               process=t2 - t1,
                               commit=time.perf_counter() - t2)
                rel_frame += gulp
                if ispans[0].nframe < gulp + overlap:
                    return   # partial gulp == sequence end
        finally:
            for g in span_gens:
                g.close()


class TransformBlock(MultiTransformBlock):
    """One input ring -> one output ring (reference pipeline.py:696-748).
    Subclasses define `on_sequence(iseq)` -> header and
    `on_data(ispan, ospan)`."""

    noutputs = 1

    def __init__(self, iring, *args, **kwargs):
        super().__init__([iring], *args, **kwargs)
        self.iring = self.irings[0]

    def _on_sequence(self, iseqs):
        oh = self.on_sequence(iseqs[0])
        return oh if isinstance(oh, list) else [oh]

    def on_sequence(self, iseq):
        raise NotImplementedError

    def _on_data(self, ispans, ospans):
        return [self.on_data(ispans[0], ospans[0])]

    def on_data(self, ispan, ospan):
        raise NotImplementedError


class SinkBlock(MultiTransformBlock):
    """One input ring, no outputs (reference pipeline.py:750-785).
    Subclasses define `on_sequence(iseq)` and `on_data(ispan)`."""

    noutputs = 0

    def __init__(self, iring, *args, **kwargs):
        super().__init__([iring], *args, **kwargs)
        self.iring = self.irings[0]

    def define_output_nframes(self, input_nframe):
        return []

    def _on_sequence(self, iseqs):
        self.on_sequence(iseqs[0])
        return []

    def on_sequence(self, iseq):
        raise NotImplementedError

    def _on_data(self, ispans, ospans):
        self.on_data(ispans[0])
        return []

    def on_data(self, ispan):
        raise NotImplementedError


# -------------------------------------------------------------------- views
class RingView(object):
    """Zero-copy header-transform view over a ring (counterpart of
    bifrost_tpu/pipeline.py:2138-2169): readers see each sequence's
    header rewritten by `header_transform`; the bytes are the ring's."""

    def __init__(self, base_ring, header_transform):
        self._parent = base_ring if isinstance(base_ring, RingView) else None
        self.base_ring = getattr(base_ring, "base_ring", base_ring)
        self.header_transform = header_transform
        self.owner = getattr(base_ring, "owner", None)
        self.name = f"{self.base_ring.name}.view"

    @property
    def space(self):
        return self.base_ring.space

    def transform_header(self, header):
        """The header a reader of this view sees (parent views first)."""
        if self._parent is not None:
            header = self._parent.transform_header(header)
        hdr = json.loads(json.dumps(header))    # deep copy
        out = self.header_transform(hdr)
        return hdr if out is None else out

    def read(self, guarantee=True):
        for iseq in self.base_ring.read(guarantee):
            yield SequenceView(iseq, self.transform_header(iseq.header))


class SequenceView(ReadSequence):
    """A ReadSequence with a rewritten header (counterpart of
    bifrost_tpu/pipeline.py:2171-2242): frame-unit math follows the new
    header's tensor info; guarantees, open spans and closing are the base
    sequence's (byte offsets are the same under any view)."""

    def __init__(self, base, header):
        self.base = base
        self.ring = base.ring
        self._seq = base._seq
        self.guarantee = base.guarantee
        self.name = header.get("name", base.name)
        self.time_tag = header.get("time_tag", base.time_tag)
        self.begin = base.begin
        self.header = header
        self.tensor = TensorInfo(header) if "_tensor" in header else None

    @property
    def _closed(self):
        return self.base._closed

    @property
    def _open_spans(self):
        return self.base._open_spans

    def close(self):
        self.base.close()

    def _acquire(self, offset, size, nonblocking):
        return self.base._acquire(offset, size, nonblocking)


def block_view(block, header_transform):
    """Wrap a block so that its output rings present transformed headers
    (counterpart of bifrost_tpu/pipeline.py:2245-2251)."""
    proxy = _copy.copy(block)
    proxy.orings = [RingView(r, header_transform) for r in block.orings]
    return proxy
