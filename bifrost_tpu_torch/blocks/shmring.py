"""Cross-process pipeline blocks over the named shm ring (counterpart of
bifrost_tpu/blocks/shmring.py).

`shm_send(iring, name)` streams a pipeline's sequences, headers intact,
into a named shared-memory ring; `shm_receive(name, gulp_nframe)` sources
them in another process, of this package or of the JAX package: the ring
is one segment layout for both (shmring.py).

The sink is a `DeviceSinkBlock` (egress.py): a 'cuda' ring's gulps are
staged on the sink's egress worker and land in the shared segment through
the ring's write spans (`reserve_view`/`commit_view`) from the egress
plane's pinned staging buffers; a wrap takes the `write()` copy.

Wire order: a stream whose frame axis is not first (ringlets, as the
FDMT's (dispersion, time) output) goes on the ring frame by frame
(`wire_frame_major`), one frame holding every ringlet's sample, and the
header it sends has its `_tensor` frame axis first (`wire_header`), so
any reader sees the bytes as they are: the receiver sources a (time,
dispersion) stream.  The JAX sink sends such a stream gulp by gulp,
ringlet-major under the ringlet header, bytes that depend on its gulp
sizes: the receiver refuses a header whose frame axis is not first.  A
stream whose frame axis is first is byte-identical from both sinks.
"""

from __future__ import annotations

import contextlib

import numpy as np

from ..DataType import DataType
from ..egress import DeviceSinkBlock, EgressDest
from ..pipeline import SourceBlock
from ..shmring import ShmRingReader, ShmRingWriter

__all__ = ["ShmSendBlock", "shm_send", "ShmReceiveBlock", "shm_receive"]


class _ShmSpanDest(EgressDest):
    """Egress destination over the shm ring's write spans: a staged chunk
    lands in the shared segment (`reserve_view`, `commit_view`), a short
    run (the capacity wrap, partial space) takes `write()`, which loops
    over sub-runs.  Back-pressure blocks in the engine's reserve wait,
    which `ShmRingWriter.interrupt()` (the block's `on_shutdown`) wakes."""

    def __init__(self, writer):
        self._writer = writer

    def chunk_view(self, nbyte):
        view = self._writer.reserve_view(nbyte)
        if view.nbytes == nbyte:
            return view
        # Declined: reserve does not move the head, so an uncommitted
        # reservation costs nothing.
        return None

    def advance(self, nbyte):
        self._writer.commit_view(nbyte)

    def write(self, flat_u8):
        done = 0
        total = flat_u8.nbytes
        while done < total:
            view = self._writer.reserve_view(total - done)
            n = view.nbytes
            np.copyto(view, flat_u8[done:done + n])
            self._writer.commit_view(n)
            done += n


class ShmSendBlock(DeviceSinkBlock):
    """Sink: stream every gulp of the input ring into a named shm ring.

    `data_capacity`: the segment's data bytes (a ring smaller than a gulp
    carries it through the wrap); `min_readers` > 0 waits, up to
    `reader_timeout` s, for that many readers before the first sequence;
    `unlink_on_exit` removes the name when the block ends (attached
    readers keep their mapping and drain)."""

    wire_frame_major = True

    def __init__(self, iring, name, data_capacity=1 << 24, min_readers=0,
                 reader_timeout=30.0, unlink_on_exit=True, *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        self._shm_name = name
        self._capacity = data_capacity
        self._min_readers = min_readers
        self._reader_timeout = reader_timeout
        self._unlink_on_exit = unlink_on_exit
        self._writer = None
        self._seq_open = False

    def on_sink_sequence(self, iseq):
        if self._writer is None:
            self._writer = ShmRingWriter(self._shm_name,
                                         data_capacity=self._capacity)
            if self._min_readers:
                self._writer.wait_for_readers(self._min_readers,
                                              self._reader_timeout)
        if self._seq_open:
            self._writer.end_sequence()
        self._writer.begin_sequence(self.wire_header(iseq.header))
        self._seq_open = True

    def open_dest(self, nbyte, nframe, frame_offset):
        return _ShmSpanDest(self._writer)

    def on_sink_data(self, arr, frame_offset):
        # The blocking path (host rings, egress_staging off).
        self._writer.write(np.asarray(arr))

    def on_sink_sequence_end(self, iseq):
        if self._seq_open:
            self._writer.end_sequence()
            self._seq_open = False

    def on_shutdown(self):
        """Pipeline shutdown: wake a writer stalled on back-pressure (the
        blocking `write` and the worker's `reserve_view` share the
        engine's interrupt check)."""
        if self._writer is not None:
            self._writer.interrupt()

    def shutdown(self, unlink=None):
        """End writing and release the segment.  Runs when the block
        thread exits, so the remote reader always sees the end of data;
        `unlink` defaults to `unlink_on_exit`."""
        if unlink is None:
            unlink = self._unlink_on_exit
        super().shutdown()   # drain and close the stager first
        if self._writer is not None:
            try:
                if self._seq_open:
                    self._writer.end_sequence()
                    self._seq_open = False
                self._writer.end_writing()
            finally:
                self._writer.close(unlink=unlink)
                self._writer = None

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class ShmReceiveBlock(SourceBlock):
    """Source: read sequences from a named shm ring into the pipeline,
    one pipeline sequence for each shm sequence, until the writer ends
    writing."""

    def __init__(self, name, gulp_nframe=1, *args, **kwargs):
        def names():
            while True:
                yield name
        super().__init__(names(), gulp_nframe, *args, **kwargs)
        self._shm_name = name
        self._reader = None

    def create_reader(self, name):
        @contextlib.contextmanager
        def reader():
            if self._reader is None:
                self._reader = ShmRingReader(self._shm_name)
            yield self._reader
        return reader()

    def main(self):
        try:
            super().main()
        finally:
            if self._reader is not None:
                self._reader.close()
                self._reader = None

    def on_shutdown(self):
        """Pipeline shutdown: wake the thread blocked in the shm ring, so
        that it exits and frees its reader slot (a leaked slot would
        back-pressure the remote writer for good)."""
        r = self._reader
        if r is not None:
            r.interrupt()

    def _set_frame_geometry(self, header):
        """Record the wire frame's bytes (every axis but the frame axis)
        from a `_tensor` header, refusing a header whose frame axis is not
        first, and empty and sub-byte frames."""
        shape = header["_tensor"]["shape"]
        if shape.index(-1) != 0:
            raise ValueError(
                f"shm ring stream {self._shm_name!r} has its frame axis at "
                f"position {shape.index(-1)} of {shape}: its bytes are the "
                f"writer's gulps ringlet by ringlet (the JAX package's "
                f"shm_send), which depend on the writer's gulp size; send "
                f"it frame-major (this package's shm_send does) or with "
                f"the frame axis first")
        frame_nbit = DataType(header["_tensor"]["dtype"]).itemsize_bits
        for dim in header["_tensor"]["shape"]:
            if dim != -1:
                frame_nbit *= dim
        if frame_nbit == 0:
            raise ValueError(
                f"shm ring frame is empty (zero-size axis in "
                f"{header['_tensor']['shape']}): cannot gulp a "
                f"zero-byte frame")
        if frame_nbit % 8:
            raise ValueError(
                f"shm ring frame is {frame_nbit} bits: sub-byte frames "
                f"(e.g. i4/ci4 with odd element counts) are unsupported "
                f"over the shm transport; pad or repack to a byte multiple")
        self._frame_nbyte = frame_nbit // 8

    def on_sequence(self, reader, name):
        # EndOfDataStop once the writer has ended writing ends the block.
        header, time_tag = reader.read_sequence()
        header.setdefault("time_tag", time_tag)
        header.setdefault("name", self._shm_name)
        self._set_frame_geometry(header)
        return [header]

    def on_data(self, reader, ospans):
        nbyte = reader.readinto(ospans[0].data.numpy())
        if nbyte % self._frame_nbyte:
            raise IOError(f"shm ring delivered a partial frame "
                          f"({nbyte} B, frame={self._frame_nbyte} B)")
        return [nbyte // self._frame_nbyte]


def shm_send(iring, name, data_capacity=1 << 24, min_readers=0,
             *args, **kwargs):
    """Stream a ring into the named cross-process shm ring.  min_readers >
    0 waits for that many readers before the first sequence (every frame
    delivered); 0 free-runs."""
    return ShmSendBlock(iring, name, data_capacity, min_readers,
                        *args, **kwargs)


def shm_receive(name, gulp_nframe=1, *args, **kwargs):
    """Source a pipeline from the named cross-process shm ring."""
    return ShmReceiveBlock(name, gulp_nframe, *args, **kwargs)
