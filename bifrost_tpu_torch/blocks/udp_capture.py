"""UDP capture block: the native packet -> ring engine as a supervised
pipeline source (counterpart of bifrost_tpu/blocks/udp_capture.py).

The engine writes the output ring itself (two reorder-window spans,
sequence begin/end on packet-sequence changes), so this block has no
reserve/on_data gulp loop: its `main` drives `UDPCapture.recv()` windows
and owns the lifecycle seams.

- Pre-sized ring: the engine keeps its two window spans open for good,
  and `Ring.resize` waits until no span is open, so a reader that needs a
  larger contiguous region than the engine's window would wedge a later
  resize.  `main` sizes the ring for `reader_gulp_nframe` before the
  engine opens its spans.
- Initialisation is reported without waiting on the barrier: the
  downstream blocks initialise only once the first packet sequence
  exists, which needs this thread to pump recv windows.
- Bounded quiesce (`Pipeline.shutdown(timeout=)`): the loop stops at the
  next recv-window edge and ends the capture; downstream drains on a
  normal end of stream.
- Supervised restart: a capture fault (header callback error, a ring
  wait interrupted by its own deadman, an injected fault) ends ONLY the
  current packet sequence; downstream keeps its reader and picks up the
  fresh sequence the engine begins at the next packet
  (`_restart_semantics = "reader_rebuild"`).  A failed sequence end is
  itself a counted fault, retried under the budget.
- Fault injection: `_udp_fault_hook` fires the sites `udp.recv` (before
  each recv call) and `capture.packet` (once for each slot window the
  call committed).  The JAX block fires `capture.packet` once per recv
  call that landed data, a count that depends on how the socket batched
  the packets; a count of slot windows is a position in the stream, so
  a fault armed at its nth firing lands at the same frames run to run.
- Packet-loss telemetry: the engine's per-sequence stats push
  (`stats_name=`) plus a throttled flush in the loop, so `Service.health()`
  and `proclog.capture_metrics` see ngood/nmissing/ninvalid/nlate/nrepeat.
- `on_shutdown` shuts the socket, unblocking a thread parked in recv.

The block's long waits are the socket recv (bounded by the socket
timeout: set one, it is also the quiesce latency) and the engine's ring
reserve under back-pressure (interrupt-aware).
"""

from __future__ import annotations

import time

from .. import config
from ..pipeline import Block
from ..udp import UDPCapture

__all__ = ["UDPCaptureBlock", "udp_capture"]


class UDPCaptureBlock(Block):
    """Run the UDP capture engine as a supervised pipeline source.

    Parameters mirror `udp.UDPCapture`; `header_callback(seq0)` returns
    `(time_tag, header_dict)`, the header carrying the `_tensor` layout of
    one captured time frame (nsrc * max_payload_size bytes).  The output
    ring is in the 'system' space (the engine writes host memory).
    """

    _restart_semantics = "reader_rebuild"

    def __init__(self, fmt, sock, nsrc, src0, max_payload_size,
                 buffer_ntime, slot_ntime, header_callback=None,
                 space="system", name=None, reader_gulp_nframe=None,
                 batch_npkt=None, core=None, **kwargs):
        super().__init__(irings=[], name=name, core=core, **kwargs)
        self.reader_gulp_nframe = int(reader_gulp_nframe) \
            if reader_gulp_nframe is not None else 4 * int(slot_ntime)
        self.fmt = str(fmt)
        self.sock = sock
        self.nsrc = int(nsrc)
        self.src0 = int(src0)
        self.max_payload_size = int(max_payload_size)
        self.buffer_ntime = int(buffer_ntime)
        self.slot_ntime = int(slot_ntime)
        self.header_callback = header_callback
        # recvmmsg depth: the argument, else the `capture_batch_npkt` flag
        # read when main() builds the engine.
        self.batch_npkt = int(batch_npkt) if batch_npkt is not None else None
        self.capture = None
        self.final_stats = None       # the counters at the engine's end
        self.nrestart_sequences = 0   # sequences ended by restarts
        self._udp_fault_hook = None   # faultinject seam (udp.recv, ...)
        self._stats_flush_t = 0.0
        self.orings = [self.create_ring(space=space)]

    def _wrapped_header_callback(self):
        user_cb = self.header_callback
        slot = self.slot_ntime

        def cb(seq0):
            if user_cb is None:
                time_tag, hdr = int(seq0), {}
            else:
                time_tag, hdr = user_cb(seq0)
            hdr = dict(hdr)
            hdr.setdefault("name", self.name)
            hdr.setdefault("time_tag", int(time_tag))
            # The engine publishes whole slot windows: a slot-multiple
            # gulp avoids partial reads downstream.
            hdr.setdefault("gulp_nframe", slot)
            return time_tag, hdr

        return cb

    def main(self):
        frame_nbyte = self.nsrc * self.max_payload_size
        contig_nframe = max(self.slot_ntime, self.reader_gulp_nframe)
        total_nframe = max(self.buffer_ntime, 4 * contig_nframe)
        self.orings[0].resize(contig_nframe * frame_nbyte,
                              total_nframe * frame_nbyte)
        self.capture = UDPCapture(
            self.fmt, self.sock, self.orings[0], self.nsrc, self.src0,
            self.max_payload_size, self.buffer_ntime, self.slot_ntime,
            header_callback=self._wrapped_header_callback(),
            core=self.core if self.core is not None else -1,
            batch_npkt=self.batch_npkt if self.batch_npkt is not None
            else config.get("capture_batch_npkt"),
            stats_name=f"udp_capture_{self.orings[0].name}")
        # Initialised, without the barrier (module docstring).
        self._init_reported = True
        self.pipeline._init_queue.put((self, True, None))
        try:
            while not (self.pipeline.shutdown_requested or
                       self.pipeline.quiesce_requested):
                self._supervised_region = True
                try:
                    self._capture_loop()
                    break
                except BaseException as e:  # noqa: BLE001 — policy decides
                    if self.pipeline.shutdown_requested or \
                            self._supervised_resume(e) is None:
                        raise
                    # A counted restart ends only the current packet
                    # sequence.  The recv loop resumes only once that
                    # teardown completed: a half-torn sequence would
                    # scatter the next packets through stale span state.
                    self.nrestart_sequences += 1
                    while True:
                        try:
                            self.capture.end_sequence()
                            break
                        except BaseException as e2:  # noqa: BLE001
                            if self.pipeline.shutdown_requested:
                                return  # teardown truncates consistently
                            if self._supervised_resume(e2) is None:
                                raise
                finally:
                    self._supervised_region = False
        finally:
            cap, self.capture = self.capture, None
            try:
                cap.end()       # end of data: downstream drains and exits
            except Exception:  # noqa: BLE001 — close() truncates instead
                pass
            finally:
                self.final_stats = cap.stats
                cap.close()

    def _capture_loop(self):
        self._loop_frame = 0
        self._loop_gulp = None
        cap = self.capture
        nwindow = cap.nwindow
        while not (self.pipeline.shutdown_requested or
                   self.pipeline.quiesce_requested):
            self._heartbeat = time.monotonic()
            hook = self._udp_fault_hook
            if hook is not None:
                hook("udp.recv", self)
            try:
                status = cap.recv()
            except Exception:
                if self.pipeline.shutdown_requested:
                    return  # socket or ring torn down under us
                raise
            if status == 3:
                continue    # socket timeout: the loop re-checks
            committed, nwindow = cap.nwindow - nwindow, cap.nwindow
            if hook is not None:
                for _ in range(committed):
                    hook("capture.packet", self)
            sup = self._supervisor
            if sup is not None:
                sup.note_progress(self)
            now = time.monotonic()
            if now - self._stats_flush_t > 0.25:
                self._stats_flush_t = now
                cap.publish_stats()

    def on_shutdown(self):
        """Unblock a capture thread parked in the socket recv (the ring
        waits are interrupt-aware already)."""
        try:
            self.sock.shutdown()
        except Exception:  # noqa: BLE001 — best effort on shutdown
            pass

    @property
    def stats(self):
        """Live packet counters, or None between engine lifetimes (the
        last engine's final counters are `final_stats`)."""
        cap = self.capture
        if cap is None:
            return None
        try:
            return cap.stats
        except Exception:  # noqa: BLE001 — engine torn down already
            return None


def udp_capture(fmt, sock, nsrc, src0, max_payload_size, buffer_ntime,
                slot_ntime, header_callback=None, *args, **kwargs):
    """Capture UDP packets into a pipeline ring with the native engine
    (formats 'simple' | 'chips'; see udp.UDPCapture)."""
    return UDPCaptureBlock(fmt, sock, nsrc, src0, max_payload_size,
                           buffer_ntime, slot_ntime, header_callback,
                           *args, **kwargs)
