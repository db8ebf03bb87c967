"""PSRDADA-compatible streaming (counterpart of bifrost_tpu/blocks/
psrdada.py; reference python/bifrost/psrdada.py and blocks/psrdada.py,
which bind the external PSRDADA library).

- `parse_dada_header` / `serialize_dada_header`: the DADA ASCII "KEY value"
  format, cast as the reference casts it.
- `dada_shm_send(iring, name)`: the shm sink with each sequence's header
  also carried as DADA ASCII (under '__dada__').
- `dada_ipc_send(iring, key)`: a sink into a PSRDADA-style SysV HDU
  (io/dada_ipc.py), the ABI a site's `dada_dbdisk`-style consumer reads:
  one transfer a sequence, the DADA header (with the `_tensor` as
  TENSOR_JSON) on the header ring, gulps landing in the data ring's
  buffers through the egress plane.  A stream with ringlets goes on frame
  by frame (egress.py, wire order), the time-ordered samples a DADA
  consumer expects, and TENSOR_JSON gives its frame axis first.
- `read_psrdada_buffer(name, header_callback, gulp_nframe)`: a source with
  the reference's signature over the shm ring: `header_callback` gets the
  parsed DADA dict and returns the `_tensor` header, whose frame axis is
  first (DADA data is time-ordered; a ringlet header is refused).

A site's existing DADA producer (dada_db and a writer) reaches a pipeline
through the bridge process, ``python -m bifrost_tpu_torch.dada_bridge``,
which attaches to the HDU and forwards each transfer into a shm ring with
the header translated (docs/dada-migration.md).
"""

from __future__ import annotations

import json
import warnings

import numpy as np

from ..egress import DeviceSinkBlock, EgressDest
from .shmring import ShmReceiveBlock, ShmSendBlock

__all__ = ["parse_dada_header", "serialize_dada_header",
           "DadaShmSendBlock", "dada_shm_send",
           "DadaIpcSinkBlock", "dada_ipc_send",
           "PsrDadaSourceBlock", "read_psrdada_buffer"]


def _cast(value):
    for conv in (int, float):
        try:
            return conv(value)
        except ValueError:
            pass
    return value


def parse_dada_header(headerstr, cast_types=True):
    """DADA ASCII 'KEY value' lines -> dict, stopping at a NUL or at the
    first malformed line; values cast to int, else float, else str."""
    nul = headerstr.find("\0")
    if nul >= 0:
        headerstr = headerstr[:nul]
    header = {}
    for line in headerstr.split("\n"):
        parts = line.split(None, 1)
        if len(parts) != 2:
            if line.strip():
                break
            continue
        key, value = parts[0].strip(), parts[1].strip()
        header[key] = _cast(value) if cast_types else value
    return header


def serialize_dada_header(header):
    """dict -> DADA ASCII (upper-case keys, one 'KEY value' a line; private
    and structured entries left out)."""
    lines = []
    for key, value in header.items():
        if key.startswith("_") or isinstance(value, (dict, list)):
            continue
        lines.append(f"{str(key).upper()} {value}")
    return "\n".join(lines) + "\n"


class DadaShmSendBlock(ShmSendBlock):
    """The shm sink with each sequence's header also as DADA ASCII (under
    '__dada__'), for consumers of the DADA header format; native readers
    keep the structured header."""

    def on_sink_sequence(self, iseq):
        hdr = dict(iseq.header)
        hdr["__dada__"] = serialize_dada_header(hdr)
        seq = type("Seq", (), {"header": hdr})()
        return super().on_sink_sequence(seq)


def dada_shm_send(iring, name, *args, **kwargs):
    return DadaShmSendBlock(iring, name, *args, **kwargs)


class _DadaBufDest(EgressDest):
    """Egress destination over a SysV DADA data ring: staged chunks land in
    the ring's buffers (`open_write_buf` views), each buffer committed with
    `mark_filled` as it fills.  A chunk across a buffer boundary takes the
    `write()` copy; a gulp's last, partial buffer is committed short."""

    def __init__(self, ring, timeout):
        self._ring = ring
        self._timeout = timeout
        self._buf = None
        self._fill = 0

    def _open(self):
        got = self._ring.open_write_buf(self._timeout)
        if got is None:
            raise TimeoutError(
                f"DADA ring key 0x{self._ring.key:x}: no CLEAR buffer "
                f"within {self._timeout}s (consumer stalled?)")
        buf, _idx = got
        self._buf = np.frombuffer(buf, dtype=np.uint8)
        self._fill = 0

    def chunk_view(self, nbyte):
        if self._buf is None:
            self._open()
        if self._fill + nbyte <= self._buf.nbytes:
            return self._buf[self._fill:self._fill + nbyte]
        return None

    def advance(self, nbyte):
        self._fill += nbyte
        if self._fill == self._buf.nbytes:
            self._ring.mark_filled(self._fill)
            self._buf = None

    def write(self, flat_u8):
        done = 0
        total = flat_u8.nbytes
        while done < total:
            if self._buf is None:
                self._open()
            n = min(total - done, self._buf.nbytes - self._fill)
            np.copyto(self._buf[self._fill:self._fill + n],
                      flat_u8[done:done + n])
            self._fill += n
            done += n
            if self._fill == self._buf.nbytes:
                self._ring.mark_filled(self._fill)
                self._buf = None

    def commit(self):
        if self._buf is not None and self._fill:
            self._ring.mark_filled(self._fill)
            self._buf = None


class DadaIpcSinkBlock(DeviceSinkBlock):
    """Sink: stream a ring into a PSRDADA-style SysV HDU (io/dada_ipc.py)
    for external DADA consumers.  Each pipeline sequence is one DADA
    transfer: the header ring carries the DADA ASCII header plus the JSON
    `_tensor` under TENSOR_JSON, `start_of_data`/`end_of_data` bracket the
    data, and each gulp lands in the data ring's buffers.

    `key`: the HDU's SysV key; `nbufs` x `bufsz` (None: one gulp a
    buffer) its data buffers; `create`: make the segments (the `dada_db`
    role) and remove them at the end; `write_timeout`: seconds a buffer
    may stay FULL before the sink raises."""

    wire_frame_major = True

    def __init__(self, iring, key, nbufs=8, bufsz=None, create=True,
                 write_timeout=30.0, *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        self._key = int(key)
        self._nbufs = int(nbufs)
        self._bufsz = bufsz
        self._create = bool(create)
        self._write_timeout = float(write_timeout)
        self._hdu = None
        self._xfer_open = False

    def _ensure_hdu(self, gulp_nbyte):
        from ..io import dada_ipc
        if self._hdu is not None:
            return
        bufsz = self._bufsz
        if bufsz is None:
            bufsz = max(1, int(gulp_nbyte))
        self._hdu = dada_ipc.DadaHDU(self._key, nbufs=self._nbufs,
                                     bufsz=bufsz, create=self._create)

    def on_sink_sequence(self, iseq):
        hdr = dict(self.wire_header(iseq.header))
        t = getattr(iseq, "tensor", None)
        gulp = hdr.get("gulp_nframe", 1)
        gulp_nbyte = t.host_span_nbyte(gulp) if t is not None else 1
        self._ensure_hdu(gulp_nbyte)
        if self._xfer_open:
            self._hdu.data.end_of_data()
        dada = serialize_dada_header(hdr)
        dada += f"TENSOR_JSON {json.dumps(hdr.get('_tensor', {}))}\n"
        self._hdu.write_header(dada)
        self._hdu.data.start_of_data()
        self._xfer_open = True

    def open_dest(self, nbyte, nframe, frame_offset):
        return _DadaBufDest(self._hdu.data, self._write_timeout)

    def on_sink_data(self, arr, frame_offset):
        # The blocking path (host rings, egress_staging off).
        dest = _DadaBufDest(self._hdu.data, self._write_timeout)
        dest.write(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
        dest.commit()

    def on_sink_sequence_end(self, iseq):
        if self._xfer_open:
            self._hdu.data.end_of_data()
            self._xfer_open = False

    def on_shutdown(self):
        """Pipeline shutdown: wake a writer blocked on a CLEAR wait behind
        a stalled consumer, on the data ring and the header ring."""
        if self._hdu is not None:
            self._hdu.data.interrupt()
            self._hdu.header.interrupt()

    def shutdown(self):
        super().shutdown()   # drain and close the stager first
        if self._hdu is not None:
            try:
                if self._xfer_open:
                    self._xfer_open = False
                    self._hdu.data.end_of_data()
                # The segments this sink made go once the reader is done
                # (the JAX sink removes them under a reader still reading).
                if self._create and not self._hdu.data.wait_drained(
                        self._write_timeout):
                    warnings.warn(
                        f"DADA ring key 0x{self._key:x}: the reader has "
                        f"not read every transfer within "
                        f"{self._write_timeout} s; removing the segments")
            finally:
                self._hdu.close()
                self._hdu = None


def dada_ipc_send(iring, key, nbufs=8, bufsz=None, create=True,
                  *args, **kwargs):
    """Stream a ring into a PSRDADA-style SysV HDU for external DADA
    consumers (see DadaIpcSinkBlock)."""
    return DadaIpcSinkBlock(iring, key, nbufs, bufsz, create,
                            *args, **kwargs)


class PsrDadaSourceBlock(ShmReceiveBlock):
    """Source with the reference block's signature,
    read_psrdada_buffer(name, header_callback, gulp_nframe):
    `header_callback(dada_dict)` -> the pipeline header, over the shm
    ring."""

    def __init__(self, name, header_callback, gulp_nframe,
                 *args, **kwargs):
        super().__init__(name, gulp_nframe, *args, **kwargs)
        self.header_callback = header_callback

    def on_sequence(self, reader, name):
        raw_header, time_tag = reader.read_sequence()
        dada = parse_dada_header(raw_header.get("__dada__", ""))
        if not dada:
            # A producer that sent no ASCII header: its flat entries are
            # the DADA dict.
            dada = {k: v for k, v in raw_header.items()
                    if not k.startswith("_") and
                    not isinstance(v, (dict, list))}
        ohdr = self.header_callback(dada)
        ohdr.setdefault("time_tag", time_tag)
        ohdr.setdefault("name", self._shm_name)
        self._set_frame_geometry(ohdr)
        return [ohdr]


def read_psrdada_buffer(name, header_callback, gulp_nframe,
                        *args, **kwargs):
    """Source a pipeline from a DADA-header shm stream (the reference's
    signature)."""
    return PsrDadaSourceBlock(name, header_callback, gulp_nframe,
                              *args, **kwargs)
