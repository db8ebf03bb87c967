"""SIGPROC filterbank format codec
(reference: python/bifrost/sigproc.py (415 LoC) + sigproc2.py (409 LoC) —
header keyword table, 1-32 bit sample packing, telescope/machine id maps).

Format: binary header of keyword records — each ``<i4 len><name>`` followed
by a typed value — bracketed by HEADER_START/HEADER_END, then raw
time-major sample data (ntime, nifs, nchans) at nbits per sample.

The port's own copy of bifrost_tpu/io/sigproc.py (numpy only, kept
verbatim so that both packages read and write the same bytes).
"""

from __future__ import annotations

import struct

import numpy as np

# keyword -> value type ('i'=int32, 'd'=float64, 's'=string, 'b'=flag/int)
_HEADER_KEYS = {
    "telescope_id": "i", "machine_id": "i", "data_type": "i",
    "rawdatafile": "s", "source_name": "s", "barycentric": "i",
    "pulsarcentric": "i", "topocentric": "i",
    "az_start": "d", "za_start": "d", "src_raj": "d", "src_dej": "d",
    "tstart": "d", "tsamp": "d", "nbits": "i", "nsamples": "i",
    "fch1": "d", "foff": "d", "nchans": "i", "nifs": "i",
    "refdm": "d", "period": "d", "npuls": "q", "nbins": "i",
    "ibeam": "i", "nbeams": "i", "signed": "b",
}

_TELESCOPES = {
    0: "Fake", 1: "Arecibo", 2: "Ooty", 3: "Nancay", 4: "Parkes", 5: "Jodrell",
    6: "GBT", 7: "GMRT", 8: "Effelsberg", 9: "ATA", 10: "SRT", 11: "LOFAR",
    12: "VLA", 52: "LWA-OV", 53: "LWA-SV", 64: "MeerKAT", 65: "KAT-7",
}
_MACHINES = {
    0: "FAKE", 1: "PSPM", 2: "WAPP", 3: "OOTY", 4: "AOFTM", 5: "FFB",
    6: "SCAMP", 7: "GBT Pulsar Spigot", 11: "BG/P", 12: "PDEV",
    20: "GUPPI", 52: "LWA-DP", 53: "LWA-ADP",
}


def id2telescope(tid):
    return _TELESCOPES.get(tid, f"unknown({tid})") if tid is not None else None


def telescope2id(name):
    for k, v in _TELESCOPES.items():
        if v == name:
            return k
    return 0


def id2machine(mid):
    return _MACHINES.get(mid, f"unknown({mid})") if mid is not None else None


def machine2id(name):
    for k, v in _MACHINES.items():
        if v == name:
            return k
    return 0


def _write_string(f, s):
    b = s.encode()
    f.write(struct.pack("<i", len(b)) + b)


def write_header(f, hdr):
    """Write a SIGPROC header dict to a binary stream."""
    _write_string(f, "HEADER_START")
    for key, val in hdr.items():
        if key not in _HEADER_KEYS or val is None:
            continue
        typ = _HEADER_KEYS[key]
        _write_string(f, key)
        if typ == "i" or typ == "b":
            f.write(struct.pack("<i", int(val)))
        elif typ == "q":
            f.write(struct.pack("<q", int(val)))
        elif typ == "d":
            f.write(struct.pack("<d", float(val)))
        elif typ == "s":
            _write_string(f, str(val))
    _write_string(f, "HEADER_END")


def read_header(f):
    """Read a SIGPROC header from a binary stream -> (dict, data_offset)."""
    start = f.read(4)
    if len(start) < 4:
        raise EOFError("empty file")
    (n,) = struct.unpack("<i", start)
    if f.read(n) != b"HEADER_START":
        raise ValueError("not a SIGPROC file (missing HEADER_START)")
    hdr = {}
    while True:
        (n,) = struct.unpack("<i", f.read(4))
        key = f.read(n).decode()
        if key == "HEADER_END":
            break
        typ = _HEADER_KEYS.get(key)
        if typ in ("i", "b"):
            (hdr[key],) = struct.unpack("<i", f.read(4))
        elif typ == "q":
            (hdr[key],) = struct.unpack("<q", f.read(8))
        elif typ == "d":
            (hdr[key],) = struct.unpack("<d", f.read(8))
        elif typ == "s":
            (m,) = struct.unpack("<i", f.read(4))
            hdr[key] = f.read(m).decode()
        else:
            raise ValueError(f"unknown SIGPROC header key: {key!r}")
    return hdr, f.tell()


def _np_dtype(nbits, signed):
    if nbits == 32:
        return np.float32  # SIGPROC convention: 32-bit is float
    if nbits == 16:
        return np.int16 if signed else np.uint16
    return np.int8 if signed else np.uint8


class SigprocFile(object):
    """Frame-oriented reader (reference sigproc2.SigprocFile)."""

    def __init__(self, filename):
        self.f = open(filename, "rb")
        self.header, self.data_offset = read_header(self.f)
        self.nchans = self.header["nchans"]
        self.nifs = self.header.get("nifs", 1)
        self.nbits = self.header["nbits"]
        # SIGPROC data is unsigned unless the (LWA extension) 'signed' flag
        # says otherwise (reference sigproc.py header table).
        self.signed = bool(self.header.get("signed", False))
        vals_per_frame = self.nifs * self.nchans
        self.frame_nbit = vals_per_frame * self.nbits
        if self.frame_nbit % 8:
            raise ValueError("frame size is not byte-aligned")
        self.frame_nbyte = self.frame_nbit // 8

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self.f.close()

    @property
    def nframe(self):
        import os
        size = os.fstat(self.f.fileno()).st_size - self.data_offset
        return size // self.frame_nbyte

    def read(self, nframe, unpack=True):
        """Read nframe frames -> (nframe_read, nifs, nchans) array.

        Sub-byte data is unpacked to 8-bit when `unpack` (MSB-first, matching
        reference sigproc.py:249-299 unpack loops).
        """
        raw = np.frombuffer(self.f.read(nframe * self.frame_nbyte),
                            dtype=np.uint8)
        nf = len(raw) // self.frame_nbyte
        raw = raw[:nf * self.frame_nbyte].reshape(nf, self.frame_nbyte)
        if self.nbits >= 8:
            dt = _np_dtype(self.nbits, self.signed)
            data = raw.view(dt).reshape(nf, self.nifs, self.nchans)
            return data
        if not unpack:
            return raw.reshape(nf, self.nifs, -1)
        vals_per_byte = 8 // self.nbits
        shifts = np.arange(vals_per_byte - 1, -1, -1, dtype=np.uint8) * \
            self.nbits
        fields = (raw[..., None] >> shifts) & ((1 << self.nbits) - 1)
        data = fields.reshape(nf, self.nifs, self.nchans)
        if self.signed:
            data = (data.astype(np.uint8) << (8 - self.nbits)) \
                .astype(np.int8) >> (8 - self.nbits)
        return data

    def readinto(self, buf):
        return self.f.readinto(buf)
