"""GUPPI RAW format header codec
(reference: python/bifrost/guppi_raw.py — 80-char records 'KEY = value',
final record 'END', optional DIRECTIO 512-byte alignment;
NTIME = BLOCSIZE*8 // (OBSNCHAN*NPOL*2*NBITS); binary layout
[chan][time][pol][complex]).

The port's own copy of bifrost_tpu/io/guppi_raw.py (numpy only, kept
verbatim so that both packages read and write the same bytes).
"""

from __future__ import annotations

RECORD_LEN = 80
DIRECTIO_ALIGN_NBYTE = 512


def read_header(f):
    hdr = {}
    while True:
        record = f.read(RECORD_LEN)
        if len(record) < RECORD_LEN:
            raise IOError("EOF reached in middle of header")
        record = record.decode()
        if record.startswith("END"):
            break
        key, val = record.split("=", 1)
        key, val = key.strip(), val.strip()
        if key in hdr:
            raise KeyError(f"Duplicate header key: {key}")
        try:
            val = int(val)
        except ValueError:
            try:
                val = float(val)
            except ValueError:
                if val[0] not in ("'", '"'):
                    raise ValueError(f"Invalid header value: {val}")
                val = val[1:-1].rstrip()
        hdr[key] = val
    if hdr.get("DIRECTIO", 0):
        rem = f.tell() % DIRECTIO_ALIGN_NBYTE
        if rem:
            f.read(DIRECTIO_ALIGN_NBYTE - rem)
    if "NPOL" in hdr:
        hdr["NPOL"] = 1 if hdr["NPOL"] == 1 else 2
    if "NTIME" not in hdr:
        hdr["NTIME"] = hdr["BLOCSIZE"] * 8 // (hdr["OBSNCHAN"] *
                                               hdr["NPOL"] * 2 * hdr["NBITS"])
    return hdr


def write_header(f, hdr):
    """Write a GUPPI RAW header (for testing and transmit paths)."""
    for key, val in hdr.items():
        if isinstance(val, str):
            sval = f"'{val:<8s}'"
        else:
            sval = str(val)
        record = f"{key:<8s}= {sval}"
        f.write(record.ljust(RECORD_LEN).encode()[:RECORD_LEN])
    f.write(b"END" + b" " * (RECORD_LEN - 3))
