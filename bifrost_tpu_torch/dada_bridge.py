"""dada_bridge: forward a PSRDADA buffer into the port's shm ring (the
port's copy of tools/dada_bridge.py).

    python -m bifrost_tpu_torch.dada_bridge --key 0xdada --name feed \\
        [--gulp-frames N] [--oneshot] [--wait-readers N] [--hdr KEY=VALUE]

Attaches to a DADA header+data HDU (SysV shared memory, the key a site
gives `dada_db -k`; protocol io/dada_ipc.py) and re-publishes each transfer
as one sequence of a named shm ring, the DADA ASCII header translated into
a `_tensor` header.  A pipeline in this or any other process consumes it
with `blocks.shm_receive(name)` or `blocks.read_psrdada_buffer`.

Header translation (override any key with --hdr KEY=VALUE): NBIT, NDIM
(2: complex), NCHAN and NPOL give the dtype and the shape [-1, NCHAN,
NPOL] with labels ["time", "freq", "pol"]; NBIT 8 with NDIM 1 is typed
i8, so a u8 filterbank is typed by the consumer's `header_callback`; the
whole DADA header rides under '__dada__'.

Exits when the DADA writer ends its transfer (--oneshot), or when no
header arrives within --timeout.
"""

from __future__ import annotations

import argparse

import numpy as np

__all__ = ["dada_to_tensor", "bridge_one_transfer", "main"]


def dada_to_tensor(dada, overrides=None):
    """DADA ASCII dict -> (`_tensor` header, frame bytes)."""
    d = dict(dada)
    d.update(overrides or {})
    nbit = int(d.get("NBIT", 8))
    nchan = int(d.get("NCHAN", 1))
    npol = int(d.get("NPOL", 1))
    ndim = int(d.get("NDIM", 1))        # DADA: 2 == complex sampling
    kind = "ci" if ndim == 2 else ("i" if nbit < 32 else "f")
    dtype = f"{kind}{nbit}"
    tensor = {
        "dtype": dtype,
        "shape": [-1, nchan, npol],
        "labels": ["time", "freq", "pol"],
        "scales": [[float(d.get("OBS_OFFSET", 0)),
                    1.0 / float(d.get("BW", 1.0) or 1.0)],
                   [float(d.get("FREQ", 0.0)), float(d.get("BW", 1.0)) /
                    max(nchan, 1)],
                   [0, 1]],
        "units": ["s", "MHz", None],
    }
    frame_nbyte = nchan * npol * ndim * nbit // 8
    return tensor, frame_nbyte


def bridge_one_transfer(hdu, writer, gulp_frames, overrides, timeout=10.0):
    """Forward one DADA transfer (header, then data until its end) into
    the shm ring as one sequence.  -> False when no header arrived."""
    from .blocks.psrdada import parse_dada_header

    headerstr = hdu.read_header(timeout=timeout)
    if headerstr is None:
        return False
    dada = parse_dada_header(headerstr)
    tensor, frame_nbyte = dada_to_tensor(dada, overrides)
    header = {
        "name": str(dada.get("OBS_ID", "dada")),
        "time_tag": int(dada.get("PICOSECONDS", 0) or 0),
        "_tensor": tensor,
        "__dada__": headerstr,
    }
    writer.begin_sequence(header)
    pending = bytearray()
    nfwd = 0
    while True:
        got = hdu.data.open_read_buf(timeout=timeout)
        if got is None:
            raise TimeoutError("DADA data ring: no buffer within timeout")
        if got == "EOD":
            break
        buf, nbyte = got
        pending += buf[:nbyte]
        hdu.data.mark_cleared()
        nframe = len(pending) // frame_nbyte
        emit = (nframe // gulp_frames) * gulp_frames or nframe
        if emit:
            n = emit * frame_nbyte
            chunk = np.frombuffer(pending, np.uint8, count=n)
            writer.write(chunk)
            del chunk           # the bytearray resizes only unexported
            del pending[:n]
            nfwd += emit
    nframe = len(pending) // frame_nbyte
    if nframe:
        writer.write(np.frombuffer(pending, np.uint8,
                                   count=nframe * frame_nbyte))
        nfwd += nframe
    writer.end_sequence()
    print(f"dada_bridge: forwarded {nfwd} frames "
          f"({nfwd * frame_nbyte} bytes)", flush=True)
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--key", required=True,
                    help="DADA shm key (hex, e.g. 0xdada)")
    ap.add_argument("--name", required=True,
                    help="the shm ring's name")
    ap.add_argument("--gulp-frames", type=int, default=256)
    ap.add_argument("--oneshot", action="store_true",
                    help="exit after the first transfer ends")
    ap.add_argument("--timeout", type=float, default=10.0)
    ap.add_argument("--wait-readers", type=int, default=1,
                    help="wait for N shm ring readers before forwarding "
                         "(0: free-run)")
    ap.add_argument("--capacity", type=int, default=1 << 24,
                    help="the shm ring's data bytes")
    ap.add_argument("--hdr", action="append", default=[],
                    metavar="KEY=VALUE", help="override a DADA key")
    args = ap.parse_args(argv)

    from .io.dada_ipc import DadaHDU
    from .shmring import ShmRingWriter

    overrides = dict(kv.split("=", 1) for kv in args.hdr)
    hdu = DadaHDU(int(args.key, 0), create=False)
    try:
        writer = ShmRingWriter(args.name, data_capacity=args.capacity)
        try:
            if args.wait_readers:
                writer.wait_for_readers(args.wait_readers,
                                        timeout=args.timeout)
            while True:
                got = bridge_one_transfer(hdu, writer, args.gulp_frames,
                                          overrides, timeout=args.timeout)
                if args.oneshot or not got:
                    break
        finally:
            writer.end_writing()
            writer.close(unlink=False)
    finally:
        hdu.close()


if __name__ == "__main__":
    main()
