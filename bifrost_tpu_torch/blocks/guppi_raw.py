"""GUPPI RAW source and sink blocks (counterpart of
bifrost_tpu/blocks/guppi_raw.py; reference python/bifrost/blocks/
guppi_raw.py — one frame per GUPPI block, tensor ['time', 'freq',
'fine_time', 'pol'], ci* dtype).  The source reads each block straight
into its host span's bytes; the sink runs on the egress plane
(egress.py): 'cuda' ring gulps are staged to the host while upstream
blocks compute, then written as header + payload per block."""

from __future__ import annotations

import os

import numpy as np

from ..egress import DeviceSinkBlock
from ..pipeline import SourceBlock
from ..DataType import DataType
from ..io import guppi_raw


def _mjd2unix(mjd):
    return (mjd - 40587) * 86400


class GuppiRawSourceBlock(SourceBlock):
    def __init__(self, sourcenames, gulp_nframe=1, *args, **kwargs):
        super().__init__(sourcenames, gulp_nframe=gulp_nframe,
                         *args, **kwargs)

    def create_reader(self, sourcename):
        return open(sourcename, "rb")

    def on_sequence(self, reader, sourcename):
        previous_pos = reader.tell()
        ihdr = guppi_raw.read_header(reader)
        self.header_buf = bytearray(reader.tell() - previous_pos)
        nbit = ihdr["NBITS"]
        if nbit not in (4, 8, 16, 32, 64):
            raise ValueError(f"bad NBITS {nbit}")
        nchan = ihdr["OBSNCHAN"]
        bw_MHz = ihdr["OBSBW"]
        cfreq_MHz = ihdr["OBSFREQ"]
        df_MHz = bw_MHz / nchan
        f0_MHz = cfreq_MHz - 0.5 * (nchan - 1) * df_MHz
        dt_s = 1.0 / df_MHz / 1e6
        byte_offset = ihdr.get("PKTIDX", 0) * ihdr.get("PKTSIZE", 0)
        frame_nbyte = ihdr["BLOCSIZE"] / ihdr["NTIME"]
        bytes_per_sec = frame_nbyte / dt_s
        offset_secs = byte_offset / bytes_per_sec
        tstart_mjd = ihdr.get("STT_IMJD", 40587) + \
            (ihdr.get("STT_SMJD", 0) + offset_secs) / 86400.0
        tstart_unix = _mjd2unix(tstart_mjd)
        raj = ihdr.get("RA")
        ohdr = {
            "_tensor": {
                "dtype": "ci" + str(nbit),
                "shape": [-1, nchan, ihdr["NTIME"], ihdr["NPOL"]],
                "labels": ["time", "freq", "fine_time", "pol"],
                "scales": [[tstart_unix, abs(dt_s) * ihdr["NTIME"]],
                           [f0_MHz, df_MHz], [0, dt_s], None],
                "units": ["s", "MHz", "s", None],
            },
            "gulp_nframe": 1,
            "az_start": ihdr.get("AZ"),
            "za_start": ihdr.get("ZA"),
            "raj": raj * (24.0 / 360.0) if raj is not None else None,
            "dej": ihdr.get("DEC"),
            "source_name": ihdr.get("SRC_NAME"),
            "refdm": ihdr.get("CHAN_DM"),
            "refdm_units": "pc cm^-3",
            "telescope": ihdr.get("TELESCOP"),
            "machine": ihdr.get("BACKEND"),
            "rawdatafile": sourcename,
            "coord_frame": "topocentric",
            "time_tag": int(round(tstart_unix * 2 ** 32)),
            "name": sourcename,
        }
        self.already_read_header = True
        return [ohdr]

    def on_data(self, reader, ospans):
        if not self.already_read_header:
            nbyte = reader.readinto(self.header_buf)
            if nbyte == 0:
                return [0]  # EOF
            if nbyte < len(self.header_buf):
                raise IOError("Block header is truncated")
        self.already_read_header = False
        ospan = ospans[0]
        odata = ospan.data
        if odata.is_cuda:
            raise ValueError("read_guppi_raw writes a host ring: use "
                             "space='system' (or 'cuda_host') and copy")
        buf = odata.numpy().reshape(-1).view(np.uint8)
        nbyte = reader.readinto(buf)
        frame_nbyte = ospan.tensor.frame_nbyte
        if nbyte % frame_nbyte:
            raise IOError("Block data is truncated")
        return [nbyte // frame_nbyte]


def read_guppi_raw(filenames, gulp_nframe=1, *args, **kwargs):
    """Read GUPPI RAW files (reference blocks/guppi_raw.py:121-141)."""
    return GuppiRawSourceBlock(filenames, gulp_nframe, *args, **kwargs)


def _unix2mjd(unix):
    return unix / 86400.0 + 40587


class GuppiRawSinkBlock(DeviceSinkBlock):
    """Sink: write the stream back out as GUPPI RAW blocks (one frame =
    one GUPPI block: 80-char header records + the frame's voltages),
    inverting GuppiRawSourceBlock's header mapping.

    Expects a ['time', 'freq', 'fine_time', 'pol'] complex-integer
    stream (the capture layout).  Host-ring inputs write their raw
    (re, im) int storage bytes directly; device-ring inputs arrive
    from the egress stager in logical complex form and are requantized
    to the declared ci dtype storage — exact for voltage-range values
    (integers are preserved bit-exactly through the float lift).
    """

    def __init__(self, iring, path=None, *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        self.path = path or ""
        self._file = None

    def on_sink_sequence(self, iseq):
        if self._file is not None:
            self._file.close()
            self._file = None
        hdr = iseq.header
        tensor = hdr["_tensor"]
        shape = tensor["shape"]
        if len(shape) != 4 or shape.index(-1) != 0:
            raise ValueError(
                f"GUPPI sink expects [-1, freq, fine_time, pol] "
                f"(one GUPPI block per frame), got shape {shape}")
        self._dtype = DataType(tensor["dtype"])
        if not (self._dtype.is_complex and self._dtype.is_integer):
            raise ValueError(
                f"GUPPI RAW stores complex-integer voltages; got "
                f"{tensor['dtype']}")
        nchan, ntime, npol = shape[1], shape[2], shape[3]
        # DataType('ciN').nbit is already per real component — the
        # inverse of the source's NBITS -> f"ci{nbit}" mapping.
        nbit = self._dtype.nbit
        scales = tensor.get("scales") or [None] * 4
        f0, df = (scales[1] or (0.0, 1.0))
        t0 = (scales[0] or (0.0, 0.0))[0]
        mjd = _unix2mjd(t0)
        stt_imjd = int(mjd)
        stt_smjd = int(round((mjd - stt_imjd) * 86400.0))
        if stt_smjd >= 86400:          # rounding carried past midnight
            stt_imjd += 1
            stt_smjd -= 86400
        self._base_header = {
            "OBSNCHAN": nchan,
            "NPOL": npol,
            "NBITS": nbit,
            "NTIME": ntime,
            "BLOCSIZE": nchan * ntime * npol * 2 * nbit // 8,
            "OBSBW": df * nchan,
            "OBSFREQ": f0 + 0.5 * (nchan - 1) * df,
            "STT_IMJD": stt_imjd,
            "STT_SMJD": stt_smjd,
        }
        for hkey, gkey in (("source_name", "SRC_NAME"),
                           ("telescope", "TELESCOP"),
                           ("machine", "BACKEND")):
            if hdr.get(hkey):
                self._base_header[gkey] = str(hdr[hkey])
        self._nblock = 0
        name = hdr.get("name", "output")
        base = os.path.basename(str(name))
        if base.endswith(".raw"):
            base = base[:-4]
        filename = os.path.join(self.path, base + ".raw") if self.path \
            else (str(name) if str(name).endswith(".raw")
                  else str(name) + ".raw")
        self.filename = filename
        self._file = open(filename, "wb")

    def _storage_bytes(self, frame):
        """One frame's GUPPI payload: the (re, im) int storage bytes."""
        a = np.asarray(frame)
        if a.dtype.names is not None:        # structured (re, im) pairs
            return np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        if np.issubdtype(a.dtype, np.complexfloating):
            # Staged logical form: requantize to the declared int width
            # (exact for voltage-range integer values).
            comp = self._dtype.as_numpy_dtype()
            base = np.dtype(comp.fields["re"][0]) if comp.names else np.int8
            pair = np.empty(a.shape + (2,), dtype=base)
            np.rint(a.real, out=pair[..., 0], casting="unsafe")
            np.rint(a.imag, out=pair[..., 1], casting="unsafe")
            return pair.reshape(-1).view(np.uint8)
        return np.ascontiguousarray(a).view(np.uint8).reshape(-1)

    def on_sink_data(self, arr, frame_offset):
        for i in range(len(arr)):
            hdr = dict(self._base_header)
            hdr["PKTIDX"] = self._nblock
            guppi_raw.write_header(self._file, hdr)
            self._file.write(self._storage_bytes(arr[i]))
            self._nblock += 1

    def on_sink_sequence_end(self, iseq):
        if self._file is not None:
            self._file.close()
            self._file = None

    def shutdown(self):
        super().shutdown()   # drain in-flight egress before closing
        if self._file is not None:
            self._file.close()
            self._file = None


def write_guppi_raw(iring, path=None, *args, **kwargs):
    """Write the stream as GUPPI RAW block files (the capture-format
    egress pair of `read_guppi_raw`)."""
    return GuppiRawSinkBlock(iring, path, *args, **kwargs)
