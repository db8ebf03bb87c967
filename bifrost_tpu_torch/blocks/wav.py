"""WAV audio source and sink blocks (counterpart of bifrost_tpu/blocks/
wav.py; reference python/bifrost/blocks/wav.py): a RIFF/WAVE codec of
its own, one file a sequence; the sink's files are byte for byte the JAX
sink's."""

from __future__ import annotations

import os
import struct

import numpy as np

from ..DataType import DataType
from ..pipeline import SinkBlock, SourceBlock
from ..units import convert_units

__all__ = ["wav_read_header", "wav_write_header", "WavSourceBlock",
           "WavSinkBlock", "read_wav", "write_wav"]


def wav_read_header(f):
    chunk_id, chunk_size, chunk_fmt = struct.unpack("<4sI4s", f.read(12))
    if chunk_id != b"RIFF" or chunk_fmt != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    hdr = None
    sub_id, sub_size = struct.unpack("<4sI", f.read(8))
    while sub_id != b"data":
        if sub_id == b"fmt ":
            packed = f.read(16)
            f.seek(sub_size - 16, 1)
            keys = ("audio_fmt", "nchan", "sample_rate", "byte_rate",
                    "block_align", "nbit")
            hdr = dict(zip(keys, struct.unpack("<HHIIHH", packed)))
        else:
            f.seek(sub_size, 1)
        sub_id, sub_size = struct.unpack("<4sI", f.read(8))
    return hdr, sub_size


def wav_write_header(f, hdr, chunk_size=0, data_size=0):
    f.write(struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", chunk_size, b"WAVE", b"fmt ", 16,
        hdr.get("audio_fmt", 1), hdr["nchan"], hdr["sample_rate"],
        hdr["sample_rate"] * hdr["nchan"] * hdr["nbit"] // 8,
        hdr["nchan"] * hdr["nbit"] // 8, hdr["nbit"], b"data", data_size))


class WavSourceBlock(SourceBlock):
    def create_reader(self, sourcename):
        return open(sourcename, "rb")

    def on_sequence(self, reader, sourcename):
        hdr, data_size = wav_read_header(reader)
        nbit = hdr["nbit"]
        dtype = ("u" if nbit == 8 else "i") + str(nbit)
        ohdr = {
            "_tensor": {
                "dtype": dtype,
                "shape": [-1, hdr["nchan"]],
                "labels": ["time", "channel"],
                "scales": [[0, 1.0 / hdr["sample_rate"]], None],
                "units": ["s", None],
            },
            "frame_rate": hdr["sample_rate"],
            "name": sourcename,
            "time_tag": 0,
        }
        return [ohdr]

    def on_data(self, reader, ospans):
        ospan = ospans[0]
        odata = ospan.data.numpy()
        nbyte = reader.readinto(odata.reshape(-1).view(np.uint8))
        return [nbyte // ospan.tensor.frame_nbyte]


class WavSinkBlock(SinkBlock):
    def __init__(self, iring, path=None, *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        self.path = path or ""
        self._file = None

    def on_sequence(self, iseq):
        if self._file is not None:
            self._finalize_file()
        hdr = iseq.header
        tensor = hdr["_tensor"]
        dtype = DataType(tensor["dtype"])
        nchan = tensor["shape"][-1] if len(tensor["shape"]) > 1 else 1
        scales = tensor.get("scales")
        units = tensor.get("units")
        dt = scales[0][1] if scales and scales[0] else 1.0
        if units and units[0]:
            dt = convert_units(dt, units[0], "s")
        rate = int(round(1.0 / dt)) if dt else 44100
        name = os.path.basename(str(hdr.get("name", "output")))
        if not name.endswith(".wav"):
            name += ".wav"
        path = os.path.join(self.path, name) if self.path else name
        self._file = open(path, "wb")
        self._whdr = {"audio_fmt": 1, "nchan": nchan, "sample_rate": rate,
                      "nbit": dtype.nbit}
        self._data_size = 0
        wav_write_header(self._file, self._whdr)

    def _finalize_file(self):
        # back-patch RIFF sizes
        f = self._file
        f.seek(0)
        wav_write_header(f, self._whdr, chunk_size=36 + self._data_size,
                         data_size=self._data_size)
        f.close()
        self._file = None

    def on_data(self, ispan):
        raw = ispan.data.cpu().contiguous().numpy().tobytes()
        self._file.write(raw)
        self._data_size += len(raw)

    def shutdown(self):
        if self._file is not None:
            self._finalize_file()

    def main(self):
        try:
            super().main()
        finally:
            self.shutdown()


def read_wav(filenames, gulp_nframe, *args, **kwargs):
    """Read WAV audio files."""
    return WavSourceBlock(filenames, gulp_nframe, *args, **kwargs)


def write_wav(iring, path=None, *args, **kwargs):
    """Write streams as WAV audio files."""
    return WavSinkBlock(iring, path, *args, **kwargs)
