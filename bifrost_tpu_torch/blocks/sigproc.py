"""SIGPROC filterbank source/sink blocks (counterpart of
bifrost_tpu/blocks/sigproc.py; reference python/bifrost/blocks/
sigproc.py — read_sigproc/write_sigproc).  The sink is a
DeviceSinkBlock (egress.py)."""

from __future__ import annotations

import os

import numpy as np

from ..egress import DeviceSinkBlock
from ..pipeline import SourceBlock
from ..DataType import DataType
from ..units import convert_units
from ..io import sigproc


def _mjd2unix(mjd):
    return (mjd - 40587) * 86400


def _unix2mjd(unix):
    return unix / 86400.0 + 40587


class SigprocSourceBlock(SourceBlock):
    def __init__(self, filenames, gulp_nframe, unpack=True, *args, **kwargs):
        super().__init__(filenames, gulp_nframe, *args, **kwargs)
        self.unpack = unpack

    def create_reader(self, sourcename):
        return sigproc.SigprocFile(sourcename)

    def on_sequence(self, ireader, sourcename):
        ihdr = ireader.header
        if ihdr["data_type"] not in (1, 2, 6):
            raise ValueError(f"unsupported SIGPROC data_type "
                             f"{ihdr['data_type']}")
        coord_frame = next((cf for cf in ("pulsarcentric", "barycentric",
                                          "topocentric")
                            if ihdr.get(cf)), "topocentric")
        tstart_unix = _mjd2unix(ihdr["tstart"])
        nbit = ihdr["nbits"]
        if self.unpack:
            nbit = max(nbit, 8)
        if nbit == 32:
            dtype = "f32"
        else:
            dtype = ("i" if ihdr.get("signed") else "u") + str(nbit)
        ohdr = {
            "_tensor": {
                "dtype": dtype,
                "shape": [-1, ihdr.get("nifs", 1), ihdr["nchans"]],
                "labels": ["time", "pol", "freq"],
                "scales": [[tstart_unix, ihdr["tsamp"]], None,
                           [ihdr["fch1"], ihdr["foff"]]],
                "units": ["s", None, "MHz"],
            },
            "frame_rate": 1.0 / ihdr["tsamp"],
            "source_name": ihdr.get("source_name"),
            "rawdatafile": ihdr.get("rawdatafile"),
            "az_start": ihdr.get("az_start"),
            "za_start": ihdr.get("za_start"),
            "raj": ihdr.get("src_raj"),
            "dej": ihdr.get("src_dej"),
            "refdm": ihdr.get("refdm", 0.0),
            "refdm_units": "pc cm^-3",
            "telescope": sigproc.id2telescope(ihdr.get("telescope_id")),
            "machine": sigproc.id2machine(ihdr.get("machine_id")),
            "ibeam": ihdr.get("ibeam"),
            "nbeams": ihdr.get("nbeams"),
            "coord_frame": coord_frame,
            "time_tag": int(round(tstart_unix * 2 ** 32)),
            "name": sourcename,
        }
        return [ohdr]

    def on_data(self, reader, ospans):
        ospan = ospans[0]
        indata = reader.read(ospan.nframe, unpack=self.unpack)
        nframe = indata.shape[0]
        if nframe:
            odata = ospan.data.numpy()
            odata[:nframe] = indata.reshape(odata[:nframe].shape) \
                if self.unpack else \
                indata.view(odata.dtype).reshape(odata[:nframe].shape)
        return [nframe]


class SigprocSinkBlock(DeviceSinkBlock):
    """Filterbank sink on the egress plane (egress.py): 'cuda' ring
    gulps are staged to the host on the sink's egress worker (the
    gpuspec integrated-spectra dump path) and the `.fil` writes drain
    from pooled staging buffers."""

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
        labels = tensor.get("labels")
        shape = tensor["shape"]
        dtype = DataType(tensor["dtype"])
        frame_axis = shape.index(-1)
        if frame_axis != 0:
            raise ValueError("sigproc sink requires time as the frame axis")
        # Accept [time, chan], [time, pol, chan], or [time, dispersion]-style
        # layouts: the last axis is the channel axis, a middle axis is IFs.
        if len(shape) == 3:
            nifs, nchans = shape[1], shape[2]
            fax, tax = 2, 0
        elif len(shape) == 2:
            nifs, nchans = 1, shape[1]
            fax, tax = 1, 0
        else:
            raise ValueError(f"cannot write rank-{len(shape)} tensor "
                             f"(labels {labels}) as sigproc")
        scales = tensor.get("scales") or [None] * len(shape)
        units = tensor.get("units") or [None] * len(shape)

        def _conv(val, unit, target):
            """Convert when the unit is convertible; otherwise keep raw
            (e.g. an FFT'd freq axis carries 'us' lag units — SIGPROC has no
            field for that, so the raw scale is recorded)."""
            if not unit:
                return val
            try:
                return convert_units(val, unit, target)
            except ValueError:
                return val

        t0, dt = scales[tax] or (0.0, 1.0)
        t0 = _conv(t0, units[tax], "s")
        dt = _conv(dt, units[tax], "s")
        fscale = scales[fax] or (0.0, 1.0)
        f0 = _conv(fscale[0], units[fax], "MHz")
        df = _conv(fscale[1], units[fax], "MHz")
        if dtype.is_floating_point:
            nbits = 32
            signed = 1
        else:
            nbits = dtype.nbit
            signed = 1 if dtype.kind == "i" else 0
        shdr = {
            "telescope_id": sigproc.telescope2id(hdr.get("telescope")),
            "machine_id": sigproc.machine2id(hdr.get("machine")),
            "data_type": 1,
            "source_name": hdr.get("source_name") or hdr.get("name", ""),
            "tstart": _unix2mjd(t0),
            "tsamp": dt,
            "nbits": nbits,
            "signed": signed,
            "fch1": f0,
            "foff": df,
            "nchans": nchans,
            "nifs": nifs,
            "refdm": hdr.get("refdm"),
            "src_raj": hdr.get("raj"),
            "src_dej": hdr.get("dej"),
            "ibeam": hdr.get("ibeam"),
            "nbeams": hdr.get("nbeams"),
        }
        name = hdr.get("name", "output")
        base = os.path.basename(str(name))
        if base.endswith(".fil"):
            base = base[:-4]
        filename = os.path.join(self.path, base + ".fil") if self.path \
            else str(name) + (".fil" if not str(name).endswith(".fil") else "")
        self._file = open(filename, "wb")
        self.filename = filename
        sigproc.write_header(self._file, shdr)

    def on_sink_data(self, arr, frame_offset):
        # Staged egress buffers and frame-major span views are already
        # C-contiguous: write the buffer directly (no tobytes() copy);
        # a strided header-view input still normalizes first.
        a = np.asarray(arr)
        if not a.flags.c_contiguous:
            a = np.ascontiguousarray(a)
        self._file.write(a)

    def shutdown(self):
        super().shutdown()   # drain in-flight egress before closing
        if self._file is not None:
            self._file.close()
            self._file = None


def read_sigproc(filenames, gulp_nframe, unpack=True, *args, **kwargs):
    """Read SIGPROC filterbank files (reference blocks/sigproc.py)."""
    return SigprocSourceBlock(filenames, gulp_nframe, unpack, *args, **kwargs)


def write_sigproc(iring, path=None, *args, **kwargs):
    """Write data as SIGPROC filterbank files (reference blocks/sigproc.py)."""
    return SigprocSinkBlock(iring, path, *args, **kwargs)
