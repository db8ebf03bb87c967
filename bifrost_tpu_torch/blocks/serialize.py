"""Serialize / deserialize: the stream checkpoint and resume pair
(counterpart of bifrost_tpu/blocks/serialize.py; reference
python/bifrost/blocks/serialize.py).

On disk: ``<name>.bf.json`` (the sequence header) and data files
``<name>.bf.<frame0>.dat``, or one file a ringlet,
``<name>.bf.<frame0>.<ringlet>.dat``, for a stream whose frame axis is
second; a new set of files starts at the gulp that would take a file past
`max_file_size` bytes.  The files are byte for byte the JAX serializer's,
and each package reads the other's.

The sink is a `DeviceSinkBlock` (egress.py): a 'cuda' ring's gulps are
staged to the host on the sink's egress worker and written from the
pooled buffers.  The reader opens one set of data files at a time (a
stream with 2048 ringlets has 2048 files a set).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from ..egress import DeviceSinkBlock
from ..pipeline import SourceBlock

__all__ = ["BifrostReader", "DeserializeBlock", "SerializeBlock",
           "serialize", "deserialize"]


def _parse_bifrost_filename(fname):
    inds = fname[fname.find(".bf.") + 4:].split(".")[:-1]
    inds = [int(i) for i in inds]
    return inds[0], inds[1:]


class BifrostReader(object):
    """The data files of one serialized sequence, read across the file
    boundaries, one set of files open at a time."""

    def __init__(self, basename):
        if not basename.endswith(".bf"):
            raise ValueError("expected a '.bf' basename")
        with open(basename + ".json") as hdr_file:
            self.header = json.load(hdr_file)
        data_filenames = glob.glob(basename + ".*.dat")
        if not data_filenames:
            raise IOError(f"no data files for {basename}")
        inds = [_parse_bifrost_filename(f) for f in data_filenames]
        _frame0s, ringlet_inds = zip(*inds)
        nringlets = [max(r) + 1 for r in zip(*ringlet_inds)]
        if len(nringlets) > 1:
            raise NotImplementedError("multiple ringlet axes")
        self.nringlet = nringlets[0] if nringlets else 0
        if self.nringlet > 0:
            ringlet_first = [r[0] for r in ringlet_inds]
            # names[i][r]: the i-th file of ringlet r.
            per_ringlet = [sorted(f for f, r in zip(data_filenames,
                                                    ringlet_first)
                                  if r == ringlet)
                           for ringlet in range(self.nringlet)]
            self._names = [list(fs) for fs in zip(*per_ringlet)]
        else:
            self._names = [[f] for f in sorted(data_filenames)]
        self.nfile = len(self._names)
        self.cur_file = 0
        self._files = None      # (file index, open files)

    def _open(self, i):
        if self._files is None or self._files[0] != i:
            self._close()
            self._files = (i, [open(f, "rb") for f in self._names[i]])
        return self._files[1]

    def _close(self):
        if self._files is not None:
            for f in self._files[1]:
                f.close()
            self._files = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._close()

    def readinto(self, buf, frame_nbyte):
        """Fill `buf` (a byte array, or one per ringlet) across file
        boundaries; -> frames read."""
        if self.cur_file == self.nfile:
            return 0
        bufs = buf if self.nringlet > 0 else [buf]
        views = [memoryview(b).cast("B") for b in bufs]
        target = views[0].nbytes
        filled = 0
        while filled < target and self.cur_file < self.nfile:
            files = self._open(self.cur_file)
            nbyte_read = min(f.readinto(v[filled:])
                             for f, v in zip(files, views))
            if nbyte_read % frame_nbyte:
                raise IOError("Unexpected end of file")
            filled += nbyte_read
            if filled < target:
                self.cur_file += 1
        return filled // frame_nbyte


class DeserializeBlock(SourceBlock):
    def create_reader(self, sourcename):
        return BifrostReader(sourcename)

    def on_sequence(self, ireader, sourcename):
        return [ireader.header]

    def on_data(self, reader, ospans):
        ospan = ospans[0]
        data = ospan.data.numpy()
        t = ospan.tensor
        if reader.nringlet > 0:
            # Each ringlet row of the span is contiguous in the ring.
            rows = []
            for r in range(reader.nringlet):
                row = data[r]
                if not row.flags.c_contiguous:
                    raise IOError("ringlet span rows are not contiguous")
                rows.append(row)
            nframe = reader.readinto(rows, t.frame_nbyte)
        else:
            nframe = reader.readinto(data.reshape(-1).view(np.uint8),
                                     t.frame_nbyte)
        return [nframe]


class SerializeBlock(DeviceSinkBlock):
    """Stream checkpoint sink on the egress plane (egress.py): a 'cuda'
    ring's gulps are staged on the sink's egress worker and written from
    the pooled buffers; a host ring's straight from the span."""

    def __init__(self, iring, path=None, max_file_size=None, *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        self.path = path or ""
        self.max_file_size = max_file_size if max_file_size is not None \
            else 1024 ** 3
        self.ofiles = []
        self.filenames = []

    def _close_data_files(self):
        for f in self.ofiles:
            f.close()
        self.ofiles = []

    def _open_new_data_files(self, frame_offset):
        self._close_data_files()
        self.bytes_written = 0
        if self.frame_axis == 0:
            filenames = [f"{self.basename}.bf.{frame_offset:012d}.dat"]
        elif self.frame_axis == 1:
            ndigit = len(str(self.nringlet - 1))
            filenames = [f"{self.basename}.bf.{frame_offset:012d}."
                         f"{i:0{ndigit}d}.dat"
                         for i in range(self.nringlet)]
        else:
            raise NotImplementedError("multiple ringlet axes")
        self.ofiles = [open(f, "wb") for f in filenames]
        self.filenames.extend(filenames)

    def on_sink_sequence(self, iseq):
        hdr = iseq.header
        tensor = hdr["_tensor"]
        self.basename = hdr.get("name") or f"{hdr.get('time_tag', 0):020d}"
        if self.path:
            self.basename = os.path.join(self.path,
                                         os.path.basename(self.basename))
        with open(self.basename + ".bf.json", "w") as hdr_file:
            hdr_file.write(json.dumps(hdr, indent=4, sort_keys=True))
        shape = tensor["shape"]
        self.frame_axis = shape.index(-1)
        self.nringlet = int(np.prod(shape[:self.frame_axis])) \
            if self.frame_axis else 1
        self._open_new_data_files(frame_offset=0)

    def on_sink_sequence_end(self, iseq):
        self._close_data_files()

    def on_sink_data(self, arr, frame_offset):
        data = np.asarray(arr)
        if self.nringlet == 1:
            bytes_to_write = data.nbytes
        else:
            bytes_to_write = data[0].nbytes
        if self.max_file_size > 0 and \
                self.bytes_written + bytes_to_write > self.max_file_size:
            self._open_new_data_files(frame_offset)
        self.bytes_written += bytes_to_write
        if self.nringlet == 1:
            data.tofile(self.ofiles[0])
        else:
            for r in range(self.nringlet):
                row = data[r]
                if not row.flags.c_contiguous:
                    row = np.ascontiguousarray(row)
                row.tofile(self.ofiles[r])

    def shutdown(self):
        super().shutdown()   # drain the staged gulps before closing
        self._close_data_files()


def serialize(iring, path=None, max_file_size=None, *args, **kwargs):
    """Dump any stream to `.bf.json` + `.dat` files."""
    return SerializeBlock(iring, path, max_file_size, *args, **kwargs)


def deserialize(filenames, gulp_nframe, *args, **kwargs):
    """Re-ingest streams written by `serialize` (each name the
    ``<name>.bf`` basename)."""
    return DeserializeBlock(filenames, gulp_nframe, *args, **kwargs)
