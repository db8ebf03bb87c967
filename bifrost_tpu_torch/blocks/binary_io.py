"""Raw binary file read and write blocks (counterpart of
bifrost_tpu/blocks/binary_io.py; reference python/bifrost/blocks/
binary_io.py).  The files are the stream's bytes and nothing else, the
same bytes the JAX blocks read and write."""

from __future__ import annotations

import numpy as np

from ..DataType import DataType
from ..pipeline import SinkBlock, SourceBlock

__all__ = ["BinaryFileReadBlock", "BinaryFileWriteBlock", "binary_read",
           "binary_write"]


class _BinaryFileRead(object):
    def __init__(self, filename, gulp_size, np_dtype):
        self.file_obj = open(filename, "rb")
        self.dtype = np_dtype
        self.gulp_size = gulp_size

    def read(self):
        return np.fromfile(self.file_obj, dtype=self.dtype,
                           count=self.gulp_size)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.file_obj.close()


class BinaryFileReadBlock(SourceBlock):
    """Frames of `gulp_size` samples of `dtype`, one frame a gulp step."""

    def __init__(self, filenames, gulp_size, gulp_nframe, dtype,
                 *args, **kwargs):
        super().__init__(filenames, gulp_nframe, *args, **kwargs)
        self.dtype = dtype
        self.gulp_size = gulp_size

    def create_reader(self, filename):
        np_dtype = DataType(self.dtype).as_numpy_dtype()
        return _BinaryFileRead(filename, self.gulp_size, np_dtype)

    def on_sequence(self, ireader, filename):
        return [{
            "name": filename,
            "_tensor": {
                "dtype": self.dtype,
                "shape": [-1, self.gulp_size],
                "labels": ["streamed", "gulped"],
                "units": [None, None],
                "scales": [[0, 1], [0, 1]],
            },
        }]

    def on_data(self, reader, ospans):
        indata = reader.read()
        if indata.shape[0] == self.gulp_size:
            odata = ospans[0].data.numpy()
            odata[0] = indata.view(odata.dtype).reshape(odata[0].shape)
            return [1]
        return [0]


class BinaryFileWriteBlock(SinkBlock):
    """Writes each sequence's bytes to ``<name>.<file_ext>``."""

    def __init__(self, iring, file_ext="out", *args, **kwargs):
        super().__init__(iring, *args, **kwargs)
        self.current_fileobj = None
        self.file_ext = file_ext

    def on_sequence(self, iseq):
        if self.current_fileobj is not None:
            self.current_fileobj.close()
        new_filename = iseq.header["name"] + "." + self.file_ext
        self.current_fileobj = open(new_filename, "wb")

    def on_data(self, ispan):
        data = ispan.data.cpu().contiguous()
        self.current_fileobj.write(data.numpy().tobytes())

    def shutdown(self):
        if self.current_fileobj is not None:
            self.current_fileobj.close()
            self.current_fileobj = None

    def main(self):
        try:
            super().main()
        finally:
            self.shutdown()


def binary_read(filenames, gulp_size, gulp_nframe, dtype, *args, **kwargs):
    """Stream raw binary files into the pipeline."""
    return BinaryFileReadBlock(filenames, gulp_size, gulp_nframe, dtype,
                               *args, **kwargs)


def binary_write(iring, file_ext="out", *args, **kwargs):
    """Write a ring's bytes to binary files."""
    return BinaryFileWriteBlock(iring, file_ext, *args, **kwargs)
