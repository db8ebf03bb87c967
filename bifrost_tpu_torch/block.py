"""Legacy v1 block API (counterpart of bifrost_tpu/block.py; reference
python/bifrost/block.py, the original byte-oriented programming model,
superseded by bifrost_tpu_torch.pipeline).

The v1 model: a Pipeline is a list of (block, input_ring_ids,
output_ring_ids) tuples; rings are looked up by name; each block runs
`main(...)` on its own thread and moves raw bytes through rings with a
`gulp_size`, carrying a free-form JSON header per sequence.  This module
reproduces that model on the port's host rings (legacy headers ride
beside the `_tensor` entry the ring needs for frame math; 1 frame == 1
byte).  The v1 blocks are host code and compute with numpy, as the JAX
package's do, so every file they write is byte-identical to the JAX
blocks'.  A span's tensor is viewed as a numpy array over the ring's own
memory (`_span_bytes`), never copied, so a write lands in the ring.
"""

from __future__ import annotations

import json
import threading

import numpy as np

from .ring import EndOfDataStop, Ring

__all__ = ["Pipeline", "SourceBlock", "SinkBlock", "TransformBlock",
           "MultiTransformBlock", "SplitterBlock", "MultiAddBlock",
           "TestingBlock", "WriteHeaderBlock", "WriteAsciiBlock",
           "CopyBlock", "FFTBlock", "IFFTBlock", "SigprocReadBlock",
           "KurtosisBlock", "DedisperseBlock", "FoldBlock",
           "WaterfallBlock", "NumpyBlock", "NumpySourceBlock",
           "insert_zeros_evenly"]


def _v1_dtype(header, default="float32"):
    """Parse the v1 header 'dtype' field, which historically appears both
    as a plain name ('float32') and as str(np.float32) =
    "<class 'numpy.float32'>" (reference block.py parses the latter with
    a split dance at many call sites)."""
    val = header.get("dtype", default)
    s = str(val)
    if "'" in s:  # "<class 'numpy.float32'>" style
        s = s.split("'")[1].split(".")[-1]
    return np.dtype(s)


def _span_bytes(span):
    """A host ring span's bytes as a flat uint8 numpy array sharing the
    span's memory."""
    return span.data.numpy().reshape(-1)


def _byte_header(legacy_header):
    hdr = dict(legacy_header)
    hdr.setdefault("name", "")
    hdr.setdefault("time_tag", 0)
    hdr["_tensor"] = {"dtype": "u8", "shape": [-1, 1]}
    return hdr


def _legacy_view(header):
    hdr = dict(header)
    hdr.pop("_tensor", None)
    return hdr


class Pipeline(object):
    """Connect v1 blocks via named rings and run them on threads
    (reference block.py:56-126).  Positional blocks are wired as
    (block, [input ring ids], [output ring ids]); MultiTransformBlock
    subclasses as (block, {ring_name: ring_id})."""

    def __init__(self, blocks):
        self.blocks = blocks
        self.rings = {}
        for index in self.unique_ring_names():
            if isinstance(index, Ring):
                self.rings[str(index)] = index
            else:
                self.rings[index] = Ring(name=f"legacy_{index}")

    def unique_ring_names(self):
        all_names = []
        for block in self.blocks:
            if isinstance(block[0], MultiTransformBlock):
                assert len(block[0].ring_names) == len(block[1])
                for ring_name in block[0].ring_names:
                    assert ring_name in block[1], \
                        f"no ring wired for port {ring_name!r}"
                for ring_id in block[1].values():
                    all_names.append(ring_id if isinstance(ring_id, Ring)
                                     else str(ring_id))
            else:
                for port in block[1:]:
                    for index in port:
                        all_names.append(index if isinstance(index, Ring)
                                         else str(index))
        return set(all_names)

    def main(self):
        threads = []
        for block in self.blocks:
            if isinstance(block[0], MultiTransformBlock):
                for port, ring_id in block[1].items():
                    block[0].rings[port] = self.rings[str(ring_id)]
                target, args = block[0]._main, []
            else:
                input_rings = [self.rings[str(r)] for r in block[1]]
                output_rings = [self.rings[str(r)] for r in block[2]]
                if isinstance(block[0], SourceBlock):
                    target, args = block[0].main, [output_rings[0]]
                elif isinstance(block[0], SinkBlock):
                    target, args = block[0].main, [input_rings[0]]
                else:
                    target, args = block[0].main, [input_rings, output_rings]
            t = threading.Thread(target=target, args=args, daemon=True)
            threads.append(t)
        for t in threads:
            t.start()
        for t in threads:
            t.join()


class _RingIO(object):
    """Shared byte-gulp read/write helpers for v1 blocks."""

    gulp_size = 4096
    out_gulp_size = None
    header = {}

    def write_to_ring(self, ring, data_bytes, header):
        """Write one full sequence of bytes with a legacy header."""
        hdr = _byte_header(header)
        ring.begin_writing()
        try:
            with ring.begin_sequence(hdr, gulp_nframe=max(1, self.gulp_size),
                                     buf_nframe=4 * max(1, self.gulp_size)) \
                    as oseq:
                data = np.frombuffer(bytes(data_bytes), dtype=np.uint8)
                pos = 0
                while pos < len(data):
                    n = min(self.gulp_size, len(data) - pos)
                    with oseq.reserve(n) as ospan:
                        _span_bytes(ospan)[:n] = data[pos:pos + n]
                        ospan.commit(n)
                    pos += n
        finally:
            ring.end_writing()

    def iterate_ring_read(self, ring):
        """Yield (legacy_header, bytes) gulps from a ring
        (reference TransformBlock.iterate_ring_read)."""
        for iseq in ring.read(guarantee=True):
            self.header = _legacy_view(iseq.header)
            for ispan in iseq.read(self.gulp_size):
                yield _span_bytes(ispan)[:ispan.nframe]


class SourceBlock(_RingIO):
    """Produces data into one output ring; subclass main(output_ring)."""

    def main(self, output_ring):
        raise NotImplementedError


class SinkBlock(_RingIO):
    """Consumes one input ring; subclass main(input_ring)."""

    def main(self, input_ring):
        raise NotImplementedError


class TransformBlock(_RingIO):
    """input rings -> output rings; default main copies ring 0 -> ring 0
    (reference block.py:144-197)."""

    def main(self, input_rings, output_rings):
        oring = output_rings[0]
        oring.begin_writing()
        try:
            for iseq in input_rings[0].read(guarantee=True):
                self.header = _legacy_view(iseq.header)
                ohdr = _byte_header(self.on_sequence(dict(self.header)))
                gulp = self.gulp_size
                with oring.begin_sequence(ohdr, gulp_nframe=gulp,
                                          buf_nframe=4 * gulp) as oseq:
                    for ispan in iseq.read(gulp):
                        idata = _span_bytes(ispan)[:ispan.nframe]
                        odata = self.on_data(idata)
                        if odata is None:
                            continue
                        odata = np.asarray(odata, dtype=np.uint8).reshape(-1)
                        with oseq.reserve(len(odata)) as ospan:
                            _span_bytes(ospan)[:len(odata)] = odata
                            ospan.commit(len(odata))
        finally:
            oring.end_writing()

    def on_sequence(self, header):
        return header

    def on_data(self, data):
        return data


class CopyBlock(TransformBlock):
    """Copies input to output unchanged (reference block.py:588-597)."""


class TestingBlock(SourceBlock):
    """Writes a numpy test array into a ring (reference block.py:415-447)."""

    def __init__(self, test_array, complex_numbers=False):
        self.test_array = np.asarray(test_array, dtype=np.complex64
                                     if complex_numbers else np.float32)

    def main(self, output_ring):
        header = {
            "nbit": self.test_array.dtype.itemsize * 8,
            "dtype": str(self.test_array.dtype),
            "shape": list(self.test_array.shape),
        }
        self.gulp_size = max(1, self.test_array.nbytes)
        self.write_to_ring(output_ring, self.test_array.tobytes(), header)


class WriteAsciiBlock(SinkBlock):
    """Writes every gulp as ASCII numbers to a file
    (reference block.py:545-587)."""

    def __init__(self, filename, gulp_size=4096):
        self.filename = filename
        self.gulp_size = gulp_size
        open(filename, "w").close()  # truncate

    def main(self, input_ring):
        with open(self.filename, "a") as f:
            for raw in self.iterate_ring_read(input_ring):
                dtype = _v1_dtype(self.header)
                vals = raw.tobytes()
                arr = np.frombuffer(vals[:len(vals) // dtype.itemsize *
                                         dtype.itemsize], dtype=dtype)
                # Complex data is written as interleaved float pairs
                # (reference block.py:575-580).
                if arr.dtype == np.complex64:
                    arr = arr.view(np.float32)
                elif arr.dtype == np.complex128:
                    arr = arr.view(np.float64)
                text = " ".join(str(v) for v in arr.ravel())
                if text:
                    f.write(text + " ")


def insert_zeros_evenly(input_data, number_zeros):
    """Evenly distribute zeros through a 1-D array
    (reference block.py:127-143)."""
    insert_index = np.floor(
        np.arange(number_zeros, step=1.0) *
        float(input_data.size) / number_zeros).astype(int)
    return np.insert(input_data, insert_index, np.zeros(number_zeros))


class MultiTransformBlock(object):
    """v1 multi-ring block: named ring ports, dict-held headers and gulp
    sizes, generator-based read/write (reference block.py:240-357).

    Subclasses declare `ring_names = {port: description}`, set
    `self.gulp_size[port]` / `self.header[port]` (in `load_settings` for
    inputs, up front or per-sequence for outputs), and drive
    `self.read(*ports)` / `self.write(*ports)` from `main()`.  Setting
    `self.trigger_sequence = True` inside the loop makes `write` begin a
    new output sequence with the current headers — the mechanism
    NumpyBlock uses when a function's output geometry changes.
    """

    ring_names = {}

    def __init__(self):
        self.rings = {}
        self.header = {}
        self.gulp_size = {}
        self.trigger_sequence = False

    def _main(self):
        for ring_name in self.ring_names:
            self.header.setdefault(ring_name, {})
        self.main()

    def main(self):
        raise NotImplementedError

    def load_settings(self):
        """Subclass hook: interpret input headers (set gulp sizes)."""

    def flatten(self, *args):
        out = []
        for element in args:
            if isinstance(element, (tuple, list)):
                out.extend(self.flatten(*element))
            else:
                out.append(element)
        return out

    def izip(self, *iterables):
        """Zip generators, flattening each yielded tuple (reference
        block.py:281-291)."""
        iterators = [iter(it) for it in iterables]
        while True:
            try:
                nxt = [next(it) for it in iterators]
            except (EndOfDataStop, StopIteration):
                return
            yield self.flatten(*nxt)

    def read(self, *ports):
        """Yield tuples of typed flat arrays, one gulp per input port."""
        seq_iters = [self.rings[p].read(guarantee=True) for p in ports]
        while True:
            try:
                seqs = [next(it) for it in seq_iters]
            except (EndOfDataStop, StopIteration):
                return
            for p, s in zip(ports, seqs):
                self.header[p] = _legacy_view(s.header)
            self.load_settings()
            dtypes = {p: _v1_dtype(self.header[p]) for p in ports}
            span_iters = [s.read(self.gulp_size[p])
                          for p, s in zip(ports, seqs)]
            while True:
                try:
                    spans = [next(it) for it in span_iters]
                except (EndOfDataStop, StopIteration):
                    break
                yield tuple(
                    _span_bytes(sp)[:sp.nframe].view(dtypes[p])
                    for p, sp in zip(ports, spans))

    def _derive_port_settings(self, name, arr):
        """Header + gulp size for an output port, measured from an array
        (shared by NumpyBlock and NumpySourceBlock so the derivation
        cannot drift between them)."""
        assert isinstance(arr, np.ndarray)
        self.gulp_size[name] = arr.nbytes
        self.header[name] = {
            "dtype": str(arr.dtype),
            "nbit": arr.dtype.itemsize * 8,
            "shape": list(arr.shape)}

    def write(self, *ports):
        """Yield tuples of writable typed flat arrays, one gulp per output
        port; each span commits when the caller pulls the next tuple (or
        closes the generator).  `trigger_sequence` starts a new sequence
        with the then-current headers/gulp sizes."""
        for p in ports:
            self.rings[p].begin_writing()
        try:
            ended = False
            while not ended:
                seqs = [self.rings[p].begin_sequence(
                    _byte_header(self.header.get(p, {})),
                    gulp_nframe=max(1, self.gulp_size[p]),
                    buf_nframe=4 * max(1, self.gulp_size[p]))
                    for p in ports]
                self.trigger_sequence = False
                try:
                    while not self.trigger_sequence:
                        gsizes = [self.gulp_size[p] for p in ports]
                        spans = [seq.reserve(g)
                                 for seq, g in zip(seqs, gsizes)]
                        views = []
                        for p, sp, g in zip(ports, spans, gsizes):
                            raw = _span_bytes(sp)[:g]
                            # Zero-fill before handing out: if the
                            # consumer dies mid-loop the close-commit
                            # below publishes zeros, never stale ring
                            # memory.
                            raw.fill(0)
                            views.append(raw.view(
                                _v1_dtype(self.header.get(p, {}))))
                        views = tuple(views)
                        committed = False
                        try:
                            yield views
                            for sp, g in zip(spans, gsizes):
                                sp.commit(g)
                            committed = True
                        except GeneratorExit:
                            # Consumer stopped: the caller wrote this gulp
                            # before its final loop exit — commit it, then
                            # stop cleanly.
                            for sp, g in zip(spans, gsizes):
                                sp.commit(g)
                            ended = True
                            raise
                        finally:
                            if not committed and not ended:
                                for sp, g in zip(spans, gsizes):
                                    sp.commit(0)
                finally:
                    for seq in seqs:
                        seq.end()
        finally:
            for p in ports:
                self.rings[p].end_writing()


class SplitterBlock(MultiTransformBlock):
    """Split one float ring into two index-selected sections
    (reference block.py:358-391)."""

    ring_names = {
        "in": "Input to split. List of floats",
        "out_1": "Gets first share of the ring. List of floats",
        "out_2": "Gets second share of the ring. List of floats"}

    def __init__(self, sections):
        super().__init__()
        assert len(sections) == 2
        self.sections = sections
        for port, sec in (("out_1", sections[0]), ("out_2", sections[1])):
            self.header[port] = {"dtype": "float32", "nbit": 32,
                                 "shape": list(np.shape(sec))}

    def load_settings(self):
        in_vals = int(np.prod(self.header["in"]["shape"]))
        self.gulp_size["in"] = in_vals * self.header["in"]["nbit"] // 8
        for port, sec in (("out_1", self.sections[0]),
                          ("out_2", self.sections[1])):
            nsec = int(np.asarray(sec).size)
            self.gulp_size[port] = self.gulp_size["in"] * nsec // in_vals

    def main(self):
        for inspan, out1, out2 in self.izip(self.read("in"),
                                            self.write("out_1", "out_2")):
            out1[:] = inspan[self.sections[0]].ravel()
            out2[:] = inspan[self.sections[1]].ravel()


class MultiAddBlock(MultiTransformBlock):
    """Add two float input rings element-wise (reference block.py:392-414)."""

    ring_names = {
        "in_1": "First input to add. List of floats",
        "in_2": "Second input to add. List of floats",
        "out_sum": "Result of add. List of floats."}

    def __init__(self, gulp_size=8):
        super().__init__()
        self.gulp_size = {"in_1": gulp_size, "in_2": gulp_size,
                          "out_sum": gulp_size}
        self.header["out_sum"] = {"dtype": "float32", "nbit": 32,
                                  "shape": [gulp_size // 4]}

    def load_settings(self):
        pass  # fixed gulp sizes

    def main(self):
        for in1, in2, out in self.izip(self.read("in_1", "in_2"),
                                       self.write("out_sum")):
            out[:] = in1 + in2


class WriteHeaderBlock(SinkBlock):
    """Write a ring's sequence header (as a dict repr) to a file
    (reference block.py:448-464)."""

    def __init__(self, filename):
        self.filename = filename

    def main(self, input_ring):
        self.gulp_size = 1
        gen = self.iterate_ring_read(input_ring)
        try:
            next(gen)
        except (EndOfDataStop, StopIteration):
            pass
        with open(self.filename, "w") as f:
            f.write(str(self.header))


class FFTBlock(TransformBlock):
    """Accumulate a whole input sequence and write its 1-D complex FFT
    (reference block.py:465-504)."""

    def __init__(self, gulp_size=4096):
        self.gulp_size = gulp_size

    def main(self, input_rings, output_rings):
        self._sequence_transform(input_rings[0], output_rings[0], np.fft.fft)

    def _sequence_transform(self, iring, oring, func):
        chunks = []
        for raw in self.iterate_ring_read(iring):
            chunks.append(np.asarray(raw, dtype=np.uint8).copy())
        hdr = dict(self.header)
        dtype = _v1_dtype(hdr)
        data = np.concatenate(chunks).tobytes() if chunks else b""
        n = len(data) // dtype.itemsize * dtype.itemsize
        arr = np.frombuffer(data[:n], dtype=dtype)
        shape = hdr.get("frame_shape") or hdr.get("shape")
        if shape and int(np.prod(shape)) > 0 and len(shape) > 1:
            arr = arr.reshape(int(shape[0]), -1)
        result = func(arr.astype(np.complex64)).astype(np.complex64)
        hdr["dtype"] = "complex64"
        hdr["nbit"] = 64
        self.gulp_size = max(1, result.nbytes)
        self.write_to_ring(oring, result.ravel().tobytes(), hdr)


class IFFTBlock(FFTBlock):
    """Accumulate a whole input sequence and write its 1-D complex IFFT
    (reference block.py:505-544)."""

    def main(self, input_rings, output_rings):
        self._sequence_transform(input_rings[0], output_rings[0],
                                 np.fft.ifft)


class SigprocReadBlock(SourceBlock):
    """Stream a sigproc filterbank (.fil) file into a ring
    (reference block.py:598-640)."""

    def __init__(self, filename, gulp_nframe=4096, core=-1):
        self.filename = filename
        self.gulp_nframe = gulp_nframe
        self.core = core

    def main(self, output_ring):
        from .io.sigproc import SigprocFile
        sf = SigprocFile(self.filename)
        hdr = {
            "frame_shape": (sf.nchans, sf.nifs),
            "frame_size": sf.nchans * sf.nifs,
            "frame_nbyte": sf.nchans * sf.nifs * sf.nbits // 8,
            "frame_axes": ("pol", "chan"),
            "ringlet_shape": (1,),
            "ringlet_axes": (),
            "dtype": str(np.dtype(f"uint{max(8, sf.nbits)}"
                                  if not sf.signed else
                                  f"int{max(8, sf.nbits)}")),
            "nbit": sf.nbits,
            "tsamp": float(sf.header.get("tsamp", 0.0)),
            "tstart": float(sf.header.get("tstart", 0.0)),
            "fch1": float(sf.header.get("fch1", 0.0)),
            "foff": float(sf.header.get("foff", 0.0)),
        }
        self.gulp_size = self.gulp_nframe * sf.nchans * sf.nifs * \
            sf.nbits // 8
        # Stream gulp_nframe frames at a time: one gulp in memory, not
        # the whole file.
        output_ring.begin_writing()
        try:
            with output_ring.begin_sequence(
                    _byte_header(hdr), gulp_nframe=max(1, self.gulp_size),
                    buf_nframe=4 * max(1, self.gulp_size)) as oseq:
                while True:
                    chunk = sf.read(self.gulp_nframe, unpack=False)
                    raw = np.ascontiguousarray(chunk).view(np.uint8) \
                        .reshape(-1)
                    if raw.size == 0:
                        break
                    with oseq.reserve(raw.size) as ospan:
                        _span_bytes(ospan)[:raw.size] = raw
                        ospan.commit(raw.size)
                    if len(chunk) < self.gulp_nframe:
                        break
        finally:
            output_ring.end_writing()
            sf.close()


class KurtosisBlock(TransformBlock):
    """Spectral-kurtosis RFI flagging: channels whose SK estimator (Nita
    et al. eq. 21) deviates from the expected 0.5 by more than 0.1 are
    zeroed (reference block.py:641-697)."""

    def __init__(self, gulp_size=1048576, core=-1):
        self.gulp_size = gulp_size
        self.core = core

    def main(self, input_rings, output_rings):
        oring = output_rings[0]
        oring.begin_writing()
        try:
            for iseq in input_rings[0].read(guarantee=True):
                self.header = _legacy_view(iseq.header)
                nchan = int(self.header["frame_shape"][0])
                dtype = _v1_dtype(self.header)
                # Align the gulp to whole (nchan, dtype) rows: a
                # misaligned gulp would rotate channels between gulps and
                # silently drop remainder bytes.
                row = nchan * dtype.itemsize
                gulp = max(row, self.gulp_size // row * row)
                ohdr = _byte_header(dict(self.header))
                with oring.begin_sequence(ohdr, gulp_nframe=gulp,
                                          buf_nframe=4 * gulp) \
                        as oseq:
                    for ispan in iseq.read(gulp):
                        raw = _span_bytes(ispan)[:ispan.nframe]
                        n = len(raw) // (nchan * dtype.itemsize) * \
                            (nchan * dtype.itemsize)
                        power = raw[:n].view(dtype).reshape(-1, nchan) \
                            .astype(np.float64)
                        m = power.shape[0]
                        s1 = power.sum(axis=0)
                        s2 = (power ** 2).sum(axis=0)
                        with np.errstate(divide="ignore",
                                         invalid="ignore"):
                            v2 = (m / (m - 1.0)) * (m * s2 / (s1 ** 2) - 1)
                        bad = np.abs(0.5 - v2) > 0.1
                        flagged = raw[:n].view(dtype).reshape(-1, nchan) \
                            .copy()
                        flagged[:, bad] = 0
                        out = flagged.reshape(-1).view(np.uint8)
                        with oseq.reserve(len(out)) as ospan:
                            _span_bytes(ospan)[:len(out)] = out
                            ospan.commit(len(out))
        finally:
            oring.end_writing()


def _dispersion_delay_s(dm, freq_mhz, ref_freq_mhz):
    """Cold-plasma dispersion delay (s) of `freq_mhz` relative to
    `ref_freq_mhz` for dispersion measure `dm` (pc cm^-3)."""
    return 4.1488e3 * dm * (freq_mhz ** -2.0 - ref_freq_mhz ** -2.0)


class DedisperseBlock(object):
    """Tag a sigproc-read ring's header with per-channel dedispersion
    delays for a trial DM (reference block.py:698-726 — the v1 block
    records delays in the header; downstream blocks apply them)."""

    def __init__(self, ring, core=-1, gulp_size=4096):
        self.ring = ring
        self.core = core
        self.gulp_size = gulp_size

    def main(self, dispersion_measure=0):
        for iseq in self.ring.read(guarantee=True):
            hdr = _legacy_view(iseq.header)
            nchan = int(hdr["frame_shape"][0])
            fch1, foff = float(hdr["fch1"]), float(hdr["foff"])
            freqs = fch1 + foff * np.arange(nchan)
            delays = _dispersion_delay_s(dispersion_measure, freqs,
                                         fch1)
            tsamp = float(hdr.get("tsamp", 1.0)) or 1.0
            hdr["delays_samples"] = (delays / tsamp).tolist()
            self.header = hdr
            for _ in iseq.read(self.gulp_size):
                pass
            return hdr


class FoldBlock(TransformBlock):
    """Fold a sigproc-read stream into a pulse-phase histogram for a
    trial period and DM (reference block.py:727-815)."""

    def __init__(self, bins, period=1e-3, gulp_size=4096 * 256,
                 dispersion_measure=0, core=-1):
        self.bins = bins
        self.period = period
        self.gulp_size = gulp_size
        self.dispersion_measure = dispersion_measure
        self.core = core
        self.data_settings = {}

    def calculate_bin_indices(self, tstart, tsamp, data_size):
        """Phase-bin index of each time sample (reference
        block.py:778-787)."""
        arrival = tstart + tsamp * np.arange(data_size)
        phase = np.fmod(arrival, self.period)
        return np.floor(phase / self.period * self.bins).astype(int)

    def calculate_delay(self, frequency, reference_frequency):
        """Dispersion delay (s) of `frequency` vs the reference
        (reference block.py:788-794)."""
        return _dispersion_delay_s(self.dispersion_measure, frequency,
                                   reference_frequency)

    def main(self, input_rings, output_rings):
        histogram = np.zeros(self.bins, dtype=np.float64)
        counts = np.zeros(self.bins, dtype=np.int64)
        tstart = None
        for iseq in input_rings[0].read(guarantee=True):
            hdr = self.header = _legacy_view(iseq.header)
            nchan = int(hdr["frame_shape"][0])
            dtype = _v1_dtype(hdr)
            tsamp = float(hdr["tsamp"])
            if tstart is None:
                tstart = float(hdr["tstart"]) * 86400.0  # MJD days -> s
            # Row-aligned gulps: a misaligned gulp would rotate channels
            # and drop remainder bytes between gulps.
            row = nchan * dtype.itemsize
            gulp = max(row, self.gulp_size // row * row)
            fch1, foff = float(hdr["fch1"]), float(hdr["foff"])
            for ispan in iseq.read(gulp):
                raw = _span_bytes(ispan)[:ispan.nframe]
                n = len(raw) // row * row
                data = raw[:n].view(dtype).reshape(-1, nchan)
                for chan in range(nchan):
                    freq = fch1 + foff * chan
                    delay = self.calculate_delay(freq, fch1)
                    idx = self.calculate_bin_indices(
                        tstart - delay, tsamp, data.shape[0])
                    np.add.at(histogram, idx,
                              data[:, chan].astype(np.float64))
                    np.add.at(counts, idx, 1)
                tstart += tsamp * data.shape[0]
        with np.errstate(invalid="ignore"):
            folded = np.where(counts > 0, histogram / np.maximum(counts, 1),
                              0.0).astype(np.float32)
        self.gulp_size = folded.nbytes
        self.out_gulp_size = folded.nbytes
        hdr = {"dtype": "float32", "nbit": 32, "shape": [self.bins]}
        self.write_to_ring(output_rings[0], folded.tobytes(), hdr)


class WaterfallBlock(object):
    """Accumulate a (time, chan) waterfall matrix from a sigproc-read
    ring and save it (reference block.py:816-904 — the v1 block renders
    a PNG via matplotlib; here the matrix is saved as .npy, keeping the
    pipeline headless)."""

    def __init__(self, ring, imagename, core=-1, gulp_nframe=4096):
        self.ring = ring
        self.imagename = imagename
        self.core = core
        self.gulp_nframe = gulp_nframe
        self.header = {}

    def main(self):
        matrix = self.generate_waterfall_matrix()
        if self.imagename:
            np.save(self.imagename, matrix)
        return matrix

    def save_waterfall_plot(self, waterfall_matrix):
        np.save(self.imagename, waterfall_matrix)

    def generate_waterfall_matrix(self):
        rows = []
        for iseq in self.ring.read(guarantee=True):
            hdr = _legacy_view(iseq.header)
            self.header = hdr
            nchan = int(hdr["frame_shape"][0])
            dtype = _v1_dtype(hdr)
            gulp = self.gulp_nframe * nchan * dtype.itemsize
            for ispan in iseq.read(gulp):
                raw = _span_bytes(ispan)[:ispan.nframe]
                n = len(raw) // (nchan * dtype.itemsize) * \
                    (nchan * dtype.itemsize)
                rows.append(raw[:n].view(dtype).reshape(-1, nchan).copy())
            break
        if not rows:
            return np.zeros((0, 0), dtype=np.float32)
        return np.concatenate(rows, axis=0)


class NumpySourceBlock(MultiTransformBlock):
    """Stream arrays from a generator, one ring per output, headers
    auto-derived (reference block.py:1007-1095).

    grab_headers=True: the generator yields (array, header_dict, ...)
    interleaved; changing=True: geometry changes between yields start new
    sequences."""

    def __init__(self, generator, outputs=1, grab_headers=False,
                 changing=True):
        super().__init__()
        self.outputs = [f"out_{i + 1}" for i in range(outputs)]
        self.ring_names = {name: f"Output number {name[4:]}"
                           for name in self.outputs}
        assert callable(generator)
        self.generator = generator()
        self.grab_headers = grab_headers
        self.changing = changing

    def _split(self, output_data):
        if self.grab_headers:
            return list(output_data[0::2]), list(output_data[1::2])
        if len(self.outputs) == 1:
            return [output_data], None
        return list(output_data), None

    def _settings_from(self, arrays, headers):
        for name, arr in zip(self.outputs, arrays):
            self._derive_port_settings(name, arr)
        if headers:
            for name, hdr in zip(self.outputs, headers):
                self.header[name].update(hdr)
                if "dtype" in hdr:
                    assert "nbit" in hdr
                    self.gulp_size[name] = arrays[
                        self.outputs.index(name)].size * \
                        int(hdr["nbit"]) // 8

    def main(self):
        try:
            arrays, headers = self._split(next(self.generator))
        except (EndOfDataStop, StopIteration):
            return
        self._settings_from(arrays, headers)
        for outspans in self.write(*self.outputs):
            for name, span, arr in zip(self.outputs, outspans, arrays):
                span[:] = arr.astype(_v1_dtype(self.header[name])).ravel()
            try:
                arrays, headers = self._split(next(self.generator))
            except (EndOfDataStop, StopIteration):
                break
            if self.changing:
                old = {n: dict(self.header[n]) for n in self.outputs}
                self._settings_from(arrays, headers)
                if any(old[n] != self.header[n] for n in self.outputs):
                    self.trigger_sequence = True


class NumpyBlock(MultiTransformBlock):
    """Wrap an arbitrary N-array -> M-array numpy function as a block:
    input geometry comes from the headers, output geometry is measured
    from the function's results, and a geometry change mid-stream starts
    new output sequences (reference block.py:905-1006)."""

    def __init__(self, function, inputs=1, outputs=1):
        super().__init__()
        self.inputs = [f"in_{i + 1}" for i in range(inputs)]
        self.outputs = [f"out_{i + 1}" for i in range(outputs)]
        self.ring_names = {}
        for name in self.inputs:
            self.ring_names[name] = f"Input number {name[3:]}"
        for name in self.outputs:
            self.ring_names[name] = f"Output number {name[4:]}"
        assert callable(function)
        self.function = function

    def _in_shape(self, name):
        hdr = self.header[name]
        shape = hdr.get("shape") or hdr.get("frame_shape")
        if shape is None:
            raise ValueError(
                f"NumpyBlock input {name!r}: header carries neither "
                f"'shape' nor 'frame_shape' ({sorted(hdr)})")
        return list(shape)

    def load_settings(self):
        for name in self.inputs:
            dtype = _v1_dtype(self.header[name])
            self.gulp_size[name] = \
                int(np.prod(self._in_shape(name))) * dtype.itemsize

    def main(self):
        write_gen = self.write(*self.outputs) if self.outputs else None
        for inspans in self.izip(self.read(*self.inputs)):
            shaped = [span.reshape(self._in_shape(name))
                      for name, span in zip(self.inputs, inspans)]
            if write_gen is None:
                self.function(*shaped)
                continue
            result = self.function(*shaped)
            arrays = [result] if len(self.outputs) == 1 else list(result)
            assert len(arrays) == len(self.outputs)
            old = {n: dict(self.header.get(n, {})) for n in self.outputs}
            for name, arr in zip(self.outputs, arrays):
                self._derive_port_settings(name, arr)
            if any(old[n] != self.header[n] for n in self.outputs):
                self.trigger_sequence = True
            outspans = next(write_gen)
            for span, arr in zip(outspans, arrays):
                span[:] = arr.ravel()
