"""Testing blocks: feed numpy arrays in, collect gulps out (counterpart of
bifrost_tpu/blocks/testing.py)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..DataType import DataType
from ..ndarray import logical_shape, structured_to_pair
from ..pipeline import SourceBlock, SinkBlock

__all__ = ["ArraySourceBlock", "array_source",
           "CallbackSinkBlock", "callback_sink", "gather_sink",
           "inject_burst", "narrowband_storm", "inject_tone"]


def _host_tensor(a):
    """numpy -> CPU tensor in storage form (structured complex integers
    gain the trailing (re, im) axis)."""
    if a.dtype.names is not None:
        a = structured_to_pair(a)
    return torch.from_numpy(np.ascontiguousarray(a))


class ArraySourceBlock(SourceBlock):
    """Stream a fixed numpy array, frame (time) axis first.  Header fields
    (dtype/labels/scales/units, and any extra metadata) may be overridden
    via `header=`; dtype defaults to the array's own.

    Complex-integer voltages (ci8) come either as the JAX package's
    structured [("re", "i1"), ("im", "i1")] array or, with
    ``header={"dtype": "ci8"}``, as their storage form: an int8 array
    with a trailing (re, im) axis of 2."""

    def __init__(self, data, gulp_nframe, header=None, name="testdata",
                 **kwargs):
        super().__init__([name], gulp_nframe, **kwargs)
        self.data_arr = np.asarray(data)
        self.header_override = dict(header or {})
        self._cursor = 0
        dt = self.header_override.get("dtype")
        self._pairs = (self.data_arr.dtype.names is None and dt is not None
                       and DataType(dt).is_complex and
                       DataType(dt).is_integer and DataType(dt).nbit >= 8)
        if self._pairs and self.data_arr.shape[-1] != 2:
            raise ValueError(f"{dt} storage needs a trailing (re, im) axis "
                             f"of 2, got shape {self.data_arr.shape}")

    def create_reader(self, name):
        @contextlib.contextmanager
        def reader():
            self._cursor = 0
            yield self
        return reader()

    def on_sequence(self, reader, name):
        arr = self.data_arr
        ov = self.header_override
        shape = arr.shape[:-1] if self._pairs else arr.shape
        dt = ov.get("dtype")
        if dt is not None and DataType(dt).itemsize_bits < 8:
            # Packed storage folds the last axis: the header's is logical.
            shape = logical_shape(shape, dt)
        ndim = len(shape)
        hdr = {
            "name": str(name),
            "time_tag": int(ov.get("time_tag", 0)),
            "_tensor": {
                "dtype": str(ov.get("dtype") or DataType(arr.dtype)),
                "shape": [-1] + list(shape[1:]),
                "labels": ov.get("labels", ["time"] + [
                    f"ax{i}" for i in range(1, ndim)]),
                "scales": ov.get("scales", [[0, 1.0] for _ in range(ndim)]),
                "units": ov.get("units", [None] * ndim),
            },
        }
        for k, v in ov.items():
            if k not in ("dtype", "labels", "scales", "units", "time_tag"):
                hdr.setdefault(k, v)
        return [hdr]

    def on_data(self, reader, ospans):
        ospan = ospans[0]
        n = min(ospan.nframe, len(self.data_arr) - self._cursor)
        if n > 0:
            src = self.data_arr[self._cursor:self._cursor + n]
            ospan.data[:n].copy_(_host_tensor(src))
        self._cursor += n
        return [n]


def array_source(data, gulp_nframe, *args, **kwargs):
    """Stream `data` (numpy, time axis first) into a pipeline."""
    return ArraySourceBlock(data, gulp_nframe, *args, **kwargs)


class CallbackSinkBlock(SinkBlock):
    """Invoke callbacks on each sequence header and data gulp."""

    def __init__(self, iring, on_sequence=None, on_data=None, **kwargs):
        super().__init__(iring, **kwargs)
        self._seq_cb = on_sequence
        self._data_cb = on_data

    def on_sequence(self, iseq):
        if self._seq_cb is not None:
            self._seq_cb(iseq.header)

    def on_data(self, ispan):
        if self._data_cb is not None:
            self._data_cb(ispan.data)


def callback_sink(iring, on_sequence=None, on_data=None, *args, **kwargs):
    """Call `on_sequence(header)` / `on_data(span_tensor)` per gulp.  The
    tensor is a view of ring memory, valid only during the callback: a
    callback that keeps it must copy it."""
    return CallbackSinkBlock(iring, on_sequence, on_data, *args, **kwargs)


def gather_sink(iring, chunks, headers=None, **kwargs):
    """Collect gulps (as numpy copies) into `chunks`, headers into
    `headers`."""
    return CallbackSinkBlock(
        iring,
        on_sequence=(headers.append if headers is not None else None),
        on_data=lambda d: chunks.append(d.cpu().numpy().copy()),
        **kwargs)


def inject_burst(data, t0, dm_row, f0, df, amp, exponent=-2.0):
    """Add a dispersed pulse of `amp` to `data` ((time, freq) array, in
    place, clipped to the dtype's range) along the FDMT's delay curve:
    channel c (frequency f0 + c * df) receives it `dm_row * rel(c) /
    rel(nchan)` frames before channel 0, where rel(c) = f0**exponent -
    (f0 + c * df)**exponent.  FDMT delay row `dm_row` then sums the whole
    pulse at output time `t0`.  -> per-channel arrival frames."""
    nchan = data.shape[1]
    fc = f0 + df * np.arange(nchan)
    rel = f0 ** exponent - fc ** exponent
    total = f0 ** exponent - (f0 + nchan * df) ** exponent
    times = t0 - np.rint(dm_row * rel / total).astype(np.int64)
    if times.min() < 0:
        raise ValueError("burst starts before the data")
    chans = np.arange(nchan)
    vals = data[times, chans].astype(np.int64) + int(amp)
    info = np.iinfo(data.dtype) if data.dtype.kind in "iu" else None
    if info is not None:
        vals = np.clip(vals, info.min, info.max)
    data[times, chans] = vals
    return times


def narrowband_storm(data, frame0=0, n_storm=60, p_on=0.8, nb_amp=255,
                     seed=0):
    """Write a narrowband RFI storm into `data` ((time, freq) array, in
    place), the narrowband part of the RFI storm recipe of
    benchmarks/frb_service.py (`RFI_STORM`: 60 channels, p_on 0.8,
    amplitude 255): `n_storm` channels drawn from a seeded generator
    blink on with probability `p_on` per frame, from frame `frame0` on,
    and an on channel's sample is overwritten with `nb_amp`.  The
    recipe's full-band impulses and broadband lift are left out.
    -> (channels (n_storm,) sorted, on (nframe - frame0, n_storm)
    bool)."""
    rng = np.random.default_rng(seed)
    chans = np.sort(rng.choice(data.shape[1], n_storm, replace=False))
    on = rng.random((len(data) - frame0, n_storm)) < p_on
    block = data[frame0:, chans]
    block[on] = nb_amp
    data[frame0:, chans] = block
    return chans, on


def inject_tone(volt, t0, station, chan, nchan, amp):
    """Add a complex tone at the centre of PFB channel `chan` (chan /
    nchan cycles per frame) to every pol of one station of ci8 voltages
    (`volt`: (time, station, pol, 2) int8 storage, in place) from frame
    `t0` on, rounded and clipped to int8."""
    t = np.arange(t0, len(volt), dtype=np.int64)
    ph = 2.0 * np.pi * ((chan * t) % nchan) / nchan
    v = volt[t0:, station].astype(np.int64)            # (n, pol, 2)
    v[..., 0] += np.rint(amp * np.cos(ph)).astype(np.int64)[:, None]
    v[..., 1] += np.rint(amp * np.sin(ph)).astype(np.int64)[:, None]
    volt[t0:, station] = np.clip(v, -128, 127)
