"""Beamform block: phased-array beamforming with integrated beam powers,
the B step of an FX beamformer (counterpart of the single-device path of
bifrost_tpu/blocks/beamform.py).

The per-gulp engine is the planned `ops.beamform.Beamform`: `method=`
(None reads the `beamform_method` config flag, latched for the sequence)
selects kernel K4 or its plain version.  Weights are staged to the
device once per sequence.  A gulp is split at integration boundaries,
mid-gulp where the integration length is not a multiple of the gulp
(`integrate_chunks`), and the partial sum carries across gulps, so the
powers do not depend on how the stream is cut.  A 'cuda' ring carrying
ci8 or ci4 is read in raw storage form (`ReadSpan.data_storage`, 2 or 1
B/sample).

Input axes: any order of (time, freq, station, pol) labels with time as
the frame axis; output [-1, nbeam, nchan] f32 labelled (time, beam,
freq), one frame per integration, with the time scale multiplied by the
integration length and gulp_nframe 1.

Data-quality fold (ops/calibrate.py): per-station (or per station*pol)
complex gains, from `gains=`, a `gain_callback(header)` or the stream
header's ``cal_gains`` table (skipped when an upstream GainCalBlock has
stamped ``cal_applied``), and a boolean `station_mask` (True = flagged)
are folded into the weights before they are staged, w' = w * g * ~mask:
calibration and excision ride the one staged weight tensor, with no pass
over the voltages.  `set_gains()` / `set_station_mask()` re-fold and
re-stage at the next gulp boundary.  Not ported: the mesh engines
(ROADMAP A16).

Fusion: the beam-power integration is an accumulate carry, so the block
joins fused groups (fuse.py) as an integrator stage: the group calls its
step on the host, and the step runs this block's own engine over the
same chunks through `integrate_chunks`, so a fused run is this block's,
kernel for kernel.
"""

from __future__ import annotations

import copy as _copy
import threading
import warnings

import numpy as np
import torch

from ..ndarray import complex_view
from ..ops.beamform import Beamform
from ..ops.calibrate import fold_gains, resolve_gains
from ..pipeline import TransformBlock
from ._common import (_canonical_permutation, deepcopy_header,
                      integrate_chunks, store)


class BeamformBlock(TransformBlock):

    def output_nframes_for_gulp(self, rel_frame0, in_nframe):
        """Exact emit schedule: one output frame for each integration
        boundary the gulp crosses (the phase counter restarts with every
        sequence)."""
        n = self.nframe_per_integration
        return [(rel_frame0 + in_nframe) // n - rel_frame0 // n]

    def __init__(self, iring, weights, nframe_per_integration, *args,
                 method=None, gains=None, gain_callback=None,
                 station_mask=None, cal_header_key="cal_gains", **kwargs):
        """weights: (nbeam, nstation[, npol]) complex.  method: None
        resolves the `beamform_method` config flag at each sequence start
        ('auto'/'cuda'/'plain'), latched for the sequence.  gains,
        gain_callback, station_mask, cal_header_key: the data-quality
        fold (module docstring)."""
        super().__init__(iring, *args, **kwargs)
        w = np.asarray(weights)
        if w.ndim == 3:  # (nbeam, nstation, npol) -> (nbeam, nstation*npol)
            w = w.reshape(w.shape[0], -1)
        if w.ndim != 2:
            raise ValueError(
                f"weights must be (nbeam, nstation[, npol]); got {w.shape}")
        self.weights = w.astype(np.complex64)
        self.nbeam = w.shape[0]
        self.nframe_per_integration = nframe_per_integration
        self.method = method
        self.gains = None if gains is None \
            else np.asarray(gains, dtype=np.complex64).reshape(-1)
        self.gain_callback = gain_callback
        self.station_mask = None if station_mask is None \
            else np.asarray(station_mask, dtype=bool).reshape(-1)
        self.cal_header_key = cal_header_key
        self._dq_pending = False
        self._pending_gains = self._pending_mask = None
        self._pending_has_gains = self._pending_has_mask = False
        self._dq_lock = threading.Lock()
        self.gain_updates = 0
        self.bf = Beamform()

    def define_output_nframes(self, input_nframe):
        return [1]

    def on_sequence(self, iseq):
        self.nframe_integrated = 0
        self._acc = None
        self._raw_reads = 0        # gulps read in raw int storage form
        self._raw_read_nbyte = 0   # bytes those reads covered
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        self._perm, self._role_labels = _canonical_permutation(
            itensor.get("labels"))
        if self._perm[0] != 0:
            raise ValueError(
                "beamform: the frame (streaming) axis must be time, got "
                f"labels {itensor['labels']}")
        self._dtype = iseq.tensor.dtype
        shape = [itensor["shape"][i] for i in self._perm]
        nsp = shape[2] * shape[3]
        self._nstand = shape[2]
        if self.weights.shape[1] != nsp:
            raise ValueError(
                f"weights expect {self.weights.shape[1]} inputs but the "
                f"stream carries {shape[2]}x{shape[3]} station*pol")
        g = resolve_gains(self.gains, self.gain_callback, ihdr,
                          self.cal_header_key)
        self._gvec = None if g is None \
            else self._expand_sp(g, np.complex64, "gains")
        self._mvec = None if self.station_mask is None \
            else self._expand_sp(self.station_mask, bool, "station_mask")
        self._dq_pending = False
        self._weff = self._folded_weights()
        ohdr = deepcopy_header(ihdr)
        otensor = ohdr["_tensor"]
        otensor["dtype"] = "f32"
        otensor["shape"] = [-1, self.nbeam, shape[1]]
        otensor["labels"] = [self._role_labels[0], "beam",
                             self._role_labels[1]]
        if itensor.get("scales") is not None:
            t, f = (_copy.deepcopy(itensor["scales"][i])
                    for i in self._perm[:2])
            t[1] *= self.nframe_per_integration
            otensor["scales"] = [t, [0, 1], f]
        if itensor.get("units") is not None:
            otensor["units"] = [itensor["units"][self._perm[0]], None,
                                itensor["units"][self._perm[1]]]
        ohdr["gulp_nframe"] = 1
        gulp_actual = self.gulp_nframe or ihdr.get("gulp_nframe", 1)
        if gulp_actual > self.nframe_per_integration:
            raise ValueError(
                f"gulp_nframe ({gulp_actual}) exceeds "
                f"nframe_per_integration ({self.nframe_per_integration}); "
                f"set gulp_nframe= on the beamform block")
        # Resolve the method once per sequence and latch the config flag.
        self.bf.method = self.method if self.method is not None else "auto"
        self.bf.method = self.bf._resolve()
        self._hold_flag_latch("beamform_method")
        # Stage the (folded) weights on the device once per sequence.
        self.bf.set_weights(self._weff, device=self.device)
        return ohdr

    # ------------------------------------------ data-quality weight fold
    def set_gains(self, gains):
        """Stage a new per-station (or per station*pol) gain table, or
        None to clear it; re-folded and re-staged at the next gulp
        boundary."""
        with self._dq_lock:
            self._pending_gains = None if gains is None \
                else np.asarray(gains, dtype=np.complex64).reshape(-1)
            self._pending_has_gains = True
            self._dq_pending = True

    def set_station_mask(self, mask):
        """Stage a new boolean flag mask (True = excise), or None to
        clear it, applied like `set_gains`."""
        with self._dq_lock:
            self._pending_mask = None if mask is None \
                else np.asarray(mask, dtype=bool).reshape(-1)
            self._pending_has_mask = True
            self._dq_pending = True

    def _expand_sp(self, v, dtype, what):
        """-> flat (nstation*npol,) table: a full-size table passes
        through, a per-station one repeats across pols."""
        v = np.asarray(v, dtype=dtype).reshape(-1)
        nsp = self.weights.shape[1]
        if v.size == nsp:
            return v
        if v.size == self._nstand and nsp % self._nstand == 0:
            return np.repeat(v, nsp // self._nstand)
        raise ValueError(
            f"{self.name}: {what} has {v.size} entries; expected "
            f"{self._nstand} (per station) or {nsp} (per station*pol)")

    def _folded_weights(self):
        """w' = w * g * (~mask), the raw weights' shape and dtype."""
        if self._gvec is None and self._mvec is None:
            return self.weights
        return fold_gains(self.weights, self._gvec, self._mvec)

    def _restage_weights(self):
        """Apply pending set_gains/set_station_mask updates: re-fold and
        re-stage the weights, on the block thread at a gulp boundary."""
        with self._dq_lock:
            if self._pending_has_gains:
                self._gvec = None if self._pending_gains is None \
                    else self._expand_sp(self._pending_gains,
                                         np.complex64, "gains")
            if self._pending_has_mask:
                self._mvec = None if self._pending_mask is None \
                    else self._expand_sp(self._pending_mask, bool,
                                         "station_mask")
            self._pending_gains = self._pending_mask = None
            self._pending_has_gains = self._pending_has_mask = False
            self._dq_pending = False
        self._weff = self._folded_weights()
        self.bf.set_weights(self._weff, device=self.device)
        self.gain_updates += 1

    def _integrate(self, x, raw, carry):
        """One gulp into the integration `carry` ((acc, frames
        integrated)): `x` the logical input, or with `raw` its ci8 ring
        storage -> (emitted integrations, carry', nchan)."""
        if self._dq_pending:
            self._restage_weights()
        nframe = x.shape[0]
        if raw:
            nchan = x.shape[self._perm[1]]
            dts, perm = str(self._dtype), tuple(self._perm)

            def engine(k0, k1):
                r = x if k1 - k0 == nframe else x[k0:k1]
                return self.bf.execute_raw(r, dts, perm)
        else:
            if self._dtype.is_complex and self._dtype.is_integer:
                x = complex_view(x, self._dtype)
            if self._perm != [0, 1, 2, 3]:
                x = x.permute(self._perm)
            ntime, nchan, nstand, npol = x.shape
            xm = x.reshape(ntime, nchan, nstand * npol)

            def engine(k0, k1):
                return self.bf.execute(
                    xm if k1 - k0 == nframe else xm[k0:k1])

        outs, carry = integrate_chunks(engine, nframe, carry,
                                       self.nframe_per_integration)
        return outs, carry, nchan

    def on_data(self, ispan, ospan):
        raw = ispan.data_storage
        if raw is not None:
            self._raw_reads += 1
            self._raw_read_nbyte += raw.numel() * raw.element_size()
        outs, carry, nchan = self._integrate(
            ispan.data if raw is None else raw, raw is not None,
            (self._acc, self.nframe_integrated))
        self._acc, self.nframe_integrated = carry
        if outs:
            store(ospan, outs[0].reshape(1, self.nbeam, nchan))
            return 1
        return 0

    def on_sequence_end(self, iseqs):
        # A trailing partial integration has no output slot: drop it, and
        # say so.
        if self.nframe_integrated:
            warnings.warn(
                f"{self.name}: dropping a trailing partial integration "
                f"({self.nframe_integrated}/{self.nframe_per_integration} "
                f"frames) at sequence end", stacklevel=1)
            self.nframe_integrated = 0
            self._acc = None

    # ------------------------------------------- fused-carry protocol
    fused_carry_warmup_nframe = 0
    fused_carry_stride = 1

    @property
    def fused_carry_nframe_per_integration(self):
        """The integration length in stage-input frames (marks the
        block as an integrator stage)."""
        return self.nframe_per_integration

    def _step(self, raw):
        def step(x, carry, consts):
            outs, carry, nchan = self._integrate(x, raw, carry)
            if not outs:
                return None, carry
            return torch.cat([o.reshape(1, self.nbeam, nchan)
                              for o in outs]), carry
        return step

    def device_kernel_carry(self):
        """The integrator step(x, carry, consts) -> (the emitted
        integrations as output frames or None, carry') on a logical
        gulp: this block's gulp code.  Valid after on_sequence."""
        return self._step(False)

    def device_kernel_carry_raw(self, dtype):
        """The same on ci8 ring storage (kernel K4 reading it at 2
        B/sample) or packed ci4 (unpacked to ci8 first)."""
        return self._step(True)

    def fused_carry_init(self):
        """(acc, frames integrated): the start of an integration."""
        return (None, 0)

    def fused_carry_consts(self):
        """No constants: the staged weights live on the plan
        (re-staged by set_gains/set_station_mask at the next gulp
        boundary)."""
        return ()


def beamform(iring, weights, nframe_per_integration, *args, **kwargs):
    """Beamform station/pol inputs into integrated beam powers (the
    phased-array B engine) on kernel K4; ci8 'cuda' rings are read in raw
    storage form."""
    return BeamformBlock(iring, weights, nframe_per_integration, *args,
                         **kwargs)
