"""Correlate block: the X step of an FX correlator (counterpart of the
single-device f32 engine of bifrost_tpu/blocks/correlate.py; reference
python/bifrost/blocks/correlate.py).

Per channel c, over the frames of an integration,

    v[c, i, j] = sum_t conj(x[t, c, i]) * x[t, c, j]

with i, j running over station x pol.  The product is one batched
complex `torch.matmul` per gulp (cuBLAS CGEMM on the card) with TF32 off,
as the JAX package runs it at Precision.HIGHEST outside any Pallas
kernel; a gulp that is one whole integration is written straight into
the output span.  A gulp is split at integration boundaries, mid-gulp
where the integration length is not a multiple of the gulp
(`integrate_chunks`), and the partial sum carries across gulps.

Gains ((nstand,) or (nstand * npol,) complex) scale the voltages before
the product, x' = g * x, so v'_ij = conj(g_i) g_j v_ij.  They resolve per
sequence from `gains=`, then a `gain_callback(header)`, then the stream
header's ``cal_gains`` table, which is skipped when an upstream
GainCalBlock has stamped ``cal_applied``; `set_gains()` stages a new table
for the next gulp boundary.

Input axes: any order of (time, freq, station, pol) labels with time as
the frame axis; output [-1, nchan, nstand, npol, nstand, npol] cf32
labelled (time, freq, station_i, pol_i, station_j, pol_j), one frame per
integration, the time scale multiplied by the integration length,
``matrix_fill_mode`` 'full'.  Not ported yet (ROADMAP): the int8 engine,
the raw ci* ingest and the mesh engines.

Fusion: the visibility integration is an accumulate carry, so the block
joins fused groups (fuse.py) as an integrator stage whose step is this
block's own gulp code on the same chunks.
"""

from __future__ import annotations

import copy as _copy
import threading
import warnings

import numpy as np
import torch

from ..ndarray import complex_view
from ..ops.calibrate import resolve_gains
from ..pipeline import TransformBlock
from ._common import (_canonical_permutation, deepcopy_header,
                      integrate_chunks, store)


def xengine(xm, gains=None, out=None):
    """xm (ntime, nchan, nsp) complex64 -> v (nchan, nsp, nsp) complex64,
    v[c, i, j] = sum_t conj(x'[t, c, i]) x'[t, c, j] with x' = gains * x
    (into `out` when given)."""
    if xm.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    if gains is not None:
        xm = xm * gains
    xc = xm.permute(1, 0, 2)                  # (nchan, ntime, nsp)
    return torch.matmul(xc.mH, xc, out=out)


class CorrelateBlock(TransformBlock):

    def output_nframes_for_gulp(self, rel_frame0, in_nframe):
        """Exact emit schedule: one output frame for each integration
        boundary the gulp crosses."""
        n = self.nframe_per_integration
        return [(rel_frame0 + in_nframe) // n - rel_frame0 // n]

    def __init__(self, iring, nframe_per_integration, *args, engine="f32",
                 gains=None, gain_callback=None, cal_header_key="cal_gains",
                 **kwargs):
        """engine: 'f32' (the only engine ported).  gains,
        gain_callback, cal_header_key: per-station or per-station*pol
        complex gains folded into the voltages (module docstring)."""
        super().__init__(iring, *args, **kwargs)
        if engine == "int8":
            raise NotImplementedError(
                "correlate: the int8 X-engine is not ported yet (ROADMAP, "
                "left out by the imaging slice); use engine='f32'")
        if engine != "f32":
            raise ValueError(f"unknown correlate engine {engine!r}")
        self.nframe_per_integration = nframe_per_integration
        self.gains = None if gains is None \
            else np.asarray(gains, dtype=np.complex64).reshape(-1)
        self.gain_callback = gain_callback
        self.cal_header_key = cal_header_key
        self._dq_pending = False
        self._pending_gains = None
        self._dq_lock = threading.Lock()
        self.gain_updates = 0

    def define_output_nframes(self, input_nframe):
        return [1]

    def on_sequence(self, iseq):
        self.nframe_integrated = 0
        self._acc = None
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        self._perm, _ = _canonical_permutation(itensor.get("labels"))
        if self._perm[0] != 0:
            raise ValueError(
                "correlate: the frame (streaming) axis must be time, got "
                f"labels {itensor['labels']}")
        self._dtype = iseq.tensor.dtype
        ohdr = deepcopy_header(ihdr)
        otensor = ohdr["_tensor"]
        otensor["dtype"] = "cf32"
        for key in ("shape", "labels", "scales", "units"):
            if key not in itensor or itensor[key] is None:
                continue
            # Canonical (time, freq, station, pol) order; the station and
            # pol entries are duplicated and must not alias.
            t, f, s, p = (_copy.deepcopy(itensor[key][i])
                          for i in self._perm)
            otensor[key] = [t, f, s, p, _copy.deepcopy(s),
                            _copy.deepcopy(p)]
        for i in range(2):
            otensor["labels"][2 + i] = str(otensor["labels"][2 + i]) + "_i"
            otensor["labels"][4 + i] = str(otensor["labels"][4 + i]) + "_j"
        otensor["scales"][0][1] *= self.nframe_per_integration
        ohdr["matrix_fill_mode"] = "full"
        ohdr["gulp_nframe"] = min(ihdr.get("gulp_nframe", 1),
                                  self.nframe_per_integration)
        gulp_actual = self.gulp_nframe or ihdr.get("gulp_nframe", 1)
        if gulp_actual > self.nframe_per_integration:
            raise ValueError(
                f"gulp_nframe ({gulp_actual}) exceeds "
                f"nframe_per_integration ({self.nframe_per_integration}); "
                f"set gulp_nframe= on the correlate block")
        self._nstand = int(itensor["shape"][self._perm[2]])
        self._npol = int(itensor["shape"][self._perm[3]])
        g = resolve_gains(self.gains, self.gain_callback, ihdr,
                          self.cal_header_key)
        self._g = None if g is None else self._stage_gains(g)
        self._dq_pending = False
        return ohdr

    # ------------------------------------------ data-quality gain fold
    def set_gains(self, gains):
        """Stage a new per-station gain table (or None to clear it),
        applied at the next gulp boundary on the block thread."""
        with self._dq_lock:
            self._pending_gains = None if gains is None \
                else np.asarray(gains, dtype=np.complex64).reshape(-1)
            self._dq_pending = True

    def _stage_gains(self, g):
        """-> the flat (nstand*npol,) complex64 gains on the device; a
        per-station table repeats across pols."""
        g = np.asarray(g, dtype=np.complex64).reshape(-1)
        nsp = self._nstand * self._npol
        if g.size == self._nstand and self._npol > 1:
            g = np.repeat(g, self._npol)
        if g.size != nsp:
            raise ValueError(
                f"{self.name}: gains have {g.size} entries; expected "
                f"{self._nstand} (per station) or {nsp} (per station*pol)")
        return torch.from_numpy(g).to(self.device)

    def _apply_pending_gains(self):
        with self._dq_lock:
            pend = self._pending_gains
            self._pending_gains = None
            self._dq_pending = False
        self._g = None if pend is None else self._stage_gains(pend)
        self.gain_updates += 1

    def _voltages(self, x):
        """The gulp in canonical (time, freq, station*pol) complex64."""
        if self._dq_pending:
            self._apply_pending_gains()
        if self._dtype.is_complex and self._dtype.is_integer:
            x = complex_view(x, self._dtype)
        elif not x.is_complex():
            x = x.to(torch.complex64)
        if self._perm != [0, 1, 2, 3]:
            x = x.permute(self._perm)
        ntime, nchan, nstand, npol = x.shape
        return x.reshape(ntime, nchan, nstand * npol)

    def _integrate(self, xm, carry):
        """One gulp into the integration `carry` ((acc, frames
        integrated)) -> (emitted integrations, carry')."""
        ntime = xm.shape[0]
        return integrate_chunks(
            lambda k0, k1: xengine(xm if k1 - k0 == ntime else xm[k0:k1],
                                   self._g),
            ntime, carry, self.nframe_per_integration)

    def on_data(self, ispan, ospan):
        xm = self._voltages(ispan.data)
        ntime, nchan, nsp = xm.shape
        if self._acc is None and self.nframe_integrated == 0 and \
                ntime == self.nframe_per_integration:
            # One whole integration: the product lands in the span.
            xengine(xm, self._g, out=ospan.data.view(nchan, nsp, nsp))
            return 1
        outs, carry = self._integrate(xm, (self._acc,
                                           self.nframe_integrated))
        self._acc, self.nframe_integrated = carry
        if outs:
            store(ospan, outs[0].reshape(1, nchan, self._nstand, self._npol,
                                         self._nstand, self._npol))
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

    def device_kernel_carry(self):
        """The integrator step(x, carry, consts) -> (the emitted
        visibility frames or None, carry'): this block's gulp code on
        the same chunks (ci8 storage is lifted as this block lifts it).
        Valid after on_sequence."""
        def step(x, carry, consts):
            xm = self._voltages(x)
            outs, carry = self._integrate(xm, carry)
            if not outs:
                return None, carry
            shape = (1, xm.shape[1], self._nstand, self._npol,
                     self._nstand, self._npol)
            return torch.cat([o.reshape(shape) for o in outs]), carry
        return step

    def fused_carry_init(self):
        """(acc, frames integrated): the start of an integration."""
        return (None, 0)

    def fused_carry_consts(self):
        """No constants: the staged gains live on the block
        (re-staged by set_gains at the next gulp boundary)."""
        return ()


def correlate(iring, nframe_per_integration, *args, **kwargs):
    """Cross-multiply stations and integrate in time, the X engine of an
    FX correlator (reference blocks/correlate.py:111-142)."""
    return CorrelateBlock(iring, nframe_per_integration, *args, **kwargs)
