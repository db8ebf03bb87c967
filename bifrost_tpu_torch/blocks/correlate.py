"""Correlate block: the X step of an FX correlator (counterpart of the
single-device f32 engine of bifrost_tpu/blocks/correlate.py; reference
python/bifrost/blocks/correlate.py).

Per channel c, over the frames of an integration,

    v[c, i, j] = sum_t conj(x[t, c, i]) * x[t, c, j]

with i, j running over station x pol.

Engines (`engine=`):

- 'f32' (default): the complex product above, one batched complex
  `torch.matmul` a gulp (cuBLAS CGEMM on the card) with TF32 off, as the
  JAX package runs it at Precision.HIGHEST outside any Pallas kernel.
- 'int8': the exact integer X-engine for <= 8-bit voltage streams, the
  JAX package's production configuration for ci8/ci4 captures
  (bifrost_tpu/blocks/correlate.py:90-105).  The voltages become int8
  (re, im) planes (a float input is cast as JAX's ``astype(int8)``
  casts: truncated, NaN to 0, saturated to [-128, 127]) and kernel X1
  (ops/xengine_kernel.py, csrc/xengine.cu) sums ``rr + ii`` and ``ri -
  ir`` exactly in int32 per gulp, then f32; integrations spanning gulps
  add the f32 chunks (`integrate_chunks`).  A gulp must stay below
  65,536 frames, where 2 * 128^2 * T reaches 2^31.  Gains fold after
  the integer planes, ``G_ij = conj(g_i) g_j`` on the f32 planes in the
  JAX order.  The `xengine_method` config flag ('auto'/'cuda'/'plain')
  picks X1 or its plain version, latched per sequence.

A gulp that is one whole integration is written straight into the output
span.  A gulp is split at integration boundaries, mid-gulp where the
integration length is not a multiple of the gulp (`integrate_chunks`),
and the partial sum carries across gulps.

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
``matrix_fill_mode`` 'full'.  A 'cuda' ring carrying ci8 or packed ci4
is read in raw storage form (`ReadSpan.data_storage`, 2 or 1 B/sample),
permuted to canonical order when the header's is another, and handed to
X1 as it lies (the 'f32' engine lifts it to complex64).  A host ring's
gulp is staged onto the block's device first (in storage form for a
complex-integer stream), so the engine runs on the card in a card
pipeline.  Not ported: the mesh engines (ROADMAP A16).

Fusion: the visibility integration is an accumulate carry, so the block
joins fused groups (fuse.py) as an integrator stage whose step is this
block's own gulp code on the same chunks, on ring storage through
`device_kernel_carry_raw`.
"""

from __future__ import annotations

import copy as _copy
import threading
import warnings

import numpy as np
import torch

from ..ndarray import complex_view
from ..ops.calibrate import resolve_gains
from ..ops.runtime import staged_unpack_canonical
from ..ops.xengine_kernel import xengine_int8, xengine_int8_plain
from ..pipeline import TransformBlock
from ._common import (_canonical_permutation, deepcopy_header,
                      integrate_chunks, store)

# The int32 exactness ceiling of the int8 engine: T * 2 * 128^2 < 2^31.
INT8_MAX_GULP = 2 ** 31 // (2 * 128 ** 2)


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


def int8_pairs(x):
    """Complex voltages -> int8 (re, im) pairs, cast as JAX's
    ``astype(int8)`` casts a float: truncated toward zero, NaN to 0,
    saturated to [-128, 127]."""
    p = torch.stack([x.real, x.imag], dim=-1)
    return torch.nan_to_num(p.trunc(), nan=0.0).clamp(-128, 127) \
        .to(torch.int8)


def fold_int8_gains(v, g):
    """The int8 engine's gain fold: v'_ij = G_ij v_ij with G_ij =
    conj(g_i) g_j, on the f32 planes in the JAX order (each product and
    sum rounded on its own)."""
    gr, gi = g.real, g.imag
    Gr = gr[:, None] * gr[None, :] + gi[:, None] * gi[None, :]
    Gi = gr[:, None] * gi[None, :] - gi[:, None] * gr[None, :]
    vr, vi = v.real, v.imag
    return torch.complex(vr * Gr[None] - vi * Gi[None],
                         vr * Gi[None] + vi * Gr[None])


class CorrelateBlock(TransformBlock):

    def output_nframes_for_gulp(self, rel_frame0, in_nframe):
        """Exact emit schedule: one output frame for each integration
        boundary the gulp crosses."""
        n = self.nframe_per_integration
        return [(rel_frame0 + in_nframe) // n - rel_frame0 // n]

    def __init__(self, iring, nframe_per_integration, *args, engine="f32",
                 gains=None, gain_callback=None, cal_header_key="cal_gains",
                 **kwargs):
        """engine: 'f32' or 'int8' (module docstring).  gains,
        gain_callback, cal_header_key: per-station or per-station*pol
        complex gains folded into the voltages (module docstring)."""
        super().__init__(iring, *args, **kwargs)
        if engine not in ("f32", "int8"):
            raise ValueError(f"unknown correlate engine {engine!r}")
        self.engine = engine
        self.nframe_per_integration = nframe_per_integration
        self.gains = None if gains is None \
            else np.asarray(gains, dtype=np.complex64).reshape(-1)
        self.gain_callback = gain_callback
        self.cal_header_key = cal_header_key
        self._dq_pending = False
        self._pending_gains = None
        self._dq_lock = threading.Lock()
        self.gain_updates = 0
        self._xmethod = None

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
        if self.engine == "int8":
            if gulp_actual >= INT8_MAX_GULP:
                raise ValueError(
                    f"engine='int8': gulp depth {gulp_actual} >= "
                    f"{INT8_MAX_GULP} frames can overflow the int32 "
                    f"in-gulp accumulator at full-range voltages; use a "
                    f"smaller gulp_nframe (cross-gulp accumulation is f32 "
                    f"and unaffected)")
            from .. import config
            m = config.get("xengine_method")
            self._xmethod = "cuda" if m == "auto" else m
            if self._xmethod not in ("cuda", "plain"):
                raise ValueError(f"unknown xengine_method {m!r} (expected "
                                 f"auto/cuda/plain)")
            self._hold_flag_latch("xengine_method")
        self._raw_reads = 0        # gulps read in raw storage form
        self._raw_read_nbyte = 0   # bytes those reads covered
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
        if self._dtype.is_complex and self._dtype.is_integer:
            x = complex_view(x, self._dtype)
        elif not x.is_complex():
            x = x.to(torch.complex64)
        if self._perm != [0, 1, 2, 3]:
            x = x.permute(self._perm)
        ntime, nchan, nstand, npol = x.shape
        return x.reshape(ntime, nchan, nstand * npol)

    def _storage(self, raw):
        """Raw ring storage in header order -> the int8 engine's input:
        canonical (time, freq, station*pol) storage, contiguous, and its
        X1 form: ('ci8', int8 (re, im) pairs) or ('ci4', packed uint8
        bytes)."""
        dt = self._dtype
        perm = list(self._perm)
        if dt.nbit >= 8:
            perm.append(4)
        if perm != sorted(perm):
            raw = raw.permute(perm)
        raw = raw.contiguous()
        t, c = raw.shape[0], raw.shape[1]
        if dt.nbit < 8:
            return "ci4", raw.reshape(t, c, -1)
        if raw.dtype != torch.int8:
            raw = raw.to(torch.int8)      # as JAX's astype(int8) wraps
        return "ci8", raw.reshape(t, c, -1, 2)

    def _x8(self, x, fmt, out=None):
        """One chunk through the int8 engine: X1 (or its plain version,
        per the latched `xengine_method`), then the gain fold."""
        if self._g is not None:
            out = None
        if self._xmethod == "plain":
            v = xengine_int8_plain(x, fmt, out)
        else:
            v = xengine_int8(x.contiguous(), fmt, out)
        return v if self._g is None else fold_int8_gains(v, self._g)

    def _count_raw(self, x):
        """Count one gulp read in raw storage form from a 'cuda' ring."""
        self._raw_reads += 1
        self._raw_read_nbyte += x.numel() * x.element_size()

    def _read(self, ispan):
        """-> (the gulp on the block's device, whether it is in
        complex-integer storage form).  A 'cuda' ring's span is read raw
        and counted; a host ring's gulp is staged onto the block's
        device, as the FDMT and flagger blocks stage theirs."""
        raw = ispan.data_storage
        if raw is not None:
            self._count_raw(raw)
            return raw, True
        x = ispan.data
        if x.device != torch.device(self.device):
            x = x.to(self.device)
        return x, self._dtype.is_complex and self._dtype.is_integer

    def _chunks(self, x, raw):
        """A gulp (`x` on the block's device, complex-integer storage
        form when `raw`) -> (the engine over frames [k0, k1), frames,
        nchan)."""
        if self._dq_pending:
            self._apply_pending_gains()
        if raw:
            if self.engine == "int8":
                fmt, xs = self._storage(x)
            else:
                re, im = staged_unpack_canonical(x, self._dtype, self._perm)
                xs, fmt = torch.complex(re, im), None
                xs = xs.reshape(xs.shape[0], xs.shape[1], -1)
        else:
            xs, fmt = self._voltages(x), None
        if self.engine == "int8" and fmt is None:
            xs, fmt = int8_pairs(xs), "ci8"
        ntime, nchan = xs.shape[0], xs.shape[1]

        def engine(k0, k1, out=None):
            xk = xs if k1 - k0 == ntime else xs[k0:k1]
            if self.engine == "int8":
                return self._x8(xk, fmt, out)
            return xengine(xk, self._g, out=out)
        return engine, ntime, nchan

    def _emit_shape(self, nchan):
        return (1, nchan, self._nstand, self._npol, self._nstand,
                self._npol)

    def on_data(self, ispan, ospan):
        x, raw = self._read(ispan)
        engine, ntime, nchan = self._chunks(x, raw)
        nsp = self._nstand * self._npol
        if self._acc is None and self.nframe_integrated == 0 and \
                ntime == self.nframe_per_integration:
            # One whole integration: the product lands in the span (on
            # the engine's device; a host span takes a copy).
            out = ospan.data.view(nchan, nsp, nsp)
            v = engine(0, ntime, out if out.device == x.device else None)
            if v.data_ptr() != out.data_ptr():
                out.copy_(v)
            return 1
        outs, carry = integrate_chunks(
            engine, ntime, (self._acc, self.nframe_integrated),
            self.nframe_per_integration)
        self._acc, self.nframe_integrated = carry
        if outs:
            store(ospan, outs[0].reshape(self._emit_shape(nchan)))
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
            if raw:
                self._count_raw(x)
            engine, ntime, nchan = self._chunks(x, raw)
            outs, carry = integrate_chunks(engine, ntime, carry,
                                           self.nframe_per_integration)
            if not outs:
                return None, carry
            return torch.cat([o.reshape(self._emit_shape(nchan))
                              for o in outs]), carry
        return step

    def device_kernel_carry(self):
        """The integrator step(x, carry, consts) -> (the emitted
        visibility frames or None, carry') on a logical gulp: this
        block's gulp code on the same chunks.  Valid after
        on_sequence."""
        return self._step(False)

    def device_kernel_carry_raw(self, dtype):
        """The same on complex-integer ring storage (ci8 pairs, packed
        ci4), read as the unfused block's raw path reads it."""
        return self._step(True)

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
