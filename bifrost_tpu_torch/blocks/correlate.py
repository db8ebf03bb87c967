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
pipeline.

The mesh (bifrost_tpu/blocks/correlate.py:621-780): under a `mesh=`
scope the gulp (its storage form, as above) is sharded over the mesh's
'time' and 'freq' axes (`shard=` maps other labels); each shard runs the
block's engine on its local block (X1 a shard with `engine='int8'` on
the card, the f32 product otherwise) and 'freq' shards never
communicate.  With `mesh_defer_reduce` (the default, latched per
sequence) every gulp's per-shard partial visibilities are carried
across the integration with shape-strict adds, no collective, and the
one psum over 'time' runs at the emit (`mesh_chain_plan`,
`_CorrelateMeshPlan`, which pipeline.MeshFusedBlock also drives across a
fused accumulate tail); with it off each gulp's engine psums at once
(`_xengine_mesh`, the collective-count baseline).  Under a mesh the
gulp must divide the integration.  A geometry no mesh axis divides runs
the single-device engine.  Gains fold per shard before the psum.

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
from ..parallel.collective import psum, strict_add
from ..parallel.shard import contiguous, mesh_axes_for, shard_views
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

    # Under the async executor the worker reserves this block's output
    # (its commit may shrink on a gulp), except that the exact
    # `output_nframes_for_gulp` below restores the reserve-ahead
    # (pipeline.py, async_reserve_ahead).
    async_reserve_ahead = False

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
        self._perm, self._role_labels = _canonical_permutation(
            itensor.get("labels"))
        if self._perm[0] != 0:
            raise ValueError(
                "correlate: the frame (streaming) axis must be time, got "
                f"labels {itensor['labels']}")
        self._dtype = iseq.tensor.dtype
        mesh = self.bound_mesh
        if mesh is not None:
            # Latched before the gulp checks below read gulp_nframe: the
            # validated and the executed gulp stay one, and a carried
            # partial cannot change reduction discipline mid-stream.
            self._hold_flag_latch("mesh_gulp_factor")
            self._hold_flag_latch("mesh_defer_reduce")
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
        if mesh is not None and self.nframe_per_integration % gulp_actual:
            # The sharded engines take whole gulps: a mid-gulp split
            # would re-chunk each shard's local time contraction.
            raise ValueError(
                f"gulp_nframe ({gulp_actual}) does not divide "
                f"nframe_per_integration ({self.nframe_per_integration}) "
                f"under a mesh scope; set gulp_nframe= on the correlate "
                f"block")
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
        self._mesh_plan = None
        if mesh is not None:
            from .. import config
            if config.get("mesh_defer_reduce"):
                self._mesh_plan = self.mesh_chain_plan()
        return ohdr

    def mesh_chain_plan(self):
        """The deferred-reduction plan (the mesh-fusion protocol of
        pipeline.MeshFusedBlock): per-shard partial visibilities carried
        across gulps, one psum at each emit.  Valid after on_sequence."""
        return _CorrelateMeshPlan(self)

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

    def _prepare(self, x, raw):
        """A gulp (`x` on the block's device, complex-integer storage
        form when `raw`) -> (the engine's input in canonical (time, freq,
        station*pol[, 2]) order, its X1 form or None)."""
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
        return xs, fmt

    def _mesh_axes(self, mesh, shape):
        """(tax, fax) of a gulp of `shape` over `mesh`.  strict="axes":
        only the time and freq role labels are mapped; a scope-wide
        shard= override naming other labels falls through, an unknown
        mesh axis raises."""
        return tuple(mesh_axes_for(mesh, self._role_labels[:2],
                                   self.shard_labels, shape=shape[:2],
                                   strict="axes"))

    def _chunks(self, x, raw):
        """A gulp -> (the engine over frames [k0, k1), frames, nchan):
        the sharded engine under a mesh scope (psum per call), else the
        single-device one."""
        xs, fmt = self._prepare(x, raw)
        ntime, nchan = xs.shape[0], xs.shape[1]
        mesh = self.bound_mesh

        def engine(k0, k1, out=None):
            xk = xs if k1 - k0 == ntime else xs[k0:k1]
            if mesh is not None:
                tax, fax = self._mesh_axes(mesh, xk.shape)
                if tax is not None or fax is not None:
                    fn = _xengine_mesh(mesh, tax, fax, self.engine,
                                       self._g is not None, fmt,
                                       self._xmethod)
                    args = (xk,) if self._g is None else (xk, self._g)
                    return self.mesh_dispatch(fn, *args, mesh=mesh)
            if self.engine == "int8":
                return self._x8(xk, fmt, out)
            return xengine(xk, self._g, out=out)
        return engine, ntime, nchan

    def _emit_shape(self, nchan):
        return (1, nchan, self._nstand, self._npol, self._nstand,
                self._npol)

    def on_data(self, ispan, ospan):
        x, raw = self._read(ispan)
        if self._mesh_plan is not None:
            # Deferred reduction: one collective-free sharded step per
            # gulp; the one psum runs at the emit.
            plan = self._mesh_plan
            plan.step(self, x, raw)
            self.nframe_integrated += ispan.nframe
            if self.nframe_integrated >= self.nframe_per_integration:
                store(ospan, plan.emit(self))
                self.nframe_integrated = 0
                return 1
            return 0
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
            if self._mesh_plan is not None:
                self._mesh_plan.reset()

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


def _xengine_local(x, engine, gains=None, fmt=None, method="cuda"):
    """One shard's visibilities (lchan, nsp, nsp) complex64 from its
    local block `x` (canonical storage of X1 form `fmt`, or complex):
    the block's single-device engine, X1 on the card for 'int8'."""
    if engine == "int8":
        if fmt is None:
            x, fmt = int8_pairs(x), "ci8"
        if method == "plain":
            v = xengine_int8_plain(x, fmt)
        else:
            v = xengine_int8(contiguous(x), fmt)
        return v if gains is None else fold_int8_gains(v, gains)
    return xengine(x, gains)


def _gains_on(gains, x):
    return gains if gains is None or gains.device == x.device \
        else gains.to(x.device)


def _xengine_mesh(mesh, tax, fax, engine="f32", with_gains=False, fmt=None,
                  method="cuda"):
    """The per-gulp-psum mesh X-engine: fn(xm[, gains]) -> (nchan, nsp,
    nsp) on xm's device.  Each distinct shard of xm (sharded (tax, fax)
    on its time and freq axes) runs `_xengine_local`, gains folded per
    shard, then one psum over `tax` (none without one); 'freq' shards
    never communicate."""
    def run(xm, *g):
        gains = g[0] if with_gains else None
        v = shard_views(mesh, xm, (tax, fax)).map(
            lambda x: _xengine_local(x, engine, _gains_on(gains, x), fmt,
                                     method), spec=(fax, None, None))
        return psum(v, tax).assemble(device=xm.device)
    return run


def _xengine_mesh_partial(mesh, tax, fax, engine="f32", with_acc=False,
                          with_gains=False, fmt=None, method="cuda"):
    """The deferred mesh X-engine: fn(xm[, gains][, acc]) -> per-shard
    partial visibilities (a ShardValues of (1, lchan, nsp, nsp), spec
    (tax, fax, None, None)), no collective; with `with_acc` the gulp's
    partials are added to the carried `acc` with shape-strict adds, so a
    partial carried across a mesh re-factor faults."""
    def run(xm, *rest):
        gains = rest[0] if with_gains else None
        p = shard_views(mesh, xm, (tax, fax)).map(
            lambda x: _xengine_local(x, engine, _gains_on(gains, x), fmt,
                                     method)[None],
            spec=(tax, fax, None, None))
        return rest[-1].add(p) if with_acc else p
    return run


class _CorrelateMeshPlan(object):
    """Deferred-reduction state of the mesh X-engine (the mesh-fusion
    protocol driven by CorrelateBlock's own deferred path and by
    pipeline.MeshFusedBlock).  `step(owner, x, raw)` folds one gulp into
    the per-shard partials with one collective-free sharded dispatch
    (`owner.mesh_dispatch`, so the collective watchdog and the fault
    seams guard it); `emit(owner)` runs the one deferred psum and
    returns the output frame.  A geometry no mesh axis divides runs the
    single-device engine with a replicated length-1 carry.  `owner` is
    the dispatching block (the fused group when fused)."""

    def __init__(self, block):
        self.block = block      # the CorrelateBlock (roles, engine, gains)
        self.pacc = None        # carried partials
        self.nchan = None
        self._axes = None       # (tax, fax) the carry was built under

    def reset(self):
        self.pacc = None
        self._axes = None

    def step(self, owner, x, raw):
        b = self.block
        xs, fmt = b._prepare(x, raw)
        self.nchan = xs.shape[1]
        mesh = owner.bound_mesh
        axes = b._mesh_axes(mesh, xs.shape)
        if self.pacc is not None and axes != self._axes:
            # The geometry changed under a carried partial (an eviction
            # re-factored the mesh): mixing layouts would be wrong, so
            # fault into the supervised restart, which sheds it.
            raise RuntimeError(
                f"{owner.name}: mesh axes changed mid-integration "
                f"({self._axes} -> {axes}); shedding the carried partial "
                f"via supervised restart")
        tax, fax = axes
        g = b._g
        if tax is None and fax is None:
            v = (b._x8(xs, fmt) if b.engine == "int8"
                 else xengine(xs, g))[None]
            self.pacc = v if self.pacc is None \
                else strict_add(self.pacc, v)
        else:
            fn = _xengine_mesh_partial(mesh, tax, fax, b.engine,
                                       with_acc=self.pacc is not None,
                                       with_gains=g is not None, fmt=fmt,
                                       method=b._xmethod)
            args = (xs,) + ((g,) if g is not None else ())
            if self.pacc is not None:
                args += (self.pacc,)
            self.pacc = owner.mesh_dispatch(fn, *args, mesh=mesh)
        self._axes = axes
        return self.pacc

    def emit(self, owner):
        """The deferred reduction: one psum when 'time' is sharded, none
        on a freq-only mesh -> one output frame (1, nchan, nstand, npol,
        nstand, npol)."""
        tax, fax = self._axes
        if tax is None and fax is None:
            v = self.pacc[0]
        else:
            from ..parallel import fuse
            mesh = owner.bound_mesh
            v = owner.mesh_dispatch(
                fuse.make_reduce(mesh, tax, (fax, None, None)), self.pacc,
                mesh=mesh)
        self.reset()
        return v.reshape(self.block._emit_shape(self.nchan))


def correlate(iring, nframe_per_integration, *args, **kwargs):
    """Cross-multiply stations and integrate in time, the X engine of an
    FX correlator (reference blocks/correlate.py:111-142)."""
    return CorrelateBlock(iring, nframe_per_integration, *args, **kwargs)
