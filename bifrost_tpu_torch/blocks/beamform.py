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
re-stage at the next gulp boundary.

The mesh (bifrost_tpu/blocks/beamform.py:533-745): under a `mesh=` scope
the gulp is sharded over the mesh's 'time' and 'freq' axes, a station
mesh axis (the station label mapped to one, e.g. `shard={'station':
'stand'}`) and a 'beam' axis the beam count divides, which shards the
weights instead.  The route is chosen by layout and logged on the
`<name>/beamform_plan` ProcLog (`route`, `route_reason`):

- 'k4_per_shard' (no station axis): each distinct shard runs the block's
  resolved `beamform_method` (kernel K4 on the card) on its local block
  and weight slice, as the single-device block does on the whole gulp;
- 'stand_matmul' (a station axis): the coherent sum over stations must
  come before detection, which K4 fuses in, so each shard forms complex
  partial beams by complex `torch.matmul` (TF32 off; the JAX package
  computes this with jnp outside Pallas), the partials psum over the
  station axis, then detect and integrate.

With `mesh_defer_reduce` (the default, latched per sequence) the
per-shard partial powers are carried across the integration and the one
psum over 'time' runs at the emit (`mesh_chain_plan`,
`_BeamformMeshPlan`, also driven by pipeline.MeshFusedBlock across a
fused accumulate tail); with it off every gulp psums at once
(`_bengine_mesh`).  'freq' and 'beam' never communicate.  Under a mesh
the gulp must divide the integration.  A geometry no mesh axis divides
runs the single-device engine.

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
from ..ops.beamform import tiled_power
from ..ops.calibrate import fold_gains, resolve_gains
from ..ops.unpack import unpack_pairs
from ..parallel.collective import psum, strict_add
from ..parallel.shard import (NamedSharding, ShardedTensor, contiguous,
                              mesh_axes_for, shard_views)
from ..pipeline import TransformBlock
from ._common import (_canonical_permutation, deepcopy_header,
                      integrate_chunks, store)


class BeamformBlock(TransformBlock):

    # Under the async executor the worker reserves this block's output
    # (its commit may shrink on a gulp), except that the exact
    # `output_nframes_for_gulp` below restores the reserve-ahead
    # (pipeline.py, async_reserve_ahead).
    async_reserve_ahead = False

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
        mesh = self.bound_mesh
        if mesh is not None:
            # Latched before the gulp checks read gulp_nframe; a carried
            # partial cannot change reduction discipline mid-stream.
            self._hold_flag_latch("mesh_gulp_factor")
            self._hold_flag_latch("mesh_defer_reduce")
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
        if mesh is not None and self.nframe_per_integration % gulp_actual:
            # The sharded engines take whole gulps: a mid-gulp split would
            # re-chunk each shard's local time contraction.
            raise ValueError(
                f"gulp_nframe ({gulp_actual}) does not divide "
                f"nframe_per_integration ({self.nframe_per_integration}) "
                f"under a mesh scope; set gulp_nframe= on the beamform "
                f"block")
        # Resolve the method once per sequence and latch the config flag.
        self.bf.method = self.method if self.method is not None else "auto"
        self.bf.method = self.bf._resolve()
        self._hold_flag_latch("beamform_method")
        # Stage the (folded) weights on the device once per sequence; under
        # a mesh they are laid out over beams and stations (`_wspec`).
        self._wspec = (None, None)
        if mesh is not None:
            _, _, sax, bax = self._mesh_axes(mesh, gulp_actual, shape[1])
            self._wspec = (bax, sax)
        self._stage_weights()
        self._mesh_plan = None
        route, reason = "k4", "no mesh scope"
        if mesh is not None:
            from .. import config
            if config.get("mesh_defer_reduce"):
                self._mesh_plan = self.mesh_chain_plan()
            axes = self._mesh_axes(mesh, gulp_actual, shape[1])
            route, reason = _mesh_route(axes)
        if not hasattr(self, "_plan_proclog"):
            from ..proclog import ProcLog
            self._plan_proclog = ProcLog(f"{self.log_name}/beamform_plan")
        self.bf._runtime.publish_proclog(self._plan_proclog, extra={
            "method": self.bf.method, "origin": self.bf.weights_origin,
            "nbeam": self.nbeam,
            "nframe_per_integration": self.nframe_per_integration,
            "cal_folded": self._gvec is not None,
            "mask_folded": self._mvec is not None,
            "route": route, "route_reason": reason})
        return ohdr

    def _stage_weights(self):
        self.bf.set_weights(self._weff, device=self.device)
        mesh = self.bound_mesh
        self._wdev = None if mesh is None else ShardedTensor(
            self.bf.weights, NamedSharding(mesh, self._wspec))

    def mesh_chain_plan(self):
        """The deferred-reduction plan (the mesh-fusion protocol of
        pipeline.MeshFusedBlock): per-shard partial powers carried
        across gulps, one psum over 'time' at each emit.  Valid after
        on_sequence."""
        return _BeamformMeshPlan(self)

    def _mesh_axes(self, mesh, ntime, nchan):
        """(tax, fax, sax, bax) of a gulp over `mesh`: the time, freq and
        station role labels' mesh axes (the station axis checked on the
        station count; it shards the flat station*pol axis, whose
        stand-major order keeps a station subset contiguous) and the beam
        axis where the beam count divides it.  strict="axes": other
        labels of a scope-wide shard= fall through, an unknown mesh axis
        raises."""
        tax, fax, sax = mesh_axes_for(
            mesh, self._role_labels[:3], self.shard_labels,
            shape=(ntime, nchan, self._nstand), strict="axes")
        bax = mesh_axes_for(mesh, ["beam"], self.shard_labels,
                            shape=(self.nbeam,), strict="axes")[0]
        return tax, fax, sax, bax

    def _mesh_input(self, x, raw):
        """A gulp -> the canonical (time, freq, station*pol) complex64
        gulp, or its ci8 (re, im) storage with `raw`."""
        if raw:
            if self._dtype.nbit == 4:
                x = unpack_pairs(x, self._dtype)
            if self._perm != [0, 1, 2, 3]:
                x = x.permute(tuple(self._perm) + (4,))
            return x.reshape(x.shape[0], x.shape[1], -1, 2)
        if self._dtype.is_complex and self._dtype.is_integer:
            x = complex_view(x, self._dtype)
        elif not x.is_complex():
            x = x.to(torch.complex64)
        if self._perm != [0, 1, 2, 3]:
            x = x.permute(self._perm)
        return x.reshape(x.shape[0], x.shape[1], -1)

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
        self._stage_weights()
        self.gain_updates += 1

    def _integrate(self, x, raw, carry):
        """One gulp into the integration `carry` ((acc, frames
        integrated)): `x` the logical input, or with `raw` its ci8 ring
        storage -> (emitted integrations, carry', nchan)."""
        if self._dq_pending:
            self._restage_weights()
        nframe = x.shape[0]
        mesh = self.bound_mesh
        if mesh is not None:
            xm = self._mesh_input(x, raw)
            nchan = xm.shape[1]

            def engine(k0, k1):
                xk = xm if k1 - k0 == nframe else xm[k0:k1]
                axes = self._mesh_axes(mesh, xk.shape[0], nchan)
                if axes == (None, None, None, None):
                    return self._single(xk)
                return self.mesh_dispatch(
                    _bengine_mesh(mesh, *axes, method=self.bf.method),
                    xk, self._wdev, mesh=mesh)
        elif raw:
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

    def _single(self, xm):
        """The single-device engine on a canonical gulp."""
        if xm.is_complex():
            return self.bf.execute(xm)
        return self.bf._power(contiguous(xm))

    def _read(self, ispan):
        """-> (the gulp, whether it is ci8/ci4 ring storage): a 'cuda'
        ring's complex-integer span is read raw and counted."""
        raw = ispan.data_storage
        if raw is not None:
            self._raw_reads += 1
            self._raw_read_nbyte += raw.numel() * raw.element_size()
            return raw, True
        return ispan.data, False

    def on_data(self, ispan, ospan):
        x, raw = self._read(ispan)
        if self._mesh_plan is not None:
            # Deferred reduction: one sharded step per gulp with no
            # collective over 'time'; the one psum runs at the emit.
            plan = self._mesh_plan
            plan.step(self, x, raw)
            self.nframe_integrated += ispan.nframe
            if self.nframe_integrated >= self.nframe_per_integration:
                store(ospan, plan.emit(self))
                self.nframe_integrated = 0
                return 1
            return 0
        outs, carry, nchan = self._integrate(
            x, raw, (self._acc, self.nframe_integrated))
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


def _mesh_route(axes):
    """(route, reason) of the mesh B-engine for mesh axes (tax, fax, sax,
    bax)."""
    tax, fax, sax, bax = axes
    if sax is not None:
        return ("stand_matmul",
                f"station axis {sax!r}: the coherent sum over stations "
                f"comes before detection, which K4 fuses in")
    if axes == (None, None, None, None):
        return ("k4", "no mesh axis divides the gulp: single-device engine")
    return ("k4_per_shard",
            f"time={tax!r} freq={fax!r} beam={bax!r}: shards detect and "
            f"integrate on their own")


def _bengine_local(x, w, method):
    """One shard's integrated powers (lbeam, lchan): the block's engine
    (K4 on the card under 'cuda') on its local block and weights."""
    return tiled_power(contiguous(x), contiguous(w), method)


def _partial_beams(x, w):
    """One shard's complex partial beams (ltime, lchan, lbeam) over its
    local stations, by complex matmul with TF32 off."""
    if not x.is_complex():
        x = torch.complex(x[..., 0].float(), x[..., 1].float())
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(x, w.T)


def _detect_integrate(beams):
    """|b|^2 summed over the frames: (ltime, lchan, lbeam) -> (lbeam,
    lchan) f32."""
    return (beams.real * beams.real + beams.imag * beams.imag) \
        .sum(dim=0).T


def _bengine_powers(mesh, xm, w, tax, fax, sax, bax, method):
    """Every position's integrated powers (lbeam, lchan), spec (bax,
    fax), before the reduction over 'time'."""
    xs = shard_views(mesh, xm, (tax, fax, sax))
    ws = shard_views(mesh, w, (bax, sax))
    if sax is None:
        return ws.zip_map(lambda wl, x: _bengine_local(x, wl, method), xs,
                          spec=(bax, fax))
    beams = psum(ws.zip_map(lambda wl, x: _partial_beams(x, wl), xs), sax)
    return beams.map(_detect_integrate, spec=(bax, fax))


def _bengine_mesh(mesh, tax, fax, sax=None, bax=None, method="cuda"):
    """The per-gulp-psum mesh B-engine: fn(xm, w) -> (nbeam, nchan) on
    xm's device, one psum over `tax` (none without one)."""
    def run(xm, w):
        p = _bengine_powers(mesh, xm, w, tax, fax, sax, bax, method)
        return psum(p, tax).assemble(device=xm.device)
    return run


def _bengine_mesh_partial(mesh, tax, fax, sax=None, bax=None,
                          with_acc=False, method="cuda"):
    """The deferred mesh B-engine: fn(xm, w[, acc]) -> per-shard partial
    powers (a ShardValues of (1, lbeam, lchan), spec (tax, bax, fax)),
    no collective over 'time' (the station psum of the 'stand_matmul'
    route is coherent and stays per gulp); with `with_acc` added to the
    carried partial with shape-strict adds."""
    def run(xm, w, *acc):
        p = _bengine_powers(mesh, xm, w, tax, fax, sax, bax, method).map(
            lambda v: v[None], spec=(tax, bax, fax))
        return acc[0].add(p) if with_acc else p
    return run


class _BeamformMeshPlan(object):
    """Deferred-reduction state of the mesh B-engine: the correlate
    plan's shape (blocks/correlate.py), with the staged weights riding
    each step.  `owner` is the dispatching block (the fused group when
    fused)."""

    def __init__(self, block):
        self.block = block
        self.pacc = None        # carried partial powers
        self.nchan = None
        self._axes = None       # (tax, fax, sax, bax) the carry uses

    def reset(self):
        self.pacc = None
        self._axes = None

    def step(self, owner, x, raw):
        b = self.block
        if b._dq_pending:
            b._restage_weights()
        xm = b._mesh_input(x, raw)
        self.nchan = xm.shape[1]
        mesh = owner.bound_mesh
        axes = b._mesh_axes(mesh, xm.shape[0], xm.shape[1])
        if self.pacc is not None and axes != self._axes:
            raise RuntimeError(
                f"{owner.name}: mesh axes changed mid-integration "
                f"({self._axes} -> {axes}); shedding the carried partial "
                f"via supervised restart")
        if axes == (None, None, None, None):
            p = b._single(xm)[None]
            self.pacc = p if self.pacc is None \
                else strict_add(self.pacc, p)
        else:
            fn = _bengine_mesh_partial(mesh, *axes,
                                       with_acc=self.pacc is not None,
                                       method=b.bf.method)
            args = (xm, b._wdev) if self.pacc is None \
                else (xm, b._wdev, self.pacc)
            self.pacc = owner.mesh_dispatch(fn, *args, mesh=mesh)
        self._axes = axes
        return self.pacc

    def emit(self, owner):
        """The deferred reduction: one psum when 'time' is sharded, none
        on a freq-, beam- or station-only mesh -> one output frame (1,
        nbeam, nchan)."""
        if self._axes == (None, None, None, None):
            p = self.pacc[0]
        else:
            from ..parallel import fuse
            tax, fax, sax, bax = self._axes
            mesh = owner.bound_mesh
            p = owner.mesh_dispatch(fuse.make_reduce(mesh, tax, (bax, fax)),
                                    self.pacc, mesh=mesh)
        self.reset()
        return p.reshape(1, self.block.nbeam, self.nchan)


def beamform(iring, weights, nframe_per_integration, *args, **kwargs):
    """Beamform station/pol inputs into integrated beam powers (the
    phased-array B engine) on kernel K4; ci8 'cuda' rings are read in raw
    storage form."""
    return BeamformBlock(iring, weights, nframe_per_integration, *args,
                         **kwargs)
