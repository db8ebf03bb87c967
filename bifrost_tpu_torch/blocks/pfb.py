"""PFB channelizer block: the F-engine's front half as a streaming stage
(counterpart of bifrost_tpu/blocks/pfb.py:98-256).

Runs the planned `ops.pfb.Pfb`: `method=` (None reads the `pfb_method`
config flag, latched for the sequence) selects kernel K2 or its plain
version for the MAC; the DFT matmuls are shared; the (ntap-1)-frame
history carries between gulps inside the plan, so split gulps are
bitwise equal to one long gulp.

ci8/ci4 ingest: a 'cuda' ring carrying ci8 is read in raw storage form
(`ReadSpan.data_storage`, 2 B/sample), which the MAC kernel reads as it
lies; packed ci4 (1 B/sample) is unpacked to that form first.  The
channelized gulp is written straight into the output span.

Layout: the frame (streaming) axis must be time and must lead; every
other axis is a stream sharing the prototype.  Output: [-1, nchan,
...stream...] complex64 with a new 'freq' axis after time, the time
scale coarsened by nchan and the freq axis anchored at the header's
`cfreq`.  gulp_nframe must be a multiple of nchan; trailing frames of a
final partial gulp that do not fill a spectrum are dropped with a
warning.

Fusion: the block declares the fused-carry protocol, so a fused group
(fuse.py) threads the (ntap-1)-spectrum history through its carry step,
the plan's own `step`/`step_raw` with the history passed in.

The mesh: under a `mesh=` scope the gulp is sharded over the time
label's mesh axis (where it divides the gulp's spectra and every shard
holds the ntap-1 spectra of history): each time shard runs the MAC (K2)
and the DFT on its own frames, from the last ntap-1 folded frames of the
shard before it (`parallel.collective.halo`, one collective-permute a
gulp; the first shard from the carried history), as a guarded dispatch.
The same MAC rows in the same order as the whole gulp, so bitwise it.
The JAX block has no mesh code: XLA partitions its jitted program.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..DataType import DataType
from ..ndarray import complex_view
from ..ops.pfb import Pfb
from ..parallel.collective import halo
from ..parallel.shard import mesh_axes_for, shard_views
from ..pipeline import TransformBlock
from ..units import convert_units, transform_units
from ._common import deepcopy_header, store


class PfbBlock(TransformBlock):

    # Under the async executor the worker reserves this block's output
    # (its commit may shrink on a gulp), except that the exact
    # `output_nframes_for_gulp` below restores the reserve-ahead
    # (pipeline.py, async_reserve_ahead).
    async_reserve_ahead = False

    def __init__(self, iring, nchan, ntap=4, coeffs=None, window="hamming",
                 *args, method=None, **kwargs):
        """nchan: channels per spectrum (one output spectrum per nchan
        input frames).  ntap/window: prototype filter geometry
        (ops.pfb.pfb_coeffs) unless explicit `coeffs` ((ntap, nchan) or
        flat ntap*nchan) are given.  method: None resolves the
        `pfb_method` config flag per sequence ('auto'/'cuda'/'plain')."""
        super().__init__(iring, *args, **kwargs)
        self.nchan = int(nchan)
        self.ntap = int(ntap)
        self.coeffs = None if coeffs is None \
            else np.asarray(coeffs, dtype=np.float64)
        self.window = window
        self.method = method
        self.pfb = Pfb()

    def define_output_nframes(self, input_nframe):
        return [input_nframe // self.nchan]

    def output_nframes_for_gulp(self, rel_frame0, in_nframe):
        """Exact emit schedule: one spectrum per nchan input frames, the
        remainder of a final partial gulp dropped."""
        return [in_nframe // self.nchan]

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        if itensor["shape"][0] != -1:
            raise ValueError(
                f"pfb: the frame (streaming) axis must lead (time-first), "
                f"got shape {itensor['shape']}")
        if self.bound_mesh is not None:
            # The gulp checked below is the gulp the loop reads.
            self._hold_flag_latch("mesh_gulp_factor")
        gulp_actual = self.gulp_nframe or ihdr.get("gulp_nframe", 1)
        if gulp_actual % self.nchan:
            raise ValueError(
                f"gulp_nframe ({gulp_actual}) must be a multiple of "
                f"nchan ({self.nchan}); set gulp_nframe= on the pfb block")
        self._dtype = DataType(itensor["dtype"])
        # Resolve the method once per sequence and latch the config flag.
        self.pfb.method = self.method if self.method is not None else "auto"
        self.pfb.init(self.nchan, coeffs=self.coeffs, ntap=self.ntap,
                      window=self.window)
        self.pfb.method = self.pfb._resolve()
        self._hold_flag_latch("pfb_method")
        self._raw_reads = 0        # gulps read in raw int storage form
        self._raw_read_nbyte = 0   # bytes those reads covered
        self._dropped_tail = 0
        chan_shape = itensor["shape"][1:]
        self._nstream = int(np.prod(chan_shape)) if chan_shape else 1
        self._ncomp = 2 if self._dtype.is_complex else 1
        ohdr = deepcopy_header(ihdr)
        ot = ohdr["_tensor"]
        ot["dtype"] = "cf32"
        ot["shape"] = [-1, self.nchan] + list(itensor["shape"][1:])
        labels = itensor.get("labels")
        self._time_label = labels[0] if labels else "time"
        if labels is not None:
            ot["labels"] = [labels[0], "freq"] + list(labels[1:])
        scales = itensor.get("scales")
        units = itensor.get("units")
        tscale = None
        if scales is not None and scales[0] is not None:
            tscale = list(scales[0])
        funit = None
        if units is not None and units[0] is not None:
            funit = transform_units(units[0], -1)
        if scales is not None:
            # The new freq axis is anchored at the stream's `cfreq` when
            # the header has one, so the FDMT sees sky frequencies.
            f0 = 0.0
            cf = ihdr.get("cfreq")
            if cf is not None and funit is not None:
                f0 = convert_units(cf, ihdr.get("cfreq_units"), funit)
            fscale = [f0, 1.0 / (tscale[1] * self.nchan)] \
                if tscale and tscale[1] else [f0, 0]
            new_t = [tscale[0], tscale[1] * self.nchan] if tscale else None
            ot["scales"] = [new_t, fscale] + list(scales[1:])
        if units is not None:
            ot["units"] = [units[0], funit] + list(units[1:])
        if ihdr.get("gulp_nframe"):
            ohdr["gulp_nframe"] = max(ihdr["gulp_nframe"] // self.nchan, 1)
        return ohdr

    def _whole(self, nframe):
        """The frames of an `nframe` gulp that fill whole spectra: a
        final partial gulp's remainder has no output slot and is dropped,
        with a warning."""
        n = (nframe // self.nchan) * self.nchan
        if n < nframe:
            self._dropped_tail = nframe - n
            warnings.warn(
                f"{self.name}: dropping {self._dropped_tail} trailing "
                f"frame(s) not filling a spectrum at sequence end",
                stacklevel=1)
        return n

    def _mesh_tax(self, mesh, nspec):
        """The time label's mesh axis for a gulp of `nspec` spectra, where
        it divides them and each shard holds the ntap-1 spectra of
        history; else None (the whole gulp at once)."""
        tax = mesh_axes_for(mesh, [self._time_label], self.shard_labels,
                            shape=(nspec,), strict="axes")[0]
        if tax is not None and nspec // mesh.shape[tax] < self.pfb.ntap - 1:
            return None
        return tax

    def _run_shards(self, xf, nstream, ncomp, chan_shape, out, mesh, tax):
        """One folded gulp over the time shards of `mesh` (module
        docstring), into `out`."""
        xs = shard_views(mesh, xf, (tax,))
        ai = mesh.axis_names.index(tax)
        first = {}
        for flat in range(mesh.size):
            c = mesh.coords(flat)
            if not any(v for i, v in enumerate(c) if i != ai):
                first[c[ai]] = xs.values[flat]
        shards = [first[k] for k in range(mesh.shape[tax])]
        self.pfb.run_shards(shards, halo(shards, self.pfb.ntap - 1),
                            nstream, ncomp, chan_shape, out)

    def on_data(self, ispan, ospan):
        n = self._whole(ispan.nframe)
        if n == 0:
            return 0
        out = ospan.data[:n // self.nchan]
        raw = ispan.data_storage
        mesh = self.bound_mesh
        tax = None if mesh is None else self._mesh_tax(mesh, n // self.nchan)
        if raw is not None:
            raw = raw[:n]
            self._raw_reads += 1
            self._raw_read_nbyte += raw.numel() * raw.element_size()
            if tax is None:
                self.pfb.execute_raw(raw, str(self._dtype), out=out)
            else:
                xf, nstream, chan_shape = self.pfb.fold_raw(
                    raw, str(self._dtype))
                self.mesh_dispatch(self._run_shards, xf, nstream, 2,
                                   chan_shape, out, mesh, tax, mesh=mesh)
        else:
            x = ispan.data[:n]
            if self._dtype.is_complex and self._dtype.is_integer:
                x = complex_view(x, self._dtype)
            if tax is None:
                store(ospan, self.pfb.execute(x))
            else:
                self.mesh_dispatch(self._run_shards, *self.pfb.fold(x), out,
                                   mesh, tax, mesh=mesh)
        return n // self.nchan

    def plan_report(self):
        """The plan's runtime accounting (ops/runtime.py schema +
        channelizer config)."""
        return self.pfb.plan_report()

    # ------------------------------------------- fused-carry protocol
    # No warm-up: the channelizer starts from a zero history fused and
    # unfused alike.
    fused_carry_warmup_nframe = 0

    @property
    def fused_carry_stride(self):
        """Input frames per output frame."""
        return self.nchan

    def device_kernel_carry(self):
        """The fused stage step(x, history, consts) -> (y, history') on
        a logical gulp: the plan's `step`, the unfused gulp's code.
        Valid after on_sequence."""
        def step(x, state, consts):
            n = self._whole(x.shape[0])
            return (None, state) if n == 0 else \
                self.pfb.step(x[:n], state)
        return step

    def device_kernel_carry_raw(self, dtype):
        """The same on ci8 ring storage (the plan's `step_raw`, kernel
        K2 reading the voltages at 2 B/sample) or packed ci4 (unpacked
        to ci8 first); the history is shared with the logical form."""
        def step(raw, state, consts):
            n = self._whole(raw.shape[0])
            return (None, state) if n == 0 else \
                self.pfb.step_raw(raw[:n], dtype, state)
        return step

    def fused_carry_init(self):
        """A fresh zero (ntap-1)-spectrum history."""
        return self.pfb.init_state(self._nstream, self._ncomp, self.device)

    def fused_carry_consts(self):
        """The staged prototype and DFT matrices: the plan stages them
        once and its step reads them from its own cache."""
        return self.pfb.staged(self.device)


def pfb(iring, nchan, ntap=4, coeffs=None, window="hamming", *args,
        **kwargs):
    """Polyphase-filterbank channelizer (the F-engine front half): one
    critically-sampled nchan-point spectrum per nchan input frames, the
    ntap-frame windowed-sinc MAC (kernel K2) and the DFT matmuls, with
    the (ntap-1)-frame history carried between gulps."""
    return PfbBlock(iring, nchan, ntap, coeffs, window, *args, **kwargs)
