"""Map block: mini-language expressions as a first-class pipeline stage
(counterpart of bifrost_tpu/blocks/map.py; reference: bf.map applied
per-gulp in user blocks; here the expression IS the block).

Runs the planned `ops.map.Map`: `method=` (None reads the `map_method`
config flag, LATCHED for the sequence) selects kernel M1, one CUDA
kernel generated from the expression and built by nvcc, for a 'cuda'
input ring, or the plain PyTorch engine (what 'auto' gives on a host
ring).  M1 takes every streaming form, forward and unbounded time
indexing on its element path, and inlines straight-line ``extra_code``
helpers; where the generator refuses the program (a helper it cannot
inline), 'auto' runs the plain engine and says why; what the kernel
does not implement raises at on_sequence (ops/map_codegen.py
`Unsupported`).  The resolved method, the generator's
refusal, the fusion form and the cache accounting land on the
`<name>/map_plan` proclog channel (the fir_plan pattern), with M1's V
and the note of a build that spilled.  M1 is built
in `on_sequence`, so the first gulp (and the deadman watching it) does
not wait for nvcc; a respec's replacement builds it earlier, in
`preflight`, so that a failed build raises in the respec, which rolls
back.

The output type and shape come from the plain engine run on a probe of
max(2, noffset + 1) frames on the 'meta' device (the CPU where a
function has no meta kernel), as the JAX block derives them with
``jax.eval_shape``; M1's inferred output type must equal it (checked).

Fusion (fuse.py): elementwise and time-local programs expose
``device_kernel`` and join `device_chain` groups.  Expressions indexing
bounded NEGATIVE time offsets (``y(i) = x(i) - x(i-1)``) expose the
``device_kernel_carry`` stencil form instead: a (max_offset)-frame
input-history tail threads between gulps via the fused-carry protocol,
so stencil maps join `stateful_chain` groups with split gulps bitwise
== one long gulp.  Forward (``x(i+1)``) or unbounded (``x(n-1-i)``)
time indexing is refused from fusion (reason ``map_unbounded_index``)
and the block runs per-gulp with GULP-LOCAL index semantics
(``n<axis>`` = the gulp's frame count): one M1 launch a gulp.  A fused map is its unfused
twin's code on the same operands: bitwise, with the same M1 launches.

Raw int8 ingest: complex-integer streams are read in their ring storage
form (ci8 pairs, packed ci4 bytes), which M1 reads in the kernel and
the plain engine lifts exactly; `_raw_reads`/`_raw_read_nbyte` count
the gulps read so from a 'cuda' ring (fused or not).

Layout: the frame (streaming) axis must lead; scalars bind by value or,
when given as a STRING, resolve from the sequence header at
on_sequence (so per-observation constants ride the header).
"""

from __future__ import annotations

import numpy as np
import torch

from ..DataType import DataType
from ..ops.map import Map, _torch_dtype
from ..pipeline import TransformBlock
from ._common import deepcopy_header


def _logical_dtype(dt):
    """The numpy dtype of the logical value of a ring DataType
    (complexified ci*, byte-expanded packed ints), as the JAX block's."""
    if dt.is_complex:
        if dt.is_integer:
            return np.dtype(np.complex64 if dt.nbit <= 16
                            else np.complex128)
        return np.dtype(np.complex64 if dt.nbit <= 32 else np.complex128)
    if dt.nbit < 8:
        return np.dtype(np.int8 if dt.kind == "i" else np.uint8)
    return np.dtype(dt.as_numpy_dtype())


class MapBlock(TransformBlock):

    async_reserve_ahead = False
    exact_output_nframes = True

    # ------------------------------------------- stateful_chain protocol
    fused_carry_warmup_nframe = 0   # zero initial history, like unfused
    fused_carry_stride = 1

    def __init__(self, iring, func, *args, axis_names=None, scalars=None,
                 in_name=None, shape=None, extra_code=None, method=None,
                 **kwargs):
        """func: mini-language program (last statement's lhs streams
        out).  axis_names: index names for explicit forms, time axis
        first.  scalars: name -> value bindings; a STRING value names a
        sequence-header key resolved per sequence.  in_name: the
        streaming input's name (inferred when unambiguous).  shape:
        output non-frame shape for explicit forms (defaults to the
        input's).  method: None resolves the `map_method` config flag
        per sequence ('auto'/'cuda'/'plain')."""
        super().__init__(iring, *args, **kwargs)
        self.method = method
        self._header_scalars = {}
        init_scalars = {}
        for k, v in (scalars or {}).items():
            if isinstance(v, str):
                self._header_scalars[k] = v
                init_scalars[k] = 0.0   # placeholder until on_sequence
            else:
                init_scalars[k] = v
        self.op = Map(func, in_name=in_name, scalars=init_scalars,
                      axis_names=axis_names, extra_code=extra_code,
                      method=method)
        self._out_chan_shape = tuple(int(s) for s in shape) \
            if shape is not None else None
        self._carry = None
        self._raw_reads = 0
        self._raw_read_nbyte = 0
        # The fusion surface is decided by the program's classified
        # time-access form (instance attributes: fuse.py's planner runs
        # hasattr checks BEFORE any sequence exists).
        form = self.op.fuse_form
        if form in ("elementwise", "local"):
            self.device_kernel = self._map_device_kernel
        elif form == "stencil":
            self.device_kernel_carry = self._map_device_kernel_carry
            self.device_kernel_carry_raw = self._map_device_kernel_carry_raw
            self.fused_carry_init = self._map_fused_carry_init
            self.fused_carry_consts = self._map_fused_carry_consts
        else:  # forward / unbounded time indexing: per-gulp only
            self.fuse_refusal_reason = "map_unbounded_index"

    def define_output_nframes(self, input_nframe):
        return [input_nframe]

    def output_nframes_for_gulp(self, rel_frame0, in_nframe):
        return [in_nframe]

    def _probe(self, probe):
        """The plain engine's output (dtype, non-frame shape) on a
        `probe`-frame input: on 'meta', or on the CPU where a function
        has no meta kernel."""
        last = None
        for dev in ("meta", "cpu"):
            try:
                x = torch.zeros((probe,) + self._in_chan_shape,
                                dtype=self._ltorch, device=dev)
                carry = self.op.carry_init(self._in_chan_shape,
                                           self._ltorch, device=dev) \
                    if self.op.fuse_form == "stencil" else None
                ocs = self._out_chan_shape if self._out_chan_shape \
                    is not None else self._in_chan_shape
                y, _ = self.op._plain_eval(x, carry, ocs, self.op.scalars)
                if not isinstance(y, torch.Tensor) or y.dim() < 1 or \
                        y.shape[0] != probe:
                    raise ValueError(
                        f"{self.name}: the program's value is not a "
                        f"stream of {probe} frames "
                        f"({getattr(y, 'shape', y)!r})")
                return y.dtype, tuple(int(s) for s in y.shape[1:])
            except (NotImplementedError, RuntimeError) as exc:
                last = exc
        raise last

    @staticmethod
    def _input_form(itensor):
        """-> (DataType, channel shape, storage form?, the Map's dtype
        key, rank) of an input sequence's tensor header.  Complex
        integers and packed types arrive in storage form, which M1 reads
        as it lies and the plain engine lifts."""
        idt = DataType(itensor["dtype"])
        chan = tuple(int(s) for s in itensor["shape"][1:])
        storage = (idt.is_complex and idt.is_integer) or idt.nbit < 8
        return (idt, chan, storage,
                str(idt) if storage else idt.as_torch_dtype(), 1 + len(chan))

    def _data_device_of(self):
        """The gulps are computed where the input ring holds them."""
        return torch.device(self.device) if self.iring.space == "cuda" \
            else torch.device("cpu")

    def preflight(self, iseq):
        """Build M1 for input sequence `iseq` before the block runs: a
        respec's replacement (service.Service.respec), whose input is
        its predecessor's open sequence."""
        _, _, storage, dkey, rank = self._input_form(iseq.header["_tensor"])
        self.op.method = self.method if self.method is not None else "auto"
        self.op.prepare(dkey, rank, self._out_chan_shape, raw=storage,
                        device=self._data_device_of())

    def on_sequence(self, iseq):
        ihdr = iseq.header
        itensor = ihdr["_tensor"]
        if itensor["shape"][0] != -1:
            raise ValueError(
                f"map: the frame (streaming) axis must lead (time-first), "
                f"got shape {itensor['shape']}")
        idt, self._in_chan_shape, self._storage, self._dkey, self._rank = \
            self._input_form(itensor)
        self._idt = idt
        self._ldtype = _logical_dtype(idt)
        self._ltorch = _torch_dtype(self._ldtype)
        if self._header_scalars:
            scal = dict(self.op.scalars)
            for k, hk in self._header_scalars.items():
                if hk not in ihdr:
                    raise ValueError(
                        f"{self.name}: header key {hk!r} bound to map "
                        f"scalar {k!r} is missing from the sequence header")
                scal[k] = ihdr[hk]
            self.op.set_scalars(scal)
        out_chan = self._out_chan_shape if self._out_chan_shape is not None \
            else self._in_chan_shape
        if self.op.explicit:
            nax = len(self.op.compiled.axis_names)
            if nax != 1 + len(out_chan):
                raise ValueError(
                    f"{self.name}: {nax} axis names for a rank-"
                    f"{1 + len(out_chan)} output {(-1,) + tuple(out_chan)}")
        # Resolve the engine ONCE per sequence and latch the config flag
        # (the fir_method latch contract).
        self.op.method = self.method if self.method is not None else "auto"
        self._data_device = self._data_device_of()
        resolved = self.op._resolve(self._dkey, self._rank,
                                    self._out_chan_shape, self._data_device)
        self.op.method = resolved
        self._hold_flag_latch("map_method")
        out_dtype, out_chan = self._probe(max(2, self.op.noffset + 1))
        prog = None
        if resolved == "cuda":
            prog = self.op.program(self._dkey, self._rank,
                                   self._out_chan_shape)
            if prog.out_dtypes[0] != out_dtype:
                raise RuntimeError(
                    f"{self.name}: the kernel generator infers "
                    f"{prog.out_dtypes[0]} for {self.op.func_string!r}, "
                    f"the plain engine gives {out_dtype}")
            # Build M1 now: an nvcc run inside the first gulp would count
            # against the deadman.
            self.op.prepare(self._dkey, self._rank, self._out_chan_shape,
                            raw=self._storage, device=self._data_device)
        # Carry reset on EVERY sequence entry (supervised restarts
        # included) — the stencil starts from zero history again.
        self._carry = None
        self._raw_reads = 0        # gulps read in raw int storage form
        self._raw_read_nbyte = 0   # bytes those reads covered
        ohdr = deepcopy_header(ihdr)
        ot = ohdr["_tensor"]
        ot["dtype"] = str(DataType(np.dtype(
            torch.empty(0, dtype=out_dtype).numpy().dtype)))
        if out_chan != self._in_chan_shape:
            ot["shape"] = [-1] + list(out_chan)
            # The input's axis metadata no longer describes the output.
            if self.op.explicit and \
                    len(self.op.compiled.axis_names) == 1 + len(out_chan):
                ot["labels"] = list(self.op.compiled.axis_names)
            elif ot.get("labels") is not None:
                ot["labels"] = None
            for k in ("scales", "units"):
                if ot.get(k) is not None:
                    ot[k] = None
        if not hasattr(self, "_plan_proclog"):
            from ..proclog import ProcLog
            self._plan_proclog = ProcLog(f"{self.log_name}/map_plan")
        self.op._runtime.publish_proclog(self._plan_proclog, extra={
            "method": resolved,
            "origin": "host",
            "fuse_form": self.op.fuse_form,
            "stencil_noffset": self.op.noffset,
            "statements": len(self.op.statements),
            "codegen_refusal": self.op.codegen_refusal or "",
            # M1's samples a thread on its vector path, and why a spilling
            # build cut it ("" where it did not)
            "vec": prog.vec if prog is not None else 0,
            "vec_note": (prog.vec_note or "") if prog is not None else "",
        })
        return ohdr

    def _apply(self, x, carry, out=None):
        """One gulp in its ring storage form -> (y, carry'): the plan's
        step, the unfused and the fused gulp's code alike."""
        if self._storage:
            if self.op.fuse_form == "stencil":
                return self.op.execute_carry_raw(x, str(self._idt), carry,
                                                 self._out_chan_shape, out)
            return self.op.execute_raw(x, str(self._idt),
                                       self._out_chan_shape, out), None
        if self.op.fuse_form == "stencil":
            return self.op.execute_carry(x, carry, self._out_chan_shape, out)
        return self.op.execute(x, self._out_chan_shape, out), None

    def _count_raw(self, raw):
        self._raw_reads += 1
        self._raw_read_nbyte += raw.numel() * raw.element_size()

    def on_data(self, ispan, ospan):
        n = ispan.nframe
        if n == 0:
            return 0
        x = ispan.data
        if ispan.data_storage is not None:
            self._count_raw(x)
        if self.op.fuse_form == "stencil" and self._carry is None:
            self._carry = self._map_fused_carry_init(x.device)
        _, self._carry = self._apply(x, self._carry, out=ospan.data)
        return n

    # --------------------------------------------- device_chain protocol
    def _map_device_kernel(self):
        """fn(x) -> y for the fusion compiler's device_chain rule on the
        stage's storage-form input: the plan's own step, so fused chains
        are bitwise the unfused gulp path.  Valid after on_sequence."""
        def step(x):
            if self._storage:
                self._count_raw(x)
            return self._apply(x, None)[0]
        return step

    # ------------------------------------------- stateful_chain protocol
    def _map_device_kernel_carry(self):
        """fused stage f(x, carry, consts) -> (y, carry') for the
        stateful_chain rule.  Valid after on_sequence."""
        def step(x, carry, consts):
            return self._apply(x, carry)
        return step

    def _map_device_kernel_carry_raw(self, dtype):
        """The same on complex-integer ring storage (ci8 pairs, packed
        ci4), counted as the unfused block counts its raw reads."""
        def step(raw, carry, consts):
            self._count_raw(raw)
            return self._apply(raw, carry)
        return step

    def _map_fused_carry_init(self, device=None):
        """Fresh zero noffset-frame input history (logical type)."""
        return self.op.carry_init(self._in_chan_shape, self._ltorch,
                                  device=device if device is not None
                                  else self.device)

    def _map_fused_carry_consts(self):
        """Scalars are read by the plan at each call, so no per-sequence
        constants thread through the group."""
        return ()

    def plan_report(self):
        """The plan's runtime accounting (ops/runtime.py schema + the map
        specifics)."""
        return self.op.plan_report()


def map_block(iring, func, *args, **kwargs):
    """User mini-language expression as a pipeline stage (the planned,
    fuse-eligible form of :func:`bifrost_tpu_torch.ops.map.map`):
    elementwise and time-local programs join fused device chains;
    bounded ``x(i-k)`` stencils carry a history tail between gulps."""
    return MapBlock(iring, func, *args, **kwargs)
