"""bf.map's code generator: one CUDA C++ kernel (M1) per user expression.

The JAX package translates a map program into one jnp closure and XLA
compiles it into one device program (bifrost_tpu/ops/map.py:421-511);
the reference it follows compiled one CUDA kernel per expression
through NVRTC (src/map.cpp).  Here `generate` walks the Python AST of
the TRANSLATED statements, ``ast.parse`` on what ``_translate_expr``
and ``_rewrite_indexing`` produced (ops/map.py), and emits one kernel
over ``csrc/map_common.cuh`` that computes every statement in registers.
It never re-parses the C, so the kernel inherits exactly the parse the
plain engine evaluates, quirks included (``&&`` becomes ``&``, which
binds tighter than ``<`` in Python: ROADMAP Queue C).

The kernel (`Program._source`, launched by ops/map_kernel.py, which says
why it is shaped so): each statement is a function of the output's
coordinates, templated on the index type I (32- or 64-bit, both
instantiated) and on PRE, whether the input values at those coordinates
come pre-loaded (`Pre`).  The elementwise and eager forms walk vector
items of V consecutive samples along the innermost (collapsed) axis
(`vec_load`: each input's raw words in one vector access; `vec_store`:
the statements on each sample, the outputs CH samples a store) and single elements (`elem_item`: the element path, the ragged
tail), both by a grid-stride loop; the local and stencil forms give a
thread a channel item (V consecutive channel samples, or one) on the
grid's x axis and runs of `Program.run` frames on its y axis
(`run_vec`, `run_elem`), the reads
``x(t - k)`` at the output's channels taken from a register window of
the last noffset frames.  Coordinates are decomposed by multiply-and-shift dividers the
launch packs (`div_magic`), never by a division.  `choose_vec` picks V;
a build that spills is redone with half of it (map_kernel).

Types.  Each node's type is what the plain engine's own operator gives
on representative values: the namespace function or Python operator is
applied to one-element tensors of the operands' dtypes (0-d tensors for
0-d values) and to Python scalars for weakly typed operands, so the
promotion rules are PyTorch's, which for these operators are JAX's:
``2.0*x`` on f32 stays f32, ``x*2`` on int8 stays int8 and wraps, ``/``
is true division (int -> f32), ``%`` and ``//`` floor, ``**`` is pow.
Subtrees of literals alone are evaluated with the plain namespace at
generation time and embedded exactly (a hex literal of the value the
plain engine computes on the CPU).  Scalars bound by name are run-time
parameters of the kernel (a new value needs no new build); sizes
``n<axis>`` are run-time too.  What the plain engine computes on the
host from scalars and sizes alone, where C arithmetic would not be
exact (Python's ``**`` and shifts, torch on 0-d CPU tensors, a 0-d
tensor bound as a scalar) is hoisted: the launch evaluates it with the
plain engine itself and passes the value (`Program.derive`).

f16 and bf16 are storage types (csrc/map_common.cuh): every operator
computes in f32 and rounds, as PyTorch's card kernels do; a CPU scalar
(a Python number or a 0-d CPU tensor) enters ``+``, ``-`` and ``*``
unrounded, as those kernels read it, and the other operators rounded
to the result type.  Complex transcendentals are computed in f64 and
rounded (not bitwise PyTorch's: a tolerance, stated in the tests).

Forms (`Map.fuse_form` and the eager call):

- ``elementwise``: one streaming input, no indexing; ranks above
  `MAX_RANK` collapse at launch (`map_kernel.collapse`);
- ``local``: explicit indexing, every time index the time axis itself;
  index expressions are computed per element with jnp's gather
  semantics (a negative index wraps once, then it is clamped);
  temporaries indexed at other coordinates are recomputed there (each
  statement is a function of the coordinates);
- ``stencil``: bounded negative time offsets, read from the
  ``noffset``-frame carry for ``t < k`` and from the gulp otherwise (two
  pointers, no concatenated copy); the same launch writes the next carry,
  the last ``noffset`` frames of ``[carry; gulp]``;
- ``eager``: the eager ``map()``'s broadcasting form, each input read
  through its own strides (0 on a broadcast axis), each statement
  written to an output of its own shape (once: an axis the output lacks
  at coordinate 0 only).

In every form a tensor of one axis or more bound as a scalar is a
constant array, read at the output's coordinates through its broadcast
strides (`Input.bcast`), and a statement that depends on no array is a
scalar (broadcast to the output grid in the explicit forms, as the
plain engine broadcasts it).

Refused by design, with the reason `Refusal` carries (the only forms
'auto' runs on the plain engine): ``extra_code`` (Python helpers have no
CUDA form), the eager explicit-index and scatter forms, and the
``forward`` and ``unbounded`` streaming forms.

`Unsupported`, with its reason (raised for a CUDA tensor whatever the
method): a type with no C form (complex32); an indexed form of rank
above `MAX_RANK`, and strides that cannot be collapsed to it.  Where
the plain engine itself raises on the program's types (complex ``%``,
``<``, min/max, rounding, erf; an index that is not an integer; a
chained comparison of arrays; ``not`` of an array), the generator
raises the same way.
"""

from __future__ import annotations

import ast
import hashlib
import re
import struct
import warnings
from collections import OrderedDict

import torch

MAX_RANK = 8
# The launch header, the first meta words (map_kernel.pack): n output
# elements, ncarry carry elements, the path (1 vector, 0 element), nd
# axes that are not padding (the elementwise and eager forms), nvec
# vector items (elementwise, eager), nci channel items and nruns frame
# runs (local, stencil), the input's channel extent and its divider (the
# stencil's carry).
HEADER = ("n", "ncarry", "vec", "nd", "nvec", "nci", "nruns", "chan",
          "chan_m", "chan_s")
BLOCK = 256
# Bytes a vector path may hold live a thread (V values of the widest
# logical type, or the stencil's window): the budget V is cut to.
VEC_BYTES = 256

C_TYPES = {
    torch.bool: "bool", torch.int8: "int8_t", torch.uint8: "uint8_t",
    torch.int16: "int16_t", torch.int32: "int32_t", torch.int64: "int64_t",
    torch.float32: "float", torch.float64: "double",
    torch.float16: "f16", torch.bfloat16: "bf16",
    torch.complex64: "cx<float>", torch.complex128: "cx<double>",
}
_HALF = (torch.float16, torch.bfloat16)
# Binary operators whose PyTorch card kernels read a CPU scalar operand
# straight into their f32 opmath, unrounded to the half type (the others,
# % and // and / among them, round it to the result type first).
_OPMATH_SCALAR = ("op_add", "op_sub", "op_mul")
PY_C = {bool: "bool", int: "long long", float: "double",
        complex: "cx<double>"}
_COMPLEX_PART = {torch.complex64: "float", torch.complex128: "double"}

# Storage forms of an input: 'real' and 'complex' tensors of the logical
# dtype, 'pair' complex-integer storage (integer component type with a
# trailing (re, im) axis), 'ci4' packed bytes, one sample a byte,
# 'cpacked' ci2/ci1, 8 // (2 nbit) samples a byte along the last axis,
# and 'packed' real storage, 8 // nbit samples a byte along the last axis.
STORAGES = ("real", "complex", "pair", "ci4", "cpacked", "packed")

_UNARY_MATH = {"exp": "std::exp", "log": "std::log", "log2": "std::log2",
               "log10": "std::log10", "sin": "std::sin", "cos": "std::cos",
               "tan": "std::tan", "asin": "std::asin", "acos": "std::acos",
               "atan": "std::atan", "sinh": "std::sinh",
               "cosh": "std::cosh", "tanh": "std::tanh",
               "sqrt": "msqrt", "rsqrt": "mrsqrt", "erf": "std::erf",
               "erfc": "std::erfc"}
_ROUNDING = {"floor": "mfloor", "ceil": "mceil", "round": "mrint",
             "rint": "mrint"}
# The complex forms (csrc/map_common.cuh, computed in f64).
_CX_MATH = {"exp": "mexp", "log": "mlog", "log2": "mlog2",
            "log10": "mlog10", "sin": "msin", "cos": "mcos", "tan": "mtan",
            "asin": "masin", "acos": "macos", "atan": "matan",
            "sinh": "msinh", "cosh": "mcosh", "tanh": "mtanh",
            "sqrt": "msqrt", "rsqrt": "mrsqrt"}
_BINOPS = {ast.Add: ("+", "op_add"), ast.Sub: ("-", "op_sub"),
           ast.Mult: ("*", "op_mul"), ast.Div: ("/", "op_div"),
           ast.FloorDiv: ("//", "op_floordiv"), ast.Mod: ("%", "op_mod"),
           ast.Pow: ("**", "op_pow"), ast.BitAnd: ("&", "op_and"),
           ast.BitOr: ("|", "op_or"), ast.BitXor: ("^", "op_xor"),
           ast.LShift: ("<<", "op_shl"), ast.RShift: (">>", "op_shr")}
_CMPOPS = {ast.Lt: "<", ast.LtE: "<=", ast.Gt: ">", ast.GtE: ">=",
           ast.Eq: "==", ast.NotEq: "!="}
_PYOPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
          ast.Mult: lambda a, b: a * b, ast.Div: lambda a, b: a / b,
          ast.FloorDiv: lambda a, b: a // b, ast.Mod: lambda a, b: a % b,
          ast.Pow: lambda a, b: a ** b, ast.BitAnd: lambda a, b: a & b,
          ast.BitOr: lambda a, b: a | b, ast.BitXor: lambda a, b: a ^ b,
          ast.LShift: lambda a, b: a << b, ast.RShift: lambda a, b: a >> b,
          ast.Lt: lambda a, b: a < b, ast.LtE: lambda a, b: a <= b,
          ast.Gt: lambda a, b: a > b, ast.GtE: lambda a, b: a >= b,
          ast.Eq: lambda a, b: a == b, ast.NotEq: lambda a, b: a != b}
# torch's float pow special-cases these scalar exponents (x*x for 2, ...).
# (The f16/bf16 operators round each product and quotient, as the card
# kernels' scalar_t arithmetic does.)
_POW_SPECIAL = {2.0: "({a} * {a})", 3.0: "({a} * {a} * {a})",
                0.5: "msqrt({a})", -0.5: "mrsqrt({a})",
                -1.0: "(({t})1 / {a})", -2.0: "(({t})1 / ({a} * {a}))"}
_CX_POW_SPECIAL = {2.0: "op_mul<{t}>({a}, {a})",
                   3.0: "op_mul<{t}>(op_mul<{t}>({a}, {a}), {a})",
                   0.5: "msqrt({a})", -0.5: "mrsqrt({a})",
                   -1.0: "op_div<{t}>({t}(1, 0), {a})",
                   -2.0: "op_div<{t}>({t}(1, 0), op_mul<{t}>({a}, {a}))"}


class Refusal(Exception):
    """A form the generator refuses by design (extra_code, the eager
    explicit-index and scatter forms, forward and unbounded streams):
    'auto' runs it on the plain engine.  `reason` says why."""

    @property
    def reason(self):
        return self.args[0]


class Unsupported(NotImplementedError):
    """What the kernel does not implement yet: raised for a CUDA tensor
    under either method (never a silent fall back to the plain engine).
    `reason` says what."""

    @property
    def reason(self):
        return self.args[0]


class Input(object):
    """One array the kernel reads: its name, storage form (`STORAGES`),
    logical torch dtype, logical rank, for a complex-integer storage its
    integer component type, for a packed storage its bits a field, and
    whether it is read whole at the output's coordinates through its
    broadcast strides (`bcast`: a constant array bound as a scalar)."""

    def __init__(self, name, storage, dtype, rank, int_dtype=None,
                 nbit=None, bcast=False):
        if storage not in STORAGES:
            raise ValueError(f"unknown storage form {storage!r}")
        self.name = name
        self.storage = storage
        self.dtype = dtype
        self.rank = int(rank)
        self.int_dtype = int_dtype
        self.nbit = nbit
        self.bcast = bool(bcast)

    @property
    def per_byte(self):
        """Samples a storage byte along the last axis (packed: 8 // nbit,
        cpacked: 8 // (2 nbit))."""
        if self.storage == "packed":
            return 8 // self.nbit
        if self.storage == "cpacked":
            return 4 // self.nbit
        return 1


def input_for(name, dtype_str, rank):
    """The `Input` of a stream of DataType string `dtype_str` read in its
    ring storage form, logical rank `rank` -> Input; raises Unsupported."""
    from ..DataType import DataType
    dt = DataType(dtype_str)
    if dt.is_complex and dt.is_integer:
        lt = torch.complex64 if dt.nbit <= 16 else torch.complex128
        if dt.nbit == 4:
            return Input(name, "ci4", lt, rank)
        if dt.nbit < 8:
            return Input(name, "cpacked", lt, rank, nbit=dt.nbit)
        return Input(name, "pair", lt, rank, dt.as_torch_dtype())
    if dt.nbit < 8:
        return Input(name, "packed", torch.int8 if dt.is_signed
                     else torch.uint8, rank, nbit=dt.nbit)
    return input_for_tensor(name, dt.as_torch_dtype(), rank)


def input_for_tensor(name, dtype, rank, bcast=False):
    """The `Input` of a logical tensor of torch `dtype`."""
    if dtype not in C_TYPES:
        raise Unsupported(f"{dtype}: no generated form for this type")
    return Input(name, "complex" if dtype.is_complex else "real", dtype,
                 rank, bcast=bcast)


# ------------------------------------------------------------ the values
class _Val(object):
    """A node's C expression `code`, its representative `rep` (a Python
    scalar for a weakly typed value, else a CPU tensor: 0-d for a 0-d
    value, one element for an array), whether it is a literal, and
    whether the plain engine holds it on the host (`host`: a Python
    scalar or a 0-d CPU tensor, computed from literals, run-time scalars
    and sizes alone)."""

    __slots__ = ("code", "rep", "const", "host")

    def __init__(self, code, rep, const=False, host=None):
        self.code = code
        self.rep = rep
        self.const = const
        self.host = const if host is None else host

    @property
    def is_tensor(self):
        return isinstance(self.rep, torch.Tensor)

    @property
    def dim0(self):
        return not self.is_tensor or self.rep.dim() == 0


def _ctype(dtype):
    ct = C_TYPES.get(dtype)
    if ct is None:
        raise Unsupported(f"{dtype}: no generated form for this type")
    return ct


def _float_lit(v):
    if v != v:
        return "NAN"
    if v in (float("inf"), float("-inf")):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    return v.hex()


def literal(value):
    """The exact C literal of a Python scalar or 0-d tensor value ->
    (code, rep)."""
    if isinstance(value, torch.Tensor):
        if value.dim() != 0:
            raise Unsupported("a constant array has no generated form")
        ct = _ctype(value.dtype)
        if value.dtype.is_complex:
            z = complex(value.item())
            part = _COMPLEX_PART[value.dtype]
            return (f"{ct}(({part}){_float_lit(z.real)}, "
                    f"({part}){_float_lit(z.imag)})"), value
        if value.dtype == torch.bool:
            return ("true" if bool(value) else "false"), value
        if value.dtype.is_floating_point:
            return f"(({ct}){_float_lit(float(value.item()))})", value
        return f"(({ct}){int(value.item())}LL)", value
    if isinstance(value, bool):
        return ("true" if value else "false"), value
    if isinstance(value, int):
        if not -2 ** 63 <= value < 2 ** 63:
            raise Unsupported(f"integer literal {value} exceeds 64 bits")
        return f"((long long){value}LL)", value
    if isinstance(value, float):
        return f"((double){_float_lit(value)})", value
    if isinstance(value, complex):
        return (f"cx<double>({_float_lit(value.real)}, "
                f"{_float_lit(value.imag)})"), value
    raise Unsupported(f"constant {value!r} has no generated form")


def _rep_of(dtype, dim0=False):
    return torch.ones((), dtype=dtype) if dim0 else \
        torch.ones(1, dtype=dtype)


def _ctype_of(rep):
    """The C type of a value of representative `rep`."""
    if isinstance(rep, torch.Tensor):
        return _ctype(rep.dtype)
    return PY_C[type(rep)]


# jnp.broadcast_to of a Python scalar (ops/map.py `_broadcast`): the
# default dtype of its kind.
_BROADCAST_DTYPE = {bool: torch.bool, int: torch.int32,
                    float: torch.float32, complex: torch.complex64}


def _value_dtype(rep):
    """The dtype an array holding a value of representative `rep` has."""
    if isinstance(rep, torch.Tensor):
        return rep.dtype
    return _BROADCAST_DTYPE[type(rep)]


def _rep_like(value):
    """A representative of a run-time weak scalar: the type, not the
    value, matters."""
    return {bool: True, int: 1, float: 1.0, complex: 1j}[type(value)]


class _Func(object):
    """The SSA lines of one generated function."""

    def __init__(self, gen):
        self.gen = gen
        self.lines = []

    def let(self, ctype, code):
        name = f"v{self.gen.counter}"
        self.gen.counter += 1
        self.lines.append(f"  const {ctype} {name} = {code};")
        return name


# ---------------------------------------------------------- the generator
class _Gen(object):
    def __init__(self, statements, form, axis_names, inputs, scalars,
                 noffset, ns, arrays, out_names):
        self.statements = statements
        self.form = form
        self.axis_names = tuple(axis_names or ())
        self.inputs = list(inputs)
        self.scalars = dict(scalars)
        self.noffset = int(noffset)
        self.ns = ns
        self.arrays = arrays
        self.out_names = list(out_names)
        self.counter = 0
        self.funcs = []              # C source of the statement functions
        self.stmt_types = []         # rep of each statement's value
        self.stmt_host = []          # whether the plain engine holds it
        # Values the plain engine computes on the host from scalars alone
        # (hoisted): (meta offset, expression, representative), evaluated
        # by the plain engine at each launch (`Program.derive`).
        self.derived = []
        # Meta layout (offsets into P::m), in the packing order of
        # map_kernel.pack.
        self.R = None
        self.scalar_slots = {}
        self.input_index = {inp.name: k for k, inp in enumerate(inputs)}
        self.bare_input = False      # a whole-array read in a local form
        # Whether a statement reads a coordinate or a size (then an
        # elementwise or eager call is not collapsed), and whether the
        # local or stencil form reads its input at its own channel
        # coordinates, x(t - k, <axes>) (the register window).
        self.uses_coords = False
        self.window = False
        self.two_d = form in ("local", "stencil")

    # ------------------------------------------------------- bindings
    def layout(self, rank):
        """The meta words (P::m) in map_kernel.pack's order: the launch
        header (`HEADER`), the output shape, the dividers by the item and
        element extents of axes 1..R-1 (and by the input's channel
        extents for the stencil's carry), each output's strides, each
        input's shape, strides, component stride, broadcast strides and
        vector mode, then the scalars."""
        self.R = rank
        off = len(HEADER)
        self.shape_off = off
        off += rank
        self.divi_off = off                # item extents (vector items)
        off += 2 * (rank - 1)
        self.dive_off = off                # element extents
        off += 2 * (rank - 1)
        self.divk_off = None
        if self.form == "stencil":
            self.divk_off = off            # the carry's channel extents
            off += 2 * (self.inputs[0].rank - 1)
        self.out_off = []
        for _ in self.out_names:
            self.out_off.append(off)
            # the eager form: a mask of the axes an output of a smaller
            # shape is written at coordinate 0 only
            off += rank + (self.form == "eager")
        self.in_off = []
        for inp in self.inputs:
            shape_off = off
            stride_off = off + inp.rank
            cs_off = stride_off + inp.rank
            off = cs_off + 1
            bs_off = None
            if self.form == "eager" or inp.bcast:
                bs_off = off
                off += rank
            self.in_off.append((shape_off, stride_off, cs_off, bs_off, off))
            off += 1                       # vector mode
        for name, v in self.scalars.items():
            if isinstance(v, torch.Tensor):
                continue                   # 0-d: hoisted (`_hoist`)
            self.scalar_slots[name] = off
            off += 2 if isinstance(v, complex) else 1
        self.nmeta = off
        self.nptr = len(self.inputs) + len(self.out_names) + 2

    def _env(self, upto):
        """name -> binding for statement `upto`'s rhs, in the order the
        plain engine's namespace is built (later entries win)."""
        env = {}
        for name, v in self.ns.items():
            if not callable(v):
                env[name] = ("const", v)
        for name, v in self.scalars.items():
            env[name] = ("scalar", v)
        for inp in self.inputs:
            env[inp.name] = ("input", inp)
        for d, ax in enumerate(self.axis_names):
            env[ax] = ("axis", d)
            env[f"n{ax}"] = ("size", d)
        for k in range(upto):
            env[self.statements[k][0]] = ("stmt", k)
        return env

    # ---------------------------------------------------------- loads
    def load(self, f, inp, idx, bare=False, window=None):
        """The value of input `inp` at logical index C array `idx`; a
        `bare` (whole-array) read is at the output coordinates, through
        the broadcast strides in the eager form.  On the vector path
        (PRE) a bare read of the elementwise and eager forms is the
        pre-loaded ``pre.in<k>``, and a read of frame ``t - window`` at
        the output's channels in the local and stencil forms is the
        register window's ``pre.w<window>``."""
        k = self.input_index[inp.name]
        ct = C_TYPES[inp.dtype]
        if window is not None:
            self.window = True
            mem = self._load_stencil(inp, idx, k) \
                if self.form == "stencil" else \
                self._ld(k, [f"{idx}[{d}]" for d in range(inp.rank)])
            return f.let(ct, f"PRE ? pre.w{window} : {mem}")
        if self.form == "stencil" and not inp.bcast:
            return f.let(ct, self._load_stencil(inp, idx, k))
        bs = self.in_off[k][3]
        pre = not self.two_d
        if bare and bs is not None:
            mem = self._ld(k, [f"c[{d}]" for d in range(self.R)], bs)
            return f.let(ct, f"PRE ? pre.in{k} : {mem}" if pre else mem)
        if bare and inp.rank != self.R:
            raise Unsupported(f"a whole-array read of {inp.name!r} (rank "
                              f"{inp.rank}) into a rank-{self.R} output")
        self.bare_input = self.bare_input or bare
        mem = self._ld(k, [f"{idx}[{d}]" for d in range(inp.rank)])
        if bare and pre:
            return f.let(ct, f"PRE ? pre.in{k} : {mem}")
        if bare and k == 0:
            # a whole-array read in the local form: frame t itself
            self.window = True
            return f.let(ct, f"PRE ? pre.w0 : {mem}")
        return f.let(ct, mem)

    def offset(self, k, terms, walk=None):
        """Input `k`'s storage offset (index type I) at the logical index
        C expressions `terms`, through its strides (or the broadcast
        strides at meta offset `walk`) -> (offset, position in the byte
        or None).  A packed storage addresses its last axis by byte: a
        shift and a mask of the index (samples a byte: a power of two)."""
        inp = self.inputs[k]
        st = self.in_off[k][1] if walk is None else walk
        if inp.storage in ("packed", "cpacked"):
            per = inp.per_byte
            sh = per.bit_length() - 1
            last = terms[-1]
            off = " + ".join(
                [f"(I)({t}) * (I)p.m[{st + d}]"
                 for d, t in enumerate(terms[:-1])] +
                [f"(I)((I)({last}) >> {sh}) * (I)p.m[{st + len(terms) - 1}]"])
            return off, f"(int)((I)({last}) & {per - 1})"
        off = " + ".join(f"(I)({t}) * (I)p.m[{st + d}]"
                         for d, t in enumerate(terms)) or "(I)0"
        return off, None

    def _ld(self, k, terms, walk=None):
        """Input `k`'s element at the logical index C expressions `terms`
        (one an axis), through its strides."""
        off, pos = self.offset(k, terms, walk)
        return self._ld_at(k, f"p.ptr[{k}]", f"({off})", pos)

    def _ld_at(self, k, ptr, off, pos):
        inp = self.inputs[k]
        if inp.storage == "packed":
            return (f"ld_packed<{C_TYPES[inp.dtype]}, {inp.nbit}>({ptr}, "
                    f"{off}, {pos})")
        if inp.storage == "cpacked":
            return (f"ld_cpacked<{_COMPLEX_PART[inp.dtype]}, {inp.nbit}>("
                    f"{ptr}, {off}, {pos})")
        if inp.storage == "real":
            return f"ld_real<{C_TYPES[inp.dtype]}>({ptr}, {off})"
        part = _COMPLEX_PART[inp.dtype]
        if inp.storage == "complex":
            return f"ld_cx<{part}>({ptr}, {off})"
        if inp.storage == "pair":
            cs = self.in_off[k][2]
            return (f"ld_pair<{part}, {C_TYPES[inp.int_dtype]}>({ptr}, "
                    f"{off}, (I)p.m[{cs}])")
        return f"ld_ci4<{part}>({ptr}, {off})"

    def vload(self, k, dst, off):
        """V consecutive samples of input `k` from storage offset `off`
        into the C array `dst` (one vector access, unpacked in
        registers)."""
        inp = self.inputs[k]
        ptr = f"p.ptr[{k}]"
        if inp.storage == "real":
            return f"vl_real<V>({dst}, {ptr}, {off})"
        if inp.storage == "packed":
            return (f"vl_packed<V, {C_TYPES[inp.dtype]}, {inp.nbit}>({dst}, "
                    f"{ptr}, {off})")
        part = _COMPLEX_PART[inp.dtype]
        if inp.storage == "complex":
            return f"vl_cx<V>({dst}, {ptr}, {off})"
        if inp.storage == "pair":
            return (f"vl_pair<V, {part}, {C_TYPES[inp.int_dtype]}>({dst}, "
                    f"{ptr}, {off})")
        if inp.storage == "cpacked":
            return f"vl_cpacked<V, {part}, {inp.nbit}>({dst}, {ptr}, {off})"
        return f"vl_ci4<V>({dst}, {ptr}, {off})"

    def vwords(self, k, vec):
        """Input `k`'s vector of `vec` samples as raw words -> (C type of
        its storage unit, bytes, the C expression of sample j of words
        {wd}, the first sample at position {pos} of its byte)."""
        inp = self.inputs[k]
        nb = max(1, int(storage_bytes(inp) * vec))
        # fewer samples than a byte holds: the item's position in it
        j = f"{{pos}} + j" if vec < inp.per_byte else "j"
        t = C_TYPES[inp.dtype]
        if inp.storage == "real":
            return t, nb, f"ex_real<{t}>({{wd}}, j)"
        if inp.storage == "packed":
            return "uint8_t", nb, f"ex_packed<{t}, {inp.nbit}>({{wd}}, {j})"
        part = _COMPLEX_PART[inp.dtype]
        if inp.storage == "complex":
            return t, nb, f"ex_cx<{part}>({{wd}}, j)"
        if inp.storage == "pair":
            it = C_TYPES[inp.int_dtype]
            return it, nb, f"ex_pair<{part}, {it}>({{wd}}, j)"
        if inp.storage == "cpacked":
            return ("uint8_t", nb,
                    f"ex_cpacked<{part}, {inp.nbit}>({{wd}}, {j})")
        return "uint8_t", nb, f"ex_ci4<{part}>({{wd}}, j)"

    def _load_stencil(self, inp, idx, k):
        """[carry; gulp] read through two pointers: history frame
        ``idx[0] < NOFF`` from the contiguous carry, else the gulp's
        frame ``idx[0] - NOFF``."""
        so = self.in_off[k][0]
        carry_off = f"(I){idx}[0]"
        for d in range(1, inp.rank):
            carry_off = f"({carry_off}) * (I)p.m[{so + d}] + (I){idx}[{d}]"
        carry_ld = ("ld_cx<{}>(p.ptr[CARRY_IN], {})".format(
            _COMPLEX_PART[inp.dtype], carry_off) if inp.dtype.is_complex
            else f"ld_real<{C_TYPES[inp.dtype]}>(p.ptr[CARRY_IN], "
                 f"{carry_off})")
        gulp_ld = self._ld(k, [f"({idx}[0] - NOFF)"] + [
            f"{idx}[{d}]" for d in range(1, inp.rank)])
        return f"(({idx}[0] < NOFF) ? {carry_ld} : {gulp_ld})"

    # ------------------------------------------------------ the walk
    def expr(self, f, node, env):
        meth = getattr(self, "_" + type(node).__name__, None)
        if meth is None:
            raise Unsupported(f"{type(node).__name__} ({ast.unparse(node)!r}) "
                          f"has no generated form")
        return meth(f, node, env)

    def _Expression(self, f, node, env):
        return self.expr(f, node.body, env)

    def _Constant(self, f, node, env):
        code, rep = literal(node.value)
        return _Val(code, rep, True)

    def _Name(self, f, node, env):
        b = env.get(node.id)
        if b is None:
            raise Unsupported(f"unbound name {node.id!r}")
        kind, v = b
        if kind == "const":
            code, rep = literal(v)
            return _Val(code, rep, True)
        if kind == "scalar":
            if isinstance(v, torch.Tensor):
                # a 0-d tensor: its value read at launch, as the plain
                # engine reads it (a CPU scalar when on the CPU)
                val = self._hoist(node, _rep_of(v.dtype, dim0=True))
                val.host = v.device.type == "cpu"
                return val
            off = self.scalar_slots[node.id]
            if isinstance(v, bool):
                code = f"(p.m[{off}] != 0)"
            elif isinstance(v, int):
                code = f"p.m[{off}]"
            elif isinstance(v, float):
                code = f"bits_f64(p.m[{off}])"
            elif isinstance(v, complex):
                code = (f"cx<double>(bits_f64(p.m[{off}]), "
                        f"bits_f64(p.m[{off + 1}]))")
            else:
                raise Unsupported(f"scalar {node.id!r} of type "
                              f"{type(v).__name__} has no generated form")
            return _Val(code, _rep_like(v), host=True)
        if kind == "axis":
            self.uses_coords = True
            pad = " + NOFF" if v == 0 and self.form == "stencil" else ""
            return _Val(f"((int32_t)(c[{v}]{pad}))", _rep_of(torch.int32))
        if kind == "size":
            self.uses_coords = True
            return _Val(f"p.m[{self.shape_off + v}]", 1, host=True)
        if kind == "input":
            if self.form == "stencil" and not v.bcast:
                raise Unsupported("a whole-array reference in a stencil")
            return _Val(self.load(f, v, "c", bare=True), _rep_of(v.dtype))
        # an earlier statement, at this element's coordinates
        rep = self.stmt_types[v]
        return _Val(f.let(_ctype_of(rep), f"s{v}<I, PRE>(p, c, pre)"), rep,
                    host=self.stmt_host[v])

    def _Subscript(self, f, node, env):
        if not isinstance(node.value, ast.Name):
            raise Unsupported(f"indexing {ast.unparse(node.value)!r}")
        b = env.get(node.value.id)
        if b is None or b[0] not in ("input", "stmt"):
            raise TypeError(f"map: indexing {node.value.id!r}, which is not "
                            f"an array")
        sl = node.slice
        idx_nodes = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        idx = [self.expr(f, n, env) for n in idx_nodes]
        for n, v in zip(idx_nodes, idx):
            dt = v.rep.dtype if v.is_tensor else type(v.rep)
            if dt in (bool, torch.bool) or dt in (float, complex) or \
                    (v.is_tensor and (dt.is_floating_point or
                                      dt.is_complex)):
                raise IndexError(f"map: index {ast.unparse(n)!r} is not "
                                 f"an integer")
        dim0 = all(v.dim0 for v in idx)
        name = f"g{self.counter}"
        self.counter += 1
        if b[0] == "input":
            inp = b[1]
            if len(idx) != inp.rank:
                raise IndexError(f"map: {inp.name!r} takes {inp.rank} "
                                 f"indices, got {len(idx)}")
            k = self.input_index[inp.name]
            so = self.in_off[k][0]
            dims = [f"(I)p.m[{so + d}]" for d in range(inp.rank)]
            if self.form == "stencil":
                dims[0] = f"((I)p.m[{so}] + NOFF)"
            f.lines.append(f"  const I {name}[{max(len(idx), 1)}] = {{" +
                           ", ".join(f"wrapclamp<I>({v.code}, {n})"
                                     for v, n in zip(idx, dims)) + "};")
            return _Val(self.load(f, inp, name,
                                  window=self._window_offset(k, idx_nodes)),
                        _rep_of(inp.dtype, dim0))
        k = b[1]                         # an earlier statement
        if len(idx) != self.R:
            raise IndexError(f"map: {node.value.id!r} takes {self.R} "
                             f"indices, got {len(idx)}")
        f.lines.append(f"  const I {name}[{self.R}] = {{" + ", ".join(
            f"wrapclamp<I>({v.code}, (I)p.m[{self.shape_off + d}])"
            for d, v in enumerate(idx)) + "};")
        rep = self.stmt_types[k]
        return _Val(f.let(C_TYPES[rep.dtype],
                          f"s{k}<I, false>(p, {name}, pre)"),
                    _rep_of(rep.dtype, dim0))

    def _window_offset(self, k, idx_nodes):
        """k in ``x(t - k, <axis 1>, ..., <axis R-1>)``: a read of the
        streaming input at the output's own channels, `k` frames back
        (0 in the local form), which the vector path takes from its
        register window; None for any other read."""
        if not self.two_d or k != 0 or self.inputs[0].bcast or \
                len(idx_nodes) != self.R or self.inputs[0].rank != self.R:
            return None
        for d in range(1, self.R):
            n = idx_nodes[d]
            if not (isinstance(n, ast.Name) and n.id == self.axis_names[d]):
                return None
        t = idx_nodes[0]
        taxis = self.axis_names[0]
        if isinstance(t, ast.Name) and t.id == taxis:
            back = 0
        elif (isinstance(t, ast.BinOp) and isinstance(t.op, ast.Sub) and
              isinstance(t.left, ast.Name) and t.left.id == taxis and
              isinstance(t.right, ast.Constant) and
              type(t.right.value) is int):
            back = t.right.value
        else:
            return None
        return back if 0 <= back <= self.noffset else None

    def _UnaryOp(self, f, node, env):
        a = self.expr(f, node.operand, env)
        if isinstance(node.op, ast.UAdd):
            return a
        if isinstance(node.op, ast.Not):
            # Python's `not`: a bool of the operand's truth, which the
            # plain engine refuses for an array of more than one element.
            if a.is_tensor and not a.dim0:
                raise RuntimeError("map: 'not' of an array: Boolean value "
                                   "of Tensor with more than one value is "
                                   "ambiguous")
            if a.const:
                return _Val(*literal(not a.rep), True)
            return _Val(f"(!truth({a.code}))", True, host=True)
        pyop = {ast.USub: lambda x: -x, ast.Invert: lambda x: ~x}[
            type(node.op)]
        rep = self._apply(ast.unparse(node), pyop, a.rep)
        if a.const:
            return _Val(*literal(rep), True)
        if a.host and isinstance(rep, torch.Tensor):
            return self._hoist(node, rep)
        if not isinstance(rep, torch.Tensor):
            if isinstance(node.op, ast.USub):
                return _Val(f"(-{a.code})" if not isinstance(rep, complex)
                            else f"op_neg<cx<double>>({a.code})", rep,
                            host=True)
            return _Val(f"(~{a.code})" if isinstance(rep, int) and
                        not isinstance(rep, bool) else f"(!{a.code})", rep,
                        host=True)
        t = _ctype(rep.dtype)
        fn = "op_neg" if isinstance(node.op, ast.USub) else "op_invert"
        return _Val(f.let(t, f"{fn}<{t}>(cvt<{t}>({a.code}))"), rep)

    def _BinOp(self, f, node, env):
        if type(node.op) not in _BINOPS:
            raise Unsupported(f"operator in {ast.unparse(node)!r} has no "
                          f"generated form")
        a = self.expr(f, node.left, env)
        b = self.expr(f, node.right, env)
        pyop = _PYOPS[type(node.op)]
        if isinstance(node.op, ast.Pow):
            from .map import _pow as pyop   # the plain engine's ``**``
        rep = self._apply(ast.unparse(node), pyop, a.rep, b.rep)
        if a.const and b.const:
            return _Val(*literal(rep), True)
        sym, fn = _BINOPS[type(node.op)]
        if a.host and b.host and (isinstance(rep, torch.Tensor) or fn in (
                "op_pow", "op_shl", "op_shr")):
            # Python's ** and shifts, and torch on 0-d CPU tensors: the
            # plain engine's own result, computed at launch.
            return self._hoist(node, rep)
        if not isinstance(rep, torch.Tensor):
            return _Val(self._py_binop(node.op, a, b, rep), rep, host=True)
        t = _ctype(rep.dtype)
        if rep.dtype.is_complex and fn in ("op_floordiv", "op_mod"):
            raise Unsupported(f"complex {sym} has no generated form")
        if fn == "op_pow":
            base = f.let(t, f"cvt<{t}>({a.code})")
            return _Val(f.let(t, self._pow(t, rep.dtype, base, b)), rep)
        if fn in ("op_shl", "op_shr") and rep.dtype == torch.bool:
            raise Unsupported(f"a shift of bools ({ast.unparse(node)!r})")
        if rep.dtype in _HALF and fn in _OPMATH_SCALAR and \
                (a.host or b.host):
            ops = [f"cvt<float>({v.code})" if v.host else
                   f"cvt<float>(cvt<{t}>({v.code}))" for v in (a, b)]
            return _Val(f.let(t, f"{t}({fn}<float>({ops[0]}, {ops[1]}))"),
                        rep)
        return _Val(f.let(t, f"{fn}<{t}>(cvt<{t}>({a.code}), "
                             f"cvt<{t}>({b.code}))"), rep)

    @staticmethod
    def _pow(t, dtype, base, b):
        """``base ** b`` in type `t`, `base` already of that type: torch's
        integer power, and its float and complex forms for scalar
        exponents."""
        special = b.const and not isinstance(b.rep, (complex, torch.Tensor))
        if dtype.is_complex:
            if special and float(b.rep) in _CX_POW_SPECIAL:
                return _CX_POW_SPECIAL[float(b.rep)].format(a=base, t=t)
            return f"mpow({base}, cvt<{t}>({b.code}))"
        if not dtype.is_floating_point:
            if b.const and isinstance(b.rep, int):
                return f"powi<{t}, long long>({base}, {b.code})"
            return f"op_pow<{t}>({base}, cvt<{t}>({b.code}))"
        if b.const and not isinstance(b.rep, (complex, torch.Tensor)) and \
                float(b.rep) in _POW_SPECIAL:
            return _POW_SPECIAL[float(b.rep)].format(a=base, t=t)
        return f"op_pow<{t}>({base}, cvt<{t}>({b.code}))"

    def _py_binop(self, op, a, b, rep):
        """Python arithmetic on weakly typed (run-time scalar) operands,
        in C on long long / double / cx<double>."""
        sym, fn = _BINOPS[type(op)]
        t = PY_C[type(rep)]
        if isinstance(op, ast.Div):
            return f"((double)({a.code}) / (double)({b.code}))"
        if fn in ("op_floordiv", "op_mod"):
            if t == "cx<double>":
                raise Unsupported(f"complex {sym} has no generated form")
            return f"{fn}<{t}>(({t})({a.code}), ({t})({b.code}))"
        if t == "cx<double>":
            return f"{fn}<{t}>(cvt<{t}>({a.code}), cvt<{t}>({b.code}))"
        return f"(({t})({a.code}) {sym} ({t})({b.code}))"

    def _Compare(self, f, node, env):
        if len(node.ops) != 1:
            raise Unsupported(f"chained comparison {ast.unparse(node)!r}")
        op = node.ops[0]
        a = self.expr(f, node.left, env)
        b = self.expr(f, node.comparators[0], env)
        rep = self._apply(ast.unparse(node), _PYOPS[type(op)], a.rep, b.rep)
        if a.const and b.const:
            return _Val(*literal(rep), True)
        if a.host and b.host and isinstance(rep, torch.Tensor):
            return self._hoist(node, rep)
        sym = _CMPOPS[type(op)]
        if not isinstance(rep, torch.Tensor):
            if isinstance(a.rep, complex) or isinstance(b.rep, complex):
                # Python allows only == and != on complex numbers.
                fn = "op_eq" if sym == "==" else "op_ne"
                return _Val(f"{fn}<cx<double>>(cvt<cx<double>>({a.code}), "
                            f"cvt<cx<double>>({b.code}))", rep, host=True)
            return _Val(f"(({a.code}) {sym} ({b.code}))", rep, host=True)
        dt = torch.result_type(a.rep, b.rep)
        t = _ctype(dt)
        ca, cb = f"cvt<{t}>({a.code})", f"cvt<{t}>({b.code})"
        if dt.is_complex:
            code = {"==": f"op_eq<{t}>({ca}, {cb})",
                    "!=": f"op_ne<{t}>({ca}, {cb})"}.get(sym)
            if code is None:
                raise Unsupported(f"complex {sym} has no generated form")
        else:
            code = f"({ca} {sym} {cb})"
        return _Val(f.let("bool", code), rep)

    def _Call(self, f, node, env):
        if not isinstance(node.func, ast.Name) or node.keywords:
            raise Unsupported(f"call {ast.unparse(node)!r} has no generated "
                          f"form")
        fname = node.func.id
        b = env.get(fname)
        fn = self.ns.get(fname)
        if (b is not None and b[0] != "const") or not callable(fn):
            raise Unsupported(f"{fname!r} is not a function of the map "
                          f"namespace")
        args = [self.expr(f, a, env) for a in node.args]
        rep = self._apply(ast.unparse(node), fn, *[a.rep for a in args])
        if all(a.const for a in args):
            return _Val(*literal(rep), True)
        if all(a.host for a in args):
            return self._hoist(node, rep)
        if not isinstance(rep, torch.Tensor):
            raise Unsupported(f"{fname} of run-time scalars returned "
                          f"{type(rep).__name__}")
        t = _ctype(rep.dtype)
        return _Val(f.let(t, self._call_code(fname, t, rep.dtype, args)),
                    rep)

    def _call_code(self, fname, t, dtype, args):
        a = args[0].code if args else None
        if fname in ("f32cast", "f64cast", "i32cast"):
            return f"cvt<{t}>({a})"
        if fname == "real":
            return f"cvt<{t}>({a})"
        if fname == "imag":
            src = args[0].rep
            if isinstance(src, torch.Tensor) and src.dtype.is_complex:
                return f"({a}).im"
            return f"cvt<{t}>(0)"
        if fname == "conj":
            if dtype.is_complex:
                return f"mconj(cvt<{t}>({a}))"
            return f"cvt<{t}>({a})"
        if fname == "mag2":
            src = args[0].rep
            if isinstance(src, torch.Tensor) and src.dtype.is_complex:
                st = C_TYPES[src.dtype]
                return f"mmag2(cvt<{st}>({a}))"
            return f"op_mul<{t}>(cvt<{t}>({a}), cvt<{t}>({a}))"
        if fname == "Complex":
            part = _COMPLEX_PART[dtype]
            return (f"{t}(cvt<{part}>({args[0].code}), "
                    f"cvt<{part}>({args[1].code}))")
        if fname == "where":
            return (f"(truth({a}) ? cvt<{t}>({args[1].code}) : "
                    f"cvt<{t}>({args[2].code}))")
        if fname in ("min", "max", "fmin", "fmax"):
            fn = "mmin" if fname in ("min", "fmin") else "mmax"
            if dtype.is_complex:
                raise Unsupported(f"complex {fname} has no generated form")
            return (f"{fn}<{t}>(cvt<{t}>({a}), "
                    f"cvt<{t}>({args[1].code}))")
        if fname == "pow":
            return self._pow(t, dtype, f"cvt<{t}>({a})", args[1])
        if fname == "atan2":
            if dtype in _HALF:
                return (f"cvt<{t}>(std::atan2(cvt<float>(cvt<{t}>({a})), "
                        f"cvt<float>(cvt<{t}>({args[1].code}))))")
            return (f"std::atan2(cvt<{t}>({a}), "
                    f"cvt<{t}>({args[1].code}))")
        if fname in ("abs", "fabs"):
            src = args[0].rep
            if isinstance(src, torch.Tensor) and src.dtype.is_complex:
                return f"mabs(cvt<{C_TYPES[src.dtype]}>({a}))"
            if dtype == torch.bool:
                raise Unsupported("abs of a bool has no generated form")
            return f"mabs<{t}>(cvt<{t}>({a}))"
        if fname in _ROUNDING:
            if dtype.is_complex:
                raise Unsupported(f"complex {fname} has no generated form")
            return f"{_ROUNDING[fname]}<{t}>(cvt<{t}>({a}))"
        if fname in _UNARY_MATH:
            if dtype.is_complex:
                if fname not in _CX_MATH:
                    raise Unsupported(f"complex {fname} has no generated "
                                      f"form")
                return f"{_CX_MATH[fname]}(cvt<{t}>({a}))"
            if not dtype.is_floating_point:
                raise Unsupported(f"{fname} to {dtype} has no generated form")
            if dtype in _HALF and fname != "rsqrt":
                # In f32, rounded once, as PyTorch's half kernels compute.
                return (f"cvt<{t}>({_UNARY_MATH[fname]}(cvt<float>("
                        f"cvt<{t}>({a}))))")
            return f"{_UNARY_MATH[fname]}(cvt<{t}>({a}))"
        raise Unsupported(f"{fname!r} has no generated form")

    def _apply(self, what, fn, *reps):
        """The plain engine's operator on representatives -> the node's
        representative (its type).  Where the engine raises on these
        types, so does the generator; an integer division by a
        representative that happens to be 0 is retried on ones (the
        type does not depend on the value)."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                out = fn(*reps)
            except (ZeroDivisionError, RuntimeError) as exc:
                if "ZeroDivision" not in f"{type(exc).__name__}{exc}":
                    raise
                out = fn(*[torch.ones_like(r) if isinstance(r, torch.Tensor)
                           else type(r)(1) for r in reps])
        if isinstance(out, torch.Tensor):
            if out.dtype not in C_TYPES:
                raise Unsupported(f"{what}: {out.dtype} has no generated form")
            if out.dim() > 1:
                out = out.reshape(-1)[:1]
        elif type(out) not in PY_C:
            raise Unsupported(f"{what}: value of type {type(out).__name__}")
        return out

    # --------------------------------------------------- statements
    def statement(self, k, tree):
        f = _Func(self)
        env = self._env(k)
        v = self.expr(f, tree, env)
        rep, host = v.rep, v.host
        if v.dim0 and self.form in ("local", "stencil"):
            # The explicit forms broadcast every statement's value to the
            # output grid (ops/map.py `_stream_eval`): an array.
            rep, host = _rep_of(_value_dtype(rep)), False
        t = _ctype_of(rep)
        body = "\n".join(f.lines)
        self.funcs.append(
            f"template <typename I, bool PRE>\n"
            f"MAP_HD {t} s{k}(const P& p, const I* c, const Pre& pre) {{\n"
            f"{body}\n  return cvt<{t}>({v.code});\n}}\n")
        self.stmt_types.append(rep)
        self.stmt_host.append(host)
        return rep

    def _hoist(self, node, rep):
        """A value the plain engine computes on the host from scalars and
        sizes alone (Python's ``**`` and shifts, torch on 0-d CPU
        tensors): a meta word the launch fills with the plain engine's own
        result (`Program.derive`), so it is exact."""
        if isinstance(rep, torch.Tensor):
            if rep.dtype not in C_TYPES:
                raise Unsupported(f"{ast.unparse(node)}: {rep.dtype} has no "
                                  f"generated form")
            dt = rep.dtype
            kind = complex if dt.is_complex else float \
                if dt.is_floating_point else bool if dt == torch.bool else int
        else:
            kind = type(rep)
        off = self.nmeta
        self.nmeta += 2 if kind is complex else 1
        self.derived.append((off, ast.unparse(node), rep))
        code = {bool: f"(p.m[{off}] != 0)", int: f"p.m[{off}]",
                float: f"bits_f64(p.m[{off}])",
                complex: f"cx<double>(bits_f64(p.m[{off}]), "
                         f"bits_f64(p.m[{off + 1}]))"}[kind]
        if isinstance(rep, torch.Tensor):
            code = f"cvt<{_ctype(rep.dtype)}>({code})"
        return _Val(code, rep, host=True)


def _f64_word(v):
    """A float's IEEE bits as the signed 64-bit meta word `bits_f64`
    reads."""
    return struct.unpack("<q", struct.pack("<d", float(v)))[0]


def _trees(statements, arrays, reserved):
    from .map import _rewrite_indexing
    out = []
    for _lhs, _idx, rhs in statements:
        expr = _rewrite_indexing(rhs, arrays, reserved)
        out.append(ast.parse(expr, mode="eval"))
    return out


def generate(statements, form, inputs, ns, arrays, out_names,
             axis_names=None, scalars=None, noffset=0, extra_code=None,
             out_rank=None):
    """Translated `statements` (ops/map.py `_CompiledMap.statements`) ->
    a `Program`; raises `Refusal` for a form refused by design and
    `Unsupported` for what the kernel does not implement.

    form: 'elementwise', 'local', 'stencil' or 'eager'; inputs: the
    `Input`s the kernel reads (the streaming input first); ns: the plain
    engine's namespace (its functions give every node's type); arrays:
    the names `_rewrite_indexing` rewrites; out_names: the statements
    written out (the last one for a stream, every one for the eager
    call); scalars: name -> value of the run-time scalars; out_rank: the
    output rank."""
    if extra_code:
        raise Refusal("extra_code: Python helpers have no CUDA form")
    if form in ("forward", "unbounded"):
        raise Refusal(f"the {form} streaming form: its frames are not "
                      f"gulp-resident")
    if form not in ("elementwise", "local", "stencil", "eager"):
        raise ValueError(f"unknown map form {form!r}")
    explicit = any(s[1] is not None for s in statements)
    if form == "eager" and explicit:
        raise Refusal("the eager explicit-index and scatter forms run on "
                      "the plain engine")
    rank = int(out_rank)
    if not 1 <= rank <= MAX_RANK or \
            any(inp.rank > MAX_RANK for inp in inputs):
        raise Unsupported(f"rank above {MAX_RANK}: an indexed form reads "
                          f"every axis (the elementwise and eager forms "
                          f"collapse contiguous axes)")
    for inp in inputs:
        if inp.dtype not in C_TYPES:
            raise Unsupported(f"{inp.dtype}: no generated form for this type")
    gen = _Gen(statements, form, axis_names, inputs, scalars or {},
               noffset, ns, arrays, out_names)
    gen.layout(rank)
    reserved = frozenset(k for k, v in ns.items())
    gen.trees = _trees(statements, arrays, reserved)
    for k, tree in enumerate(gen.trees):
        gen.statement(k, tree)
    out_idx = [max(i for i, s in enumerate(statements) if s[0] == n)
               for n in out_names]
    return Program(gen, out_idx)


def storage_bytes(inp):
    """Bytes a sample of input `inp` takes in its storage form."""
    if inp.storage == "pair":
        return 2 * inp.int_dtype.itemsize
    if inp.storage in ("ci4", "packed", "cpacked"):
        return 1.0 / inp.per_byte
    return inp.dtype.itemsize


def _pow2_floor(x):
    return 1 << max(0, int(x).bit_length() - 1) if x >= 1 else 1


def _streamed(gen):
    """The inputs a vector path moves in vector accesses: every input of
    the elementwise and eager forms, the windowed input of the local and
    stencil forms."""
    if not gen.two_d:
        return list(gen.inputs)
    return gen.inputs[:1] if gen.window else []


def choose_vec(gen, out_dtypes):
    """V, the samples a thread owns on the vector path: the widest
    streamed operand (the inputs `_streamed` names and the outputs) moves
    16 bytes a thread, so that every access of a warp is one contiguous
    span (wider spans a thread break the stores' coalescing); at most
    32, and in a window at least the samples a packed byte holds.  1 (no
    vector path)
    where a local or stencil form has no channel axis, or its window of
    noffset + 1 frames would not fit `VEC_BYTES`."""
    if gen.two_d and gen.R < 2:
        return 1
    ins = _streamed(gen)
    sizes = [storage_bytes(i) for i in ins] + \
        [d.itemsize for d in out_dtypes]
    v = max(_min_vec(gen), min(32, _pow2_floor(16 / max(sizes))))
    if gen.window and (gen.noffset + 1) * v * \
            gen.inputs[0].dtype.itemsize > VEC_BYTES:
        return 1
    return v


def _min_vec(gen):
    """The fewest samples a vector item may hold: a window loads whole
    bytes of a packed input; an elementwise item may start inside one
    (its position in the byte kept beside its words)."""
    if not gen.two_d:
        return 1
    return max([i.per_byte for i in _streamed(gen)] or [1])


class Program(object):
    """A generated kernel: its CUDA C++ source and the layout its launch
    packs (ops/map_kernel.py).  `vec` (V) samples a thread on the vector
    path, `chunk` of them a store, `run` frames a thread in the local and
    stencil forms; `vec_note` says why V was cut after a build."""

    def __init__(self, gen, out_idx):
        self.form = gen.form
        self.inputs = gen.inputs
        self.noffset = gen.noffset
        self.rank = gen.R
        self.out_names = gen.out_names
        self.out_dtypes = [_value_dtype(gen.stmt_types[k]) for k in out_idx]
        self.scalar_names = list(gen.scalars)
        self.scalar_types = [torch.Tensor if isinstance(v, torch.Tensor)
                             else type(v) for v in gen.scalars.values()]
        # What `derive` evaluates at each launch.
        self._derived = list(gen.derived)
        self._host_stmts = [(gen.statements[k][0], ast.unparse(tree))
                            for k, tree in enumerate(gen.trees)
                            if gen.stmt_host[k]]
        self._axis_names = gen.axis_names
        self._ns = gen.ns
        self._arrays = gen.arrays
        self.nmeta = gen.nmeta
        self.nptr = gen.nptr
        # A local form reading its input whole needs the output's
        # non-frame shape to equal the input's (checked by the caller).
        self.bare_input = gen.bare_input
        self.uses_coords = gen.uses_coords
        self.window = gen.window
        self.two_d = gen.two_d
        # the window re-reads noffset frames a run, at most 1/8 of them
        self.run = min(64, 8 * max(2, gen.noffset)) if gen.two_d else 1
        self.vec_note = None
        self.last_launch = None            # map_kernel's plan of the last
        self._gen, self._out_idx = gen, out_idx
        self.set_vec(choose_vec(gen, self.out_dtypes))

    def set_vec(self, vec):
        """Generate the source for V = `vec` samples a thread."""
        self.vec = int(vec)
        self.min_vec = _min_vec(self._gen)
        self.layouts = OrderedDict()       # map_kernel.pack's layout words
        widest = max(d.itemsize for d in self.out_dtypes)
        self.chunk = min(self.vec, max(1, 16 // widest))
        self.source = self._source(self._gen, self._out_idx)
        self.key = hashlib.sha256(self.source.encode()).hexdigest()[:16]
        self.name = f"map_{self.key}"
        self.lib = None

    def derive(self, scalars, out_shape):
        """The meta words of the hoisted values: each evaluated by the
        plain engine on the host from the run-time `scalars` (name ->
        value) and the output's sizes, after the array-independent
        statements it may read -> list of int."""
        if not self._derived:
            return []
        from .map import _HOOKS, _eval
        ns = dict(self._ns)
        ns.update(_HOOKS)
        ns.update(scalars)
        for d, ax in enumerate(self._axis_names):
            ns[f"n{ax}"] = int(out_shape[d])
        for name, expr in self._host_stmts:
            ns[name] = _eval(expr, self._arrays, ns)
        words = []
        for _off, expr, rep in self._derived:
            v = _eval(expr, self._arrays, ns)
            if isinstance(rep, torch.Tensor):
                if not isinstance(v, torch.Tensor) or v.dim() != 0 or \
                        v.dtype != rep.dtype:
                    raise TypeError(f"map: {expr!r} was generated as a 0-d "
                                    f"{rep.dtype}, the scalars give {v!r}")
                v = v.item()
            elif type(v) is not type(rep):
                raise TypeError(f"map: {expr!r} was generated as "
                                f"{type(rep).__name__}, the scalars give "
                                f"{type(v).__name__} {v!r}")
            if isinstance(v, complex):
                words += [_f64_word(v.real), _f64_word(v.imag)]
            elif isinstance(v, float):
                words.append(_f64_word(v))
            else:
                words.append(int(v))
        return words

    def _source(self, gen, out_idx):
        R, V, CH, RUN = gen.R, self.vec, self.chunk, self.run
        nin = len(gen.inputs)
        nout = len(gen.out_names)
        H = {k: i for i, k in enumerate(HEADER)}
        SH = gen.shape_off
        lines = [
            "// Generated by bifrost_tpu_torch/ops/map_codegen.py: kernel "
            "M1 for one bf.map",
            "// program (the port's counterpart of the jnp closure of",
            "// bifrost_tpu/ops/map.py:421-511).  Statements:",
        ]
        for lhs, idx, rhs in gen.statements:
            lhs_s = lhs + (f"({', '.join(idx)})" if idx else "")
            lines.append(f"//   {lhs_s} = {rhs}".replace("\n", " "))
        lines += [
            f"// Form {gen.form}, rank {R}.  A thread owns V = {V} "
            f"consecutive output samples on",
            "// the vector path (one access an operand, the widest 16 "
            "bytes a thread), one",
            "// on the element path (any strides, the ragged tail); index "
            "arithmetic in the",
            "// index type I (32- or 64-bit, chosen at launch), dividing by "
            "host-computed",
            "// magic pairs.",
        ]
        if gen.two_d:
            lines += [
                f"// The frame axis is the grid's y axis: a thread walks "
                f"a run of RUN = {RUN}",
                "// frames of its channels, decomposed once"
                + (f"; the last NOFF = {gen.noffset} frames" if gen.window
                   and gen.noffset else "") + ".",
            ]
            if gen.window:
                lines.append(
                    "// Reads x(t - k) at the output's channels come from "
                    "a register window.")
        lines += [
            '#include "map_common.cuh"',
            "using namespace bfmap;",
            f"constexpr int R = {R}, V = {V}, CH = {CH}, RUN = {RUN}, "
            f"NOFF = {gen.noffset};",
            f"#define CARRY_IN {nin + nout}",
            f"#define CARRY_OUT {nin + nout + 1}",
            f"struct P {{ long long m[{gen.nmeta}]; void* ptr[{gen.nptr}]; "
            f"}};",
        ]
        if gen.two_d:
            fields = [f"{C_TYPES[gen.inputs[0].dtype]} w{k};"
                      for k in range(gen.noffset + 1)] if gen.window else []
        else:
            fields = [f"{C_TYPES[inp.dtype]} in{k};"
                      for k, inp in enumerate(gen.inputs)]
        lines.append("struct Pre { " + (" ".join(fields) or "char none;")
                     + " };")
        lines.append("\n".join(gen.funcs))

        def div(off, d, r):
            return (f"div_magic<I>({r}, p.m[{off} + 2 * ({d} - 1)], "
                    f"p.m[{off} + 2 * ({d} - 1) + 1])")

        def out_off(j, c):
            return " + ".join(f"(I){c}[{d}] * (I)p.m[{gen.out_off[j] + d}]"
                              for d in range(R))

        def stores(c, pre_val, PRE):
            out = []
            if gen.form == "eager":
                out.append("    long long nz = 0;\n" + "\n".join(
                    f"    nz |= (long long)({c}[{d}] != 0) << {d};"
                    for d in range(R)))
            for j, k in enumerate(out_idx):
                t = C_TYPES[_value_dtype(gen.stmt_types[k])]
                guard = f"if (!(nz & p.m[{gen.out_off[j] + R}])) " \
                    if gen.form == "eager" else ""
                out.append(f"    {guard}st<{t}>(p.ptr[{nin + j}], "
                           f"{out_off(j, c)}, cvt<{t}>(s{k}<I, {PRE}>(p, "
                           f"{c}, {pre_val})));")
            return "\n".join(out)

        def vstores(c, fill, advance):
            """The vector stores of V samples at coordinates `c` (the
            first), CH a store; `fill` sets `pre` for sample j; `advance`
            moves cj to the next sample."""
            ys = "\n".join(
                f"      {C_TYPES[_value_dtype(gen.stmt_types[k])]} y{j}[CH];"
                for j, k in enumerate(out_idx))
            comp = "\n".join(
                f"        y{j}[jj] = cvt<{C_TYPES[_value_dtype(gen.stmt_types[k])]}>"
                f"(s{k}<I, true>(p, cj, pre));"
                for j, k in enumerate(out_idx))
            guard = ""
            if gen.form == "eager":
                guard = "\n".join(
                    f"    nz |= (long long)({c}[{d}] != 0) << {d};"
                    for d in range(R - 1))
                guard = "    long long nz = 0;\n" + guard + "\n" if guard \
                    else "    const long long nz = 0;\n"
            st_ = "\n".join(
                ("      if (!(nz & p.m[{m}])) ".format(m=gen.out_off[j] + R)
                 if gen.form == "eager" else "      ") +
                f"vst<CH>(p.ptr[{nin + j}], {out_off(j, c)} + (I)(h * CH), "
                f"y{j});" for j in range(nout))
            return (f"{guard}    I cj[R];\n"
                    f"    for (int d = 0; d < R; ++d) cj[d] = {c}[d];\n"
                    f"#pragma unroll\n"
                    f"    for (int h = 0; h < V / CH; ++h) {{\n{ys}\n"
                    f"#pragma unroll\n"
                    f"      for (int jj = 0; jj < CH; ++jj) {{\n"
                    f"        const int j = h * CH + jj;\n"
                    f"        Pre pre;\n{fill}\n{comp}\n{advance}\n"
                    f"      }}\n{st_}\n    }}")

        parts = []
        if not gen.two_d:
            parts.append(f"""// Coordinates of element (item) e over the element (item) extents: the
// axes below R - nd are padding of extent 1.
template <typename I, int DV>
MAP_HD void unflatten(const P& p, I e, I* c) {{
  const int nd = (int)p.m[{H['nd']}];
  I r = e;
#pragma unroll
  for (int d = R - 1; d > 0; --d) {{
    if (d > R - nd) {{
      const I q = div_magic<I>(r, p.m[DV + 2 * (d - 1)], p.m[DV + 2 * (d - 1) + 1]);
      c[d] = r - q * (I)(d == R - 1 && DV == {gen.divi_off} ? p.m[{SH} + d] / V : p.m[{SH} + d]);
      r = q;
    }} else {{
      c[d] = r;
      r = 0;
    }}
  }}
  c[0] = r;
}}

template <typename I>
MAP_HD void elem_item(const P& p, I e) {{
  I c[R];
  unflatten<I, {gen.dive_off}>(p, e, c);
  const Pre pre{{}};
{stores("c", "pre", "false")}
}}""")
            if V > 1:
                fields, loads, fill = [], [], []
                for k, inp in enumerate(gen.inputs):
                    bs = gen.in_off[k][3]
                    off, pos = gen.offset(k, [f"it.c[{d}]"
                                              for d in range(R)], bs)
                    ct = C_TYPES[inp.dtype]
                    unit, nb, ex = gen.vwords(k, V)
                    nw = (nb + 3) // 4
                    sub = V < inp.per_byte
                    fields.append(f"uint32_t w{k}[{nw}]; {ct} s{k};" +
                                  (f" int p{k};" if sub else ""))
                    scalar = gen._ld_at(k, f"p.ptr[{k}]", "off",
                                        pos if pos is not None else "0")
                    loads.append(
                        f"  {{\n    const I off = {off};\n" +
                        (f"    it.p{k} = {pos};\n" if sub else "") +
                        f"    if (p.m[{gen.in_off[k][4]}]) {{\n"
                        f"      vld_words<{nb}>(it.w{k}, "
                        f"static_cast<const {unit}*>(p.ptr[{k}]) + off);\n"
                        f"      it.s{k} = {ct}();\n"
                        f"    }} else {{\n      it.s{k} = {scalar};\n"
                        f"      for (int q = 0; q < {nw}; ++q) it.w{k}[q] = 0;"
                        f"\n    }}\n  }}")
                    fill.append(f"        pre.in{k} = p.m[{gen.in_off[k][4]}] "
                                f"? {ex.format(wd=f'it.w{k}', pos=f'it.p{k}')}"
                                f" : it.s{k};")
                parts.append(f"""// A vector item: V consecutive samples along the innermost axis, each
// input's raw words from one vector access (a broadcast input: one
// load), then the statements on each sample and the vector stores.
template <typename I>
struct Item {{ I c[R]; {' '.join(fields)} }};

template <typename I>
MAP_HD void vec_load(const P& p, I i, Item<I>& it) {{
  unflatten<I, {gen.divi_off}>(p, i, it.c);
  it.c[R - 1] *= V;
{chr(10).join(loads)}
}}

template <typename I>
MAP_HD void vec_store(const P& p, const Item<I>& it) {{
{vstores("it.c", chr(10).join(fill), "        cj[R - 1] += 1;")}
}}""")
        else:
            parts.append(f"""// The channel coordinates c[1..R-1] of flat channel index `first`.
template <typename I>
MAP_HD void chan_coords(const P& p, I first, I* c) {{
  I r = first;
#pragma unroll
  for (int d = R - 1; d > 1; --d) {{
    const I q = {div(gen.dive_off, "d", "r")};
    c[d] = r - q * (I)p.m[{SH} + d];
    r = q;
  }}
  if (R > 1) c[R > 1 ? 1 : 0] = r;
}}

// Frames f0 .. f0 + RUN - 1 of the channel at c, one element a frame.
template <typename I>
MAP_HD void run_elem(const P& p, I* c, I f0) {{
  const I nt = (I)p.m[{SH}];
  const Pre pre{{}};
  for (int r = 0; r < RUN; ++r) {{
    const I f = f0 + (I)r;
    if (f >= nt) break;
    c[0] = f;
{stores("c", "pre", "false")}
  }}
}}""")
            if V > 1:
                win, fill, load, slide = "", "", "", ""
                if gen.window:
                    inp = gen.inputs[0]
                    ct = C_TYPES[inp.dtype]
                    goff, _ = gen.offset(0, [f"c[{d}]" for d in range(R)])
                    carry_v = (f"vl_cx<V>(w[NOFF - k], p.ptr[CARRY_IN], cof)"
                               if inp.dtype.is_complex else
                               f"vl_real<V>(w[NOFF - k], p.ptr[CARRY_IN], "
                               f"cof)")
                    # w[NOFF - k]: frame f - k; w[NOFF] the frame itself
                    win = f"  {ct} w[NOFF + 1][V];\n"
                    if gen.noffset:
                        win += (f"#pragma unroll\n"
                                f"  for (int k = 1; k <= NOFF; ++k) {{\n"
                                f"    const I g = f0 - (I)k;\n"
                                f"    if (g >= 0) {{\n      c[0] = g;\n"
                                f"      const I off = {goff};\n"
                                f"      {gen.vload(0, 'w[NOFF - k]', 'off')};"
                                f"\n    }} else {{\n"
                                f"      const I cof = (NOFF + g) * "
                                f"(I)p.m[{H['chan']}] + first;\n"
                                f"      {carry_v};\n    }}\n  }}")
                        slide = ("#pragma unroll\n"
                                 "    for (int k = 0; k < NOFF; ++k)\n"
                                 "#pragma unroll\n"
                                 "      for (int j = 0; j < V; ++j) "
                                 "w[k][j] = w[k + 1][j];")
                    fill = "\n".join(
                        f"        pre.w{k} = w[NOFF - {k}][j];"
                        for k in range(gen.noffset + 1))
                    load = (f"    {{\n      const I off = {goff};\n"
                            f"      {gen.vload(0, 'w[NOFF]', 'off')};\n"
                            f"    }}")
                advance = ("#pragma unroll\n"
                           "        for (int d = R - 1; d > 0; --d) {\n"
                           f"          if (++cj[d] < (I)p.m[{SH} + d]) "
                           "break;\n"
                           "          cj[d] = 0;\n        }")
                parts.append(f"""// Frames f0 .. f0 + RUN - 1 of V consecutive channel samples from flat
// channel `first` (at c): one vector access a frame and operand, the
// frames before it in the register window.
template <typename I>
MAP_HD void run_vec(const P& p, I* c, I f0, I first) {{
  const I nt = (I)p.m[{SH}];
{win}
  for (int r = 0; r < RUN; ++r) {{
    const I f = f0 + (I)r;
    if (f >= nt) break;
    c[0] = f;
{load}
{vstores("c", fill, advance)}
{slide}
  }}
}}""")
            if gen.form == "stencil":
                inp = gen.inputs[0]
                so = gen.in_off[0][0]
                ct = C_TYPES[inp.dtype]
                rin = inp.rank
                cdec = "\n".join(
                    f"  {{\n    const I q = {div(gen.divk_off, d, 'r')};\n"
                    f"    c[{d}] = r - q * (I)p.m[{so + d}];\n    r = q;\n  }}"
                    for d in reversed(range(2, rin)))
                if rin > 1:
                    cdec += "\n  c[1] = r;"
                gulp_terms = ["(s - NOFF)"] + [f"c[{d}]" for d in range(1, rin)]
                carry_ld = (f"ld_cx<{_COMPLEX_PART[inp.dtype]}>"
                            if inp.dtype.is_complex else f"ld_real<{ct}>")
                parts.append(f"""// The next carry: frame f of the last NOFF of [carry; gulp].
template <typename I>
MAP_HD void carry_item(const P& p, I j) {{
  const I chan = (I)p.m[{H['chan']}];
  const I f = div_magic<I>(j, p.m[{H['chan_m']}], p.m[{H['chan_s']}]);
  I r = j - f * chan;
  const I flat = r;
  I c[{max(rin, 1)}];
{cdec}
  const I s = (I)p.m[{so}] + f;
  const {ct} v = s < NOFF ? {carry_ld}(p.ptr[CARRY_IN], s * chan + flat)
                          : {gen._ld(0, gulp_terms)};
  st<{ct}>(p.ptr[CARRY_OUT], j, v);
}}""")
        if not gen.two_d:
            vec_loop = host_vec = ""
            if V > 1:
                vec_loop = """  for (U i = tid; i < nvec; i += stride) {
    Item<I> it;
    vec_load<I>(p, (I)i, it);
    vec_store<I>(p, it);
  }
"""
                host_vec = vec_loop.replace("tid", "0").replace("stride", "1")
            kernel_body = f"""  using U = typename std::make_unsigned<I>::type;
  const U stride = (U)gridDim.x * blockDim.x;
  const U tid = (U)blockIdx.x * blockDim.x + threadIdx.x;
  const U nvec = (U)p.m[{H['nvec']}];
{vec_loop}  for (U e = nvec * V + tid; e < (U)p.m[{H['n']}]; e += stride)
    elem_item<I>(p, (I)e);"""
            host_body = f"""  using U = typename std::make_unsigned<I>::type;
  const U nvec = (U)p.m[{H['nvec']}];
{host_vec}  for (U e = nvec * V; e < (U)p.m[{H['n']}]; ++e) elem_item<I>(p, (I)e);"""
        else:
            run = ("      if (vec) run_vec<I>(p, c, f0, first);\n      else "
                   if V > 1 else "      ")
            carry = ""
            if gen.form == "stencil":
                carry = f"""  const U t = ((U)blockIdx.y * gridDim.x + blockIdx.x) *
                  (blockDim.x * blockDim.y) + threadIdx.y * blockDim.x +
                  threadIdx.x;
  const U tstride = (U)gridDim.x * gridDim.y * blockDim.x * blockDim.y;
  for (U j = t; j < (U)p.m[{H['ncarry']}]; j += tstride)
    carry_item<I>(p, (I)j);"""
            kernel_body = f"""  using U = typename std::make_unsigned<I>::type;
  const bool vec = p.m[{H['vec']}] != 0;
  const U ci = (U)blockIdx.x * blockDim.x + threadIdx.x;
  if (ci < (U)p.m[{H['nci']}]) {{
    const I first = vec ? (I)(ci * V) : (I)ci;
    I c[R];
    chan_coords<I>(p, first, c);
    for (U run = (U)blockIdx.y * blockDim.y + threadIdx.y;
         run < (U)p.m[{H['nruns']}]; run += (U)gridDim.y * blockDim.y) {{
      const I f0 = (I)(run * RUN);
{run}run_elem<I>(p, c, f0);
    }}
  }}
{carry}"""
            host_body = f"""  using U = typename std::make_unsigned<I>::type;
  const bool vec = p.m[{H['vec']}] != 0;
  for (U ci = 0; ci < (U)p.m[{H['nci']}]; ++ci) {{
    const I first = vec ? (I)(ci * V) : (I)ci;
    I c[R];
    chan_coords<I>(p, first, c);
    for (U run = 0; run < (U)p.m[{H['nruns']}]; ++run) {{
      const I f0 = (I)(run * RUN);
{run}run_elem<I>(p, c, f0);
    }}
  }}""" + ("" if gen.form != "stencil" else f"""
  for (U j = 0; j < (U)p.m[{H['ncarry']}]; ++j) carry_item<I>(p, (I)j);""")
        lines += parts
        lines.append(f"""
#ifdef __CUDACC__
template <typename I>
__global__ void __launch_bounds__({BLOCK}) map_kernel(const P p) {{
{kernel_body}
}}

// The grid from the device: at most four waves of the blocks of this
// instantiation the SMs hold (occupancy; four read 2-9 % faster than one
// on an H100); in the local and stencil forms blockDim.x spans the
// channel items (a power of two up to {BLOCK}) and the grid's y axis the
// frame runs.
template <typename I>
static int launch(const P& p, cudaStream_t stream, int* info) {{
  static int occ = 0;
  if (occ == 0) {{
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, map_kernel<I>, {BLOCK}, 0);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) occ = 1;
  }}
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = (long long)(sms > 0 ? sms : 1) * occ * 4;
  dim3 grid(1, 1, 1), block({BLOCK}, 1, 1);
  if ({int(gen.two_d)}) {{
    const long long nci = p.m[{H['nci']}], nruns = p.m[{H['nruns']}];
    long long bx = 1;
    while (bx < nci && bx < {BLOCK}) bx *= 2;
    block = dim3((unsigned)bx, (unsigned)({BLOCK} / bx), 1);
    const long long gx = (nci + bx - 1) / bx;
    long long gy = (nruns + block.y - 1) / block.y;
    long long gymax = cap / gx;
    if (gymax > 65535) gymax = 65535;
    if (gy > gymax) gy = gymax;
    if (gy < 1) gy = 1;
    grid = dim3((unsigned)gx, (unsigned)gy, 1);
  }} else {{
    const long long nvec = p.m[{H['nvec']}];
    long long items = p.m[{H['n']}] - nvec * V;
    if (nvec > items) items = nvec;
    long long g = (items + {BLOCK} - 1) / {BLOCK};
    if (g > cap) g = cap;
    grid = dim3((unsigned)(g < 1 ? 1 : g), 1, 1);
  }}
  if (info) {{
    info[0] = (int)grid.x; info[1] = (int)grid.y;
    info[2] = (int)block.x; info[3] = (int)block.y;
    info[4] = occ; info[5] = sms;
  }}
  map_kernel<I><<<grid, block, 0, stream>>>(p);
  return (int)cudaGetLastError();
}}

extern "C" int map_launch(const long long* m, void* const* ptr, int idx64,
                          void* stream, int* info) {{
  P p;
  for (int k = 0; k < {gen.nmeta}; ++k) p.m[k] = m[k];
  for (int k = 0; k < {gen.nptr}; ++k) p.ptr[k] = ptr[k];
  if (p.m[{H['n']}] + p.m[{H['ncarry']}] == 0) return 0;
  return idx64 ? launch<long long>(p, (cudaStream_t)stream, info)
               : launch<int>(p, (cudaStream_t)stream, info);
}}

extern "C" const char* map_error_string(int e) {{
  return cudaGetErrorString((cudaError_t)e);
}}
#else
// The same split on the host, one item after another (the CPU tests).
template <typename I>
static void host_run(const P& p) {{
{host_body}
}}

extern "C" int map_host(const long long* m, void* const* ptr, int idx64) {{
  P p;
  for (int k = 0; k < {gen.nmeta}; ++k) p.m[k] = m[k];
  for (int k = 0; k < {gen.nptr}; ++k) p.ptr[k] = ptr[k];
  if (idx64) host_run<long long>(p);
  else host_run<int>(p);
  return 0;
}}
#endif
""")
        text = "\n".join(lines)
        if re.search(r"\bb?f16\b", text):
            # CUDA's half headers only where a half type is used
            text = text.replace('#include "map_common.cuh"',
                                '#define MAP_HALF_TYPES 1\n'
                                '#include "map_common.cuh"', 1)
        return text
