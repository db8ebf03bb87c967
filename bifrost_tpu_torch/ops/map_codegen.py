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
  at coordinate 0 only);
- ``gather``: the eager call's explicit-index form (``generate`` takes
  it as 'eager' with indexed statements): a grid over ``shape`` of rank
  at most `MAX_RANK`, each input read at its computed indices through
  its own shape and strides (``wrapclamp``), a whole-array read through
  its broadcast strides; index arithmetic in the plain engine's int32.
  A read whose indices are each ``+-axis + offset`` over distinct
  axes, or an offset alone (the offset an int expression of scalars and
  sizes), is affine (`_Gen.sites`): where the launch finds it inside its
  input, the tile and vector paths take its value in ``pre`` (no
  ``wrapclamp``).  The tile path (`Program._gather_src`) stages the
  reads whose contiguous axis is not the output's innermost through
  shared memory (`tile_geometry`); the vector path takes V samples along
  the innermost axis, a read forward or reversed in one access.
  A statement whose left-hand index is not the axis names scatters, as
  jnp's ``.at[idx].set``, into a copy of its target (the right-hand
  side reads the original): an index wraps once if negative, an update
  still out of bounds is dropped (``wrapdrop``), and of repeated targets
  the highest source position, row-major over the grid, wins.  Such a
  program is two launches over a copy the launch makes: pass 1 raises
  each target's owner word to its largest source position + 1
  (``atomicMax``), pass 2 writes where the owner is the thread's own.
  Where its indices are a permutation of the grid axes, each
  ``+-axis + offset`` (`_Gen.one_pass`), the launch finds them inside
  the target and the scatter is the program's only output, the map is
  injective: one launch (pass 3) over the target's shape computes each
  element at its source (``to_grid``) or keeps the target's value;
- ``forward`` and ``unbounded``: the streaming forms whose frames are
  not gulp-resident (``x(t+1)``, ``x(nt-1-t)``, a temp's history, a
  stencil beside a whole-array read, a permuted left-hand index, which
  the plain engine ignores as the JAX package's ``_stream_eval`` does),
  on the gulp alone: every time index computed per element with
  ``wrapclamp``, temps recomputed where they are read.  The element
  path only (V = 1).

In every form a tensor of one axis or more bound as a scalar is a
constant array, read at the output's coordinates through its broadcast
strides (`Input.bcast`), and a statement that depends on no array is a
scalar (broadcast to the output grid in the explicit forms, as the
plain engine broadcasts it).

``extra_code`` helpers are inlined (`_Inliner`): a helper of
straight-line assignments ending in one ``return``, over the map
namespace, ``torch.<f>`` of the same meaning and other such helpers,
called with positional arguments, becomes the expression it returns.

Refused, with the reason `Refusal` carries (what 'auto' runs on the
plain engine): an ``extra_code`` helper that cannot be inlined (a loop,
a branch, keyword arguments, a global other than ``torch``/``np``,
recursion, an attribute call outside `_TORCH_SAME`), a statement that
reads an array an earlier statement scattered into (the eager call runs
such a program as the programs ops/map.py `_scatter_segments` cuts
before each such statement), and in the forms
'auto' ran on the plain engine before M1 took them (`NEW_FORMS`, and
programs with ``extra_code``) whatever the kernel does not implement.

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
import copy
import hashlib
import math
import re
import struct
import warnings
from collections import OrderedDict

import torch

MAX_RANK = 8
FORMS = ("elementwise", "local", "stencil", "eager", "forward", "unbounded")
# The forms whose programs 'auto' ran on the plain engine before M1 took
# them: the eager call's explicit form, 'gather' (its scatters
# included), and the streaming forms whose frames are not gulp-resident.
# What the kernel does not implement there stays a `Refusal`.
NEW_FORMS = ("gather", "forward", "unbounded")
# The launch header, the first meta words (map_kernel.pack): n output
# elements, ncarry carry elements, the path (1 vector, 0 element, 2 the
# gather form's tile), nd
# axes that are not padding (the elementwise and eager forms), nvec
# vector items (elementwise, eager), nci channel items and nruns frame
# runs (local, stencil), the input's channel extent and its divider (the
# stencil's carry), and a scatter's pass (0 none, 1 the owners, 2 the
# writes, 3 an injective scatter's one pass).
HEADER = ("n", "ncarry", "vec", "nd", "nvec", "nci", "nruns", "chan",
          "chan_m", "chan_s", "pass")
BLOCK = 256
# The gather form's tile path (`tile_geometry`): (TP, TQ) by the element
# size of its widest turned read, at most TILE_SLOTS reads in shared
# memory, TILE_BYTES of it a block.
TILES = {1: (64, 64), 2: (64, 64), 4: (32, 32), 8: (32, 32), 16: (32, 32)}
TILE_SLOTS = 4
TILE_BYTES = 40 * 1024
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
    """A program the generator refuses (an ``extra_code`` helper it
    cannot inline, a read of a scattered array, what the kernel does not
    implement in a form the plain engine ran before M1 took it): 'auto'
    runs it on the plain engine.  `reason` says why."""

    @property
    def reason(self):
        return self.args[0]


def _read_scattered(name):
    return Refusal(f"a statement reads {name!r} after a statement "
                   f"scattered into it: M1 computes each statement at its "
                   f"own coordinates in one pass, and a scatter's result "
                   f"is whole only after the pass")


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
        # the statement each output writes: the last of its name
        self.out_idx = [max(i for i, s in enumerate(statements)
                            if s[0] == n) for n in self.out_names]
        # The eager call's forms: broadcasting ('eager') and explicit
        # ('gather'); in the latter a statement whose left-hand index is
        # not the axis names scatters into a copy of its target.
        self.eager = form in ("eager", "gather")
        self.scatter_stmt = {
            k for k, (_n, idx, _r) in enumerate(statements)
            if form == "gather" and idx is not None and
            tuple(idx) != self.axis_names}
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
        self.uses_coords = form == "gather"
        self.window = False
        self.two_d = form in ("local", "stencil", "forward", "unbounded")
        self.bare_names = set()      # inputs a gather form reads whole
        # The gather form's affine reads ('sites'): (input index, its
        # components (sign, grid axis, offset source) an input axis), each
        # read from ``pre.r<site>`` on the tile and vector paths; and the
        # components of a scatter whose left-hand index is a permutation
        # of the grid axes (`one_pass`: statement, components).
        self.sites = []
        self.one_pass = None
        self._collect_sites = form == "gather"

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
        for k in self.out_idx:
            self.out_off.append(off)
            if k in self.scatter_stmt:
                # a scatter's target: its shape, then its strides
                off += 2 * self.target(k).rank
                continue
            # the eager forms: a mask of the axes an output of a smaller
            # shape is written at coordinate 0 only
            off += rank + self.eager
        self.in_off = []
        for inp in self.inputs:
            shape_off = off
            stride_off = off + inp.rank
            cs_off = stride_off + inp.rank
            off = cs_off + 1
            bs_off = None
            if self.form == "eager" or inp.bcast or \
                    inp.name in self.bare_names:
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
        # inputs, outputs, the stencil's carry in and out, then each
        # scattered output's owner words
        self.owner_ptr = {}
        nptr = len(self.inputs) + len(self.out_names) + 2
        for j, k in enumerate(self.out_idx):
            if k in self.scatter_stmt:
                self.owner_ptr[j] = nptr
                nptr += 1
        self.nptr = nptr

    def size_word(self, d):
        """The C expression of the grid's extent along axis `d`: the
        gather form keeps the grid's shape apart (`GSH`), since a one-pass
        scatter walks its target's shape."""
        if self.form == "gather":
            return f"p.m[GSH + {d}]"
        return f"p.m[{self.shape_off + d}]"

    def gather_layout(self):
        """The gather form's meta words after the scalars and the hoisted
        values: the grid's shape (`GSH`), a one-pass scatter's offsets
        (`CMAP`: c[a] = +-y[b] + word a), each affine read's words
        (`site_off`: its offset at grid coordinate 0, its step a grid
        axis, its path mode) and the tile's (`TILEW`: the axes p and q,
        the tiles along each, the tiles in all)."""
        R = self.R
        self.gsh_off = self.nmeta
        self.cmap_off = self.gsh_off + R
        self.site_off = [self.cmap_off + R + (R + 2) * r
                         for r in range(len(self.sites))]
        self.tile_off = self.cmap_off + R + (R + 2) * len(self.sites)
        self.nmeta = self.tile_off + 5

    def _affine(self, nodes, env):
        """Index expressions `nodes` -> their components (sign, grid axis,
        offset source) where each is ``+-axis + offset`` over distinct
        axes, or an offset alone (sign 0), the offset an int expression
        of literals, int scalars and sizes (evaluated at launch,
        `Program.offsets`); None otherwise."""
        comps, used = [], set()
        for n in nodes:
            a = self._affine1(n, env)
            if a is None or abs(a[0]) > 1 or (a[0] and a[1] in used):
                return None
            if a[0]:
                used.add(a[1])
            comps.append((a[0], a[1] if a[0] else None, a[2]))
        return comps

    def _affine1(self, node, env):
        if isinstance(node, ast.Name):
            kind, v = env.get(node.id, (None, None))
            if kind == "axis":
                return 1, v, "0"
            if kind == "size" or (kind in ("scalar", "const") and
                                  type(v) is int):
                return 0, None, node.id
            return None
        if isinstance(node, ast.Constant):
            return (0, None, repr(node.value)) \
                if type(node.value) is int else None
        if isinstance(node, ast.UnaryOp) and \
                isinstance(node.op, (ast.USub, ast.UAdd)):
            a = self._affine1(node.operand, env)
            if a is None or isinstance(node.op, ast.UAdd):
                return a
            return -a[0], a[1], f"-({a[2]})"
        if not isinstance(node, ast.BinOp):
            return None
        a, b = self._affine1(node.left, env), self._affine1(node.right, env)
        if a is None or b is None or (a[0] and b[0]):
            return None
        if isinstance(node.op, (ast.Add, ast.Sub)):
            sg = 1 if isinstance(node.op, ast.Add) else -1
            return (a[0] + sg * b[0], a[1] if a[0] else b[1],
                    f"({a[2]}) {'+' if sg > 0 else '-'} ({b[2]})")
        if isinstance(node.op, ast.Mult) and not (a[0] or b[0]):
            return 0, None, f"({a[2]}) * ({b[2]})"
        return None

    def target(self, k):
        """The input a scatter statement `k` writes a copy of."""
        name = self.statements[k][0]
        k_in = self.input_index.get(name)
        if k_in is None:
            raise KeyError(f"map: the scatter target {name!r} is not an "
                           f"array of the call")
        return self.inputs[k_in]

    def out_dtype(self, j):
        """Output `j`'s dtype: its statement's value, or a scatter
        target's own."""
        k = self.out_idx[j]
        if k in self.scatter_stmt:
            return self.target(k).dtype
        return _value_dtype(self.stmt_types[k])

    def scan_bare(self, trees):
        """The inputs the gather form reads whole (through broadcast
        strides): a name not indexed, before any statement of that
        name."""
        assigned = set()
        for k, tree in enumerate(trees):
            for t in [tree] + self.idx_trees.get(k, []):
                indexed = {id(n.value) for n in ast.walk(t)
                           if isinstance(n, ast.Subscript)}
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and id(n) not in indexed and \
                            n.id in self.input_index and \
                            n.id not in assigned:
                        self.bare_names.add(n.id)
            assigned.add(self.statements[k][0])

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
            env[self.statements[k][0]] = \
                ("scattered" if k in self.scatter_stmt else "stmt", k)
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
        # (the gather form's `pre` holds its affine reads alone)
        pre = not self.two_d and self.form != "gather"
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
        if bare and k == 0 and self.form == "local":
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
            return _Val(self.size_word(v), 1, host=True)
        if kind == "input":
            if self.form == "stencil" and not v.bcast:
                raise Unsupported("a whole-array reference in a stencil")
            return _Val(self.load(f, v, "c", bare=True), _rep_of(v.dtype))
        if kind == "scattered":
            raise _read_scattered(node.id)
        # an earlier statement, at this element's coordinates
        rep = self.stmt_types[v]
        return _Val(f.let(_ctype_of(rep), f"s{v}<I, PRE>(p, c, pre)"), rep,
                    host=self.stmt_host[v])

    def _Subscript(self, f, node, env):
        if not isinstance(node.value, ast.Name):
            raise Unsupported(f"indexing {ast.unparse(node.value)!r}")
        b = env.get(node.value.id)
        if b is not None and b[0] == "scattered":
            raise _read_scattered(node.value.id)
        if b is None or b[0] not in ("input", "stmt"):
            raise TypeError(f"map: indexing {node.value.id!r}, which is not "
                            f"an array")
        sl = node.slice
        idx_nodes = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        idx = self._indices(f, idx_nodes, env)
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
            comps = self._affine(idx_nodes, env) \
                if self._collect_sites else None
            if comps is not None:
                # an affine read: on the tile and vector paths its value
                # comes in `pre` (the launch checked it stays inside)
                r = len(self.sites)
                self.sites.append((k, comps))
                mem = self._ld(k, [f"{name}[{d}]" for d in range(inp.rank)])
                return _Val(f.let(C_TYPES[inp.dtype],
                                  f"PRE ? pre.r{r} : {mem}"),
                            _rep_of(inp.dtype, dim0))
            return _Val(self.load(f, inp, name,
                                  window=self._window_offset(k, idx_nodes)),
                        _rep_of(inp.dtype, dim0))
        k = b[1]                         # an earlier statement
        if len(idx) != self.R:
            raise IndexError(f"map: {node.value.id!r} takes {self.R} "
                             f"indices, got {len(idx)}")
        f.lines.append(f"  const I {name}[{self.R}] = {{" + ", ".join(
            f"wrapclamp<I>({v.code}, (I){self.size_word(d)})"
            for d, v in enumerate(idx)) + "};")
        rep = self.stmt_types[k]
        return _Val(f.let(C_TYPES[rep.dtype],
                          f"s{k}<I, false>(p, {name}, pre)"),
                    _rep_of(rep.dtype, dim0))

    def _indices(self, f, idx_nodes, env):
        """Index expressions -> their values, each an integer (the plain
        engine raises IndexError on any other)."""
        idx = [self.expr(f, n, env) for n in idx_nodes]
        for n, v in zip(idx_nodes, idx):
            dt = v.rep.dtype if v.is_tensor else type(v.rep)
            if dt in (bool, torch.bool) or dt in (float, complex) or \
                    (v.is_tensor and (dt.is_floating_point or
                                      dt.is_complex)):
                raise IndexError(f"map: index {ast.unparse(n)!r} is not "
                                 f"an integer")
        return idx

    def _window_offset(self, k, idx_nodes):
        """k in ``x(t - k, <axis 1>, ..., <axis R-1>)``: a read of the
        streaming input at the output's own channels, `k` frames back
        (0 in the local form), which the vector path takes from its
        register window; None for any other read."""
        if self.form not in ("local", "stencil") or k != 0 or \
                self.inputs[0].bcast or \
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
        if v.dim0 and self.form != "elementwise" and self.form != "eager":
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
        if k in self.scatter_stmt:
            self._targets(k, env)
        return rep

    def _targets(self, k, env):
        """A scatter statement's target function ``t<k>``: its target
        index at the source coordinates c (each wrapped once if negative,
        jnp's ``.at[]``) into `t`, false where an index stays outside its
        axis (the update is dropped)."""
        f = _Func(self)
        inp = self.target(k)
        trees = self.idx_trees[k]
        if len(trees) != inp.rank:
            raise IndexError(f"map: a {inp.rank}-d array scattered with "
                             f"{len(trees)} indices")
        self._collect_sites = False
        idx = self._indices(f, trees, env)
        self._collect_sites = self.form == "gather"
        so = self.out_off[self.out_idx.index(k)] \
            if k in self.out_idx else None
        if so is None:
            return                       # overwritten by a later statement
        comps = self._affine(trees, env)
        if comps is not None and self.out_idx == [k] and \
                inp.rank == self.R and \
                sorted(a for _, a, _ in comps if a is not None) == \
                list(range(self.R)):
            # a permutation of the grid axes, each +-1: injective where
            # the launch finds every index inside the target (one pass)
            self.one_pass = (k, comps)
        f.lines.append("  bool ok = true;")
        f.lines += [f"  t[{d}] = wrapdrop<I>({v.code}, (I)p.m[{so + d}], "
                    f"ok);" for d, v in enumerate(idx)]
        self.funcs.append(
            f"template <typename I, bool PRE>\n"
            f"MAP_HD bool t{k}(const P& p, const I* c, const Pre& pre, "
            f"I* t) {{\n" + "\n".join(f.lines) + "\n  return ok;\n}\n")

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


# torch functions that are a map namespace function of the same meaning
# on tensors, by the namespace's name (an inlined helper may call them).
_TORCH_SAME = {f: f for f in (
    "exp", "log", "log2", "log10", "sin", "cos", "tan", "asin", "acos",
    "atan", "atan2", "sinh", "cosh", "tanh", "sqrt", "abs", "floor", "ceil",
    "round", "erf", "erfc", "conj", "real")}
_TORCH_SAME.update(minimum="min", maximum="max")
# numpy's constants an inlined helper may read.
_NP_CONSTS = {"pi": math.pi, "e": math.e}


class _Helper(object):
    """An inlinable ``extra_code`` helper: its parameters, its local
    assignments in order and its returned expression (AST nodes)."""

    def __init__(self, params, assigns, ret):
        self.params, self.assigns, self.ret = params, assigns, ret


class _Inliner(ast.NodeTransformer):
    """``extra_code`` helpers inlined into the expressions that call them.

    A helper is inlined when its body is straight-line assignments to
    local names ending in one ``return``, calling only functions of the
    map namespace, ``torch.<f>`` where ``<f>`` is one of them
    (`_TORCH_SAME`), and other inlinable helpers, with positional
    arguments; operators, comparisons and ``where`` (the translator's
    ternary) are allowed, and ``np.pi``/``np.e`` read as numbers.  The
    call is replaced by the helper's returned expression, its parameters
    and locals substituted by the expressions they stand for: the plain
    engine evaluates a helper's operators as it evaluates the program's
    (ops/map.py `_full_namespace`), so the inlined expression has the
    helper's types and values, Python numbers staying weakly typed.
    Anything else is a `Refusal` naming the construct."""

    def __init__(self, extra_code, ns):
        self.ns = ns
        self.table = _helper_table(extra_code) if extra_code else {}
        self.stack = []
        self.env = {}

    def expand(self, tree):
        if not self.table:
            return tree
        return self.visit(copy.deepcopy(tree))

    def visit_Call(self, node):
        fname = node.func.id if isinstance(node.func, ast.Name) else None
        if fname not in self.table or fname in self.env:
            return self.generic_visit(node)
        h = self.table[fname]
        if isinstance(h, str):
            raise Refusal(f"extra_code helper {fname!r}: {h}")
        if node.keywords:
            raise Refusal(f"extra_code helper {fname!r}: keyword "
                          f"arguments")
        if any(isinstance(a, ast.Starred) for a in node.args):
            raise Refusal(f"extra_code helper {fname!r}: a starred "
                          f"argument")
        if len(node.args) != len(h.params):
            raise Refusal(f"extra_code helper {fname!r} takes "
                          f"{len(h.params)} arguments, called with "
                          f"{len(node.args)}")
        if fname in self.stack:
            raise Refusal(f"extra_code helper {fname!r}: recursion")
        args = [self.visit(a) for a in node.args]
        outer = self.env
        self.stack.append(fname)
        try:
            self.env = dict(zip(h.params, args))
            for name, value in h.assigns:
                self.env[name] = self._body(fname, value)
            return self._body(fname, h.ret)
        finally:
            self.env = outer
            self.stack.pop()

    def _body(self, fname, node):
        """A helper's expression with its names substituted."""
        return _Substitute(self, fname).visit(copy.deepcopy(node))


class _Substitute(ast.NodeTransformer):
    """One helper expression: parameters and locals -> their expressions,
    ``torch.<f>`` -> the namespace's ``<f>``, ``np.pi`` -> its value,
    calls of helpers inlined."""

    def __init__(self, inliner, fname):
        self.inl, self.fname = inliner, fname

    def refuse(self, what):
        return Refusal(f"extra_code helper {self.fname!r}: {what}")

    def visit_Name(self, node):
        env = self.inl.env
        if node.id in env:
            return copy.deepcopy(env[node.id])
        if node.id in self.inl.ns and node.id not in ("torch", "np"):
            return node
        raise self.refuse(f"the global name {node.id!r}")

    def visit_Attribute(self, node):
        base = node.value.id if isinstance(node.value, ast.Name) else None
        if base == "np" and node.attr in _NP_CONSTS:
            return ast.copy_location(ast.Constant(_NP_CONSTS[node.attr]),
                                     node)
        raise self.refuse(f"the attribute {ast.unparse(node)!r}")

    def visit_Call(self, node):
        if node.keywords:
            raise self.refuse(f"keyword arguments in "
                              f"{ast.unparse(node)!r}")
        fn = node.func
        if isinstance(fn, ast.Attribute):
            base = fn.value.id if isinstance(fn.value, ast.Name) else None
            if base != "torch" or fn.attr not in _TORCH_SAME:
                raise self.refuse(f"the call {ast.unparse(fn)!r} (an "
                                  f"attribute call that is not a map "
                                  f"function)")
            node.func = ast.copy_location(
                ast.Name(_TORCH_SAME[fn.attr], ast.Load()), fn)
            node.args = [self.visit(a) for a in node.args]
            return node
        if not isinstance(fn, ast.Name) or fn.id in self.inl.env:
            raise self.refuse(f"the call {ast.unparse(node)!r}")
        node.args = [self.visit(a) for a in node.args]
        if fn.id in self.inl.table:
            return self.inl.visit_Call(node)
        if not callable(self.inl.ns.get(fn.id)):
            raise self.refuse(f"the global name {fn.id!r}")
        return node

    def generic_visit(self, node):
        if type(node) in _HELPER_REFUSED:
            raise self.refuse(_HELPER_REFUSED[type(node)])
        return super().generic_visit(node)


_HELPER_REFUSED = {ast.IfExp: "a branch (a conditional expression)",
                   ast.BoolOp: "a branch ('and'/'or')",
                   ast.Subscript: "indexing", ast.Lambda: "a lambda",
                   ast.ListComp: "a comprehension",
                   ast.GeneratorExp: "a comprehension",
                   ast.Starred: "a starred argument",
                   ast.NamedExpr: "an assignment expression"}


def _helper_table(extra_code):
    """``extra_code``'s helpers -> {name: `_Helper`, or the reason it is
    not inlinable}."""
    table = {}
    for st in ast.parse(extra_code).body:
        if isinstance(st, ast.FunctionDef):
            table[st.name] = _helper_of(st)
        elif isinstance(st, ast.AsyncFunctionDef):
            table[st.name] = "an async function"
        else:
            # a helper defined otherwise (a lambda, an import) is called
            # as the plain engine calls it: not inlined
            for t in ast.walk(st):
                if isinstance(t, ast.Name) and isinstance(t.ctx, ast.Store):
                    table.setdefault(t.id, "not a def of straight-line "
                                           "assignments and a return")
    return table


def _helper_of(fd):
    a = fd.args
    if fd.decorator_list:
        return "a decorator"
    if a.posonlyargs or a.vararg or a.kwonlyargs or a.kwarg or a.defaults:
        return "parameters that are not plain positional ones"
    body = list(fd.body)
    if body and isinstance(body[0], ast.Expr) and \
            isinstance(body[0].value, ast.Constant) and \
            isinstance(body[0].value.value, str):
        body = body[1:]                  # the docstring
    what = {ast.For: "a loop", ast.While: "a loop", ast.If: "a branch",
            ast.AugAssign: "an augmented assignment (in place on a "
                           "tensor)",
            ast.Global: "a global statement",
            ast.Nonlocal: "a nonlocal statement", ast.Try: "a try block",
            ast.With: "a with block"}
    assigns = []
    for st in body[:-1]:
        if isinstance(st, ast.Assign) and len(st.targets) == 1 and \
                isinstance(st.targets[0], ast.Name):
            assigns.append((st.targets[0].id, st.value))
            continue
        return what.get(type(st), f"the statement {ast.unparse(st)!r}")
    if not body or not isinstance(body[-1], ast.Return) or \
            body[-1].value is None:
        last = body[-1] if body else None
        return what.get(type(last), "no final return of a value")
    return _Helper([p.arg for p in a.args], assigns, body[-1].value)


def helper_refusal(statements, arrays, ns, extra_code):
    """Why an ``extra_code`` helper the program calls cannot be inlined
    (`_Inliner`), or None: what 'auto' then runs on the plain engine."""
    if not extra_code:
        return None
    reserved = frozenset(ns)
    inliner = _Inliner(extra_code, ns)
    trees = _trees(statements, arrays, reserved) + list(_idx_trees(
        statements, arrays, reserved,
        [k for k, s in enumerate(statements) if s[1]]).values())
    try:
        for t in trees:
            for n in (t if isinstance(t, list) else [t]):
                inliner.expand(n)
    except Refusal as r:
        return r.reason
    return None


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


def _idx_trees(statements, arrays, reserved, scatter_stmt):
    """Each scatter statement's left-hand index expressions, parsed."""
    from .map import _rewrite_indexing
    return {k: [ast.parse(_rewrite_indexing(ix, arrays, reserved),
                          mode="eval").body for ix in statements[k][1]]
            for k in scatter_stmt}


def generate(statements, form, inputs, ns, arrays, out_names,
             axis_names=None, scalars=None, noffset=0, extra_code=None,
             out_rank=None, explicit=None):
    """Translated `statements` (ops/map.py `_CompiledMap.statements`) ->
    a `Program`; raises `Refusal` for a program the generator refuses and
    `Unsupported` for what the kernel does not implement.

    form: one of `FORMS` ('eager' of the explicit form is the 'gather'
    form); explicit: whether the program is the explicit-index form
    (default: whether a statement is indexed; a segment of an explicit
    program is, whatever its own statements); extra_code: the helpers to
    inline; inputs: the `Input`s the kernel reads (the streaming input
    first); ns: the plain engine's namespace (its functions give every
    node's type); arrays: the names `_rewrite_indexing` rewrites; out_names:
    the statements written out (the last one for a stream, every one for the
    eager call); scalars: name -> value of the run-time scalars; out_rank:
    the output rank."""
    if form not in FORMS:
        raise ValueError(f"unknown map form {form!r}")
    if explicit is None:
        explicit = any(s[1] is not None for s in statements)
    if form == "eager" and explicit:
        form = "gather"
    try:
        return _generate(statements, form, inputs, ns, arrays, out_names,
                         axis_names, scalars, noffset, extra_code, out_rank)
    except Unsupported as u:
        if extra_code or form in NEW_FORMS:
            # What the kernel does not implement, in a program the plain
            # engine ran under 'auto' before M1 took these forms, stays
            # there: refused, with the reason.
            raise Refusal(u.reason) from None
        raise


def _generate(statements, form, inputs, ns, arrays, out_names, axis_names,
              scalars, noffset, extra_code, out_rank):
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
    reserved = frozenset(k for k, v in ns.items())
    inliner = _Inliner(extra_code, ns)
    gen.trees = [inliner.expand(t) for t in _trees(statements, arrays,
                                                    reserved)]
    gen.idx_trees = {k: [inliner.expand(t) for t in ts]
                     for k, ts in _idx_trees(statements, arrays, reserved,
                                             gen.scatter_stmt).items()}
    if form == "gather":
        gen.scan_bare(gen.trees)
    gen.layout(rank)
    for k, tree in enumerate(gen.trees):
        gen.statement(k, tree)
    if form == "gather":
        gen.gather_layout()
    return Program(gen, gen.out_idx)


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
    if (gen.two_d and gen.R < 2) or gen.form in ("forward", "unbounded"):
        return 1                 # the streamed new forms: the element path
    ins = _streamed(gen)
    sizes = [storage_bytes(i) for i in ins] + \
        [d.itemsize for d in out_dtypes]
    v = max(_min_vec(gen), min(32, _pow2_floor(16 / max(sizes))))
    if gen.window and (gen.noffset + 1) * v * \
            gen.inputs[0].dtype.itemsize > VEC_BYTES:
        return 1
    return v


def tile_geometry(gen):
    """The tile path's geometry for the gather form's affine reads ->
    (TP, TQ, slots): a tile of TP grid steps along the turned reads'
    contiguous axis p by TQ along the output's innermost axis q (`TILES`
    by the widest slotted read's element size), and each slot (site,
    element size, row pitch in elements, byte offset) of the shared
    buffer; the first `TILE_SLOTS` reads that fit `TILE_BYTES` have one."""
    sizes = [gen.inputs[k].dtype.itemsize for k, _ in gen.sites]
    if not sizes:
        return 0, 0, []
    tp, tq = TILES[max(sizes[:TILE_SLOTS])]
    slots, off = [], 0
    for r, es in enumerate(sizes[:TILE_SLOTS]):
        pitch = tp + max(1, 4 // es)      # odd words a row: no conflicts
        nb = -(-tq * pitch * es // 16) * 16
        if off + nb > TILE_BYTES:
            break
        slots.append((r, es, pitch, off))
        off += nb
    return tp, tq, slots


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
        self.out_dtypes = [gen.out_dtype(j) for j in range(len(out_idx))]
        # The outputs a scatter writes (a copy of its target, made by the
        # launch), each with its target's rank; such a program is two
        # launches: the owners of every target, then the writes.
        self.scatters = {j: gen.target(k).rank for j, k in enumerate(out_idx)
                         if k in gen.scatter_stmt}
        self.scatter_input = {j: gen.input_index[gen.statements[k][0]]
                              for j, k in enumerate(out_idx)
                              if k in gen.scatter_stmt}
        # the inputs read through broadcast strides at the output's
        # coordinates (the eager call's, and constant arrays)
        self.bcast_reads = [o[3] is not None for o in gen.in_off]
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
        # The gather form's affine reads (input index, components) and a
        # one-pass scatter's (statement, components); map_kernel checks
        # at each launch where they stay inside (`offsets`).
        self.sites = list(gen.sites)
        self.one_pass = gen.one_pass
        self.tile = tile_geometry(gen) if gen.form == "gather" else None
        self._offsets = None
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

    def offsets(self, scalars, grid):
        """The offsets of the affine reads' and the one-pass scatter's
        components at this launch, from the run-time `scalars` (name ->
        value) and the grid's sizes -> (a tuple for each site, the
        scatter's tuple or None); an offset that is not an int (a
        scalar's value) is None."""
        if self._offsets is None:
            def code(comps):
                return [compile(o, "<offset>", "eval") for _, _, o in comps]
            self._offsets = ([code(c) for _, c in self.sites],
                             code(self.one_pass[1]) if self.one_pass
                             else None)
        ns = dict(scalars)
        ns.update({f"n{ax}": int(n) for ax, n in zip(self._axis_names,
                                                      grid)})

        def ev(codes):
            out = []
            for c in codes:
                v = eval(c, {"__builtins__": {}}, ns)  # noqa: S307
                out.append(v if type(v) is int else None)
            return tuple(out)
        sites, one = self._offsets
        return (tuple(ev(c) for c in sites),
                ev(one) if one is not None else None)

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

    @staticmethod
    def _unflatten_src(gen):
        H = {k: i for i, k in enumerate(HEADER)}
        SH = gen.shape_off
        return f"""// Coordinates of element (item) e over the element (item) extents: the
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
}}"""

    def _gather_src(self, gen, out_idx, stores, out_off):
        """The gather form's items over the walked shape Y (the grid, or
        a one-pass scatter's target): `to_grid` (grid coordinates c of
        y, and whether c lies in the grid), `site_at` (an affine read's
        offset at c), the element item, the vector item (each affine
        read one vector access, forward or reversed, or one load), and
        the tile's phases over (tile, thread, shared buffer): `tile_load`
        moves each turned read's tile into shared memory along the
        input's contiguous axis, `tile_store` computes each output from
        it along the output's innermost axis -> (parts, kernel body,
        host body, tile kernel and launch, host tile walk)."""
        R, V, CH = gen.R, self.vec, self.chunk
        nin = len(gen.inputs)
        H = {k: i for i, k in enumerate(HEADER)}
        SH = gen.shape_off
        one = gen.one_pass
        parts = []
        if one is not None:
            cm = "\n".join(
                f"    c[{a}] = {'-' if sg < 0 else ''}y[{d}] + "
                f"(I)p.m[CMAP + {a}];" for d, (sg, a, _) in enumerate(one[1]))
            ing = " &&\n           ".join(
                f"c[{a}] >= 0 && c[{a}] < (I)p.m[GSH + {a}]"
                for a in range(R))
            cm = (f"  if (p.m[PASS] == 3) {{\n{cm}\n    return {ing};\n"
                  f"  }}\n")
        else:
            cm = ""
        parts.append(f"""// The grid coordinates c of walked coordinates y: y itself, or under a
// one-pass scatter (pass 3) the source of target element y; false where
// c lies outside the grid (the target element keeps its value).
template <typename I>
MAP_HD bool to_grid(const P& p, const I* y, I* c) {{
{cm}#pragma unroll
  for (int d = 0; d < R; ++d) c[d] = y[d];
  return true;
}}

// An affine read's storage offset at grid coordinates c, from its words
// at w (the offset at c = 0, then its step a grid axis), in the unsigned
// type: the launch checked that it lies inside the input.
template <typename I>
MAP_HD I site_at(const P& p, int w, const I* c) {{
  using U = typename std::make_unsigned<I>::type;
  U a = (U)p.m[w];
#pragma unroll
  for (int d = 0; d < R; ++d) a += (U)p.m[w + 1 + d] * (U)c[d];
  return (I)a;
}}""")
        sw = gen.site_off

        def site_ld(r, c):
            k = gen.sites[r][0]
            return gen._ld_at(k, f"p.ptr[{k}]",
                              f"site_at<I>(p, {sw[r]}, {c})", None)

        parts.append(f"""template <typename I>
MAP_HD void elem_item(const P& p, I e) {{
  I y[R], c[R];
  unflatten<I, {gen.dive_off}>(p, e, y);
  const bool ing = to_grid<I>(p, y, c);
  (void)ing;
  const Pre pre{{}};
{stores("c", "pre", "false", "e", "y", "ing")}
}}""")
        if V > 1:
            fields, loads, fill = [], [], []
            for r, (k, _) in enumerate(gen.sites):
                ct = C_TYPES[gen.inputs[k].dtype]
                nb = V * gen.inputs[k].dtype.itemsize
                fields.append(f"uint32_t w{r}[{(nb + 3) // 4}]; {ct} s{r}; "
                              f"long long m{r};")
                loads.append(
                  f"  {{\n    const I a = site_at<I>(p, {sw[r]}, c);\n"
                  f"    it.m{r} = p.m[{sw[r] + R + 1}];\n"
                  f"    const {ct}* q = static_cast<const {ct}*>(p.ptr[{k}]);"
                  f"\n    if (it.m{r} == 1) vld_words<{nb}>(it.w{r}, q + a);\n"
                  f"    else if (it.m{r} == 2) vld_words<{nb}>(it.w{r}, "
                  f"q + (a - (I)(V - 1)));\n"
                  f"    else it.s{r} = {site_ld(r, 'c')};\n  }}")
                part = _COMPLEX_PART.get(gen.inputs[k].dtype)
                ex = (f"ex_cx<{part}>" if part else f"ex_real<{ct}>") + \
                    f"(it.w{r}, {{j}})"
                fill.append(f"        pre.r{r} = it.m{r} == 1 ? "
                            f"{ex.format(j='j')} : it.m{r} == 2 ? "
                            f"{ex.format(j='V - 1 - j')} : it.s{r};")
            ys, comp, sts = [], [], []
            for j, k in enumerate(out_idx):
                t = C_TYPES[gen.out_dtype(j)]
                if k in gen.scatter_stmt:
                    if one is None or one[0] != k:
                        continue          # a two-pass scatter: elements
                    rt, so = self.scatters[j], gen.out_off[j]
                    off = " + ".join(f"(I)it.y[{d}] * (I)p.m[{so + rt + d}]"
                                     for d in range(rt))
                    guard = "      "
                else:
                    off = out_off(j, "it.y")
                    guard = f"      if (!(nz & p.m[{gen.out_off[j] + R}])) "
                ys.append(f"      {t} o{j}[CH];")
                comp.append(f"        o{j}[jj] = cvt<{t}>(s{k}<I, true>(p, "
                            f"cj, pre));")
                sts.append(f"{guard}vst<CH>(p.ptr[{nin + j}], {off} + "
                           f"(I)(h * CH), o{j});")
            nz = "\n".join(f"  nz |= (long long)(it.y[{d}] != 0) << {d};"
                           for d in range(R - 1))
            parts.append(f"""// A vector item: V consecutive samples of y along the innermost axis,
// each affine read in one vector access (forward, or reversed: its words
// taken from the last), or one load where the read does not move along
// that axis; the statements on each sample, the outputs CH a store.
template <typename I>
struct Item {{ I y[R]; {' '.join(fields)} }};

template <typename I>
MAP_HD void vec_load(const P& p, I i, Item<I>& it) {{
  unflatten<I, {gen.divi_off}>(p, i, it.y);
  it.y[R - 1] *= V;
  I c[R];
  to_grid<I>(p, it.y, c);
{chr(10).join(loads)}
}}

template <typename I>
MAP_HD void vec_store(const P& p, const Item<I>& it) {{
  long long nz = 0;
{nz}
  (void)nz;
  I yj[R], cj[R];
#pragma unroll
  for (int d = 0; d < R; ++d) yj[d] = it.y[d];
#pragma unroll
  for (int h = 0; h < V / CH; ++h) {{
{chr(10).join(ys)}
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) {{
      const int j = h * CH + jj;
      yj[R - 1] = it.y[R - 1] + (I)j;
      to_grid<I>(p, yj, cj);
      Pre pre;
{chr(10).join(fill)}
{chr(10).join(comp)}
    }}
{chr(10).join(sts)}
  }}
}}""")
        tp, tq, slots = self.tile
        tile_kernel = tile_host = ""
        if slots:
            _, es, pitch, off = slots[-1]
            shb = off + -(-tq * pitch * es // 16) * 16     # bytes in all
            lds, pres = [], []
            slotted = {r: (es, pitch, off) for r, es, pitch, off in slots}
            for r, (k, _) in enumerate(gen.sites):
                ct = C_TYPES[gen.inputs[k].dtype]
                mode = f"p.m[{sw[r] + R + 1}]"
                if r in slotted:
                    _, pitch, off = slotted[r]
                    lds.append(f"    if ({mode} == 3)\n      reinterpret_cast"
                               f"<{ct}*>(sh + {off})[tq * {pitch} + tp] = "
                               f"{site_ld(r, 'c')};")
                    pres.append(f"    if ({mode} == 3) pre.r{r} = "
                                f"reinterpret_cast<const {ct}*>(sh + {off})"
                                f"[tq * {pitch} + tp];\n    else if (ing) "
                                f"pre.r{r} = {site_ld(r, 'c')};")
                else:
                    pres.append(f"    if (ing) pre.r{r} = {site_ld(r, 'c')};")
            walk = f"""  const int ap = (int)p.m[TILEW], aq = (int)p.m[TILEW + 1];
  const I np = (I)p.m[{SH} + ap] - p0, nq = (I)p.m[{SH} + aq] - q0;"""
            coords = """    I y[R], c[R];
#pragma unroll
    for (int d = 0; d < R; ++d)
      y[d] = y0[d] + (d == ap ? (I)tp : (I)0) + (d == aq ? (I)tq : (I)0);"""
            parts.append(f"""// The tile path: a block takes a tile of TP steps along the turned
// reads' contiguous axis p by TQ along the output's innermost axis q
// (the other axes fixed); each turned read's tile goes into shared
// memory along p (rows padded to an odd number of words), then each
// output is computed along q from it, the other reads read directly.
constexpr int TP = {tp}, TQ = {tq}, NT = {BLOCK}, SHB = {shb};

// Tile `tile`'s first coordinates y0 (its corner p0, q0 along p and q):
// q's tiles fastest, then p's, then the other axes, innermost first.
template <typename I>
MAP_HD void tile_origin(const P& p, long long tile, I* y0, I& p0, I& q0) {{
  const int ap = (int)p.m[TILEW], aq = (int)p.m[TILEW + 1];
  long long r = tile;
  q0 = (I)(r % p.m[TILEW + 3] * TQ);
  r /= p.m[TILEW + 3];
  p0 = (I)(r % p.m[TILEW + 2] * TP);
  r /= p.m[TILEW + 2];
#pragma unroll
  for (int d = R - 1; d >= 0; --d) {{
    if (d == aq) {{
      y0[d] = q0;
    }} else if (d == ap) {{
      y0[d] = p0;
    }} else {{
      y0[d] = (I)(r % p.m[{SH} + d]);
      r /= p.m[{SH} + d];
    }}
  }}
}}

// Thread t's share of the load phase: tile elements t, t + NT, ...,
// p fastest, so that a warp reads along the input's contiguous axis.
template <typename I>
MAP_HD void tile_load(const P& p, const I* y0, I p0, I q0, int t,
                      unsigned char* sh) {{
{walk}
#pragma unroll
  for (int u = 0; u < TP * TQ / NT; ++u) {{
    const int k = t + u * NT, tp = k % TP, tq = k / TP;
    if ((I)tp >= np || (I)tq >= nq) continue;
{coords}
    if (!to_grid<I>(p, y, c)) continue;
{chr(10).join(lds)}
  }}
}}

// Thread t's share of the compute phase: q fastest, so that a warp
// stores along the output's innermost axis.
template <typename I>
MAP_HD void tile_store(const P& p, const I* y0, I p0, I q0, int t,
                       const unsigned char* sh) {{
{walk}
#pragma unroll
  for (int u = 0; u < TP * TQ / NT; ++u) {{
    const int k = t + u * NT, tq = k % TQ, tp = k / TQ;
    if ((I)tp >= np || (I)tq >= nq) continue;
{coords}
    const bool ing = to_grid<I>(p, y, c);
    Pre pre;
{chr(10).join(pres)}
{stores("c", "pre", "true", None, "y", "ing")}
  }}
}}""")
            tile_kernel = f"""
template <typename I>
__global__ void __launch_bounds__(NT) map_tile(const P p) {{
  __shared__ __align__(16) unsigned char sh[SHB];
  for (long long tile = blockIdx.x; tile < p.m[TILEW + 4];
       tile += gridDim.x) {{
    I y0[R], p0, q0;
    tile_origin<I>(p, tile, y0, p0, q0);
    tile_load<I>(p, y0, p0, q0, (int)threadIdx.x, sh);
    __syncthreads();
    tile_store<I>(p, y0, p0, q0, (int)threadIdx.x, sh);
    __syncthreads();
  }}
}}

// The tile path's grid: at most four waves of the blocks the SMs hold.
template <typename I>
static int launch_tile(const P& p, cudaStream_t stream, int* info) {{
  static int occ = 0;
  if (occ == 0) {{
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, map_tile<I>, NT, 0);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) occ = 1;
  }}
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long g = p.m[TILEW + 4];
  const long long cap = (long long)(sms > 0 ? sms : 1) * occ * 4;
  if (g > cap) g = cap;
  if (info) {{
    info[0] = (int)g; info[1] = 1; info[2] = NT; info[3] = 1;
    info[4] = occ; info[5] = sms;
  }}
  map_tile<I><<<(unsigned)g, NT, 0, stream>>>(p);
  return (int)cudaGetLastError();
}}
"""
            tile_host = f"""  if (p.m[{H['vec']}] == 2) {{
    alignas(16) unsigned char sh[SHB];
    for (long long tile = 0; tile < p.m[TILEW + 4]; ++tile) {{
      I y0[R], p0, q0;
      tile_origin<I>(p, tile, y0, p0, q0);
      for (int t = 0; t < NT; ++t) tile_load<I>(p, y0, p0, q0, t, sh);
      for (int t = 0; t < NT; ++t) tile_store<I>(p, y0, p0, q0, t, sh);
    }}
    return;
  }}
"""
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
        host_body = f"""{tile_host}  using U = typename std::make_unsigned<I>::type;
  const U nvec = (U)p.m[{H['nvec']}];
{host_vec}  for (U e = nvec * V; e < (U)p.m[{H['n']}]; ++e) elem_item<I>(p, (I)e);"""
        return parts, kernel_body, host_body, tile_kernel, bool(slots)

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
        if gen.form == "gather":
            lines.append(f"constexpr int GSH = {gen.gsh_off}, CMAP = "
                         f"{gen.cmap_off}, TILEW = {gen.tile_off}, PASS = "
                         f"{H['pass']};")
            fields = [f"{C_TYPES[gen.inputs[k].dtype]} r{r};"
                      for r, (k, _) in enumerate(gen.sites)]
        elif gen.two_d:
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

        def stores(c, pre_val, PRE, e=None, y=None, ing=None):
            """The outputs' stores at coordinates `c` (a scatter's at
            source position `e`; the gather form's one-pass scatter at
            walked coordinates `y`, its source in the grid where `ing`)."""
            out = []
            if gen.eager:
                out.append("    long long nz = 0;\n" + "\n".join(
                    f"    nz |= (long long)({c}[{d}] != 0) << {d};"
                    for d in range(R)))
            if gen.scatter_stmt:
                out.append(f"    const long long ps = p.m[{H['pass']}];\n"
                           f"    using OW = typename std::conditional<"
                           f"sizeof(I) == 4, unsigned int, unsigned long "
                           f"long>::type;")
            for j, k in enumerate(out_idx):
                t = C_TYPES[gen.out_dtype(j)]
                val = f"cvt<{t}>(s{k}<I, {PRE}>(p, {c}, {pre_val}))"
                if k in gen.scatter_stmt:
                    code = []
                    if y is not None and gen.one_pass and \
                            gen.one_pass[0] == k:
                        code.append(one_pass_store(j, k, t, y, ing, val))
                    if e is not None:
                        code.append(scatter_store(j, k, t, c, pre_val, e,
                                                  val))
                    out.append("\n    else ".join(
                        x.lstrip() if i else x for i, x in enumerate(code)))
                    continue
                guard = f"if (!(nz & p.m[{gen.out_off[j] + R}])) " \
                    if gen.eager else ""
                if gen.scatter_stmt:
                    guard = "if (ps != 1) " + guard
                out.append(f"    {guard}st<{t}>(p.ptr[{nin + j}], "
                           f"{out_off(j, c)}, {val});")
            return "\n".join(out)

        def scatter_store(j, k, t, c, pre_val, e, val):
            """Output j's scatter at source position e: pass 1 raises
            its target's owner word to e + 1, pass 2 writes where the
            owner is e + 1 (the highest source position of the
            target)."""
            rt, so = self.scatters[j], gen.out_off[j]
            flat = "t_[0]"
            for d in range(1, rt):
                flat = f"({flat}) * (I)p.m[{so + d}] + t_[{d}]"
            off = " + ".join(f"t_[{d}] * (I)p.m[{so + rt + d}]"
                             for d in range(rt))
            own = f"static_cast<OW*>(p.ptr[{gen.owner_ptr[j]}])"
            return (f"    {{\n      I t_[{rt}];\n"
                    f"      if (t{k}<I, false>(p, {c}, {pre_val}, t_)) {{\n"
                    f"        const I fl = {flat};\n"
                    f"        const OW me = (OW)({e}) + 1;\n"
                    f"        if (ps == 1) owner_max<OW>({own} + fl, me);\n"
                    f"        else if ({own}[fl] == me)\n"
                    f"          st<{t}>(p.ptr[{nin + j}], {off}, {val});\n"
                    f"      }}\n    }}")

        def one_pass_store(j, k, t, y, ing, val):
            """Output j's injective scatter in pass 3 at target element y:
            its source's value where `ing`, else the target's own."""
            rt, so = self.scatters[j], gen.out_off[j]
            keep = gen._ld(self.scatter_input[j],
                           [f"{y}[{d}]" for d in range(rt)])
            off = " + ".join(f"(I){y}[{d}] * (I)p.m[{so + rt + d}]"
                             for d in range(rt))
            return (f"    if (ps == 3) st<{t}>(p.ptr[{nin + j}], {off}, "
                    f"{ing} ? {val} : cvt<{t}>({keep}));")

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
        tile_kernel, tiled = "", False
        if gen.form == "gather":
            parts.append(self._unflatten_src(gen))
            g_parts, kernel_body, host_body, tile_kernel, tiled = \
                self._gather_src(gen, out_idx, stores, out_off)
            parts += g_parts
        elif not gen.two_d:
            parts.append(self._unflatten_src(gen) + f"""

template <typename I>
MAP_HD void elem_item(const P& p, I e) {{
  I c[R];
  unflatten<I, {gen.dive_off}>(p, e, c);
  const Pre pre{{}};
{stores("c", "pre", "false", "e")}
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
        if gen.form == "gather":
            pass
        elif not gen.two_d:
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
        tile_launch = ""
        if tiled:
            tile_launch = (f"  if (p.m[{H['vec']}] == 2)\n    return idx64 ? "
                           f"launch_tile<long long>(p, (cudaStream_t)stream, "
                           f"info)\n                 : launch_tile<int>(p, "
                           f"(cudaStream_t)stream, info);\n")
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
{tile_kernel}
extern "C" int map_launch(const long long* m, void* const* ptr, int idx64,
                          void* stream, int* info) {{
  P p;
  for (int k = 0; k < {gen.nmeta}; ++k) p.m[k] = m[k];
  for (int k = 0; k < {gen.nptr}; ++k) p.ptr[k] = ptr[k];
  if (p.m[{H['n']}] + p.m[{H['ncarry']}] == 0) return 0;
{tile_launch}  return idx64 ? launch<long long>(p, (cudaStream_t)stream, info)
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
