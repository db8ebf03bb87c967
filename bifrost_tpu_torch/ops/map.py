"""bf.map, the ND transform mini-language (counterpart of
bifrost_tpu/ops/map.py; reference src/map.cpp NVRTC JIT engine +
python/bifrost/map.py language spec at map.py:62-112).

The string translator is the JAX package's, kept here as its own copy
and unchanged in behaviour (`_translate_expr`, `_rewrite_indexing`,
`_classify_stream`, ...).  What evaluates a translated program differs:

- the plain engine evaluates the translated statements with PyTorch in
  place of jnp (`_full_namespace`): the same operators and functions, so
  PyTorch's type promotion, which for these operators is JAX's (Python
  scalars weakly typed).  ``x(i, j)`` indexing gathers with jnp's
  semantics (a negative index wraps once, then it is clamped); ``/`` and
  ``//`` by a scalar divide (PyTorch's reflected ``/`` and its card
  kernels would multiply by the reciprocal).  The eager scatter
  (``c(nj-1-j) = a(j)``) has ``.at[idx].set``'s semantics
  (`scatter_targets`): an index wraps once if negative, an update still
  out of bounds is dropped, and where targets repeat the update of the
  highest source position (row-major) wins, chosen by an ``amax`` of
  positions so that the rule holds on the card.  Two quirks of the JAX
  package are kept: the scatter writes into a copy of the ORIGINAL
  target (the right-hand side reads the original too), and the
  streaming forms ignore the left-hand index, as its ``_stream_eval``
  does;
- kernel M1 (ops/map_codegen.py, ops/map_kernel.py): the same program
  as ONE generated CUDA kernel, built by nvcc at first use.  The JAX
  package's counterpart is the one XLA program its jitted closure
  compiles into; the reference's, the kernel NVRTC compiled.

Caching is explicit and bounded (the retention contract of
:class:`.runtime.OpRuntime`): the translation cache (`_compile_map`) and
each translation's closure cache (`_CompiledMap._fn_cache`) are 64-entry
LRUs, the streaming :class:`Map` plan keeps its programs on an
``OpRuntime("map", ("cuda", "plain"))`` keyed on the RESOLVED method, and
build.py keeps 64 loaded kernel libraries (``build/map/`` on disk plays
the reference's ~/.bifrost PTX cache).

Two entry points share one translator:

- :func:`map` — the reference's eager call: named arrays in, outputs
  written/returned, arbitrary shapes/broadcasting per call.
- :class:`Map` — the PLANNED streaming form behind ``blocks.MapBlock``:
  ONE streaming input (frame axis leading), scalars bound per plan, and
  the step exposed for the fusion compiler (fuse.py) so user
  expressions join fused device chains.  Expressions indexing bounded
  NEGATIVE time offsets (``y(i) = x(i) - x(i-1)``) compile to a stencil
  carry form: a (max_offset)-frame history tail threads between gulps via
  the fused-carry protocol, so split gulps == one long gulp bitwise.
  Forward (``x(i+1)``) or unbounded (``x(n-1-i)``) time indexing cannot
  stream gulp-resident and is refused from fusion (reason
  ``map_unbounded_index``); ci8 and wider pairs and packed ci4, ci2
  and ci1 ring storage is read raw (in the kernel, or lifted by the
  plain engine).  A tensor bound as a scalar is a constant array of the
  program (0-d: a scalar read at each call).

Methods (the ``map_method`` config flag when None/'auto'): 'auto'
resolves to 'cuda' (M1) for a CUDA tensor and to 'plain' for a CPU one;
'cuda' runs M1 (its plain version on a CPU tensor); 'plain' runs the
plain engine on any device.  M1 takes every form: elementwise, local,
stencil, forward and unbounded streams, the eager broadcasting,
explicit-index and scatter calls (a statement that reads what an earlier
one scattered starts a program of its own, `_scatter_segments`), and
inlinable ``extra_code`` helpers.  What the generator refuses
(`map_codegen.Refusal`, `codegen_refusal`: a helper it cannot inline, a
scatter into an array an earlier program of the call wrote, and what
the kernel does not implement in a form the plain engine ran before M1
took it) 'auto' resolves to 'plain' and says why in ``plan_report()``;
'cuda' raises with the reason.  What the
kernel does not implement in the other forms (`map_codegen.Unsupported`:
complex32, an indexed form of rank above 8) raises for a CUDA tensor
under 'auto' and 'cuda' alike; 'plain' runs it.  The JAX package's
'jnp' and 'pallas' are refused with the name of their counterparts
here.

Supported forms (all from the reference's docstring/examples):
- elementwise with broadcasting:       ``bf.map("c = a + b", {'c':c,'a':a,'b':b})``
- multiple statements:                 ``"a = c.real; b = c.imag"``
- explicit indexing with axis names:   ``"c(i,j) = a(j,i)"`` (axis_names, shape)
- index arithmetic:                    ``"c(i) = a(i, k)"``, ``"y(i) = x(n-1-i)"``
- scalars in `data` inlined by value; C-isms translated: ``.real``, ``.imag``,
  ``.conj()``, ``.mag2()`` (incl. on parenthesized/indexed expressions),
  ``a**b``/``pow``, ``exp/log/sin/cos/sqrt/abs/...``,
  ``cond ? x : y`` (right-associative, arbitrarily nested),
  ``&&``/``||``/``!``, casts ``(float)x``, float suffixes (``1.0f``);
- ``extra_code``: Python helper definitions with ``torch`` and ``np`` in
  scope, callable from the function string: the port's counterpart of
  the JAX package's jnp/np/jax helpers and of the reference's CUDA
  global-scope injection (src/map.cpp:202-233).  M1 inlines the
  straight-line ones (ops/map_codegen.py `_Inliner`).
"""

from __future__ import annotations

import ast
import functools
import re
import threading
import warnings
from collections import OrderedDict

import numpy as np
import torch

from ..DataType import DataType
from . import map_codegen
from .map_kernel import logical_shape, map_apply, prepare as _prepare_kernel
from .runtime import OpRuntime

_FUNCS = ("exp", "log", "log2", "log10", "sin", "cos", "tan", "asin", "acos",
          "atan", "atan2", "sinh", "cosh", "tanh", "sqrt", "rsqrt", "abs",
          "fabs", "floor", "ceil", "round", "rint", "pow", "min", "max",
          "fmin", "fmax", "erf", "erfc", "real", "imag", "conj", "mag2",
          "Complex", "where")

MAP_METHODS = ("cuda", "plain")
_JAX_METHODS = {
    "jnp": "the JAX package's translated jnp program; its port is the "
           "plain PyTorch engine, method 'plain'",
    "pallas": "a Pallas TPU engine of the JAX package; its port is the "
              "generated CUDA kernel M1, method 'cuda' (or 'auto')",
}


# ------------------------------------------------ the PyTorch namespace
def _as_t(v):
    """A Python scalar -> a 0-d CPU tensor (torch's default dtype for
    its kind); a tensor as it is."""
    return v if isinstance(v, torch.Tensor) else torch.tensor(v)


def _unary(fn):
    return lambda x: fn(_as_t(x))


def _promoted(a, b):
    """Two operands, Python scalars among them, -> tensors of their
    promoted dtype (a scalar as a 0-d CPU tensor)."""
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = torch.tensor(a)
    dt = torch.result_type(a, b)
    a = a.to(dt) if isinstance(a, torch.Tensor) else torch.tensor(a, dtype=dt)
    b = b.to(dt) if isinstance(b, torch.Tensor) else torch.tensor(b, dtype=dt)
    return a, b


def _binary(fn):
    return lambda a, b: fn(*_promoted(a, b))


def _real(x):
    return x.real


def _imag(x):
    """jnp.imag: zeros of a real value's own type (torch's .imag raises
    on a real tensor)."""
    if isinstance(x, torch.Tensor):
        return x.imag if x.is_complex() else torch.zeros_like(x)
    return x.imag


def _conj(x):
    if isinstance(x, torch.Tensor):
        return torch.conj(x)
    return x.conjugate()


def _mag2(x):
    return _real(x * _conj(x))


def _complex(re_, im_):
    """Complex(re, im) with the float type of the promoted operands."""
    a, b = _promoted(re_, im_)
    if not a.is_floating_point():
        a, b = a.float(), b.float()
    return torch.complex(a, b)


def _where(c, a, b):
    c = _as_t(c)
    if c.dtype != torch.bool:
        c = c != 0
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = torch.tensor(a)
    return torch.where(c, a, b)


def _cast(dtype):
    def cast(x):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # complex -> real keeps .real
            return _as_t(x).to(dtype)
    return cast


def _pow(a, b):
    """``**``/pow: torch.pow (its x*x, x*x*x, sqrt and 1/x forms for
    scalar exponents 2, 3, 0.5, -1 and -2), with 1/sqrt for -0.5 on every
    device (the card's rsqrt is approximate)."""
    if isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor) and \
            not isinstance(b, complex) and b == -0.5 and \
            (a.is_floating_point()):
        return _div(1.0, torch.sqrt(a))
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return torch.pow(torch.tensor(a), b)
    return torch.pow(a, b)


@functools.lru_cache(maxsize=64)
def _device_scalar_of(kind, v, dtype, device):
    return torch.tensor(v, dtype=dtype, device=device)


def _device_scalar(v, dtype, device):
    """A 0-d tensor of `v` on `device`, made once per value (a bounded
    cache: the copy to the card is not repeated every gulp)."""
    if isinstance(v, torch.Tensor):
        v = v.item()
    return _device_scalar_of(type(v), v, dtype, device)


def _scalar_divisor(a, b):
    """A card tensor divided by a scalar: PyTorch's card kernels multiply
    by the scalar's reciprocal, so the divisor goes to the card as a
    tensor and the division is a division, as on the CPU and in JAX."""
    if isinstance(a, torch.Tensor) and a.device.type == "cuda" and \
            (not isinstance(b, torch.Tensor) or
             (b.dim() == 0 and b.device.type == "cpu")):
        dt = torch.result_type(a, b)
        return _device_scalar(b, dt, a.device)
    return b


def _div(a, b):
    """True division, ``a / b``; a scalar numerator divides (PyTorch's
    reflected ``/`` multiplies by the reciprocal)."""
    if isinstance(b, torch.Tensor) and not isinstance(a, torch.Tensor):
        dt = torch.result_type(a, b)
        if not (dt.is_floating_point or dt.is_complex):
            dt = torch.get_default_dtype()
        return torch.true_divide(torch.tensor(a, dtype=dt), b)
    if isinstance(a, torch.Tensor):
        b2 = _scalar_divisor(a, b)
        if b2 is not b:
            dt = torch.result_type(a, b)
            if not (dt.is_floating_point or dt.is_complex):
                b2 = b2.to(torch.get_default_dtype())
            return torch.true_divide(a, b2)
    return a / b


def _floordiv(a, b):
    if isinstance(a, torch.Tensor):
        b = _scalar_divisor(a, b)
    return a // b


def _gather(arr, idx):
    """``arr[(i, j, ...)]`` with jnp's gather semantics: a negative index
    wraps once, then every index is clamped to its axis."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    if len(idx) != arr.dim():
        raise IndexError(f"map: {arr.dim()}-d array indexed with "
                         f"{len(idx)} indices")
    fixed, parts = {}, []
    for d, i in enumerate(idx):
        n = arr.shape[d]
        if isinstance(i, torch.Tensor) and i.dim() == 0 and \
                i.device.type == "cpu":
            i = i.item()
        if isinstance(i, torch.Tensor):
            if i.dtype == torch.bool or i.is_floating_point() or \
                    i.is_complex():
                raise IndexError(f"map: index of type {i.dtype}")
            i = i.to(device=arr.device, dtype=torch.int64)
            parts.append((d, torch.where(i < 0, i + n, i).clamp(0, n - 1)))
        else:
            if isinstance(i, (bool, float, complex)):
                raise IndexError(f"map: index {i!r} is not an integer")
            i = int(i)
            fixed[d] = min(max(i + n if i < 0 else i, 0), n - 1)
    for d in sorted(fixed, reverse=True):
        arr = arr.select(d, fixed[d])
    if not parts:
        return arr
    return arr[tuple(p for _, p in parts)]


def scatter_targets(base_shape, idx, device):
    """The targets of a scatter into an array of `base_shape` at the
    index values `idx` (tensors or Python ints, one an axis), with the
    JAX package's ``.at[idx].set`` semantics -> (the indices' broadcast
    shape B, the flat row-major target of each source position of B, or
    ``prod(base_shape)`` where it writes nothing).  A negative index wraps
    once; an update still outside its axis is dropped; where targets
    repeat, the update of the highest source position (row-major over B)
    wins, chosen by an ``amax`` of positions, so the rule holds on every
    device (``index_put_`` leaves the order of repeated writes open)."""
    if len(idx) != len(base_shape):
        raise IndexError(f"map: a {len(base_shape)}-d array scattered with "
                         f"{len(idx)} indices")
    parts = []
    for i in idx:
        if isinstance(i, torch.Tensor):
            if i.dtype == torch.bool or i.is_floating_point() or \
                    i.is_complex():
                raise IndexError(f"map: index of type {i.dtype}")
            parts.append(i.to(device=device, dtype=torch.int64))
        else:
            if isinstance(i, (bool, float, complex)):
                raise IndexError(f"map: index {i!r} is not an integer")
            parts.append(torch.tensor(int(i), dtype=torch.int64,
                                      device=device))
    shape = torch.broadcast_shapes(*[p.shape for p in parts])
    numel = 1
    for n in base_shape:
        numel *= int(n)
    flat = torch.zeros(shape, dtype=torch.int64, device=device)
    valid = torch.ones(shape, dtype=torch.bool, device=device)
    for n, i in zip(base_shape, parts):
        i = torch.where(i < 0, i + n, i)
        valid = valid & (i >= 0) & (i < n)
        flat = flat * n + i
    flat, valid = flat.reshape(-1), valid.reshape(-1)
    pos = torch.arange(flat.numel(), dtype=torch.int64, device=device)
    # a dropped update owns a word of its own past the targets (one word
    # for them all would serialize the card's atomics on it)
    slot = torch.where(valid, flat, numel + pos)
    owner = torch.full((numel + flat.numel(),), -1, dtype=torch.int64,
                       device=device).scatter_reduce_(0, slot, pos, "amax")
    return shape, torch.where(valid & (owner.gather(0, slot) == pos), flat,
                              numel)


def _scatter(base, idx, val):
    """``base.at[idx].set(val)`` as the JAX package computes it
    (`scatter_targets`), into a copy of `base`: `val` broadcast to the
    indices' shape, each target written once."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    shape, dest = scatter_targets(tuple(base.shape), idx, base.device)
    numel = base.numel()
    out = torch.empty(numel + 1, dtype=base.dtype, device=base.device)
    out[:numel] = base.reshape(-1)
    # the dropped updates land on the spare last element
    out.scatter_(0, dest, torch.broadcast_to(val, shape).to(
        base.dtype).reshape(-1))
    return out[:numel].reshape(base.shape)


def _make_namespace():
    ns = {
        "exp": _unary(torch.exp), "log": _unary(torch.log),
        "log2": _unary(torch.log2), "log10": _unary(torch.log10),
        "sin": _unary(torch.sin), "cos": _unary(torch.cos),
        "tan": _unary(torch.tan), "asin": _unary(torch.asin),
        "acos": _unary(torch.acos), "atan": _unary(torch.atan),
        "atan2": _binary(torch.atan2), "sinh": _unary(torch.sinh),
        "cosh": _unary(torch.cosh), "tanh": _unary(torch.tanh),
        "sqrt": _unary(torch.sqrt),
        "rsqrt": lambda x: _div(1.0, _unary(torch.sqrt)(x)),
        "abs": _unary(torch.abs), "fabs": _unary(torch.abs),
        "floor": _unary(torch.floor), "ceil": _unary(torch.ceil),
        "round": _unary(torch.round), "rint": _unary(torch.round),
        "pow": _pow, "min": _binary(torch.minimum),
        "max": _binary(torch.maximum), "fmin": _binary(torch.minimum),
        "fmax": _binary(torch.maximum),
        "erf": _unary(torch.erf), "erfc": _unary(torch.erfc),
        "real": _real, "imag": _imag, "conj": _conj, "mag2": _mag2,
        "Complex": _complex, "where": _where,
        "pi": np.pi, "e": np.e,
    }
    return ns


def _full_namespace(extra_code=None):
    """The complete evaluation namespace: builtins-free PyTorch
    functions, casts, and any `extra_code` helper definitions (Python
    source with `torch` and `np` in scope, the counterpart of the JAX
    package's `jnp`/`np`/`jax` helpers)."""
    ns = _make_namespace()
    ns["f32cast"] = _cast(torch.float32)
    # (double) is float32, as in the JAX package, which runs without x64
    # (jnp.float64 canonicalizes to float32 there).
    ns["f64cast"] = _cast(torch.float32)
    ns["i32cast"] = _cast(torch.int32)
    if extra_code:
        # The reference's extra_code injects CUDA at global scope
        # (src/map.cpp:202-233); here it is Python helper definitions,
        # exec'd into the evaluation namespace.  Same trust model as the
        # reference: the caller's code is compiled and run as-is.  A
        # helper's ``/``, ``//`` and ``**`` are the program's own (the
        # hooks), so that an inlined helper (map_codegen `_Inliner`) is
        # the helper's evaluation.
        helper_ns = {"torch": torch, "np": np}
        helper_ns.update(ns)
        helper_ns.update(_HOOKS)
        tree = _PlainCode(frozenset()).visit(ast.parse(extra_code))
        exec(compile(ast.fix_missing_locations(tree), "<extra_code>",  # noqa: S102
                     "exec"), helper_ns)
        for k, v in helper_ns.items():
            if not k.startswith("_") and callable(v) and \
                    k not in ("torch", "np"):
                ns[k] = v
    return ns


_HOOKS = {"__gather__": _gather, "__div__": _div,
          "__floordiv__": _floordiv, "__pow__": _pow}


class _PlainCode(ast.NodeTransformer):
    """Array indexing -> ``__gather__``; ``/``, ``//`` and ``**`` -> the
    namespace's ``__div__``, ``__floordiv__`` and ``__pow__``."""

    _OPS = {ast.Div: "__div__", ast.FloorDiv: "__floordiv__",
            ast.Pow: "__pow__"}

    def __init__(self, arrays):
        self.arrays = arrays

    def visit_Subscript(self, node):
        self.generic_visit(node)
        if isinstance(node.value, ast.Name) and node.value.id in self.arrays:
            return ast.Call(ast.Name("__gather__", ast.Load()),
                            [node.value, node.slice], [])
        return node

    def visit_BinOp(self, node):
        self.generic_visit(node)
        hook = self._OPS.get(type(node.op))
        if hook is None:
            return node
        return ast.Call(ast.Name(hook, ast.Load()), [node.left, node.right],
                        [])


@functools.lru_cache(maxsize=256)
def _plain_code(expr, arrays):
    """A translated, index-rewritten expression -> its compiled code
    object for the plain engine."""
    tree = _PlainCode(arrays).visit(ast.parse(expr, mode="eval"))
    return compile(ast.fix_missing_locations(tree), "<map>", "eval")


def _eval(expr, arrays, ns):
    code = _plain_code(expr, frozenset(arrays))
    # The mini-language in a builtins-free namespace (module docstring).
    return eval(code, {"__builtins__": {}}, ns)  # noqa: S307


def _broadcast(val, shape, device):
    """jnp.broadcast_to: a Python scalar becomes an array of its weak
    type's default dtype (int32 for an int, as JAX's without x64)."""
    if not isinstance(val, torch.Tensor):
        dt = {bool: torch.bool, int: torch.int32, float: torch.float32,
              complex: torch.complex64}[type(val)]
        return torch.full(shape, val, dtype=dt, device=device)
    return torch.broadcast_to(val.to(device) if val.device != device
                              else val, shape)


def _translate_ternary(e):
    """C ternary -> where(), right-associative, arbitrarily nested:
    ``a ? b : c ? d : e`` == ``a ? b : (c ? d : e)``; parenthesized
    sub-ternaries are handled by recursion when their parens are opened."""
    depth = 0
    for i, ch in enumerate(e):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "?" and depth == 0:
            tern = 0
            d2 = 0
            for j in range(i + 1, len(e)):
                c = e[j]
                if c == "(":
                    d2 += 1
                elif c == ")":
                    d2 -= 1
                elif c == "?" and d2 == 0:
                    tern += 1
                elif c == ":" and d2 == 0:
                    if tern == 0:
                        cond = _translate_ternary(e[:i]).strip()
                        a = _translate_ternary(e[i + 1:j]).strip()
                        b = _translate_ternary(e[j + 1:]).strip()
                        return f"where({cond}, {a}, {b})"
                    tern -= 1
            raise ValueError(f"unmatched '?' in map expression: {e!r}")
    # Parenthesized groups may still hide ternaries: recurse into each
    # top-level (...) group.
    if "?" in e:
        out = []
        i = 0
        while i < len(e):
            if e[i] == "(":
                depth = 1
                j = i + 1
                while j < len(e) and depth:
                    if e[j] == "(":
                        depth += 1
                    elif e[j] == ")":
                        depth -= 1
                    j += 1
                out.append("(" + _translate_ternary(e[i + 1:j - 1]) + ")")
                i = j
            else:
                out.append(e[i])
                i += 1
        return "".join(out)
    return e


_METHODS = ("conj", "mag2", "real", "imag")


def _rewrite_methods(e):
    """``expr.meth()``/``expr.meth`` -> ``meth(expr)`` with the primary
    expression found by balanced-paren backscan (so ``(a+b).conj()`` and
    ``a(i,j).real`` work, not just bare identifiers)."""
    for meth in _METHODS:
        pat = re.compile(rf"\.\s*{meth}(\(\))?(?!\w)")
        while True:
            m = pat.search(e)
            if m is None:
                break
            k = m.start() - 1
            while k >= 0 and e[k].isspace():
                k -= 1
            if k >= 0 and e[k] == ")":
                depth = 1
                k -= 1
                while k >= 0 and depth:
                    if e[k] == ")":
                        depth += 1
                    elif e[k] == "(":
                        depth -= 1
                    k -= 1
                while k >= 0 and (e[k].isalnum() or e[k] == "_"):
                    k -= 1  # include a call's function/array name
            else:
                while k >= 0 and (e[k].isalnum() or e[k] == "_"):
                    k -= 1
            start = k + 1
            prim = e[start:m.start()]
            e = f"{e[:start]}{meth}({prim}){e[m.end():]}"
    return e


def _translate_expr(expr):
    """C-ish expression -> python/jnp expression (still with name(...) array
    index calls intact; those are rewritten separately)."""
    e = expr.strip()
    # float literal suffixes: 1.0f -> 1.0
    e = re.sub(r"(\d(?:\.\d*)?(?:[eE][+-]?\d+)?)[fF]\b", r"\1", e)
    # C casts: (float)x -> float32(x) handled via function call translation
    e = re.sub(r"\(\s*float\s*\)", "f32cast", e)
    e = re.sub(r"\(\s*double\s*\)", "f64cast", e)
    e = re.sub(r"\(\s*int\s*\)", "i32cast", e)
    # logical ops
    e = e.replace("&&", " & ").replace("||", " | ")
    e = re.sub(r"!(?!=)", " ~", e)
    e = _rewrite_methods(e)
    e = _translate_ternary(e)
    return e


_CALL_RE = re.compile(r"([A-Za-z_]\w*)\s*\(")
# Identifier with no word/attribute char before it (so `1e3` and `.real`
# never yield a phantom name).
_IDENT_RE = re.compile(r"(?<![\w.])[A-Za-z_]\w*")


def _rewrite_indexing(expr, array_names, reserved):
    """Rewrite ``a(i, j+1)`` array-call syntax into ``a[(i, j+1)]``.

    Handles nesting by scanning parens; function names in `reserved` are left
    as calls.
    """
    out = []
    i = 0
    while i < len(expr):
        m = _CALL_RE.match(expr, i)
        if m and m.group(1) in array_names and m.group(1) not in reserved:
            name = m.group(1)
            # find matching close paren
            depth = 1
            j = m.end()
            while j < len(expr) and depth:
                if expr[j] == "(":
                    depth += 1
                elif expr[j] == ")":
                    depth -= 1
                j += 1
            inner = expr[m.end():j - 1]
            inner = _rewrite_indexing(inner, array_names, reserved)
            out.append(f"{name}[({inner},)]")
            i = j
        else:
            out.append(expr[i])
            i += 1
    return "".join(out)


def _split_top_commas(s):
    parts, depth, last = [], 0, 0
    for k, ch in enumerate(s):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(s[last:k])
            last = k + 1
    parts.append(s[last:])
    return [p.strip() for p in parts]


def _iter_array_refs(expr, array_names, reserved):
    """Yield (name, [index exprs]) for every ``name(i, ...)`` array
    reference in `expr`, recursing into the index expressions (the
    read-only twin of `_rewrite_indexing`'s walk)."""
    i = 0
    while i < len(expr):
        m = _CALL_RE.match(expr, i)
        if m and m.group(1) in array_names and m.group(1) not in reserved:
            depth, j = 1, m.end()
            while j < len(expr) and depth:
                if expr[j] == "(":
                    depth += 1
                elif expr[j] == ")":
                    depth -= 1
                j += 1
            args = _split_top_commas(expr[m.end():j - 1])
            yield m.group(1), args
            for a in args:
                yield from _iter_array_refs(a, array_names, reserved)
            i = j
        else:
            i += 1


def _has_bare_ref(expr, array_names):
    """True when any array name appears WITHOUT a ``(...)`` index — a
    whole-array reference (broadcasting form)."""
    for m in _IDENT_RE.finditer(expr):
        if m.group(0) in array_names:
            j = m.end()
            while j < len(expr) and expr[j].isspace():
                j += 1
            if j >= len(expr) or expr[j] != "(":
                return True
    return False


def _time_offset(idx_expr, taxis):
    """Time-axis index expression -> integer frame offset, or None when
    it is not of the bounded-stencil form ``t``/``t - k``/``t + k``."""
    e = idx_expr.strip()
    if e == taxis:
        return 0
    m = re.fullmatch(rf"{re.escape(taxis)}\s*([+-])\s*(\d+)", e)
    if m is None:
        return None
    k = int(m.group(2))
    return k if m.group(1) == "+" else -k


def _classify_stream(compiled, in_name, reserved):
    """Classify a translated program's time-axis access pattern for the
    streaming (gulp-at-a-time) execution forms -> (form, noffset):

    - ``"elementwise"``: no explicit indexing — pure broadcasting.
    - ``"local"``: explicit indexing, every time index exactly the time
      axis variable (channel-axis gathers/arithmetic are free).
    - ``"stencil"``: bounded NEGATIVE time offsets on the input
      (``x(i-k)``); `noffset` = max k, the carried history depth.
    - ``"forward"`` / ``"unbounded"``: ``x(i+k)`` / any other time
      index (``x(n-1-i)``, permuted output, temp history) — frames that
      are not gulp-resident, so the streaming form runs per-gulp only
      and fusion refuses with ``map_unbounded_index``.
    """
    explicit = compiled.explicit
    if not explicit:
        return "elementwise", 0
    axis_names = compiled.axis_names
    taxis = axis_names[0]
    arrays = frozenset([in_name] + [s[0] for s in compiled.statements])
    refs, bare = [], False
    for lhs_name, lhs_idx, rhs in compiled.statements:
        if lhs_idx is not None and tuple(lhs_idx) != tuple(axis_names):
            return "unbounded", 0      # permuted/scattered output indexing
        refs.extend(_iter_array_refs(rhs, arrays, reserved))
        bare = bare or _has_bare_ref(rhs, arrays)
    noffset = 0
    for name, args in refs:
        off = _time_offset(args[0], taxis) if args else None
        if off is None:
            return "unbounded", 0
        if off > 0:
            return "forward", 0
        if off < 0:
            if name != in_name:
                # Only the INPUT's history is carried; a temp's previous
                # frames were never materialized beyond the gulp.
                return "unbounded", 0
            noffset = max(noffset, -off)
    if noffset and (bare or any(name != in_name for name, _ in refs)):
        # Stencil grids address history-padded input coordinates; temps
        # and whole-array refs are gulp-shaped and would misalign.
        return "unbounded", 0
    return ("stencil", noffset) if noffset else ("local", 0)



def _lift(raw, dtype):
    """A ring gulp of DataType `dtype` in storage form -> its logical
    value (complex64 for ci4..ci16, complex128 wider, byte-expanded ints
    for packed real types): what the JAX package's `_lift` and
    ``prepare(ispan.data)`` assemble, exactly."""
    dt = DataType(dtype)
    if dt.is_complex and dt.is_integer:
        if dt.nbit < 8:
            from .unpack import unpack_pairs
            raw = unpack_pairs(raw, dt)
        f = torch.float32 if dt.nbit <= 16 else torch.float64
        return torch.complex(raw[..., 0].to(f), raw[..., 1].to(f))
    if dt.nbit < 8:
        from .unpack import _unpack_bits
        return _unpack_bits(raw, dt)
    return raw


def _stream_eval(compiled, ns_base, arrays, reserved, in_name, scalars,
                 x, pad, out_chan_shape):
    """Evaluate the translated statements over one gulp.

    `x` leads with the frame axis, preceded by `pad` carried history
    frames in stencil form; index grids address the PADDED input
    coordinates (time grid shifted by `pad`) while the output keeps the
    gulp's own frame count.  Returns the LAST statement's value."""
    ns = dict(ns_base)
    ns.update(_HOOKS)
    ns.update(scalars)
    ns[in_name] = x
    explicit = compiled.explicit
    shape = None
    if explicit:
        nframe = x.shape[0] - pad
        chan = tuple(out_chan_shape) if out_chan_shape is not None \
            else tuple(x.shape[1:])
        shape = (nframe,) + chan
        for ax_i, ax in enumerate(compiled.axis_names):
            # int32 grids, as jnp.arange's without x64
            grid = torch.arange(shape[ax_i], dtype=torch.int32,
                                device=x.device)
            if ax_i == 0 and pad:
                grid = grid + pad    # history-padded input coordinates
            ns[ax] = grid.reshape([-1 if k == ax_i else 1
                                   for k in range(len(shape))])
            ns[f"n{ax}"] = shape[ax_i]
    val = None
    for lhs_name, _lhs_idx, rhs in compiled.statements:
        expr = _rewrite_indexing(rhs, arrays, reserved)
        val = _eval(expr, arrays, ns)
        if explicit:
            val = _broadcast(val, shape, x.device)
        ns[lhs_name] = val
    return val


# Built-closure cache bound (per translation): same 64-entry LRU contract
# as the OpRuntime plan cache.
_FN_CACHE_CAPACITY = 64


def _parse_statement(stmt):
    """One statement of a function string -> (lhs_name,
    lhs_indices|None, translated rhs)."""
    lhs, rhs = stmt.split("=", 1)
    lhs = lhs.strip()
    m = re.match(r"^([A-Za-z_]\w*)\s*(?:\((.*)\))?$", lhs)
    if not m:
        raise ValueError(f"bad map lhs: {lhs!r}")
    lhs_idx = tuple(s.strip() for s in m.group(2).split(",")) \
        if m.group(2) else None
    return m.group(1), lhs_idx, _translate_expr(rhs)


class _CompiledMap(object):
    def __init__(self, func_string, arg_names, axis_names, ndim_shape_known,
                 extra_code=None, statements=None):
        self.func_string = func_string
        self.extra_code = extra_code
        self.axis_names = tuple(axis_names) if axis_names else ()
        # list of (lhs_name, lhs_indices|None, rhs_expr); `statements`
        # given: a segment of a parsed program (`segment`)
        if statements is None:
            statements = [_parse_statement(stmt.strip())
                          for stmt in func_string.split(";") if stmt.strip()]
        self.statements = list(statements)
        # the explicit-index form: a statement is indexed (a segment keeps
        # its program's form, `segment`)
        self.explicit = any(s[1] is not None for s in self.statements)
        # Closure cache per call signature, LRU-bounded (retention
        # contract: an evicted signature is rebuilt on next use).  The
        # eager call's generated programs live here too.  Translations
        # are shared (lru_cache), so blocks on several threads (fleet
        # tenants, a respec's replacement) use one cache: the lock makes
        # one build per signature.
        self._fn_cache = OrderedDict()
        self._fn_lock = threading.RLock()

    def _cached(self, key, build):
        with self._fn_lock:
            fn = self._fn_cache.get(key)
            if fn is None:
                fn = self._fn_cache[key] = build()
                while len(self._fn_cache) > _FN_CACHE_CAPACITY:
                    self._fn_cache.popitem(last=False)
            else:
                self._fn_cache.move_to_end(key)
            return fn

    def segment(self, a, b):
        """Statements a..b of the explicit form as a program of its own
        (`_eager_cuda`): the same statements, explicit form, axis
        names and helpers, whether or not a statement of the segment is
        indexed; built once per program."""
        def build():
            seg = _CompiledMap(self.func_string, None, self.axis_names, None,
                               self.extra_code, self.statements[a:b])
            seg.explicit = self.explicit
            return seg
        return self._cached(("segment", a, b), build)

    def get_fn(self, shapes, dtypes, scalar_names, shape):
        key = (tuple(sorted((k, v) for k, v in shapes.items())), shape)
        return self._cached(key, lambda: self.build(shapes, dtypes,
                                                    scalar_names, shape))

    def build(self, shapes, dtypes, scalar_names, shape):
        """-> fn(named tensors and scalars) -> dict of outputs: the plain
        engine."""
        ns_base = _full_namespace(self.extra_code)
        arg_names = list(shapes.keys())
        explicit = self.explicit
        axis_names = self.axis_names
        statements = self.statements
        reserved = set(ns_base.keys())
        arrays = frozenset(arg_names)

        def fn(**arrs):
            ns = dict(ns_base)
            ns.update(_HOOKS)
            ns.update(arrs)
            results = {}
            if not explicit:
                # pure elementwise with broadcasting
                for lhs_name, _, rhs in statements:
                    expr = _rewrite_indexing(rhs, arrays, reserved)
                    results[lhs_name] = _eval(expr, arrays, ns)
                    ns[lhs_name] = results[lhs_name]
                return results
            # explicit-index form: broadcast index grids over `shape`
            if shape is None:
                raise ValueError("explicit-index map requires shape=")
            dev = next((v.device for v in arrs.values()
                        if isinstance(v, torch.Tensor)),
                       torch.device("cpu"))
            for ax_i, ax in enumerate(axis_names):
                ns[ax] = torch.arange(shape[ax_i], dtype=torch.int32,
                                      device=dev).reshape(
                    [-1 if k == ax_i else 1 for k in range(len(shape))])
            for ax_i, ax in enumerate(axis_names):
                ns[f"n{ax}"] = shape[ax_i]
            for lhs_name, lhs_idx, rhs in statements:
                expr = _rewrite_indexing(rhs, arrays, reserved)
                val = _broadcast(_eval(expr, arrays, ns), tuple(shape), dev)
                if lhs_idx is not None and \
                        tuple(lhs_idx) != tuple(axis_names):
                    # permuted/strided output indexing: a scatter into a
                    # copy of the ORIGINAL output array
                    idx = tuple(_eval(_rewrite_indexing(ix, arrays,
                                                        reserved),
                                      arrays, ns)
                                for ix in lhs_idx)
                    results[lhs_name] = _scatter(arrs[lhs_name], idx, val)
                else:
                    results[lhs_name] = val
                ns[lhs_name] = results[lhs_name]
            return results

        return fn


@functools.lru_cache(maxsize=64)
def _compile_map(func_string, arg_names, axis_names, extra_code=None):
    """Translation cache (bounded LRU, retention contract): an evicted
    translation is re-derived from the function string on next use —
    correctness never depends on residency, only repeat-call cost."""
    return _CompiledMap(func_string, arg_names, axis_names, None,
                        extra_code=extra_code)


def _py_scalar(v):
    """A numpy scalar -> its Python value (a weakly typed scalar, as a
    Python number is to both engines)."""
    if isinstance(v, np.generic) or (isinstance(v, np.ndarray) and
                                     v.ndim == 0):
        return v.item()
    return v


def _bound(v):
    """A planned Map's scalar binding -> what the engines read: a numpy
    array of one axis or more becomes a CPU tensor of its dtype (a
    copy: a constant array, as a bound tensor is), anything else
    `_py_scalar`'s value."""
    if isinstance(v, np.ndarray) and v.ndim > 0:
        return torch.from_numpy(np.array(v))
    return _py_scalar(v)


def _number(v):
    return isinstance(v, (bool, int, float, complex))


def _scalars_key(scalars):
    """What a generated program depends on in its scalars: each number's
    type, each tensor's dtype, shape and device type (not the values,
    which are read at each launch)."""
    return tuple((k, (str(v.dtype), tuple(v.shape), v.device.type)
                  if isinstance(v, torch.Tensor) else type(v).__name__)
                 for k, v in scalars.items())


def _unsupported(func_string, reason):
    """The error for a program the kernel does not implement yet."""
    return map_codegen.Unsupported(
        f"map: the kernel generator does not implement {func_string!r} "
        f"({reason}); method 'plain' (the map_method flag) runs it on the "
        f"plain engine")


def _method_request(method):
    """None/'auto' -> the `map_method` flag; the JAX methods are
    refused with their counterparts' names -> 'auto', 'cuda' or 'plain'
    (unvalidated)."""
    m = method if method is not None else "auto"
    if m == "auto":
        from .. import config
        m = config.get("map_method")
    if m in _JAX_METHODS:
        raise ValueError(f"map: method {m!r} is {_JAX_METHODS[m]} "
                         f"(map_method config flag)")
    return m


# --------------------------------------------------------------- planned op
class Map(object):
    """The PLANNED streaming form of the mini-language (blocks.MapBlock's
    engine): one streaming input with the frame axis leading, scalars
    bound per plan, programs cached on the shared
    :class:`.runtime.OpRuntime` (``map_method`` flag, bounded LRU,
    uniform ``plan_report()``).

    Construction classifies the expression's time-axis access pattern
    (see :func:`_classify_stream`) into ``fuse_form``:
    elementwise/local programs expose a stateless ``kernel()`` (the
    block's ``device_kernel``); bounded negative time offsets compile
    to the stencil ``kernel_carry()`` threading a ``noffset``-frame
    history tail (the fused-carry protocol — split gulps bitwise ==
    one long gulp); forward/unbounded indexing stays per-gulp only.

    Raw ci4/ci8 ring storage is ingested by the ``*_raw`` twins: M1 reads
    the storage in the kernel; the plain engine lifts it first.
    """

    def __init__(self, func_string, in_name=None, scalars=None,
                 axis_names=None, extra_code=None, method=None):
        self.func_string = func_string
        self.extra_code = extra_code
        self.scalars = {k: _bound(v) for k, v in (scalars or {}).items()}
        self._moved = {}                # constant arrays copied to a device
        self.method = method if method is not None else "auto"
        self._runtime = OpRuntime("map", MAP_METHODS,
                                  config_flag="map_method", default="cuda")
        if method is not None and method != "auto":
            # Eager validation: a bogus explicit method fails at
            # construction, not at first execute.
            self._runtime.resolve_method(_method_request(method))
        self._ns = _full_namespace(extra_code)
        reserved = frozenset(self._ns)
        self.compiled = _compile_map(
            func_string, ("<stream>",),
            tuple(axis_names) if axis_names else None, extra_code)
        self.statements = self.compiled.statements
        if not self.statements:
            raise ValueError(f"map: no statements in {func_string!r}")
        self.out_name = self.statements[-1][0]
        lhs_names = {s[0] for s in self.statements}
        self.explicit = self.compiled.explicit
        if self.explicit and not self.compiled.axis_names:
            # Checked BEFORE input inference: the index variables in
            # "y(i) = x(i)" would otherwise read as unbound identifiers.
            raise ValueError("explicit-index map requires axis_names")
        axes = set(self.compiled.axis_names) | \
            {f"n{a}" for a in self.compiled.axis_names}
        cands = set()
        for _, _, rhs in self.statements:
            cands.update(_IDENT_RE.findall(rhs))
        cands -= lhs_names | set(self.scalars) | axes | set(reserved)
        if in_name is None:
            if len(cands) != 1:
                raise ValueError(
                    "map: could not infer the streaming input name from "
                    f"{sorted(cands)!r}; pass in_name=")
            in_name = next(iter(cands))
        elif cands - {in_name}:
            raise ValueError(
                f"map: unbound names {sorted(cands - {in_name})!r} "
                "(not the input, a statement lhs, or a scalar)")
        self.in_name = in_name
        self.fuse_form, self.noffset = _classify_stream(
            self.compiled, in_name, reserved)
        self._arrays = frozenset([in_name] + [s[0] for s in self.statements])
        self._helper_refusal = map_codegen.helper_refusal(
            self.statements, self._arrays, self._ns, extra_code)
        self._programs = OrderedDict()  # program key -> Program | Refusal
        self._last_program = None       # the last program M1 ran
        self.codegen_refusal = None     # the last resolution's reason

    # ------------------------------------------------------- plumbing
    def set_scalars(self, scalars):
        """Rebind scalar values (header-resolved bindings).  Safe at any
        time: programs read the values at each call, and key on their
        types."""
        self.scalars = {k: _bound(v) for k, v in scalars.items()}

    def _scalars_on(self, device):
        """The scalars with each constant array on `device` (a copy, made
        again when the bound tensor changes)."""
        out = dict(self.scalars)
        for k, v in self.scalars.items():
            if isinstance(v, torch.Tensor) and v.dim() > 0 and \
                    v.device != device:
                hit = self._moved.get((k, str(device)))
                if hit is None or hit[0] is not v or hit[1] != v._version:
                    hit = (v, v._version, v.to(device))
                    self._moved[(k, str(device))] = hit
                out[k] = hit[2]
        return out

    def _gen_scalars(self):
        """The run-time scalars of a program: numbers, and 0-d tensors
        (read at each launch)."""
        return {k: v for k, v in self.scalars.items() if _number(v) or (
            isinstance(v, torch.Tensor) and v.dim() == 0)}

    def _const_arrays(self):
        """Tensors of one axis or more bound as scalars: the kernel reads
        them as buffers, broadcast at the output's coordinates."""
        return {k: v for k, v in self.scalars.items()
                if isinstance(v, torch.Tensor) and v.dim() > 0}

    def form_refusal(self):
        """Why the generator refuses this program whatever its input (an
        `extra_code` helper it calls that cannot be inlined), or None."""
        return self._helper_refusal

    def program(self, dtype, rank, out_chan_shape=None):
        """The generated program for an input of `dtype` (a DataType
        string: ring storage; or a torch dtype: a logical tensor) and
        logical rank `rank` -> `map_codegen.Program`, or raises
        `map_codegen.Refusal` (a program the generator refuses) or
        `map_codegen.Unsupported` (what the kernel does not implement)."""
        scal = self._gen_scalars()
        ocs = tuple(out_chan_shape) if out_chan_shape is not None else None
        key = (str(dtype), int(rank), ocs, _scalars_key(self.scalars))
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self._generate(dtype, rank, ocs,
                                                        scal)
            while len(self._programs) > _FN_CACHE_CAPACITY:
                self._programs.popitem(last=False)
        if isinstance(prog, (map_codegen.Refusal, map_codegen.Unsupported)):
            raise prog
        return prog

    def _generate(self, dtype, rank, ocs, scal):
        try:
            reason = self.form_refusal()
            if reason is not None:
                raise map_codegen.Refusal(reason)
            out_rank = rank if not self.explicit else \
                1 + (len(ocs) if ocs is not None else rank - 1)
            collapsed = self.fuse_form == "elementwise" and \
                rank > map_codegen.MAX_RANK
            if collapsed:
                # every operand collapsed at launch (map_kernel.collapse)
                rank = out_rank = map_codegen.MAX_RANK
            if isinstance(dtype, torch.dtype):
                inp = map_codegen.input_for_tensor(self.in_name, dtype, rank)
            else:
                inp = map_codegen.input_for(self.in_name, dtype, rank)
            consts = [map_codegen.input_for_tensor(
                k, v.dtype, out_rank if collapsed else v.dim(), bcast=True)
                for k, v in self._const_arrays().items()]
            prog = map_codegen.generate(
                self.statements, self.fuse_form, [inp] + consts, self._ns,
                self._arrays, [self.out_name],
                axis_names=self.compiled.axis_names, scalars=scal,
                noffset=self.noffset, extra_code=self.extra_code,
                out_rank=out_rank)
        except (map_codegen.Refusal, map_codegen.Unsupported) as r:
            return r
        prog.plain = self._prog_plain(prog, dtype)
        return prog

    def _prog_plain(self, prog, dtype):
        """The program's plain version (map_kernel.map_apply_plain): the
        plain engine on the same operands."""
        storage = prog.inputs[0].storage
        names = prog.scalar_names

        def plain(ins, out_shape, scal, carry):
            x = ins[0]
            if storage in ("pair", "ci4", "cpacked", "packed"):
                x = _lift(x, dtype)
            scalars = self._scalars_on(x.device)
            scalars.update(zip(names, scal))
            y, c2 = self._plain_eval(x, carry, out_shape[1:], scalars)
            return [y], c2
        return plain

    def _plain_eval(self, x, carry, out_chan, scalars):
        """The plain engine on one logical gulp (after `carry` in stencil
        form) -> (y, next carry or None)."""
        ocs = tuple(out_chan) if self.explicit else None
        ns = self._ns
        reserved = frozenset(ns)
        if self.fuse_form != "stencil":
            return _stream_eval(self.compiled, ns, self._arrays, reserved,
                                self.in_name, scalars, x, 0, ocs), None
        noff = self.noffset
        xfull = torch.cat([carry, x], dim=0)
        y = _stream_eval(self.compiled, ns, self._arrays, reserved,
                         self.in_name, scalars, xfull, noff, ocs)
        return y, xfull[xfull.shape[0] - noff:].clone()

    def _requested(self):
        m = _method_request(self.method)
        return m if m == "auto" else self._runtime.resolve_method(m)

    def _resolve(self, dtype=None, rank=None, out_chan_shape=None,
                 device=None):
        """The method a call on `device` runs (None: a card).  'plain'
        when asked for, and for 'auto' on the CPU.  For a program the
        generator refuses (`form_refusal`, or the `map_codegen.Refusal`
        of generating it for `dtype`; the reason kept in
        `codegen_refusal`): 'plain' under 'auto', a ValueError with the
        reason under 'cuda'.  Else 'cuda', once the program for an input
        of `dtype` and `rank` (when given) is generated: what the kernel
        does not implement raises `map_codegen.Unsupported` with the
        reason, under either method."""
        req = self._requested()
        reason = self.codegen_refusal = self.form_refusal()
        if req == "plain" or (req == "auto" and device is not None and
                              torch.device(device).type == "cpu"):
            return "plain"
        if reason is None and dtype is not None:
            try:
                self.program(dtype, rank, out_chan_shape)
            except map_codegen.Unsupported as u:
                raise _unsupported(self.func_string,
                                   f"{u.reason}; input {dtype}") from None
            except map_codegen.Refusal as r:
                reason = self.codegen_refusal = r.reason
        if reason is not None:
            if req == "auto":
                return "plain"
            raise ValueError(f"map: method 'cuda' cannot run "
                             f"{self.func_string!r}: the kernel generator "
                             f"refuses it ({reason})")
        return "cuda"

    def _step_fn(self, dtype, rank, out_chan_shape, raw, device):
        """-> (method, fn(x, carry, out) -> (y, carry')) for an input on
        `device`, cached on the runtime under the resolved method."""
        ocs = tuple(out_chan_shape) if out_chan_shape is not None else None
        method = self._resolve(dtype, rank, ocs, device)
        key = (method, "raw" if raw else "plain", str(dtype), rank, ocs,
               _scalars_key(self.scalars))

        def build():
            if method == "cuda":
                prog = self.program(dtype, rank, ocs)

                consts = [inp.name for inp in prog.inputs[1:]]

                def fn(x, carry=None, out=None):
                    self._last_program = prog
                    scal = self._scalars_on(x.device)
                    ys, c2 = map_apply(
                        prog, [x] + [scal[n] for n in consts],
                        self._out_shape(x, prog, ocs),
                        [self.scalars[n] for n in prog.scalar_names],
                        carry, None if out is None else [out])
                    return ys[0], c2
                fn.program = prog
                return fn

            def fn(x, carry=None, out=None):
                lx = _lift(x, dtype) if raw else x
                y, c2 = self._plain_eval(
                    lx, carry, ocs if ocs is not None else
                    tuple(lx.shape[1:]), self._scalars_on(lx.device))
                if out is not None:
                    y = out.copy_(y)
                return y, c2
            fn.program = None
            return fn
        return method, self._runtime.plan(key, build, method=method,
                                          origin="host")

    def _out_shape(self, x, prog, ocs):
        lshape = logical_shape(x, prog.inputs[0])
        if not self.explicit:
            return lshape
        return (lshape[0],) + (ocs if ocs is not None else lshape[1:])

    @staticmethod
    def _key_dtype(x, dtype):
        return x.dtype if dtype is None else str(DataType(dtype))

    def _logical_rank(self, x, dtype):
        if dtype is None:
            return x.dim()
        dt = DataType(dtype)
        return x.dim() - 1 if (dt.is_complex and dt.is_integer and
                               dt.nbit >= 8) else x.dim()

    def prepare(self, dtype, rank, out_chan_shape=None, raw=False,
                device=None):
        """Resolve the method for an input of `dtype`/`rank` and, for
        'cuda' on a CUDA device, build M1 now (MapBlock does this in
        on_sequence, so the first gulp does not wait for nvcc) ->
        the resolved method."""
        method, fn = self._step_fn(dtype, rank, out_chan_shape, raw,
                                   device)
        if method == "cuda" and device is not None and \
                torch.device(device).type == "cuda":
            _prepare_kernel(fn.program)
        return method

    # ------------------------------------------------------ traceables
    def kernel(self, out_chan_shape=None):
        """fn(x) -> y on a logical gulp: the block's device_kernel (the
        plan the unfused executor runs, so fused == unfused)."""
        def fn(x):
            return self._step_fn(x.dtype, x.dim(), out_chan_shape,
                                 False, x.device)[1](x)[0]
        return fn

    def kernel_raw(self, dtype, out_chan_shape=None):
        """fn(raw) -> y on ring storage of DataType `dtype`."""
        dkey = str(DataType(dtype))

        def fn(raw):
            return self._step_fn(dkey, self._logical_rank(raw, dkey),
                                 out_chan_shape, True, raw.device)[1](raw)[0]
        return fn

    def kernel_carry(self, out_chan_shape=None):
        """Stencil step fn(x, carry, consts) -> (y, carry'): the
        fused-carry protocol form (fuse.py stateful_chain)."""
        def fn(x, carry, consts=()):
            return self._step_fn(x.dtype, x.dim(), out_chan_shape,
                                 False, x.device)[1](x, carry)
        return fn

    def kernel_carry_raw(self, dtype, out_chan_shape=None):
        dkey = str(DataType(dtype))

        def fn(raw, carry, consts=()):
            return self._step_fn(dkey, self._logical_rank(raw, dkey),
                                 out_chan_shape, True, raw.device)[1](raw,
                                                                     carry)
        return fn

    def carry_init(self, chan_shape, dtype, device=None):
        """Fresh zero `noffset`-frame history (the stencil's virtual
        x(-k) == 0 frames, matching the unfused first-gulp semantics)."""
        if not isinstance(dtype, torch.dtype):
            dtype = _torch_dtype(dtype)
        return torch.zeros((self.noffset,) + tuple(chan_shape), dtype=dtype,
                           device=device)

    # ------------------------------------------------------- executors
    def execute(self, x, out_chan_shape=None, out=None):
        return self._step_fn(x.dtype, x.dim(), out_chan_shape,
                             False, x.device)[1](x, None, out)[0]

    def execute_raw(self, raw, dtype, out_chan_shape=None, out=None):
        dkey = str(DataType(dtype))
        return self._step_fn(dkey, self._logical_rank(raw, dkey),
                             out_chan_shape, True, raw.device)[1](raw, None,
                                                                  out)[0]

    def execute_carry(self, x, carry, out_chan_shape=None, out=None):
        return self._step_fn(x.dtype, x.dim(), out_chan_shape,
                             False, x.device)[1](x, carry, out)

    def execute_carry_raw(self, raw, dtype, carry, out_chan_shape=None,
                          out=None):
        dkey = str(DataType(dtype))
        return self._step_fn(dkey, self._logical_rank(raw, dkey),
                             out_chan_shape, True, raw.device)[1](raw, carry,
                                                                  out)

    # -------------------------------------------------------- reporting
    def plan_report(self):
        """Uniform runtime schema + map specifics (the JAX report's keys)
        and the generator's verdict (`codegen_refusal`: None where M1
        runs the program); `kernel`: the last program M1 ran, its V, run,
        the note of a build that spilled and its last launch's plan (path,
        index type, grid), or None."""
        rep = self._runtime.report()
        prog = self._last_program
        rep.update({
            "statements": len(self.statements),
            "fuse_form": self.fuse_form,
            "stencil_noffset": self.noffset,
            "in_name": self.in_name,
            "out_name": self.out_name,
            "codegen_refusal": self.codegen_refusal,
            "kernel": None if prog is None else {
                "vec": prog.vec, "run": prog.run,
                "vec_note": prog.vec_note,
                "last_launch": prog.last_launch},
        })
        return rep


def _torch_dtype(dtype):
    """numpy dtype (or its name) -> torch dtype."""
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _eager_input(arr):
    """An eager map operand -> a logical tensor: a tensor stays where it
    is; numpy goes to this thread's device (structured complex integers
    lifted to complex64)."""
    if isinstance(arr, torch.Tensor):
        return arr
    from ..device import get_device
    a = np.asarray(arr)
    if a.dtype.names is not None:
        from ..ndarray import structured_to_pair
        p = torch.from_numpy(structured_to_pair(a))
        return torch.complex(p[..., 0].float(), p[..., 1].float()).to(
            get_device())
    return torch.from_numpy(np.ascontiguousarray(a)).to(get_device())


def _eager_finalize(result, out):
    """Copy a result into the caller's output array (tensor or numpy,
    structured complex integers rounded) and return it; None -> result."""
    if out is None:
        return result
    if isinstance(out, torch.Tensor):
        return out.copy_(result)
    a = np.asarray(out)
    if a.dtype.names is not None:
        from ..ndarray import pair_to_structured
        z = result.detach().cpu()
        pair = torch.stack([z.real.round(), z.imag.round()], -1).numpy()
        a[...] = pair_to_structured(pair, str(DataType(a.dtype)))
        return out
    r = result.detach().cpu()
    if not np.iscomplexobj(a) and r.is_complex():
        r = r.real
    a[...] = r.numpy()
    return out


def _eager_plan(compiled, arrs, scalar_names, shape):
    """The eager call's program for card tensors -> (Program, or the
    `map_codegen.Refusal`, or None where no statement is an array; the
    input names in order; the run-time scalars; the output names; the
    plain engine's value of each statement on 'meta' tensors (shapes and
    types, and the values of statements that depend on no array); the
    grid).  Running the plain engine on 'meta' first raises its error for
    a call it refuses.  What the broadcasting form's kernel does not
    implement raises `map_codegen.Unsupported`."""
    tens = {k: v for k, v in arrs.items() if isinstance(v, torch.Tensor)}
    explicit = compiled.explicit
    names = sorted(tens)
    scal = {k: arrs[k] for k in sorted(scalar_names) if _number(arrs[k])}
    stmt_names = list(dict.fromkeys(s[0] for s in compiled.statements))
    out_shape = tuple(shape) if explicit else tuple(
        torch.broadcast_shapes(*[tens[k].shape for k in names]))
    meta = {k: (torch.empty(v.shape, dtype=v.dtype, device="meta")
                if isinstance(v, torch.Tensor) else v)
            for k, v in arrs.items()}
    vals = compiled.get_fn(
        {k: (tuple(v.shape) if isinstance(v, torch.Tensor) else None)
         for k, v in arrs.items()},
        None, frozenset(scalar_names),
        out_shape if explicit else None)(**meta)
    arrays = [n for n in stmt_names if isinstance(vals[n], torch.Tensor)
              and vals[n].device.type == "meta"]
    if not arrays:
        return None, names, scal, arrays, vals, out_shape
    collapsed = not explicit and len(out_shape) > map_codegen.MAX_RANK
    rank = len(out_shape) if explicit else \
        min(max(len(out_shape), 1), map_codegen.MAX_RANK)
    key = ("cuda", tuple((k, str(tens[k].dtype), tens[k].dim())
                         for k in names),
           tuple((k, type(v).__name__) for k, v in scal.items()),
           len(out_shape))

    def gen():
        try:
            return map_codegen.generate(
                compiled.statements, "eager",
                [map_codegen.input_for_tensor(
                    k, tens[k].dtype, rank if collapsed else tens[k].dim())
                 for k in names], _full_namespace(compiled.extra_code),
                frozenset(arrs), arrays, axis_names=compiled.axis_names,
                scalars=scal, extra_code=compiled.extra_code,
                out_rank=rank, explicit=explicit)
        except map_codegen.Refusal as r:
            return r
        except map_codegen.Unsupported as u:
            raise _unsupported(compiled.func_string, u.reason) from None
    prog = compiled._cached(key, gen)
    if isinstance(prog, map_codegen.Program):
        for n, dt in zip(arrays, prog.out_dtypes):
            if vals[n].dtype != dt:
                raise RuntimeError(f"map: the kernel generator infers {dt} "
                                   f"for {n!r}, the plain engine gives "
                                   f"{vals[n].dtype}")
    return prog, names, scal, arrays, vals, out_shape


def _eager_cuda(compiled, arrs, scalar_names, method, shape):
    """The eager call on M1 -> results dict, or None where the generator
    refuses the program under 'auto' (`map_codegen.Refusal`: an
    ``extra_code`` helper that cannot be inlined, what the kernel does
    not implement in the explicit form, a scatter into an array an
    earlier segment wrote); 'cuda' raises with the reason.

    The broadcasting form: statements of any shape that broadcasts to the
    inputs' are outputs of one launch (each written once); a statement
    that depends on no array is the plain engine's own value, as the
    plain engine returns it.  The explicit form: every statement over
    the grid `shape`, each input read at its computed indices through its
    own shape and strides; a statement whose left-hand index is not the
    axis names scatters into a copy of its target (two launches, one
    where the scatter is injective: ops/map_kernel.py).  A statement that reads what an earlier one
    scattered starts a program of its own (`_scatter_segments`), each
    segment's results the next one's inputs; a scatter writes a copy of
    its ORIGINAL target (the JAX package's quirk), so a later segment's
    scatter into an array an earlier segment wrote is refused.  Each
    output's shape and type are the plain engine's (`_eager_plan`).
    What the broadcasting form's kernel does not implement raises
    `map_codegen.Unsupported` under either method."""
    if compiled.explicit and shape is None:
        return None                     # the plain engine's error
    segs = _scatter_segments(compiled) if compiled.explicit else []
    parts = [compiled] if len(segs) < 2 else \
        [compiled.segment(a, b) for a, b in segs]
    cur, results = dict(arrs), {}
    for part in parts:
        again = [n for n, idx, _ in part.statements if n in results and
                 idx is not None and tuple(idx) != compiled.axis_names]
        if again:
            return _refused(compiled, method,
                            f"a scatter into {again[0]!r} after an earlier "
                            f"statement wrote it and a later one read it: "
                            f"the scatter writes a copy of the original "
                            f"target")
        res = _eager_launch(part, cur, scalar_names, method, shape)
        if res is None:
            return None
        results.update(res)
        cur.update(res)
    return results


def _refused(compiled, method, reason):
    """None, where 'auto' runs the call on the plain engine; 'cuda'
    raises with the reason."""
    if method == "cuda":
        raise ValueError(f"map: method 'cuda' cannot run "
                         f"{compiled.func_string!r}: the kernel generator "
                         f"refuses it ({reason})")
    return None


def _eager_launch(compiled, arrs, scalar_names, method, shape):
    """One program of the eager call (`_eager_cuda`) on M1 -> results
    dict, or `_refused`'s None."""
    prog, names, scal, arrays, vals, out_shape = _eager_plan(
        compiled, arrs, scalar_names, shape)
    results = {n: vals[n] for n in dict.fromkeys(
        s[0] for s in compiled.statements) if n not in arrays}
    if prog is None:
        return results
    if isinstance(prog, map_codegen.Refusal):
        return _refused(compiled, method, prog.reason)
    dev = arrs[names[0]].device
    outs = None
    if not compiled.explicit:
        outs = [torch.empty(vals[n].shape, dtype=dt, device=dev)
                for n, dt in zip(arrays, prog.out_dtypes)]
    try:
        outs, _ = map_apply(prog, [arrs[k] for k in names],
                            out_shape or (1,),
                            [scal[k] for k in prog.scalar_names], outs=outs)
    except map_codegen.Unsupported as u:
        raise _unsupported(compiled.func_string, u.reason) from None
    results.update(zip(arrays, outs))
    return results


def _scatter_segments(compiled):
    """The explicit form's statements cut before each one that reads an
    array an earlier statement of its segment scattered into ->
    [(start, end)]: a scatter's result is whole only after its launches,
    so each segment is a program of its own (`_CompiledMap.segment`),
    the earlier segments' results its inputs."""
    axes = tuple(compiled.axis_names)
    segs, start, scattered = [], 0, set()
    for k, (name, idx, rhs) in enumerate(compiled.statements):
        reads = set()
        for e in [rhs] + list(idx or ()):
            reads.update(_IDENT_RE.findall(e))
        if reads & scattered:
            segs.append((start, k))
            start, scattered = k, set()
        if idx is not None and tuple(idx) != axes:
            scattered.add(name)
        else:
            scattered.discard(name)
    segs.append((start, len(compiled.statements)))
    return segs


def eager_program(func_string, data, axis_names=None, shape=None,
                  extra_code=None):
    """The generated program :func:`map` launches for `data` on a card
    (tensors and numbers) -> (`map_codegen.Program`, its inputs in order,
    its run-time scalar values in order, the grid, the output names);
    raises `map_codegen.Refusal` for a program the generator refuses.
    ``map_kernel.map_apply(prog, ins, grid, scalars)`` then runs it
    alone (no plain-engine pass on 'meta' at each call): how a caller
    times the kernel."""
    compiled = _compile_map(func_string, tuple(sorted(data.keys())),
                            tuple(axis_names) if axis_names else None,
                            extra_code)
    arrs = {k: (v if isinstance(v, torch.Tensor) else _py_scalar(v))
            for k, v in data.items()}
    scalar_names = {k for k, v in arrs.items()
                    if not isinstance(v, torch.Tensor)}
    prog, names, scal, arrays, _, grid = _eager_plan(
        compiled, arrs, scalar_names,
        tuple(shape) if shape is not None else None)
    if isinstance(prog, map_codegen.Refusal):
        raise prog
    if prog is None:
        raise ValueError(f"map: no statement of {func_string!r} is an "
                         f"array")
    return (prog, [arrs[k] for k in names],
            [scal[k] for k in prog.scalar_names], grid or (1,), arrays)


def map(func_string, data, axis_names=None, shape=None, func_name=None,
        extra_code=None, block_shape=None, block_axes=None):
    """Apply `func_string` to named arrays (reference map.py:62).

    `block_shape`/`block_axes` are accepted for API parity and ignored,
    as in the JAX package.  `extra_code` takes Python helper definitions
    (source with `torch` and `np` in scope) callable from func_string.
    Tensors are used where they lie, numpy arrays go to this thread's
    device.  The `map_method` flag: 'auto' and 'cuda' run the call on M1
    for CUDA tensors (`_eager_cuda`): the broadcasting form, every
    statement that depends on an array written by one launch at its own
    shape; the explicit-index form over `shape` in one launch, two where
    a statement scatters (one where the scatter is an injective
    permutation of the grid axes), a program of its own from each
    statement that reads what an earlier one scattered; inlinable helpers
    inlined.  What the generator
    refuses runs on the plain engine under 'auto' and raises under
    'cuda'.  'plain' runs the plain engine.
    """
    compiled = _compile_map(func_string, tuple(sorted(data.keys())),
                            tuple(axis_names) if axis_names else None,
                            extra_code)
    out_names = [s[0] for s in compiled.statements]

    arrs = {}
    outs = {}
    scalars = set()
    for name, arr in data.items():
        if isinstance(arr, (int, float, complex)) or \
                (isinstance(arr, np.ndarray) and arr.ndim == 0):
            arrs[name] = _py_scalar(arr)
            scalars.add(name)
            continue
        arrs[name] = _eager_input(arr)
        if name in out_names:
            outs[name] = arr

    req = _method_request(None)
    if req not in ("auto", "cuda", "plain"):
        raise ValueError(f"map: unknown method {req!r} (map_method config "
                         f"flag; expected auto/cuda/plain)")
    results = None
    devs = {v.device.type for v in arrs.values()
            if isinstance(v, torch.Tensor)}
    if req != "plain" and devs == {"cuda"}:
        results = _eager_cuda(compiled, arrs, scalars, req,
                              tuple(shape) if shape is not None else None)
    if results is None:
        shapes = {n: (None if n in scalars else tuple(arrs[n].shape))
                  for n in arrs}
        fn = compiled.get_fn(shapes, None, frozenset(scalars),
                             tuple(shape) if shape is not None else None)
        results = fn(**arrs)
    ret = {}
    for name in out_names:
        ret[name] = _eager_finalize(results[name], outs.get(name))
    if len(ret) == 1:
        return next(iter(ret.values()))
    return ret


def clear_map_cache():
    _compile_map.cache_clear()


def list_map_cache():
    info = _compile_map.cache_info()
    print(f"Cache enabled: yes\nCache entries: {info.currsize}")
