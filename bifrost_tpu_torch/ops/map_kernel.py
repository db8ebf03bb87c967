"""Kernel M1: bf.map's generated CUDA kernel and its plain version.

M1 has no Pallas counterpart.  The JAX package translates each map
program into one jnp closure that XLA compiles into one device program
(bifrost_tpu/ops/map.py:421-511, `_CompiledMap.build`, and :380
`_stream_eval` under ``jax.jit``); the reference compiled one CUDA kernel
per expression (src/map.cpp).  Here ops/map_codegen.py writes one CUDA
C++ kernel per program over csrc/map_common.cuh and build.py's
`load_generated` compiles it with nvcc for sm_90a, ``--fmad=false``.

What bounds it: bytes.  A thread owns output elements through a
grid-stride loop and computes every statement for them in registers, so
temporaries never reach device memory: one pass reads each input element
(more only where an index expression gathers it again) and writes each
output element once.  ``2.0f*x*x.conj() + 1.0f`` on a ci8 gulp reads 2 B
and writes 8 B a sample where the operator-by-operator plain engine makes
some five passes over full-size complex64 temporaries.  This first
kernel is simple: one element a loop step, scalar loads, 64-bit index
arithmetic; wider loads are later work.

`map_apply(prog, ins, out_shape, scalars, carry, outs)` launches M1 for
CUDA tensors on the caller's current stream, reading every input through
its element strides (a ring span as it lies; a complex-integer stream in
its storage form, ci8 pairs and packed ci4 read in the kernel), and runs
`map_apply_plain` (the program's plain PyTorch closure, `prog.plain`)
for CPU tensors; any other device raises.  `map_apply.launches` counts
its launches and nothing else.  `map_apply_host` runs the same
generated body compiled by the host C++ compiler on CPU tensors: the
tests' way to hold the generated arithmetic against the plain engine
without a card.
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch

from .. import build

BLOCK = 256
MAX_GRID = 132 * 64


def _storage_strides(t, inp):
    """-> (logical strides in load units, the (re, im) component stride)
    of input tensor `t` in storage form `inp.storage`."""
    if inp.storage == "pair":
        if t.shape[-1] != 2:
            raise ValueError(f"map: {inp.name!r} pair storage needs a "
                             f"trailing (re, im) axis of 2, got "
                             f"{tuple(t.shape)}")
        return list(t.stride()[:-1]), t.stride()[-1]
    return list(t.stride()), 0


def logical_shape(t, inp):
    if inp.storage == "pair":
        return tuple(t.shape[:-1])
    if inp.storage in ("packed", "cpacked"):
        return tuple(t.shape[:-1]) + (t.shape[-1] * inp.per_byte,)
    return tuple(t.shape)


def _check_input(t, inp, collapsed=False):
    want = {"real": inp.dtype, "complex": inp.dtype,
            "pair": inp.int_dtype, "ci4": torch.uint8,
            "cpacked": torch.uint8, "packed": torch.uint8}[inp.storage]
    if t.dtype != want and not (inp.storage in ("ci4", "cpacked",
                                                "packed") and
                                t.dtype == torch.int8):
        raise TypeError(f"map: input {inp.name!r} must be {want} "
                        f"({inp.storage} storage), got {t.dtype}")
    if len(logical_shape(t, inp)) != inp.rank and not collapsed:
        raise ValueError(f"map: input {inp.name!r} must have logical rank "
                         f"{inp.rank}, got shape {tuple(t.shape)}")


def _bcast_strides(shape, strides, out_shape):
    """Strides of an input read at output coordinates: aligned right,
    0 on an axis it broadcasts along."""
    r = len(out_shape)
    bs = [0] * r
    for d in range(1, len(shape) + 1):
        if shape[-d] != 1:
            if shape[-d] != out_shape[-d]:
                raise ValueError(f"map: shape {tuple(shape)} does not "
                                 f"broadcast to {tuple(out_shape)}")
            bs[r - d] = strides[-d]
    return bs


def collapse(out_shape, strides, rank, keep_last=False):
    """Merge adjacent axes of `out_shape` that every operand's strides
    (each list aligned with `out_shape`) walk as one, drop axes of
    extent 1, and pad at the front to `rank` axes -> (shape, strides);
    raises `Unsupported` where more than `rank` axes remain.  With
    `keep_last` the last axis stays apart (a packed storage addresses it
    by byte)."""
    from .map_codegen import Unsupported
    dims = [(n, [s[d] for s in strides]) for d, n in enumerate(out_shape)]
    last = dims.pop() if keep_last and dims else None
    out = []
    for n, st in dims:
        if n == 1:
            continue
        if out:
            pn, pst = out[-1]
            if all(a == b * n for a, b in zip(pst, st)):
                out[-1] = (pn * n, st)
                continue
        out.append((n, st))
    if last is not None:
        out.append(last)
    if len(out) > rank:
        raise Unsupported(f"map: the strides of a rank-{len(out_shape)} "
                          f"call cannot be collapsed to {rank} axes")
    out = [(1, [0] * len(strides))] * (rank - len(out)) + out
    return ([n for n, _ in out],
            [[st[k] for _, st in out] for k in range(len(strides))])


def _scalar_slots(prog, scalars):
    m = []
    for name, want, v in zip(prog.scalar_names, prog.scalar_types,
                             scalars):
        if not (isinstance(v, torch.Tensor) if want is torch.Tensor
                else type(v) is want):
            raise TypeError(f"map: scalar {name!r} was generated as "
                            f"{want.__name__}, got {type(v).__name__}")
        if isinstance(v, torch.Tensor):
            continue                       # read by `Program.derive`
        if isinstance(v, complex):
            m += [struct.unpack("<q", struct.pack("<d", v.real))[0],
                  struct.unpack("<q", struct.pack("<d", v.imag))[0]]
        elif isinstance(v, float):
            m.append(struct.unpack("<q", struct.pack("<d", v))[0])
        else:
            m.append(int(v))
    return m


def pack(prog, ins, out_shape, scalars, carry, outs, carry_out):
    """The kernel's meta words and pointers, in map_codegen's layout.  An
    eager call's outputs may be of any shape that broadcasts to
    `out_shape` (each written once); a call of more axes than the
    program has is collapsed (`collapse`)."""
    if len(ins) != len(prog.inputs) or len(outs) != len(prog.out_names):
        raise ValueError("map: inputs or outputs do not match the program")
    out_shape = tuple(out_shape)
    n = math.prod(out_shape)
    ncarry = carry_out.numel() if carry_out is not None else 0
    eager = prog.form == "eager"
    ostr = []
    for o in outs:
        if eager:
            ostr.append(_bcast_strides(o.shape, o.stride(), out_shape))
        elif tuple(o.shape) != out_shape:
            raise ValueError(f"map: output shape {tuple(o.shape)} != "
                             f"{out_shape}")
        else:
            ostr.append(list(o.stride()))
    views = []                   # (shape, strides, cs, bcast strides)
    for t, inp in zip(ins, prog.inputs):
        _check_input(t, inp, len(out_shape) > prog.rank)
        strides, cs = _storage_strides(t, inp)
        shape = logical_shape(t, inp)
        bs = _bcast_strides(shape, strides, out_shape) \
            if eager or inp.bcast else None
        views.append([shape, strides, cs, bs])
    if not eager:
        # The streaming forms read their input at the output's frames (a
        # whole-array read at the output's coordinates too): the shapes
        # must agree as the plain engine's broadcast requires.
        lshape = logical_shape(ins[0], prog.inputs[0])
        if lshape[0] != out_shape[0] or (
                (prog.form == "elementwise" or prog.bare_input) and
                lshape != out_shape):
            raise ValueError(f"map: input {lshape} does not match the "
                             f"output {out_shape}")
    if len(out_shape) > prog.rank:
        # The elementwise and eager forms read every input at the
        # output's coordinates: collapse them all alike.
        walks = ostr + [v[3] if v[3] is not None else v[1] for v in views]
        keep = any(inp.storage in ("packed", "cpacked")
                   for inp in prog.inputs)
        out_shape, walks = collapse(out_shape, walks, prog.rank, keep)
        ostr = walks[:len(outs)]
        for v, w in zip(views, walks[len(outs):]):
            v[0], v[1] = out_shape, w
            if v[3] is not None:
                v[3] = w
    m = [n, ncarry] + list(out_shape)
    for st in ostr:
        m += list(st)
        if eager:
            m.append(sum(1 << d for d, (a, e) in enumerate(zip(st, out_shape))
                         if a == 0 and e != 1))
    for shape, strides, cs, bs in views:
        m += list(shape) + list(strides) + [cs]
        if bs is not None:
            m += list(bs)
    m += _scalar_slots(prog, scalars)
    m += prog.derive(dict(zip(prog.scalar_names, scalars)), out_shape)
    if len(m) != prog.nmeta:
        raise ValueError(f"map: packed {len(m)} meta words, the program "
                         f"takes {prog.nmeta}")
    ptrs = [t.data_ptr() for t in ins] + [o.data_ptr() for o in outs] + [
        carry.data_ptr() if carry is not None else 0,
        carry_out.data_ptr() if carry_out is not None else 0]
    return ((ctypes.c_longlong * len(m))(*m),
            (ctypes.c_void_p * len(ptrs))(*ptrs), n + ncarry)


def _outputs(prog, out_shape, device, outs):
    if outs is None:
        return [torch.empty(out_shape, dtype=dt, device=device)
                for dt in prog.out_dtypes]
    for o, dt in zip(outs, prog.out_dtypes):
        if o.dtype != dt or o.device != device:
            raise ValueError(f"map: output must be {dt} on {device}, got "
                             f"{o.dtype} on {o.device}")
    return list(outs)


def _carry_out(prog, ins, carry):
    if prog.form != "stencil":
        return None
    inp = prog.inputs[0]
    chan = logical_shape(ins[0], inp)[1:]
    want = (prog.noffset,) + tuple(chan)
    if carry is None or tuple(carry.shape) != want or \
            carry.dtype != inp.dtype or not carry.is_contiguous():
        raise ValueError(f"map: the stencil carry must be contiguous "
                         f"{inp.dtype} {want}")
    return torch.empty_like(carry)


def _library(prog):
    """The program's loaded library, kept on the program after its first
    load (build.py keys the load on a hash of the source and header)."""
    lib = getattr(prog, "lib", None)
    if lib is not None:
        return lib
    lib = build.load_generated(prog.name, prog.source)
    if not getattr(lib, "_map_bound", False):
        lib.map_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
        lib.map_launch.restype = ctypes.c_int
        lib.map_error_string.argtypes = [ctypes.c_int]
        lib.map_error_string.restype = ctypes.c_char_p
        lib._map_bound = True
    prog.lib = lib
    return lib


def prepare(prog):
    """Build (or load) M1 for `prog` now, so a block's first gulp does not
    wait for nvcc."""
    _library(prog)


def map_apply_plain(prog, ins, out_shape, scalars=(), carry=None,
                    outs=None):
    """M1's plain version: the program's PyTorch closure on the same
    operands -> (outputs list, next carry or None)."""
    ys, carry2 = prog.plain(ins, tuple(out_shape), list(scalars), carry)
    if outs is not None:
        ys = [o.copy_(y) for o, y in zip(outs, ys)]
    return ys, carry2


def map_apply(prog, ins, out_shape, scalars=(), carry=None, outs=None):
    """M1 on the operands' device: one launch on the current CUDA stream
    for CUDA tensors, the plain version for CPU tensors.  ins: the
    program's inputs in storage form; out_shape: the logical output
    shape; scalars: the run-time scalar values in `prog.scalar_names`
    order; carry: a stencil's (noffset, ...chan...) history; outs:
    output tensors (any strides) or None -> (outputs, next carry)."""
    dev = ins[0].device
    if dev.type == "cpu":
        return map_apply_plain(prog, ins, out_shape, scalars, carry, outs)
    if dev.type != "cuda":
        raise ValueError(f"map_apply: unsupported device {dev}")
    for t in list(ins) + ([carry] if carry is not None else []):
        if t.device != dev:
            raise ValueError(f"map_apply: operands on {t.device} and {dev}")
    outs = _outputs(prog, tuple(out_shape), dev, outs)
    carry_out = _carry_out(prog, ins, carry)
    m, ptrs, total = pack(prog, ins, tuple(out_shape), scalars, carry,
                          outs, carry_out)
    lib = _library(prog)
    grid = max(1, min(-(-total // BLOCK), MAX_GRID))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.map_launch(m, ptrs, grid, BLOCK, stream)
    if err:
        raise RuntimeError(f"map_apply: launch failed: "
                           f"{lib.map_error_string(err).decode()}")
    map_apply.launches += 1
    return outs, carry_out


map_apply.launches = 0


def map_apply_host(prog, ins, out_shape, scalars=(), carry=None,
                   outs=None):
    """The generated body compiled by the host C++ compiler, run on CPU
    tensors: what M1 computes, without a card (the tests' check of the
    generated arithmetic)."""
    dev = ins[0].device
    if dev.type != "cpu":
        raise ValueError("map_apply_host runs on CPU tensors")
    outs = _outputs(prog, tuple(out_shape), dev, outs)
    carry_out = _carry_out(prog, ins, carry)
    m, ptrs, _ = pack(prog, ins, tuple(out_shape), scalars, carry, outs,
                      carry_out)
    lib = build.load_generated_host(prog.name, prog.source)
    lib.map_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.map_host.restype = ctypes.c_int
    lib.map_host(m, ptrs)
    return outs, carry_out
