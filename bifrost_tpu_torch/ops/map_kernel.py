"""Kernel M1: bf.map's generated CUDA kernel and its plain version.

M1 has no Pallas counterpart.  The JAX package translates each map
program into one jnp closure that XLA compiles into one device program
(bifrost_tpu/ops/map.py:421-511, `_CompiledMap.build`, and :380
`_stream_eval` under ``jax.jit``); the reference compiled one CUDA kernel
per expression (src/map.cpp).  Here ops/map_codegen.py writes one CUDA
C++ kernel per program over csrc/map_common.cuh and build.py's
`load_generated` compiles it with nvcc for sm_90a, ``--fmad=false``.

What bounds it: bytes, once a sample costs few instructions.  A thread
computes every statement in registers, so temporaries never reach device
memory: one pass reads each input element (more only where an index
expression gathers it again) and writes each output element once.  The
card issues some 3.3e13 thread-instructions a second, so a 2-byte f16
sample at the bytes bound may spend about 40 of them; the design keeps
the index arithmetic and the accesses well under that:

- the elementwise and eager calls are collapsed at launch (`collapse`):
  a contiguous ring span walks as one axis;
- each kernel is built for a 32-bit and a 64-bit index type; `pack`
  takes the 32-bit one while ``n + ncarry`` and every operand's largest
  element offset are below `INDEX32_LIMIT`;
- no division by a run-time extent: each is a host-computed
  multiply-and-shift pair (`magic`, PyTorch's IntDivider method), exact
  for every index of the type;
- the vector path: a thread owns V consecutive output samples
  (`Program.vec`) and moves each operand in one vector access, the
  widest in 16 bytes (2 complex64 or 8 f16 a thread), the narrower in
  V samples' bytes (4 of ci8 pairs, 1 of ci2, unpacked in registers),
  so that every access of a warp is one contiguous span; wider spans a
  thread break the stores' coalescing (V = 8 on ci8 -> complex64, 64
  bytes a thread, took 0.273 ms against the first design's 0.195 on an
  H100; loading several items' words before computing them gained
  nothing).  The path applies where every operand's
  innermost stride is one sample of its storage form (0 for a broadcast
  input) and the pointers and outer strides are aligned; the ragged
  tail and any other layout take the element path of the same kernel;
- the local and stencil forms put the frame axis on the grid's y axis: a
  thread decomposes its channel once and walks a run of `Program.run`
  frames, and the stencil keeps its last noffset frames in a register
  window, so each input element is loaded once;
- the grid is four waves of the blocks the device's SMs hold
  (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, in the library),
  and the 16-byte stores carry the streaming hint (``st.global.cs``).

`map_apply(prog, ins, out_shape, scalars, carry, outs)` launches M1 for
CUDA tensors on the caller's current stream, reading every input through
its element strides (a ring span as it lies; a complex-integer stream in
its storage form, ci8 pairs and packed ci4 read in the kernel), and runs
`map_apply_plain` (the program's plain PyTorch closure, `prog.plain`)
for CPU tensors; any other device raises.  `map_apply.launches` counts
its launches and nothing else; `.vector_launches` and
`.index64_launches` count those that took the vector path and the
64-bit index type, and `.last` (and the program's `last_launch`) holds
the last launch's plan: path, V, index type, grid.  `map_apply_host`
runs the same generated body, the same vector/element split, compiled
by the host C++ compiler on CPU tensors (counted on itself the same
way): the tests' way to hold the generated arithmetic against the plain
engine without a card.
"""

from __future__ import annotations

import ctypes
import math
import re
import struct

import torch

from .. import build
from .map_codegen import HEADER, storage_bytes

INDEX32_LIMIT = 2 ** 31
LAYOUTS = 8           # layouts whose words a program keeps (`pack`)


def magic(d, bits):
    """The meta words (m, s) of divisor `d` for `bits`-bit indices:
    n // d == (umulhi(n, m) + n) >> s for every 0 <= n < 2**(bits - 1)
    (PyTorch's IntDivider: s = ceil(log2 d), m = 2**bits (2**s - d) // d
    + 1, which fits in `bits` bits); m as a signed 64-bit word."""
    if not 1 <= d < 2 ** (bits - 1):
        raise ValueError(f"map: divisor {d} outside 1 .. 2**{bits - 1} - 1")
    s = (d - 1).bit_length()
    m = ((1 << bits) * ((1 << s) - d)) // d + 1
    return (m - (1 << 64) if m >= 1 << 63 else m), s


def magic_div(n, m, s, bits):
    """What the kernel computes from the words of `magic`: the high half
    of the unsigned product, the sum in `bits` bits, the shift."""
    mask = (1 << bits) - 1
    t = (n * (m & mask)) >> bits
    return ((t + n) & mask) >> s


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
    extent 1, and pad at the front to `rank` axes -> (shape, strides,
    nd, the axes that are not padding); raises `Unsupported` where more
    than `rank` axes remain.  With `keep_last` the last axis stays apart
    (a packed storage addresses it by byte)."""
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
    nd = max(1, len(out))
    out = [(1, [0] * len(strides))] * (rank - len(out)) + out
    return ([n for n, _ in out],
            [[st[k] for _, st in out] for k in range(len(strides))], nd)


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


def _unit(inp):
    """(one sample's step along the innermost axis in storage units,
    bytes a storage unit) of input `inp`."""
    if inp.storage == "pair":
        return 2, inp.int_dtype.itemsize
    if inp.storage in ("real", "complex"):
        return 1, inp.dtype.itemsize
    return 1, 1                            # ci4, packed, cpacked: bytes


def _fit(words, n, fill):
    """The last `n` of `words`, padded at the front with `fill`."""
    words = list(words)[-n:] if n else []
    return [fill] * (n - len(words)) + words


def _aligned(ptr, strides, ub, align):
    return ptr % align == 0 and all(s * ub % align == 0 for s in strides)


def _chan_contiguous(ext, strides, unit):
    """Whether `strides` walk the axes of extents `ext` as one, a sample
    `unit` storage units from the next (extent-1 axes ignored)."""
    want = unit
    for e, st in reversed([(e, st) for e, st in zip(ext, strides) if e > 1]):
        if st != want:
            return False
        want = st * e
    return True


def _vector_1d(prog, out_shape, nd, outs, ostr, ins, views):
    """The elementwise and eager forms: each input's vector mode (1: one
    vector access, 0: a broadcast, one load) where the vector path
    applies, else None."""
    V, R = prog.vec, len(out_shape)
    L = out_shape[-1]
    if V == 1 or not (nd == 1 or L % V == 0) or math.prod(out_shape) < V:
        return None
    outer = [d for d in range(R - 1) if out_shape[d] > 1]
    for o, st in zip(outs, ostr):
        e = o.element_size()
        if st[-1] != 1 or not _aligned(o.data_ptr(), [st[d] for d in outer],
                                       e, min(16, prog.chunk * e)):
            return None
    modes = []
    for t, inp, (_, strides, cs, bs) in zip(ins, prog.inputs, views):
        walk = bs if bs is not None else strides
        unit, ub = _unit(inp)
        if walk[-1] == 0 and bs is not None:
            modes.append(0)
            continue
        nb = max(1, int(storage_bytes(inp) * V))
        if walk[-1] != unit or (inp.storage == "pair" and cs != 1) or \
                not _aligned(t.data_ptr(), [walk[d] for d in outer], ub,
                             min(16, nb)):
            return None
        modes.append(1)
    return modes


def _vector_2d(prog, out_shape, outs, ostr, ins, views, carry):
    """The local and stencil forms: whether V consecutive channel samples
    of every output (and of the windowed input, and the stencil's carry)
    are one aligned vector access."""
    V, R = prog.vec, len(out_shape)
    if V == 1 or R < 2 or math.prod(out_shape[1:]) % V:
        return False
    chan = list(out_shape[1:])
    for o, st in zip(outs, ostr):
        e = o.element_size()
        if not (_chan_contiguous(chan, st[1:], 1) and
                _aligned(o.data_ptr(), [st[0]] if out_shape[0] > 1 else [],
                         e, min(16, prog.chunk * e))):
            return False
    if not prog.window:
        return True
    inp = prog.inputs[0]
    shape, strides, cs, _ = views[0]
    if list(shape[1:]) != chan or (inp.storage == "pair" and cs != 1):
        return False
    unit, ub = _unit(inp)
    sext = list(shape[1:])
    if inp.storage in ("packed", "cpacked"):
        sext[-1] //= inp.per_byte
    nb = int(storage_bytes(inp) * V)
    if not (_chan_contiguous(sext, strides[1:], unit) and
            _aligned(ins[0].data_ptr(), [strides[0]] if shape[0] > 1
                     else [], ub, min(16, nb))):
        return False
    return carry is None or carry.data_ptr() % min(
        16, V * inp.dtype.itemsize) == 0


def _max_offset(shape, strides, inp=None, cs=0):
    """The largest storage offset an operand of logical `shape` read
    through `strides` reaches."""
    ext = list(shape)
    if inp is not None and inp.storage in ("packed", "cpacked") and ext:
        ext[-1] = -(-ext[-1] // inp.per_byte)
    return sum((e - 1) * abs(st) for e, st in zip(ext, strides)
               if e > 0) + abs(cs)


def _layout_key(prog, ins, out_shape, carry, outs):
    """What the layout words depend on: every operand's shape, strides,
    dtype and pointer alignment (mod 16)."""
    return (prog.vec, tuple(out_shape),
            tuple((t.shape, t.stride(), t.dtype, t.data_ptr() % 16)
                  for t in list(ins) + list(outs)),
            None if carry is None else (carry.shape, carry.data_ptr() % 16))


def pack(prog, ins, out_shape, scalars, carry, outs, carry_out):
    """The kernel's meta words and pointers, in map_codegen's layout, and
    the launch plan {'path': 'vector' or 'element', 'vec', 'run',
    'index': 'int32' or 'int64', 'nd'}.  An eager call's outputs may be
    of any shape that broadcasts to `out_shape` (each written once); the
    elementwise and eager calls are collapsed (`collapse`).  The words
    up to the scalars (shape, dividers, strides, path) are kept on the
    program by the operands' layout (`LAYOUTS` of them), so a repeated
    call (a ring's next gulp) packs only its scalars and pointers."""
    if len(ins) != len(prog.inputs) or len(outs) != len(prog.out_names):
        raise ValueError("map: inputs or outputs do not match the program")
    key = _layout_key(prog, ins, out_shape, carry, outs)
    hit = prog.layouts.get(key)
    if hit is None:
        hit = _layout(prog, ins, out_shape, carry, outs, carry_out)
        prog.layouts[key] = hit
        while len(prog.layouts) > LAYOUTS:
            prog.layouts.popitem(last=False)
    words, out_shape, plan = hit
    m = words + _scalar_slots(prog, scalars) + \
        prog.derive(dict(zip(prog.scalar_names, scalars)), out_shape)
    if len(m) != prog.nmeta:
        raise ValueError(f"map: packed {len(m)} meta words, the program "
                         f"takes {prog.nmeta}")
    ptrs = [t.data_ptr() for t in ins] + [o.data_ptr() for o in outs] + [
        carry.data_ptr() if carry is not None else 0,
        carry_out.data_ptr() if carry_out is not None else 0]
    return ((ctypes.c_longlong * len(m))(*m),
            (ctypes.c_void_p * len(ptrs))(*ptrs), dict(plan))


def _layout(prog, ins, out_shape, carry, outs, carry_out):
    """The layout words of `pack` (checking the operands), the collapsed
    output shape and the plan."""
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
    R = prog.rank
    nd = R
    if not prog.two_d and (len(out_shape) > R or not prog.uses_coords):
        # The elementwise and eager forms read every input at the
        # output's coordinates: collapse them all alike.  A packed input
        # whose bytes lie contiguous along the last axis walks it in
        # samples (its other strides times the samples a byte), so it
        # merges with the axes before it; any other keeps the last axis
        # apart (addressed by byte).
        walks = ostr + [v[3] if v[3] is not None else v[1] for v in views]
        keep = False
        for k, inp in enumerate(prog.inputs):
            w = walks[len(outs) + k]
            if inp.storage in ("packed", "cpacked"):
                if w[-1] == 1:
                    walks[len(outs) + k] = [s * inp.per_byte
                                            for s in w[:-1]] + [1]
                else:
                    keep = True
        out_shape, walks, nd = collapse(out_shape, walks, R, keep)
        ostr = walks[:len(outs)]
        for v, w, inp in zip(views, walks[len(outs):], prog.inputs):
            if inp.storage in ("packed", "cpacked") and not keep:
                w = [s // inp.per_byte for s in w[:-1]] + [w[-1]]
            if v[3] is not None:
                v[3] = w
            else:
                v[0], v[1] = out_shape, w
    V = prog.vec
    if prog.two_d:
        modes = [0] * len(ins)
        vec = _vector_2d(prog, out_shape, outs, ostr, ins, views, carry)
        chan = math.prod(out_shape[1:])
        nvec, nci = 0, chan // V if vec else chan
        nruns = -(-out_shape[0] // prog.run)
    else:
        modes = _vector_1d(prog, out_shape, nd, outs, ostr, ins, views)
        vec = modes is not None
        modes = modes or [0] * len(ins)
        nvec, nci, nruns = (n // V if vec else 0), 0, 0
    # 32-bit indices where every index and offset fits.
    offs = [n + ncarry] + [_max_offset(out_shape, st) for st in ostr]
    for (shape, strides, cs, bs), inp in zip(views, prog.inputs):
        offs.append(_max_offset(out_shape, bs, inp, cs) if bs is not None
                    else _max_offset(shape, strides, inp, cs))
    idx64 = max(offs) >= INDEX32_LIMIT
    bits = 64 if idx64 else 32
    chan_in = 1
    if prog.form == "stencil":
        chan_in = math.prod(logical_shape(ins[0], prog.inputs[0])[1:])
    m = [n, ncarry, int(vec), nd, nvec, nci, nruns, chan_in,
         *magic(max(chan_in, 1), bits)]
    assert len(m) == len(HEADER)
    m += list(out_shape)
    for d in range(1, R):
        ext = out_shape[d] // V if (vec and not prog.two_d and
                                    d == R - 1) else out_shape[d]
        m += magic(max(ext, 1), bits)
    for d in range(1, R):
        m += magic(max(out_shape[d], 1), bits)
    if prog.form == "stencil":
        lshape = logical_shape(ins[0], prog.inputs[0])
        for d in range(1, prog.inputs[0].rank):
            m += magic(max(lshape[d], 1), bits)
    for st in ostr:
        m += list(st)
        if eager:
            m.append(sum(1 << d for d, (a, e) in enumerate(zip(st, out_shape))
                         if a == 0 and e != 1))
    for (shape, strides, cs, bs), inp, mode in zip(views, prog.inputs,
                                                   modes):
        m += _fit(shape, inp.rank, 1) + _fit(strides, inp.rank, 0) + [cs]
        if bs is not None:
            m += list(bs)
        m.append(mode)
    plan = {"path": "vector" if (nvec or (prog.two_d and vec)) else
            "element", "vec": V, "run": prog.run,
            "index": "int64" if idx64 else "int32", "nd": nd}
    return m, out_shape, plan


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


def _spill_bytes(name):
    """ptxas's spill stores (bytes) of generated library `name`, or 0."""
    for e in reversed(build.generated_log):
        if e["name"] == name and e["kind"] == "cuda":
            return sum(int(x) for x in re.findall(
                r"(\d+) bytes spill stores", e["ptxas"]))
    return 0


def _library(prog):
    """The program's loaded library, kept on the program after its first
    load (build.py keys the load on a hash of the source and header).  A
    build whose kernels spill is redone with half the V (no vector path
    below a window's packed byte), and `prog.vec_note` says so."""
    lib = getattr(prog, "lib", None)
    if lib is not None:
        return lib
    while True:
        lib = build.load_generated(prog.name, prog.source)
        spill = _spill_bytes(prog.name)
        if not spill or prog.vec == 1:
            break
        note = f"V {prog.vec} spilled {spill} bytes"
        vec = prog.vec // 2
        prog.set_vec(vec if vec >= prog.min_vec else 1)
        prog.vec_note = (prog.vec_note + "; " if prog.vec_note else "") + \
            note + f", rebuilt with V {prog.vec}"
    if not getattr(lib, "_map_bound", False):
        lib.map_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p,
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


def _count(fn, prog, plan):
    fn.launches += 1
    fn.vector_launches += plan["path"] == "vector"
    fn.index64_launches += plan["index"] == "int64"
    fn.last = prog.last_launch = plan


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
    lib = _library(prog)                # first: a spill may change V
    m, ptrs, plan = pack(prog, ins, tuple(out_shape), scalars, carry,
                         outs, carry_out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    info = (ctypes.c_int * 6)()
    err = lib.map_launch(m, ptrs, int(plan["index"] == "int64"), stream,
                         info)
    if err:
        raise RuntimeError(f"map_apply: launch failed: "
                           f"{lib.map_error_string(err).decode()}")
    plan.update(grid=(info[0], info[1]), block=(info[2], info[3]),
                blocks_per_sm=info[4], sms=info[5])
    _count(map_apply, prog, plan)
    return outs, carry_out


def map_apply_host(prog, ins, out_shape, scalars=(), carry=None,
                   outs=None):
    """The generated body compiled by the host C++ compiler, run on CPU
    tensors through the same vector/element split: what M1 computes,
    without a card (the tests' check of the generated arithmetic)."""
    dev = ins[0].device
    if dev.type != "cpu":
        raise ValueError("map_apply_host runs on CPU tensors")
    outs = _outputs(prog, tuple(out_shape), dev, outs)
    carry_out = _carry_out(prog, ins, carry)
    m, ptrs, plan = pack(prog, ins, tuple(out_shape), scalars, carry, outs,
                         carry_out)
    lib = build.load_generated_host(prog.name, prog.source)
    lib.map_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.map_host.restype = ctypes.c_int
    lib.map_host(m, ptrs, int(plan["index"] == "int64"))
    _count(map_apply_host, prog, plan)
    return outs, carry_out


for _fn in (map_apply, map_apply_host):
    _fn.launches = _fn.vector_launches = _fn.index64_launches = 0
    _fn.last = None
