"""Shared cases of kernel M1's tests (tests/test_torch_map_codegen.py on
the CPU, tests/test_torch_gpu.py on the card): the storage forms its two
paths are held on, the inputs of each layout, the complex64 sqrt edge
points, and the eager explicit-index, scatter and streaming programs
(tests/test_torch_map.py holds them against the JAX package).  Imports
no JAX, so the card tests can use it."""

import numpy as np
import torch

# storage form -> (program, DataType or torch dtype, samples a byte)
FORMS = {
    "ci8": ("y = v * v.conj() + v * 2", "ci8", 1),
    "ci4": ("y = v * v.conj() + v * 2", "ci4", 1),
    "ci2": ("y = v * v.conj() + v * 2", "ci2", 2),
    "ci1": ("y = v * v.conj() + v * 2", "ci1", 4),
    "i4": ("y = v * 3 - (v >> 1)", "i4", 2),
    "f16": ("y = v * v - v * 0.5 + 1.25", torch.float16, 1),
    "bf16": ("y = v * v - v * 0.5 + 1.25", torch.bfloat16, 1),
    "f32": ("y = v * v - v / 3 + 1.5", torch.float32, 1),
    "c64": ("y = v * v.conj() + v * 2", torch.complex64, 1),
}

LAYOUTS = ["vector", "tail", "unaligned", "transposed"]


def storage(form, frames, chan, seed=31, dev=None):
    """A (frames, chan)-sample input in `form`'s storage form:
    integer-exact values (complex64 of small integers)."""
    rng = np.random.default_rng(seed)
    per = FORMS[form][2]
    if form == "ci8":
        x = torch.from_numpy(rng.integers(-128, 128, (frames, chan, 2))
                             .astype(np.int8))
    elif form in ("ci4", "ci2", "ci1", "i4"):
        x = torch.from_numpy(rng.integers(0, 256, (frames, chan // per))
                             .astype(np.uint8))
    elif form == "c64":
        x = torch.complex(*(torch.from_numpy(
            rng.integers(-50, 50, (frames, chan)).astype(np.float32))
            for _ in range(2)))
    else:
        x = torch.from_numpy((rng.standard_normal((frames, chan)) * 3)
                             .astype(np.float32)).to(FORMS[form][1])
    return x if dev is None else x.to(dev)


def layout(form, kind, frames, wide, seed=31, dev=None):
    """The input of layout `kind`: 'vector' (contiguous, `frames` x 64
    samples, n a multiple of V), 'tail' (contiguous, n not a multiple of
    V where V exceeds the samples a byte), 'unaligned' (a span from frame
    1: its start is not aligned to the vector access) or 'transposed'
    (the innermost stride is not one sample; `wide` = (frames a sample
    of a byte, channels) before the transpose)."""
    chan = 36 if FORMS[form][2] > 1 else 37
    if kind == "vector":
        return storage(form, frames, 64, seed, dev)
    if kind == "tail":
        return storage(form, frames, chan, seed, dev)
    if kind == "unaligned":
        return storage(form, frames + 1, chan, seed, dev)[1:]
    return storage(form, 2 * FORMS[form][2] * wide[0], wide[1], seed,
                   dev).transpose(0, 1)


# complex64 sqrt at the ends of the f32 range (csqrt_f's scaled
# branches): parts of FLT_MAX's size, subnormal parts, zero against a
# tiny part, and each branch's threshold 2^60 / 2^-60 from both sides.
_FMAX, _FTINY = float(np.finfo(np.float32).max), 1e-44
SQRT_EDGES = [
    (3e38, 3e38), (-3e38, 3e38), (_FMAX, _FMAX), (-_FMAX, -_FMAX),
    (_FMAX, 0.0), (-_FMAX, 0.0), (0.0, _FMAX), (3.4e38, -1e-30),
    (-3.4e38, 1e-30), (1e30, 1e-30), (1e-30, -1e30),
    (0.0, _FTINY), (0.0, -_FTINY), (_FTINY, 0.0), (-_FTINY, 0.0),
    (1e-45, 1e-45), (-1e-45, 1e-45), (1e-40, 1e-40), (-1e-40, 3e-42),
    (1e-38, -1e-41), (2.0 ** 60, 1.0), (2.0 ** 60 * (1 - 2 ** -24), -1.0),
    (-(2.0 ** -60), 2.0 ** -70), (2.0 ** -60 * (1 - 2 ** -24), 2.0 ** -61),
    (1e-20, 1e-20), (-1e-20, -1e-25), (1.5, -2.5), (-4.0, 0.0),
]


def sqrt_edge_ulps(got, z):
    """Per point, max |got - sqrt(z)| in complex64 ulps of max(|z|,
    |sqrt(z)|), against a 120-bit mpmath reference (|z| taken in f64,
    where it does not overflow)."""
    import mpmath
    with mpmath.workprec(120):
        ref = torch.tensor([complex(mpmath.sqrt(mpmath.mpc(complex(v))))
                            for v in z.reshape(-1).cpu().numpy()],
                           dtype=torch.complex128)
    return ulps_of(got.reshape(-1).cpu(), ref, z.reshape(-1).cpu())


def ulps_of(got, want, z):
    """Per point, max |got - want| in complex64 ulps of max(|z|, |want|),
    all taken in complex128."""
    want = want.to(torch.complex128)
    scale = torch.maximum(z.to(torch.complex128).abs(), want.abs())
    d = (torch.view_as_real(got.to(torch.complex128)) -
         torch.view_as_real(want)).abs().amax(-1) / scale
    return d / 2.0 ** -24


# The eager scatter's JAX semantics: a = 10..14, c = 0, shape (5,).
SCATTER_TABLE = [
    ("c(i+2) = a(i)", [0, 0, 10, 11, 12]),
    ("c(2*i) = a(i)", [10, 0, 11, 0, 12]),
    ("c(i-7) = a(i)", [12, 13, 14, 0, 0]),
    ("c(i//2) = a(i)", [11, 13, 14, 0, 0]),
]

# Multi-axis gathers and scatters on `eager_data`: (program, shape,
# scalars).
EAGER_FORMS = [
    ("d(i,j) = a(j,i)", (5, 6), {}),
    ("e(i) = a(i, k)", (6,), {"k": 3}),
    ("e(i) = a(i, k)", (6,), {"k": -2}),
    ("c(i,j) = a(i,0) * b(j)", (6, 5), {}),
    ("c(i,j) = a(ni-1-i, j) + s", (6, 5), {"s": 0.5}),
    ("c(i, nj-1-j) = a(i, j)", (6, 5), {}),
    ("c(i//2, j) = a(i, j)", (6, 5), {}),
    ("c(2*i, j) = a(i, j) * s", (6, 5), {"s": 3}),
    ("d(j, i) = a(i, j) + b(j)", (6, 5), {}),
    ("c(i - k, j) = a(i, j); e(i, j) = c(i, j) * 2", (6, 5), {"k": 8}),
    ("c(i,j) = a(i,j) * b(j); d(j,i) = c(i,j) - a(i,j)", (6, 5), {}),
    ("c(2*i, j) = a(i, j); f = c(i, j) + 1", (6, 5), {}),
    ("c(i//2, j) = a(i, j); t = c(i, j) * 2; u = t - a(i, j)", (6, 5), {}),
]

# Of EAGER_FORMS, those whose statement reads an array an earlier
# statement scattered into: the generator refuses them as one program,
# and the eager call runs them as two (ops/map.py `_scatter_segments`);
# in the last two the second program's statements are not indexed, and it
# stays the explicit form over `shape`.
READS_SCATTERED = ("c(i - k, j) = a(i, j); e(i, j) = c(i, j) * 2",
                   "c(2*i, j) = a(i, j); f = c(i, j) + 1",
                   "c(i//2, j) = a(i, j); t = c(i, j) * 2; "
                   "u = t - a(i, j)")

# Of EAGER_FORMS, the scatters that take one launch: indices a
# permutation of the grid axes, each +-axis + offset, inside the target,
# the program's only output (ops/map_kernel.py `_gather_call`); every
# other scatter takes two.
ONE_PASS = ("c(i, nj-1-j) = a(i, j)", "d(j, i) = a(i, j) + b(j)")

# The forward and unbounded streaming forms over (t, c, s, p).
STREAM_FORMS = [
    ("y(t,c,s,p) = x(t+1,c,s,p) - x(t,c,s,p)", "forward"),
    ("y(t,c,s,p) = x(nt-1-t,c,s,p)", "unbounded"),
    ("z(t,c,s,p) = x(t,c,s,p) * 3; y(t,c,s,p) = z(t-1,c,s,p) + z(t,c,s,p)",
     "unbounded"),
    ("y(t,c,s,p) = x(t-1,c,s,p) + x", "unbounded"),
]


def eager_data(seed=71, dev=None):
    """EAGER_FORMS' arrays: a (6, 5) f32 of small integers, b (5,) int32,
    and the outputs given, c (6, 5) and d (5, 6) f32 (a scatter's
    targets)."""
    rng = np.random.default_rng(seed)
    data = {"a": rng.integers(-20, 20, (6, 5)).astype(np.float32),
            "b": rng.integers(-9, 9, (5,)).astype(np.int32),
            "c": rng.integers(-5, 5, (6, 5)).astype(np.float32),
            "d": rng.integers(-5, 5, (5, 6)).astype(np.float32)}
    return {k: torch.from_numpy(v).to(dev) if dev is not None else
            torch.from_numpy(v) for k, v in data.items()}


def eager_program(func, data, axis_names, shape, extra_code=None):
    """The generated program of the eager call `func` on `data` (tensors
    and numbers) -> (Program, its inputs in order, its output names), as
    ops.map.map builds it for a card."""
    from bifrost_tpu_torch.ops.map import eager_program as program
    prog, ins, _, _, outs = program(func, data, axis_names, shape,
                                    extra_code)
    return prog, ins, outs
