"""Shared cases of kernel M1's tests (tests/test_torch_map_codegen.py on
the CPU, tests/test_torch_gpu.py on the card): the storage forms its two
paths are held on, the inputs of each layout, and the complex64 sqrt
edge points.  Imports no JAX, so the card tests can use it."""

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
