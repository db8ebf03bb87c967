"""bf.map's kernel generator (ops/map_codegen.py) on the CPU: the forms it
takes and the reasons it refuses the others, its type inference against
the plain engine's probe, and the generated statement bodies compiled
over csrc/map_common.cuh by the host C++ compiler
(`build.load_generated_host`, ``-ffp-contract=off``, as
`build.load_host` builds the UDP libraries) and run against the plain
engine (`map_kernel.map_apply_host` against `map_apply_plain`).  No
nvcc runs here: kernel M1 itself is held against its plain version on
the card by tests/test_torch_gpu.py and chip_smoke's [map].

Parity tiers, as stated in each test:
- real f32/f64/integer arithmetic, casts, comparisons, rounding, floor
  ``%``/``//``, gathers, stencils, integer-exact complex input (ci8,
  ci4, ci2, ci1), scalars computed on the host (``**`` and shifts of
  run-time scalars, 0-d tensors), constant arrays, statements that
  depend on no array, collapsed ranks above 8: bitwise;
- f16/bf16 (f32 opmath, rounded after each operator): bitwise where the
  CPU kernels and the card kernels agree (half-representable scalars);
  within one half ulp where the CPU rounds a CPU scalar the card reads
  unrounded (+, -), and for x**3 (the CPU cubes in f32, the card rounds
  x*x first); the plain engine against JAX within HALF_JAX_ULP half ulps;
- transcendentals (exp, log, sin, ...; the host's libm against
  PyTorch's vectorized kernels): within TRANS_ULP ulps of the larger
  magnitude;
- complex products and quotients of arbitrary values: within CX_ULP
  ulps of the largest term;
- complex transcendentals (f64 formulas): within CX_FN_ULP ulps of
  max(|z|, |w|) of PyTorch's CPU kernels, and of a 120-bit mpmath
  reference for complex128.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from bifrost_tpu.ops.map import Map as JMap
from bifrost_tpu.ops.map import map as j_map

from bifrost_tpu_torch import config
from bifrost_tpu_torch.ops import map_codegen, map_kernel
from bifrost_tpu_torch.ops.map import Map
from torch_map_forms import (EAGER_FORMS, FORMS, ONE_PASS, READS_SCATTERED,
                             SCATTER_TABLE, SQRT_EDGES, STREAM_FORMS,
                             eager_data, eager_program,
                             layout as layout_input, sqrt_edge_ulps, storage,
                             ulps_of)

TRANS_ULP = 4
CX_ULP = 4
CX_FN_ULP = 8
HALF_JAX_ULP = 4


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    config.reset("map_method")


def _bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(a.contiguous().view(torch.uint8),
                    b.contiguous().view(torch.uint8))


def _ulps(a, b, scale=None):
    """max |a - b| in ulps of `scale` (default max(|a|, |b|)), NaNs at
    the same places counted equal."""
    a = torch.view_as_real(a) if a.is_complex() else a
    b = torch.view_as_real(b) if b.is_complex() else b
    a, b = a.double(), b.double()
    nan = torch.isnan(a) & torch.isnan(b)
    if scale is None:
        scale = torch.maximum(a.abs(), b.abs())
    d = torch.where(nan, 0, (a - b).abs()) / (2.0 ** -24 *
                                              scale.clamp_min(1e-30))
    return float(d.max()) if d.numel() else 0.0


def _run(func, x, dtype=None, axis_names=None, scalars=None, ocs=None,
         carry=None, in_name=None, extra_code=None):
    """The program of `func` on input `x` (storage form of DataType
    `dtype`, or a logical tensor): host-compiled body and plain engine
    -> (host outputs, plain outputs, program)."""
    op = Map(func, axis_names=axis_names, scalars=scalars, in_name=in_name,
             extra_code=extra_code)
    dkey = dtype if dtype is not None else x.dtype
    rank = x.dim() - (1 if dtype in ("ci8", "ci16", "ci32") else 0)
    prog = op.program(dkey, rank, ocs)
    lshape = map_kernel.logical_shape(x, prog.inputs[0])
    out_shape = lshape if not op.explicit else \
        (lshape[0],) + (tuple(ocs) if ocs is not None else lshape[1:])
    scal = [op.scalars[n] for n in prog.scalar_names]
    if op.fuse_form == "stencil" and carry is None:
        carry = op.carry_init(lshape[1:], prog.inputs[0].dtype)
    ins = [x] + [op.scalars[i.name] for i in prog.inputs[1:]]
    host, hc = map_kernel.map_apply_host(prog, ins, out_shape, scal, carry)
    plain, pc = map_kernel.map_apply_plain(prog, ins, out_shape, scal,
                                           carry)
    return (host[0], hc), (plain[0], pc), prog


# ------------------------------------------------ forms and refusals

# A helper the generator cannot inline (a loop): what stays refused.
LOOP_HELPER = ("def h(v):\n    for _ in range(2):\n        v = v * 2\n"
               "    return v\n")


@pytest.mark.parametrize("func,axes,form,reason", [
    ("y = 2.0f*x*x.conj() + 1.0f", None, "elementwise", None),
    ("y(t,c) = x(t, nc-1-c)", ("t", "c"), "local", None),
    ("y(t,c) = x(t,c) - x(t-2,c)", ("t", "c"), "stencil", None),
    ("y(t,c) = x(t+1,c)", ("t", "c"), "forward", "a loop"),
    ("y(t,c) = x(nt-1-t,c)", ("t", "c"), "unbounded", "a loop"),
])
def test_forms_and_refusal_reasons(func, axes, form, reason):
    """The generator takes every streaming form (the JAX classifier
    gives the same forms), the forward and unbounded ones on the
    element path; 'auto' resolves them to 'cuda'.  What stays refused
    in those forms (a helper with a loop) resolves to 'plain' under
    'auto', with the reason, and 'cuda' raises with it."""
    op = Map(func, axis_names=axes)
    assert op.fuse_form == JMap(func, axis_names=axes).fuse_form == form
    assert op.form_refusal() is None
    assert op._resolve("f32", 2) == "cuda"
    assert op.plan_report()["codegen_refusal"] is None
    if reason is None:
        return
    prog = op.program("f32", 2)
    assert prog.form == form and prog.vec == 1
    func = func.replace("= x(", "= h(x(") + ")"
    op = Map(func, axis_names=axes, extra_code=LOOP_HELPER)
    assert op.fuse_form == form
    assert reason in op.form_refusal()
    assert op._resolve("f32", 2) == "plain"
    assert reason in op.plan_report()["codegen_refusal"]
    with pytest.raises(map_codegen.Refusal, match=reason):
        op.program("f32", 2)
    op.method = "cuda"
    with pytest.raises(ValueError, match=reason):
        op._resolve("f32", 2)


@pytest.mark.parametrize("func,dtype,kwargs,reason", [
    ("y = helper(x)", "f32", dict(extra_code="def helper(v):\n"
                                  "    return v * 2\n"), "extra_code"),
    ("y = x > 0 && x < 1", "f32", {}, "chained comparison"),
    ("y = Complex(v, v)", "f16", {}, "complex32"),
    ("y = x % 2", "cf32", {}, "remainder"),
])
def test_refused_programs_name_their_reason(func, dtype, kwargs, reason):
    """Programs M1 does not run are refused before any build, with the
    reason.  Only a form refused by design (here extra_code) runs on the
    plain engine under 'auto'.  What the kernel does not implement raises
    `Unsupported` under 'auto' and 'cuda' alike, for a card tensor;
    where the plain engine raises on the types (complex ``%``), the
    generator raises its error.  'auto' on the CPU is the plain engine
    whatever the program."""
    op = Map(func, **kwargs)
    assert op._resolve(dtype, 2, device="cpu") == "plain"
    if reason == "extra_code":
        # an inlinable helper is generated; one with a loop is refused
        assert op._resolve(dtype, 2) == "cuda"
        assert op.program(dtype, 2).vec > 1
        op = Map(func.replace("helper", "h"), extra_code=LOOP_HELPER)
        with pytest.raises(map_codegen.Refusal, match=reason):
            op.program(dtype, 2)
        assert op._resolve(dtype, 2) == "plain"
        assert reason in op.codegen_refusal
        return
    if reason == "remainder":
        with pytest.raises(NotImplementedError, match=reason):
            torch.ones(2, dtype=torch.complex64) % 2
        with pytest.raises(NotImplementedError, match=reason):
            op.program(dtype, 2)
        assert not isinstance(_raised(op.program, dtype, 2),
                              map_codegen.Unsupported)
    else:
        with pytest.raises(map_codegen.Unsupported, match=reason):
            op.program(dtype, 2)
    for method in ("auto", "cuda"):
        op.method = method
        with pytest.raises(NotImplementedError, match=reason):
            op._resolve(dtype, 2)
        with pytest.raises(NotImplementedError, match=reason):
            op._resolve(dtype, 2, device="cuda")
    assert op.codegen_refusal is None
    op.method = "plain"
    assert op._resolve(dtype, 2, device="cuda") == "plain"


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as exc:  # noqa: BLE001 — the exception is the result
        return exc
    return None


def test_eager_explicit_forms_are_refused():
    """The eager explicit-index form is generated ('gather', V samples a
    vector item: 4 f32) and a scatter is two launches, or one where its
    indices are a permutation of the grid axes (`one_pass`, taken where
    the launch finds them inside the target); what one program refuses
    is a statement reading an array an earlier statement scattered into
    (the eager call cuts such a program in two)."""
    from bifrost_tpu_torch.ops.map import _compile_map, _full_namespace

    def gen(func, outs):
        cm = _compile_map(func, ("a", "c"), ("i", "j"))
        return map_codegen.generate(
            cm.statements, "eager",
            [map_codegen.input_for_tensor(k, torch.float32, 2)
             for k in ("a", "c")], _full_namespace(None),
            frozenset({"a", "c", "d"}), outs, axis_names=("i", "j"),
            out_rank=2)
    prog = gen("c(i,j) = a(j,i)", ["c"])
    assert prog.form == "gather" and prog.vec == 4 and not prog.scatters
    prog = gen("c(j,i) = a(i,j)", ["c"])
    assert prog.scatters == {0: 2} and map_kernel._passes(prog) == (1, 2)
    assert prog.one_pass is not None
    prog = gen("c(2*j,i) = a(i,j)", ["c"])
    assert prog.scatters == {0: 2} and prog.one_pass is None
    with pytest.raises(map_codegen.Refusal, match="scattered"):
        gen("c(j,i) = a(i,j); d(i,j) = c(i,j) + 1", ["c", "d"])


def test_function_names_ending_in_an_array_name():
    """The translator (the JAX package's, kept unchanged) rewrites
    ``x(`` inside ``max(x, 1)`` as an index of ``x``: ``max[(x, 1,)]``
    (ROADMAP Queue C).  The JAX engine and the port's plain engine both
    raise TypeError, and so does the generator."""
    x = torch.arange(4.0)
    with pytest.raises(TypeError):
        JMap("y = max(x, 1.0)").execute(x.numpy())
    op = Map("y = max(x, 1.0)")
    with pytest.raises(TypeError):
        op.execute(x)
    with pytest.raises(TypeError, match="index"):
        op.program(torch.float32, 1)
    assert torch.equal(Map("y = max(v, 1.0)").execute(x),
                       torch.clamp(x, min=1.0))


def test_and_and_quirk_parses_as_python_does():
    """``&&`` becomes ``&``, which binds tighter than ``<`` (ROADMAP
    Queue C): unparenthesized comparisons chain and are refused by the
    generator (the plain engine raises on them too); parenthesized they
    generate, bitwise the plain engine."""
    x = torch.linspace(-2, 2, 17)
    with pytest.raises(RuntimeError):
        Map("y = x > 0 && x < 1")._plain_eval(x, None, (), {})
    (h, _), (p, _), _ = _run("y = (x > 0) && (x < 1)", x)
    assert h.dtype == torch.bool and _bits(h, p)


# ---------------------------------------------- types against the probe

@pytest.mark.parametrize("func", [
    "y = 2.0*x", "y = x*2", "y = x/2", "y = x//2", "y = x%3", "y = x**2",
    "y = x > 1", "y = sqrt(x)", "y = (float)(x) + 1", "y = (int)(x)",
    "y = x.imag", "y = x.real", "y = mag2(x)", "y = Complex(x, 1)",
    "y = where(x, 1, 2.5)", "y = min(x, 3)", "y = abs(x)", "y = round(x)",
    "y = x * 1j", "y = exp(x)", "y = x + s", "y = x & 1",
])
@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8, torch.int32,
                                   torch.float32, torch.float64,
                                   torch.complex64])
def test_inferred_type_is_the_probe_type(func, dtype):
    """The generator's output type (PyTorch's promotion, weakly typed
    Python scalars) equals the plain engine's on a probe, for every
    program it accepts; where the plain engine raises, the generator
    raises too (its own error, or `Unsupported`)."""
    op = Map(func, scalars={"s": 2})
    x = torch.ones(3, 2, dtype=dtype)
    try:
        want = op._plain_eval(x, None, (2,), op.scalars)[0].dtype
    except Exception:  # noqa: BLE001 — the engine refuses this type
        with pytest.raises(Exception):
            op.program(dtype, 2)
        return
    try:
        prog = op.program(dtype, 2)
    except map_codegen.Unsupported as r:
        assert "complex" in r.reason or "bool" in r.reason, r.reason
        return
    assert prog.out_dtypes[0] == want


# ---------------------------------------- host-compiled bodies, bitwise

def _f32(shape, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


@pytest.mark.parametrize("func", [
    # weak typing: a Python float stays f32, the product rounds once
    "y = 2.0*x + 0.1", "y = s*x - x/3", "y = 3.0/x", "y = (x + 1) * (x - 1)",
    # floor % and // (negative operands), half-even round, trunc casts
    "y = x % 1.5", "y = x // 0.75", "y = -x % 2", "y = round(x * 2)",
    "y = rint(x) + floor(x) - ceil(x)", "y = (float)((int)(x * 3))",
    # pow and its special exponents (x*x, x*x*x, 1/x, 1/(x*x))
    "y = x**2 + x**3", "y = x**-1 + x**-2",
    # ternaries, comparisons, min/max (an input named v: see
    # test_function_names_ending_in_an_array_name)
    "y = x > 0 ? x : (x < -1 ? -x : 0.5)", "y = min(v, 0.5) + max(v, -1)",
    "y = where((x > 1) | (x < -1), x, 0)",
    # multiple statements, temps, real/imag of a real value
    "a = x*x; b = a - x; y = b * a", "y = x.imag + x.real * 2",
])
def test_real_f32_bodies_bitwise(func):
    """Real f32 arithmetic: the host-compiled generated body is bitwise
    the plain engine (no contraction on either side)."""
    x = _f32((7, 5, 3), 1)
    x[0, 0, 0], x[0, 0, 1], x[0, 0, 2] = 0.5, 2.5, -1.5     # ties
    (h, _), (p, _), prog = _run(func, x, scalars={"s": -1.25})
    assert h.dtype == p.dtype == prog.out_dtypes[0]
    assert _bits(h, p), (h - p).abs().max()


@pytest.mark.parametrize("func,dtype", [
    ("y = x*2", torch.int8),            # int8 stays int8 and wraps
    ("y = x*x + 100", torch.int8),
    ("y = -x", torch.int8),
    ("y = x / 3", torch.int8),          # true division: f32
    ("y = x // 3 + x % 3", torch.int8),  # floor, with negatives
    ("y = x // -4 + x % -4", torch.int32),
    ("y = x**3", torch.int8),           # wrapping integer power
    ("y = abs(x)", torch.int8),         # abs(-128) wraps to -128
    ("y = (x & 7) ^ (x | 3)", torch.int16),
    ("y = (x << 3) + (x >> 2)", torch.int8),    # shifts wrap, sign-fill
    ("y = x << 9", torch.int8),         # past the width: 0
    ("y = (v >> (v & 15)) + (v << (v - 1))", torch.int32),
    ("y = (x << 1) | (x >> 7)", torch.uint8),
    ("y = ~x", torch.uint8),
    ("y = x - 300", torch.uint8),       # the scalar wraps to uint8
    ("y = (float)(x) * 0.5", torch.int32),
    ("y = x * 2.5", torch.int16),       # int * float scalar: f32
    ("y = min(v, 5) + max(v, -5)", torch.int32),
])
def test_integer_bodies_bitwise(func, dtype):
    """Integer arithmetic wraps as PyTorch's (and JAX's) does; weakly
    typed scalars keep the tensor's type: bitwise."""
    rng = np.random.default_rng(2)
    info = torch.iinfo(dtype)
    x = torch.from_numpy(rng.integers(max(info.min, -128),
                                      min(info.max, 127) + 1, (9, 4))
                         .astype(str(dtype).split(".")[1]))
    x[0, 0] = max(info.min, -128)
    (h, _), (p, _), prog = _run(func, x)
    assert h.dtype == p.dtype == prog.out_dtypes[0]
    assert _bits(h, p)


def test_nan_propagating_min_max_and_f64():
    """min/max propagate a NaN, as jnp.minimum and torch.minimum do (C's
    fminf does not): bitwise but for the NaN's bits (PyTorch's CPU
    kernel makes its own NaN); f64 arithmetic is bitwise too."""
    x = _f32((6, 4), 3)
    x[1, 2] = float("nan")
    x[4, 0] = float("inf")
    (h, _), (p, _), _ = _run("y = min(v, 0.25) - max(v, -0.25)", x)
    nan = torch.isnan(p)
    assert torch.equal(torch.isnan(h), nan) and bool(nan[1, 2])
    assert _bits(h[~nan], p[~nan])
    xd = _f32((6, 4), 12).double() / 3
    (h, _), (p, _), _ = _run("y = x*x/7 - fabs(x)**3 + x % 0.3", xd)
    assert h.dtype == torch.float64 and _bits(h, p)


@pytest.mark.parametrize("func", ["y = sqrt(fabs(x))", "y = fabs(x)**0.5",
                                  "y = rsqrt(fabs(x) + 1)",
                                  "y = exp(x)", "y = log(fabs(x) + 1)",
                                  "y = sin(x) * cos(x)", "y = tanh(x)",
                                  "y = atan2(x, 1.5)", "y = pow(fabs(x), 1.7)",
                                  "y = erf(x)", "y = log10(fabs(x) + 2)"])
def test_transcendental_bodies_within_tolerance(func):
    """libm on the host against PyTorch's vectorized CPU kernels: within
    TRANS_ULP ulps (of the larger result; a product of two within the
    sum of theirs).  sqrt is here too: the host's is correctly rounded
    (numpy's), PyTorch's CPU sqrt is not always (on the card both are
    sqrtf: the [map] phase holds M1 bitwise there)."""
    x = _f32((8, 16), 4, scale=1.5)
    (h, _), (p, _), _ = _run(func, x)
    assert h.dtype == p.dtype
    assert _ulps(h, p) <= 2 * TRANS_ULP, _ulps(h, p)


@pytest.mark.parametrize("dtype", ["ci8", "ci4"])
def test_raw_complex_heads_bitwise(dtype):
    """ci8 pairs and packed ci4 bytes read in the kernel (ci4 MSB first,
    sign-extended as ops/unpack.py does), the main-path program and the
    complex arithmetic on integer-exact values: bitwise."""
    rng = np.random.default_rng(5)
    if dtype == "ci8":
        x = torch.from_numpy(rng.integers(-128, 128, (10, 6, 2, 2))
                             .astype(np.int8))
    else:
        x = torch.from_numpy(rng.integers(0, 256, (10, 6, 2))
                             .astype(np.uint8))
    for func in ("y = 2.0f*x*x.conj() + 1.0f", "y = x.real * x.imag",
                 "y = mag2(v) - abs(v.real)", "y = v * 1j - Complex(1, v.re"
                 "al)", "y = v.imag * Complex(v.real, 2) + 1j"):
        (h, _), (p, _), _ = _run(func, x, dtype=dtype)
        assert h.dtype == p.dtype and _bits(h, p), func


@pytest.mark.parametrize("dtype", ["i4", "u4", "i2", "u1"])
def test_raw_packed_real_heads_bitwise(dtype):
    """Packed real storage (8 // nbit samples a byte along the last axis,
    MSB first, a signed field sign-extended as ops/unpack.py does) read
    in the kernel: elementwise, a gather along the packed axis (out of
    range on both sides), and a stencil over gulps of 5, 2 and 1 frames,
    also packed along the time axis itself: bitwise the plain engine,
    which unpacks first."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.integers(0, 256, (8, 3)).astype(np.uint8))
    for func, axes in (("y = x * 3 - 1", None),
                       ("y = (float)(x) * 0.5 + x", None),
                       ("y(t,c) = x(t, nc-1-c) - x(t, c+5) * x(t, -c-2)",
                        ("t", "c"))):
        (h, _), (p, _), prog = _run(func, x, dtype=dtype, axis_names=axes)
        assert prog.inputs[0].storage == "packed"
        assert h.shape == (8, 3 * prog.inputs[0].per_byte)
        assert h.dtype == p.dtype and _bits(h, p), func
    for frames, func, axes in (
            (x, "y(t,c) = x(t,c) - x(t-3,c) + x(t-1, c+1)", ("t", "c")),
            (x[:, 0].clone(), "y(t) = x(t) * 2 - x(t-5)", ("t",))):
        # packed along time, one byte is 8 // nbit frames: fewer than
        # noffset (5) in the first two gulps
        cut = (5, 7) if frames.dim() == 2 else (1, 2)
        chunks = [frames[:cut[0]], frames[cut[0]:cut[1]], frames[cut[1]:]]
        hc = None
        for chunk in chunks:
            (h, hc), (p, pc), prog = _run(func, chunk, dtype=dtype,
                                          axis_names=axes, carry=hc)
            assert _bits(h, p) and _bits(hc, pc), func


def test_complex_products_and_quotients_within_tolerance():
    """Complex products and c10::complex's scaled quotient on arbitrary
    values: within CX_ULP ulps of the largest term."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy((rng.standard_normal((12, 5)) +
                          1j * rng.standard_normal((12, 5)))
                         .astype(np.complex64))
    for func in ("y = x * x.conj() * (0.3 + 0.7j)", "y = (x + 1) / (x - 2j)",
                 "y = 2.5 / x", "y = exp(x) * abs(x)"):
        (h, _), (p, _), _ = _run(func, x)
        scale = torch.view_as_real(p).abs().amax(-1, keepdim=True) \
            .expand(*p.shape, 2) + 1
        assert _ulps(h, p, scale) <= 4 * CX_ULP, (func, _ulps(h, p, scale))


def test_local_gathers_clamp_and_wrap():
    """Index expressions computed per element with jnp's gather
    semantics, indices out of range on both sides; a temp indexed at
    other coordinates is recomputed there; an output shape other than
    the input's: bitwise."""
    x = _f32((5, 7), 7)
    for func, ocs in (("y(t,c) = x(t, c-9) + x(t, c+4) * 2", None),
                      ("y(t,c) = x(t, nc-1-c) - x(t-0, -c)", None),
                      ("a(t,c) = x(t,c) * 3; y(t,c) = a(t, c+1) - a(t, c)",
                       None),
                      ("y(t,c) = x(t, 2*c) + c", (4,)),
                      ("y(t,c) = x(t, (int)(x(t,0)) % nc)", None)):
        (h, _), (p, _), _ = _run(func, x, axis_names=("t", "c"), ocs=ocs)
        assert h.shape == p.shape and _bits(h, p), func


@pytest.mark.parametrize("dtype", ["f32", "ci8"])
def test_stencil_carry_two_pointers(dtype):
    """``t - k`` reads the carry for t < k and the gulp otherwise; the
    next carry is the last noffset frames of [carry; gulp], also for a
    gulp shorter than noffset: bitwise the plain engine (which
    concatenates), chained over gulps of 5, 2 and 1 frames."""
    rng = np.random.default_rng(8)
    func = "y(t,c) = x(t,c) - 0.5 * x(t-3,c) + x(t-1, c+1)"
    if dtype == "f32":
        frames = torch.from_numpy(rng.standard_normal((8, 6))
                                  .astype(np.float32))
        chunks = [frames[:5], frames[5:7], frames[7:8]]
    else:
        frames = torch.from_numpy(rng.integers(-100, 100, (8, 6, 2))
                                  .astype(np.int8))
        chunks = [frames[:5], frames[5:7], frames[7:8]]
    hc = pc = None
    for chunk in chunks:
        (h, hc), (p, pc), prog = _run(func, chunk,
                                      dtype=None if dtype == "f32" else dtype,
                                      axis_names=("t", "c"),
                                      carry=hc if hc is not None else None)
        assert prog.noffset == 3
        assert _bits(h, p) and _bits(hc, pc)


def test_eager_broadcast_bodies_bitwise():
    """The eager call's broadcasting form: each input through its own
    strides (0 on a broadcast axis, a transposed view), every statement
    written out: bitwise the plain engine."""
    from bifrost_tpu_torch.ops.map import _compile_map, _full_namespace
    a = _f32((4, 6), 9)
    b = _f32((6,), 10)
    c = _f32((6, 4), 11).T          # strided
    cm = _compile_map("d = a*b - c; e = d*2 + s", ("a", "b", "c", "d", "e",
                                                   "s"), None)
    prog = map_codegen.generate(
        cm.statements, "eager",
        [map_codegen.input_for_tensor(k, v.dtype, v.dim())
         for k, v in (("a", a), ("b", b), ("c", c))],
        _full_namespace(None), frozenset("abcdes"), ["d", "e"],
        scalars={"s": 0.75}, out_rank=2)
    host, _ = map_kernel.map_apply_host(prog, [a, b, c], (4, 6), [0.75])
    d = a * b - c
    assert _bits(host[0], d) and _bits(host[1], d * 2 + 0.75)


def test_generated_source_is_deterministic_and_keyed():
    """One source per program: the same expression and types give the
    same key (the library is built once), scalars are run-time values
    (a new value needs no new kernel), a new type a new kernel."""
    a = Map("y = s*x + 1", scalars={"s": 2.0}).program(torch.float32, 2)
    b = Map("y = s*x + 1", scalars={"s": 3.5}).program(torch.float32, 2)
    c = Map("y = s*x + 1", scalars={"s": 3}).program(torch.float32, 2)
    d = Map("y = s*x + 1", scalars={"s": 2.0}).program(torch.float64, 2)
    assert a.key == b.key and len({a.key, c.key, d.key}) == 3
    assert "map_common.cuh" in a.source and "__launch_bounds__" in a.source


# ------------------- half types, ci2/ci1, complex math, scalars, shapes

def _half(dtype, shape=(9, 33), seed=14):
    return (_f32(shape, seed, scale=3.0)).to(dtype)


def _jax_half(x):
    import jax.numpy as jnp
    return jnp.asarray(x.float().numpy()).astype(
        jnp.float16 if x.dtype == torch.float16 else jnp.bfloat16)


def _half_ulps(a, b):
    """max |a - b| in half ulps (10 or 7 mantissa bits) of max(|a|, |b|,
    1), the size of the programs' terms: a sum that cancels is held to
    its terms' rounding; NaNs at the same places equal."""
    bits = 10 if a.dtype == torch.float16 else 7
    a, b = a.double(), b.double()
    nan = torch.isnan(a) & torch.isnan(b)
    scale = torch.maximum(a.abs(), b.abs()).clamp_min(1.0)
    ulp = 2.0 ** (torch.floor(torch.log2(scale)) - bits)
    d = torch.where(nan, 0, (a - b).abs()) / ulp
    return float(d.max())


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("func,exact", [
    ("y = v * v - v / 3 + 1.5", True),
    ("y = v * 0.5 - 0.25 * v + 2", True),
    ("y = v > 0.5 ? v // 0.75 : v % 1.25", True),
    ("y = max(v, 0.5) + round(v * 4) - min(v, -1)", True),
    ("y = sqrt(fabs(v)) + rsqrt(fabs(v) + 1)", True),
    ("y = v ** 2 + v ** -1 + fabs(v) ** 0.5", True),
    ("y = (float)(v) * 3 + v", True),
    ("y = v + (v < 1) * 2", True),
    ("y = v * 0.1 + 0.3", False),
    ("y = v ** 3", False),
    ("y = v ** -2", False),
])
def test_half_bodies(dtype, func, exact):
    """f16 and bf16 as storage types, f32 arithmetic rounded after each
    operator: the host body is bitwise the plain engine where the CPU and
    card kernels agree (`exact`), within one half ulp where they do not
    (the CPU's + and - round a Python scalar to the half type first, the
    card's do not and M1 follows the card; the CPU's f16 x**3 and x**-2
    compute x*x in f32, the card's round it first); the plain engine
    within HALF_JAX_ULP half ulps of the JAX Map on the same data
    (XLA:CPU may keep f32 across a fusion of the program's few
    operators).  Ulps of max(|y|, 1) (`_half_ulps`)."""
    x = _half(dtype)
    (h, _), (p, _), prog = _run(func, x)
    assert h.dtype == p.dtype == prog.out_dtypes[0]
    if exact:
        assert _bits(h, p), (h.double() - p.double()).abs().max()
    else:
        assert _half_ulps(h, p) <= 1
    if h.dtype in (torch.float16, torch.bfloat16):
        j = torch.from_numpy(np.asarray(
            JMap(func, in_name="v").execute(_jax_half(x)), np.float32))
        assert _half_ulps(p, j.to(p.dtype)) <= HALF_JAX_ULP, func


@pytest.mark.parametrize("dtype,per", [("ci2", 2), ("ci1", 4)])
def test_raw_cpacked_heads_bitwise(dtype, per):
    """Packed ci2 and ci1 (8 // (2 nbit) samples a byte, each (re, im)
    pair of fields MSB first, sign-extended: ops/unpack.py's order) read
    in the kernel: elementwise, a gather along the packed axis and a
    stencil over gulps of 3, 2 and 3 frames: bitwise the plain engine,
    whose lift is bitwise the JAX Map's `_lift` (and its program on the
    same bytes)."""
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.integers(0, 256, (8, 3)).astype(np.uint8))
    for func, axes in (("y = v * v.conj() + v * 2", None),
                       ("y(t,c) = v(t, nc-1-c) - v(t, c+5) * 1j",
                        ("t", "c"))):
        op = Map(func, axis_names=axes, in_name="v")
        (h, _), (p, _), prog = _run(func, x, dtype=dtype, axis_names=axes)
        assert prog.inputs[0].storage == "cpacked"
        assert h.shape == (8, 3 * per) and _bits(h, p), func
        j = np.asarray(JMap(func, axis_names=axes, in_name="v")
                       .execute_raw(x.numpy(), dtype))
        assert np.array_equal(p.numpy(), j), func
        assert op.fuse_form in ("elementwise", "local")
    hc = None
    for chunk in (x[:3], x[3:5], x[5:]):
        (h, hc), (p, pc), _ = _run("y(t,c) = v(t,c) - v(t-2,c) * 0.5",
                                   chunk, dtype=dtype, axis_names=("t", "c"),
                                   carry=hc)
        assert _bits(h, p) and _bits(hc, pc)


_CX_FUNCS = ("sqrt", "log", "log2", "log10", "sin", "cos", "tan", "asin",
             "acos", "atan", "sinh", "cosh", "tanh", "rsqrt")


def _cx_points(dtype, shape=(24, 16), seed=16):
    """|z| in (0.1, 10), random phases: never on a branch cut."""
    rng = np.random.default_rng(seed)
    mag = np.exp(rng.uniform(np.log(0.1), np.log(10), shape))
    z = torch.from_numpy(mag * np.exp(1j * rng.uniform(-np.pi, np.pi,
                                                        shape)))
    return z.to(dtype)


def _cx_ulps(got, want, z):
    eps = 2.0 ** -24 if got.dtype == torch.complex64 else 2.0 ** -53
    scale = torch.maximum(z.abs().double(), want.abs().double())[..., None]
    g = torch.view_as_real(got).double()
    w = torch.view_as_real(want).double()
    return float(((g - w).abs() / scale).max()) / eps


@pytest.mark.parametrize("fn", _CX_FUNCS + ("pow", "cpow"))
def test_complex_transcendental_bodies_within_tolerance(fn):
    """Complex sqrt, log, log2, log10, the trigonometric and hyperbolic
    functions, the inverse trigonometric ones, rsqrt and pow (the
    formulas of csrc/map_common.cuh, computed in f64; branch cuts: sqrt,
    log, rsqrt and pow on the negative real axis, asin and acos on the
    real axis beyond +-1, atan on the imaginary axis beyond +-i): within
    CX_FN_ULP ulps of max(|z|, |w|) of PyTorch's CPU kernels (pow: 2x:
    PyTorch's complex64 pow is float exp(w log z), 12 ulps off)
    for complex64 and complex128; against a 120-bit mpmath reference
    the complex64 body within 2 ulps (f64, rounded once), the complex128
    body within CX_FN_ULP (pow: 2x, exp(w log z) in f64); the plain
    engine on complex64 within 4 CX_FN_ULP of the JAX Map's (two float
    formulas)."""
    mpmath = pytest.importorskip("mpmath")
    func = {"pow": "y = v ** 2.5", "cpow": "y = pow(v, 0.5 + 1.5j)"}.get(
        fn, f"y = {fn}(v)")
    tol = CX_FN_ULP * (2 if "pow" in fn else 1)
    f = {"log2": lambda v: mpmath.log(v, 2),
         "rsqrt": lambda v: 1 / mpmath.sqrt(v),
         "pow": lambda v: mpmath.power(v, 2.5),
         "cpow": lambda v: mpmath.power(v, mpmath.mpc(0.5, 1.5))}.get(
        fn, getattr(mpmath, fn, None))
    for dtype, exact in ((torch.complex64, 2), (torch.complex128, tol)):
        z = _cx_points(dtype)
        (h, _), (p, _), _ = _run(func, z)
        assert h.dtype == p.dtype == dtype
        assert _cx_ulps(h, p, z) <= tol, (dtype, _cx_ulps(h, p, z))
        with mpmath.workprec(120):
            ref = torch.tensor([[complex(f(mpmath.mpc(complex(v))))
                                 for v in row] for row in z.numpy()],
                               dtype=torch.complex128)
        err = _cx_ulps(h.to(torch.complex128), ref, z)
        if dtype == torch.complex64:
            err *= 2.0 ** -29          # in complex64 ulps
        assert err <= exact, (dtype, err)
    z = _cx_points(torch.complex64)
    (_, _), (p, _), _ = _run(func, z)
    j = torch.from_numpy(np.asarray(JMap(func, in_name="v").execute(
        z.numpy())))
    assert _cx_ulps(p, j, z) <= 4 * tol, _cx_ulps(p, j, z)


def test_complex64_sqrt_at_the_ends_of_the_range():
    """complex64 sqrt (csqrt_f, f32 with its operands scaled by powers
    of two) on SQRT_EDGES (FLT_MAX-sized parts, subnormal parts, zero
    against a tiny part, the scaling thresholds): finite, within 2 ulps
    of max(|z|, |w|) of a 120-bit mpmath reference, and within CX_FN_ULP
    of PyTorch's CPU kernel, which the plain engine runs."""
    pytest.importorskip("mpmath")
    z = torch.tensor([complex(a, b) for a, b in SQRT_EDGES],
                     dtype=torch.complex64)[None, :]
    (h, _), (p, _), _ = _run("y = sqrt(v)", z)
    assert torch.isfinite(torch.view_as_real(h)).all(), h
    err = sqrt_edge_ulps(h, z)
    assert float(err.max()) <= 2, dict(zip(SQRT_EDGES, err.tolist()))
    err = ulps_of(h, p, z)
    assert float(err.max()) <= CX_FN_ULP, dict(zip(SQRT_EDGES, err.tolist()))


@pytest.mark.parametrize("func,scalars", [
    # Python's ** and shifts of run-time scalars, and torch's ** of them
    ("y = v * (s ** t) + (k << j) - (k >> j)",
     {"s": 2.5, "t": 1.5, "k": 37, "j": 3}),
    ("y = v * (k ** j) - f32cast(s) ** 2.5", {"s": 1.7, "k": 3, "j": 5}),
    # torch on 0-d CPU tensors: computed by the plain engine itself
    ("y = v * exp(f32cast(s)) + sqrt(f32cast(s) * 0.1)", {"s": 1.3}),
    ("y = v * w0 + (w0 > 0.2)", {"w0": torch.tensor(0.3)}),
    ("y = v * (not s) + (not t) * 2", {"s": 0, "t": 2.5}),
])
def test_host_scalar_values_bitwise(func, scalars):
    """What the plain engine computes on the host from run-time scalars
    alone (Python's ``**``, shifts and ``not``, torch on 0-d CPU tensors,
    a 0-d tensor bound as a scalar) is its own value, computed at launch:
    bitwise, and a new value of the same type needs no new program."""
    x = _f32((6, 5), 17)
    if "not" in func:
        # `not` reads as a name to the streaming form's input inference:
        # the eager call takes it (the JAX eager map too).
        from bifrost_tpu_torch.ops.map import _compile_map, \
            _full_namespace
        cm = _compile_map(func, ("s", "t", "v", "y"), None)
        prog = map_codegen.generate(
            cm.statements, "eager",
            [map_codegen.input_for_tensor("v", x.dtype, 2)],
            _full_namespace(None), frozenset("stvy"), ["y"],
            scalars=scalars, out_rank=2)
        h, _ = map_kernel.map_apply_host(prog, [x], tuple(x.shape),
                                         [scalars[k] for k in
                                          prog.scalar_names])
        assert _bits(h[0], x * True + False * 2)
        return
    (h, _), (p, _), prog = _run(func, x, scalars=scalars)
    assert _bits(h, p)
    other = {k: (v + 1 if not isinstance(v, torch.Tensor) else v * 2)
             for k, v in scalars.items()}
    op = Map(func, scalars=other, in_name="v")
    assert op.program(torch.float32, 2).key == prog.key
    (h, _), (p, _), _ = _run(func, x, scalars=other)
    assert _bits(h, p)


def test_statements_that_depend_on_no_array():
    """A statement whose value depends on no array: an intermediate of
    the elementwise form stays a weakly typed scalar, in the explicit
    forms it is broadcast to the output grid (ops/map.py `_broadcast`:
    int32 for an int); bitwise the plain engine."""
    x = _f32((6, 5), 18)
    for func, axes, want in (("a = s * 2; y = v * a", None, torch.float32),
                             ("y(t,c) = 3", ("t", "c"), torch.int32),
                             ("a = s * 2; y(t,c) = v(t,c) * a + a",
                              ("t", "c"), torch.float32)):
        (h, _), (p, _), prog = _run(func, x, axis_names=axes,
                                    scalars={"s": 1.5}, in_name="v")
        assert prog.out_dtypes[0] == h.dtype == want
        assert _bits(h, p), func


@pytest.mark.parametrize("func,axes", [
    ("y = v * w + 1", None),
    ("y(t,c) = v(t, nc-1-c) * w", ("t", "c")),
    ("y(t,c) = v(t,c) - v(t-2,c) * w", ("t", "c")),
])
def test_constant_arrays_bitwise(func, axes):
    """A tensor bound as a scalar is a constant array: read as a buffer
    at the output's coordinates through its broadcast strides (a new
    value of the same shape needs no new program): bitwise the plain
    engine, in the elementwise, local and stencil forms."""
    x = _f32((6, 5), 19)
    w = _f32((5,), 20)
    (h, _), (p, _), prog = _run(func, x, axis_names=axes,
                                scalars={"w": w})
    assert [i.name for i in prog.inputs[1:]] == ["w"] and _bits(h, p)
    (h, _), (p, _), prog2 = _run(func, x, axis_names=axes,
                                 scalars={"w": w * 3})
    assert prog2.key == prog.key and _bits(h, p)


def test_eager_statements_of_differing_shapes():
    """The eager call: statements of any shape that broadcasts to the
    inputs' are outputs of one kernel, each written once (an output of a
    smaller shape at coordinate 0 of the axes it lacks); ``not`` of a
    scalar; a statement that depends on no array is the plain engine's
    own value.  Bitwise the plain engine."""
    from bifrost_tpu_torch.ops.map import _compile_map, _full_namespace
    a = _f32((7, 6), 21)
    b = _f32((6,), 22)
    cm = _compile_map("c = a + 1; d = b * 2; e = s * 3; f = a * (not s)",
                      ("a", "b", "s"), None)
    prog = map_codegen.generate(
        cm.statements, "eager",
        [map_codegen.input_for_tensor(k, v.dtype, v.dim())
         for k, v in (("a", a), ("b", b))], _full_namespace(None),
        frozenset("abcdefs"), ["c", "d", "f"], scalars={"s": 0},
        out_rank=2)
    outs = [torch.full((7, 6), -7.0), torch.full((6,), -7.0),
            torch.full((7, 6), -7.0)]
    map_kernel.map_apply_host(prog, [a, b], (7, 6), [0], outs=outs)
    for got, want in zip(outs, (a + 1, b * 2, a * True)):
        assert _bits(got, want)


def test_ranks_above_eight_collapse():
    """Rank 10: the elementwise form and the eager call collapse the
    axes every operand walks as one to 8 (contiguous, and strided along
    the last axis); strides that cannot be collapsed raise Unsupported
    at launch; an indexed form of rank 9 raises when generated."""
    from bifrost_tpu_torch.ops.map import _compile_map, _full_namespace
    shape = (2, 3, 2, 2, 3, 2, 2, 2, 3, 4)
    big = _f32(shape[:-1] + (8,), 23)
    for x in (big[..., :4].contiguous(), big[..., ::2]):
        (h, _), (p, _), prog = _run("y = v * 3 - 1", x)
        assert prog.rank == map_codegen.MAX_RANK and _bits(h, p)
    bad = big.permute(9, 8, 7, 6, 5, 4, 3, 2, 1, 0)[::2]
    with pytest.raises(map_codegen.Unsupported, match="collapsed"):
        _run("y = v * 3 - 1", bad)
    b = _f32((4,), 24)
    cm = _compile_map("c = a * b; d = b - 1", ("a", "b"), None)
    prog = map_codegen.generate(
        cm.statements, "eager",
        [map_codegen.input_for_tensor(k, torch.float32, 8)
         for k in ("a", "b")], _full_namespace(None), frozenset("abcd"),
        ["c", "d"], out_rank=8)
    a = big[..., :4].contiguous()
    outs = [torch.empty(shape), torch.empty(4)]
    map_kernel.map_apply_host(prog, [a, b], shape, [], outs=outs)
    assert _bits(outs[0], a * b) and _bits(outs[1], b - 1)
    with pytest.raises(map_codegen.Unsupported, match="rank above"):
        Map("y(a,b,c,d,e,f,g,h,i) = v(a,b,c,d,e,f,g,h,i)",
            axis_names=tuple("abcdefghi")).program(torch.float32, 9)


# ------------------- the Hopper design: paths, index types, dividers
#
# M1 takes its vector path (V consecutive samples a thread, one vector
# access an operand) where every operand's innermost stride is one sample
# of its storage form and the pointers are aligned, the element path
# otherwise (and for the ragged tail); 32-bit indices below
# map_kernel.INDEX32_LIMIT.  The host build runs the same split, so these
# hold both paths and both index types against the plain engine, bitwise.

def _layout(form, kind):
    return layout_input(form, kind, 13, (3, 12))


@pytest.mark.parametrize("layout", ["vector", "tail", "unaligned",
                                    "transposed"])
@pytest.mark.parametrize("form", list(FORMS))
def test_vector_and_element_paths_bitwise(form, layout):
    """Each storage form on the vector path (contiguous; with a ragged
    tail the last n % V samples on the element path) and on the element
    path (a span from an unaligned frame, a transposed operand): bitwise
    the plain engine, the path as the layout decides, 32-bit indices.  A
    one-byte vector (ci2, ci1: V samples fill a byte) is aligned
    anywhere, and has no ragged tail."""
    func, dt, per = FORMS[form]
    x = _layout(form, layout)
    (h, _), (p, _), prog = _run(func, x, dtype=dt if isinstance(dt, str)
                                else None, in_name="v")
    nb = map_codegen.storage_bytes(prog.inputs[0]) * prog.vec
    path = "element" if layout == "transposed" or (
        layout == "unaligned" and nb > 1) else "vector"
    last = map_kernel.map_apply_host.last
    assert (last["path"], last["index"]) == (path, "int32"), last
    if layout == "tail":
        assert (h.numel() % prog.vec != 0) == (prog.vec > per)
    assert h.dtype == p.dtype and _bits(h, p), (form, layout)


def test_vector_widths():
    """V: the widest streamed operand moves 16 bytes a thread (in a
    window at least the samples a packed byte holds; an elementwise item
    may start inside a byte); no vector path where the stencil's window
    would not fit map_codegen.VEC_BYTES, nor for a form with no channel
    axis."""
    def prog(func, dt, rank=2, axes=None):
        return Map(func, axis_names=axes, in_name="v").program(dt, rank)
    for func, dt, axes, vec in (
            ("y = 2.0f*v*v.conj() + 1.0f", "ci8", None, 2),
            ("y = v * v - v * 0.5 + 1.25", torch.float16, None, 8),
            ("y = v * v.conj() + v * 2", "ci2", None, 2),
            ("y = v * v.conj() + v * 2", "ci1", None, 2),
            ("y = v * 3 - (v >> 1)", "i4", None, 16),
            ("y = sqrt(v)", torch.complex64, None, 2),
            ("y = v * 2", torch.float32, None, 4),
            ("y(t,c) = v(t,c) - v(t-1,c)", "ci8", ("t", "c"), 2),
            ("y(t,c) = v(t,c) - v(t-3,c)", torch.complex64, ("t", "c"), 2),
            # a window of 16 complex frames of ci1's 4 samples: 512 B
            ("y(t,c) = v(t,c) - v(t-15,c)", "ci1", ("t", "c"), 1)):
        assert prog(func, dt, axes=axes).vec == vec, (func, dt)
    assert prog("y(t) = v(t) - v(t-1)", torch.float32, 1, ("t",)).vec == 1


@pytest.mark.parametrize("noff", [1, 3])
@pytest.mark.parametrize("dtype", ["f32", "ci8"])
@pytest.mark.parametrize("layout", ["vector", "element"])
def test_stencil_register_window(noff, dtype, layout):
    """The stencil's register window: runs of RUN frames over gulps of
    37, 2 (shorter than the carry at noffset 3), 50 and 17 frames (runs
    that do not divide the gulp; a run starting at frame 0 reads its
    history from the carry), a gather beside the window reads; on a
    strided span from an unaligned column the element path: bitwise the
    plain engine's concatenation, next carry included."""
    rng = np.random.default_rng(32)
    func = (f"y(t,c) = x(t,c) - x(t-{noff},c) * 0.5 + x(t-1,c) * "
            f"x(t-1, c+1)")
    n = 37 + 2 + 50 + 17
    if dtype == "f32":
        big = torch.from_numpy(rng.integers(-60, 60, (n, 72))
                               .astype(np.float32))
    else:
        big = torch.from_numpy(rng.integers(-60, 60, (n, 72, 2))
                               .astype(np.int8))
    frames = big[:, :64].contiguous() if layout == "vector" else \
        big[:, 3:67]
    hc = pc = None
    a = 0
    for g in (37, 2, 50, 17):
        (h, hc), (p, pc), prog = _run(
            func, frames[a:a + g], dtype=None if dtype == "f32" else "ci8",
            axis_names=("t", "c"), carry=hc)
        a += g
        assert prog.window and prog.noffset == noff and g % prog.run
        assert map_kernel.map_apply_host.last["path"] == layout
        assert _bits(h, p) and _bits(hc, pc), g


@pytest.mark.parametrize("func,ocs,window", [
    ("y(t,c) = x(t,c) * 2 + x(t, nc-1-c)", None, True),
    ("y(t,c) = x(t, 2*c) - c", (32,), False),
    ("a(t,c) = x(t,c) * 3; y(t,c) = a(t, c+1) - x", None, True),
])
def test_local_form_paths_bitwise(func, ocs, window):
    """The local form: a run of frames a thread, its channel decomposed
    once; reads of frame t at the output's channels from the vector load,
    gathers per sample, vector stores: bitwise the plain engine on both
    paths (a contiguous input and a strided span)."""
    big = _f32((21, 72), 33)
    for x, path in ((big[:, :64].contiguous(), "vector"),
                    (big[:, 1:65], "vector" if not window else "element")):
        (h, _), (p, _), prog = _run(func, x, axis_names=("t", "c"), ocs=ocs)
        assert prog.window == window
        assert map_kernel.map_apply_host.last["path"] == path
        assert h.shape == p.shape and _bits(h, p), func


@pytest.mark.parametrize("bshape,func,path", [
    ((64,), "c = a*b - 1; d = b * 2", "vector"),
    ((300, 1), "c = a*b - 1; d = a - b", "vector"),
    ((300, 1), "c = a*b - 1; d = b * 2", "element"),
    ((63,), "c = a*b - 1; d = b * 2", "element")])
def test_eager_broadcast_paths(bshape, func, path):
    """The eager call with a broadcast operand: along the outer axis
    (innermost stride 1: an output of its smaller shape written once) and
    along the innermost axis (stride 0: one load a vector) on the vector
    path; an output broadcast along the innermost axis, or an innermost
    extent that V does not divide (the axes cannot be collapsed), on the
    element path.  Bitwise the plain engine."""
    from bifrost_tpu_torch.ops.map import _compile_map, _full_namespace
    a = _f32((300, bshape[-1] if bshape[-1] != 1 else 64), 34)
    b = _f32(bshape, 35)
    cm = _compile_map(func, ("a", "b"), None)
    prog = map_codegen.generate(
        cm.statements, "eager",
        [map_codegen.input_for_tensor(k, v.dtype, v.dim())
         for k, v in (("a", a), ("b", b))], _full_namespace(None),
        frozenset("abcd"), ["c", "d"], out_rank=2)
    want = [a * b - 1, a - b if "a - b" in func else b * 2]
    outs = [torch.full(w.shape, -7.0) for w in want]
    map_kernel.map_apply_host(prog, [a, b], tuple(a.shape), [], outs=outs)
    assert map_kernel.map_apply_host.last["path"] == path
    assert all(_bits(o, w) for o, w in zip(outs, want))


@pytest.mark.parametrize("case", ["elementwise", "stencil", "local",
                                  "packed", "eager"])
def test_index64_form_bitwise(case, monkeypatch):
    """The 64-bit index type, taken where an index or offset reaches
    map_kernel.INDEX32_LIMIT (lowered here to 16): bitwise the plain
    engine on both paths, and counted."""
    monkeypatch.setattr(map_kernel, "INDEX32_LIMIT", 16)
    before = map_kernel.map_apply_host.index64_launches
    x = storage("ci8", 13, 64)
    if case == "elementwise":
        (h, _), (p, _), _ = _run("y = 2.0f*x*x.conj() + 1.0f", x, "ci8")
        assert _bits(h, p)
    elif case == "stencil":
        hc = None
        for a, b in ((0, 5), (5, 7), (7, 13)):
            (h, hc), (p, pc), _ = _run(
                "y(t,c) = x(t,c) - x(t-3,c) + x(t-1, c+1)", x[a:b], "ci8",
                axis_names=("t", "c"), carry=hc)
            assert _bits(h, p) and _bits(hc, pc)
    elif case == "local":
        (h, _), (p, _), _ = _run("y(t,c) = x(t, nc-1-c) * 2 + x(t,c)", x,
                                 "ci8", axis_names=("t", "c"))
        assert _bits(h, p)
    elif case == "packed":
        (h, _), (p, _), _ = _run("y = v * 3 - (v >> 1)",
                                 storage("i4", 13, 36)[1:], "i4",
                                 in_name="v")
        assert _bits(h, p)
    else:
        test_eager_broadcast_paths((64,), "c = a*b - 1; d = b * 2",
                                   "vector")
    assert map_kernel.map_apply_host.last["index"] == "int64"
    assert map_kernel.map_apply_host.index64_launches > before


def test_path_counter():
    """map_apply_host counts its launches, those on the vector path and
    those with 64-bit indices (map_apply counts the card's the same way,
    tests/test_torch_gpu.py), and keeps the last launch's plan."""
    fn = map_kernel.map_apply_host
    start = (fn.launches, fn.vector_launches, fn.index64_launches)
    _run("y = v * 2", _f32((8, 16), 36), in_name="v")
    assert fn.last["path"] == "vector" and fn.last["vec"] == 4
    _run("y = v * 2", _f32((16, 8), 37).T, in_name="v")
    assert fn.last["path"] == "element"
    assert (fn.launches, fn.vector_launches, fn.index64_launches) == (
        start[0] + 2, start[1] + 1, start[2])


def test_layout_words_kept_by_layout():
    """pack keeps a program's layout words (shape, dividers, strides,
    path) by its operands' layout: another gulp of the same layout
    reuses them, a span of another alignment gets its own (and its own
    path); the results stay bitwise the plain engine."""
    big = _f32((41, 16), 38)
    op = Map("y = v * 2 + s", in_name="v", scalars={"s": 1.5})
    prog = op.program(torch.float32, 2)
    for x, n, path in ((big[:20], 1, "vector"), (big[20:40], 1, "vector"),
                       (big[1:21][:, :15], 2, "element")):
        y, _ = map_kernel.map_apply_host(prog, [x], tuple(x.shape), [1.5])
        assert len(prog.layouts) == n
        assert map_kernel.map_apply_host.last["path"] == path
        assert _bits(y[0], x * 2 + 1.5)


def test_spilling_build_halves_v(monkeypatch):
    """A build whose kernels spill is redone with half the V, and the
    program says so (`vec_note`); nvcc is stood in for here."""
    from bifrost_tpu_torch import build

    class Lib(object):
        class Fn(object):
            pass

        def __init__(self):
            self.map_launch, self.map_error_string = self.Fn(), self.Fn()

    prog = Map("y = x * x - x * 0.5").program(torch.float16, 3)
    assert prog.vec == 8

    def load(name, source):
        spill = 24 if prog.vec > 2 else 0
        build.generated_log.append({
            "name": name, "kind": "cuda", "seconds": 0.0, "nvcc": True,
            "ptxas": f"ptxas info : Function properties for k\n"
                     f"    0 bytes stack frame, {spill} bytes spill stores, "
                     f"{spill} bytes spill loads\n"})
        return Lib()
    monkeypatch.setattr(build, "load_generated", load)
    map_kernel.prepare(prog)
    assert prog.vec == 2 and prog.vec_note == (
        "V 8 spilled 24 bytes, rebuilt with V 4; "
        "V 4 spilled 24 bytes, rebuilt with V 2")


_DIV_SOURCE = """#include "map_common.cuh"
using namespace bfmap;
extern "C" void divide(const long long* n, const long long* m,
                       const long long* s, long long* q, int count,
                       int bits) {
  for (int i = 0; i < count; ++i)
    q[i] = bits == 32 ? (long long)div_magic<int>((int)n[i], m[i], s[i])
                      : div_magic<long long>(n[i], m[i], s[i]);
}
"""


def _c_divide(n, d, bits):
    """csrc/map_common.cuh's div_magic (host build) on the words of
    map_kernel.magic."""
    import ctypes
    from bifrost_tpu_torch import build
    lib = build.load_generated_host("map_divide", _DIV_SOURCE)
    m, s = map_kernel.magic(d, bits)
    arr = [(ctypes.c_longlong * 1)(v) for v in (n, m, s)]
    q = (ctypes.c_longlong * 1)()
    lib.divide(*arr, q, 1, bits)
    return q[0]


# The edges of each index type: 1, 2, 3, powers of two and their
# neighbours, the type's largest value (2**31 - 1, 2**63 - 1).
_EDGES = {bits: sorted({1, 2, 3} | {2 ** k + e for k in range(2, bits - 1)
                                    for e in (-1, 0, 1)} | {2 ** (bits - 1) - 1})
          for bits in (32, 64)}


@pytest.mark.parametrize("bits", [32, 64])
def test_divider_at_the_edges(bits):
    """The multiply-and-shift divider (map_kernel.magic, its Python model
    magic_div and the header's div_magic) is n // d at the edges: d and n
    among 1, 2, 3, the powers of two and their neighbours and the index
    type's largest value, and n at d - 1, d, d + 1."""
    top = 2 ** (bits - 1) - 1
    for d in _EDGES[bits]:
        m, s = map_kernel.magic(d, bits)
        ns = {n for n in _EDGES[bits] + [0, d - 1, d, d + 1, top]
              if 0 <= n <= top}
        for n in ns:
            assert map_kernel.magic_div(n, m, s, bits) == n // d, (n, d)
    for d, n in ((1, top), (top, top), (top, top - 1), (3, top),
                 (2 ** (bits - 2) + 1, top)):
        assert _c_divide(n, d, bits) == n // d, (n, d)


@settings(max_examples=400, deadline=None)
@given(bits=st.sampled_from([32, 64]), data=st.data())
def test_divider_property(bits, data):
    """Over the whole range of each index type: n // d and n % d, from
    the divider's words, in the Python model and in the header's C."""
    top = 2 ** (bits - 1) - 1
    d = data.draw(st.one_of(st.integers(1, top), st.sampled_from(
        _EDGES[bits])), label="d")
    n = data.draw(st.one_of(st.integers(0, top), st.sampled_from(
        [0, top, d - 1, d, min(top, d + 1)])), label="n")
    m, s = map_kernel.magic(d, bits)
    q = map_kernel.magic_div(n, m, s, bits)
    assert (q, n - q * d) == divmod(n, d)
    assert _c_divide(n, d, bits) == n // d


# ------------- bf.map's remaining forms: the generated bodies on the host

def _eager_host(func, data, axes, shape, extra_code=None):
    """The eager call's generated program, host-compiled, against the
    plain engine on the same tensors -> (host outputs, plain outputs,
    program, launches)."""
    from bifrost_tpu_torch.ops.map import map as eager_map
    prog, ins, outs = eager_program(func, data, axes, shape, extra_code)
    before = map_kernel.map_apply_host.launches
    host, _ = map_kernel.map_apply_host(
        prog, ins, shape, [data[k] for k in prog.scalar_names])
    launches = map_kernel.map_apply_host.launches - before
    config.set("map_method", "plain")
    plain = eager_map(func, {k: (v.clone() if isinstance(v, torch.Tensor)
                                 else v) for k, v in data.items()},
                      axis_names=axes, shape=shape, extra_code=extra_code)
    if not isinstance(plain, dict):
        plain = {outs[0]: plain}
    return dict(zip(outs, host)), plain, prog, launches


@pytest.mark.parametrize("func,want", SCATTER_TABLE)
def test_scatter_table_bodies_bitwise(func, want):
    """The scatter's JAX semantics in the generated body (wrapdrop and
    the owner rule, two launches), bitwise the plain engine and the
    table."""
    data = {"a": torch.arange(5, dtype=torch.float32) + 10,
            "c": torch.zeros(5)}
    host, plain, prog, n = _eager_host(func, data, ("i",), (5,))
    assert prog.scatters == {0: 1} and n == 2
    assert _bits(host["c"], plain["c"])
    assert host["c"].tolist() == want


@pytest.mark.parametrize("func,shape,scalars", EAGER_FORMS)
def test_eager_gather_and_scatter_bodies_bitwise(func, shape, scalars):
    """Every eager explicit-index and scatter program of the JAX parity
    tests: the generated body, host-compiled, bitwise the plain engine,
    every output; one launch, two where the program scatters but for the
    injective affine scatters of ONE_PASS (one pass over the target)."""
    data = eager_data()
    data.update(scalars)
    axes = ("i", "j")[:len(shape)]
    if func in READS_SCATTERED:
        # one program cannot read what it scattered: the eager call cuts
        # it in two (test_eager_split_at_a_scatter_read_bitwise)
        with pytest.raises(map_codegen.Refusal, match="scattered"):
            eager_program(func, data, axes, shape)
        return
    host, plain, prog, n = _eager_host(func, data, axes, shape)
    assert prog.form == "gather" and \
        n == (2 if prog.scatters and func not in ONE_PASS else 1)
    assert set(host) == set(plain)
    for k in host:
        assert _bits(host[k], plain[k]), k


def test_scatter_duplicates_take_the_last_source_position():
    """Many sources a target, in two axes, some dropped: the highest
    source position (row-major over the grid) of each target wins, on
    the host-compiled body as in the plain engine; a strided target is
    read through its strides, and the result is a copy (the target
    stays as it was)."""
    rng = np.random.default_rng(74)
    a = torch.from_numpy(rng.standard_normal((16, 12)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((12, 5)).astype(np.float32)).T
    keep = c.clone()
    func = "c(i % 3 - 1, j // 3 + i // 8) = a(i, j) * 2"
    host, plain, prog, n = _eager_host(func, {"a": a, "c": c}, ("i", "j"),
                                       (16, 12))
    assert n == 2 and _bits(host["c"], plain["c"])
    assert torch.equal(c, keep)
    # target (r, q) of source (i, j): the last (i, j) in row-major order
    want = keep.clone()
    for i in range(16):
        for j in range(12):
            r, q = i % 3 - 1, j // 3 + i // 8
            r = r + 5 if r < 0 else r
            if q < 12:
                want[r, q] = a[i, j] * 2
    assert _bits(host["c"], want)


@pytest.mark.parametrize("dtype", ["ci8", "ci4", "f32"])
@pytest.mark.parametrize("func,form", STREAM_FORMS)
def test_forward_and_unbounded_bodies_bitwise(func, form, dtype):
    """The forward and unbounded streaming forms on the element path
    (raw ci8 and ci4 read in the kernel, a logical f32 stream; a temp
    read at other frames recomputed there), host-compiled, bitwise the
    plain engine on the gulp alone."""
    rng = np.random.default_rng(75)
    shape = (11, 3, 2, 2)
    if dtype == "ci8":
        x = torch.from_numpy(rng.integers(-128, 128, shape + (2,))
                             .astype(np.int8))
    elif dtype == "ci4":
        x = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
    else:
        x = _f32(shape, 76)
    (h, _), (p, _), prog = _run(func, x, dtype=None if dtype == "f32"
                                else dtype, axis_names=("t", "c", "s", "p"))
    assert prog.form == form and prog.vec == 1
    assert map_kernel.map_apply_host.last["path"] == "element"
    assert _bits(h, p)


EXACT_HELPERS = (
    "def sq(v):\n    return v * v\n"
    "def g(v, w):\n    \"a docstring\"\n    a = sq(v) * w\n"
    "    b = torch.minimum(a, v) - 1\n"
    "    return where(b > 0, b, -b) // 2 + np.pi * 0\n")


@pytest.mark.parametrize("func,dtype", [
    ("y = g(x, w)", torch.int32), ("y = g(x, w) + g(x, 3)", torch.float32),
    ("y(t,c) = g(x(t+1,c), w)", torch.float32),
])
def test_inlined_helper_bodies_bitwise(func, dtype):
    """extra_code helpers inlined (nested helpers, torch.minimum, where,
    np.pi, a docstring, a run-time scalar and a literal argument): the
    program's types and values bitwise the plain engine's evaluation of
    the helpers, in the elementwise, eager and forward forms."""
    axes = ("t", "c") if "(t" in func else None
    x = (_f32((7, 6), 77) * 4).round().to(dtype)
    (h, _), (p, _), prog = _run(func, x, axis_names=axes,
                                scalars={"w": 3}, extra_code=EXACT_HELPERS)
    assert h.dtype == p.dtype and _bits(h, p)
    if axes is None:
        host, plain, _, n = _eager_host(func, {"x": x, "w": 3}, None,
                                        tuple(x.shape), EXACT_HELPERS)
        assert n == 1 and _bits(host["y"], plain["y"])


def test_inlined_gauss_within_tolerance():
    """The JAX package's gauss helper written in torch, inlined: within
    TRANS_ULP ulps of the plain engine (the host's expf against
    PyTorch's vectorized exp; the operators before it bitwise)."""
    code = "def gauss(x, w):\n    return torch.exp(-(x*x)/(2*w*w))\n"
    (h, _), (p, _), _ = _run("y = gauss(x, w)", _f32((9, 8), 78),
                             scalars={"w": 0.5}, extra_code=code)
    assert h.dtype == p.dtype and _ulps(h, p) <= TRANS_ULP


@pytest.mark.parametrize("code,what", [
    (LOOP_HELPER, "a loop"),
    ("def h(v):\n    if v:\n        v = -v\n    return v\n", "a branch"),
    ("def h(v):\n    return v if v > 0 else -v\n", "a branch"),
    ("def h(v):\n    return v > 0 and v\n", "a branch"),
    ("def h(v):\n    return exp(v=v)\n", "keyword arguments"),
    ("S = 2\ndef h(v):\n    return v * S\n", "the global name 'S'"),
    ("def h(v):\n    return h(v)\n", "recursion"),
    ("def h(v):\n    return torch.clamp(v, 0)\n", "torch.clamp"),
    ("def h(v):\n    return np.exp(v)\n", "np.exp"),
    ("def h(v, w=2):\n    return v * w\n", "positional"),
    ("def h(v):\n    v += 1\n    return v\n", "augmented"),
    ("h = lambda v: v * 2\n", "not a def"),
])
def test_helpers_that_stay_refused_name_the_construct(code, what):
    """A helper that is not straight-line assignments and a return over
    the map namespace stays refused, naming the construct; 'auto' runs
    it on the plain engine."""
    op = Map("y = h(x)", extra_code=code)
    reason = op.form_refusal()
    assert reason is not None and what in reason, reason
    assert op._resolve(torch.float32, 2) == "plain"


@pytest.mark.parametrize("func,shape,scalars,launches", [
    ("c(i - k, j) = a(i, j); e(i, j) = c(i, j) * 2", (6, 5), {"k": 8}, 3),
    ("c(2*i, j) = a(i, j); d(j, i) = c(i, j) + a(i, j); "
     "e(i, j) = d(j, i) - c", (6, 5), {}, 4),
    ("c(i//2, j) = a(i, j); e(i, j) = c(i, j) + 1; a(i, j) = e * 2",
     (6, 5), {}, 3),
    ("c(2*i, j) = a(i, j); f = c(i, j) + 1", (6, 5), {}, 3),
    ("c(i//2, j) = a(i, j); t = c(i, j) * 2; u = t - a(i, j)",
     (6, 5), {}, 3),
])
def test_eager_split_at_a_scatter_read_bitwise(func, shape, scalars,
                                               launches, monkeypatch):
    """A statement reading what an earlier one scattered: the eager call
    on card tensors runs the program as the segments it cuts, each
    segment's results the next one's inputs, the generated bodies
    (host-compiled here, `map_apply` for the card's) bitwise the plain
    engine and the JAX call, every output, with the launches each
    segment takes (a transposing scatter alone in its segment one, the
    other scatters two); a segment whose statements are not indexed stays
    the explicit form over `shape`."""
    import sys
    from bifrost_tpu_torch.ops.map import map as eager_map
    mod = sys.modules["bifrost_tpu_torch.ops.map"]
    monkeypatch.setattr(mod, "map_apply", map_kernel.map_apply_host)
    data = eager_data()
    data.update(scalars)
    cm = mod._compile_map(func, tuple(sorted(data)), ("i", "j"))
    before = map_kernel.map_apply_host.launches
    got = mod._eager_cuda(cm, dict(data), set(scalars), "cuda", shape)
    assert map_kernel.map_apply_host.launches - before == launches
    config.set("map_method", "plain")
    want = eager_map(func, {k: (v.clone() if isinstance(v, torch.Tensor)
                                else v) for k, v in data.items()},
                     axis_names=("i", "j"), shape=shape)
    assert set(want) <= set(got)
    for k in want:
        assert _bits(got[k], want[k]), k
    jwant = j_map(func, {k: (v.numpy() if isinstance(v, torch.Tensor)
                             else v) for k, v in data.items()},
                  axis_names=("i", "j"), shape=shape)
    assert set(jwant) == set(want)
    for k in jwant:
        assert _bits(got[k], torch.from_numpy(np.array(jwant[k]))), k


def test_eager_rescatter_after_a_split_is_refused(monkeypatch):
    """A later segment's scatter into an array an earlier segment wrote:
    the scatter would start from that result, not from the original
    target, so the eager call refuses it (plain under 'auto', an error
    under 'cuda')."""
    import sys
    mod = sys.modules["bifrost_tpu_torch.ops.map"]
    monkeypatch.setattr(mod, "map_apply", map_kernel.map_apply_host)
    func = "c(2*i, j) = a(i, j); e(i, j) = c(i, j); c(i + 1, j) = e(i, j)"
    data = eager_data()
    cm = mod._compile_map(func, tuple(sorted(data)), ("i", "j"))
    assert mod._eager_cuda(cm, dict(data), set(), "auto", (6, 5)) is None
    with pytest.raises(ValueError, match="original target"):
        mod._eager_cuda(cm, dict(data), set(), "cuda", (6, 5))
