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
  ``%``/``//``, gathers, stencils, integer-exact complex input: bitwise;
- transcendentals (exp, log, sin, ...; the host's libm against
  PyTorch's vectorized kernels): within TRANS_ULP ulps of the larger
  magnitude;
- complex products and quotients of arbitrary values: within CX_ULP
  ulps of the largest term.
"""

import numpy as np
import pytest
import torch

from bifrost_tpu.ops.map import Map as JMap

from bifrost_tpu_torch import config
from bifrost_tpu_torch.ops import map_codegen, map_kernel
from bifrost_tpu_torch.ops.map import Map

TRANS_ULP = 4
CX_ULP = 4


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
         carry=None):
    """The program of `func` on input `x` (storage form of DataType
    `dtype`, or a logical tensor): host-compiled body and plain engine
    -> (host outputs, plain outputs, program)."""
    op = Map(func, axis_names=axis_names, scalars=scalars)
    dkey = dtype if dtype is not None else x.dtype
    rank = x.dim() - (1 if dtype is not None and dtype.startswith("ci")
                      and dtype != "ci4" else 0)
    prog = op.program(dkey, rank, ocs)
    lshape = map_kernel.logical_shape(x, prog.inputs[0])
    out_shape = lshape if not op.explicit else \
        (lshape[0],) + (tuple(ocs) if ocs is not None else lshape[1:])
    scal = [op.scalars[n] for n in prog.scalar_names]
    if op.fuse_form == "stencil" and carry is None:
        carry = op.carry_init(lshape[1:], prog.inputs[0].dtype)
    host, hc = map_kernel.map_apply_host(prog, [x], out_shape, scal, carry)
    plain, pc = map_kernel.map_apply_plain(prog, [x], out_shape, scal,
                                           carry)
    return (host[0], hc), (plain[0], pc), prog


# ------------------------------------------------ forms and refusals

@pytest.mark.parametrize("func,axes,form,reason", [
    ("y = 2.0f*x*x.conj() + 1.0f", None, "elementwise", None),
    ("y(t,c) = x(t, nc-1-c)", ("t", "c"), "local", None),
    ("y(t,c) = x(t,c) - x(t-2,c)", ("t", "c"), "stencil", None),
    ("y(t,c) = x(t+1,c)", ("t", "c"), "forward", "forward"),
    ("y(t,c) = x(nt-1-t,c)", ("t", "c"), "unbounded", "unbounded"),
])
def test_forms_and_refusal_reasons(func, axes, form, reason):
    """The generator takes the elementwise, local and stencil streaming
    forms and refuses the forward and unbounded ones with their names
    (the JAX classifier gives the same forms); 'auto' then resolves to
    'plain' and 'cuda' raises with the reason."""
    op = Map(func, axis_names=axes)
    assert op.fuse_form == JMap(func, axis_names=axes).fuse_form == form
    if reason is None:
        assert op.form_refusal() is None
        assert op._resolve("f32", 2) == "cuda"
        assert op.plan_report()["codegen_refusal"] is None
        return
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
    ("y = sin(x)", "cf32", {}, "complex sin"),
    ("y = x > 0 && x < 1", "f32", {}, "chained comparison"),
    ("y = sqrt(x)", "cf32", {}, "complex sqrt"),
    ("y = x * 2", "f16", {}, "torch.float16"),
    ("y = x * 2", "ci2", {}, "packed complex"),
    ("y = 3.0", "f32", dict(in_name="x"), "does not depend on an array"),
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
    from bifrost_tpu_torch.ops.map import _compile_map
    cm = _compile_map("c(i,j) = a(j,i)", ("a", "c"), ("i", "j"))
    with pytest.raises(map_codegen.Refusal, match="explicit-index"):
        map_codegen.generate(
            cm.statements, "eager",
            [map_codegen.input_for_tensor("a", torch.float32, 2)],
            {}, frozenset({"a", "c"}), ["c"], out_rank=2)


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
