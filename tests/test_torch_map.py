"""The port's bf.map (`ops.map.Map`, `ops.map.map`, `blocks.map_block` /
`MapBlock`, the `map` service stage) against the JAX package's
(bifrost_tpu/ops/map.py, bifrost_tpu/blocks/map.py) on the CPU, on the
same seeded numpy input.  Mirrors each of the 20 tests of
tests/test_map.py, plus the eager call's docstring forms.

The port runs its plain engine here (on a CPU tensor method 'cuda' is
the plain version too; kernel M1 itself is held against it by
tests/test_torch_map_codegen.py on the host and chip_smoke's [map] on
the card).

Parity tiers:
- integer-exact input (ci8 voltages, small integers): the port is
  bitwise the JAX package, fused and unfused, raw and logical;
- f32 input through exact operators (``*`` by a power of two, negation,
  comparison, ``abs``, ``sqrt``): bitwise;
- f32 input through rounded operators: within DEPTH_ULP x depth ulps of
  the JAX result, depth the number of rounded operators between input
  and output (XLA:CPU may contract ``s*x + 1`` into one FMA, the port
  rounds each operator; ``exp`` is XLA's against PyTorch's, each within
  a few ulps of the true value);
- fused against unfused, split gulps against one long gulp: bitwise.
"""

import os
import time

import numpy as np
import pytest
import torch

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import bifrost_tpu as jbf
from bifrost_tpu import blocks as jblocks
from bifrost_tpu import config as jconfig
from bifrost_tpu.blocks.testing import array_source as j_array_source
from bifrost_tpu.blocks.testing import gather_sink as j_gather_sink
from bifrost_tpu.ops.map import Map as JMap
from bifrost_tpu.ops.map import map as j_map
from bifrost_tpu.pipeline import Pipeline as JPipeline

import bifrost_tpu_torch as bt
from bifrost_tpu_torch import blocks, config, device
from bifrost_tpu_torch.blocks.testing import array_source, gather_sink
from bifrost_tpu_torch.ndarray import pair_to_structured
from bifrost_tpu_torch.ops.map import (Map, _compile_map, _FN_CACHE_CAPACITY,
                                       map as eager_map)
from bifrost_tpu_torch.pipeline import Pipeline
from torch_map_forms import (EAGER_FORMS, SCATTER_TABLE, STREAM_FORMS,
                             eager_data)

EPS = 2.0 ** -24
DEPTH_ULP = 4


@pytest.fixture(autouse=True)
def _reset_flags():
    yield
    for f in ("map_method", "pipeline_fuse"):
        config.reset(f)
        jconfig.reset(f)


@pytest.fixture
def on_cpu():
    """Bind this thread to the CPU (numpy operands of the eager call go
    to the thread's device, the card by default)."""
    device.set_device("cpu")
    yield
    device._tls.device = None


def _volt(ntime, nchan=4, nstand=3, npol=2, seed=0, lo=-8, hi=8):
    """ci8 voltages in the port's storage form (trailing (re, im))."""
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (ntime, nchan, nstand, npol, 2)) \
        .astype(np.int8)


def _cx(raw):
    return (raw[..., 0].astype(np.float32) + 1j * raw[..., 1]) \
        .astype(np.complex64)


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _close(port, ref, depth, scale=None):
    """Within DEPTH_ULP * depth ulps of each other (module docstring), an
    ulp of `scale`, the magnitude of the largest term rounded (default
    the larger result)."""
    port, ref = np.asarray(port), np.asarray(ref)
    if scale is None:
        scale = np.maximum(np.abs(port), np.abs(ref))
    tol = DEPTH_ULP * depth * EPS * scale
    return port.shape == ref.shape and bool(
        np.all(np.abs(port.astype(np.float64) - ref) <= tol))


HDR_LABELS = ["time", "freq", "station", "pol"]

STENCIL = "y(t,c,s,p) = x(t,c,s,p) - x(t-1,c,s,p)"
STENCIL_AXES = ("t", "c", "s", "p")


def _run_chain(data, dtype, fuse_on, build, gulp=8, report=None,
               header=None, scope_copy=True, rawstats=None, counts=None):
    """src -> copy('cuda') -> build(dev) under a fuse scope -> copy to
    the host -> gather, on the CPU.  scope_copy=False leaves the copy
    outside the fuse scope, so the chain heads at the first map stage
    (the raw-head ingest topology)."""
    from bifrost_tpu_torch.ops import map_kernel
    config.set("pipeline_fuse", fuse_on)
    try:
        chunks = []
        hdr = {"dtype": dtype, "labels": HDR_LABELS}
        hdr.update(header or {})
        with Pipeline(device="cpu") as pipe:
            src = array_source(np.asarray(data), gulp, header=hdr)
            if scope_copy:
                with bt.block_scope(fuse=True):
                    dev = blocks.copy(src, space="cuda")
                    x = build(dev)
            else:
                dev = blocks.copy(src, space="cuda")
                with bt.block_scope(fuse=True):
                    x = build(dev)
            back = blocks.copy(x, space="system")
            gather_sink(back, chunks)
            pipe.run()
            if report is not None:
                report.append(pipe.fusion_report())
            if rawstats is not None:
                for b in pipe.blocks:
                    if getattr(b, "_raw_reads", 0):
                        rawstats.append((b.name, b._raw_reads,
                                         b._raw_read_nbyte))
        return np.concatenate(chunks, axis=0) if chunks else None
    finally:
        config.reset("pipeline_fuse")


def _jrun_chain(data, dtype, fuse_on, build, gulp=8, header=None,
                scope_copy=True):
    """The same chain on the JAX package (tests/test_map.py:_run_chain)."""
    jconfig.set("pipeline_fuse", fuse_on)
    try:
        chunks = []
        hdr = {"dtype": dtype, "labels": HDR_LABELS}
        hdr.update(header or {})
        if dtype.startswith("ci"):
            data = pair_to_structured(data, dtype)
        with JPipeline() as pipe:
            src = j_array_source(np.asarray(data), gulp, header=hdr)
            if scope_copy:
                with jbf.block_scope(fuse=True):
                    dev = jblocks.copy(src, space="tpu")
                    x = build(dev)
            else:
                dev = jblocks.copy(src, space="tpu")
                with jbf.block_scope(fuse=True):
                    x = build(dev)
            back = jblocks.copy(x, space="system")
            j_gather_sink(back, chunks)
            pipe.run()
        return np.concatenate(chunks, axis=0) if chunks else None
    finally:
        jconfig.reset("pipeline_fuse")


# ------------------------------------------------ mini-language parity

def _f32(ntime=24, shape=(4, 3, 2), seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((ntime,) + shape).astype(np.float32)


@pytest.mark.parametrize("func,kwargs,jkwargs,ref,depth,scale", [
    # elementwise broadcast with an inlined scalar (2 rounded operators,
    # the larger term |s x| + 1)
    ("y = s*x + 1.0f", dict(scalars={"s": 2.5}), None,
     lambda x: (2.5 * x + 1.0).astype(np.float32), 2,
     lambda x: np.abs(2.5 * x) + 1),
    # multiple statements (x*x, p + p: 1 rounding, the add exact)
    ("p = x*x; y = p + p", {}, None,
     lambda x: (x * x + x * x).astype(np.float32), 1, None),
    # right-associative ternary -> where() (exact)
    ("y = x > 0 ? x : -x", {}, None, lambda x: np.abs(x), 0, None),
    # C-isms: casts, float suffixes, functions (sqrt rounded: XLA:CPU's
    # is not always the correctly rounded one)
    ("y = sqrt(fabs(x)) * 2.0f", {}, None,
     lambda x: (np.sqrt(np.abs(x)) * np.float32(2.0)).astype(np.float32), 1,
     None),
    # extra_code helper injection: a torch helper of the same meaning as
    # the JAX test's jnp one (exp, then an exact doubling)
    ("y = boost(x)", dict(extra_code="def boost(v):\n"
                          "    return torch.exp(v) * 2\n"),
     dict(extra_code="def boost(v):\n    return jnp.exp(v) * 2\n"),
     lambda x: (np.exp(x) * 2).astype(np.float32), 2, None),
])
def test_map_pipeline_parity_grid(func, kwargs, jkwargs, ref, depth, scale):
    """Mirrors test_map.py:99 (tolerance: bitwise where depth is 0, else
    DEPTH_ULP x depth ulps of the largest term against JAX; against numpy
    rtol 1e-6 as there)."""
    data = _f32()
    got = _run_chain(data, "f32", False,
                     lambda dev: blocks.map_block(dev, func, **kwargs))
    want = _jrun_chain(data, "f32", False,
                       lambda dev: jblocks.map_block(
                           dev, func, **(jkwargs or kwargs)))
    assert got is not None and got.dtype == want.dtype
    np.testing.assert_allclose(got, ref(data), rtol=1e-6, atol=1e-6)
    if depth == 0:
        assert _bits(got, want)
    else:
        assert _close(got, want, depth,
                      scale(data) if scale is not None else None)


def test_map_explicit_index_channel_gather_local_form():
    """Mirrors test_map.py:126: explicit indexing with channel-axis
    arithmetic (``x(t, nc-1-c)``) is time-LOCAL: it fuses, reverses the
    channel axis, and is bitwise the JAX block."""
    data = _f32(shape=(5,))
    rep = []
    hdr = {"labels": ["time", "freq"]}

    def build(dev):
        m = blocks.map_block(dev, "y(t,c) = x(t, nc-1-c)",
                             axis_names=("t", "c"))
        assert m.op.fuse_form == "local"
        return m
    fused = _run_chain(data, "f32", True, build, report=rep, header=hdr)
    unfused = _run_chain(data, "f32", False, build, header=hdr)
    assert _bits(fused, unfused)
    assert _bits(fused, np.ascontiguousarray(data[:, ::-1]))
    want = _jrun_chain(data, "f32", False, lambda dev: jblocks.map_block(
        dev, "y(t,c) = x(t, nc-1-c)", axis_names=("t", "c")), header=hdr)
    assert _bits(fused, want)
    fused_names = [n for g in rep[0]["groups"] for n in g["constituents"]]
    assert any("MapBlock" in n for n in fused_names), rep[0]


def test_map_local_gather_clamps_out_of_range_indices():
    """jnp's gather semantics, which the port's engine keeps: a negative
    index wraps once, then it is clamped (``x(t, c-7)`` and
    ``x(t, c+3)`` on 5 channels), bitwise the JAX block."""
    data = _f32(shape=(5,), seed=3)
    hdr = {"labels": ["time", "freq"]}
    for func in ("y(t,c) = x(t, c-7) + x(t, c+3)",
                 "y(t,c) = x(t, 2*c - nc)"):
        got = _run_chain(data, "f32", False, lambda dev: blocks.map_block(
            dev, func, axis_names=("t", "c")), header=hdr)
        want = _jrun_chain(data, "f32", False, lambda dev: jblocks.map_block(
            dev, func, axis_names=("t", "c")), header=hdr)
        assert _bits(got, want), func


def test_map_multi_statement_complex_split():
    """Mirrors test_map.py:147: ``a = c.real; b = c.imag`` form (last
    statement streams out), bitwise the JAX block."""
    data = _volt(24)
    got = _run_chain(data, "ci8", False,
                     lambda dev: blocks.map_block(dev, "a = x.real; y = a"))
    np.testing.assert_array_equal(got, _cx(data).real)
    want = _jrun_chain(data, "ci8", False, lambda dev: jblocks.map_block(
        dev, "a = x.real; y = a"))
    assert _bits(got, want)
    got = _run_chain(data, "ci8", False,
                     lambda dev: blocks.map_block(dev, "y = x.imag*2"))
    assert _bits(got, 2 * _cx(data).imag)


# ------------------------------------------- fused == unfused, bitwise

@pytest.mark.parametrize("ntime,gulp", [
    (32, 8),     # aligned gulp grid
    (44, 8),     # partial final gulp (44 = 5*8 + 4)
])
def test_map_fused_chain_bitwise_ci8(ntime, gulp):
    """Mirrors test_map.py:163: fused == unfused == JAX, bitwise."""
    data = _volt(ntime)
    rep = []

    def build(dev):
        m = blocks.map_block(dev, "y = 2.0f*x*x.conj() + 1.0f")
        return blocks.detect(m, mode="scalar")
    fused = _run_chain(data, "ci8", True, build, gulp, report=rep)
    unfused = _run_chain(data, "ci8", False, build, gulp)
    assert fused is not None
    assert _bits(fused, unfused)
    want = _jrun_chain(data, "ci8", True, lambda dev: jblocks.detect(
        jblocks.map_block(dev, "y = 2.0f*x*x.conj() + 1.0f"),
        mode="scalar"), gulp)
    assert _bits(fused, want)
    fused_names = [n for g in rep[0]["groups"] for n in g["constituents"]]
    assert any("MapBlock" in n for n in fused_names), rep[0]
    for name, reason in rep[0]["refused"].items():
        if "MapBlock" in name:
            assert reason != "unplanned_op", rep[0]


@pytest.mark.parametrize("ntime,gulp", [(32, 8), (44, 8)])
def test_map_stencil_fused_bitwise_with_golden(ntime, gulp):
    """Mirrors test_map.py:189: the stencil fuses (stateful_chain), is
    bitwise its unfused twin, the exact golden and the JAX block."""
    data = _volt(ntime)
    rep = []

    def build(dev):
        return blocks.map_block(dev, STENCIL, axis_names=STENCIL_AXES)
    fused = _run_chain(data, "ci8", True, build, gulp, report=rep)
    unfused = _run_chain(data, "ci8", False, build, gulp)
    assert _bits(fused, unfused)
    rules = [g["rule"] for g in rep[0]["groups"]]
    assert "stateful_chain" in rules, rep[0]
    x = _cx(data)
    golden = (x - np.concatenate([np.zeros_like(x[:1]), x[:-1]]))
    assert _bits(fused, golden.astype(np.complex64))
    want = _jrun_chain(data, "ci8", True, lambda dev: jblocks.map_block(
        dev, STENCIL, axis_names=STENCIL_AXES), gulp)
    assert _bits(fused, want)


def test_map_stencil_split_gulps_match_one_long_gulp():
    """Mirrors test_map.py:207: gulp-4, gulp-8 (a partial tail), gulp-3
    (shorter than nothing but the carry) and one 44-frame gulp give the
    SAME bytes, fused and unfused; a 3-frame stencil's carry is longer
    than a 2-frame gulp."""
    data = _volt(44, seed=2)

    def build(dev):
        return blocks.map_block(dev, STENCIL, axis_names=STENCIL_AXES)
    runs = [
        _run_chain(data, "ci8", False, build, gulp=44),
        _run_chain(data, "ci8", False, build, gulp=4),
        _run_chain(data, "ci8", False, build, gulp=8),
        _run_chain(data, "ci8", True, build, gulp=4),
        _run_chain(data, "ci8", True, build, gulp=8),
    ]
    for other in runs[1:]:
        assert _bits(runs[0], other)
    deep = "y(t,c,s,p) = x(t,c,s,p) - x(t-3,c,s,p)"

    def build3(dev):
        return blocks.map_block(dev, deep, axis_names=STENCIL_AXES)
    long = _run_chain(data, "ci8", False, build3, gulp=44)
    for gulp, fuse in ((2, False), (2, True), (5, True)):
        assert _bits(long, _run_chain(data, "ci8", fuse, build3,
                                      gulp=gulp)), (gulp, fuse)
    x = _cx(data)
    assert _bits(long, x - np.concatenate([np.zeros_like(x[:3]), x[:-3]]))


def test_map_raw_ci8_head_fused_bitwise():
    """Mirrors test_map.py:227: a stencil map HEADING the fused group
    (copy outside the fuse scope) reads the ci8 ring in storage form,
    fused and unfused, the same bytes counted; bitwise with each other
    and the JAX chain, and within 1e-5 of the f64 golden."""
    data = _volt(44, seed=3)
    rep, fstats, ustats = [], [], []

    def build(dev):
        m = blocks.map_block(dev, STENCIL, axis_names=STENCIL_AXES)
        return blocks.detect(m, mode="scalar")
    fused = _run_chain(data, "ci8", True, build, report=rep,
                       scope_copy=False, rawstats=fstats)
    unfused = _run_chain(data, "ci8", False, build,
                         scope_copy=False, rawstats=ustats)
    assert _bits(fused, unfused)
    rules = [g["rule"] for g in rep[0]["groups"]]
    assert "stateful_chain" in rules, rep[0]
    assert fstats and fstats[0][1] > 0, fstats
    assert ustats and ustats[0][1] > 0, ustats
    assert fstats[0][2] == ustats[0][2] == data.nbytes
    want = _jrun_chain(data, "ci8", True, lambda dev: jblocks.detect(
        jblocks.map_block(dev, STENCIL, axis_names=STENCIL_AXES),
        mode="scalar"), scope_copy=False)
    assert _bits(fused, want)
    x = _cx(data).astype(np.complex128)
    d = x - np.concatenate([np.zeros_like(x[:1]), x[:-1]])
    np.testing.assert_allclose(fused, (d * d.conj()).real, rtol=1e-5)


# ---------------------------------------- supervised restart mid-chain

def test_map_stencil_restart_resets_carry_with_attribution():
    """Mirrors test_map.py:256: a fault armed on the CONSTITUENT map fires
    on the fused group; the supervised restart sheds the faulted gulp,
    RESETS the stencil carry (the output after the restart differences
    from zero history), and the restart event names the constituent."""
    from bifrost_tpu_torch.faultinject import FaultPlan
    from bifrost_tpu_torch.supervise import RestartPolicy, Supervisor

    data = _volt(40, seed=5)
    gulp = 8
    got, events = [], []
    with Pipeline(device="cpu") as pipe:
        src = array_source(data, gulp, header={
            "dtype": "ci8", "labels": HDR_LABELS})
        with bt.block_scope(fuse=True):
            dev = blocks.copy(src, space="cuda")
            m = blocks.map_block(dev, STENCIL, axis_names=STENCIL_AXES)
        back = blocks.copy(m, space="system")
        gather_sink(back, got)
        pipe._fuse_device_chains()     # fuse FIRST, then arm/attach
        sup = Supervisor(policy=RestartPolicy(max_restarts=3,
                                              backoff=0.01),
                         on_event=lambda ev: events.append(ev))
        plan = FaultPlan(seed=3)
        plan.raise_at("block.on_data", block=m.name, nth=1)
        plan.attach(pipe)
        try:
            pipe.run(supervise=sup)
        finally:
            plan.detach()
        fused = [b for b in pipe.blocks
                 if getattr(b, "constituent_names", None)]
    assert fused and any(m.name in b.constituent_names for b in fused)
    assert plan.fired(site="block.on_data")
    x = _cx(data)

    def diff0(seg):
        return seg - np.concatenate([np.zeros_like(seg[:1]), seg[:-1]])
    golden = np.concatenate([diff0(x[:8]), diff0(x[16:])], axis=0)
    out = np.concatenate(got, axis=0)
    assert _bits(out, golden.astype(np.complex64))
    restarts = [ev for ev in events if ev.kind == "restart"]
    assert restarts, [e.as_dict() for e in events]
    assert m.name in restarts[0].details.get("constituents", [])


# ------------------------------------------------- refusal invariants

@pytest.mark.parametrize("func,form", [
    ("y(t,c,s,p) = x(t+1,c,s,p) - x(t,c,s,p)", "forward"),
    ("y(t,c,s,p) = x(nt-1-t,c,s,p)", "unbounded"),
])
def test_map_refusal_reasons_forward_and_unbounded(func, form):
    """Mirrors test_map.py:306: forward/unbounded time indexing refuses
    as map_unbounded_index (now given by the port's planner) while the
    block still runs per-gulp with gulp-local semantics, bitwise the JAX
    block; the generator takes the form (M1's element path), so on a
    host ring 'auto' runs the plain engine with no refusal, and for a
    card it resolves to 'cuda'."""
    from bifrost_tpu_torch.fuse import REASONS
    assert "map_unbounded_index" in REASONS
    data = _volt(32, seed=4)
    rep, mbs = [], []

    def build(dev):
        mb = blocks.map_block(dev, func, axis_names=STENCIL_AXES)
        assert mb.op.fuse_form == form
        mbs.append(mb)
        return blocks.detect(mb, mode="scalar")
    fused = _run_chain(data, "ci8", True, build, report=rep)
    unfused = _run_chain(data, "ci8", False, build)
    reasons = {n: r for n, r in rep[0]["refused"].items()
               if "MapBlock" in n}
    assert list(reasons.values()) == ["map_unbounded_index"], rep[0]
    assert _bits(fused, unfused)
    want = _jrun_chain(data, "ci8", False, lambda dev: jblocks.detect(
        jblocks.map_block(dev, func, axis_names=STENCIL_AXES),
        mode="scalar"))
    assert _bits(fused, want)
    r = mbs[0].plan_report()
    assert r["method"] == "plain" and r["codegen_refusal"] is None
    op = Map(func, axis_names=STENCIL_AXES)
    assert op._resolve("ci8", 4) == "cuda" and op.codegen_refusal is None
    assert op.program("ci8", 4).form == form


def test_map_stencil_on_temp_refuses():
    """Mirrors test_map.py:333: history of a TEMP is never carried."""
    func = "a(t) = x(t)*2.0f; y(t) = a(t) - a(t-1)"
    op = Map(func, axis_names=("t",))
    assert op.fuse_form == JMap(func, axis_names=("t",)).fuse_form == \
        "unbounded"


# ------------------------------------------------ bounded-cache pins

def test_compile_map_cache_bounded():
    """Mirrors test_map.py:342."""
    assert _compile_map.cache_info().maxsize == 64


def test_compiled_map_fn_cache_bounded():
    """Mirrors test_map.py:347."""
    from bifrost_tpu_torch.ops.map import clear_map_cache
    clear_map_cache()
    cm = _compile_map("y = x + 0", ("x", "y"), None, None)
    for i in range(_FN_CACHE_CAPACITY + 6):
        shapes = {"x": (i + 1,), "y": (i + 1,)}
        cm.get_fn(shapes, {"x": None, "y": None}, frozenset(), None)
    assert len(cm._fn_cache) == _FN_CACHE_CAPACITY
    first_key = (tuple(sorted({"x": (1,), "y": (1,)}.items())), None)
    assert first_key not in cm._fn_cache


def test_map_cache_utilities_still_work(capsys, on_cpu):
    """Mirrors test_map.py:361."""
    from bifrost_tpu_torch.ops.map import clear_map_cache, list_map_cache
    clear_map_cache()
    out = eager_map("c = a + 1", {"c": np.zeros(4, np.float32),
                                  "a": np.ones(4, np.float32)})
    assert np.array_equal(out, np.full(4, 2, np.float32))
    list_map_cache()
    text = capsys.readouterr().out
    assert "Cache enabled: yes" in text
    assert "Cache entries: 1" in text
    clear_map_cache()
    assert _compile_map.cache_info().currsize == 0


# -------------------------------------------- plan schema and methods

def test_map_plan_report_schema():
    """Mirrors test_map.py:377: the JAX report's keys, the port's method
    names ('auto' is the plain engine for a CPU tensor, M1 for a card
    one), and the generator's verdict."""
    op = Map("y = x*x")
    op.execute(torch.arange(8, dtype=torch.float32))
    rep = op.plan_report()
    jop = JMap("y = x*x")
    jop.execute(np.arange(8, dtype=np.float32))
    assert set(jop.plan_report()) <= set(rep)
    assert rep["op"] == "map"
    assert rep["method"] == "plain"
    assert rep["codegen_refusal"] is None
    assert op._resolve(torch.float32, 1, device="cuda") == "cuda"
    assert op.codegen_refusal is None
    assert rep["origin"] == "host"
    assert isinstance(rep["plan_build_s"], float)
    cache = rep["cache"]
    assert set(cache) == {"entries", "capacity", "hits", "misses",
                          "evictions"}
    assert cache["capacity"] == 64
    assert rep["fuse_form"] == "elementwise"
    assert rep["stencil_noffset"] == 0


def test_map_bogus_method_raises_eagerly():
    """Mirrors test_map.py:393; the JAX methods are refused with their
    counterparts' names."""
    with pytest.raises(ValueError, match="map_method"):
        Map("y = x", method="warp")
    with pytest.raises(ValueError, match="'plain'"):
        Map("y = x", method="jnp")
    with pytest.raises(ValueError, match="'cuda'"):
        Map("y = x", method="pallas")


def test_map_method_flag_resolution_and_bad_flag():
    """Mirrors test_map.py:398: the flag resolves ('plain', 'cuda',
    'auto' -> 'cuda' or, for a refused program, 'plain'); a bad value
    raises at resolution; 'cuda' forced on a refused program raises with
    the reason.  The forward form and an inlinable helper resolve to
    'cuda'; a helper with a branch stays refused."""
    config.set("map_method", "plain")
    try:
        assert Map("y = x")._resolve() == "plain"
    finally:
        config.reset("map_method")
    assert Map("y = x")._resolve() == "cuda"
    fwd = "y(t) = x(t+1)"
    assert Map(fwd, axis_names=("t",))._resolve() == "cuda"
    assert Map(fwd, axis_names=("t",), method="cuda")._resolve() == "cuda"
    assert Map("y = f(x)", extra_code="def f(v):\n    return v\n",
               method="cuda")._resolve() == "cuda"
    branch = "def f(v):\n    if v:\n        v = -v\n    return v\n"
    assert Map("y = f(x)", extra_code=branch)._resolve() == "plain"
    with pytest.raises(ValueError, match="extra_code.*a branch"):
        Map("y = f(x)", extra_code=branch, method="cuda")._resolve()
    config.set("map_method", "warp9")
    try:
        op = Map("y = x")
        with pytest.raises(ValueError, match="map_method"):
            op._resolve()
    finally:
        config.reset("map_method")


def test_map_input_inference_errors():
    """Mirrors test_map.py:413, against the JAX Map's errors."""
    for cls in (Map, JMap):
        with pytest.raises(ValueError, match="in_name"):
            cls("y = a + b")
        with pytest.raises(ValueError, match="axis_names"):
            cls("y(i) = x(i)")
        with pytest.raises(ValueError, match="unbound"):
            cls("y = a + b", in_name="a")


# -------------------------------------------------- header bindings

def test_map_header_scalar_binding():
    """Mirrors test_map.py:425."""
    data = _f32(16)
    got = _run_chain(data, "f32", False,
                     lambda dev: blocks.map_block(
                         dev, "y = g*x", scalars={"g": "gain"}),
                     header={"gain": 3.0})
    np.testing.assert_allclose(got, 3.0 * data, rtol=1e-6)
    want = _jrun_chain(data, "f32", False,
                       lambda dev: jblocks.map_block(
                           dev, "y = g*x", scalars={"g": "gain"}),
                       header={"gain": 3.0})
    assert _bits(got, want)


def test_map_header_scalar_missing_key_raises():
    """Mirrors test_map.py:435."""
    from bifrost_tpu_torch.pipeline import PipelineInitError
    data = _f32(8)
    with pytest.raises(PipelineInitError, match="gain"):
        _run_chain(data, "f32", False,
                   lambda dev: blocks.map_block(
                       dev, "y = g*x", scalars={"g": "gain"}))


# ------------------------------------------------------ service stage

def test_service_map_stage_kind():
    """Mirrors test_map.py:446: a `map` stage runs in a Service, clean,
    every frame committed."""
    from bifrost_tpu_torch.service import (Service, ServiceSpec, StageSpec,
                                           EXIT_CLEAN, _KIND_TIERS)
    assert _KIND_TIERS["map"] == "compute"
    data = _f32(24, shape=(4,))
    spec = ServiceSpec([
        StageSpec("custom", name="source", params=dict(
            factory=lambda _up, **kw: array_source(
                data, 8, header={"dtype": "f32",
                                 "labels": ["time", "freq"]}))),
        StageSpec("map", params=dict(func="y = x*x + 1.0f")),
        # the detect stage is the service's ledger sink
        StageSpec("detect", params=dict(threshold=1e9)),
    ], heartbeat_interval_s=1.0, heartbeat_misses=30)
    svc = Service(spec, device="cpu")
    svc.start()
    deadline = time.monotonic() + 30.0
    while svc.running and time.monotonic() < deadline:
        time.sleep(0.05)
    report = svc.stop()
    assert report.exit_code == EXIT_CLEAN
    assert report.ledger["committed_frames"] == len(data)


# ------------------------------------- a numpy array bound as a scalar

def _jax_closure(func, scalars, x, axis_names=None, carry=None):
    """The JAX Map's own closure on numpy `x`: the function its
    `kernel()` / `kernel_carry()` cache (`Map._build`).  Its executors
    key their plan cache on the scalar items, which a numpy array cannot
    be (TypeError: unhashable), so the closure is the JAX Map's
    result."""
    import jax.numpy as jnp
    op = JMap(func, scalars=scalars, axis_names=axis_names)
    if carry is None:
        return _jnp(op._build(False, None, None)(jnp.asarray(x)))
    y, c2 = op._build(True, None, None)(jnp.asarray(x), jnp.asarray(carry),
                                        ())
    return _jnp(y), _jnp(c2)


@pytest.mark.parametrize("wdtype", [np.float32, np.int32])
def test_map_numpy_array_scalar_as_jax(wdtype, on_cpu):
    """A numpy array of one axis or more bound as a scalar is a
    constant array (a CPU tensor of its dtype): the eager call, a Map
    over a stream (elementwise and stencil, split gulps), and
    set_scalars after construction give the JAX Map's result on the
    same numpy input, bitwise (integer-exact values)."""
    rng = np.random.default_rng(47)
    x = rng.integers(-60, 60, (9, 5)).astype(np.float32)
    w = rng.integers(-6, 6, (5,)).astype(wdtype)
    got = eager_map("y = x * w + 1", {"x": x, "w": w})
    assert _bits(got.numpy(), _jnp(j_map("y = x * w + 1",
                                         {"x": x, "w": w})))
    op = Map("y = x * w + 1", scalars={"w": w})
    assert isinstance(op.scalars["w"], torch.Tensor) and \
        op.scalars["w"].dtype == torch.from_numpy(w).dtype
    want = _jax_closure("y = x * w + 1", {"w": w}, x)
    got = op.execute(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype and _bits(got, want)
    w2 = (w * 3).astype(wdtype)
    op.set_scalars({"w": w2})
    got = op.execute(torch.from_numpy(x)).numpy()
    assert _bits(got, _jax_closure("y = x * w + 1", {"w": w2}, x))
    func, axes = "y(t,c) = x(t,c) - x(t-2,c) * w", ("t", "c")
    st = Map(func, scalars={"w": w}, axis_names=axes)
    carry = st.carry_init((5,), torch.float32)
    jcarry = np.zeros((2, 5), np.float32)
    for a, b in ((0, 4), (4, 5), (5, 9)):
        y, carry = st.execute_carry(torch.from_numpy(x[a:b]), carry)
        jy, jcarry = _jax_closure(func, {"w": w}, x[a:b], axes, jcarry)
        assert _bits(y.numpy(), jy) and _bits(carry.numpy(), jcarry)


# ------------------------------------------------ the eager call's forms

def _jnp(a):
    return np.asarray(a)


def test_eager_map_broadcasting_and_scalars(on_cpu):
    """``c = a*s + b`` with b broadcast along the first axis and a Python
    scalar: bitwise the JAX call (f32 via exact operators here: s is a
    power of two), into the caller's output array."""
    rng = np.random.default_rng(7)
    a = rng.integers(-50, 50, (5, 4)).astype(np.float32)
    b = rng.integers(-50, 50, (4,)).astype(np.float32)
    c = np.zeros((5, 4), np.float32)
    got = eager_map("c = a*s + b", {"c": c, "a": a, "b": b, "s": 4.0})
    want = j_map("c = a*s + b", {"c": np.zeros((5, 4), np.float32),
                                 "a": a, "b": b, "s": 4.0})
    assert got is c
    assert _bits(c, _jnp(want))
    # multiple statements: every lhs comes back
    out = eager_map("d = a.real; e = a*2", {"a": a})
    jout = j_map("d = a.real; e = a*2", {"a": a})
    assert set(out) == {"d", "e"}
    for k in out:
        assert _bits(out[k].numpy(), _jnp(jout[k]))


def test_eager_map_explicit_index_forms(on_cpu):
    """The docstring's explicit forms: ``c(i,j) = a(j,i)`` with shape=,
    ``y(i) = x(ni-1-i)`` and ``c(i) = a(i, 1)``, bitwise the JAX call."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    got = eager_map("c(i,j) = a(j,i)", {"a": a}, axis_names=("i", "j"),
                    shape=(4, 3))
    want = j_map("c(i,j) = a(j,i)", {"a": a}, axis_names=("i", "j"),
                 shape=(4, 3))
    assert _bits(got.numpy(), _jnp(want))
    assert _bits(got.numpy(), a.T.copy())
    x = np.arange(7, dtype=np.int32) * 3
    got = eager_map("y(i) = x(ni-1-i)", {"x": x}, axis_names=("i",),
                    shape=(7,))
    want = j_map("y(i) = x(ni-1-i)", {"x": x}, axis_names=("i",),
                 shape=(7,))
    assert _bits(got.numpy(), _jnp(want))
    got = eager_map("c(i) = a(i, 1)", {"a": a}, axis_names=("i",),
                    shape=(3,))
    assert _bits(got.numpy(), a[:, 1].copy())


def test_eager_map_scatter_form(on_cpu):
    """A permuted output index (``c(j) = a(j)`` written at ``c(ni-1-j)``
    is a scatter into the output array), bitwise the JAX call."""
    a = np.arange(5, dtype=np.float32) + 10
    c = np.zeros(5, np.float32)
    got = eager_map("c(ni-1-i) = a(i)", {"a": a, "c": c},
                    axis_names=("i",), shape=(5,))
    want = j_map("c(ni-1-i) = a(i)", {"a": a, "c": np.zeros(5, np.float32)},
                 axis_names=("i",), shape=(5,))
    assert got is c
    assert _bits(c, _jnp(want))
    assert _bits(c, a[::-1].copy())


@pytest.mark.parametrize("func", [
    "y = (int)(x)", "y = (float)(n) + x", "y = (double)(x) * 2",
    "y = x / 3", "y = n // 3 + n % 3",
])
def test_eager_map_casts_and_integer_rules(func, on_cpu):
    """Casts (the translator's, as in the JAX package, take a
    parenthesized operand: ``(int)x`` does not translate, ROADMAP Queue
    C) and the promotion of weakly typed scalars: dtypes equal the JAX
    call's (``(double)`` is f32 in both: JAX runs without x64) and
    values bitwise (the operands are integers, ``/`` is correctly
    rounded in both)."""
    x = np.array([-7.5, -2.25, 0.0, 3.5, 9.0], np.float32)
    n = np.array([-7, -2, 0, 3, 9], np.int8)
    got = eager_map(func, {"x": x, "n": n})
    want = _jnp(j_map(func, {"x": x, "n": n}))
    got = got.numpy()
    if func == "y = x / 3":
        assert _bits(got, x / np.float32(3))
        assert _close(got, want, 1)
    else:
        assert _bits(got, want), (got, want)


def test_eager_map_cuda_method_on_cpu_is_the_plain_engine(on_cpu):
    """On CPU tensors 'cuda' (and 'auto') run the plain version, bitwise
    'plain'; the JAX methods are refused with their counterparts'
    names."""
    x = torch.arange(6, dtype=torch.float32)
    for method in ("auto", "cuda", "plain"):
        config.set("map_method", method)
        assert torch.equal(eager_map("y = x*x - 1", {"x": x}), x * x - 1)
    config.set("map_method", "jnp")
    with pytest.raises(ValueError, match="'plain'"):
        eager_map("y = x*x - 1", {"x": x})


# ------------- bf.map's remaining forms against the JAX package

@pytest.mark.parametrize("func,want", SCATTER_TABLE)
def test_eager_scatter_drops_and_wraps_as_jax(func, want, on_cpu):
    """The plain engine's scatter takes ``.at[idx].set``'s semantics: an
    index wraps once if negative, an update still out of bounds is
    dropped (no IndexError), and of repeated targets the highest source
    position wins; bitwise the JAX call."""
    a = np.arange(5, dtype=np.float32) + 10
    got = eager_map(func, {"a": a, "c": np.zeros(5, np.float32)},
                    axis_names=("i",), shape=(5,))
    jwant = _jnp(j_map(func, {"a": a, "c": np.zeros(5, np.float32)},
                       axis_names=("i",), shape=(5,)))
    assert _bits(got, jwant)
    assert _bits(got, np.array(want, np.float32))


@pytest.mark.parametrize("func,shape,scalars", EAGER_FORMS)
def test_eager_gather_and_scatter_forms_as_jax(func, shape, scalars,
                                               on_cpu):
    """The eager explicit-index (gather) and scatter forms, scalars bound
    by name among them, bitwise the JAX call on the same seeded input
    (integer-exact values), every output."""
    data = {k: v.numpy() for k, v in eager_data().items()}
    data.update(scalars)
    got = eager_map(func, {k: (v.copy() if isinstance(v, np.ndarray)
                               else v) for k, v in data.items()},
                    axis_names=("i", "j")[:len(shape)], shape=shape)
    want = j_map(func, dict(data), axis_names=("i", "j")[:len(shape)],
                 shape=shape)
    if not isinstance(got, dict):
        got, want = {"_": got}, {"_": want}
    assert set(got) == set(want)
    for k in got:
        assert _bits(np.asarray(got[k]), _jnp(want[k])), k


@pytest.mark.parametrize("dtype", ["ci8", "ci4"])
@pytest.mark.parametrize("func,form", STREAM_FORMS)
def test_map_forward_and_unbounded_raw_as_jax(func, form, dtype):
    """The forward and unbounded streaming forms (a temp's history, a
    stencil beside a whole-array read) on raw ci8 and ci4 gulps, each
    gulp alone: the port's Map bitwise the JAX Map on the same storage
    bytes."""
    rng = np.random.default_rng(72)
    shape = (9, 4, 3, 2)
    if dtype == "ci8":
        raw = rng.integers(-128, 128, shape + (2,)).astype(np.int8)
    else:
        raw = rng.integers(0, 256, shape).astype(np.uint8)
    op = Map(func, axis_names=STENCIL_AXES)
    assert op.fuse_form == form
    got = op.execute_raw(torch.from_numpy(raw), dtype)
    want = JMap(func, axis_names=STENCIL_AXES).execute_raw(raw, dtype)
    assert _bits(got.numpy(), _jnp(want))


# The JAX package's helpers (tests/test_ops.py:1336, tests/test_map.py:112)
# and the same written in torch.
HELPERS = {
    "gauss": ("y = gauss(x, w)",
              "def gauss(x, w):\n    return torch.exp(-(x*x)/(2*w*w))\n",
              "def gauss(x, w):\n    return jnp.exp(-(x*x)/(2*w*w))\n",
              np.float32, 0.5, 3),
    "boost": ("y = boost(x)", "def boost(v):\n    return torch.exp(v) * 2\n",
              "def boost(v):\n    return jnp.exp(v) * 2\n",
              np.float32, 0.5, 3),
    # No transcendental: the program's `/`, `//` and `**` inside a helper,
    # bitwise (int true division to float32, float floor division and
    # power, a weakly typed Python scalar).  XLA on the CPU contracts
    # a product and a sum into one fused multiply-add and divides by a
    # literal through its reciprocal, so neither is in the float body.
    "ipoly": ("y = h(x, w)",
              "def h(v, w):\n    return (v*w - v/3) // 2 + v**2\n", None,
              np.int32, 3, 0),
    "fpoly": ("y = h(x, w)",
              "def h(v, w):\n    d = v / w - v\n"
              "    return d // 2 - d**3 % w\n",
              None, np.float32, 0.5, 0),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_map_extra_code_helpers_as_jax(name, on_cpu):
    """extra_code helpers (inlined into M1 on a card) on the plain engine
    against the JAX package's jnp helpers, the eager call and a Map, the
    same dtype: bitwise where the helper has no transcendental, else
    within DEPTH_ULP x 3 ulps (exp is XLA's against PyTorch's, then two
    rounded operators)."""
    func, code, jcode, dtype, w, depth = HELPERS[name]
    x = _f32(ntime=12, shape=(5,), seed=73) * 40
    x = x.astype(dtype) if dtype != np.float32 else x / 40
    jcode = jcode or code

    def same(got, want):
        if not depth:
            return _bits(got, want)
        return got.dtype == want.dtype and _close(got, want, depth)
    got = eager_map(func, {"x": x, "w": w}, extra_code=code).numpy()
    want = _jnp(j_map(func, {"x": x, "w": w}, extra_code=jcode))
    assert same(got, want)
    op = Map(func, scalars={"w": w}, extra_code=code)
    assert op.form_refusal() is None and op._resolve(
        torch.from_numpy(x).dtype, 2) == "cuda"
    got = op.execute(torch.from_numpy(x)).numpy()
    want = _jnp(JMap(func, scalars={"w": w}, extra_code=jcode).execute(x))
    assert same(got, want)


def test_map_benchmark_check_runs_on_the_cpu():
    """benchmarks_torch/map.py's --check (the JAX benchmark's self-check
    on the port: goldens, fused parity, stencil carry, the refusal, the
    plan report) passes on the CPU."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks_torch", "map.py")
    spec = importlib.util.spec_from_file_location("map_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.run_check(torch.device("cpu")) == 0
