"""The port's ops runtime (bifrost_tpu_torch/ops/runtime.py) against the
JAX package's (bifrost_tpu/ops/runtime.py): the cases of
tests/test_ops_runtime.py whose surface the port has (the bounded LRU,
hit/miss accounting, method resolution, the report schema, the
per-sequence latch, the ops' plan reports, the staged unpack) and the
mirror of tests/test_fusion.py::test_fft_on_op_runtime, each run through
both packages where both have it."""

import numpy as np
import pytest
import torch

from bifrost_tpu.ops import runtime as jruntime

from bifrost_tpu_torch import config
from bifrost_tpu_torch.ops.runtime import (OpRuntime, staged_unpack,
                                           storage_nbyte_per_sample)

RUNTIMES = (("jax", jruntime.OpRuntime), ("torch", OpRuntime))


@pytest.fixture
def on_cpu():
    """Bind this thread to the CPU (numpy operands of an op go to the
    thread's device, the card by default)."""
    from bifrost_tpu_torch import device
    device.set_device("cpu")
    yield
    device._tls.device = None


@pytest.mark.parametrize("pkg,cls", RUNTIMES, ids=[p for p, _ in RUNTIMES])
def test_runtime_lru_eviction_bounds(pkg, cls):
    rt = cls("op", ("a", "b"), capacity=4)
    for i in range(10):
        rt.plan(("k", i), lambda i=i: f"plan{i}")
    assert len(rt) == 4
    assert rt.evictions == 6
    assert ("k", 0) not in rt and ("k", 5) not in rt
    assert all(("k", i) in rt for i in range(6, 10))
    assert list(rt.keys()) == [("k", i) for i in range(6, 10)]


@pytest.mark.parametrize("pkg,cls", RUNTIMES, ids=[p for p, _ in RUNTIMES])
def test_runtime_lru_hit_refreshes_recency(pkg, cls):
    rt = cls("op", ("a",), capacity=2)
    rt.plan(("k", 0), lambda: "p0")
    rt.plan(("k", 1), lambda: "p1")
    assert rt.plan(("k", 0), lambda: "NEW") == "p0"
    rt.plan(("k", 2), lambda: "p2")
    assert ("k", 0) in rt and ("k", 1) not in rt
    assert rt.get(("k", 0)) == "p0" and rt.get(("k", 1)) is None
    assert dict(rt.items()) == {("k", 0): "p0", ("k", 2): "p2"}


def test_runtime_hit_miss_accounting_and_build_stamp():
    rt = OpRuntime("op", ("a",))
    rt.plan("k", lambda: "p", method="a", origin="host")
    assert (rt.hits, rt.misses) == (0, 1)
    assert rt.last_plan_build_s >= 0.0
    assert rt.last_method == "a" and rt.last_origin == "host"
    rt.plan("k", lambda: "p")
    assert (rt.hits, rt.misses) == (1, 1)
    assert rt.last_plan_build_s == 0.0

    class SelfTimed:
        plan_build_s = 12.5
    rt.plan("k2", SelfTimed)              # a plan that times itself
    assert rt.last_plan_build_s == 12.5


@pytest.mark.parametrize("pkg,cls", RUNTIMES, ids=[p for p, _ in RUNTIMES])
def test_runtime_none_build_not_cached(pkg, cls):
    rt = cls("op", ("a",))
    assert rt.plan("k", lambda: None) is None
    assert "k" not in rt and rt.misses == 1
    assert rt.plan("k", lambda: "real") == "real"


def test_runtime_invalidate_keeps_counters():
    rt = OpRuntime("op", ("a",))
    rt.plan("k", lambda: "p")
    rt.plan("k", lambda: "p")
    rt.invalidate()
    assert len(rt) == 0 and rt == {}
    assert (rt.hits, rt.misses) == (1, 1)


def test_runtime_method_resolution():
    rt = OpRuntime("fdmt", ("cuda", "plain", "naive"),
                   config_flag="fdmt_method", default="cuda")
    assert rt.resolve_method(None) == "cuda"
    assert rt.resolve_method("auto") == "cuda"
    assert rt.resolve_method("plain") == "plain"
    with pytest.raises(ValueError, match="unknown method"):
        rt.resolve_method("bogus")
    try:
        config.set("fdmt_method", "naive")
        assert rt.resolve_method("auto") == "naive"
        assert rt.resolve_method("plain") == "plain"   # explicit wins
    finally:
        config.reset("fdmt_method")
    # A flag-less runtime with no default leaves 'auto' to its op, as the
    # JAX runtime does.
    free = OpRuntime("romein", ("cuda", "plain"), default=None)
    jfree = jruntime.OpRuntime("romein", ("pallas", "scatter"),
                               default=None)
    assert free.resolve_method("auto") == jfree.resolve_method("auto") \
        == "auto"


def test_runtime_report_schema_pinned():
    rt = OpRuntime("op", ("a",), capacity=8)
    rt.plan("k", lambda: "p", method="a", origin="device")
    jrt = jruntime.OpRuntime("op", ("a",), capacity=8)
    jrt.plan("k", lambda: "p", method="a", origin="device")
    rep, jrep = rt.report(), jrt.report()
    assert set(rep) == set(jrep) == {"op", "method", "origin",
                                     "plan_build_s", "cache"}
    assert set(rep["cache"]) == set(jrep["cache"])
    assert {k: rep[k] for k in ("op", "method", "origin")} == \
        {k: jrep[k] for k in ("op", "method", "origin")}
    assert rep["cache"] == jrep["cache"]


def test_runtime_per_sequence_latch():
    """hold_latch pins the op's config flag for a sequence: config.set on
    it raises, naming the owner."""
    rt = OpRuntime("beamform", ("cuda", "plain"),
                   config_flag="beamform_method")
    rt.hold_latch("bf_block")
    try:
        with pytest.raises(RuntimeError, match="bf_block"):
            config.set("beamform_method", "plain")
    finally:
        rt.release_latch("bf_block")
    config.set("beamform_method", "plain")   # released: accepted again
    config.reset("beamform_method")


def test_op_plan_reports_serve_uniform_core():
    """Every op's plan_report() embeds the runtime core beside its own
    keys, those of the JAX op's report."""
    from bifrost_tpu.ops import Fdmt as JFdmt
    from bifrost_tpu_torch.ops import Beamform, Fdmt, Fir, Romein
    core = {"op", "method", "origin", "plan_build_s", "cache"}
    rep = Fdmt().init(8, 16, f0=60e6, df=0.1e6).plan_report()
    jrep = JFdmt().init(8, 16, f0=60e6, df=0.1e6).plan_report()
    assert core <= set(rep) and rep["op"] == "fdmt"
    assert {"nchan", "nsteps", "nbuckets", "rowsteps_exact",
            "rowsteps_single", "rowsteps_bucketed",
            "padding_waste_pct_single", "padding_waste_pct_bucketed",
            "rowsteps_reduction_pct"} <= set(rep)
    for key in ("nchan", "nsteps", "rowsteps_exact"):
        assert rep[key] == jrep[key], key
    rep = Romein().plan_report()
    assert core <= set(rep) and rep["op"] == "romein"
    bf = Beamform()
    bf.init(np.ones((2, 4), np.complex64), device="cpu")
    rep = bf.plan_report()
    assert core <= set(rep) and rep["op"] == "beamform"
    assert {"nbeam", "nsp", "weights_origin"} <= set(rep)
    fir = Fir()
    fir.init(np.ones(3))
    rep = fir.plan_report()
    assert core <= set(rep) and rep["op"] == "fir"
    assert {"ntap", "decim"} <= set(rep)


def test_fdmt_runtime_cache_replays_same_tables():
    from bifrost_tpu_torch.ops import Fdmt
    plan = Fdmt().init(16, 32, f0=1200.0, df=0.1)
    dev = torch.device("cpu")
    first = plan._device_tables("plain", dev)
    hits = plan._runtime.hits
    assert plan._device_tables("plain", dev) is first
    assert plan._runtime.hits == hits + 1
    assert ("plain", str(dev)) in plan._runtime


def test_romein_last_stamps_are_the_runtime_s():
    from bifrost_tpu_torch.ops import Romein
    rom = Romein()
    rom.last_method = "plain"
    rom.last_origin = "host"
    rom.last_plan_build_s = 0.5
    assert rom._runtime.last_method == "plain"
    assert rom._runtime.last_origin == "host"
    assert rom.plan_report()["plan_build_s"] == 0.5


def test_staged_unpack_ci8_passthrough():
    raw = np.arange(24, dtype=np.int8).reshape(3, 4, 2)
    re, im = staged_unpack(torch.from_numpy(raw), "ci8")
    jre, jim = jruntime.staged_unpack(raw, "ci8")
    np.testing.assert_array_equal(re.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(im.numpy(), np.asarray(jim))
    np.testing.assert_array_equal(re.numpy(), raw[..., 0])


def test_staged_unpack_ci4_matches_unpack_reference():
    from bifrost_tpu.ndarray import to_jax
    from bifrost_tpu_torch.ops.unpack import unpack_logical
    rng = np.random.default_rng(8)
    re = rng.integers(-8, 8, (6, 5)).astype(np.int8)
    im = rng.integers(-8, 8, (6, 5)).astype(np.int8)
    packed = (((re & 0xF).astype(np.uint8) << 4) |
              (im & 0xF).astype(np.uint8))
    ure, uim = staged_unpack(torch.from_numpy(packed), "ci4")
    jre, jim = jruntime.staged_unpack(to_jax(packed), "ci4")
    np.testing.assert_array_equal(ure.numpy(), re)
    np.testing.assert_array_equal(uim.numpy(), im)
    np.testing.assert_array_equal(ure.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(uim.numpy(), np.asarray(jim))
    logical = unpack_logical(torch.from_numpy(packed), "ci4").numpy()
    np.testing.assert_array_equal(
        ure.numpy() + 1j * uim.numpy(), logical)


def test_staged_unpack_rejects_non_complex_int():
    with pytest.raises(ValueError, match="complex-integer"):
        staged_unpack(torch.zeros((2, 2)), "f32")


def test_storage_nbyte_per_sample():
    for name in ("ci4", "ci8", "ci16"):
        assert storage_nbyte_per_sample(name) == \
            jruntime.storage_nbyte_per_sample(name)
    assert storage_nbyte_per_sample("ci4") == 1
    assert storage_nbyte_per_sample("ci8") == 2
    with pytest.raises(ValueError):
        storage_nbyte_per_sample("f32")


def test_fft_on_op_runtime(on_cpu):
    """Fft on the runtime: fft_method resolution ('auto' accepted, the
    JAX engines refused), one cached executor hit on every execute after
    the first, the plan_report schema; the output is the JAX plan's
    within the FFT bound."""
    import bifrost_tpu as jbf
    from bifrost_tpu.ops.fft import Fft as JFft
    import bifrost_tpu_torch as bf
    from bifrost_tpu_torch.ops.fft import Fft, resolve_method
    assert resolve_method(None) == "torch"
    assert resolve_method("auto") == "torch"
    with pytest.raises(ValueError):
        resolve_method("bogus")
    with pytest.raises(ValueError, match="TPU engine"):
        resolve_method("xla")
    config.set("fft_method", "auto")
    try:
        assert resolve_method(None) == "torch"
    finally:
        config.reset("fft_method")
    x = np.random.default_rng(1).random((8, 16)).astype(np.float32) \
        .astype(np.complex64)
    plan = Fft()
    out = bf.zeros((8, 16), dtype="cf32")
    assert isinstance(out, bf.ndarray) and out.bf.space == "system"
    plan.init(x, out, axes=1)
    plan.execute(x, out)
    plan.execute(x, out)
    rep = plan.plan_report()
    assert rep["op"] == "fft" and rep["method"] == "torch"
    assert rep["kind"] == "c2c"
    assert rep["cache"]["hits"] >= 1 and rep["cache"]["misses"] == 1
    for key in ("origin", "plan_build_s"):
        assert key in rep
    jplan = JFft()
    jout = jbf.zeros((8, 16), dtype="cf32")
    jplan.init(x, jout, axes=1)
    jplan.execute(x, jout)
    jrep = jplan.plan_report()
    assert set(jrep) == set(rep)
    np.testing.assert_allclose(np.asarray(out), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
