"""The fusion compiler of the port (bifrost_tpu_torch/fuse.py) on the
CPU, beside the JAX package's (bifrost_tpu/fuse.py).

- The planner's contract, ported from tests/test_fusion.py: one group
  with its report, `pipeline_fuse` off keeps the unfused chain bitwise,
  the refusal reasons, `fuse.plan()` leaves the pipeline alone and
  `fuse.apply()` is idempotent, the exact emit schedule with an
  accumulate tail, the per-sequence latch, a stateful chain with an
  accumulate tail and the FDMT's warm-up schedule (both sweep signs).
  Each fused run is bitwise equal to its unfused twin, and where the
  JAX package builds the same chain, the port's `fusion_report()` names
  the same groups, constituents and ring hops as the JAX one.
- The four chains the reference fuses by default, each fused on both
  packages from the same seeded numpy input: the gpuspec chain
  (bench.py's run_framework shape), the DQ front end
  (benchmarks/dq_tpu.py: copy -> rfi_flag -> gaincal), the beam search
  and a small instrument (`lwa_instrument_spec` through the JAX
  `Service`).  Per chain: the reports equal; the port's fused outputs
  bitwise equal to its unfused ones, partial final gulps, mid-gulp
  integration boundaries and the FDMT warm-up included; the kernel
  wrappers called as often fused as unfused; and the port against the
  JAX chain within the stated tolerance:
  gpuspec within the testbench's FFT bound, 32 eps_f32 sqrt(nfft)
  max|want| (test_torch_gpuspec.py); the DQ front end within 2**-20 of
  its peak (K5b's complex product against XLA's, which contracts it
  into FMAs), the flagged cells (zeros) exactly; the beam search's
  dedispersed frames and the instrument's images within 1e-5 of their
  peak (test_torch_bengine_chain.py's and
  test_torch_instrument_chain.py's bounds); candidates and frame
  ledgers equal.
"""

import contextlib

import numpy as np
import pytest

import bifrost_tpu as jbf
from bifrost_tpu import blocks as jblocks
from bifrost_tpu import config as jconfig
from bifrost_tpu import views as jviews
from bifrost_tpu.blocks.testing import array_source as j_array_source
from bifrost_tpu.blocks.testing import callback_sink as j_callback_sink
from bifrost_tpu.pipeline import Pipeline as JaxPipeline

import bifrost_tpu_torch as pbf
from bifrost_tpu_torch import blocks as pblocks
from bifrost_tpu_torch import config as pconfig
from bifrost_tpu_torch import fuse
from bifrost_tpu_torch import views as pviews
from bifrost_tpu_torch.blocks.testing import array_source as p_array_source
from bifrost_tpu_torch.blocks.testing import callback_sink as p_callback_sink
from bifrost_tpu_torch.fuse import FusedChainBlock, StatefulChainBlock
from bifrost_tpu_torch.ndarray import pair_to_structured
from bifrost_tpu_torch.pipeline import Pipeline as PortPipeline

# name -> the modules that hold a reference to the kernel's wrapper
KERNELS = {
    "fir_mac": ("ops.fir_kernel", "ops.pfb_kernel"),
    "merge_step": ("ops.fdmt_kernel", "ops.fdmt"),
    "beamform_power": ("ops.beamform_kernel", "ops.beamform"),
    "masked_fill": ("ops.dq_kernel",),
    "gain_apply": ("ops.dq_kernel",),
    "grid_general": ("ops.romein_kernel", "ops.romein"),
    "grid_separable": ("ops.romein_kernel", "ops.romein"),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_fft_method_default():
    """The JAX references run at the JAX package's default `fft_method`:
    tests/test_fusion.py's latch test sets it from a sink callback, and
    under load a call that lands after the latch is released succeeds and
    stays set in that process ('matmul', 4e-3 off the 'xla' images)."""
    from bifrost_tpu import config as jconfig
    jconfig.reset("fft_method")


@pytest.fixture
def calls(monkeypatch):
    """Counts of the kernel wrappers' calls (on the CPU each wrapper
    runs its plain version; the count is the launches the card would
    make)."""
    import importlib
    counts = {k: 0 for k in KERNELS}
    wrapped = {}
    for name, mods in KERNELS.items():
        real = getattr(importlib.import_module(
            "bifrost_tpu_torch." + mods[0]), name)

        def counted(*a, _name=name, _real=real, **k):
            counts[_name] += 1
            return _real(*a, **k)
        wrapped[name] = counted
        for m in mods:
            mod = importlib.import_module("bifrost_tpu_torch." + m)
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, counted)
    return counts


@contextlib.contextmanager
def fuse_flag(config, on):
    config.set("pipeline_fuse", bool(on))
    try:
        yield
    finally:
        config.reset("pipeline_fuse")


def _groups(rep):
    return sorted((g["rule"], tuple(g["constituents"]),
                   g["ring_hops_eliminated"]) for g in rep["groups"])


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


# --------------------------------------------------- the gpuspec chain
def _voltages(nframe, nchan=4, ntime=32, npol=2, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 8, (nframe, nchan, ntime, npol, 2)) \
        .astype(np.int8)


def _fb(side, data, gulp=1, n_int=4, f_avg=8, scope=True, shift=False):
    """bench.py's run_framework chain on `side` ('jax' or 'port'): ci8
    [time, freq, fine_time, pol] -> copy -> transpose -> fft -> detect
    -> merge_axes -> reduce -> accumulate, in a fuse scope."""
    if side == "jax":
        bfm, blk, vw, src_fn, snk_fn = jbf, jblocks, jviews, \
            j_array_source, j_callback_sink
        pipe, space, data = JaxPipeline(), "tpu", pair_to_structured(data)
    else:
        bfm, blk, vw, src_fn, snk_fn = pbf, pblocks, pviews, \
            p_array_source, p_callback_sink
        pipe, space = PortPipeline(device="cpu"), "cuda"
    got = []
    with pipe:
        src = src_fn(data, gulp, header={
            "dtype": "ci8", "labels": ["time", "freq", "fine_time", "pol"]},
            name="src")
        with bfm.block_scope(fuse=True) if scope else bfm.block_scope():
            dev = blk.copy(src, space=space, name="h2d")
            t = blk.transpose(dev, ["time", "pol", "freq", "fine_time"],
                              name="tr")
            f = blk.fft(t, axes="fine_time", axis_labels="fine_freq",
                        apply_fftshift=shift, name="fft")
            d = blk.detect(f, mode="stokes", name="det")
            m = vw.merge_axes(d, "freq", "fine_freq", label="freq")
            r = blk.reduce(m, "freq", f_avg, name="red")
            a = blk.accumulate(r, n_int, name="acc")
        snk_fn(a, on_data=lambda arr: got.append(np.array(arr)),
               name="snk")
    return pipe, got


def _cat(got):
    return np.concatenate(got, axis=0)


def test_planner_builds_one_group_with_report():
    """The chain fuses into one FusedChainBlock; fusion_report() names
    the rule, the constituents and the ring hops, as the JAX one does."""
    pipe, got = _fb("port", _voltages(8))
    pipe.run()
    rep = pipe.fusion_report()
    assert len(rep["groups"]) == 1
    g = rep["groups"][0]
    assert g["rule"] == "device_chain"
    assert g["constituents"] == ["h2d", "tr", "fft", "det", "red", "acc"]
    assert g["ring_hops_eliminated"] == rep["ring_hops_eliminated"] == 5
    assert rep["flags"]["pipeline_fuse"] is True
    fused = [b for b in pipe.blocks if isinstance(b, FusedChainBlock)]
    assert len(fused) == 1 and fused[0].constituent_names == \
        g["constituents"]
    assert got
    jpipe, _ = _fb("jax", _voltages(8))
    with jpipe:
        assert _groups(jpipe.fusion_report()) == _groups(rep)


def test_pipeline_fuse_off_keeps_unfused_baseline_bitwise():
    data = _voltages(8)
    pipe_f, got_f = _fb("port", data)
    pipe_f.run()
    with fuse_flag(pconfig, False):
        pipe_u, got_u = _fb("port", data)
        pipe_u.run()
        rep = pipe_u.fusion_report()
    assert not rep["groups"]
    assert "pipeline_fuse_off" in rep["refused"].values()
    assert not any(isinstance(b, FusedChainBlock) for b in pipe_u.blocks)
    assert _bits(_cat(got_f), _cat(got_u))


class _OverlappedBlock(pbf.TransformBlock):
    """Declares input overlap without the fused-carry protocol."""

    def on_sequence(self, iseq):
        return dict(iseq.header)

    def define_input_overlap_nframe(self, iseqs):
        return 2

    def on_data(self, ispan, ospan):
        ospan.data.copy_(ispan.data[2:])
        return ospan.nframe

    def device_kernel(self):
        return lambda x: x


def _refusal_pipeline(case):
    """-> (pipeline, the block whose reason is checked)."""
    x = np.random.default_rng(0).random((8, 4)).astype(np.float32)
    pipe = PortPipeline(device="cpu")
    with pipe:
        src = p_array_source(x, 4)
        if case == "no_fuse_scope":
            b = last = pblocks.transpose(pblocks.copy(src, space="cuda"),
                                         [0, 1])
        elif case == "host_resident":
            with pbf.block_scope(fuse=True):
                b = pblocks.transpose(src, [0, 1])
                last = pblocks.fftshift(b, axes=1)
        elif case == "singleton":
            dev = pblocks.copy(src, space="cuda")
            with pbf.block_scope(fuse=True):
                b = last = pblocks.transpose(dev, [0, 1])
        elif case == "multi_reader":
            dev = pblocks.copy(src, space="cuda")
            with pbf.block_scope(fuse=True):
                b = pblocks.transpose(dev, [0, 1])
                last = pblocks.fftshift(b, axes=1)
            p_callback_sink(b, on_data=lambda a: None)
        elif case == "cross_gulp_state":
            dev = pblocks.copy(src, space="cuda")
            with pbf.block_scope(fuse=True):
                b = _OverlappedBlock(dev)
                last = pblocks.transpose(b, [0, 1])
        elif case == "unplanned_op":
            vis = np.ones((2, 1, 4), np.complex64)
            pos = np.zeros((2, 4), np.int32)
            s = p_array_source(vis, 1, header={
                "labels": ["time", "chan", "vis"]})
            dev = pblocks.copy(s, space="cuda")
            with pbf.block_scope(fuse=True):
                t = pblocks.transpose(dev, ["chan", "vis", "time"])
                b = last = pblocks.romein(t, 8, np.ones((3, 3),
                                                        np.complex64),
                                          positions=pos)
        p_callback_sink(last, on_data=lambda a: None)
    return pipe, b


@pytest.mark.parametrize("case", ["no_fuse_scope", "host_resident",
                                  "singleton", "multi_reader",
                                  "cross_gulp_state", "unplanned_op"])
def test_refusal_reasons_reported(case):
    """Blocks the planner does not fuse carry their reason; every
    reported reason is a documented one."""
    pipe, b = _refusal_pipeline(case)
    rep = pipe.fusion_report()
    assert rep["refused"][b.name] == case, rep
    assert not any(b.name in g["constituents"] for g in rep["groups"])
    for reason in rep["refused"].values():
        assert reason in fuse.REASONS
    pipe.run()


def test_plan_does_not_mutate_pipeline():
    pipe, got = _fb("port", _voltages(4))
    names = [b.name for b in pipe.blocks]
    fplan = fuse.plan(pipe)
    assert [b.name for b in pipe.blocks] == names
    assert len(fplan.groups) == 1
    plan1 = fuse.apply(pipe)
    after = list(pipe.blocks)
    plan2 = fuse.apply(pipe)                  # idempotent re-apply
    assert pipe.blocks == after
    assert _groups(plan1.report()) == _groups(plan2.report()) == \
        _groups(fplan.report())
    pipe.run()
    assert got


@pytest.mark.parametrize("nframe", [12, 14])
def test_fused_chain_exact_emit_schedule(nframe):
    """Gulps of 4 chain frames at nacc 3 emit 1, 1, 2 (the third gulp
    completes two integrations), and a partial final gulp of 2 frames
    none; the loop's exactness check holds and the output is the
    unfused chain's, bitwise."""
    data = _voltages(nframe)
    pipe, got = _fb("port", data, gulp=4, n_int=3)
    pipe.run()
    g = [b for b in pipe.blocks if isinstance(b, FusedChainBlock)][0]
    assert [g.output_nframes_for_gulp(r, 4) for r in (0, 4, 8)] == \
        [[1], [1], [2]]
    assert g.output_nframes_for_gulp(12, 2) == [0]
    assert sum(len(c) for c in got) == 4
    with fuse_flag(pconfig, False):
        pipe_u, got_u = _fb("port", data, gulp=4, n_int=3)
        pipe_u.run()
    assert _bits(_cat(got), _cat(got_u))


def test_pipeline_fuse_latched_per_sequence():
    """config.set('pipeline_fuse') mid-sequence is refused naming the
    group; more gulps than the rings hold keep the group in its
    sequence while the sink pokes the flag."""
    errs = []

    def poke(arr):
        try:
            pconfig.set("pipeline_fuse", False)
        except RuntimeError as e:
            errs.append(str(e))

    try:
        with PortPipeline(device="cpu") as pipe:
            src = p_array_source(_voltages(64), 1, header={
                "dtype": "ci8",
                "labels": ["time", "freq", "fine_time", "pol"]})
            with pbf.block_scope(fuse=True):
                dev = pblocks.copy(src, space="cuda")
                t = pblocks.transpose(dev, ["time", "pol", "freq",
                                            "fine_time"])
                d = pblocks.detect(t, mode="stokes")
            p_callback_sink(d, on_data=poke)
            pipe.run()
    finally:
        pconfig.reset("pipeline_fuse")
    assert errs and "pipeline_fuse" in errs[0] and "Fused_" in errs[0]
    pconfig.set("pipeline_fuse", True)       # released at sequence end
    pconfig.reset("pipeline_fuse")


@pytest.mark.parametrize("fused_async", [True, False])
def test_gpuspec_chain_fused_vs_unfused_and_jax(fused_async, monkeypatch):
    """The gpuspec chain with fftshift: fused bitwise equal to unfused
    with the worker on or off (gulps of 2 frames at nacc 3: a gulp with
    an integration boundary inside runs on the block thread, the others
    on the worker); within the FFT bound of the JAX fused chain."""
    from bifrost_tpu_torch import pipeline as ppipeline
    data = _voltages(24, nchan=4, ntime=64)
    submitted = []
    real_submit = ppipeline._GulpDispatcher.submit

    def submit(self, fn, abort=None):
        submitted.append(fn)
        return real_submit(self, fn, abort)

    monkeypatch.setattr(ppipeline._GulpDispatcher, "submit", submit)
    pconfig.set("fused_async", fused_async)
    try:
        pipe, got = _fb("port", data, gulp=2, n_int=3, shift=True)
        pipe.run()
    finally:
        pconfig.reset("fused_async")
    # phases 0, 2, 1, 0, ... a gulp: two gulps in three on the worker
    assert len(submitted) == (8 if fused_async else 0)
    with fuse_flag(pconfig, False):
        pipe_u, got_u = _fb("port", data, gulp=2, n_int=3, shift=True)
        pipe_u.run()
    assert _bits(_cat(got), _cat(got_u))
    jpipe, jgot = _fb("jax", data, gulp=2, n_int=3, shift=True)
    with jpipe:
        jpipe.run()
    assert _groups(jpipe.fusion_report()) == _groups(pipe.fusion_report())
    a, b = _cat(got).astype(np.float64), _cat(jgot).astype(np.float64)
    nfft = 64 * 8
    assert a.shape == b.shape == (8, 4, 4 * 64 // 8)
    assert np.abs(a - b).max() <= \
        32 * np.finfo(np.float32).eps * np.sqrt(nfft) * np.abs(b).max()


def test_stateful_chain_with_accumulate_tail_bitwise(calls):
    """PFB -> detect -> accumulate: the PFB's history and the carried
    integration thread through the group, mid-gulp integration
    boundaries included; bitwise against the unfused chain, the same
    kernel calls, the JAX report's groups."""
    rng = np.random.default_rng(12)
    raw = rng.integers(-8, 8, (48, 2, 2, 2)).astype(np.int8)

    def run(side, fuse_on):
        cfg = jconfig if side == "jax" else pconfig
        got = []
        with fuse_flag(cfg, fuse_on):
            if side == "jax":
                pipe, space, data, bfm, blk, s_fn, k_fn = \
                    JaxPipeline(), "tpu", pair_to_structured(raw), jbf, \
                    jblocks, j_array_source, j_callback_sink
                kw = {"method": "jnp"}
            else:
                pipe, space, data, bfm, blk, s_fn, k_fn = \
                    PortPipeline(device="cpu"), "cuda", raw, pbf, \
                    pblocks, p_array_source, p_callback_sink
                kw = {}
            with pipe:
                src = s_fn(data, 8, header={
                    "dtype": "ci8", "labels": ["time", "station", "pol"]})
                with bfm.block_scope(fuse=True):
                    dev = blk.copy(src, space=space, name="h2d")
                    p = blk.pfb(dev, 4, ntap=3, name="pfb", **kw)
                    d = blk.detect(p, mode="stokes", name="det")
                    a = blk.accumulate(d, 3, name="acc")   # nacc 3, gulp 2
                k_fn(a, on_data=lambda arr: got.append(np.array(arr)))
                pipe.run()
                rep = pipe.fusion_report()
        return _cat(got), rep

    fused, rep = run("port", True)
    n_fused = dict(calls)
    unfused, _ = run("port", False)
    assert {k: v - n_fused[k] for k, v in calls.items()} == n_fused
    assert n_fused["fir_mac"] == 48 // 8
    assert rep["groups"][0]["rule"] == "stateful_chain"
    assert rep["groups"][0]["constituents"] == ["h2d", "pfb", "det", "acc"]
    assert _bits(fused, unfused)
    _, jrep = run("jax", True)
    assert _groups(jrep) == _groups(rep)


class _FreqTimeSource(pbf.SourceBlock):
    """A (freq, time) f32 stream, time the frame axis (last)."""

    def __init__(self, data, gulp_nframe, **kwargs):
        super().__init__(["ft"], gulp_nframe, **kwargs)
        self.arr = data
        self._cursor = 0

    def create_reader(self, name):
        @contextlib.contextmanager
        def r():
            self._cursor = 0
            yield self
        return r()

    def on_sequence(self, reader, name):
        return [{"name": "ft", "time_tag": 0, "_tensor": {
            "dtype": "f32", "shape": [self.arr.shape[0], -1],
            "labels": ["freq", "time"],
            "scales": [[100.0, 1.0], [0, 1e-3]],
            "units": ["MHz", "s"]}}]

    def on_data(self, reader, ospans):
        ospan = ospans[0]
        n = min(ospan.nframe, self.arr.shape[1] - self._cursor)
        if n > 0:
            ospan.data[:, :n].copy_(torch_from(
                self.arr[:, self._cursor:self._cursor + n]))
        self._cursor += n
        return [n]


def torch_from(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("negative", [False, True])
def test_fdmt_stateful_chain_warmup_schedule(negative, calls):
    """copy -> fdmt: the first gulp emits gulp - max_delay frames, the
    later ones whole gulps; fused == unfused bitwise with as many FDMT
    merge steps, for either sweep sign."""
    x = np.random.default_rng(15).standard_normal((4, 32)) \
        .astype(np.float32)

    def run(fuse_on):
        got = []
        with fuse_flag(pconfig, fuse_on):
            with PortPipeline(device="cpu") as pipe:
                src = _FreqTimeSource(x, 8)
                with pbf.block_scope(fuse=True):
                    dev = pblocks.copy(src, space="cuda")
                    f = pblocks.fdmt(dev, max_delay=3,
                                     negative_delays=negative)
                p_callback_sink(f, on_data=lambda a: got.append(
                    np.array(a)))
                pipe.run()
                groups = [b for b in pipe.blocks
                          if isinstance(b, StatefulChainBlock)]
        return np.concatenate(got, axis=-1), groups

    fused, groups = run(True)
    n_fused = calls["merge_step"]
    unfused, _ = run(False)
    assert calls["merge_step"] == 2 * n_fused > 0
    g = groups[0]
    assert g.output_nframes_for_gulp(0, 8) == [5]
    assert g.output_nframes_for_gulp(8, 8) == [8]
    assert g.output_nframes_for_gulp(16, 8) == [8]
    assert fused.shape == unfused.shape == (3, 32 - 3)
    assert _bits(fused, unfused)


# ---------------------------------------------- the DQ front end
def _dq_data(seed=21):
    """cf32 [time, freq, station] small integers, with a storm on two
    cells from frame 64 on."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-8, 9, (192, 8, 4)) +
         1j * rng.integers(-8, 9, (192, 8, 4))).astype(np.complex64)
    x[64:, 3, 1] *= 40
    x[96:, 5, 2] = 200
    return x


def _dq_gains():
    rng = np.random.default_rng(22)
    return (0.5 + rng.random(4) + 0.3j * rng.standard_normal(4)) \
        .astype(np.complex64)


def _dq(side, data, gains, fuse_on=True, gulp=64):
    """benchmarks/dq_tpu.py's run_chain: copy -> rfi_flag -> gaincal in
    a fuse scope."""
    cfg = jconfig if side == "jax" else pconfig
    got = []
    with fuse_flag(cfg, fuse_on):
        if side == "jax":
            pipe, bfm, blk, s_fn, k_fn, space = JaxPipeline(), jbf, \
                jblocks, j_array_source, j_callback_sink, "tpu"
        else:
            pipe, bfm, blk, s_fn, k_fn, space = \
                PortPipeline(device="cpu"), pbf, pblocks, p_array_source, \
                p_callback_sink, "cuda"
        with pipe:
            src = s_fn(data, gulp, header={
                "dtype": "cf32", "labels": ["time", "freq", "station"]},
                name="src")
            with bfm.block_scope(fuse=True):
                dev = blk.copy(src, space=space, name="h2d")
                fl = blk.rfi_flag(dev, window=16, name="flag")
                cal = blk.gaincal(fl, gains, axis="station", name="cal")
            k_fn(cal, on_data=lambda a: got.append(np.array(a)))
            pipe.run()
            rep = pipe.fusion_report()
    return _cat(got), rep


def test_dq_front_end_fused_vs_unfused_and_jax(calls):
    data, g = _dq_data(), _dq_gains()
    fused, rep = _dq("port", data, g)
    n_fused = dict(calls)
    unfused, _ = _dq("port", data, g, fuse_on=False)
    assert {k: v - n_fused[k] for k, v in calls.items()} == n_fused
    assert n_fused["masked_fill"] == n_fused["gain_apply"] == 3
    assert _bits(fused, unfused)
    assert rep["groups"][0]["constituents"] == ["h2d", "flag", "cal"]
    jf, jrep = _dq("jax", data, g)
    assert _groups(jrep) == _groups(rep)
    assert fused.shape == jf.shape
    assert np.array_equal(fused == 0, jf == 0)
    assert (fused == 0).any()
    assert np.abs(fused - jf).max() <= 2.0 ** -20 * np.abs(jf).max()


# ---------------------------------------------- the beam search
B = dict(nstand=3, npol=2, nchan=8, ntap=4, n_int=4, nbeam=2, max_delay=4)
B_NINT = 10


def _bvolt(extra=0, seed=5):
    rng = np.random.default_rng(seed)
    n = B_NINT * B["n_int"] * B["nchan"] + extra
    return rng.integers(-8, 8, (n, B["nstand"], B["npol"], 2)) \
        .astype(np.int8)


def _port_beam(volt, fuse_on, gulp=None):
    from bifrost_tpu_torch.service import lwa_beam_search_pipeline
    g = {"dedispersed": []}
    pipe, det, ledger = lwa_beam_search_pipeline(
        volt, device="cpu", gather=g, fuse=fuse_on, gulp_nframe=gulp, **B)
    pipe.run()
    return g["dedispersed"], det, ledger, pipe.fusion_report()


def _jax_beam(volt):
    """The JAX B branch of `lwa_instrument_spec` in its fuse scopes."""
    from bifrost_tpu.blocks.testing import gather_sink
    from bifrost_tpu.service import CandidateDetectBlock, FrameLedger
    from bifrost_tpu_torch.service import default_beam_weights
    w = default_beam_weights(B["nbeam"], B["nstand"] * B["npol"])
    dd = []
    ledger = FrameLedger()
    with JaxPipeline() as pipe:
        src = j_array_source(pair_to_structured(volt),
                             B["n_int"] * B["nchan"], header={
            "dtype": "ci8", "labels": ["time", "station", "pol"],
            "scales": [[0.0, 1e-6], None, None], "units": ["s", None, None],
            "cfreq": 40.0, "cfreq_units": "MHz"}, name="ingest")
        with jbf.block_scope(fuse=True):
            dev = jblocks.copy(src, space="tpu", name="fengine_h2d")
            f = jblocks.pfb(dev, B["nchan"], ntap=B["ntap"],
                            name="fengine_pfb")
        with jbf.block_scope(fuse=True):
            b = jblocks.beamform(f, w, nframe_per_integration=B["n_int"],
                                 name="bengine")
        with jbf.block_scope(fuse=True):
            t = jblocks.transpose(b, ["beam", "freq", "time"],
                                  name="bdetect_t")
            d = jblocks.fdmt(t, max_delay=B["max_delay"],
                             name="bdetect_fdmt")
        det = CandidateDetectBlock(d, threshold=8.0, name="bdetect")
        det.ledger = ledger
        gather_sink(d, dd, name="gather_dedispersed")
        pipe.run()
        rep = pipe.fusion_report()
    return [np.asarray(a) for a in dd], det, ledger, rep


def test_beam_search_report_and_jax():
    volt = _bvolt()
    dd, det, ledger, rep = _port_beam(volt, True)
    jdd, jdet, jledger, jrep = _jax_beam(volt)
    # The PFB ring has one reader here (the instrument's has two), so
    # the whole chain is one group.
    assert _groups(rep) == _groups(jrep) == [
        ("stateful_chain", ("fengine_h2d", "fengine_pfb", "bengine",
                            "bdetect_t", "bdetect_fdmt"), 4)]
    a, b = np.concatenate(dd, -1), np.concatenate(jdd, -1)
    assert len(dd) == len(jdd) == B_NINT - B["max_delay"]
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert det.candidates == jdet.candidates
    s = ledger.summary()
    assert s == {k: jledger.summary()[k] for k in s}


@pytest.mark.parametrize("spectra,extra", [
    (4, 0),       # one integration a gulp
    (3, 0),       # integration boundaries inside gulps
    (2, 13),      # a partial final gulp, its spectra remainder dropped
])
def test_beam_search_fused_vs_unfused_bitwise(spectra, extra, calls):
    """Bitwise, with the same kernel calls: the FDMT's warm-up frames
    are dropped, not computed."""
    volt = _bvolt(extra)
    gulp = spectra * B["nchan"]
    with pytest.warns(UserWarning) if extra else contextlib.nullcontext():
        f_dd, f_det, f_led, rep = _port_beam(volt, True, gulp)
    n_fused = dict(calls)
    with pytest.warns(UserWarning) if extra else contextlib.nullcontext():
        u_dd, u_det, u_led, urep = _port_beam(volt, False, gulp)
    assert {k: v - n_fused[k] for k, v in calls.items()} == n_fused
    assert n_fused["merge_step"] > 0 and n_fused["beamform_power"] > 0
    assert len(rep["groups"]) == 1 and not urep["groups"]
    assert len(f_dd) == len(u_dd) == B_NINT - B["max_delay"]
    for x, y in zip(f_dd, u_dd):
        assert _bits(x, y)
    assert f_det.candidates == u_det.candidates
    assert f_led.summary() == u_led.summary()


def test_dq_beam_search_one_group_bitwise(calls):
    """The flagged, calibrated beam search (chip_smoke's [dq] chain) in
    one fuse scope: copy -> pfb -> rfi_flag -> gaincal -> beamform ->
    transpose -> fdmt is one stateful group, bitwise its unfused twin
    with the same kernel calls, and the JAX report's group."""
    from bifrost_tpu_torch.service import default_beam_weights
    volt = _bvolt()
    w = default_beam_weights(B["nbeam"], B["nstand"] * B["npol"])
    g = _dq_gains()[:B["nstand"]]

    def run(side, fuse_on):
        cfg = jconfig if side == "jax" else pconfig
        dd = []
        with fuse_flag(cfg, fuse_on):
            if side == "jax":
                from bifrost_tpu.blocks.testing import gather_sink
                pipe, bfm, blk, data, space = JaxPipeline(), jbf, jblocks, \
                    pair_to_structured(volt), "tpu"
                src_fn = j_array_source
            else:
                from bifrost_tpu_torch.blocks.testing import gather_sink
                pipe, bfm, blk, data, space = PortPipeline(device="cpu"), \
                    pbf, pblocks, volt, "cuda"
                src_fn = p_array_source
            with pipe:
                src = src_fn(data, B["n_int"] * B["nchan"], header={
                    "dtype": "ci8", "labels": ["time", "station", "pol"],
                    "scales": [[0.0, 1e-6], None, None],
                    "units": ["s", None, None], "cfreq": 40.0,
                    "cfreq_units": "MHz"}, name="ingest")
                with bfm.block_scope(fuse=True):
                    h = blk.copy(src, space=space, name="fengine_h2d")
                    f = blk.pfb(h, B["nchan"], ntap=B["ntap"],
                                name="fengine_pfb")
                    fl = blk.rfi_flag(f, window=B["n_int"], name="dq_flag")
                    c = blk.gaincal(fl, g, axis="station", name="dq_cal")
                    b = blk.beamform(c, w, B["n_int"], name="bengine")
                    t = blk.transpose(b, ["beam", "freq", "time"],
                                      name="bdetect_t")
                    d = blk.fdmt(t, max_delay=B["max_delay"],
                                 name="bdetect_fdmt")
                gather_sink(d, dd)
                pipe.run()
                rep = pipe.fusion_report()
        return [np.asarray(a) for a in dd], rep

    fused, rep = run("port", True)
    n_fused = dict(calls)
    unfused, _ = run("port", False)
    assert {k: v - n_fused[k] for k, v in calls.items()} == n_fused
    assert _groups(rep) == [("stateful_chain", (
        "fengine_h2d", "fengine_pfb", "dq_flag", "dq_cal", "bengine",
        "bdetect_t", "bdetect_fdmt"), 6)]
    assert len(fused) == len(unfused) == B_NINT - B["max_delay"]
    for x, y in zip(fused, unfused):
        assert _bits(x, y)
    jdd, jrep = run("jax", True)
    assert _groups(jrep) == _groups(rep)
    a, b = np.concatenate(fused, -1), np.concatenate(jdd, -1)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


# ---------------------------------------------- the instrument
GEOM = dict(nstand=3, npol=2, nchan=4, ntap=4, n_int=3, nbeam=2, ngrid=16,
            max_delay=4)
X_NINT = 8


def test_instrument_report_bitwise_and_jax(calls):
    """`lwa_instrument_pipeline(fuse=True)` against its unfused twin
    (bitwise, the same kernel calls) and against the JAX
    `lwa_instrument_spec(fuse=True)` run through `Service`: the same
    groups and hops, the images within 1e-5 of their peak, the same
    candidates and frame ledger."""
    from bifrost_tpu import service as jservice
    from bifrost_tpu_torch.service import lwa_instrument_pipeline
    rng = np.random.default_rng(7)
    volt = rng.integers(-8, 8, (X_NINT * GEOM["n_int"] * GEOM["nchan"],
                                GEOM["nstand"], GEOM["npol"], 2)) \
        .astype(np.int8)
    gains = (rng.integers(1, 4, (3, 2)) +
             1j * rng.integers(-2, 3, (3, 2))).astype(np.complex64)

    def port(fuse_on):
        images, cands = [], []
        pipe, det, ledger = lwa_instrument_pipeline(
            volt, device="cpu", gains=gains, fuse=fuse_on,
            on_image=lambda d: images.append(d.numpy().copy()),
            on_candidate=cands.append, **GEOM)
        pipe.run()
        return images, cands, ledger, pipe.fusion_report()

    images, cands, ledger, rep = port(True)
    n_fused = dict(calls)
    u_images, u_cands, u_ledger, _ = port(False)
    assert {k: v - n_fused[k] for k, v in calls.items()} == n_fused
    assert len(images) == len(u_images) == X_NINT
    for a, b in zip(images, u_images):
        assert _bits(a, b)
    assert cands == u_cands and ledger.summary() == u_ledger.summary()
    assert _groups(rep) == sorted([
        ("stateful_chain", ("fengine_h2d", "fengine_pfb"), 1),
        ("stateful_chain", ("xengine", "image_t"), 1),
        ("stateful_chain", ("bengine", "bdetect_t", "bdetect_fdmt"), 2)])
    assert rep["refused"]["image_grid"] == "no_fuse_scope"

    j_images, j_cands = [], []
    spec = jservice.lwa_instrument_spec(
        voltages=pair_to_structured(volt), fuse=True, pallas_interpret=True,
        gains=gains, on_image=lambda d: j_images.append(np.array(d)),
        on_candidate=j_cands.append, **GEOM)
    svc = jservice.Service(spec, name="instrument_fused_ref")
    svc.start()
    finished = svc.wait(timeout=300)
    svc.stop()
    assert finished and svc._run_error is None
    jrep = svc.pipeline.fusion_report()
    assert _groups(jrep) == _groups(rep)
    assert rep["ring_hops_eliminated"] == jrep["ring_hops_eliminated"] == 4
    assert len(j_images) == X_NINT
    for a, b in zip(images, j_images):
        a, b = a.reshape(b.shape), b
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert cands == j_cands
    s = ledger.summary()
    assert s == {k: svc.ledger.summary()[k] for k in s}


def test_raw_head_reads_ring_storage():
    """A group that starts at the PFB on a ci8 device ring reads it in
    storage form, as the unfused block does: the same count of raw reads
    and bytes (a partial final gulp's remainder not counted), bitwise
    the same spectra."""
    raw = np.random.default_rng(13).integers(-8, 8, (45, 2, 2, 2)) \
        .astype(np.int8)

    def run(fuse_on):
        got = []
        with fuse_flag(pconfig, fuse_on):
            with PortPipeline(device="cpu") as pipe:
                src = p_array_source(raw, 8, header={
                    "dtype": "ci8", "labels": ["time", "station", "pol"]})
                dev = pblocks.copy(src, space="cuda")
                with pbf.block_scope(fuse=True):
                    p = pblocks.pfb(dev, 4, ntap=3, name="pfb")
                    d = pblocks.detect(p, mode="stokes", name="det")
                p_callback_sink(d, on_data=lambda a: got.append(np.array(a)))
                with pytest.warns(UserWarning, match="trailing"):
                    pipe.run()
                blk = [b for b in pipe.blocks
                       if b.name in ("pfb", "Fused_pfb+det")][0]
        return _cat(got), blk

    fused, g = run(True)
    unfused, p = run(False)
    assert isinstance(g, StatefulChainBlock)
    assert _bits(fused, unfused)
    assert (g._raw_reads, g._raw_read_nbyte) == \
        (p._raw_reads, p._raw_read_nbyte) == (6, 44 * 2 * 2 * 2)
