"""Live respec on the port (service.Service.respec, the pipeline's splice
seams) on the CPU.

- Under the synchronous loop and under the async gulp executor
  (`pipeline_async_depth` 2): a paced stage behind an unpaced source is
  replaced mid-stream; the ledger stays contiguous (lost == dup == 0,
  every frame committed once), the replacement resumes its
  predecessor's sequence at the predecessor's frame (the sync loop's
  next gulp, the executor's dispatch frontier after its drain), and the
  stream that reaches the sink is the source's, frame for frame: the
  read guarantee is held across the splice, so the writer, which the
  paced stage holds back, cannot reclaim the frames the replacement has
  yet to read.
- A build error (a map stage's kernel build included) rolls back to the
  old stage and re-raises; a wedged quiesce aborts; sources, capture stages, fused stages, renamed blocks
  and a changed output space are refused.
- A stencil map stage spliced mid-stream at a gulp fixed by a wedge is
  bitwise the JAX package's spliced output on the same numpy data (the
  replacement starts with a fresh carry in both).
- A fleet tenant's DeviceSinkBlock stages through the tenant's view of
  the fleet pool.
"""

import threading
import time

import numpy as np
import pytest

from bifrost_tpu_torch import config
from bifrost_tpu_torch.blocks import fftshift, transpose
from bifrost_tpu_torch.blocks.testing import array_source, gather_sink
from bifrost_tpu_torch.pipeline import TransformBlock, block_scope
from bifrost_tpu_torch.service import (CandidateDetectBlock, Service,
                                       ServiceSpec, StageSpec)

GULP = 16
NGULP = 64
DATA = (np.random.default_rng(11).integers(0, 100, (NGULP * GULP, 8))
        .astype(np.float32))


class Paced(TransformBlock):
    """Copy transform, `pace_s` a gulp; notes its first gulp's frame."""

    def __init__(self, iring, pace_s=0.01, **kwargs):
        super().__init__(iring, **kwargs)
        self.pace_s = pace_s
        self.first_frame = None

    def on_sequence(self, iseq):
        return dict(iseq.header)

    def on_data(self, ispan, ospan):
        if self.first_frame is None:
            self.first_frame = ispan.frame_offset
        time.sleep(self.pace_s)
        ospan.data[...] = ispan.data
        return ispan.nframe


def _work_stage(name="work", pace_s=0.01, block_name=None):
    return StageSpec("custom", name=name, params=dict(
        factory=lambda up, **k: Paced(up, pace_s=pace_s,
                                      name=block_name or name)))


def _spec(chunks, device_copy=False, data=DATA, pace_s=0.01):
    """source -> [copy('cuda')] -> work (paced) -> detect, with a gather
    beside the detector."""
    def detect(up, **k):
        gather_sink(up, chunks, name="gather")
        return CandidateDetectBlock(up, threshold=1e9, name="detect")

    stages = [StageSpec("custom", name="source", params=dict(
        factory=lambda _up, **k: array_source(data, GULP)))]
    if device_copy:
        stages.append(StageSpec("copy"))
    stages += [_work_stage(pace_s=pace_s),
               StageSpec("custom", name="detect", tier="detect",
                         params=dict(factory=detect))]
    return ServiceSpec(stages, heartbeat_interval_s=1.0,
                       heartbeat_misses=30, quiesce_timeout_s=5.0)


def _wait_committed(svc, nframe, timeout=30.0):
    deadline = time.monotonic() + timeout
    while svc.ledger.summary()["committed_frames"] < nframe:
        assert time.monotonic() < deadline, "stream did not advance"
        time.sleep(0.005)


def _finish(svc):
    assert svc.wait(timeout=60)
    return svc.stop()


@pytest.mark.parametrize("depth", [1, 2], ids=["sync", "async"])
def test_respec_mid_stream_keeps_the_stream_whole(depth):
    config.set("pipeline_async_depth", depth)
    try:
        chunks = []
        svc = Service(_spec(chunks, device_copy=depth > 1), name="rs",
                      device="cpu")
        svc.start()
        _wait_committed(svc, 8 * GULP)
        old = svc.blocks["work"]
        rec = svc.respec("work", _work_stage(pace_s=0.002))
        new = svc.blocks["work"]
        rep = _finish(svc)
    finally:
        config.reset("pipeline_async_depth")
    assert new is not old and new.name == old.name == "work"
    assert rec["outcome"] in ("drained", "interrupted")
    assert not rec["rolled_back"] and rec["downtime_s"] is not None
    assert old._exec_async_depth == new._exec_async_depth == \
        (depth if depth > 1 else 0)
    # The replacement resumed its predecessor's sequence where it
    # stopped, mid-stream.
    assert old._splice_mid_sequence
    assert new.first_frame == old._loop_frame > 0
    led = rep.ledger
    assert led["lost_frames"] == led["duplicated_frames"] == 0
    assert led["committed_frames"] == len(DATA)
    np.testing.assert_array_equal(np.concatenate(chunks), DATA)
    assert rep.exit_code == 0
    assert rep.counters["respecs"] == 1 and rep.counters["restarts"] == 0
    assert rep.availability["respecs"] == 1
    assert rep.availability["respec_downtime_s"] > 0
    assert svc.respecs == [rec]


def test_health_elastic_section_reports_the_respec():
    chunks = []
    svc = Service(_spec(chunks), name="rs_health", device="cpu")
    svc.start()
    assert svc.health()["elastic"] == {"respecs": 0,
                                       "respec_downtime_s": 0.0,
                                       "last_respec": None}
    _wait_committed(svc, 4 * GULP)
    rec = svc.respec("work", _work_stage(pace_s=0.002))
    el = svc.health()["elastic"]
    assert el["respecs"] == 1 and el["last_respec"] == rec
    assert el["respec_downtime_s"] == round(svc.respec_downtime_s, 6) > 0
    assert svc.supervisor.events_for("work", "respec")
    _finish(svc)


def test_respec_build_error_rolls_back_and_reraises():
    chunks = []
    svc = Service(_spec(chunks), name="rs_rollback", device="cpu")
    svc.start()
    _wait_committed(svc, 4 * GULP)

    def broken(up, **k):
        raise RuntimeError("replacement build failed")

    with pytest.raises(RuntimeError, match="replacement build failed"):
        svc.respec("work", StageSpec("custom", name="work",
                                     params=dict(factory=broken)))
    rec = svc.respecs[-1]
    assert rec["rolled_back"] and rec["outcome"] in ("drained",
                                                     "interrupted")
    assert svc.spec.stages[1].params["factory"] is not broken
    rep = _finish(svc)
    assert rep.ledger["lost_frames"] == rep.ledger["duplicated_frames"] == 0
    assert rep.ledger["committed_frames"] == len(DATA)
    np.testing.assert_array_equal(np.concatenate(chunks), DATA)


def test_respec_map_build_error_rolls_back(monkeypatch):
    """The replacement map stage's kernel build (M1 on the card) runs in
    the splice, for the open input sequence: a failed build raises in
    the respec, which rolls back to the old program; nothing falls back
    to another engine."""
    from bifrost_tpu_torch.ops.map import Map
    chunks = []
    prepare = Map.prepare

    def failing(self, *a, **k):
        if self.func_string == "y = x * 3":
            raise RuntimeError("nvcc failed for the generated map kernel")
        return prepare(self, *a, **k)

    stage = StageSpec("map", name="map", params=dict(func="y = x * 2"))
    spec = ServiceSpec([
        StageSpec("custom", name="source", params=dict(
            factory=lambda _up, **k: array_source(DATA, GULP))),
        _work_stage(),
        stage,
        StageSpec("custom", name="gather", params=dict(
            factory=lambda up, **k: gather_sink(up, chunks,
                                                name="gather"))),
    ], heartbeat_interval_s=1.0, heartbeat_misses=30)
    svc = Service(spec, name="rs_mapfail", device="cpu")
    monkeypatch.setattr(Map, "prepare", failing)
    svc.start()
    _wait_committed_chunks(chunks, 4)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        svc.respec("map", StageSpec("map", name="map",
                                    params=dict(func="y = x * 3")))
    assert svc.respecs[-1]["rolled_back"]
    assert svc.spec.stages[2] is stage
    assert svc.blocks["map"].op.func_string == "y = x * 2"
    assert svc.wait(timeout=60)
    svc.stop()
    np.testing.assert_array_equal(np.concatenate(chunks), DATA * 2)


def _wait_committed_chunks(chunks, n, timeout=30.0):
    deadline = time.monotonic() + timeout
    while len(chunks) < n:
        assert time.monotonic() < deadline, "stream did not advance"
        time.sleep(0.005)


def test_respec_wedged_quiesce_aborts():
    from bifrost_tpu_torch.faultinject import FaultPlan
    chunks = []
    svc = Service(_spec(chunks), name="rs_wedge", device="cpu")
    entered, release = threading.Event(), threading.Event()
    plan = FaultPlan(seed=3)
    plan.wedge_at("block.on_data", block="work", nth=3, release=release,
                  entered=entered, timeout=30.0, stamp_heartbeat=True)
    plan.attach(svc.pipeline)
    try:
        svc.start()
        assert entered.wait(15.0)
        with pytest.raises(RuntimeError, match="wedged"):
            svc.respec("work", _work_stage(pace_s=0.002), timeout=0.2)
        assert svc.respecs[-1]["outcome"] == "wedged"
        assert svc.blocks["work"] in svc.pipeline.blocks   # not replaced
    finally:
        release.set()
        plan.detach()
    rep = svc.stop(timeout=2.0)
    assert rep.exit_code in (1, 2)


def _fused_stage(up, **k):
    with block_scope(fuse=True):
        t = transpose(up, [0, 1], name="fz_t")
        return fftshift(t, axes=1, name="fz")


@pytest.mark.parametrize("case", ["source", "capture", "fused", "renamed",
                                  "space"])
def test_respec_refusals(case):
    chunks = []
    stages = [StageSpec("custom", name="source", params=dict(
        factory=lambda _up, **k: array_source(DATA, GULP)))]
    if case == "fused":
        stages += [StageSpec("copy"),
                   StageSpec("custom", name="fz", params=dict(
                       factory=_fused_stage))]
    stages += [_work_stage(),
               StageSpec("custom", name="detect", tier="detect",
                         params=dict(factory=lambda up, **k: (
                             gather_sink(up, chunks, name="gather"),
                             CandidateDetectBlock(up, threshold=1e9,
                                                  name="detect"))[1]))]
    svc = Service(ServiceSpec(stages, heartbeat_interval_s=1.0,
                              heartbeat_misses=30), name=f"rs_{case}",
                  device="cpu")
    svc.start()
    _wait_committed(svc, 2 * GULP)
    if case == "source":
        with pytest.raises(ValueError, match="source"):
            svc.respec("source", _work_stage(name="source"))
    elif case == "capture":
        with pytest.raises(ValueError, match="capture"):
            svc.respec("work", StageSpec("capture", name="work"))
    elif case == "fused":
        with pytest.raises(ValueError, match="fused group"):
            svc.respec("fz", _work_stage(name="fz"))
    elif case == "renamed":
        with pytest.raises(ValueError, match="keep the block name|keeps "
                                             "the block name"):
            svc.respec("work", _work_stage(block_name="work2"))
        assert svc.respecs[-1]["rolled_back"]
    else:
        with pytest.raises(ValueError, match="output space"):
            svc.respec("work", StageSpec("copy", name="work",
                                         params=dict(name="work")))
        assert svc.respecs[-1]["rolled_back"]
    rep = _finish(svc)
    assert rep.ledger["lost_frames"] == rep.ledger["duplicated_frames"] == 0
    assert rep.ledger["committed_frames"] == len(DATA)
    want = np.fft.fftshift(DATA, axes=1) if case == "fused" else DATA
    np.testing.assert_array_equal(np.concatenate(chunks), want)


# ------------------------------------------ a stencil spliced, against JAX
STENCIL = "y(t,c) = x(t,c) - x(t-1,c)"
STENCIL2 = "y(t,c) = x(t,c) + x(t-1,c)"
WEDGE_GULP = 5


def _stencil_run(which):
    """source -> pace -> map(STENCIL) -> gather on one package; the map
    stage wedged in its gulp of index WEDGE_GULP (FaultPlan's nth counts
    from 0) while a respec to STENCIL2 sets its stop, so the splice lands
    after that gulp in both.  The pace stage is parked after the gulp
    past it until the replacement
    has opened its sequence: the JAX splice releases the read guarantee
    in between, and a writer that went on could reclaim the frames the
    replacement resumes at."""
    if which == "jax":
        from bifrost_tpu import service as S
        from bifrost_tpu.blocks.testing import array_source as src
        from bifrost_tpu.blocks.testing import gather_sink as gs
        from bifrost_tpu.faultinject import FaultPlan
        from bifrost_tpu.pipeline import TransformBlock as TB
        kw = {}
    else:
        from bifrost_tpu_torch import service as S
        from bifrost_tpu_torch.blocks.testing import array_source as src
        from bifrost_tpu_torch.blocks.testing import gather_sink as gs
        from bifrost_tpu_torch.faultinject import FaultPlan
        from bifrost_tpu_torch.pipeline import TransformBlock as TB
        kw = {"device": "cpu"}

    class Pace(TB):
        def on_sequence(self, iseq):
            return dict(iseq.header)

        def on_data(self, ispan, ospan):
            time.sleep(0.01)
            ospan.data[...] = ispan.data
            return ispan.nframe

    chunks = []

    def mapstage(func):
        return S.StageSpec("map", name="map", params=dict(
            func=func, axis_names=["t", "c"]))

    spec = S.ServiceSpec([
        S.StageSpec("custom", name="source", params=dict(
            factory=lambda _up, **k: src(DATA, GULP))),
        S.StageSpec("custom", name="pace", params=dict(
            factory=lambda up, **k: Pace(up, name=f"pace_{which}"))),
        mapstage(STENCIL),
        S.StageSpec("custom", name="gather", params=dict(
            factory=lambda up, **k: gs(up, chunks,
                                       name=f"gather_{which}"))),
    ], heartbeat_interval_s=1.0, heartbeat_misses=30)
    svc = S.Service(spec, name=f"stencil_{which}", **kw)
    entered, release = threading.Event(), threading.Event()
    parked, unpark = threading.Event(), threading.Event()
    plan = FaultPlan(seed=5)
    # The map block's own name: "map@<service>" where a live service of
    # an earlier test still holds "map".
    plan.wedge_at("block.on_data", block=svc.blocks["map"].name,
                  nth=WEDGE_GULP,
                  release=release, entered=entered, timeout=30.0,
                  stamp_heartbeat=True)
    plan.wedge_at("block.on_data", block=f"pace_{which}",
                  nth=WEDGE_GULP + 2, release=unpark, entered=parked,
                  timeout=30.0, stamp_heartbeat=True)
    plan.attach(svc.pipeline)
    box = {}
    old = svc.blocks["map"]
    try:
        svc.start()
        assert entered.wait(30.0) and parked.wait(30.0)
        th = threading.Thread(target=lambda: box.update(
            rec=svc.respec("map", mapstage(STENCIL2))), daemon=True)
        th.start()
        deadline = time.monotonic() + 10.0
        while not old._splice_stop:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        release.set()
        th.join(30.0)
        new = svc.blocks["map"]
        while new._splice_resume_frame is not None:
            assert time.monotonic() < deadline + 20.0
            time.sleep(0.001)
    finally:
        release.set()
        unpark.set()
        plan.detach()
    assert svc.wait(timeout=60)
    svc.stop()
    return np.concatenate(chunks), box["rec"], old._loop_frame


def test_spliced_stencil_bitwise_the_jax_splice():
    port, prec, pk = _stencil_run("port")
    jax_, jrec, jk = _stencil_run("jax")
    assert not prec["rolled_back"] and not jrec["rolled_back"]
    assert port.shape == jax_.shape == DATA.shape
    assert np.array_equal(port.view(np.uint32), jax_.view(np.uint32))
    # Both spliced at the gulp edge after the wedged gulp.
    assert pk == jk == (WEDGE_GULP + 1) * GULP
    # The seam: STENCIL up to the splice, STENCIL2 after it with a fresh
    # carry (x(t-1) = 0 at the resumed frame).
    k = pk
    prev = np.concatenate([np.zeros((1, 8), np.float32), DATA[:-1]])
    want = DATA - prev
    want[k:] = DATA[k:] + prev[k:]
    want[k] = DATA[k]
    np.testing.assert_array_equal(port, want)


# --------------------------------------------------- the fleet staging view
def test_fleet_tenant_sinks_stage_through_the_pool_view():
    from bifrost_tpu_torch.egress import DeviceSinkBlock
    from bifrost_tpu_torch.fleet import FleetScheduler, TenantSpec

    got = []

    class Sink(DeviceSinkBlock):
        def on_sink_sequence(self, iseq):
            pass

        def on_sink_data(self, arr, frame_offset):
            got.append(np.array(arr))

    spec = ServiceSpec([
        StageSpec("custom", name="source", params=dict(
            factory=lambda _up, **k: array_source(DATA, GULP))),
        StageSpec("copy"),
        StageSpec("custom", name="sink", params=dict(
            factory=lambda up, **k: Sink(up, name="pool_sink"))),
    ], heartbeat_interval_s=1.0, heartbeat_misses=30)
    quota = GULP * 8 * 4          # one gulp: below the stager's depth + 1
    fleet = FleetScheduler(device="cpu", staging_bytes_total=1 << 20)
    t = fleet.submit(TenantSpec("pooled", spec, staging_bytes=quota))
    sink = t.service.blocks["sink"]
    assert sink.egress_pool is t.pool_view
    assert fleet.wait(timeout=60)
    rep = fleet.stop()
    assert rep.exit_code == 0
    np.testing.assert_array_equal(np.concatenate(got), DATA)
    st = t.pool_view.stats()
    assert st["quota_bytes"] == quota
    assert st["allocated"] >= 2 and st["over_quota_allocs"] >= 1
    assert st["retained_bytes"] == 0          # drained at the reap
    assert fleet.staging_pool.stats()["dropped"] >= 1
