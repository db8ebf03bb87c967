"""The port's service layer (bifrost_tpu_torch/service.py) on the CPU.

The first eleven tests mirror the socket-free cases of
tests/test_service.py on the port (`device='cpu'`), on small chains of
'custom' stages: spec validation, the clean run's exit report and
ledger, the health snapshot and its ProcLog, a restart's ledger
accounting, degraded mode, the shed path, escalation, the detector, and
the proclog namespace guard.  The twelfth JAX case,
`test_lwa_frb_search_spec_geometry_and_shards`, needs UDP sockets: it is
in test_torch_capture_service.py.

Then the whole instrument: the port's `Service(lwa_instrument_spec(
voltages=...), device='cpu')` against the JAX `Service` of the same spec
(fused, `pallas_interpret=True`) at benchmarks/e2e_tpu.py's GEOM
(:150-151) on seeded voltages, clean and through the e2e fault
(`FaultPlan(seed=7).raise_at("block.on_data", block="bengine", nth=1)`,
e2e_tpu.py:189-191).  Tolerances: images within 1e-5 of their peak
(test_torch_instrument_chain.py's bound, derived there); candidates,
ledger summaries, event kinds, blocks and constituents, and exit codes
identical.  Both packages' health snapshots carry the same keys, and the
port's `load_by_pid` reads the tree the JAX service writes into the
structure of the port's own (timing values left out).
"""

import os
import time
import warnings

import numpy as np
import pytest

from bifrost_tpu_torch.blocks.testing import array_source
from bifrost_tpu_torch.pipeline import TransformBlock
from bifrost_tpu_torch.proclog import load_by_pid, service_metrics
from bifrost_tpu_torch.service import (EXIT_CLEAN, EXIT_DEGRADED,
                                       EXIT_ESCALATED, Service, ServiceSpec,
                                       StageSpec)
from bifrost_tpu_torch.supervise import RestartPolicy

DATA = (np.arange(256 * 8, dtype=np.float32).reshape(256, 8) % 23)
GULP = 16


@pytest.fixture(scope="module", autouse=True)
def _jax_fft_method_default():
    """The JAX references run at the JAX package's default `fft_method`:
    tests/test_fusion.py's latch test sets it from a sink callback, and
    under load a call that lands after the latch is released succeeds and
    stays set in that process ('matmul', 4e-3 off the 'xla' images)."""
    from bifrost_tpu import config as jconfig
    jconfig.reset("fft_method")


class FlakyTransform(TransformBlock):
    """Copy transform raising `nfaults` times at gulp `fault_gulp`."""

    def __init__(self, iring, fault_gulp=2, nfaults=1, **kwargs):
        super().__init__(iring, **kwargs)
        self.fault_gulp = fault_gulp
        self.nfaults = nfaults
        self._gulps = 0

    def on_sequence(self, iseq):
        return dict(iseq.header)

    def on_data(self, ispan, ospan):
        g = self._gulps
        self._gulps += 1
        if g >= self.fault_gulp and self.nfaults > 0:
            self.nfaults -= 1
            raise RuntimeError("injected service fault")
        ospan.data[...] = ispan.data
        return ispan.nframe


def _source_stage(data=DATA, gulp=GULP):
    return StageSpec("custom", name="source", params=dict(
        factory=lambda _up, **kw: array_source(data, gulp)))


def _spec(stages, **kw):
    kw.setdefault("heartbeat_interval_s", 1.0)
    kw.setdefault("heartbeat_misses", 30)
    return ServiceSpec(stages, **kw)


def _service(spec, **kw):
    return Service(spec, device="cpu", **kw)


def _run_to_completion(svc, timeout=30.0):
    svc.start()
    deadline = time.monotonic() + timeout
    while svc.running and time.monotonic() < deadline:
        time.sleep(0.05)
    return svc.stop()


# ------------------------------------------------------------- spec layer
def test_spec_validation():
    with pytest.raises(ValueError):
        StageSpec("warp_drive")
    with pytest.raises(ValueError):
        ServiceSpec([])
    with pytest.raises(ValueError):
        ServiceSpec([StageSpec("detect", name="a"),
                     StageSpec("detect", name="a")])


def test_non_source_stage_cannot_start_chain():
    with pytest.raises(ValueError, match="upstream"):
        _service(_spec([StageSpec("detect")]))


# ------------------------------------------------------------ clean runs
def test_clean_run_exit_clean_and_ledger():
    svc = _service(_spec([_source_stage(),
                          StageSpec("detect", params=dict(threshold=1e9))]))
    report = _run_to_completion(svc)
    assert report.exit_code == EXIT_CLEAN
    assert report.clean
    assert report.state == "stopped"
    led = report.ledger
    assert led["committed_frames"] == len(DATA)
    assert led["lost_frames"] == 0
    assert led["duplicated_frames"] == 0
    assert led["sequences"] == 1
    assert report.counters["restarts"] == 0
    # idempotent: a second stop() returns the SAME report
    assert svc.stop() is report


def test_health_snapshot_structure_and_proclog():
    svc = _service(_spec([_source_stage(),
                          StageSpec("detect", params=dict(threshold=1e9))]))
    svc.start()
    deadline = time.monotonic() + 20.0
    while svc.blocks["detect"].frames_seen < len(DATA) and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    snap = svc.health()
    assert snap["state"] in ("running", "degraded")
    assert set(snap["blocks"]) == {"source", "detect"}
    for row in snap["blocks"].values():
        assert "budget_remaining" in row and "heartbeat_age_s" in row
    assert snap["ledger"]["committed_frames"] == len(DATA)
    svc._push_health()
    rows = service_metrics(load_by_pid(os.getpid()))
    assert rows, "no service row in the proclog tree"
    assert any(r.get("committed_frames") == len(DATA) for r in rows)
    svc.stop()


# -------------------------------------------------- restarts + the ledger
def test_restart_sheds_one_gulp_recovery_stamped():
    flaky = {}

    def factory(up, **kw):
        flaky["block"] = FlakyTransform(up, fault_gulp=2, name="flaky")
        return flaky["block"]

    svc = _service(_spec([
        _source_stage(),
        StageSpec("custom", name="flaky", params=dict(factory=factory),
                  restart=RestartPolicy(max_restarts=3, backoff=0.01)),
        StageSpec("detect", params=dict(threshold=1e9)),
    ]))
    report = _run_to_completion(svc)
    assert report.counters["restarts"] == 1
    assert report.counters["recoveries"] == 1
    assert report.recovery["count"] == 1
    assert report.recovery["p50_s"] is not None
    assert report.recovery["p99_s"] is not None
    led = report.ledger
    # the faulted gulp is SHED (accounted), never lost or duplicated
    assert led["restart_shed_frames"] == GULP
    assert led["lost_frames"] == 0
    assert led["duplicated_frames"] == 0
    # downstream saw EOS + a fresh sequence from the restarted transform
    assert led["sequences"] == 2
    assert led["committed_frames"] == len(DATA) - GULP
    recs = [r for r in svc.ledger.restarts if r["block"] == "flaky"]
    assert recs and recs[0]["shed_nframe"] == GULP
    assert "recovery_s" in recs[0]


# --------------------------------------------------------- degraded mode
def test_degraded_mode_raises_threshold_instead_of_escalating():
    def factory(up, **kw):
        return FlakyTransform(up, fault_gulp=2, nfaults=2, name="flaky")

    svc = _service(_spec(
        [
            _source_stage(),
            StageSpec("custom", name="flaky", params=dict(factory=factory),
                      restart=RestartPolicy(max_restarts=3, window_s=60.0,
                                            backoff=0.01)),
            StageSpec("detect", params=dict(threshold=5.0)),
        ],
        degrade_margin=1, degrade_detect_factor=3.0))
    report = _run_to_completion(svc)
    det = svc.blocks["detect"]
    # two restarts against budget 3 -> remaining 1 == margin -> degrade
    assert report.counters["restarts"] == 2
    assert report.counters["escalations"] == 0
    assert report.counters["degrades"] >= 1
    assert svc.degrade_episodes == 1
    assert det.threshold == pytest.approx(15.0)
    assert report.exit_code == EXIT_DEGRADED
    assert report.state == "degraded"
    assert report.degraded_at_stop


def test_degrade_shed_path_accounts_through_supervisor():
    svc = _service(_spec([_source_stage(),
                          StageSpec("detect", params=dict(threshold=1e9))]))
    det = svc.blocks["detect"]
    det.shed_every = 2          # shed every 2nd gulp, as degraded mode does
    report = _run_to_completion(svc)
    assert det.gulps_shed > 0
    assert report.counters["shed_frames"] == det.gulps_shed * GULP
    assert report.ledger["shed_frames"] == det.gulps_shed * GULP
    # shed gulps skip DETECTION, not consumption: continuity is intact
    assert report.ledger["committed_frames"] == len(DATA)
    assert report.ledger["lost_frames"] == 0


# ------------------------------------------------------------ escalation
def test_budget_exhaustion_escalates_exit_code_2():
    def factory(up, **kw):
        return FlakyTransform(up, fault_gulp=0, nfaults=100, name="doomed")

    svc = _service(_spec([
        _source_stage(),
        StageSpec("custom", name="doomed", params=dict(factory=factory),
                  restart=RestartPolicy(max_restarts=1, backoff=0.01)),
        StageSpec("detect", params=dict(threshold=1e9)),
    ]))
    svc.start()
    deadline = time.monotonic() + 30.0
    while svc.running and time.monotonic() < deadline:
        time.sleep(0.05)
    report = svc.stop()
    assert report.exit_code == EXIT_ESCALATED
    assert report.state == "escalated"
    assert report.escalation is not None
    assert report.escalation["reason"] == "restart budget exhausted"
    assert report.escalation["block"] == "doomed"


# ------------------------------------------------- candidate detect block
def test_candidate_detect_finds_bright_burst():
    rng = np.random.default_rng(3)
    data = rng.normal(100.0, 5.0, size=(128, 16)).astype(np.float32)
    data[40, 3] = 5000.0
    hits = []
    svc = _service(_spec([
        _source_stage(data=data, gulp=GULP),
        StageSpec("detect", params=dict(threshold=8.0,
                                        on_candidate=hits.append)),
    ]))
    report = _run_to_completion(svc)
    det = svc.blocks["detect"]
    assert report.exit_code == EXIT_CLEAN
    assert det.ncandidates >= 1
    assert hits and hits[0]["snr"] >= 8.0
    # the bright cell sits in the gulp covering frames [32, 48)
    assert any(32 <= c["frame"] < 48 and c["seq"] == 0
               for c in det.candidates)


# ------------------------------------- concurrent-service namespace guard
def test_two_live_services_do_not_clobber_proclog_namespace():
    def spec():
        return _spec([_source_stage(),
                      StageSpec("detect", params=dict(threshold=1e9))])

    svc_a = _service(spec(), name="svc_a")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        svc_b = _service(spec(), name="svc_b")
    assert any("detect" in str(w.message) and "svc_a" in str(w.message)
               for w in caught)
    names_a = {b.name for b in svc_a.pipeline.blocks}
    names_b = {b.name for b in svc_b.pipeline.blocks}
    assert not (names_a & names_b), (names_a, names_b)
    assert "detect" in names_a and "detect@svc_b" in names_b
    assert svc_b.blocks["detect"].name == "detect@svc_b"
    svc_a.start()
    svc_b.start()
    for svc in (svc_a, svc_b):
        deadline = time.monotonic() + 20.0
        det = svc.blocks["detect"]
        while det.frames_seen < len(DATA) and \
                time.monotonic() < deadline:
            time.sleep(0.05)
    tree = load_by_pid(os.getpid())
    assert "detect" in tree and "detect@svc_b" in tree
    rep_a, rep_b = svc_a.stop(), svc_b.stop()
    for rep in (rep_a, rep_b):
        assert rep.ledger["committed_frames"] == len(DATA)
        assert rep.ledger["lost_frames"] == 0
        assert rep.ledger["duplicated_frames"] == 0
    # Claims were released at stop: a fresh service gets the bare names.
    svc_c = _service(spec(), name="svc_c")
    assert "detect" in {b.name for b in svc_c.pipeline.blocks}
    svc_c.start()
    svc_c.stop()


def test_custom_factory_block_name_collision_raises():
    def named_copy_stage():
        return StageSpec("custom", name="copy", params=dict(
            factory=lambda up, **kw: FlakyTransform(
                up, fault_gulp=10**9, name="shared_name")))

    def spec():
        return _spec([_source_stage(), named_copy_stage(),
                      StageSpec("detect", params=dict(threshold=1e9))])

    svc_a = _service(spec(), name="first")
    try:
        with pytest.raises(ValueError, match="shared_name"):
            _service(spec(), name="second")
    finally:
        svc_a.start()
        svc_a.stop()


# ----------------------------------------------- the port's own contract
def test_service_needs_a_card_or_a_device(monkeypatch):
    """No card and no device named: the Service raises, as Pipeline()
    does; nothing falls back to the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Service(_spec([_source_stage(),
                       StageSpec("detect", params=dict(threshold=1e9))]))


@pytest.mark.parametrize("kind", ["capture", "unpack", "map"])
def test_unported_kinds_raise(kind):
    """Every kind of the JAX registry builds here now.  A capture stage
    without its socket and geometry raises TypeError, and one after
    another stage ValueError (it can only start a chain), as the JAX
    registry does; an unpack stage builds an UnpackBlock, a map stage a
    MapBlock (bifrost_tpu/service.py:942-943), and a map stage without
    its program raises KeyError, as there."""
    if kind == "capture":
        with pytest.raises(TypeError):
            _service(_spec([StageSpec(kind)]))
        with pytest.raises(ValueError, match="first stage"):
            _service(_spec([_source_stage(), StageSpec(kind)]))
        return
    if kind == "unpack":
        from bifrost_tpu_torch.blocks import UnpackBlock
        svc = _service(_spec([_source_stage(),
                              StageSpec(kind, params=dict(dtype="i8"))]))
        b = svc.blocks[kind]
        assert isinstance(b, UnpackBlock) and b.dtype == "i8"
        return
    from bifrost_tpu_torch.blocks import MapBlock
    svc = _service(_spec([_source_stage(),
                          StageSpec(kind, params=dict(func="y = x*x"))]))
    b = svc.blocks[kind]
    assert isinstance(b, MapBlock) and b.op.fuse_form == "elementwise"
    with pytest.raises(KeyError, match="func"):
        _service(_spec([_source_stage(), StageSpec(kind)]))


@pytest.mark.parametrize("flag,bad,good,default", [
    ("service_degrade_margin", -1, 2, 1),
    ("service_degrade_detect_factor", 0.5, 3.0, 2.0),
    ("service_health_interval_s", 0.0, 0.5, 2.0),
])
def test_service_flags_defaults_and_validation(flag, bad, good, default):
    """The three service flags carry the JAX package's defaults and
    validation (bifrost_tpu/config.py:263-283)."""
    from bifrost_tpu import config as jconfig
    from bifrost_tpu_torch import config
    assert config.get(flag) == jconfig.get(flag) == default
    with pytest.raises(ValueError, match=flag):
        config.set(flag, bad)
    config.set(flag, good)
    try:
        assert config.get(flag) == good
    finally:
        config.reset(flag)


def test_registry_copy_defaults_to_cuda_space():
    svc = _service(_spec([_source_stage(), StageSpec("copy"),
                          StageSpec("detect", params=dict(threshold=1e9))]))
    assert svc.blocks["copy"].orings[0].space == "cuda"
    report = _run_to_completion(svc)
    assert report.exit_code == EXIT_CLEAN
    assert report.ledger["committed_frames"] == len(DATA)


# ------------------------------------------ the instrument against JAX
GEOM = dict(nstand=3, npol=2, nchan=4, ntap=4, n_int=3, nbeam=2, ngrid=16,
            max_delay=4)
NINT = 8
TOL = 1e-5


def _voltages(seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 8, (NINT * GEOM["n_int"] * GEOM["nchan"],
                                GEOM["nstand"], GEOM["npol"], 2)) \
        .astype(np.int8)


def _events(evs):
    return [(e.kind, e.block, tuple(e.details.get("constituents", ())))
            for e in evs]


def _instrument(pkg, volt, fault):
    """One instrument Service run of package `pkg` ('port' or 'jax'), as
    benchmarks/e2e_tpu.py:run_instrument runs it: fuse first, then arm
    the fault plan on the post-fusion blocks."""
    if pkg == "port":
        from bifrost_tpu_torch import service
        from bifrost_tpu_torch.faultinject import FaultPlan
        images = []
        spec = service.lwa_instrument_spec(
            voltages=volt, threshold=2.0,
            on_image=lambda d: images.append(d.numpy().copy()), **GEOM)
        svc = service.Service(spec, name=f"e2e_port_{fault}", device="cpu")
    else:
        from bifrost_tpu import service
        from bifrost_tpu.faultinject import FaultPlan
        from bifrost_tpu_torch.ndarray import pair_to_structured
        images = []
        spec = service.lwa_instrument_spec(
            voltages=pair_to_structured(volt), pallas_interpret=True,
            threshold=2.0,
            on_image=lambda d: images.append(np.array(d)), **GEOM)
        svc = service.Service(spec, name=f"e2e_jax_{fault}")
    cands, events = [], []
    svc.blocks["bdetect"].on_candidate = cands.append
    svc.on_event(events.append)
    svc.pipeline._fuse_device_chains()
    plan = None
    if fault:
        plan = FaultPlan(seed=7)
        plan.raise_at("block.on_data", block="bengine", nth=1)
        plan.attach(svc.pipeline)
    try:
        svc.start()
        finished = svc.wait(timeout=300)
        health = svc.health()
        report = svc.stop()
    finally:
        if plan is not None:
            plan.detach()
    assert finished and svc._run_error is None
    return {"images": images, "candidates": cands, "events": events,
            "report": report, "health": health, "plan": plan}


@pytest.fixture(scope="module")
def instrument_runs():
    volt = _voltages()
    return {(pkg, fault): _instrument(pkg, volt, fault)
            for pkg in ("port", "jax") for fault in (False, True)}


@pytest.mark.parametrize("fault", [False, True])
def test_instrument_service_matches_jax(instrument_runs, fault):
    p = instrument_runs[("port", fault)]
    j = instrument_runs[("jax", fault)]
    assert len(p["images"]) == len(j["images"]) == NINT
    for a, b in zip(p["images"], j["images"]):
        a = a.reshape(b.shape)
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= TOL * np.abs(b).max()
    assert p["candidates"] == j["candidates"]
    assert p["report"].ledger == j["report"].ledger
    assert p["report"].exit_code == j["report"].exit_code
    assert _events(p["events"]) == _events(j["events"])
    led = p["report"].ledger
    assert led["lost_frames"] == led["duplicated_frames"] == 0
    if not fault:
        assert p["report"].exit_code == EXIT_CLEAN
        assert p["report"].drain.clean
        c = p["report"].counters
        assert c["faults"] == c["restarts"] == c["heartbeat_misses"] == \
            c["deadman_interrupts"] == 0
    else:
        assert p["plan"].fired(site="block.on_data")
        restarts = [e for e in p["events"] if e.kind == "restart"]
        assert len(restarts) == 1
        assert "bengine" in restarts[0].details["constituents"]
        # the X branch never faulted: its images equal the clean run's
        clean = instrument_runs[("port", False)]["images"]
        for a, b in zip(p["images"], clean):
            assert np.array_equal(a, b)


def test_instrument_health_snapshots_carry_the_same_keys(instrument_runs):
    p = instrument_runs[("port", True)]["health"]
    j = instrument_runs[("jax", True)]["health"]
    assert set(p) == set(j)
    for key in ("counters", "ledger", "availability", "elastic",
                "recovery", "detect"):
        assert set(p[key]) == set(j[key]), key
    assert set(p["blocks"]) == set(j["blocks"])
    for name in p["blocks"]:
        assert set(p["blocks"][name]) == set(j["blocks"][name])


def test_load_by_pid_reads_the_jax_tree_into_the_same_structure():
    """The same two-stage spec on both packages, each block named the
    same; the port's `load_by_pid` reads both trees (the JAX one from its
    own root) into one {block: {log: keys}} structure."""
    from bifrost_tpu import service as jservice
    from bifrost_tpu.blocks.testing import array_source as j_array_source
    from bifrost_tpu.libbifrost_tpu import proclog_dir as j_proclog_dir
    from bifrost_tpu.pipeline import SinkBlock as JSink
    from bifrost_tpu_torch.pipeline import SinkBlock as PSink

    def make_sink(base):
        class Sink(base):
            def on_sequence(self, iseq):
                pass

            def on_data(self, ispan):
                pass
        return Sink

    def stages(src_fn, sink_cls, tag):
        return [StageSpec("custom", name="src", params=dict(
                    factory=lambda up: src_fn(DATA, GULP))),
                StageSpec("custom", name="sink", params=dict(
                    factory=lambda up: sink_cls(up, name=f"tree_{tag}")))]

    def structure(tree, svc):
        names = {b.name: f"block{i}"
                 for i, b in enumerate(svc.pipeline.blocks)}
        names[svc.pipeline.pname] = "pipeline"
        return {names[b]: {log: set(kv) for log, kv in logs.items()}
                for b, logs in tree.items() if b in names}

    port = Service(ServiceSpec(stages(array_source, make_sink(PSink),
                                      "port")), device="cpu")
    jax_ = jservice.Service(jservice.ServiceSpec(
        stages(j_array_source, make_sink(JSink), "jax")))
    for svc in (port, jax_):
        svc.start()
        assert svc.wait(timeout=60)
        svc._push_health()
    pid = os.getpid()
    p = structure(load_by_pid(pid, include_rings=False), port)
    j = structure(load_by_pid(pid, include_rings=False,
                              root=os.path.dirname(j_proclog_dir())), jax_)
    port.stop()
    jax_.stop()
    assert p == j
    assert {"bind", "in", "out", "sequence0", "perf"} <= set(p["block0"])
    assert {"info", "supervise", "service"} <= set(p["pipeline"])
