"""The port's supervision layer (bifrost_tpu_torch/supervise.py) on the
CPU: the single-device cases of tests/test_supervise.py, one for one on
the port's pipeline (`device='cpu'`), with the same data and timings —
restart per policy with the faulted gulp shed, budget escalation, the
fail-fast default, the deadman on a block wedged outside and inside a
ring wait, in-place resumes, the scripted inter-sequence absorb replay
(its 20-replay stress variant keeps the reference's `slow` marker), the
overrun policies, per-block policies and the supervise ProcLog, source
restarts, stray interrupts, the bounded quiesce, recovery stamps and
budgets.  The mesh case (`test_mesh_shard_wedge_supervised_restart_
continuity`) and the shard seams' events are in
tests/test_torch_mesh_faults.py.
"""

import threading
import time

import numpy as np
import pytest

import torch

from bifrost_tpu_torch.blocks.testing import array_source
from bifrost_tpu_torch.pipeline import (Pipeline as _Pipeline, SinkBlock,
                                        SourceBlock, TransformBlock)
from bifrost_tpu_torch.supervise import (OverrunError, RestartPolicy,
                                         Supervisor, SupervisorEscalation)


def Pipeline():
    return _Pipeline(device="cpu")

DATA = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)


class CopyTransform(TransformBlock):
    def on_sequence(self, iseq):
        return dict(iseq.header)

    def on_data(self, ispan, ospan):
        ospan.data[...] = ispan.data
        return ispan.nframe


class FlakyTransform(CopyTransform):
    """Raises once, at input gulp index `fault_gulp`."""

    def __init__(self, iring, fault_gulp=1, **kwargs):
        super().__init__(iring, **kwargs)
        self.fault_gulp = fault_gulp
        self._fired = False
        self._gulps = 0

    def on_data(self, ispan, ospan):
        if self._gulps == self.fault_gulp and not self._fired:
            self._fired = True
            raise RuntimeError("injected fault")
        self._gulps += 1
        return super().on_data(ispan, ospan)


class GatherSink(SinkBlock):
    def __init__(self, iring, **kwargs):
        super().__init__(iring, **kwargs)
        self.chunks = []
        self.nseqs = 0

    def on_sequence(self, iseq):
        self.nseqs += 1

    def on_data(self, ispan):
        self.chunks.append(np.array(ispan.data))

    @property
    def frames(self):
        return sum(len(c) for c in self.chunks)


def test_restart_mid_sequence_drains_to_completion():
    """Block raises on gulp k -> restarted; pipeline completes; every
    other gulp's data is delivered intact; downstream saw EOS + a fresh
    sequence (2 sequences total)."""
    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        flaky = FlakyTransform(src, fault_gulp=1)
        sink = GatherSink(flaky)
        sup = Supervisor(policy=RestartPolicy(max_restarts=3, backoff=0.01))
        pipe.run(supervise=sup)
    out = np.concatenate(sink.chunks, axis=0)
    expect = np.concatenate([DATA[:8], DATA[16:]], axis=0)  # gulp 1 shed
    assert np.array_equal(out, expect)
    assert sink.nseqs == 2
    assert sup.counters["restarts"] == 1
    assert sup.counters["faults"] == 1
    assert sup.counters["escalations"] == 0
    # the event stream names the faulted block
    assert sup.events_for(flaky.name, "restart")


def test_restart_budget_exhaustion_escalates_cleanly():
    class AlwaysBad(CopyTransform):
        def on_data(self, ispan, ospan):
            raise RuntimeError("perma-fault")

    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        bad = AlwaysBad(src)
        GatherSink(bad)
        sup = Supervisor(policy=RestartPolicy(max_restarts=2, backoff=0.01))
        with pytest.raises(SupervisorEscalation) as exc_info:
            pipe.run(supervise=sup)
    report = exc_info.value.report
    assert report["reason"] == "restart budget exhausted"
    assert report["block"] == bad.name
    assert sup.counters["restarts"] == 2
    assert sup.counters["escalations"] == 1
    assert report["recent_events"]  # structured failure report has a tail


def test_supervise_off_is_fail_fast():
    """Without supervise=, the same fault kills the pipeline (today's
    behavior)."""
    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        FlakyTransform(src, fault_gulp=1)
        with pytest.raises(RuntimeError, match="injected fault"):
            pipe.run()


def test_deadman_fires_on_wedged_block_no_hang():
    """A block wedged outside any ring wait (hung device call stand-in)
    misses heartbeats; the deadman interrupt cannot wake it, so the
    supervisor escalates — bounded, no indefinite hang."""
    entered = threading.Event()
    release = threading.Event()

    class Wedge(CopyTransform):
        def on_data(self, ispan, ospan):
            entered.set()
            release.wait(120)  # far beyond the escalation horizon
            return super().on_data(ispan, ospan)

    t0 = time.monotonic()
    try:
        with Pipeline() as pipe:
            src = array_source(DATA, 8)
            w = Wedge(src)
            GatherSink(w)
            sup = Supervisor(policy=RestartPolicy(max_restarts=2,
                                                  backoff=0.01),
                             heartbeat_interval_s=0.2, heartbeat_misses=3)
            with pytest.raises(SupervisorEscalation) as exc_info:
                pipe.run(supervise=sup)
    finally:
        release.set()  # let the daemon thread die
    assert entered.is_set()
    assert time.monotonic() - t0 < 60
    assert sup.counters["heartbeat_misses"] >= 1
    assert sup.counters["deadman_interrupts"] >= 1
    assert "unresponsive" in exc_info.value.report["reason"]


def test_deadman_interrupts_stuck_ring_wait_no_hang():
    """A sink that stops consuming wedges the upstream transform in its
    output-ring reserve (a genuine ring wait).  The heartbeat watchdog
    detects the stall, the deadman interrupt wakes the ring wait
    (RingInterrupted — the restart path), and the run terminates by
    escalation instead of hanging forever."""
    release = threading.Event()

    class StuckSink(SinkBlock):
        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            release.wait(120)

    t0 = time.monotonic()
    try:
        with Pipeline() as pipe:
            src = array_source(DATA, 8)
            copy = CopyTransform(src)
            StuckSink(copy)
            sup = Supervisor(policy=RestartPolicy(max_restarts=2,
                                                  backoff=0.01),
                             heartbeat_interval_s=0.2, heartbeat_misses=3)
            with pytest.raises(SupervisorEscalation):
                pipe.run(supervise=sup)
    finally:
        release.set()
    assert time.monotonic() - t0 < 60
    assert sup.counters["deadman_interrupts"] >= 1
    # the copy block's ring wait was interrupted and it went through the
    # supervised fault path (RingInterrupted -> restart), not a hang:
    interrupted = [e for e in sup.events
                   if e.kind in ("deadman_interrupt", "restart")]
    assert interrupted


def test_source_deadman_in_reserve_resumes_in_place_no_replay():
    """A deadman false-positive on a source blocked in its output
    reserve (healthy-but-slow consumer) must resume the wait in place —
    NOT re-create the reader, which would replay already-delivered
    frames downstream.  The sink here keeps its own heartbeat fresh
    (live but slow), so only the backpressure-stalled source goes
    stale."""
    data = np.arange(32 * 2, dtype=np.float32).reshape(32, 2)

    class LiveSlowSink(GatherSink):
        def on_data(self, ispan):
            super().on_data(ispan)
            deadline = time.monotonic() + 0.5
            while time.monotonic() < deadline:
                self._heartbeat = time.monotonic()  # alive, just slow
                time.sleep(0.05)

    with Pipeline() as pipe:
        src = array_source(data, 8)
        sink = LiveSlowSink(src)
        sup = Supervisor(policy=RestartPolicy(max_restarts=30, window_s=60,
                                              backoff=0.01),
                         heartbeat_interval_s=0.1, heartbeat_misses=3)
        pipe.run(supervise=sup)
    out = np.concatenate(sink.chunks, axis=0)
    # every frame exactly once: an in-place resume, not a reader replay
    assert np.array_equal(out, data), (out.shape, data.shape)
    assert sup.counters["escalations"] == 0
    assert sup.counters["deadman_interrupts"] >= 1  # the false positive
    assert sink.nseqs == 1  # the source sequence was never torn down


def _run_absorb_replay():
    """The inter-sequence deadman-absorb scenario as a SCRIPTED
    interleaving (faultinject.FaultPlan), not a timing lottery.

    The exact race the old single-shot interrupt latch lost: copy and
    sink are parked (FaultPlan wedge) just BEFORE their inter-sequence
    ring waits; the watchdog deadmans both while neither is in a wait;
    copy is released first and ABSORBS — acking its own generations —
    strictly before sink is allowed to look for its interrupt.  With the
    latch, copy's blanket clear erased sink's pending interrupt here:
    sink then blocked with `deadman_pending` stuck and the watchdog
    escalated a healthy pipeline (~1/10 timer-driven runs).  With
    generation-counted interrupts, copy's bounded ack cannot retire
    sink's later generation, so sink wakes, absorbs, and the stream
    completes — every run.
    """
    import contextlib
    from bifrost_tpu_torch.faultinject import FaultPlan

    data = np.arange(16 * 2, dtype=np.float32).reshape(16, 2)
    gap_release = threading.Event()     # holds back sequence 2
    copy_release = threading.Event()    # copy's wedge -> its own deadman
    sink_release = threading.Event()    # sink's wedge -> copy absorbed

    class TwoObsSource(SourceBlock):
        """Two sequences; the inter-observation gap lasts exactly until
        the scripted interleaving has played out (gap_release)."""

        def __init__(self, gulp_nframe, **kwargs):
            super().__init__(["obs_a", "obs_b"], gulp_nframe, **kwargs)

        def create_reader(self, name):
            if name == "obs_b":
                deadline = time.monotonic() + 30.0
                while not gap_release.is_set() and \
                        time.monotonic() < deadline:
                    self._heartbeat = time.monotonic()  # alive, waiting
                    gap_release.wait(0.02)

            @contextlib.contextmanager
            def reader():
                yield {"pos": 0}
            return reader()

        def on_sequence(self, reader, name):
            return [{"_tensor": {"dtype": "f32", "shape": [-1, 2],
                                 "labels": ["time", "chan"]}}]

        def on_data(self, reader, ospans):
            n = min(ospans[0].nframe, len(data) - reader["pos"])
            if n > 0:
                ospans[0].data[:n] = torch.from_numpy(
                    data[reader["pos"]:reader["pos"] + n])
            reader["pos"] += n
            return [n]

    with Pipeline() as pipe:
        src = TwoObsSource(8)
        copy = CopyTransform(src)
        sink = GatherSink(copy)

        # The script, driven off the supervise event stream:
        #   copy deadman fired      -> release copy's wedge (it absorbs)
        #   copy absorbed + sink deadman fired -> release sink's wedge
        #   sink absorbed           -> end the gap (sequence 2 flows)
        flags = {"copy_abs": False, "sink_dm": False}

        def on_ev(ev):
            if ev.kind == "deadman_interrupt" and ev.block == copy.name:
                copy_release.set()
            elif ev.kind == "deadman_interrupt" and ev.block == sink.name:
                flags["sink_dm"] = True
            elif ev.kind == "deadman_absorbed" and ev.block == copy.name:
                flags["copy_abs"] = True
            elif ev.kind == "deadman_absorbed" and ev.block == sink.name:
                gap_release.set()
            if flags["copy_abs"] and flags["sink_dm"]:
                sink_release.set()

        sup = Supervisor(policy=RestartPolicy(max_restarts=2, backoff=0.01),
                         heartbeat_interval_s=0.1, heartbeat_misses=5,
                         on_event=on_ev)
        plan = FaultPlan()
        # Park copy and sink just BEFORE their second input-sequence
        # open: heartbeats go stale OUTSIDE any ring wait — the window
        # where a fired interrupt can only be observed later, i.e. where
        # a peer's clear could swallow it.
        plan.wedge_at("ring.open", block=copy.name, nth=1,
                      release=copy_release, timeout=30.0)
        plan.wedge_at("ring.open", block=sink.name, nth=1,
                      release=sink_release, timeout=30.0)
        plan.attach(pipe)
        try:
            pipe.run(supervise=sup)
        finally:
            plan.detach()
            gap_release.set()
    assert sink.nseqs == 2                       # nothing truncated
    assert sink.frames == 2 * len(data)
    assert sup.counters["escalations"] == 0
    assert sup.counters["deadman_interrupts"] >= 2
    absorbed = {e.block for e in sup.events if e.kind == "deadman_absorbed"}
    assert {copy.name, sink.name} <= absorbed
    return sup


def test_intersequence_deadman_absorbed_no_truncation():
    """A deadman landing on a block idle BETWEEN input sequences cannot
    be restarted — it must be absorbed in place, not allowed to silently
    kill the block and truncate the stream while run() reports success.
    Scripted via FaultPlan: the absorb-vs-clear interleaving replays
    exactly, every run (see _run_absorb_replay)."""
    _run_absorb_replay()


@pytest.mark.slow
def test_intersequence_deadman_absorbed_stress():
    """The latch race reproduced ~1/10 timer-driven runs; 20 consecutive
    scripted replays prove the generation-counted ack closed it."""
    for _ in range(20):
        _run_absorb_replay()


def test_finished_block_is_not_deadmanned():
    """A block that finishes early (source EOS) freezes its heartbeat;
    the watchdog must not deadman it — a latched interrupt on its rings
    would starve live downstream readers.  The slow sink here keeps the
    pipeline alive well past the source's heartbeat timeout."""
    data = np.arange(128 * 2, dtype=np.float32).reshape(128, 2)

    class SlowSink(GatherSink):
        def on_data(self, ispan):
            super().on_data(ispan)
            time.sleep(0.1)

    with Pipeline() as pipe:
        src = array_source(data, 8)
        sink = SlowSink(src)
        sup = Supervisor(policy=RestartPolicy(max_restarts=1, backoff=0.01),
                         heartbeat_interval_s=0.2, heartbeat_misses=3)
        pipe.run(supervise=sup)
    assert np.array_equal(np.concatenate(sink.chunks, axis=0),
                          data)
    assert sup.counters["deadman_interrupts"] == 0
    assert sup.counters["escalations"] == 0


def test_drop_oldest_source_sheds_and_reports():
    """A fast source feeding a slow sink with on_overrun='drop_oldest'
    sheds frames instead of stalling; delivered + shed == produced, and
    shed counts surface both on the block and in supervise events."""
    data = np.arange(256 * 2, dtype=np.float32).reshape(256, 2)

    class SlowSink(GatherSink):
        def on_data(self, ispan):
            super().on_data(ispan)
            time.sleep(0.05)

    with Pipeline() as pipe:
        src = array_source(data, 8, on_overrun="drop_oldest")
        sink = SlowSink(src)
        sup = Supervisor(policy=RestartPolicy())
        pipe.run(supervise=sup)
    shed = sup.counters["shed_frames"]
    assert shed > 0
    assert src.shed_frames == shed
    assert sink.frames + shed == len(data)
    # delivered frames are bit-exact (no partial/corrupt gulps)
    for chunk in sink.chunks:
        base = int(chunk[0, 0]) // 2
        assert np.array_equal(chunk, data[base:base + len(chunk)])
    assert sup.events_for(src.name, "shed")


def test_fail_overrun_policy_raises():
    data = np.arange(256 * 2, dtype=np.float32).reshape(256, 2)

    class SlowSink(GatherSink):
        def on_data(self, ispan):
            time.sleep(0.05)

    with Pipeline() as pipe:
        src = array_source(data, 8, on_overrun="fail")
        SlowSink(src)
        with pytest.raises(OverrunError):
            pipe.run()


def test_backpressure_default_loses_nothing():
    """The default policy blocks (no shedding), slow sink or not."""
    data = np.arange(64 * 2, dtype=np.float32).reshape(64, 2)

    class SlowSink(GatherSink):
        def on_data(self, ispan):
            super().on_data(ispan)
            time.sleep(0.01)

    with Pipeline() as pipe:
        src = array_source(data, 8)
        sink = SlowSink(src)
        pipe.run(supervise=RestartPolicy())
    assert src.shed_frames == 0
    assert np.array_equal(np.concatenate(sink.chunks, axis=0),
                          data)


def test_invalid_overrun_policy_rejected():
    with pytest.raises(ValueError, match="on_overrun"):
        with Pipeline():
            array_source(DATA, 8, on_overrun="nonsense")


def test_per_block_policy_and_proclog_export():
    """policies={name: policy} overrides the default; the supervise
    proclog is written and parseable by proclog.supervise_metrics."""
    import os
    from bifrost_tpu_torch import proclog as plog

    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        flaky = FlakyTransform(src, fault_gulp=1)
        GatherSink(flaky)
        sup = Supervisor(policy=RestartPolicy(max_restarts=0),
                         policies={flaky.name: RestartPolicy(
                             max_restarts=5, backoff=0.01)})
        pipe.run(supervise=sup)  # succeeds: the per-block policy applies
        tree = plog.load_by_pid(os.getpid())
    assert sup.counters["restarts"] == 1
    rows = plog.supervise_metrics(tree)
    assert rows, f"no supervise rows in {sorted(tree)}"
    assert any(r["restarts"] >= 1 for r in rows)


def test_source_restart_fresh_reader():
    """A source whose reader raises mid-sequence is restarted with a
    fresh reader (sequence starts over) and the pipeline completes."""
    attempts = []

    class FlakyReader(object):
        def __init__(self, data, fail_once):
            self.data = data
            self.fail_once = fail_once
            self.pos = 0

        def read(self, nframe):
            if self.fail_once and self.pos >= 8:
                self.fail_once = False
                raise IOError("transient source glitch")
            n = min(nframe, len(self.data) - self.pos)
            out = self.data[self.pos:self.pos + n]
            self.pos += n
            return out

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

    class FlakySource(SourceBlock):
        def __init__(self, data, gulp_nframe, **kwargs):
            self.data = data
            self.failed_once = False
            super().__init__(["flaky"], gulp_nframe, **kwargs)

        def create_reader(self, name):
            first = not self.failed_once
            self.failed_once = True
            attempts.append(name)
            return FlakyReader(self.data, fail_once=first)

        def on_sequence(self, reader, name):
            return [{"_tensor": {"dtype": "f32",
                                 "shape": [-1, self.data.shape[1]],
                                 "labels": ["time", "chan"]}}]

        def on_data(self, reader, ospans):
            chunk = reader.read(ospans[0].nframe)
            ospans[0].data[:len(chunk)] = torch.from_numpy(chunk)
            return [len(chunk)]

    data = np.arange(32 * 2, dtype=np.float32).reshape(32, 2)
    with Pipeline() as pipe:
        src = FlakySource(data, 8)
        sink = GatherSink(src)
        sup = Supervisor(policy=RestartPolicy(max_restarts=2, backoff=0.01))
        pipe.run(supervise=sup)
    assert len(attempts) == 2          # reader was re-created once
    assert sup.counters["restarts"] == 1
    # the retried sequence delivers the full stream
    assert sink.chunks[-1] is not None
    full = np.concatenate(sink.chunks[-(len(data) // 8):], axis=0)
    assert np.array_equal(full, data)


def test_stray_targeted_interrupt_is_survived():
    """A generation-counted interrupt aimed at nobody (an operator tool,
    a late deadman for a finished block) wakes waiters collaterally;
    supervised waiters must absorb it and the stream must complete
    losslessly once it is acknowledged."""
    data = np.arange(128 * 2, dtype=np.float32).reshape(128, 2)

    class SlowSink(GatherSink):
        def on_data(self, ispan):
            super().on_data(ispan)
            time.sleep(0.01)

    with Pipeline() as pipe:
        src = array_source(data, 8)
        sink = SlowSink(src)
        sup = Supervisor(policy=RestartPolicy(max_restarts=2, backoff=0.01))

        fired = {}

        def meddle():
            time.sleep(0.15)
            ring = src.orings[0]
            fired["gen"] = ring.interrupt(target=12345)  # aimed at nobody
            time.sleep(0.1)
            ring.ack_interrupt(fired["gen"])

        t = threading.Thread(target=meddle, daemon=True)
        t.start()
        pipe.run(supervise=sup)
        t.join(5)
    assert np.array_equal(np.concatenate(sink.chunks, axis=0), data)
    assert sup.counters["escalations"] == 0


def test_shutdown_timeout_clean_drain():
    """Bounded quiesce on a healthy pipeline: sources stop at the next
    gulp edge, EOS drains downstream, and every block reports
    'drained' — no interrupts fired, run() returns normally."""
    data = np.arange(4096 * 2, dtype=np.float32).reshape(4096, 2)

    class SlowSink(GatherSink):
        def on_data(self, ispan):
            super().on_data(ispan)
            time.sleep(0.02)

    with Pipeline() as pipe:
        src = array_source(data, 8)
        copy = CopyTransform(src)
        sink = SlowSink(copy)
        result = {}

        def controller():
            time.sleep(0.3)
            result["report"] = pipe.shutdown(timeout=10.0)

        t = threading.Thread(target=controller, daemon=True)
        t.start()
        pipe.run()
        t.join(20)
    report = result["report"]
    assert report.clean, report.as_dict()
    assert set(report.blocks) == {src.name, copy.name, sink.name}
    assert all(v["outcome"] == "drained" for v in report.blocks.values())
    assert report.elapsed_s < 10.0
    assert pipe.drain_report is report
    # everything committed before the quiesce was delivered losslessly
    if sink.chunks:
        out = np.concatenate(sink.chunks, axis=0)
        assert np.array_equal(out, data[:len(out)])


def test_shutdown_timeout_after_completion_is_noop():
    """Quiescing an already-finished pipeline returns immediately with
    every block drained."""
    data = np.arange(32 * 2, dtype=np.float32).reshape(32, 2)
    with Pipeline() as pipe:
        src = array_source(data, 8)
        sink = GatherSink(src)
        pipe.run()
        t0 = time.monotonic()
        report = pipe.shutdown(timeout=5.0)
    assert time.monotonic() - t0 < 1.0
    assert report.clean
    assert set(report.blocks) == {src.name, sink.name}
    assert np.array_equal(np.concatenate(sink.chunks, axis=0), data)


def test_recovery_time_stamped_into_restart_event_and_counters():
    """Satellite (24/7 service PR): the supervisor stamps fault->first-
    healthy-gulp recovery time into the restart SuperviseEvent and the
    counters, and recovery_stats() serves p50/p99 without event-stream
    parsing."""
    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        flaky = FlakyTransform(src, fault_gulp=1)
        GatherSink(flaky)
        sup = Supervisor(policy=RestartPolicy(max_restarts=3, backoff=0.01))
        pipe.run(supervise=sup)
    assert pipe.supervisor is sup   # reachable from a controller thread
    assert sup.counters["restarts"] == 1
    assert sup.counters["recoveries"] == 1
    ev = sup.events_for(flaky.name, "restart")[0]
    assert "recovery_s" in ev.details
    assert ev.details["recovery_s"] >= 0.0
    # the faulted gulp's frames are named in the event (ledger input)
    assert ev.details["shed_nframe"] == 8
    stats = sup.recovery_stats()
    assert stats["count"] == 1
    assert stats["p50_s"] == stats["p99_s"] == stats["max_s"]
    assert abs(stats["p50_s"] - ev.details["recovery_s"]) < 1e-3


def test_budget_remaining_query():
    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        flaky = FlakyTransform(src, fault_gulp=1)
        GatherSink(flaky)
        sup = Supervisor(policy=RestartPolicy(max_restarts=3, backoff=0.01))
        assert sup.budget_remaining("no_such_block") is None
        pipe.run(supervise=sup)
    # one restart consumed inside the (long) window
    assert sup.budget_remaining(flaky.name) == 2
    assert sup.budget_remaining(flaky) == 2
    # untouched blocks keep the full budget
    assert sup.budget_remaining(src.name) == 3


def test_record_degrade_event_and_counter():
    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        sink = GatherSink(src)
        sup = Supervisor(policy=RestartPolicy(max_restarts=3))
        sup.attach(pipe)
        sup.record_degrade(sink, budget_remaining=1, detect_factor=2.0)
        pipe.shutdown()
    assert sup.counters["degrades"] == 1
    ev = sup.events_for(sink.name, "degrade")[0]
    assert ev.details["budget_remaining"] == 1


def test_record_respec_event_and_counter():
    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        sink = GatherSink(src)
        sup = Supervisor(policy=RestartPolicy(max_restarts=3))
        sup.attach(pipe)
        sup.record_respec(sink, stage="sink", outcome="drained",
                          rolled_back=False, splice_s=0.01)
        pipe.shutdown()
    assert sup.counters["respecs"] == 1
    ev = sup.events_for(sink.name, "respec")[0]
    assert ev.details["outcome"] == "drained"
    assert ev.details["rolled_back"] is False


def test_reader_behind_an_empty_warm_up_stays_alive():
    """The port's ring-progress liveness: a transform that commits empty
    spans for its first gulps (an FDMT's warm-up) keeps the sink waiting
    behind it alive through the watchdog's horizon, so the sink is not
    deadmanned; a wait with no commit at all still is (the tests
    above)."""
    data = np.arange(96 * 2, dtype=np.float32).reshape(96, 2)

    class WarmUp(CopyTransform):
        def __init__(self, iring, **kwargs):
            super().__init__(iring, **kwargs)
            self._gulps = 0

        def on_data(self, ispan, ospan):
            time.sleep(0.1)
            self._gulps += 1
            if self._gulps <= 8:            # 0.8 s of empty commits
                return 0
            return super().on_data(ispan, ospan)

    with Pipeline() as pipe:
        src = array_source(data, 8)
        warm = WarmUp(src)
        sink = GatherSink(warm)
        sup = Supervisor(policy=RestartPolicy(max_restarts=2, backoff=0.01),
                         heartbeat_interval_s=0.1, heartbeat_misses=6)
        pipe.run(supervise=sup)
    assert sup.counters["deadman_interrupts"] == 0, sup.events
    assert sup.counters["heartbeat_misses"] == 0
    assert np.array_equal(np.concatenate(sink.chunks, axis=0), data[64:])
