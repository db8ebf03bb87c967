"""The port's fault injection (bifrost_tpu_torch/faultinject.py) on the
CPU: every case of tests/test_faultinject.py, one for one on the port's
pipeline (`device='cpu'`) — arming validation, a scripted raise as a
counted restart, deterministic replay, a permafault exhausting the
budget, the source.reserve alias with a delay, an injected interrupt
absorbed under supervision, a wedge escalating through the deadman, the
bounded quiesce past a wedge, detach, and the UDP sites through a
stand-in capture block (no socket); then a udp.recv raise through a real
UDPCaptureBlock over loopback.  Then the port's own: the egress
sites on a DeviceSinkBlock.  The mesh sites (collective.enter,
shard.lost, shard.dispatch) are armed on a mesh block in
tests/test_torch_mesh_faults.py.
"""

import threading
import time

import numpy as np
import pytest

from bifrost_tpu_torch.blocks.testing import array_source
from bifrost_tpu_torch.faultinject import FaultPlan, InjectedFault
from bifrost_tpu_torch.pipeline import (Pipeline as _Pipeline, SinkBlock,
                                        TransformBlock)
from bifrost_tpu_torch.supervise import (RestartPolicy, Supervisor,
                                         SupervisorEscalation)


def Pipeline():
    return _Pipeline(device="cpu")

DATA = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)


class CopyTransform(TransformBlock):
    def on_sequence(self, iseq):
        return dict(iseq.header)

    def on_data(self, ispan, ospan):
        ospan.data[...] = ispan.data
        return ispan.nframe


class GatherSink(SinkBlock):
    def __init__(self, iring, **kwargs):
        super().__init__(iring, **kwargs)
        self.chunks = []
        self.nseqs = 0

    def on_sequence(self, iseq):
        self.nseqs += 1

    def on_data(self, ispan):
        self.chunks.append(np.array(ispan.data))


def test_arming_validation():
    plan = FaultPlan()
    with pytest.raises(ValueError, match="site"):
        plan.inject("ring.explode", "raise")
    with pytest.raises(ValueError, match="action"):
        plan.inject("ring.reserve", "vanish")
    plan.raise_at("block.on_data", block="x")
    with pytest.raises(RuntimeError, match="attach"):
        with Pipeline() as pipe:
            array_source(DATA, 8)
            plan.attach(pipe)
            plan.raise_at("block.on_data", block="y")


def _run_raise_scenario():
    """Injected raise at the transform's gulp 1, supervised; returns
    (plan, sup, sink, copy_name)."""
    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        copy = CopyTransform(src)
        sink = GatherSink(copy)
        sup = Supervisor(policy=RestartPolicy(max_restarts=3, backoff=0.01))
        plan = FaultPlan(seed=7)
        plan.raise_at("block.on_data", block=copy.name, nth=1)
        plan.attach(pipe)
        try:
            pipe.run(supervise=sup)
        finally:
            plan.detach()
    return plan, sup, sink, copy.name


def test_injected_raise_is_a_counted_restart():
    """A scripted on_data raise behaves exactly like an organic block
    fault: one restart, the faulted gulp shed, the rest delivered."""
    plan, sup, sink, copy_name = _run_raise_scenario()
    out = np.concatenate(sink.chunks, axis=0)
    expect = np.concatenate([DATA[:8], DATA[16:]], axis=0)  # gulp 1 shed
    assert np.array_equal(out, expect)
    assert sup.counters["restarts"] == 1
    assert sup.counters["escalations"] == 0
    assert [(e["site"], e["block"], e["action"], e["n"])
            for e in plan.log] == [("block.on_data", copy_name, "raise", 1)]


def test_plan_replay_is_deterministic():
    """Two runs of the same plan produce the same firing log and the
    same supervision outcome — the whole point of scripted faults."""
    logs, counters = [], []
    for _ in range(2):
        plan, sup, sink, _ = _run_raise_scenario()
        # block names carry a process-global instance counter, so compare
        # the schedule shape (site, action, call index), not the labels
        logs.append([(e["site"], e["action"], e["n"]) for e in plan.log])
        counters.append((sup.counters["restarts"], sup.counters["faults"],
                         len(sink.chunks)))
    assert logs[0] == logs[1]
    assert counters[0] == counters[1]


def test_injected_permafault_exhausts_budget():
    """count=None fires on every call: the restart budget drains and the
    supervisor escalates with a structured report."""
    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        copy = CopyTransform(src)
        GatherSink(copy)
        sup = Supervisor(policy=RestartPolicy(max_restarts=2, backoff=0.01))
        plan = FaultPlan()
        plan.raise_at("block.on_data", block=copy.name, nth=0, count=None,
                      exc=InjectedFault)
        plan.attach(pipe)
        try:
            with pytest.raises(SupervisorEscalation) as exc_info:
                pipe.run(supervise=sup)
        finally:
            plan.detach()
    assert exc_info.value.report["reason"] == "restart budget exhausted"
    assert exc_info.value.report["block"] == copy.name
    assert sup.counters["restarts"] == 2
    # budget 2 -> the fault fired on the first try plus one per restart
    assert len(plan.fired(site="block.on_data")) == 3


def test_source_reserve_site_and_delay_action():
    """'source.reserve' aliases a reserve on a source's own output ring;
    a delay there perturbs pacing without corrupting the stream."""
    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        sink = GatherSink(src)
        plan = FaultPlan()
        plan.delay_at("source.reserve", 0.05, block=src.name, nth=0, count=2)
        plan.attach(pipe)
        try:
            pipe.run()
        finally:
            plan.detach()
    assert np.array_equal(np.concatenate(sink.chunks, axis=0), DATA)
    entries = plan.fired(site="source.reserve", block=src.name)
    assert [e["n"] for e in entries] == [0, 1]


def test_injected_ring_interrupt_is_absorbed_supervised():
    """An 'interrupt' action fires a generation at a ring mid-stream;
    supervised waiters treat the unattributed wakeup as collateral and
    the plan acknowledges it via a scripted 'call' — the stream
    completes losslessly."""
    acked = {}

    def ack_it(site, block, obj):
        # runs at the sink's next acquire, after the interrupt fired
        gen = acked.pop("gen", None)
        if gen is not None:
            acked["ring"].ack_interrupt(gen)

    def fire_it(site, block, obj):
        ring = getattr(obj, "base_ring", obj)
        acked["ring"] = ring
        acked["gen"] = ring.interrupt(target=999)

    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        sink = GatherSink(src)
        sup = Supervisor(policy=RestartPolicy(max_restarts=3, backoff=0.01))
        plan = FaultPlan()
        plan.call_at("ring.acquire", fire_it, block=sink.name, nth=2,
                     count=1)
        plan.call_at("ring.acquire", ack_it, block=sink.name, nth=3,
                     count=1)
        plan.attach(pipe)
        try:
            pipe.run(supervise=sup)
        finally:
            plan.detach()
    assert np.array_equal(np.concatenate(sink.chunks, axis=0), DATA)
    assert sup.counters["escalations"] == 0


def test_wedge_then_deadman_escalates_bounded():
    """A scripted wedge in on_data (outside any ring wait — the hung
    device call shape) trips the watchdog deadman; the interrupt cannot
    wake it, so the run escalates in bounded time."""
    release = threading.Event()
    entered = threading.Event()
    t0 = time.monotonic()
    try:
        with Pipeline() as pipe:
            src = array_source(DATA, 8)
            copy = CopyTransform(src)
            GatherSink(copy)
            sup = Supervisor(policy=RestartPolicy(max_restarts=2,
                                                  backoff=0.01),
                             heartbeat_interval_s=0.2, heartbeat_misses=3)
            plan = FaultPlan()
            plan.wedge_at("block.on_data", block=copy.name, nth=1,
                          release=release, entered=entered, timeout=60.0)
            plan.attach(pipe)
            try:
                with pytest.raises(SupervisorEscalation) as exc_info:
                    pipe.run(supervise=sup)
            finally:
                plan.detach()
    finally:
        release.set()
    assert entered.is_set()
    assert time.monotonic() - t0 < 60
    assert "unresponsive" in exc_info.value.report["reason"]
    assert sup.counters["deadman_interrupts"] >= 1


def test_quiesce_past_wedge_structured_report():
    """Pipeline.shutdown(timeout=) with one block wedged in on_data:
    returns within timeout + join_grace (+ slack), reports the wedged
    block as 'wedged' and the others as drained/interrupted, and the
    run still terminates."""
    release = threading.Event()
    entered = threading.Event()
    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        copy = CopyTransform(src)
        sink = GatherSink(copy)
        plan = FaultPlan()
        # Wedge the SINK inside on_data: not a ring wait, so the
        # deadline interrupt cannot wake it — the quiesce worst case.
        plan.wedge_at("block.on_data", block=sink.name, nth=1,
                      release=release, entered=entered, timeout=60.0)
        plan.attach(pipe)
        runner = threading.Thread(target=pipe.run, daemon=True)
        runner.start()
        try:
            assert entered.wait(20)
            t0 = time.monotonic()
            report = pipe.shutdown(timeout=1.0, join_grace=0.5)
            dt = time.monotonic() - t0
        finally:
            release.set()
        runner.join(30)
        plan.detach()
    assert not runner.is_alive()
    assert dt < 1.0 + 0.5 + 2.0          # timeout + grace + slack
    assert report.blocks[sink.name]["outcome"] == "wedged"
    assert not report.clean
    assert report.wedged == [sink.name]
    for name in (src.name, copy.name):
        assert report.blocks[name]["outcome"] in ("drained", "interrupted")
    assert report.elapsed_s <= dt + 0.1
    assert pipe.drain_report is report
    d = report.as_dict()
    assert d["clean"] is False and set(d["blocks"]) == {
        src.name, copy.name, sink.name}


def test_detach_restores_hooks():
    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        copy = CopyTransform(src)
        GatherSink(copy)
        plan = FaultPlan()
        plan.raise_at("block.on_data", block=copy.name, nth=0)
        plan.attach(pipe)
        assert "on_data" in copy.__dict__      # instance wrapper installed
        assert all(r._fault_hook is not None for r in pipe.rings)
        plan.detach()
        assert "on_data" not in copy.__dict__  # class lookup restored
        assert all(r._fault_hook is None for r in pipe.rings)


def test_udp_sites_arm_and_dispatch_through_capture_hook():
    """The udp.recv / capture.packet sites (24/7 service PR): arming
    wires the _udp_fault_hook seam of capture-shaped blocks at attach,
    dispatch fires the plan's actions, detach restores the seam."""
    import types

    from bifrost_tpu_torch.faultinject import SITES

    assert "udp.recv" in SITES and "capture.packet" in SITES

    block = types.SimpleNamespace(name="capture", _udp_fault_hook=None)
    pipe = types.SimpleNamespace(rings=[], blocks=[block])
    plan = FaultPlan(seed=1)
    plan.raise_at("udp.recv", block="capture", nth=1)
    plan.inject("capture.packet", "delay", block="capture", seconds=0.0,
                count=None)
    plan.attach(pipe)
    assert block._udp_fault_hook is not None
    # nth=0 recv call: seen but not fired
    block._udp_fault_hook("udp.recv", block)
    block._udp_fault_hook("capture.packet", block)
    # nth=1 recv call fires the raise
    with pytest.raises(InjectedFault):
        block._udp_fault_hook("udp.recv", block)
    log = [(e["site"], e["action"], e["n"]) for e in plan.log]
    assert ("udp.recv", "raise", 1) in log
    assert ("capture.packet", "delay", 0) in log
    plan.detach()
    assert block._udp_fault_hook is None


def test_udp_site_unknown_still_rejected():
    plan = FaultPlan()
    with pytest.raises(ValueError):
        plan.raise_at("udp.bogus")


def test_udp_recv_raise_through_a_capture_block():
    """A udp.recv raise through a real UDPCaptureBlock over loopback: one
    counted restart that ends only the current packet sequence; the
    engine begins a fresh sequence at the next packet and the sink, which
    kept its reader, sees it.  The raise is armed once the first
    sequence's frames reached the sink (a 'call' point whose function
    raises once), so it lands between the two packet bursts."""
    import struct

    from bifrost_tpu_torch.blocks.udp_capture import udp_capture
    from bifrost_tpu_torch.udp import UDPSocket, UDPTransmit

    payload = 64

    def header_cb(seq0):
        return seq0, {"_tensor": {
            "dtype": "u8", "shape": [-1, payload], "labels": ["time", "b"],
            "scales": [[0, 1], [0, 1]], "units": [None, None]}}

    class SeqSink(SinkBlock):
        def __init__(self, iring, **kwargs):
            super().__init__(iring, **kwargs)
            self.seqs = []      # (time_tag, [frames])

        def on_sequence(self, iseq):
            self.seqs.append((iseq.time_tag, []))

        def on_data(self, ispan):
            self.seqs[-1][1].append(np.array(ispan.data))

        def nframe(self):
            return sum(len(c) for _, cs in self.seqs for c in cs)

    rx = UDPSocket().bind("127.0.0.1", 0)
    rx.set_timeout(0.05)
    with Pipeline() as pipe:
        cap = udp_capture("simple", rx, 1, 0, payload, buffer_ntime=256,
                          slot_ntime=8, header_callback=header_cb,
                          name="capture")
        sink = SeqSink(cap, gulp_nframe=8)
    armed = threading.Event()
    fired = []

    def raise_once(site, block, obj):
        if armed.is_set() and not fired:
            fired.append(site)
            raise InjectedFault("udp.recv")

    plan = FaultPlan(seed=5)
    plan.call_at("udp.recv", raise_once, block="capture", count=None)
    plan.attach(pipe)
    sup = Supervisor(policy=RestartPolicy(max_restarts=3, backoff=0.01))
    runner = threading.Thread(target=pipe.run, kwargs={"supervise": sup},
                              daemon=True)
    runner.start()
    tx_sock = UDPSocket().connect("127.0.0.1", rx.port)
    tx = UDPTransmit(tx_sock)

    def send(seqs):
        for t in seqs:
            tx.send(struct.pack("<QHH", t, 0, 0) + bytes([t % 256]) * payload)

    def wait(pred, what):
        deadline = time.monotonic() + 10
        while not pred():
            assert time.monotonic() < deadline, what
            time.sleep(0.02)

    try:
        send(range(32))
        wait(lambda: sink.nframe() >= 16, "first sequence never arrived")
        armed.set()
        wait(lambda: sup.counters["restarts"] == 1, "no restart")
        send(range(1000, 1032))
        wait(lambda: len(sink.seqs) == 2 and sink.nframe() >= 32 + 16,
             "no fresh sequence downstream")
    finally:
        drain = pipe.shutdown(timeout=5.0)
        runner.join(timeout=10)
        plan.detach()
        rx.shutdown()
    assert drain.clean
    assert fired == ["udp.recv"]
    assert sup.counters["restarts"] == 1 and sup.counters["escalations"] == 0
    assert cap.nrestart_sequences == 1
    (t0, a), (t1, b) = sink.seqs
    assert (t0, t1) == (0, 1000)
    a, b = np.concatenate(a), np.concatenate(b)
    assert len(a) == 32 and len(b) == 32
    for t in range(32):
        assert (a[t] == t).all() and (b[t] == (1000 + t) % 256).all()


def test_egress_sites_fire_on_a_device_sink():
    """egress.stage / egress.drain fire on a staging DeviceSinkBlock's
    thread; a raise at the stage site is a counted restart, and the
    sink's output stays every gulp but the faulted one."""
    from bifrost_tpu_torch.blocks import copy
    from bifrost_tpu_torch.egress import DeviceSinkBlock

    class Sink(DeviceSinkBlock):
        def __init__(self, iring, **kwargs):
            super().__init__(iring, **kwargs)
            self.chunks = []

        def on_sink_sequence(self, iseq):
            pass

        def on_sink_data(self, arr, frame_offset):
            self.chunks.append(np.array(arr))

    with Pipeline() as pipe:
        src = array_source(DATA, 8)
        sink = Sink(copy(src, space="cuda"))
        sup = Supervisor(policy=RestartPolicy(max_restarts=3, backoff=0.01))
        plan = FaultPlan()
        plan.raise_at("egress.stage", block=sink.name, nth=2)
        plan.inject("egress.drain", "delay", block=sink.name, seconds=0.0,
                    count=None)
        plan.attach(pipe)
        try:
            pipe.run(supervise=sup)
        finally:
            plan.detach()
        assert sink._egress_fault_hook is None
    assert [e["n"] for e in plan.fired(site="egress.stage")] == [2]
    assert len(plan.fired(site="egress.drain")) == len(DATA) // 8 - 1
    out = np.concatenate(sink.chunks, axis=0)
    expect = np.concatenate([DATA[:16], DATA[24:]], axis=0)
    assert np.array_equal(out, expect)
    assert sup.counters["restarts"] == 1
