"""The socket-fed service specs of the port (bifrost_tpu_torch/service.py:
frb_search_spec, lwa_frb_search_spec, lwa_instrument_spec(sock=)) on the
CPU over loopback, against the JAX package's Service fed the same
packets and against the port's own replay Service.

Each run sends a schedule compiled by the port harness
(benchmarks_torch/frb_service.py) through the schedule walker at a rate
the kernel drops nothing at (asserted: nmissing == 0), waits for the
detect sink to go quiet, and stops the service, whose bounded quiesce
ends the capture and drains the chain.

Tolerances:
- FRB search: candidates equal in frame and DM row; SNR within 1e-5
  relative.  u8 power makes every FDMT sum an exact integer below 2**24,
  so the dedispersed frames agree exactly; the SNR's median and MAD
  scale are then an f32 division in XLA and in torch, a few ulps apart
  at most.
- The instrument over UDP: images bitwise the port's replay Service's
  (the same voltages reach the same ring bytes); against the JAX
  Service(sock=), 1e-5 of the image peak, the bound of
  test_torch_service.py's replay comparison (the capture adds no
  arithmetic).
"""

import gc
import importlib.util
import os
import time

import numpy as np
import pytest

from bifrost_tpu_torch import service
from bifrost_tpu_torch.udp import (TRANSMIT_RECORD_DTYPE, UDPSocket,
                                   UDPTransmit)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _jax_fft_method_default():
    """The JAX references run at the JAX package's default `fft_method`:
    tests/test_fusion.py's latch test sets it from a sink callback, and
    under load a call that lands after the latch is released succeeds and
    stays set in that process ('matmul', 4e-3 off the 'xla' images)."""
    from bifrost_tpu import config as jconfig
    jconfig.reset("fft_method")


def _port_harness():
    path = os.path.join(ROOT, "benchmarks_torch", "frb_service.py")
    spec = importlib.util.spec_from_file_location("torch_frb_service", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


H = _port_harness()


@pytest.fixture(scope="module", autouse=True)
def _collect_jax_services():
    """Collect this module's JAX Services before the next module runs: a
    JAX ProcLog unlinks its file when it is collected, so a block named
    'detect' collected later would delete the log of a live block of
    that name in another module's test (tests/test_service.py reads it)."""
    yield
    gc.collect()


def _rx(udp_mod):
    rx = udp_mod.UDPSocket().bind("127.0.0.1", 0)
    rx.set_timeout(0.05)
    return rx


def _send(port, slab, recs):
    """Walk one compiled schedule to 127.0.0.1:port; every datagram out."""
    tx_sock = UDPSocket().connect("127.0.0.1", port)
    tx = UDPTransmit(tx_sock)
    stats = tx.run_schedule(slab, recs, batch_npkt=16)
    assert stats["ndropped"] == 0, stats
    tx_sock.shutdown()
    return stats


def _quiet(count, timeout_s=30.0, settle_s=0.75):
    """Wait until `count()` stops advancing for `settle_s` seconds."""
    deadline = time.monotonic() + timeout_s
    last, last_t = count(), time.monotonic()
    while time.monotonic() < deadline:
        time.sleep(0.05)
        cur = count()
        if cur != last:
            last, last_t = cur, time.monotonic()
        elif time.monotonic() - last_t > settle_s:
            return
    raise AssertionError("the service never went quiet")


def _run(svc, rx, slab, recs, count):
    """-> (health, report, the service's health log) of one run; the
    health and its log are read while the service still runs."""
    svc.start()
    try:
        _send(rx.port, slab, recs)
        _quiet(count)
        health = svc.health()
        log = None
        if isinstance(svc, service.Service):        # the port's
            from bifrost_tpu_torch.proclog import load_by_pid
            svc._push_health()
            log = load_by_pid(os.getpid())[svc.pipeline.pname]["service"]
        report = svc.stop(timeout=30.0)
    finally:
        rx.shutdown()
    return health, report, log


# ------------------------------------------------------------ the geometry
def test_lwa_frb_search_spec_geometry_and_shards():
    """tests/test_service.py:323 on the port: 64 sources x 64-byte
    payloads = 4096 channels a frame, and a list of reuseport shard
    sockets gives one spec per shard (list in, list out) with identical
    stage chains."""
    rx = UDPSocket().bind("127.0.0.1", 0)
    spec = service.lwa_frb_search_spec(rx)
    cap = spec.stages[0]
    assert cap.kind == "capture"
    assert cap.params["nsrc"] == 64
    assert cap.params["max_payload_size"] == 64
    _tt, hdr = cap.params["header_callback"](0)
    assert hdr["_tensor"]["shape"] == [-1, 4096]
    assert [s.kind for s in spec.stages] == \
        ["capture", "transpose", "fdmt", "detect"]
    rx.shutdown()
    shards = [UDPSocket().bind("127.0.0.1", 0, reuseport=True)
              for _ in range(3)]
    try:
        specs = service.lwa_frb_search_spec(shards, threshold=9.0)
        assert len(specs) == 3
        for s in specs:
            assert s.stages[0].params["nsrc"] == 64
            assert [st.kind for st in s.stages] == \
                ["capture", "transpose", "fdmt", "detect"]
    finally:
        for s in shards:
            s.shutdown()


def test_sub_byte_packets_need_the_unported_unpack():
    """i4 packets: the spec inserts an unpack stage to i8 after the
    capture, with the JAX spec's stage list and parameters."""
    from bifrost_tpu import service as jservice
    for flag in (None, dict(algo="mad", window=16)):
        p = service.frb_search_spec(None, 1, 64, 4096, 16, 64, 16,
                                    packet_dtype="i4", rfi_flag=flag)
        j = jservice.frb_search_spec(None, 1, 64, 4096, 16, 64, 16,
                                     packet_dtype="i4", rfi_flag=flag)
        assert [s.kind for s in p.stages] == [s.kind for s in j.stages]
        assert p.stages[1].kind == "unpack"
        assert p.stages[1].params == j.stages[1].params == {"dtype": "i8"}
        hp = p.stages[0].params["header_callback"](0)[1]
        hj = j.stages[0].params["header_callback"](0)[1]
        assert hp == hj and hp["_tensor"]["shape"] == [-1, 128]


# ------------------------------------------------------- the FRB search
def _frb(pkg, slab, recs):
    if pkg == "port":
        from bifrost_tpu_torch import udp as udp_mod
        mod = service
    else:
        from bifrost_tpu import service as mod
        from bifrost_tpu import udp as udp_mod
    rx = _rx(udp_mod)
    cands = []
    spec = mod.frb_search_spec(
        rx, H.NSRC, H.PAYLOAD, buffer_ntime=H.BUFFER_NTIME,
        slot_ntime=H.SLOT_NTIME, gulp_nframe=H.GULP_NFRAME,
        max_delay=H.MAX_DELAY, threshold=8.0, on_candidate=cands.append)
    kw = {"device": "cpu"} if pkg == "port" else {}
    svc = mod.Service(spec, name=f"frb_sock_{pkg}", **kw)
    det = svc.blocks["detect"]
    health, report, log = _run(svc, rx, slab, recs,
                               lambda: det.frames_seen)
    return {"cands": cands, "health": health, "report": report, "svc": svc,
            "log": log}


@pytest.fixture(scope="module")
def frb_runs():
    events = H.build_schedule(3, 0, 1024)
    slab, recs, sent, _ = H.compile_schedule(events, 20_000)
    return sent, {pkg: _frb(pkg, slab, recs) for pkg in ("port", "jax")}


def test_frb_search_spec_matches_the_jax_service(frb_runs):
    sent, runs = frb_runs
    p, j = runs["port"], runs["jax"]
    for r in (p, j):
        assert r["report"].exit_code == service.EXIT_CLEAN
        led = r["report"].ledger
        assert led["lost_frames"] == led["duplicated_frames"] == 0
        assert led["committed_frames"] == sent - H.MAX_DELAY
    assert len(p["cands"]) == len(j["cands"]) >= 3   # the bursts
    for a, b in zip(p["cands"], j["cands"]):
        assert (a["frame"], a["dm_index"]) == (b["frame"], b["dm_index"])
        assert abs(a["snr"] - b["snr"]) <= TOL * abs(b["snr"])


def test_frb_search_spec_rings_and_health(frb_runs):
    """The rings are the capture's 'system' space, as the reference
    builds them; health()['capture'] carries the engine's counters, and
    the health push their `capture_*` keys."""
    sent, runs = frb_runs
    p = runs["port"]
    svc = p["svc"]
    assert {r.space for r in svc.pipeline.rings} == {"system"}
    cap = p["health"]["capture"]
    assert set(cap) == {"ngood", "nmissing", "ninvalid", "nlate", "nrepeat"}
    assert cap["nmissing"] == cap["ninvalid"] == cap["nlate"] == 0
    assert cap["ngood"] > 0
    assert set(runs["jax"]["health"]["capture"]) == set(cap)
    assert {f"capture_{k}" for k in cap} <= set(p["log"])


def test_i4_frb_search_over_udp_matches_replay():
    """i4 packets over loopback: the capture's packed bytes go through
    the spec's unpack stage (i4 -> i8, 2 channels a byte) and the FDMT;
    nothing is lost, and the candidates are those of
    `frb_search_pipeline` replaying the same values as i8."""
    from bifrost_tpu_torch import udp as udp_mod
    from bifrost_tpu_torch.ops.unpack import unpack as p_unpack
    import torch
    nframe = 1024

    def payload(t):
        # The harness's noise rows, and a positive i4 burst (7, 7 a
        # byte) on the frames where its u8 burst sits.
        if t % H.BURST_PERIOD < H.BURST_LEN:
            return b"\x77" * H.PAYLOAD
        return H.frame_payload(t)

    pkts = [H.HDR.pack(t, 0, 0) + payload(t) for t in range(nframe)]
    size = len(pkts[0])
    slab = b"".join(pkts)
    recs = udp_mod.pack_transmit_records(
        [(k * size, size, k * 50_000) for k in range(nframe)])
    sent = nframe
    rx = _rx(udp_mod)
    cands = []
    spec = service.frb_search_spec(
        rx, H.NSRC, H.PAYLOAD, buffer_ntime=H.BUFFER_NTIME,
        slot_ntime=H.SLOT_NTIME, gulp_nframe=H.GULP_NFRAME,
        max_delay=H.MAX_DELAY, threshold=8.0, packet_dtype="i4",
        on_candidate=cands.append)
    svc = service.Service(spec, name="frb_sock_i4", device="cpu")
    det = svc.blocks["detect"]
    health, report, _ = _run(svc, rx, slab, recs, lambda: det.frames_seen)
    assert report.exit_code == service.EXIT_CLEAN
    assert health["capture"]["nmissing"] == 0
    assert report.ledger["lost_frames"] == 0
    assert report.ledger["committed_frames"] == sent - H.MAX_DELAY
    packed = np.stack([np.frombuffer(payload(t), np.uint8)
                       for t in range(nframe)])
    vals = p_unpack(torch.from_numpy(packed), "i4").numpy()
    assert vals.shape == (nframe, 2 * H.NSRC * H.PAYLOAD)
    want = []
    pipe, _, _ = service.frb_search_pipeline(
        vals, H.GULP_NFRAME, H.MAX_DELAY, f0_mhz=60.0, df_mhz=0.024,
        threshold=8.0, device="cpu", on_candidate=want.append)
    pipe.run()
    assert len(cands) == len(want) > 0
    for a, b in zip(cands, want):
        assert (a["frame"], a["dm_index"]) == (b["frame"], b["dm_index"])
        assert abs(a["snr"] - b["snr"]) <= TOL * abs(b["snr"])


# --------------------------------------------- the instrument over UDP
GEOM = dict(nstand=3, npol=2, nchan=4, ntap=4, n_int=3, nbeam=2, ngrid=16,
            max_delay=4)
NINT = 8
NSRC, PAYLOAD = 3, 4      # 3 packets of 4 bytes: one 3 x 2 ci8 frame


def _voltages(seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 8, (NINT * GEOM["n_int"] * GEOM["nchan"],
                                GEOM["nstand"], GEOM["npol"], 2)) \
        .astype(np.int8)


def _voltage_schedule(volt, rate_pps):
    """Each frame as NSRC 'simple' packets (seq = frame, src = station)."""
    raw = volt.reshape(len(volt), NSRC, PAYLOAD)
    pkt = np.zeros((len(volt), NSRC), dtype=[("seq", "<u8"), ("src", "<u2"),
                                              ("pad", "<u2"),
                                              ("payload", "u1", PAYLOAD)])
    pkt["seq"] = np.arange(len(volt))[:, None]
    pkt["src"] = np.arange(NSRC)[None, :]
    pkt["payload"] = raw
    n = pkt.size
    size = pkt.dtype.itemsize
    recs = np.zeros(n, dtype=TRANSMIT_RECORD_DTYPE)
    recs["offset"] = np.arange(n) * size
    recs["size"] = size
    recs["t_ns"] = np.arange(n) * int(1e9 / rate_pps)
    return pkt.tobytes(), recs


def _instrument_sock(pkg, volt, capture):
    images = []
    if pkg == "port":
        from bifrost_tpu_torch import udp as udp_mod
        rx = _rx(udp_mod)
        spec = service.lwa_instrument_spec(
            sock=rx, capture=capture, threshold=2.0,
            on_image=lambda d: images.append(d.numpy().copy()), **GEOM)
        svc = service.Service(spec, name="e2e_sock_port", device="cpu")
    else:
        from bifrost_tpu import service as jservice
        from bifrost_tpu import udp as udp_mod
        rx = _rx(udp_mod)
        spec = jservice.lwa_instrument_spec(
            sock=rx, capture=capture, threshold=2.0, pallas_interpret=True,
            on_image=lambda d: images.append(np.array(d)), **GEOM)
        svc = jservice.Service(spec, name="e2e_sock_jax")
    slab, recs = _voltage_schedule(volt, 10_000)
    health, report, _ = _run(svc, rx, slab, recs, lambda: len(images))
    return {"images": images, "health": health, "report": report}


def test_instrument_over_udp_matches_replay_and_jax():
    volt = _voltages()
    # The port at the spec's default slot (16 frames, not a multiple of
    # nchan: its header names the spec's gulp, module docstring)...
    p = _instrument_sock("port", volt, dict(nsrc=NSRC,
                                            max_payload_size=PAYLOAD))
    # ...its replay Service on the same voltages...
    images = []
    spec = service.lwa_instrument_spec(
        voltages=volt, threshold=2.0,
        on_image=lambda d: images.append(d.numpy().copy()), **GEOM)
    rsvc = service.Service(spec, name="e2e_replay_port", device="cpu")
    rsvc.start()
    assert rsvc.wait(timeout=120)
    assert rsvc.stop().exit_code == service.EXIT_CLEAN
    # ...and the JAX Service(sock=), whose capture needs a slot of whole
    # spectra (slot_ntime = nchan) to reach the PFB.
    j = _instrument_sock("jax", volt, dict(nsrc=NSRC,
                                           max_payload_size=PAYLOAD,
                                           slot_ntime=GEOM["nchan"]))
    cap = p["health"]["capture"]
    assert cap["ngood"] > 0
    assert cap["nmissing"] == cap["ninvalid"] == cap["nlate"] == 0
    assert p["report"].exit_code == service.EXIT_CLEAN
    assert len(p["images"]) == len(images) == len(j["images"]) == NINT
    for a, b, c in zip(p["images"], images, j["images"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        a = a.reshape(c.shape)
        assert np.isfinite(a).all()
        assert np.abs(a - c).max() <= TOL * np.abs(c).max()


def test_instrument_capture_geometry_is_checked():
    rx = UDPSocket().bind("127.0.0.1", 0)
    try:
        spec = service.lwa_instrument_spec(
            sock=rx, capture=dict(nsrc=2, max_payload_size=4), **GEOM)
        with pytest.raises(ValueError, match="nsrc\\*max_payload_size"):
            service.Service(spec, name="e2e_badgeom", device="cpu")
        with pytest.raises(ValueError, match="exactly one"):
            service.lwa_instrument_spec(voltages=_voltages(), sock=rx,
                                        **GEOM)
    finally:
        rx.shutdown()


def test_four_lwa_frb_search_services_share_one_reuseport_port():
    """ROADMAP item 18 as four Services: `lwa_frb_search_spec` of four
    sockets bound to one port with SO_REUSEPORT, each spec run as a
    Service of its own (the LWA's 64 sources x 64 B, 4096 channels; a
    small gulp and FDMT depth), fed by four sender flows of 16 sources
    each over 128 frames.  The kernel's flow hash picks each flow's
    shard; every packet lands once across the four (Σ ngood = sent, no
    repeats), every Service stops with exit code 0, and each reports its
    own capture counters in `health()["capture"]`.  Each flow's sender
    is one the kernel hashes to a shard of its own
    (`udp.reuseport_senders`): a Service whose shard never sees a packet
    never initializes its chain, and a stop cannot drain it."""
    from bifrost_tpu_torch.udp import pack_transmit_records, reuseport_senders
    nshard, nsrc, payload, nframe = 4, 64, 64, 128
    per = nsrc // nshard
    rx0 = UDPSocket().bind("127.0.0.1", 0, reuseport=True)
    rxs = [rx0] + [UDPSocket().bind("127.0.0.1", rx0.port, reuseport=True)
                   for _ in range(nshard - 1)]
    for rx in rxs:
        rx.set_timeout(0.05)
    specs = service.lwa_frb_search_spec(rxs, gulp_nframe=32, max_delay=16,
                                        slot_ntime=64)
    svcs = [service.Service(s, name=f"fan{i}", device="cpu")
            for i, s in enumerate(specs)]
    senders = reuseport_senders(rxs)
    rng = np.random.default_rng(23)
    data = rng.integers(0, 32, (nframe, nsrc * payload)).astype(np.uint8)
    txs = []
    for svc in svcs:
        svc.start()
    try:
        for g in range(nshard):
            pkt = np.empty((nframe, per), dtype=[
                ("seq", "<u8"), ("src", "<u2"), ("pad", "<u2"),
                ("payload", "u1", payload)])
            pkt["seq"] = np.arange(nframe)[:, None]
            pkt["src"] = np.arange(g * per, (g + 1) * per)[None, :]
            pkt["pad"] = 0
            pkt["payload"] = data[:, g * per * payload:
                                  (g + 1) * per * payload].reshape(
                nframe, per, payload)
            size = pkt.dtype.itemsize
            recs = pack_transmit_records(
                (k * size, size, k * 100_000) for k in range(pkt.size))
            tx = UDPTransmit(senders[g])
            tx.start_schedule(pkt.tobytes(), recs, batch_npkt=16)
            txs.append((senders[g], tx))
        walks = [tx.wait_schedule() for _s, tx in txs]
        _quiet(lambda: [svc.blocks["capture"].stats for svc in svcs])
        health = [svc.health()["capture"] for svc in svcs]
        reports = [svc.stop(timeout=30.0) for svc in svcs]
    finally:
        for s, _tx in txs:
            s.shutdown()
        for rx in rxs:
            rx.shutdown()
    stats = [svc.blocks["capture"].final_stats for svc in svcs]
    sent = sum(w["nsent"] for w in walks)
    assert sent == nframe * nsrc and not any(w["ndropped"] for w in walks)
    assert sum(st["ngood"] for st in stats) == sent, stats
    assert all(st["nrepeat"] == 0 and st["ninvalid"] == 0 for st in stats)
    assert all(r.exit_code == 0 for r in reports), reports
    assert len(health) == nshard and all(h is not None for h in health)
    assert [st["ngood"] for st in stats] == [per * nframe] * nshard
