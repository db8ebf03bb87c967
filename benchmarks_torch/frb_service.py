#!/usr/bin/env python3
"""24/7 FRB-search service of the PyTorch/CUDA port: bursty-traffic replay
+ chaos harness (the port's copy of benchmarks/frb_service.py).

Drives the REAL capture socket of a `bifrost_tpu_torch.service.Service`
(capture -> transpose -> FDMT -> candidate detect, the paper's LWA-style
L3 deployment as a service) with a SCRIPTED, SEEDED traffic generator,
orchestrated together with seeded `faultinject.FaultPlan`s so one whole
chaos scenario — traffic shape AND injected faults — replays
deterministically from a single seed.

Traffic shapes (composable per scenario):
  - packet-rate ramps (per-segment pacing),
  - drop storms (contiguous sequence ranges plus seeded random loss),
  - reordered / duplicated packets (seeded local swaps and repeats),
  - malformed / truncated streams (runt headers, wrong payload sizes,
    garbage datagrams — the capture engine's ninvalid paths),
  - source flap (wall-clock silence plus a packet-sequence jump the
    engine zero-fills).

Fault injection (the supervise/faultinject seams):
  - `capture.packet` / `udp.recv` raises -> capture-tier restarts
    (sequence teardown + fresh sequence at the next packet),
  - `block.on_data` raises on compute stages -> compute-tier restarts,
  - wedge + deadman on FDMT -> heartbeat miss, generation interrupt,
    counted restart (the release is event-driven off the supervisor's
    own `deadman_interrupt` event — no timing lottery),
  - restart-budget edge on the detect tier -> the service DEGRADES
    (threshold raise through the existing shed/record paths) instead of
    escalating.

Per scenario the harness reports sustained packets/s (sent and
capture-ingested), candidates/s, p50/p99 restart recovery time (from
`Supervisor.recovery_stats()`), the supervise counters, the service
frame-continuity ledger, and the exit report.  A `replay_signature`
(FaultPlan firing log + restart-event kinds + continuity invariants +
the traffic schedule hash) is the determinism contract: same seed ->
same signature.

The traffic generator, the schedule compiler and the scenario matrix are
the JAX harness's, byte for byte, so a seed gives the same schedule (and
`schedule_hash`) in both.  The service runs on the card unless
`--device cpu` is given: the FDMT (kernel K1) and, in rfi_storm, the
flagger (K5a) run there on gulps staged from the capture's host rings.

Usage:
    python benchmarks_torch/frb_service.py           # soak + fault mix,
                                                     # one JSON line
    python benchmarks_torch/frb_service.py --scenario drop_storm --seed 7
    python benchmarks_torch/frb_service.py --seconds 30 --rate 8000
    python benchmarks_torch/frb_service.py --check   # chaos matrix
    python benchmarks_torch/frb_service.py --check --device cpu

`--check` runs the seeded scenario matrix (clean, drop storm,
malformed stream, reorder+dup+flap, wedge+deadman, restart storm,
restart-budget edge) with short traffic scripts and asserts the
invariants that must hold REGARDLESS of timing: zero committed-frame
loss, zero duplication, expected fault/recovery/degrade accounting,
expected exit codes, and seed-replay determinism (the restart-storm
scenario runs twice and must produce identical signatures).  Timing
numbers are reported but never asserted.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import socket as pysock
import struct
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bifrost_tpu_torch.faultinject import FaultPlan  # noqa: E402
from bifrost_tpu_torch.service import Service, frb_search_spec  # noqa: E402
from bifrost_tpu_torch.udp import (UDPSocket, UDPTransmit,  # noqa: E402
                                   pack_transmit_records)

# Chain geometry (small enough for CI, real enough to dedisperse).
PAYLOAD = 64          # bytes per packet = u8 power samples per frame
NSRC = 1
NCHAN = PAYLOAD * NSRC
SLOT_NTIME = 16
BUFFER_NTIME = 4096   # absorbs first-gulp compile stalls without
                      # back-pressuring the socket into kernel drops
GULP_NFRAME = 64
MAX_DELAY = 16
BURST_PERIOD = 256    # one injected burst per this many frames
BURST_LEN = 3
HDR = struct.Struct("<QHH")

# Default replay rate.  The original Python sender topped out around
# 2.6k pkts/s (one sendto + a pacing sleep every 8th event, all in the
# interpreter); the C schedule walker (UDPTransmit.run_schedule) paces
# from pre-compiled records with zero Python per packet, so the chaos
# matrix now replays at wire-ish rates by default.
DEFAULT_RATE_PPS = 50_000


# --------------------------------------------------------------- traffic
def frame_payload(t, rfi=None):
    """Deterministic per-frame filterbank row: pseudo-noise plus a
    bright burst every BURST_PERIOD frames (no RNG: content must be a
    pure function of the frame index so replays and partial deliveries
    stay comparable).

    `rfi` is an optional per-frame RFI spec
    (on_channels, nb_amp, impulse_amp, broad_amp) rendered ON TOP of
    the clean row — broadband lift first (saturating add), then
    narrowband carrier overwrites, then a full-band impulse overwrite.
    The spec rides the SCHEDULE (build_schedule), so RFI placement is
    seed-deterministic and covered by schedule_hash."""
    row = ((t * 7 + 13 * np.arange(NCHAN)) % 23 + 10).astype(np.uint8)
    if t % BURST_PERIOD < BURST_LEN:
        row[:] = 250
    if rfi is not None:
        chans, nb_amp, impulse_amp, broad_amp = rfi
        if broad_amp:
            row = np.minimum(row.astype(np.int32) + int(broad_amp),
                             255).astype(np.uint8)
        if chans:
            row[list(chans)] = nb_amp
        if impulse_amp:
            row[:] = impulse_amp
    return row.tobytes()


def build_schedule(seed, first_frame, nframes, drop_ranges=(),
                   drop_p=0.0, dup_p=0.0, reorder_p=0.0,
                   malform_every=0, flaps=(), rfi=None):
    """-> deterministic event list for the sender.

    Events: ('pkt', seq[, rfi_spec]) | ('runt', seq) | ('badsize', seq)
    | ('garbage', seq) | ('pause', seconds, seq_jump).  All randomness
    is consumed HERE, from one seeded RNG, at build time — the sender
    just walks the list, so the wire schedule is a pure function of the
    arguments.

    `rfi`: optional storm recipe dict — n_storm narrowband channels
    picked from the seeded RNG blink on with probability p_on per frame
    at amplitude nb_amp; a full-band impulse of impulse_amp fires every
    impulse_every frames (phase-offset from the bursts); frames in
    broad_range get a broadband lift of broad_amp.  The resolved
    per-frame spec is embedded in the 'pkt' event, so schedule_hash
    (and therefore the replay signature) covers the storm exactly."""
    rng = random.Random(seed)
    flaps = dict(flaps)  # {frame index: (pause_s, seq_jump)}
    storm = ()
    if rfi is not None:
        rfi = dict(rfi)
        storm = tuple(sorted(rng.sample(range(NCHAN),
                                        rfi.get("n_storm", 48))))
    events = []
    jump = 0
    for i in range(nframes):
        t = first_frame + i + jump
        if i in flaps:
            pause_s, seq_jump = flaps[i]
            events.append(("pause", pause_s, seq_jump))
            jump += seq_jump
            t += seq_jump
        if any(a <= i < b for a, b in drop_ranges):
            continue
        if drop_p and rng.random() < drop_p:
            continue
        if rfi is not None:
            on = tuple(c for c in storm
                       if rng.random() < rfi.get("p_on", 0.8))
            every = rfi.get("impulse_every", 0)
            imp = rfi.get("impulse_amp", 255) \
                if every and i % every == every // 2 else 0
            lo, hi = rfi.get("broad_range", (0, 0))
            br = rfi.get("broad_amp", 0) if lo <= i < hi else 0
            if on or imp or br:
                events.append(("pkt", t,
                               (on, rfi.get("nb_amp", 255), imp, br)))
            else:
                events.append(("pkt", t))
        else:
            events.append(("pkt", t))
        if malform_every and i % malform_every == malform_every - 1:
            events.append((("runt", "badsize", "garbage")[rng.randrange(3)],
                           t))
        if dup_p and rng.random() < dup_p:
            events.append(("pkt", t))
        if reorder_p and rng.random() < reorder_p and len(events) >= 2 \
                and events[-1][0] == "pkt" and events[-2][0] == "pkt":
            events[-1], events[-2] = events[-2], events[-1]
    return events


def schedule_hash(events):
    h = hashlib.sha256()
    for ev in events:
        h.update(repr(ev).encode())
    return h.hexdigest()[:16]


def send_schedule(tx, addr, events, rate_pps):
    """Walk the event list against the wire.  -> (packets_sent,
    malformed_sent, wall_seconds)."""
    interval = 8.0 / rate_pps if rate_pps else 0.0
    sent = malformed = 0
    t0 = time.perf_counter()
    for i, ev in enumerate(events):
        kind = ev[0]
        if kind == "pause":
            time.sleep(ev[1])
            continue
        t = ev[1]
        if kind == "pkt":
            rfi_spec = ev[2] if len(ev) > 2 else None
            tx.sendto(HDR.pack(t, 0, 0) + frame_payload(t, rfi_spec), addr)
            sent += 1
        elif kind == "runt":
            tx.sendto(HDR.pack(t, 0, 0)[:6], addr)          # truncated hdr
            malformed += 1
        elif kind == "badsize":
            tx.sendto(HDR.pack(t, 0, 0) + b"\x55" * (PAYLOAD // 2), addr)
            malformed += 1
        elif kind == "garbage":
            tx.sendto(b"\xde\xad\xbe\xef" * 3, addr)
            malformed += 1
        if interval and i % 8 == 7:
            time.sleep(interval)
    return sent, malformed, time.perf_counter() - t0


def render_event(ev):
    """One schedule event -> its exact wire datagram (None for pauses).
    Byte-for-byte the datagrams `send_schedule` emits: the C-paced
    replay path compiles these into a slab, so malformed shapes (runt /
    badsize / garbage) and RFI-spec payloads ride the schedule bitwise
    identically to the Python sender."""
    kind = ev[0]
    if kind == "pause":
        return None
    t = ev[1]
    if kind == "pkt":
        rfi_spec = ev[2] if len(ev) > 2 else None
        return HDR.pack(t, 0, 0) + frame_payload(t, rfi_spec)
    if kind == "runt":
        return HDR.pack(t, 0, 0)[:6]                    # truncated hdr
    if kind == "badsize":
        return HDR.pack(t, 0, 0) + b"\x55" * (PAYLOAD // 2)
    if kind == "garbage":
        return b"\xde\xad\xbe\xef" * 3
    raise ValueError(f"unknown schedule event {ev!r}")


def compile_schedule(events, rate_pps):
    """Compile an event list into a C walker schedule: ONE payload slab
    plus packed (offset, size, t_ns) records (udp.TRANSMIT_RECORD_DTYPE).

    Pacing lives in the timestamps: wire datagram k fires at
    k * 1e9/rate_pps ns plus every preceding 'pause' rendered as a gap
    (rate_pps 0/None -> all-zero spacing = blast).  Loss/dup/reorder/
    malformed shapes are already baked into the EVENT ORDER and bytes by
    build_schedule, so the compiled schedule — and therefore the wire —
    stays a pure function of (seed, kwargs, rate): schedule_hash and the
    replay signature are unchanged by which sender walks it.

    -> (slab_bytes, records_bytes, packets, malformed)
    """
    interval_ns = int(round(1e9 / rate_pps)) if rate_pps else 0
    chunks, recs = [], []
    off = pause_ns = k = 0
    sent = malformed = 0
    for ev in events:
        pkt = render_event(ev)
        if pkt is None:                  # pause: a gap in the timeline
            pause_ns += int(ev[1] * 1e9)
            continue
        if ev[0] == "pkt":
            sent += 1
        else:
            malformed += 1
        chunks.append(pkt)
        recs.append((off, len(pkt), pause_ns + k * interval_ns))
        off += len(pkt)
        k += 1
    return b"".join(chunks), pack_transmit_records(recs), sent, malformed


def send_schedule_c(tx, events, rate_pps, batch_npkt=64):
    """C-paced replay: compile once, hand the slab+records to the
    pinned C schedule walker (sendmmsg batches + token-bucket pacing,
    zero Python per packet).  Same signature contract as
    `send_schedule`: -> (packets_sent, malformed_sent, wall_seconds).

    `tx` is a `UDPTransmit` over a CONNECTED socket (the scenario's
    capture address).  A walker drop (EAGAIN budget exhausted — not a
    scripted drop, those never reach the slab) breaks replay
    determinism, so it raises instead of skewing the signature."""
    slab, recs, sent, malformed = compile_schedule(events, rate_pps)
    if not recs:
        return 0, 0, 0.0
    stats = tx.run_schedule(slab, recs, batch_npkt=batch_npkt)
    if stats["ndropped"]:
        raise RuntimeError(
            f"paced replay dropped {stats['ndropped']} datagrams after "
            f"retry budget (nsent={stats['nsent']} nretry={stats['nretry']})")
    return sent, malformed, stats["wall_s"]


# --------------------------------------------------------------- harness
def _open_capture_socket():
    rx = UDPSocket().bind("127.0.0.1", 0)
    rx.set_timeout(0.05)
    return rx, rx.port


def _wait_frames(svc, at_least, timeout_s):
    det = svc.blocks["detect"]
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if det.frames_seen >= at_least:
            return True
        time.sleep(0.05)
    return False


def _wait_quiescent(svc, timeout_s, settle_s=0.75):
    """Wait until the detect sink's frame count stops advancing."""
    det = svc.blocks["detect"]
    deadline = time.monotonic() + timeout_s
    last, last_t = det.frames_seen, time.monotonic()
    while time.monotonic() < deadline:
        time.sleep(0.1)
        cur = det.frames_seen
        if cur != last:
            last, last_t = cur, time.monotonic()
        elif time.monotonic() - last_t > settle_s:
            return True
    return False


def _burst_aligned(frame):
    """True when a candidate's frame index lands in the window where an
    injected burst (plus FDMT's <= MAX_DELAY dedispersion shift) can
    legitimately peak — the storm scenarios count RECOVERED bursts, not
    false positives."""
    ph = frame % BURST_PERIOD
    return ph < BURST_LEN + MAX_DELAY + 8 or \
        ph >= BURST_PERIOD - (MAX_DELAY + 4)


def run_scenario(name, seed=0, frames=1024, rate_pps=DEFAULT_RATE_PPS,
                 traffic_kwargs=None, arm=None, spec_kwargs=None,
                 threshold=8.0, warmup_frames=256, drain_timeout=10.0,
                 use_c_sender=True, device=None):
    """Run one scripted scenario end to end.  -> result dict.

    The service is WARMED first (clean traffic until the detect sink has
    processed a gulp — first-use compiles happen here), then the seeded
    chaos schedule plays.  Faults armed via `arm(plan, svc, ctl)` fire
    against the warmed steady state, so their nth-indices land on
    deterministic gulps.

    `use_c_sender=True` (default) replays the compiled schedule through
    the C walker at `rate_pps`; False keeps the original Python sendto
    loop (parity baseline — the wire bytes and the replay signature are
    identical either way, only the pacing engine differs).

    `device`: None runs the service on the card, 'cpu' on the CPU."""
    traffic_kwargs = dict(traffic_kwargs or {})
    spec_kwargs = dict(spec_kwargs or {})
    rx, port = _open_capture_socket()
    cands = []
    spec = frb_search_spec(rx, NSRC, PAYLOAD, buffer_ntime=BUFFER_NTIME,
                           slot_ntime=SLOT_NTIME, gulp_nframe=GULP_NFRAME,
                           max_delay=MAX_DELAY, threshold=threshold,
                           on_candidate=cands.append, **spec_kwargs)
    svc = Service(spec, name=f"frb_{name}", device=device)
    plan = FaultPlan(seed=seed)
    ctl = {"events": [], "release": threading.Event(),
           "entered": threading.Event()}

    def observe(ev):
        ctl["events"].append((ev.kind, ev.block))
        # Release a parked wedge only once it has actually ENTERED: a
        # spurious early deadman (e.g. a slow first compile tripping a
        # tight test watchdog) must not pre-release the wedge and turn
        # the scenario into a no-op.
        if ev.kind == "deadman_interrupt" and ctl["entered"].is_set():
            ctl["release"].set()

    svc.on_event(observe)
    if arm is not None:
        arm(plan, svc, ctl)
    if plan.points:
        plan.attach(svc.pipeline)
    if use_c_sender:
        tx_sock = UDPSocket().connect("127.0.0.1", port)
        tx = UDPTransmit(tx_sock)

        def _send(events):
            return send_schedule_c(tx, events, rate_pps)

        def _close_tx():
            try:
                tx_sock.shutdown()
            except Exception:
                pass
    else:
        tx = pysock.socket(pysock.AF_INET, pysock.SOCK_DGRAM)
        addr = ("127.0.0.1", port)

        def _send(events):
            return send_schedule(tx, addr, events, rate_pps)

        _close_tx = tx.close
    try:
        svc.start()
        # Warmup: clean traffic; blocks initialize and jit-compile.
        warm = build_schedule(seed, 0, warmup_frames)
        _send(warm)
        warmed = _wait_frames(svc, GULP_NFRAME, timeout_s=30.0)
        # The scripted chaos phase.
        events = build_schedule(seed, warmup_frames, frames,
                                **traffic_kwargs)
        sent, malformed, send_s = _send(events)
        _wait_quiescent(svc, drain_timeout)
        mid_health = svc.health()
        report = svc.stop()
    finally:
        _close_tx()
        if plan.points:
            plan.detach()
        try:
            rx.shutdown()
        except Exception:
            pass
    det = svc.blocks["detect"]
    cap_stats = mid_health.get("capture")
    counters = report.counters
    recovery = report.recovery
    rep = report.as_dict()
    firing_log = [(e["site"], e["block"], e["action"], e["n"])
                  for e in plan.log]
    restart_kinds = [
        (r["block"], r.get("restart_kind", "resume"),
         int(r.get("shed_nframe", 0)))
        for r in svc.ledger.restarts]
    result = {
        "scenario": name,
        "seed": seed,
        "sender": "c_sched" if use_c_sender else "python",
        "device": str(svc.pipeline.device),
        "rate_pps": rate_pps,
        "warmed": warmed,
        "schedule_hash": schedule_hash(events),
        "packets_sent": sent,
        "malformed_sent": malformed,
        "send_wall_s": round(send_s, 3),
        "packets_per_sec_sent": round(sent / send_s, 1) if send_s else None,
        "capture": cap_stats,
        "frames_processed": det.frames_seen,
        "candidates": det.ncandidates,
        "candidates_per_sec": round(
            det.ncandidates / rep["uptime_s"], 3) if rep["uptime_s"] else 0,
        "counters": counters,
        "recovery_p50_s": recovery["p50_s"],
        "recovery_p99_s": recovery["p99_s"],
        "recovery_count": recovery["count"],
        "ledger": rep["ledger"],
        "exit_code": report.exit_code,
        "exit_state": report.state,
        "degrade_episodes": rep["degrade_episodes"],
        "drain_clean": rep["drain"]["clean"] if rep["drain"] else None,
        "firing_log": firing_log,
        "restart_kinds": restart_kinds,
        "burst_candidates": sum(_burst_aligned(c["frame"]) for c in cands),
    }
    flag = svc.blocks.get("flag")
    if flag is not None:
        result["flagged_fraction"] = round(flag.flagged_fraction, 4)
        result["baseline_resets"] = flag.baseline_resets
    result["replay_signature"] = {
        "schedule_hash": result["schedule_hash"],
        "firing_log": firing_log,
        "restart_kinds": restart_kinds,
        "lost_frames": rep["ledger"]["lost_frames"],
        "duplicated_frames": rep["ledger"]["duplicated_frames"],
        "restart_shed_frames": rep["ledger"]["restart_shed_frames"],
    }
    return result


# -------------------------------------------------------------- scenarios
def _arm_none(plan, svc, ctl):
    pass


def _arm_restart_storm(plan, svc, ctl):
    # Two tiers, both keyed to GULP indices (pure stream position, so
    # the firing order is pinned by pipeline causality and the replay
    # signature is seed-deterministic): FDMT's 9th on_data, then the
    # detect sink's 13th.  Capture-tier restarts are exercised in
    # reorder_dup_flap — recv-WINDOW counts depend on socket batching,
    # which is wall-clock, not stream, position.
    plan.raise_at("block.on_data", block="fdmt", nth=8)
    plan.raise_at("block.on_data", block="detect", nth=12)


def _arm_capture_flap(plan, svc, ctl):
    # Capture-tier fault mid-flap-scenario: the packet sequence tears
    # down cleanly and a fresh one begins at the next packet.
    plan.raise_at("capture.packet", block="capture", nth=30)


def _arm_wedge_deadman(plan, svc, ctl):
    # Park FDMT's on_data outside any ring wait; the supervisor's
    # deadman_interrupt event releases it (event-driven, no sleep
    # scripting).  The pending generation then surfaces at FDMT's next
    # ring call as a counted deadman restart.
    plan.wedge_at("block.on_data", block="fdmt", nth=6,
                  release=ctl["release"], entered=ctl["entered"],
                  timeout=60.0)


def _arm_budget_edge(plan, svc, ctl):
    # Two detect-tier faults against max_restarts=3 / margin 1: after
    # the second restart the remaining budget hits the margin and the
    # service must DEGRADE (threshold raise), not escalate.
    plan.raise_at("block.on_data", block="detect", nth=4, count=2)


# The RFI-storm recipe: most of the band blinks with strong narrowband
# carriers, full-band impulses fire between bursts, and a broadband
# lift covers one stretch — drowning the injected bursts unless the
# data-quality plane excises the storm (the rfi_storm scenario's
# flagged-vs-unflagged comparison in --check).
RFI_STORM = dict(n_storm=60, p_on=0.8, nb_amp=255,
                 impulse_every=128, impulse_amp=255,
                 broad_range=(300, 330), broad_amp=60)

SCENARIOS = {
    "clean": dict(arm=_arm_none, traffic_kwargs={}),
    "drop_storm": dict(arm=_arm_none, traffic_kwargs=dict(
        drop_ranges=((256, 384),), drop_p=0.02)),
    "malformed_stream": dict(arm=_arm_none, traffic_kwargs=dict(
        malform_every=17)),
    "reorder_dup_flap": dict(arm=_arm_capture_flap, traffic_kwargs=dict(
        dup_p=0.05, reorder_p=0.1, flaps={512: (0.4, 64)})),
    "wedge_deadman": dict(arm=_arm_wedge_deadman, traffic_kwargs={},
                          spec_kwargs=dict(heartbeat_interval_s=0.25,
                                           heartbeat_misses=8)),
    "restart_storm": dict(arm=_arm_restart_storm, traffic_kwargs=dict(
        drop_p=0.01)),
    "budget_edge": dict(arm=_arm_budget_edge, traffic_kwargs={}),
    "rfi_storm": dict(arm=_arm_none, traffic_kwargs=dict(rfi=RFI_STORM),
                      spec_kwargs=dict(rfi_flag=dict(
                          algo="mad", thresh=6.0, mad_factor=4.0,
                          window=16))),
}


# ----------------------------------------------------------------- check
def _check(seed, device=None):
    failures = []

    def expect(cond, what, res):
        if not cond:
            failures.append(f"{res['scenario']}: {what}")
            print(f"frb_service --check FAIL [{res['scenario']}]: {what}\n"
                  f"  result: {json.dumps(res, default=str)}",
                  file=sys.stderr)

    def run(name, **kw):
        cfg = SCENARIOS[name]
        res = run_scenario(name, seed=seed, arm=cfg["arm"],
                           traffic_kwargs=cfg["traffic_kwargs"],
                           spec_kwargs=cfg.get("spec_kwargs", {}),
                           device=device, **kw)
        # Invariants every scenario must hold: committed frames are
        # never lost or duplicated, and the sink made progress.
        expect(res["warmed"], "service never processed the warmup gulp",
               res)
        expect(res["ledger"]["lost_frames"] == 0,
               f"committed-frame LOSS {res['ledger']['lost_frames']}", res)
        expect(res["ledger"]["duplicated_frames"] == 0,
               f"committed-frame DUP {res['ledger']['duplicated_frames']}",
               res)
        expect(res["frames_processed"] > 0, "no frames reached detect",
               res)
        expect(res["counters"]["escalations"] == 0,
               f"escalated: {res['counters']}", res)
        return res

    t0 = time.perf_counter()
    res = run("clean")
    expect(res["exit_code"] == 0, f"exit {res['exit_code']} != clean", res)
    expect(res["candidates"] >= 1, "no burst candidates in clean run", res)
    expect(res["counters"]["restarts"] == 0, "spurious restarts", res)

    res = run("drop_storm")
    expect(res["exit_code"] == 0, f"exit {res['exit_code']} != clean", res)
    expect((res["capture"] or {}).get("nmissing", 0) > 0,
           "drop storm produced no missing-packet accounting", res)

    res = run("malformed_stream")
    expect(res["exit_code"] == 0, f"exit {res['exit_code']} != clean", res)
    expect((res["capture"] or {}).get("ninvalid", 0) > 0,
           "malformed stream produced no ninvalid accounting", res)
    expect(res["counters"]["faults"] == 0,
           "malformed packets leaked a block fault", res)
    expect(res["candidates"] >= 1,
           "bursts lost amid malformed packets", res)

    res = run("reorder_dup_flap")
    expect(res["exit_code"] == 0, f"exit {res['exit_code']} != clean", res)
    expect(res["counters"]["restarts"] >= 1,
           "capture-tier fault did not restart", res)

    res = run("wedge_deadman")
    expect(res["counters"]["deadman_interrupts"] >= 1,
           "wedge never drew a deadman interrupt", res)
    expect(res["counters"]["restarts"] >= 1, "deadman did not restart",
           res)
    expect(res["recovery_count"] >= 1, "no recovery time recorded", res)

    res_a = run("restart_storm")
    expect(res_a["counters"]["restarts"] >= 2,
           f"expected both tier restarts, got {res_a['counters']}", res_a)
    expect(res_a["recovery_p99_s"] is not None,
           "no recovery percentiles after restarts", res_a)
    expect(len(res_a["firing_log"]) == 2,
           f"firing log {res_a['firing_log']}", res_a)

    # Seed-replay determinism: same seed -> same firing log, same
    # restart sequence, same continuity ledger.
    res_b = run("restart_storm")
    expect(res_a["replay_signature"] == res_b["replay_signature"],
           f"replay signature diverged:\n  A={res_a['replay_signature']}"
           f"\n  B={res_b['replay_signature']}", res_b)

    res = run("budget_edge")
    expect(res["degrade_episodes"] >= 1,
           "budget edge did not degrade", res)
    expect(res["exit_code"] == 1,
           f"exit {res['exit_code']} != degraded", res)
    expect(res["counters"]["degrades"] >= 1,
           "no degrade event in supervise counters", res)

    # RFI storm: the flagged chain (frb_search_spec rfi_flag= stage)
    # keeps recovering the injected bursts; an un-flagged twin of the
    # SAME storm drowns them.  Burst counting is burst-phase-aligned
    # (_burst_aligned) so storm-driven false positives don't score.
    res_f = run("rfi_storm")
    expect(res_f["exit_code"] == 0, f"exit {res_f['exit_code']} != clean",
           res_f)
    expect((res_f.get("flagged_fraction") or 0) > 0,
           "storm drew no flags", res_f)
    expect(res_f["burst_candidates"] >= 1,
           "flagged chain lost the bursts in the storm", res_f)
    cfg = SCENARIOS["rfi_storm"]
    res_u = run_scenario("rfi_storm_unflagged", seed=seed,
                         arm=cfg["arm"],
                         traffic_kwargs=cfg["traffic_kwargs"],
                         spec_kwargs={}, device=device)
    expect(res_u["ledger"]["lost_frames"] == 0 and
           res_u["ledger"]["duplicated_frames"] == 0,
           "unflagged storm broke frame continuity", res_u)
    expect(res_f["burst_candidates"] > res_u["burst_candidates"],
           f"flagging did not recover bursts (flagged "
           f"{res_f['burst_candidates']} vs unflagged "
           f"{res_u['burst_candidates']})", res_f)
    # Seed-replay determinism with the storm in the schedule: the RFI
    # placement is part of schedule_hash, so the signature must match.
    res_f2 = run_scenario("rfi_storm", seed=seed, arm=cfg["arm"],
                          traffic_kwargs=cfg["traffic_kwargs"],
                          spec_kwargs=cfg["spec_kwargs"], device=device)
    expect(res_f["replay_signature"] == res_f2["replay_signature"],
           f"rfi_storm replay signature diverged:\n"
           f"  A={res_f['replay_signature']}\n"
           f"  B={res_f2['replay_signature']}", res_f2)

    out = {"frb_service_check": "ok" if not failures else "FAIL",
           "failures": failures,
           "scenarios": len(SCENARIOS) + 3,
           "device": res_f2["device"],
           "wall_s": round(time.perf_counter() - t0, 1)}
    print(json.dumps(out))
    return 1 if failures else 0


# ------------------------------------------------------------------ soak
def _soak(seconds, rate_pps, seed, device=None):
    """Sustained-rate soak with a periodic fault mix: the publishable
    packets/s + candidates/s + recovery-time numbers."""
    rx, port = _open_capture_socket()
    spec = frb_search_spec(rx, NSRC, PAYLOAD, buffer_ntime=BUFFER_NTIME,
                           slot_ntime=SLOT_NTIME, gulp_nframe=GULP_NFRAME,
                           max_delay=MAX_DELAY, threshold=8.0)
    svc = Service(spec, name="frb_soak", device=device)
    plan = FaultPlan(seed=seed)
    # One capture-tier and one compute-tier fault per ~4 s of soak.
    for k in range(max(1, int(seconds / 4))):
        plan.raise_at("capture.packet", block="capture", nth=60 + 160 * k)
        plan.raise_at("block.on_data", block="fdmt", nth=24 + 56 * k)
    plan.attach(svc.pipeline)
    tx_sock = UDPSocket().connect("127.0.0.1", port)
    tx = UDPTransmit(tx_sock)
    try:
        svc.start()
        send_schedule_c(tx, build_schedule(seed, 0, 512), rate_pps)
        _wait_frames(svc, GULP_NFRAME, timeout_s=30.0)
        sent = 0
        t0 = time.perf_counter()
        frame = 512
        while time.perf_counter() - t0 < seconds:
            chunk = build_schedule(seed + frame, frame, 1024, drop_p=0.01)
            s, _m, _w = send_schedule_c(tx, chunk, rate_pps)
            sent += s
            frame += 1024
        wall = time.perf_counter() - t0
        _wait_quiescent(svc, 15.0)
        health = svc.health()
        report = svc.stop()
    finally:
        try:
            tx_sock.shutdown()
        except Exception:
            pass
        plan.detach()
        try:
            rx.shutdown()
        except Exception:
            pass
    det = svc.blocks["detect"]
    rep = report.as_dict()
    cap = health.get("capture") or {}
    out = {
        "frb_soak_seconds": round(wall, 2),
        "frb_packets_per_sec_sent": round(sent / wall, 1),
        "frb_packets_per_sec_captured": round(
            cap.get("ngood", 0) / wall, 1) if cap else None,
        "frb_frames_processed": det.frames_seen,
        "frb_candidates": det.ncandidates,
        "frb_candidates_per_sec": round(det.ncandidates / wall, 3),
        "frb_restarts": report.counters["restarts"],
        "frb_recovery_p50_s": report.recovery["p50_s"],
        "frb_recovery_p99_s": report.recovery["p99_s"],
        "frb_ledger": rep["ledger"],
        "frb_exit_code": report.exit_code,
        "frb_faults_fired": len(plan.log),
    }
    print(json.dumps(out))
    return 0 if report.exit_code != 2 and \
        rep["ledger"]["lost_frames"] == 0 and \
        rep["ledger"]["duplicated_frames"] == 0 else 1


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=15.0,
                   help="soak duration (non-check mode)")
    p.add_argument("--rate", type=int, default=DEFAULT_RATE_PPS,
                   help="target send rate, packets/s (C-paced schedule "
                        "walker; 0 = blast)")
    p.add_argument("--scenario", choices=sorted(SCENARIOS),
                   help="run ONE scenario and print its result")
    p.add_argument("--check", action="store_true",
                   help="fast chaos matrix (invariants, no timing "
                        "assertions)")
    p.add_argument("--device", default=None,
                   help="torch device of the service ('cpu'); default "
                        "the card")
    args = p.parse_args()
    if args.check:
        return _check(args.seed, args.device)
    if args.scenario:
        cfg = SCENARIOS[args.scenario]
        res = run_scenario(args.scenario, seed=args.seed,
                           rate_pps=args.rate, arm=cfg["arm"],
                           traffic_kwargs=cfg["traffic_kwargs"],
                           spec_kwargs=cfg.get("spec_kwargs", {}),
                           device=args.device)
        print(json.dumps(res, default=str))
        return 0 if res["ledger"]["lost_frames"] == 0 and \
            res["ledger"]["duplicated_frames"] == 0 else 1
    return _soak(args.seconds, args.rate, args.seed, args.device)


if __name__ == "__main__":
    sys.exit(main())
