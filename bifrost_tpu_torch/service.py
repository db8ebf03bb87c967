"""The service layer of the port (counterpart of bifrost_tpu/service.py):
a supervised pipeline built from a declarative `ServiceSpec`, run as a
managed long-running `Service`, plus the chains the JAX package's specs
build, as bare pipelines.

The runtime (bifrost_tpu/service.py:1-60, 813-1489): `Service(spec)`
builds a pipeline from the spec's ordered `StageSpec`s (registry kinds
capture, copy, transpose, fdmt, flag, calibrate, detect, or a `custom`
factory),
runs it under a `supervise.Supervisor` with per-stage restart tiers
(`DEFAULT_TIERS`), and answers what an operator asks:

- `health()`: a structured snapshot (per-stage heartbeat age, stall %,
  queued gulps, restart budget left; the UDP capture's packet counters;
  supervise counters; recovery percentiles; the frame ledger; detection;
  degraded state), pushed every `service_health_interval_s` to a
  `<pipeline>/service` ProcLog (the capture counters as `capture_*`).
- The `FrameLedger` at the detect sink: committed, lost and duplicated
  frames, and the frames restarts and sheds skipped (lost == dup == 0
  is the invariant).
- Degraded mode: when a stage's restart budget left drops to
  `degrade_margin`, detection thresholds rise by `degrade_detect_factor`
  (and, with `degrade_shed_every`, the detector sheds gulps) instead of
  riding the budget into an escalation; a full policy window without a
  restart restores them.
- `stop()`: the bounded quiesce and a `ServiceExitReport` whose exit
  code is 0 (clean), 1 (degraded at stop, or the quiesce needed its
  deadline interrupts) or 2 (escalated, a wedged block, a pipeline
  error).
- `respec(stage, new_stage)`: live respec (bifrost_tpu/service.py:
  1055-1234).  One stage of the running pipeline is replaced at a gulp
  edge: the block is quiesced (pipeline.quiesce_block), the replacement
  is built onto the same input and output rings, takes over the block's
  place in the input stream and its supervision
  (Supervisor.replace_block), and starts; the rest of the chain streams
  on.  The FrameLedger keeps lost == dup == 0 across the splice.  The
  stop lock is held throughout, so a concurrent `stop()` waits for the
  splice.  Sources, capture stages and fused stages are refused; the
  replacement keeps the block's name and output rings; a build error
  (a map stage's M1 build included: `MapBlock.preflight` builds it for
  the open input sequence) rebuilds the old stage and re-raises; a
  wedged quiesce aborts.
  `respecs` and `respec_downtime_s` keep the records, which `health()`,
  the exit report and the fleet (fleet.py) publish.

Block names are the proclog namespace, so every live service claims its
blocks' names: a registry stage whose name is taken is suffixed
`<name>@<service>` with a warning, a custom block's taken name raises; a
respec's replacement takes its predecessor's claim.

`Service(spec, device=None)` runs on the card, building the CUDA
kernels (build.py) in `start()` before the watchdog is armed, so a
clean run sees no heartbeat miss; `device='cpu'` runs every 'cuda'
ring on the CPU (the tests).  There is no fallback from one to the
other.

The socket-fed specs (bifrost_tpu/service.py:260-352), the 24/7 way the
reference runs its FRB search: `frb_search_spec(sock, ...)` is UDP
capture [-> rfi flag] -> transpose -> FDMT -> candidate detect on host
('system') rings, as the reference builds it; the FDMT (and the
flagger) stage each host gulp onto the pipeline's device and run their
kernels there (blocks/fdmt.py, blocks/flag.py).  `lwa_frb_search_spec`
is its LWA geometry (64 sources x 64 B = 4096 channels), a list of
reuseport sockets giving a list of specs.

`lwa_instrument_spec(voltages=... | sock=...)` is the whole instrument
as one spec, the topology `lwa_instrument_pipeline` builds (one set of
builders): replay or UDP capture -> H2D -> PFB, the X branch (correlate
-> transpose -> merge_axes into 'vis' -> Romein grid -> FFT -> host ->
`on_image`) and the B branch (beamform -> transpose -> FDMT -> candidate
detect), fused as `block_scope(fuse=True)` puts them (copy -> pfb,
correlate -> image_t and bengine -> bdetect_t -> bdetect_fdmt each one
group).

The bare chains, each -> (pipeline, detector, ledger):

- `frb_search_pipeline`, the body of `frb_search_spec`
  (service.py:294-315): array_source (u8 [time, freq]) -> copy('cuda')
  [-> rfi_flag] -> transpose(['freq', 'time']) -> fdmt(max_delay) ->
  CandidateDetectBlock.
- `lwa_beam_search_pipeline`, the B branch of the instrument.
- `lwa_instrument_pipeline`, the whole instrument.

Sub-byte capture runs through the `unpack` kind, and the instrument
takes `engine='int8'`.  With `degrade_shards` (the default) a
collective-watchdog shard eviction of a mesh stage puts the service in
degraded-mesh state instead of escalating: the chain streams on the
surviving shards, the skipped gulp is booked as shed by a shard
(`shard_shed_frames`, never lost), and the health loop restores an
evicted shard once its health returns, clearing the state when no
eviction remains.  The availability summary reads the device registry
(parallel/faultdomain.py) over every mesh a guarded dispatch touched.  The
data-quality front end of the beam search (flag -> calibrate before the
B-engine) is built from blocks, as benchmarks/dq_tpu.py builds it.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
import warnings

import numpy as np
import torch

from . import config, telemetry, views
from .blocks import (array_source, beamform, callback_sink, copy, correlate,
                     fdmt, fft, gather_sink, pfb, romein, transpose)
from .blocks import rfi_flag as _rfi_flag
from .ops.stats import mad_snr
from .pipeline import Pipeline, SinkBlock, block_scope
from .proclog import ProcLog
from .supervise import RestartPolicy, Supervisor

__all__ = ["Service", "ServiceSpec", "StageSpec", "FrameLedger",
           "CandidateDetectBlock", "ServiceExitReport", "frb_search_spec",
           "lwa_frb_search_spec", "lwa_instrument_spec",
           "frb_search_pipeline",
           "lwa_beam_search_pipeline", "lwa_instrument_pipeline",
           "DEFAULT_TIERS", "EXIT_CLEAN", "EXIT_DEGRADED", "EXIT_ESCALATED"]

EXIT_CLEAN = 0
EXIT_DEGRADED = 1
EXIT_ESCALATED = 2

# ------------------------------------------------- proclog namespace guard
# Block names are the proclog namespace: two live services whose stages
# resolve to one block name would clobber each other's logs.  Each
# service claims its names for its lifetime (released at stop()).  The
# claim list itself is the owner token, compared with `is`.
_ns_lock = threading.Lock()
_ns_claims = {}        # block name -> (owner claim list, service name)


def _claim_block_name(desired, service_name, owner_names):
    """Reserve a free block name for a registry-built stage: `desired`,
    or `<desired>@<service>[.k]` with a warning naming the owner."""
    with _ns_lock:
        name = desired
        if name in _ns_claims:
            if _ns_claims[name][0] is owner_names:
                return name
            owner = _ns_claims[name][1]
            name = f"{desired}@{service_name}"
            k = 2
            while name in _ns_claims:
                if _ns_claims[name][0] is owner_names:
                    return name
                name = f"{desired}@{service_name}.{k}"
                k += 1
            warnings.warn(
                f"service {service_name!r}: block name {desired!r} is "
                f"already claimed by live service {owner!r} — proclog "
                f"rows would clobber; using {name!r} instead",
                stacklevel=3)
        _ns_claims[name] = (owner_names, service_name)
        owner_names.append(name)
        return name


def _claim_custom_block_name(name, service_name, owner_names):
    """Claim a custom factory's self-chosen block name; raise on a live
    collision (its ProcLogs exist already: a rename cannot help)."""
    with _ns_lock:
        claim = _ns_claims.get(name)
        if claim is not None:
            if claim[0] is owner_names:
                return
            raise ValueError(
                f"service {service_name!r}: block name {name!r} collides "
                f"with live service {claim[1]!r} — its proclog rows "
                f"(<{name}>/perf, ...) would be clobbered.  Name the "
                f"block uniquely in its factory (e.g. "
                f"'{name}@{service_name}')")
        _ns_claims[name] = (owner_names, service_name)
        owner_names.append(name)


def _release_block_names(owner_names):
    with _ns_lock:
        for name in owner_names:
            claim = _ns_claims.get(name)
            if claim is not None and claim[0] is owner_names:
                _ns_claims.pop(name, None)
        del owner_names[:]


# Default restart tiers by stage role: capture restarts cheaply and
# often, compute at moderate cost, the detect sink tightly (a sink that
# keeps dying is a bug, not weather).
DEFAULT_TIERS = {
    "capture": RestartPolicy(max_restarts=8, window_s=30.0, backoff=0.05),
    "transport": RestartPolicy(max_restarts=5, window_s=30.0, backoff=0.05),
    "compute": RestartPolicy(max_restarts=4, window_s=30.0, backoff=0.05),
    "detect": RestartPolicy(max_restarts=3, window_s=30.0, backoff=0.05),
}

# Stage kind -> default tier (StageSpec.tier overrides).
_KIND_TIERS = {
    "capture": "capture",
    "copy": "transport",
    "transpose": "transport",
    "unpack": "transport",
    "fdmt": "compute",
    "flag": "compute",
    "calibrate": "compute",
    "map": "compute",
    "detect": "detect",
    "custom": "compute",
}


class StageSpec(object):
    """One stage of a service chain: a registry `kind`, its constructor
    `params`, and its restart policy (explicit `restart`, else the
    `tier`'s, else the kind's default tier)."""

    def __init__(self, kind, name=None, params=None, restart=None,
                 tier=None):
        if kind not in _KIND_TIERS:
            raise ValueError(f"unknown stage kind {kind!r} "
                             f"(one of {sorted(_KIND_TIERS)})")
        self.kind = kind
        self.name = name or kind
        self.params = dict(params or {})
        self.restart = restart
        self.tier = tier or _KIND_TIERS[kind]

    def policy(self):
        if self.restart is not None:
            return self.restart
        return DEFAULT_TIERS[self.tier]

    def __repr__(self):
        return (f"StageSpec(kind={self.kind!r}, name={self.name!r}, "
                f"tier={self.tier!r})")


class ServiceSpec(object):
    """An ordered stage chain plus the supervision, degradation and
    quiesce settings; `None` settings resolve from config.py at build.

    The default watchdog horizon, 1 s x 30, must exceed the longest
    stall of a healthy chain; latency-sensitive deployments and tests
    lower it per spec."""

    def __init__(self, stages, heartbeat_interval_s=1.0,
                 heartbeat_misses=30, degrade_margin=None,
                 degrade_detect_factor=None, degrade_shed_every=0,
                 degrade_shards=True, quiesce_timeout_s=5.0,
                 health_interval_s=None):
        if not stages:
            raise ValueError("a service needs at least one stage")
        names = [s.name for s in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        self.stages = list(stages)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.heartbeat_misses = int(heartbeat_misses)
        self.degrade_margin = degrade_margin
        self.degrade_detect_factor = degrade_detect_factor
        self.degrade_shed_every = int(degrade_shed_every)
        # Degraded-mesh policy: True = a shard eviction puts the service
        # in degraded state (exit code 1 if still degraded at stop) and
        # the health loop restores evicted shards whose health returns;
        # False = shard events are only counted and published.
        self.degrade_shards = bool(degrade_shards)
        self.quiesce_timeout_s = float(quiesce_timeout_s)
        self.health_interval_s = health_interval_s


class FrameLedger(object):
    """Frame-continuity accounting for a service run.

    The terminal sink reports every gulp it consumes
    (`note_sink(seq, frame0, nframe)`); the supervise event stream
    reports restarts and sheds (`note_event`).  Within one output
    sequence committed frames must be contiguous: a gap is lost data, an
    overlap duplicated data.  A restart starts a fresh sequence, so it
    never shows as a gap; what it skips is counted from its event's
    `shed_nframe`, and overload sheds from the `shed` events.  The
    invariant is lost == duplicated == 0.

    `first_sink_t` (time.perf_counter) and `first_sink_nframe` stamp the
    first committed gulp, so that a rate can be read without start-up.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.first_sink_t = None
        self.first_sink_nframe = 0
        self.committed_frames = 0
        self.lost_frames = 0
        self.duplicated_frames = 0
        self.sequences = 0
        self.shed_frames = 0           # overload-policy sheds (events)
        self.restart_shed_frames = 0   # faulted gulps skipped by restarts
        self.shard_shed_frames = 0     # those skipped by shard faults
        self._restart_events = []      # SuperviseEvents (bounded)
        # seq key -> next expected frame0.  None = sequence announced
        # but no gulp observed yet: the first gulp baselines the
        # expectation at its own offset (a restarted sink re-enters its
        # sequence at its resume frame).
        self._expect = {}

    def note_sequence(self, key):
        with self._lock:
            self.sequences += 1
            self._expect[key] = None

    def note_sink(self, key, frame0, nframe):
        with self._lock:
            if self.first_sink_t is None:
                self.first_sink_t = time.perf_counter()
                self.first_sink_nframe = nframe
            expect = self._expect.get(key)
            if expect is not None:
                if frame0 > expect:
                    self.lost_frames += frame0 - expect
                elif frame0 < expect:
                    self.duplicated_frames += min(expect - frame0, nframe)
                self._expect[key] = max(expect, frame0 + nframe)
            else:
                self._expect[key] = frame0 + nframe
            self.committed_frames += nframe

    def note_event(self, ev):
        if ev.kind == "restart":
            with self._lock:
                self._restart_events.append(ev)
                del self._restart_events[:-256]
                shed = int(ev.details.get("shed_nframe", 0))
                self.restart_shed_frames += shed
                if "shard_device" in ev.details or \
                        "shard_reason" in ev.details:
                    # A degraded mesh's missing gulp is shed, not lost.
                    self.shard_shed_frames += shed
        elif ev.kind == "shed":
            with self._lock:
                self.shed_frames += int(ev.details.get("nframe", 0))

    @property
    def restarts(self):
        """Per-restart records, read at call time, so the recovery time
        the supervisor stamps later is there."""
        with self._lock:
            events = list(self._restart_events)
        return [{"block": e.block, "time": e.time, **e.details}
                for e in events]

    def summary(self):
        with self._lock:
            return {
                "committed_frames": self.committed_frames,
                "lost_frames": self.lost_frames,
                "duplicated_frames": self.duplicated_frames,
                "sequences": self.sequences,
                "shed_frames": self.shed_frames,
                "restart_shed_frames": self.restart_shed_frames,
                "shard_shed_frames": self.shard_shed_frames,
                "restarts": len(self._restart_events),
            }


class CandidateDetectBlock(SinkBlock):
    """Terminal FRB candidate detector over the dedispersed (DM, time)
    stream: a per-DM-row median/MAD baseline over each gulp, and the
    gulp's peak SNR becomes a candidate when it crosses the threshold.

    The reduction runs on the span's device: the JAX block pulls each
    whole gulp to the host (service.py:731), this one copies back only
    the peak SNR and its flat index.  It is the service's degraded-mode
    actuator: `raise_threshold()` / `restore_threshold()`, and
    `shed_every = N` skips detection on every Nth gulp of a sequence,
    accounted through the supervisor's `record_shed`.
    `on_candidate(cand_dict)` fires per detection (an observer: its
    errors are swallowed).  `ledger` wires a FrameLedger.
    """

    MAX_CANDIDATES = 1024

    def __init__(self, iring, threshold=8.0, on_candidate=None, **kwargs):
        super().__init__(iring, **kwargs)
        self.base_threshold = float(threshold)
        self.threshold = float(threshold)
        self.on_candidate = on_candidate
        self.shed_every = 0
        self.ledger = None
        self.candidates = []
        self.ncandidates = 0
        self.frames_seen = 0
        self.gulps_seen = 0
        self.gulps_shed = 0
        self._seq_index = -1
        self._gulp_in_seq = 0
        self._dm_scale = (0.0, 1.0)
        self._t_scale = (0.0, 1.0)

    def raise_threshold(self, factor):
        self.threshold = self.base_threshold * float(factor)

    def restore_threshold(self):
        self.threshold = self.base_threshold

    def on_sequence(self, iseq):
        hdr = iseq.header
        tensor = hdr.get("_tensor", {})
        labels = tensor.get("labels") or []
        scales = tensor.get("scales") or []
        if "dispersion" in labels:
            self._dm_scale = tuple(scales[labels.index("dispersion")])
        if "time" in labels:
            self._t_scale = tuple(scales[labels.index("time")])
        self._seq_index += 1
        self._gulp_in_seq = 0
        if self.ledger is not None:
            self.ledger.note_sequence(self._seq_index)

    def on_data(self, ispan):
        nframe = ispan.nframe
        frame0 = ispan.frame_offset
        if self.ledger is not None:
            self.ledger.note_sink(self._seq_index, frame0, nframe)
        self.frames_seen += nframe
        self.gulps_seen += 1
        self._gulp_in_seq += 1
        shed_every = self.shed_every
        if shed_every > 0 and self._gulp_in_seq % shed_every == 0:
            # Degraded-mode shed: detection is skipped, the gulp is still
            # consumed, and the frames count as an overload drop does.
            self.gulps_shed += 1
            sup = self._supervisor
            if sup is not None:
                sup.record_shed(self, nframe)
            return
        x = ispan.data.to(torch.float32)
        if x.dim() == 1:
            x = x[None, :]
        x = x.reshape(-1, x.shape[-1])          # (ndm..., time) -> 2D
        if x.numel() == 0:
            return
        # Robust per-DM-row baseline (median + MAD, not mean/std: a bright
        # burst must not inflate its own baseline), ops/stats.py.
        snr = mad_snr(x, dim=-1)
        peak, flat = torch.stack([snr.max().double(),
                                  snr.argmax().double()]).cpu().tolist()
        if peak >= self.threshold:
            dm_i, t_i = divmod(int(flat), x.shape[1])
            dm0, ddm = self._dm_scale
            cand = {
                "seq": self._seq_index,
                "frame": int(frame0 + t_i),
                "dm_index": int(dm_i),
                "dm": dm0 + ddm * int(dm_i),
                "snr": round(peak, 3),
                "threshold": self.threshold,
            }
            self.ncandidates += 1
            self.candidates.append(cand)
            del self.candidates[:-self.MAX_CANDIDATES]
            cb = self.on_candidate
            if cb is not None:
                try:
                    cb(cand)
                except Exception:  # noqa: BLE001 — observer only
                    pass


def frb_search_spec(sock, nsrc, max_payload_size, buffer_ntime, slot_ntime,
                    gulp_nframe, max_delay, threshold=8.0, fmt="simple",
                    f0_mhz=60.0, df_mhz=0.024, dt_s=1e-3, packet_dtype="u8",
                    on_candidate=None, rfi_flag=None, **service_kwargs):
    """The FRB search as a ServiceSpec fed by a socket
    (bifrost_tpu/service.py:260-316): UDP capture [-> rfi flag] ->
    transpose -> FDMT -> candidate detect, every ring in the capture's
    'system' space as the reference builds it; the FDMT and the flagger
    run on the pipeline's device (module docstring).

    One captured time frame is `nsrc * max_payload_size` bytes of
    filterbank power, one `packet_dtype` sample per channel;
    `f0_mhz`/`df_mhz`/`dt_s` scale the axes so the FDMT dedisperses in
    physical units.  `rfi_flag`: a dict of RfiFlagBlock parameters (e.g.
    dict(algo='mad', thresh=6.0, window=16)) inserting the flagger
    between capture and transpose.  A sub-byte `packet_dtype` (i4)
    inserts an `unpack` stage to i8 after the capture, as the reference
    does."""
    from .DataType import DataType
    nbit = DataType(packet_dtype).itemsize_bits
    nchan = int(nsrc) * int(max_payload_size) * 8 // nbit

    def header_cb(seq0):
        return seq0, {
            "_tensor": {
                "dtype": str(packet_dtype),
                "shape": [-1, nchan],
                "labels": ["time", "freq"],
                "scales": [[seq0 * dt_s, dt_s], [f0_mhz, df_mhz]],
                "units": ["s", "MHz"],
            },
        }

    stages = [
        StageSpec("capture", params=dict(
            fmt=fmt, sock=sock, nsrc=nsrc, src0=0,
            max_payload_size=max_payload_size, buffer_ntime=buffer_ntime,
            slot_ntime=slot_ntime, header_callback=header_cb,
            reader_gulp_nframe=gulp_nframe)),
    ]
    if nbit < 8:
        stages.append(StageSpec("unpack", params=dict(dtype="i8")))
    if rfi_flag is not None:
        flag_params = dict(rfi_flag)
        flag_params.setdefault("gulp_nframe", gulp_nframe)
        stages.append(StageSpec("flag", params=flag_params))
    stages += [
        StageSpec("transpose", params=dict(axes=["freq", "time"],
                                           gulp_nframe=gulp_nframe)),
        StageSpec("fdmt", params=dict(max_delay=max_delay,
                                      gulp_nframe=gulp_nframe)),
        StageSpec("detect", params=dict(threshold=threshold,
                                        on_candidate=on_candidate,
                                        gulp_nframe=gulp_nframe)),
    ]
    return ServiceSpec(stages, **service_kwargs)


def lwa_frb_search_spec(sock, nsrc=64, max_payload_size=64,
                        buffer_ntime=8192, slot_ntime=16, gulp_nframe=64,
                        max_delay=64, threshold=8.0, f0_mhz=40.0,
                        df_mhz=0.00928, dt_s=1e-3, **kwargs):
    """The FRB search at the LWA geometry (bifrost_tpu/service.py:
    319-352): 64 sources x 64-byte payloads = 4096 channels a frame, the
    LWA band (40 MHz + 4096 x 9.28 kHz).

    `sock` is one bound capture socket, or a LIST of sockets bound with
    `UDPSocket.bind(addr, port, reuseport=True)`: then one spec per
    fanout shard is returned (list in, list out).  Each shard's capture
    spans the whole source range (the kernel hashes flows, not sources,
    across the group) into a ring of its own."""
    if isinstance(sock, (list, tuple)):
        return [lwa_frb_search_spec(
                    s, nsrc=nsrc, max_payload_size=max_payload_size,
                    buffer_ntime=buffer_ntime, slot_ntime=slot_ntime,
                    gulp_nframe=gulp_nframe, max_delay=max_delay,
                    threshold=threshold, f0_mhz=f0_mhz, df_mhz=df_mhz,
                    dt_s=dt_s, **kwargs)
                for s in sock]
    return frb_search_spec(sock, nsrc, max_payload_size,
                           buffer_ntime=buffer_ntime,
                           slot_ntime=slot_ntime, gulp_nframe=gulp_nframe,
                           max_delay=max_delay, threshold=threshold,
                           f0_mhz=f0_mhz, df_mhz=df_mhz, dt_s=dt_s,
                           **kwargs)


def frb_search_pipeline(data, gulp_nframe, max_delay, f0_mhz=40.0,
                        df_mhz=0.00928, dt_s=1e-3, threshold=8.0,
                        device=None, fdmt_method=None, on_candidate=None,
                        gather=None, rfi_flag=None):
    """Build the FRB-search chain over `data`, a (time, freq) u8 array of
    filterbank power replayed from memory.  The axes are scaled as
    `frb_search_spec` scales them (the defaults are
    `lwa_frb_search_spec`'s LWA band: 40 MHz + nfreq x 9.28 kHz, 1 ms).

    `rfi_flag`: a dict of RfiFlagBlock parameters (e.g. dict(algo='mad',
    thresh=6.0, mad_factor=4.0, window=16)) inserts the RFI flagger
    (block "flag", gulp_nframe defaulting to the chain's) after the H2D
    copy and before the transpose, as `frb_search_spec(rfi_flag=...)`
    inserts it after capture.

    `device`: None runs on the card (raising where there is none);
    'cpu' runs every 'cuda'-space ring on the CPU.  `gather`: a list that
    receives every dedispersed gulp as numpy.  -> (pipeline, detector,
    ledger); call `pipeline.run()`."""
    data = np.asarray(data)
    pipe = Pipeline(device=device)
    with pipe:
        src = array_source(data, gulp_nframe, header={
            "labels": ["time", "freq"],
            "scales": [[0.0, dt_s], [f0_mhz, df_mhz]],
            "units": ["s", "MHz"],
        }, name="capture")
        det, ledger = frb_search_chain(
            src, gulp_nframe, max_delay, threshold=threshold,
            fdmt_method=fdmt_method, on_candidate=on_candidate,
            gather=gather, rfi_flag=rfi_flag)
    return pipe, det, ledger


def frb_search_chain(src, gulp_nframe, max_delay, threshold=8.0,
                     fdmt_method=None, on_candidate=None, gather=None,
                     rfi_flag=None, scope=None):
    """The FRB search's chain after its source, built in the current
    pipeline: `src` (a (time, freq) filterbank ring in host memory) ->
    copy('cuda') -> [RFI flagger] -> transpose -> FDMT -> detect, as
    `frb_search_pipeline` builds it after its replay.  `scope(name)`, if
    given, is the context each block is built in (a `block_scope`, e.g.
    to pin it to a core).  -> (detector, ledger)."""
    ledger = FrameLedger()

    def at(name):
        return scope(name) if scope is not None else contextlib.nullcontext()
    with at("h2d"):
        dev = copy(src, space="cuda", name="h2d")
    if rfi_flag is not None:
        params = dict(rfi_flag)
        params.setdefault("gulp_nframe", gulp_nframe)
        params.setdefault("name", "flag")
        with at(params["name"]):
            dev = _rfi_flag(dev, **params)
    with at("transpose"):
        t = transpose(dev, ["freq", "time"], gulp_nframe=gulp_nframe,
                      name="transpose")
    with at("fdmt"):
        d = fdmt(t, max_delay=max_delay, method=fdmt_method,
                 gulp_nframe=gulp_nframe, name="fdmt")
    with at("detect"):
        det = CandidateDetectBlock(d, threshold=threshold,
                                   on_candidate=on_candidate,
                                   gulp_nframe=gulp_nframe, name="detect")
    det.ledger = ledger
    if gather is not None:
        with at("gather"):
            gather_sink(d, gather, gulp_nframe=gulp_nframe, name="gather")
    return det, ledger


def default_beam_weights(nbeam, nsp):
    """`lwa_instrument_spec`'s deterministic small-integer beam weights
    (service.py:408-412): w[b, i] = ((b * nsp + i) % 7) - 3, complex64."""
    return ((np.arange(nbeam * nsp, dtype=np.int64).reshape(nbeam, nsp)
             % 7) - 3).astype(np.complex64)


def _lwa_gulp(gulp_nframe, nchan, n_int):
    gulp = int(gulp_nframe) if gulp_nframe else int(nchan)
    if gulp % nchan:
        raise ValueError(f"gulp_nframe ({gulp}) must be a multiple of "
                         f"nchan ({nchan}) so the PFB emits whole spectra "
                         f"per gulp")
    if gulp // nchan > n_int:
        raise ValueError(f"gulp_nframe/nchan ({gulp // nchan}) spectra per "
                         f"gulp exceeds nframe_per_integration ({n_int})")
    return gulp


def _fuse_scope(fuse):
    """`lwa_instrument_spec`'s scope(): `block_scope(fuse=True)` where
    the chains fuse, else no scope."""
    return block_scope(fuse=True) if fuse else contextlib.nullcontext()


# The instrument's builders, one per stage of `lwa_instrument_spec`; the
# bare pipelines call the same ones, so both build one topology.
def _lwa_ingest(voltages, voltage_dtype, gulp, f0_mhz, dt_s):
    """The replay source of [time, station, pol] voltages of
    `voltage_dtype`: 'ci8' (the structured array or int8 pairs) or
    'ci4' (packed uint8 bytes, one sample a byte, re in the high
    nibble)."""
    packed = np.asarray(voltages).dtype == np.uint8
    if voltage_dtype not in ("ci8", "ci4"):
        raise ValueError(f"voltage_dtype must be 'ci8' or 'ci4', got "
                         f"{voltage_dtype!r}")
    if packed != (voltage_dtype == "ci4"):
        want = "uint8 bytes" if voltage_dtype == "ci4" else \
            "the structured (re, im) array or int8 pairs"
        raise TypeError(f"voltage_dtype={voltage_dtype!r} takes {want}, "
                        f"got {np.asarray(voltages).dtype}")
    return array_source(voltages, gulp, header={
        "dtype": voltage_dtype,
        "labels": ["time", "station", "pol"],
        "scales": [[0.0, dt_s], None, None],
        "units": ["s", None, None],
        "cfreq": f0_mhz,
        "cfreq_units": "MHz",
    }, name="ingest")


def _lwa_capture(sock, capture, nstand, npol, gulp, f0_mhz, dt_s):
    """The UDP capture of ci8 [time, station, pol] voltages
    (bifrost_tpu/service.py:443-484), its header naming the spec's gulp
    (`lwa_instrument_spec`)."""
    from .blocks import UDPCaptureBlock
    nsp = int(nstand) * int(npol)
    cap = dict(capture or {})
    nsrc = int(cap.pop("nsrc", nstand))
    payload = int(cap.pop("max_payload_size", max(nsp * 2 // max(nsrc, 1),
                                                  1)))
    if nsrc * payload != nsp * 2:
        raise ValueError(
            f"capture geometry nsrc*max_payload_size ({nsrc}*{payload}) "
            f"!= nstand*npol*2 B ({nsp * 2}) of ci8 voltages per time "
            f"frame")

    def header_cb(seq0):
        return seq0, {
            "_tensor": {
                "dtype": "ci8",
                "shape": [-1, int(nstand), int(npol)],
                "labels": ["time", "station", "pol"],
                "scales": [[seq0 * dt_s, dt_s], None, None],
                "units": ["s", None, None],
            },
            "cfreq": f0_mhz,
            "cfreq_units": "MHz",
            "gulp_nframe": gulp,
        }

    cap.setdefault("fmt", "simple")
    cap.setdefault("buffer_ntime", 8192)
    cap.setdefault("slot_ntime", 16)
    return UDPCaptureBlock(sock=sock, nsrc=nsrc, src0=0,
                           max_payload_size=payload,
                           header_callback=header_cb,
                           reader_gulp_nframe=gulp, name="ingest", **cap)


def _lwa_fengine(src, nchan, ntap, coeffs, pfb_method, fuse):
    """The H2D copy and the PFB: the F-engine ring both branches read."""
    with _fuse_scope(fuse):
        dev = copy(src, space="cuda", name="fengine_h2d")
        return pfb(dev, nchan, ntap=ntap, coeffs=coeffs, method=pfb_method,
                   name="fengine_pfb")


def _lwa_xengine(f, n_int, engine, gains, fuse):
    """The X-engine; one frame is nchan * (nstand*npol)**2 complex64 (8
    GiB at the flagship), so its ring holds one frame."""
    with _fuse_scope(fuse):
        return correlate(f, n_int, engine=engine, gains=gains,
                         buffer_factor=1, name="xengine")


def _lwa_image(x, ngrid, kernels, uvw, romein_method, fft_method, on_image,
               fuse):
    """transpose -> merge_axes into 'vis' -> Romein grid -> FFT -> host
    -> `on_image`, one frame a gulp, one frame a ring."""
    with block_scope(gulp_nframe=1):
        with _fuse_scope(fuse):
            t = transpose(x, ["freq", "station_i", "pol_i", "station_j",
                              "pol_j", "time"], buffer_factor=1,
                          name="image_t")
        v = views.merge_axes(t, "station_i", "pol_i", label="inp_i")
        v = views.merge_axes(v, "inp_i", "station_j", label="inp_ij")
        v = views.merge_axes(v, "inp_ij", "pol_j", label="vis")
        g = romein(v, ngrid, kernels, positions=uvw, method=romein_method,
                   buffer_factor=1, name="image_grid")
        img = fft(g, axes=["v", "u"], axis_labels=["m", "l"],
                  method=fft_method, name="image_fft")
        host = copy(img, space="system", name="image_d2h")
        return callback_sink(host, on_data=on_image, name="image_sink")


def _lwa_bengine(f, weights, n_int, beamform_method, fuse):
    with _fuse_scope(fuse):
        return beamform(f, weights, nframe_per_integration=n_int,
                        method=beamform_method, name="bengine")


def _lwa_bdetect(b, max_delay, threshold, on_candidate, fdmt_method, fuse):
    """transpose -> FDMT -> candidate detect -> (detector, FDMT block)."""
    with _fuse_scope(fuse):
        t = transpose(b, ["beam", "freq", "time"], name="bdetect_t")
        d = fdmt(t, max_delay=max_delay, method=fdmt_method,
                 name="bdetect_fdmt")
    det = CandidateDetectBlock(d, threshold=threshold,
                               on_candidate=on_candidate, name="bdetect")
    return det, d


def _lwa_gathers(b, d, gather):
    if "beams" in gather:
        gather_sink(b, gather["beams"], name="gather_beams")
    if "dedispersed" in gather:
        gather_sink(d, gather["dedispersed"], name="gather_dedispersed")


def lwa_beam_search_pipeline(voltages, nstand=256, npol=2, nchan=4096,
                             ntap=4, n_int=16, nbeam=8, weights=None,
                             max_delay=64, threshold=8.0, f0_mhz=40.0,
                             dt_s=1e-6, gulp_nframe=None, coeffs=None,
                             device=None, pfb_method=None,
                             beamform_method=None, fdmt_method=None,
                             on_candidate=None, gather=None, fuse=True,
                             voltage_dtype="ci8"):
    """Build the LWA beam-search chain over `voltages`, [time, station,
    pol] replayed from memory, of `voltage_dtype`: 'ci8', the JAX
    package's structured (re, im) array or its int8 storage form with a
    trailing axis of 2; or 'ci4', a uint8 [time, station, pol] array of
    packed bytes with re in the high nibble (the PFB reads either raw).
    The defaults are `lwa_instrument_spec`'s flagship geometry; `weights`
    ((nbeam, nstand*npol) complex) default to its small-integer planes,
    `coeffs` (the (ntap, nchan) PFB prototype) to `pfb_coeffs`.  A gulp
    is `gulp_nframe` voltage frames (default nchan), a multiple of nchan
    with at most n_int spectra.

    `device`: None runs on the card (raising where there is none); 'cpu'
    runs every 'cuda'-space ring on the CPU.  The three `*_method`
    arguments pin the PFB, beamform and FDMT methods (None reads their
    config flags).  `gather`: a dict whose 'beams' and 'dedispersed'
    lists, where present, receive the beam-power frames and the
    dedispersed gulps as numpy (a 'beams' reader is a second reader of
    the beamformer's ring, which then ends its fused group).  `fuse`:
    build the chain inside `block_scope(fuse=True)` as the spec does
    (module docstring).  -> (pipeline, detector, ledger); call
    `pipeline.run()`."""
    gulp = _lwa_gulp(gulp_nframe, nchan, n_int)
    if weights is None:
        weights = default_beam_weights(nbeam, int(nstand) * int(npol))
    pipe = Pipeline(device=device)
    ledger = FrameLedger()
    with pipe:
        ingest = _lwa_ingest(voltages, voltage_dtype, gulp, f0_mhz, dt_s)
        f = _lwa_fengine(ingest, nchan, ntap, coeffs, pfb_method, fuse)
        b = _lwa_bengine(f, weights, n_int, beamform_method, fuse)
        det, d = _lwa_bdetect(b, max_delay, threshold, on_candidate,
                              fdmt_method, fuse)
        det.ledger = ledger
        _lwa_gathers(b, d, gather or {})
    return pipe, det, ledger


def default_uvw(nstand, npol, ngrid, m=3):
    """`lwa_instrument_spec`'s default grid positions (service.py:
    414-423): stations on a square grid, each baseline's offset hashed
    onto the UV plane with room for an m x m kernel -> (2, nvis) int32,
    nvis = (nstand * npol)**2 in (i, j) order."""
    side = int(np.ceil(np.sqrt(nstand)))
    px = np.repeat(np.arange(nstand) % side, npol)
    py = np.repeat(np.arange(nstand) // side, npol)
    u = (px[None, :] - px[:, None] + side - 1).reshape(-1)
    v = (py[None, :] - py[:, None] + side - 1).reshape(-1)
    lo = max(int(ngrid) - m - 1, 1)
    return np.stack([(u * 7) % lo, (v * 7) % lo]).astype(np.int32)


def default_grid_kernel(m=3):
    """`lwa_instrument_spec`'s default gridding kernel (service.py:
    424-428): an (m, m) plane of ones, which broadcasts to every
    (channel, visibility) pair and is rank 1 (kernel K6b)."""
    return np.ones((m, m), np.complex64)


def _lwa_planes(nstand, npol, nbeam, ngrid, weights, uvw, kernels):
    """The spec's default beam weights, grid positions and kernel."""
    if weights is None:
        weights = default_beam_weights(nbeam, int(nstand) * int(npol))
    m = 3 if kernels is None else int(np.shape(kernels)[-1])
    if uvw is None:
        uvw = default_uvw(nstand, npol, ngrid, m)
    if kernels is None:
        kernels = default_grid_kernel(m)
    return weights, uvw, kernels


def _check_engine(engine):
    if engine not in ("f32", "int8"):
        raise ValueError(f"lwa instrument: unknown engine {engine!r} "
                         f"(expected 'f32' or 'int8')")


def lwa_instrument_pipeline(voltages, nstand=256, npol=2, nchan=4096,
                            ntap=4, n_int=16, nbeam=8, gulp_nframe=None,
                            engine="f32", gains=None, weights=None,
                            uvw=None, kernels=None, ngrid=128, max_delay=64,
                            threshold=8.0, f0_mhz=40.0, dt_s=1e-6,
                            on_image=None, on_candidate=None, coeffs=None,
                            device=None, pfb_method=None,
                            beamform_method=None, fdmt_method=None,
                            romein_method=None, fft_method=None,
                            gather=None, fuse=True, voltage_dtype="ci8"):
    """Build the whole LWA instrument of `lwa_instrument_spec` over
    `voltages` ([time, station, pol] of `voltage_dtype`, as
    `lwa_beam_search_pipeline` takes them) as a bare pipeline: replay -> H2D -> PFB, then from the
    one PFB ring both the B branch (beamform -> transpose -> FDMT ->
    detect) and the X branch (correlate -> transpose -> merge_axes into
    'vis' -> Romein grid -> FFT over (v, u) -> copy to the host ->
    `on_image`).

    Arguments as the spec's (minus its capture option): `fuse` builds
    the blocks inside `block_scope(fuse=True)` where the spec's scope()
    puts them, so that copy -> pfb, correlate -> image_t and bengine ->
    bdetect_t -> bdetect_fdmt fuse (the default, as the spec's); `gains`
    ((nstand[, npol]) complex) fold into the X-engine's voltages; `uvw`
    ((2, nvis) int grid positions) and `kernels` (broadcastable to
    (nchan, nvis, m, m)) default to the host arrays `default_uvw` and
    `default_grid_kernel`; given as card tensors they stay on the card
    and the gridder builds its plan there (origin 'device',
    ops/romein.py); `weights` and `coeffs` as in
    `lwa_beam_search_pipeline`.  `engine` is the X-engine's, 'f32' or
    'int8' (the PFB's output cast to int8 as the reference casts it).
    `device`, the `*_method` pins and `gather` ('beams', 'dedispersed')
    as in `lwa_beam_search_pipeline`.  `on_image(grid)` gets each image
    frame, an (nchan, ngrid, ngrid, 1) host view valid during the call.

    Ring sizing: one X-engine frame is nchan * (nstand*npol)**2 complex64
    (8 GiB at the flagship), so the X-engine's output ring, the
    transpose's and the gridder's input hold one frame each
    (buffer_factor 1), and the imaging blocks take one frame per gulp.
    -> (pipeline, detector, ledger); call `pipeline.run()`."""
    _check_engine(engine)
    gulp = _lwa_gulp(gulp_nframe, nchan, n_int)
    weights, uvw, kernels = _lwa_planes(nstand, npol, nbeam, ngrid, weights,
                                        uvw, kernels)
    pipe = Pipeline(device=device)
    ledger = FrameLedger()
    with pipe:
        ingest = _lwa_ingest(voltages, voltage_dtype, gulp, f0_mhz, dt_s)
        f = _lwa_fengine(ingest, nchan, ntap, coeffs, pfb_method, fuse)
        x = _lwa_xengine(f, n_int, engine, gains, fuse)
        _lwa_image(x, ngrid, kernels, uvw, romein_method, fft_method,
                   on_image, fuse)
        b = _lwa_bengine(f, weights, n_int, beamform_method, fuse)
        det, d = _lwa_bdetect(b, max_delay, threshold, on_candidate,
                              fdmt_method, fuse)
        det.ledger = ledger
        _lwa_gathers(b, d, gather or {})
    return pipe, det, ledger


def lwa_instrument_spec(voltages=None, sock=None, nstand=256, npol=2,
                        nchan=4096, ntap=4, n_int=16, nbeam=8,
                        gulp_nframe=None, engine="f32", gains=None,
                        weights=None, uvw=None, kernels=None, ngrid=128,
                        max_delay=64, threshold=8.0, f0_mhz=40.0,
                        dt_s=1e-6, on_image=None, on_candidate=None,
                        capture=None, fuse=True, coeffs=None,
                        pfb_method=None, beamform_method=None,
                        fdmt_method=None, romein_method=None,
                        fft_method=None, voltage_dtype="ci8",
                        **service_kwargs):
    """The telescope in a box (bifrost_tpu/service.py:355-550): the whole
    instrument as one supervised ServiceSpec, six stages —

        ingest (replay or UDP capture of ci8 [time, station, pol],
                tier 'capture')
          -> fengine: H2D copy -> PFB                    [fused group]
          -> xengine: correlate                          [fused with image_t]
               -> image: transpose -> Romein grid -> FFT -> host
          -> bengine: beamform + integrate               [fused group with
               -> bdetect: transpose -> FDMT -> detect    bdetect_t, _fdmt]

    Both branches read the one F-engine ring: the fengine factory parks
    its block in a closure that the branch factories read (a service
    chain is a list; the branches live in the closure).  Arguments are
    `lwa_instrument_pipeline`'s.  Ingest replays `voltages` unless `sock`
    is given: then a UDP capture stage at the same geometry takes its
    place, `capture` (a dict) overriding nsrc (default nstand),
    max_payload_size (default nstand*npol*2 // nsrc), fmt ('simple'),
    buffer_ntime (8192) and slot_ntime (16); nsrc * max_payload_size
    must be the nstand*npol*2 bytes of ci8 voltages of one time frame.
    The capture's header names the spec's gulp as the stream's
    `gulp_nframe`, so the H2D copy reads the PFB's whole spectra whatever
    the slot (the JAX spec leaves the capture's slot hint there, which
    the PFB refuses unless slot_ntime is a multiple of nchan).
    `service_kwargs` go to ServiceSpec.  The detect sink feeds the
    Service's FrameLedger."""
    if (voltages is None) == (sock is None):
        raise ValueError("lwa_instrument_spec needs exactly one of "
                         "`voltages` (replay) or `sock` (UDP capture)")
    _check_engine(engine)
    gulp = _lwa_gulp(gulp_nframe, nchan, n_int)
    weights, uvw, kernels = _lwa_planes(nstand, npol, nbeam, ngrid, weights,
                                        uvw, kernels)
    taps = {}

    def _ingest(upstream):
        if sock is None:
            return _lwa_ingest(voltages, voltage_dtype, gulp, f0_mhz,
                               dt_s)
        return _lwa_capture(sock, capture, nstand, npol, gulp, f0_mhz, dt_s)

    def _fengine(upstream):
        taps["fengine"] = _lwa_fengine(upstream, nchan, ntap, coeffs,
                                       pfb_method, fuse)
        return taps["fengine"]

    def _xengine(upstream):
        return _lwa_xengine(taps["fengine"], n_int, engine, gains, fuse)

    def _image(upstream):
        return _lwa_image(upstream, ngrid, kernels, uvw, romein_method,
                          fft_method, on_image, fuse)

    def _bengine(upstream):
        return _lwa_bengine(taps["fengine"], weights, n_int,
                            beamform_method, fuse)

    def _bdetect(upstream):
        return _lwa_bdetect(upstream, max_delay, threshold, on_candidate,
                            fdmt_method, fuse)[0]

    stages = [
        StageSpec("custom", name="ingest", tier="capture",
                  params=dict(factory=_ingest)),
        StageSpec("custom", name="fengine", params=dict(factory=_fengine)),
        StageSpec("custom", name="xengine", params=dict(factory=_xengine)),
        StageSpec("custom", name="image", params=dict(factory=_image)),
        StageSpec("custom", name="bengine", params=dict(factory=_bengine)),
        StageSpec("custom", name="bdetect", tier="detect",
                  params=dict(factory=_bdetect)),
    ]
    return ServiceSpec(stages, **service_kwargs)


class ServiceExitReport(object):
    """Outcome of a service run: the drain report, supervise counters,
    recovery stats, the frame ledger, degradation, and the exit code
    (EXIT_CLEAN / EXIT_DEGRADED / EXIT_ESCALATED)."""

    def __init__(self, exit_code, state, drain, counters, recovery,
                 ledger, degrade_episodes, degraded_at_stop, escalation,
                 error, uptime_s, availability=None):
        self.exit_code = exit_code
        self.state = state
        self.drain = drain
        self.counters = counters
        self.recovery = recovery
        self.ledger = ledger
        self.degrade_episodes = degrade_episodes
        self.degraded_at_stop = degraded_at_stop
        self.escalation = escalation
        self.error = error
        self.uptime_s = uptime_s
        self.availability = dict(availability or {})

    @property
    def clean(self):
        return self.exit_code == EXIT_CLEAN

    def as_dict(self):
        return {
            "exit_code": self.exit_code,
            "state": self.state,
            "uptime_s": self.uptime_s,
            "drain": self.drain.as_dict() if self.drain is not None
            else None,
            "counters": dict(self.counters),
            "recovery": dict(self.recovery),
            "ledger": dict(self.ledger),
            "degrade_episodes": self.degrade_episodes,
            "degraded_at_stop": self.degraded_at_stop,
            "escalation": self.escalation,
            "error": self.error,
            "availability": dict(self.availability),
        }

    def __repr__(self):
        return f"ServiceExitReport({json.dumps(self.as_dict())})"


class Service(object):
    """A supervised pipeline built from a ServiceSpec, run as a managed
    long-running service (module docstring):

        svc = Service(lwa_instrument_spec(voltages=v))
        svc.start()                  # build kernels, run + health push
        snap = svc.health()          # structured snapshot, any time
        report = svc.stop()          # bounded quiesce -> exit report

    `blocks` maps stage name -> block; `supervisor`, `pipeline` and
    `ledger` expose the machinery.  `device`: None runs on the card
    (raising where there is none), 'cpu' runs on the CPU."""

    def __init__(self, spec, name=None, device=None):
        self.spec = spec
        self.name = name or "service"
        self.ledger = FrameLedger()
        self.degraded = False
        self.degrade_episodes = 0
        # Degraded-mesh state (shard evictions outstanding): apart from
        # the restart-budget degrade; it raises no detect threshold and
        # clears when the shards are restored.
        self.shard_degraded = False
        self.shard_degrade_episodes = 0
        self._degraded_since = None
        self._last_restart_t = None
        self._state = "built"
        self._started_t = None
        self._run_thread = None
        self._run_error = None
        self._health_thread = None
        self._health_stop = threading.Event()
        self._lock = threading.Lock()
        self._stop_lock = threading.Lock()
        self._user_on_event = None
        self.exit_report = None
        self.start_s = None           # seconds start() took (kernel build)
        # Live respec: one record per respec() call (stage, outcome,
        # rolled_back, splice_s, downtime_s) and their downtime sum, which
        # the availability summary and the fleet's per-tenant accounting
        # read.
        self.respecs = []
        self.respec_downtime_s = 0.0
        self._degrade_margin = spec.degrade_margin \
            if spec.degrade_margin is not None \
            else config.get("service_degrade_margin")
        self._degrade_factor = spec.degrade_detect_factor \
            if spec.degrade_detect_factor is not None \
            else config.get("service_degrade_detect_factor")
        self._health_interval = spec.health_interval_s \
            if spec.health_interval_s is not None \
            else config.get("service_health_interval_s")
        self.blocks = {}
        self._ns_names = []
        try:
            with Pipeline(device=device) as pipe:
                upstream = None
                for stage in spec.stages:
                    upstream = self._build_stage(stage, upstream)
                    self.blocks[stage.name] = upstream
            for b in pipe.blocks:
                _claim_custom_block_name(b.name, self.name, self._ns_names)
        except BaseException:
            _release_block_names(self._ns_names)
            raise
        self.pipeline = pipe
        for b in self.blocks.values():
            if isinstance(b, CandidateDetectBlock):
                b.ledger = self.ledger
        # Policies key on the block's name (a custom factory may not
        # honour the stage name), so lookups and events line up.
        self.supervisor = Supervisor(
            policies={self.blocks[s.name].name: s.policy()
                      for s in spec.stages},
            heartbeat_interval_s=spec.heartbeat_interval_s,
            heartbeat_misses=spec.heartbeat_misses,
            on_event=self._on_supervise_event)
        self._proclog = ProcLog(f"{pipe.pname}/service")

    # ------------------------------------------------------------ build
    def _build_stage(self, stage, upstream):
        from . import blocks as blk
        params = dict(stage.params)
        kind = stage.kind
        if kind == "custom":
            # Any block factory, anywhere in the chain (upstream is None
            # for a chain-starting source); claimed after the build.
            factory = params.pop("factory")
            params.pop("name", None)
            return factory(upstream, **params)
        params["name"] = _claim_block_name(
            params.get("name", stage.name), self.name, self._ns_names)
        if kind == "capture":
            if upstream is not None:
                raise ValueError("capture must be the first stage")
            return blk.UDPCaptureBlock(**params)
        if upstream is None:
            raise ValueError(f"stage {stage.name!r} needs an upstream "
                             f"stage (only 'capture' or a 'custom' "
                             f"source factory can start a chain)")
        if kind == "copy":
            return blk.CopyBlock(upstream, params.pop("space", "cuda"),
                                 **params)
        if kind == "transpose":
            return blk.TransposeBlock(upstream, params.pop("axes"),
                                      **params)
        if kind == "fdmt":
            return blk.FdmtBlock(upstream, **params)
        if kind == "flag":
            return blk.RfiFlagBlock(upstream, **params)
        if kind == "unpack":
            return blk.UnpackBlock(upstream, **params)
        if kind == "calibrate":
            return blk.GainCalBlock(upstream, **params)
        if kind == "map":
            return blk.MapBlock(upstream, params.pop("func"), **params)
        return CandidateDetectBlock(upstream, **params)      # "detect"

    # -------------------------------------------------------- lifecycle
    def start(self):
        """Start the service: build the CUDA kernels the blocks use (on a
        card), then run the pipeline supervised on a background thread
        with the health pusher beside it.  -> self."""
        if self._run_thread is not None:
            raise RuntimeError("service already started")
        t0 = time.perf_counter()
        # The kernel_cache flag sends the builds where later processes
        # find them (cache.py).
        from . import cache as _kcache
        _kcache.maybe_enable_from_config()
        if self.pipeline.device.type == "cuda":
            # The counterpart of the JAX package's compilation-cache warm
            # start: no kernel is built inside the watchdog's horizon.
            from . import build
            build.build_all()
        self.start_s = time.perf_counter() - t0
        self._state = "running"
        self._started_t = time.monotonic()

        def _run():
            try:
                self.pipeline.run(supervise=self.supervisor)
            except BaseException as e:  # noqa: BLE001 — surfaced in stop()
                self._run_error = e
                with self._lock:
                    if self._state != "stopped":
                        self._state = "escalated"

        self._run_thread = threading.Thread(
            target=_run, name=f"{self.name}.run", daemon=True)
        self._run_thread.start()
        self._health_thread = threading.Thread(
            target=self._health_loop, name=f"{self.name}.health",
            daemon=True)
        self._health_thread.start()
        return self

    def wait(self, timeout=None):
        """Join the run thread; True if it finished."""
        t = self._run_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    @property
    def running(self):
        t = self._run_thread
        return t is not None and t.is_alive()

    @property
    def state(self):
        with self._lock:
            return self._state

    def stop(self, timeout=None, join_grace=1.0):
        """Bounded-quiesce the pipeline, stop supervision and the health
        pusher, and build the ServiceExitReport.  Idempotent: every later
        or concurrent call returns the same report."""
        with self._stop_lock:
            return self._stop_locked(timeout, join_grace)

    def _stop_locked(self, timeout, join_grace):
        if self.exit_report is not None:
            return self.exit_report
        timeout = self.spec.quiesce_timeout_s if timeout is None \
            else float(timeout)
        uptime = round(time.monotonic() - self._started_t, 3) \
            if self._started_t is not None else 0.0
        drain = self.pipeline.shutdown(timeout=timeout,
                                       join_grace=join_grace)
        self.wait(timeout + join_grace + 5.0)
        self._health_stop.set()
        ht = self._health_thread
        if ht is not None:
            ht.join(timeout=2.0)
        self.supervisor.stop()
        escalation = None
        if self.supervisor.failure is not None:
            escalation = dict(self.supervisor.failure.report)
        error = None
        if self._run_error is not None and escalation is None:
            error = repr(self._run_error)
        wedged = bool(drain.wedged)
        if escalation is not None or error is not None or wedged:
            code, state = EXIT_ESCALATED, "escalated"
        elif self.degraded or self.shard_degraded or not drain.clean:
            code, state = EXIT_DEGRADED, "degraded"
        else:
            code, state = EXIT_CLEAN, "stopped"
        with self._lock:
            self._state = "stopped" if code == EXIT_CLEAN else state
        self.exit_report = ServiceExitReport(
            exit_code=code, state=state, drain=drain,
            counters=self.supervisor.counters,
            recovery=self.supervisor.recovery_stats(),
            ledger=self.ledger.summary(),
            degrade_episodes=self.degrade_episodes,
            degraded_at_stop=self.degraded or self.shard_degraded,
            escalation=escalation,
            error=error, uptime_s=uptime,
            availability=self._availability())
        self._push_health()
        _release_block_names(self._ns_names)
        return self.exit_report

    # ------------------------------------------------------ live respec
    def respec(self, stage_name, new_stage, timeout=None):
        """Replace stage `stage_name` of the running pipeline with
        `new_stage` (a StageSpec) at a gulp edge (module docstring).
        `timeout`: the quiesce's (default the spec's quiesce_timeout_s).
        -> the record (also appended to `respecs`): stage, outcome
        ('drained' / 'interrupted'), rolled_back, splice_s (quiesce start
        to the replacement's start) and downtime_s (to its first gulp;
        None where none came within `timeout`)."""
        from .pipeline import SourceBlock
        if not isinstance(new_stage, StageSpec):
            raise TypeError("respec() replaces a stage with a StageSpec")
        with self._stop_lock:
            if self.exit_report is not None:
                raise RuntimeError("service already stopped")
            if self._run_thread is None:
                raise RuntimeError("service not started")
            idx = next((i for i, st in enumerate(self.spec.stages)
                        if st.name == stage_name), None)
            if idx is None:
                raise KeyError(f"no stage named {stage_name!r}")
            old_stage = self.spec.stages[idx]
            old = self.blocks[stage_name]
            if old not in self.pipeline.blocks:
                raise ValueError(
                    f"stage {stage_name!r} (block {old.name!r}) was "
                    f"absorbed into a fused group: respec needs a "
                    f"standalone block (build that stage outside "
                    f"block_scope(fuse=True))")
            if isinstance(old, SourceBlock) or not old.irings:
                raise ValueError(
                    f"stage {stage_name!r} is a source: respec splices at "
                    f"the input ring; sources restart through the "
                    f"supervisor instead")
            if new_stage.kind == "capture":
                raise ValueError("a capture stage cannot be spliced in")
            if old._thread_done:
                raise RuntimeError(f"stage {stage_name!r} has finished its "
                                   f"stream: there is nothing to respec")
            timeout = self.spec.quiesce_timeout_s if timeout is None \
                else float(timeout)
            t0 = time.monotonic()
            rec = {"stage": stage_name, "outcome": None,
                   "rolled_back": False, "splice_s": None,
                   "downtime_s": None}
            rec["outcome"] = self.pipeline.quiesce_block(old,
                                                         timeout=timeout)
            if rec["outcome"] == "wedged":
                # The block ignored the stop and the interrupts: nothing
                # was spliced; only a stop or an escalation can follow.
                self.respecs.append(rec)
                raise RuntimeError(
                    f"respec of {stage_name!r}: stage wedged during "
                    f"quiesce (timeout {timeout}s): respec aborted")
            if old._splice_handoff is None:
                # Its stream ended before the stop reached it.
                self.respecs.append(rec)
                raise RuntimeError(f"stage {stage_name!r} finished its "
                                   f"stream during the quiesce: there is "
                                   f"nothing to respec")
            build_error = None
            try:
                new = self._splice_build(new_stage, old)
                used_stage = new_stage
            except BaseException as e:  # noqa: BLE001 — re-raised below
                # Rollback: the old stage, rebuilt through the same
                # splice, keeps the service streaming under its spec.
                build_error = e
                rec["rolled_back"] = True
                new = self._splice_build(old_stage, old)
                used_stage = old_stage
            if isinstance(new, CandidateDetectBlock):
                new.ledger = self.ledger
                if self.degraded:
                    new.raise_threshold(self._degrade_factor)
                    if self.spec.degrade_shed_every > 0:
                        new.shed_every = self.spec.degrade_shed_every
            # The replacement inherits the open writing of the rings and
            # the predecessor's place in the input stream.
            new._adopted_began_writing = old._began_writing
            new._adopted_handoff, old._splice_handoff = \
                old._splice_handoff, None
            if old._splice_mid_sequence:
                new._splice_resume_frame = int(old._loop_frame or 0)
            self.supervisor.replace_block(old, new,
                                          policy=used_stage.policy())
            self.pipeline.splice_forget(old)
            self.blocks[stage_name] = new
            self.spec.stages[idx] = used_stage
            self.pipeline.splice_start(new)
            rec["splice_s"] = round(time.monotonic() - t0, 6)
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                if self._block_progressed(new):
                    rec["downtime_s"] = round(time.monotonic() - t0, 6)
                    break
                time.sleep(0.005)
            self.respec_downtime_s += rec["downtime_s"] \
                if rec["downtime_s"] is not None else rec["splice_s"]
            self.respecs.append(rec)
            self.supervisor.record_respec(
                new, stage=stage_name, outcome=rec["outcome"],
                rolled_back=rec["rolled_back"], splice_s=rec["splice_s"],
                downtime_s=rec["downtime_s"])
            if build_error is not None:
                raise build_error
            return rec

    def _splice_build(self, stage, old):
        """Build `stage` as the replacement of the quiesced block `old`,
        adopting old's output rings.  -> the new block; on a failure the
        partial build is undone (block list, adopted ring ownership,
        stray fresh rings) and the error re-raised."""
        pipe = self.pipeline
        n0 = len(pipe.blocks)
        pipe._ring_adoptions[old.name] = list(old.orings)
        try:
            with pipe:
                new = self._build_stage(stage, old.irings[0])
            added = pipe.blocks[n0:]
            if len(added) != 1 or added[0] is not new:
                raise ValueError(
                    f"respec of {old.name!r}: the replacement factory "
                    f"built {len(added)} blocks; a live splice replaces "
                    f"exactly one")
            if new.name != old.name:
                raise ValueError(
                    f"respec of {old.name!r}: the replacement block is "
                    f"named {new.name!r}; a live splice keeps the block "
                    f"name (rings and supervision key on it: a custom "
                    f"factory passes name=)")
            if list(new.orings) != list(old.orings):
                raise ValueError(
                    f"respec of {old.name!r}: the replacement must adopt "
                    f"the stage's output rings exactly (it has "
                    f"{len(new.orings)}, the stage {len(old.orings)})")
            # What the replacement builds for its input (M1 for a map
            # stage) is built here, where a failure rolls back.
            iseqs = old._splice_handoff[1] if old._splice_handoff else None
            preflight = getattr(new, "preflight", None)
            if iseqs is not None and preflight is not None:
                preflight(iseqs[0])
            return new
        except BaseException:
            for b in pipe.blocks[n0:]:
                for r in list(b.orings):
                    if r in old.orings:
                        r.owner = old
                    elif r in pipe.rings:
                        pipe.rings.remove(r)
            del pipe.blocks[n0:]
            raise
        finally:
            pipe._ring_adoptions.pop(old.name, None)

    @staticmethod
    def _block_progressed(block):
        if getattr(block, "gulps_seen", 0) > 0:
            return True
        return block.perf_totals.get("process", 0.0) > 0.0

    # ----------------------------------------------------- event policy
    def _on_supervise_event(self, ev):
        self.ledger.note_event(ev)
        if ev.kind == "restart":
            self._last_restart_t = time.monotonic()
            remaining = self.supervisor.budget_remaining(ev.block)
            if remaining is not None and remaining <= self._degrade_margin:
                self._enter_degraded(ev.block, remaining)
        elif ev.kind == "shard_evict" and self.spec.degrade_shards:
            self._enter_shard_degraded(ev.block, ev.details.get("device"))
        elif ev.kind == "escalate":
            with self._lock:
                if self._state in ("running", "degraded"):
                    self._state = "escalated"
        cb = self._user_on_event
        if cb is not None:
            try:
                cb(ev)
            except Exception:  # noqa: BLE001 — observer only
                pass

    def on_event(self, cb):
        """Register an additional supervise-event observer."""
        self._user_on_event = cb
        return self

    def _detect_blocks(self):
        return [b for b in self.blocks.values()
                if isinstance(b, CandidateDetectBlock)]

    def _enter_degraded(self, block_name, remaining):
        with self._lock:
            if self.degraded:
                return
            self.degraded = True
            self.degrade_episodes += 1
            self._degraded_since = time.monotonic()
            if self._state == "running":
                self._state = "degraded"
        for det in self._detect_blocks():
            det.raise_threshold(self._degrade_factor)
            if self.spec.degrade_shed_every > 0:
                det.shed_every = self.spec.degrade_shed_every
        self.supervisor.record_degrade(
            block_name, budget_remaining=remaining,
            detect_factor=self._degrade_factor,
            shed_every=self.spec.degrade_shed_every)
        telemetry.track("service:degrade")

    def _enter_shard_degraded(self, block_name, device):
        """A shard was evicted: the service goes on with the surviving
        shards (degraded-mesh mode) instead of escalating; the ledger
        books the missing gulp as shed, and the state and exit code show
        the impairment until the shard is restored."""
        first = False
        with self._lock:
            if not self.shard_degraded:
                self.shard_degraded = True
                self.shard_degrade_episodes += 1
                first = True
            if self._state == "running":
                self._state = "degraded"
        if first:
            self.supervisor.record_degrade(
                block_name, reason="shard_evicted", shard_device=device)
            telemetry.track("service:degrade_shards")

    def _maybe_restore_shards(self):
        """The health loop's auto-restore: every evicted shard whose
        health has returned (`faultdomain.mark_restored`) goes back into
        the mesh, and once no eviction remains (whoever restored it) the
        degraded-mesh state clears."""
        if not self.spec.degrade_shards:
            return
        from .parallel import faultdomain
        restored = []
        for dev in faultdomain.restorable_devices():
            # restore() reports the transition: a concurrent restorer
            # cannot double-book it.
            if faultdomain.restore(dev):
                self.supervisor.record_shard_restore(dev)
                restored.append(dev)
        if self.shard_degraded and not faultdomain.evicted_devices():
            with self._lock:
                was = self.shard_degraded
                self.shard_degraded = False
                if self._state == "degraded" and not self.degraded:
                    self._state = "running"
            if was:
                self.supervisor.record_degrade(
                    "mesh", recovered=True, restored_shards=restored)

    def _maybe_recover(self):
        """Leave degraded mode once every stage's budget has headroom and
        a full policy window has passed without a restart."""
        if not self.degraded:
            return
        last = self._last_restart_t
        window = max(s.policy().window_s for s in self.spec.stages)
        if last is not None and time.monotonic() - last < window:
            return
        for s in self.spec.stages:
            remaining = self.supervisor.budget_remaining(self.blocks[s.name])
            if remaining is not None and remaining <= self._degrade_margin:
                return
        with self._lock:
            if not self.degraded:
                return
            self.degraded = False
            self._degraded_since = None
            if self._state == "degraded" and not self.shard_degraded:
                self._state = "running"
        for det in self._detect_blocks():
            det.restore_threshold()
            det.shed_every = 0
        self.supervisor.record_degrade("service", recovered=True)

    # ----------------------------------------------------------- health
    def _availability(self):
        """The mesh fault-domain summary: availability_pct over every mesh
        a guarded dispatch touched, shard-recovery p50/p99 (the
        supervisor's shard-fault restarts), per-shard downtime and the
        eviction and restore counts (100 % and empty with no mesh), and
        the live respecs' downtime."""
        from .parallel import faultdomain
        counters = self.supervisor.counters
        return {
            "availability_pct": round(faultdomain.availability_pct(), 4),
            "shard_recovery": self.supervisor.shard_recovery_stats(),
            "shard_evictions": counters.get("shard_evictions", 0),
            "shard_restores": counters.get("shard_restores", 0),
            "downtime_s_by_shard": faultdomain.downtime_by_device(),
            "shard_degrade_episodes": self.shard_degrade_episodes,
            "respecs": len(self.respecs),
            "respec_downtime_s": round(self.respec_downtime_s, 6),
        }

    def health(self):
        """Structured service-health snapshot (what the health thread
        pushes to the `<pipeline>/service` ProcLog)."""
        now = time.monotonic()
        sup = self.supervisor
        blocks = {}
        for stage in self.spec.stages:
            b = self.blocks[stage.name]
            hb = b._heartbeat
            perf = dict(b.perf_totals)
            total = sum(perf.values())
            stall = 100.0 * (perf.get("acquire", 0.0) +
                             perf.get("reserve", 0.0)) / total \
                if total else None
            blocks[stage.name] = {
                "heartbeat_age_s": round(now - hb, 3)
                if hb is not None else None,
                "stall_pct": round(stall, 1) if stall is not None else None,
                "queued_gulps": b._async_queue_depth(),
                "budget_remaining": sup.budget_remaining(b),
                "tier": stage.tier,
            }
        capture_stats = None
        for b in self.blocks.values():
            stats = getattr(b, "stats", None)
            if isinstance(stats, dict) and "ngood" in stats:
                capture_stats = stats
                break
        detect = {}
        for det in self._detect_blocks():
            detect = {"ncandidates": det.ncandidates,
                      "threshold": det.threshold,
                      "frames_seen": det.frames_seen,
                      "gulps_shed": det.gulps_shed,
                      "last_candidate": det.candidates[-1]
                      if det.candidates else None}
        failure = sup.failure
        from .parallel import faultdomain
        return {
            "state": self.state,
            "uptime_s": round(now - self._started_t, 3)
            if self._started_t is not None else 0.0,
            "degraded": self.degraded or self.shard_degraded,
            "degrade_episodes": self.degrade_episodes,
            "shard_degraded": self.shard_degraded,
            "capture": capture_stats,
            "blocks": blocks,
            "counters": sup.counters,
            "recovery": sup.recovery_stats(),
            "detect": detect,
            "ledger": self.ledger.summary(),
            "shards": faultdomain.shard_health(),
            "availability": self._availability(),
            "elastic": {
                "respecs": len(self.respecs),
                "respec_downtime_s": round(self.respec_downtime_s, 6),
                "last_respec": dict(self.respecs[-1])
                if self.respecs else None,
            },
            "last_escalation": dict(failure.report)
            if failure is not None else None,
        }

    def _push_health(self):
        try:
            snap = self.health()
            entry = {
                "state": snap["state"],
                "uptime_s": snap["uptime_s"],
                "degraded": int(snap["degraded"]),
                "restarts": snap["counters"]["restarts"],
                "escalations": snap["counters"]["escalations"],
                "shed_frames": snap["counters"]["shed_frames"],
                "recoveries": snap["counters"]["recoveries"],
                "committed_frames": snap["ledger"]["committed_frames"],
                "lost_frames": snap["ledger"]["lost_frames"],
                "duplicated_frames": snap["ledger"]["duplicated_frames"],
                "ncandidates": snap["detect"].get("ncandidates", 0),
            }
            rec = snap["recovery"]
            if rec["count"]:
                entry["recovery_p50_s"] = round(rec["p50_s"], 6)
                entry["recovery_p99_s"] = round(rec["p99_s"], 6)
            avail = snap["availability"]
            entry["availability_pct"] = avail["availability_pct"]
            if avail["shard_recovery"]["count"]:
                entry["shard_recovery_p50_s"] = round(
                    avail["shard_recovery"]["p50_s"], 6)
                entry["shard_recovery_p99_s"] = round(
                    avail["shard_recovery"]["p99_s"], 6)
            cap = snap["capture"]
            if cap:
                entry.update({f"capture_{k}": v for k, v in cap.items()})
            entry["snapshot"] = json.dumps(snap, default=str)
            self._proclog.update(entry)
        except Exception:  # noqa: BLE001 — observability only
            pass

    def _health_loop(self):
        while not self._health_stop.wait(self._health_interval):
            self._maybe_restore_shards()
            self._maybe_recover()
            self._push_health()
