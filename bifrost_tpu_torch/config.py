"""Feature-gate registry (counterpart of bifrost_tpu/config.py), holding
only the flags the port reads so far.

Call sites read through `config.get(name)`; `config.set(name, value)`
overrides the default.  A flag that names an environment variable (the
JAX package's name for it) reads it when no override is set: override >
environment > default, as the JAX registry does.  A flag may carry a
`validate` callable: a bad value raises at `set` and again at `get`.
Flags that steer per-sequence state are LATCHED by the blocks that read
them (`hold_latch` / `release_latch`): while a sequence holds the latch,
`set` and `reset` on that flag raise, naming the block, because a new
value could only half-apply mid-stream.
"""

from __future__ import annotations

import os
import threading

_lock = threading.Lock()
_overrides = {}
_latch_guards = {}   # name -> owners latching it, one entry per sequence


def _parse_bool(s):
    return str(s).lower() in ("1", "true", "yes", "on")


class Flag(object):
    def __init__(self, name, default, description, validate=None, env=None):
        self.name = name
        self.default = default
        self.description = description
        self.validate = validate
        self.env = env

    def value(self):
        if self.name in _overrides:
            value = _overrides[self.name]
        else:
            raw = os.environ.get(self.env, "") if self.env else ""
            if raw != "":
                kind = type(self.default)
                value = _parse_bool(raw) if kind is bool else kind(raw)
            else:
                value = self.default
        if self.validate is not None:
            self.validate(value)
        return value


# Deepest in-order queue a block's worker accepts (the JAX package's
# MAX_ASYNC_DEPTH).
MAX_ASYNC_DEPTH = 16


def _validate_async_depth(value):
    if not isinstance(value, int) or isinstance(value, bool) or \
            not 1 <= value <= MAX_ASYNC_DEPTH:
        raise ValueError(
            f"pipeline_async_depth must be an integer in "
            f"[1, {MAX_ASYNC_DEPTH}], got {value!r}")


def _validate_chunk_nbyte(value):
    if not isinstance(value, int) or isinstance(value, bool) or \
            value < 0 or (value != 0 and value < 4096):
        raise ValueError(
            f"egress_chunk_nbyte must be 0 (whole-gulp staging) or an "
            f"integer >= 4096 bytes, got {value!r}")


def _validate_batch_npkt(value):
    if not isinstance(value, int) or isinstance(value, bool) or \
            not 1 <= value <= 4096:
        raise ValueError(
            f"capture_batch_npkt must be an integer in [1, 4096] "
            f"(recvmmsg packets per socket call), got {value!r}")


def _validate_nonneg_int(name, value):
    if not isinstance(value, int) or isinstance(value, bool) or value < 0:
        raise ValueError(f"{name} must be a non-negative integer, "
                         f"got {value!r}")


def _validate_ge_one(name, value):
    if not isinstance(value, (int, float)) or isinstance(value, bool) or \
            value < 1.0:
        raise ValueError(f"{name} must be a number >= 1, got {value!r}")


def _validate_nonneg_float(name, value):
    if not isinstance(value, (int, float)) or isinstance(value, bool) or \
            value < 0:
        raise ValueError(f"{name} must be a non-negative number, "
                         f"got {value!r}")


def _validate_pos_int(name, value):
    if not isinstance(value, int) or isinstance(value, bool) or value < 1:
        raise ValueError(f"{name} must be a positive integer, got {value!r}")


def _validate_pos_float(name, value):
    if not isinstance(value, (int, float)) or isinstance(value, bool) or \
            not value > 0:
        raise ValueError(f"{name} must be a positive number, got {value!r}")


FLAGS = {f.name: f for f in [
    Flag("fdmt_method", "auto",
         "Default FDMT executor: 'auto'/'cuda' (the merge step runs on "
         "the hand-written kernel for a CUDA tensor, its plain PyTorch "
         "version for a CPU tensor), 'plain' (the plain PyTorch merge "
         "step on any device), or 'naive' (the per-band unrolled "
         "executor, for tests).  Latched per sequence by FdmtBlock."),
    Flag("pfb_method", "auto",
         "Default PFB MAC method: 'auto'/'cuda' (kernel K2 for a CUDA "
         "tensor, its plain PyTorch version for a CPU tensor) or 'plain' "
         "(the plain version on any device).  Latched per sequence by "
         "PfbBlock."),
    Flag("beamform_method", "auto",
         "Default beamform method: 'auto'/'cuda' (kernel K4 for a CUDA "
         "tensor, its plain PyTorch version for a CPU tensor) or 'plain' "
         "(the plain version on any device).  Latched per sequence by "
         "BeamformBlock."),
    Flag("romein_method", "auto",
         "Default gridding method: 'auto'/'cuda' (kernels K6a/K6b for a "
         "CUDA tensor, their plain PyTorch versions for a CPU tensor) or "
         "'plain' (the plain versions on any device).  Latched per "
         "sequence by GridderBlock."),
    Flag("dq_flag_method", "auto",
         "Default RFI-flagger apply method: 'auto'/'cuda' (kernel K5a for "
         "a CUDA tensor, its plain PyTorch version for a CPU tensor) or "
         "'plain' (the plain version on any device).  The window "
         "statistics are shared by both.  Latched per sequence by "
         "RfiFlagBlock."),
    Flag("dq_cal_method", "auto",
         "Default gain-calibration apply method: 'auto'/'cuda' (kernel "
         "K5b for a CUDA tensor, its plain PyTorch version for a CPU "
         "tensor) or 'plain' (the plain version on any device).  Latched "
         "per sequence by GainCalBlock."),
    Flag("xengine_method", "auto",
         "Default int8 X-engine method: 'auto'/'cuda' (kernel X1 for a "
         "CUDA tensor, its plain PyTorch version for a CPU tensor) or "
         "'plain' (the plain version on any device).  The port's kernel "
         "selector only: the JAX engine is jnp, with no such flag.  "
         "Latched per sequence by CorrelateBlock(engine='int8')."),
    Flag("map_method", "auto",
         "Default bf.map engine (ops/map.py): 'auto'/'cuda' (kernel M1, "
         "one CUDA kernel generated per expression and built by nvcc, "
         "for a CUDA tensor; the plain PyTorch engine for a CPU tensor) "
         "or 'plain' (the plain engine on any device).  Three forms the "
         "generator refuses by design (extra_code, the eager "
         "explicit-index and scatter forms, forward or unbounded "
         "streams): 'auto' resolves them to 'plain', 'cuda' raises.  "
         "What the kernel does not implement yet raises for a CUDA "
         "tensor under 'auto' and 'cuda' alike (map_codegen.Unsupported: "
         "half types; sub-byte real storage and packed complex types "
         "other than ci4; complex transcendentals other than exp and "
         "abs, complex pow; shifts and 'not'; chained comparisons; ** of "
         "two run-time scalars; statements that do not depend on an "
         "array; constant arrays; eager statements of different shapes; "
         "ranks above 8); 'plain' runs those.  The JAX package's 'jnp' "
         "and 'pallas' are refused with the name of their counterpart.  "
         "Latched per sequence by MapBlock."),
    Flag("fft_method", "auto",
         "Default FFT engine: 'auto'/'torch' (torch.fft: cuFFT on the "
         "card).  The JAX package's 'xla' and MXU 'matmul*' engines are "
         "TPU methods and are refused.  Latched per sequence by "
         "FftBlock."),
    Flag("pipeline_fuse", True,
         "Pipeline-graph fusion (fuse.py): at Pipeline.run each maximal "
         "run of fuse-scoped device blocks becomes one fused group, one "
         "block on one thread and one CUDA stream with no rings between "
         "its stages.  Off keeps every block, the unfused baseline.  "
         "Latched per sequence by every fused group."),
    Flag("mesh_defer_reduce", True,
         "Defer mesh reduction collectives to emit boundaries: the "
         "sharded X- and B-engines carry per-shard partials across gulps "
         "(and across fused chains, pipeline.MeshFusedBlock) and run ONE "
         "psum per emitted integration instead of one per gulp "
         "(parallel/fuse.py).  Off = the per-gulp-psum engines, the "
         "collective-count baseline.  Latched per sequence by the mesh "
         "compute blocks: a carried partial cannot change reduction "
         "discipline mid-stream.",
         env="BIFROST_TPU_MESH_DEFER_REDUCE"),
    Flag("mesh_gulp_factor", 1,
         "Multiply the resolved gulp_nframe by this factor for blocks "
         "under a `mesh=` scope (blocks that pin their gulp, accumulate, "
         "are exempt through Block.mesh_gulp_scale_ok): larger sharded "
         "gulps amortize the per-gulp work of every shard.  Chain "
         "geometry must still divide (integration length % gulp == 0).  "
         "Latched per sequence by the mesh compute blocks.  1 is inert.",
         validate=lambda v: _validate_pos_int("mesh_gulp_factor", v),
         env="BIFROST_TPU_MESH_GULP_FACTOR"),
    Flag("mesh_collective_timeout_s", 0.0,
         "Mesh collective watchdog deadline in seconds: a sharded "
         "dispatch (Block.mesh_dispatch, parallel.fx.make_fx_step) that "
         "has not returned within it is declared a supervised "
         "ShardFault(device, block, gulp) (parallel/faultdomain.py).  0 "
         "disables the watchdog.  Set it above the longest healthy "
         "dispatch, kernel builds included, or pay spurious evictions.",
         validate=lambda v: _validate_nonneg_float(
             "mesh_collective_timeout_s", v),
         env="BIFROST_TPU_MESH_COLLECTIVE_TIMEOUT"),
    Flag("fused_async", True,
         "A fused group with an accumulate tail and a guaranteed reader "
         "hands the gulps that complete no integration to its worker "
         "thread, which runs them on the group's stream while the block "
         "thread goes on to the next gulp's ring work.  Latched per "
         "sequence."),
    Flag("pipeline_async_depth", 1,
         "Async gulp executor depth for base source, transform and sink "
         "blocks: with depth > 1 a block that touches the card runs up to "
         "this many gulps in order on its worker thread, on the block's "
         "CUDA stream, while the block thread reserves, acquires (and a "
         "source stages) the next gulp's spans.  1 (default) keeps the "
         "synchronous reserve -> compute -> commit loop; lossy readers, "
         "sources that shed or fail on overrun, host-only blocks and "
         "strict_sync stay synchronous.  Fused groups with an accumulate "
         "tail take max(2, depth) as their worker's depth, and the "
         "egress stager of a DeviceSinkBlock keeps max(2, depth) gulps "
         "in flight.  Latched per sequence.",
         validate=_validate_async_depth),
    Flag("strict_sync", False,
         "Leave nothing in flight when a block's device scope ends: each "
         "gulp synchronises the block's CUDA stream before its commit, "
         "the async gulp executor and fused_async stay off, and the "
         "fusion planner keeps every block on its own (fully synchronous "
         "per-gulp mode; slower, simplest timing)."),
    Flag("serialize_dispatch", False,
         "One process-wide lock around every block's device scope, so "
         "one block's device work is issued at a time.  The JAX "
         "package's default probes the backend and turns this on only "
         "for a tunneled PJRT client; the port has no such backend, so "
         "its default is off."),
    Flag("fir_method", "auto",
         "Default FIR engine: 'auto'/'cuda' (kernel K2 for a CUDA tensor, "
         "its plain PyTorch version for a CPU tensor), 'plain' (the plain "
         "MAC on any device), or 'conv' (F.conv1d with groups=lanes, the "
         "JAX package's grouped-convolution benchmark baseline; not "
         "bitwise).  The JAX package's 'pallas' and 'jnp' are refused "
         "with the name of their counterpart.  The legacy fir_pallas bool "
         "forces 'cuda'.  Latched per sequence by FirBlock."),
    Flag("fir_pallas", False,
         "Legacy bool of the JAX package: when set, 'auto' FIR plans take "
         "kernel K2 ('cuda'), the port's counterpart of the Pallas "
         "kernel."),
    Flag("egress_staging", True,
         "Staged device->host egress for DeviceSinkBlock sinks on 'cuda' "
         "rings (egress.py): copies into pooled pinned buffers on a side "
         "stream while the consumer drains the gulp before.  Off = "
         "one blocking copy per gulp on the block thread.  Latched per "
         "sequence."),
    Flag("egress_chunk_nbyte", 4 << 20,
         "Egress staging chunk in bytes: a staged gulp bound for a sink's "
         "own destination (open_dest) is copied to the host in "
         "frame-aligned pieces of at most this size; a pooled gulp is one "
         "copy.  0 stages whole gulps.  Latched per sequence.",
         validate=_validate_chunk_nbyte),
    Flag("capture_batch_npkt", 64,
         "recvmmsg batch depth of the UDP capture engine (packets per "
         "socket call, [1, 4096]): per-batch bookkeeping amortises over "
         "this many packets.  Read by UDPCaptureBlock when it builds its "
         "engine (a new value applies to the next engine, not "
         "mid-stream).", validate=_validate_batch_npkt),
    Flag("service_degrade_margin", 1,
         "Service degraded-mode trigger: when a supervised stage's "
         "remaining restart budget (within its sliding window) drops to "
         "this value or below, the service degrades (detect-threshold "
         "raise, optional gulp shedding) instead of riding the budget "
         "into a SupervisorEscalation.  0 degrades only on the last "
         "restart.",
         validate=lambda v: _validate_nonneg_int("service_degrade_margin",
                                                 v)),
    Flag("service_degrade_detect_factor", 2.0,
         "Multiplier applied to candidate-detection thresholds while a "
         "service runs degraded (restored on recovery).  Must be >= 1.",
         validate=lambda v: _validate_ge_one(
             "service_degrade_detect_factor", v)),
    Flag("service_health_interval_s", 2.0,
         "Seconds between service health-snapshot pushes to the "
         "<pipeline>/service ProcLog.",
         validate=lambda v: _validate_pos_float(
             "service_health_interval_s", v)),
    Flag("trace", False,
         "Named trace ranges around block and gulp work (trace.py): "
         "torch.profiler.record_function ranges, and NVTX ranges on the "
         "card, visible in a start_profile capture and in Nsight.  Off "
         "(default): trace_scope costs nothing.  Read per call.",
         env="BIFROST_TPU_TRACE"),
    Flag("telemetry_endpoint", "",
         "URL the usage counters are POSTed to at exit (telemetry.py); "
         "empty (default) sends nothing, the counters still aggregate "
         "in the process.",
         env="BIFROST_TPU_TELEMETRY_ENDPOINT"),
    Flag("kernel_cache", "",
         "Where the nvcc builds of build.py persist across processes "
         "(cache.py), enabled at Service/FleetScheduler start.  Empty "
         "(default) = off: the builds go to bifrost_tpu_torch/build/; "
         "\"1\"/\"on\" = ~/.bifrost_tpu_torch/kernel_cache; any other "
         "value = that directory.  kernel_cache_info() shows the resolved "
         "state in the fleet health snapshot.",
         env="BIFROST_TPU_KERNEL_CACHE"),
    Flag("portaudio_lib", "",
         "Path to the PortAudio shared library (portaudio.py); empty "
         "resolves it with ctypes.util.find_library and the common "
         "sonames.",
         env="BIFROST_TPU_PORTAUDIO_LIB"),
    Flag("fleet_health_interval_s", 1.0,
         "Seconds between fleet-scheduler control-loop passes (queued-"
         "tenant admission, finished-tenant reaping, eviction-driven "
         "preemption, usage sampling, and the fleet health-snapshot push "
         "to the <fleet>/fleet ProcLog).  A device-registry eviction "
         "pokes the loop at once regardless.",
         validate=lambda v: _validate_pos_float(
             "fleet_health_interval_s", v),
         env="BIFROST_TPU_FLEET_HEALTH_INTERVAL"),
    Flag("fleet_max_queue", 16,
         "Admission queue depth of the fleet scheduler: tenants beyond "
         "this many waiting for resources are rejected at submit time "
         "instead of queued (FleetScheduler(max_queue=...) overrides).",
         validate=lambda v: _validate_nonneg_int("fleet_max_queue", v),
         env="BIFROST_TPU_FLEET_MAX_QUEUE"),
    Flag("fleet_preempt_quiesce_s", 5.0,
         "Bounded-quiesce timeout of a tenant the fleet scheduler "
         "preempts or retires: its pipeline gets this long to drain "
         "before the deadline interrupts.",
         validate=lambda v: _validate_pos_float(
             "fleet_preempt_quiesce_s", v),
         env="BIFROST_TPU_FLEET_PREEMPT_QUIESCE"),
    Flag("fleet_starvation_s", 0.0,
         "Queue starvation guard: a tenant waiting longer than this many "
         "seconds has its effective priority aged up one step per "
         "elapsed window (the starvation_promotions counter records each "
         "step).  0 (default) keeps strict priority order.",
         validate=lambda v: _validate_nonneg_float("fleet_starvation_s",
                                                   v),
         env="BIFROST_TPU_FLEET_STARVATION"),
]}


def describe():
    """A table of every flag, its environment variable and its value
    (bifrost_tpu/config.py:440)."""
    lines = []
    for f in FLAGS.values():
        try:
            val = f.value()
        except ValueError as e:        # an invalid environment setting
            val = f"<error: {e}>"
        lines.append(f"{f.name:20s} {str(f.env):34s} = {val!r}\n"
                     f"{'':20s} {f.description}")
    return "\n".join(lines)


def hold_latch(name, owner):
    with _lock:
        _latch_guards.setdefault(name, []).append(str(owner))


def release_latch(name, owner):
    with _lock:
        owners = _latch_guards.get(name)
        if owners is not None:
            try:
                owners.remove(str(owner))
            except ValueError:
                pass
            if not owners:
                _latch_guards.pop(name, None)


def _check_unlatched(name):
    owners = _latch_guards.get(name)
    if owners:
        names = ", ".join(sorted(dict.fromkeys(owners)))
        raise RuntimeError(
            f"config flag {name!r} is latched by active sequence(s) "
            f"[{names}]: it is resolved once per block sequence and "
            f"cannot change mid-sequence")


def get(name):
    """Current value of a flag (override, else default)."""
    return FLAGS[name].value()


def set(name, value):  # noqa: A001 — mirrors the JAX package's API
    if name not in FLAGS:
        raise KeyError(f"unknown flag {name!r}; known: {sorted(FLAGS)}")
    if FLAGS[name].validate is not None:
        FLAGS[name].validate(value)
    with _lock:
        _check_unlatched(name)
        _overrides[name] = value


def reset(name=None):
    """Drop programmatic overrides (all of them when name is None)."""
    with _lock:
        names = list(_overrides) if name is None else [name]
        for n in names:
            if n in _overrides:
                _check_unlatched(n)
        for n in names:
            _overrides.pop(n, None)
