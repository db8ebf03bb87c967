"""Chip smoke run of bifrost_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile every CUDA source of the port (one nvcc each, in
             parallel) from this checkout.
3. kernels — hold each kernel against its plain PyTorch version at the
             shapes the main paths give it, bitwise, and time both, the
             bound and a library call for the same function (K4 and K5a
             also on their edge shapes, K4_EDGES and K5A_EDGES, each
             launch's route asserted; X1 on XE_EDGES and at the gulp
             guard's edge XE_GUARD, into outputs prefilled with NaN,
             its corner turn and tiles also timed apart); K1 at the FRB
             search's shape and at the beam search's (8 beams in one
             launch a merge step); time the PFB's DFT matmuls per
             gulp.  The gridders K6a/K6b are also held against a
             rerun, and their tiled plan's geometry, sectors per plane,
             layout floor, host build time and each kernel
             instantiation's registers and shared memory get a line of
             their own.  The same plans are built from card tensors
             (origin 'device', ops/romein_plan.py), held bitwise against
             the host-built plans table by table, and K6a/K6b launched
             from them bitwise their host-origin launches, both build
             times and both kernels' times a frame beside each other;
             K6b's plan is also rebuilt for RM_NSEQ sequences of new
             positions from each origin.  The flagger's window step:
             W1s, its statistics, held bitwise against its plain
             version on W1S_EDGES (its register form: both algorithms,
             [frbflag]'s 256 windows of 16 frames x 4096 channels,
             [dq]'s one window of 16 x 2,097,152 cells, windows of 1 to
             32 frames, NaN samples of both signs, -0.0/+0.0 ties,
             strided power) and W1S_SELECT_EDGES (its select form,
             windows of 33 to 65,536 frames); W1m, the cross-cell
             median MAD, against stats.median on W1M_EDGES (one and two
             cells, odd and even rows, NaN rows, both its forms); and
             W1, its baseline walk, against its plain walk on W1_EDGES
             (tail segments, the ring's chunk edges, ties at each
             threshold, NaN and -0.0 statistics, the warm cap); all
             three timed at both paths' shapes (CUDA graphs) beside
             the torch-sort passes W1s and W1m replace and W1's latency
             floor (its walker's dependent chain in SASS at the SM
             clock); W1s's select form and W1m also at the flag
             block's default of one window a gulp ([frbflag]'s 4096 x
             4096), beside the route they replace.
4. main    — drive the FRB-search chain (`frb_search_pipeline`) at full
             width: 4096 channels of u8 power at the LWA band (40 MHz,
             9.28 kHz, 1 ms), FDMT max_delay 2048, gulps of 4096 frames,
             12 gulps, with a dispersed burst injected from a fixed seed.
             The kernels' launch counts are read from this run alone.
             The dedispersed gulps of the same chain are then compared
             bitwise against the chain with fdmt_method='plain'.
5. bengine — drive the LWA beam-search chain (`lwa_beam_search_pipeline`,
             unfused: fuse=False; phase 11 runs the fused form) at
             `lwa_instrument_spec`'s flagship width: ci8 voltages of
             256 stations x 2 pol, PFB 4096 channels x 4 taps, 8 beams
             integrated over 16 spectra, FDMT max_delay 64, one
             integration (65,536 frames) per gulp, B_NINT = 66
             integrations (a 16-integration block of seeded noise
             replayed 4.125 times).
             Launch counts are read from this run alone (K1: one launch
             per merge step for all 8 beams; every K2 launch on its
             vector kernel); steady state
             is timed from the first integration's beam powers to the
             last one's.  Its beam powers and dedispersed frames are
             compared bitwise against the chain with every method
             'plain', and the first integration's powers against an
             f64 numpy golden.
6. instrument — drive the whole LWA instrument (`lwa_instrument_pipeline`,
             unfused) on the same voltages at the same width, both
             branches fanned out from one PFB ring: the B branch above
             and the X/imaging
             branch (correlate -> transpose -> Romein grid at ngrid 128
             with the spec's rank-1 default kernel, kernel K6b -> FFT ->
             copy to the host).  Launch counts are read from this run
             alone (K1 and K2 as in phase 5); the B branch's outputs
             are compared bitwise with [bengine]'s, the first 2 images
             with the same pipeline run 2 integrations deep with every
             method 'plain', and the first
             image on 8 channels against an f64 numpy golden, and a
             2-integration run with `uvw` a card tensor (the gridder's
             plan built on the card, origin 'device' asserted, its
             proclog row read back) bitwise against the first 2 images.
             Then a 2-integration run with a seeded non-rank-1 kernel puts
             kernel K6a on the path, its images compared bitwise with
             the same run with every method 'plain'.
7. frbflag — the FRB search of phase 4 with the RFI flagger
             (`frb_search_pipeline(rfi_flag=dict(algo='mad', thresh=6.0,
             mad_factor=4.0, window=16))`, kernels W1s, W1m, W1 and
             K5a) on the same data
             with a seeded narrowband storm from the third gulp on (60
             channels blinking on with probability 0.8 per frame at
             255).  Launch counts are read from this run alone, every
             K5a launch must take its vector kernel, the burst must be
             found, every storm cell on for more than half
             of a window flagged in that window, and the dedispersed
             gulps bitwise equal to the chain with dq_flag_method and
             fdmt_method 'plain' and to the chain with dq_flag_method
             'plain' alone (the plain walk, a loop of some 28 launches a
             window), each run's steady frames/s printed beside the
             others'.  The chain with W1 is then traced over its
             NGULP gulps (`trace.start_profile`): the card's idle share
             and the device ops that take the most time a gulp.  Then
             the same search at the flag block's default window
             (`rfi_flag=dict(algo='mad')`: one window a gulp), its
             launches asserted a gulp (W1s's select form, W1m, W1's
             one-window form, K5a), every busy storm channel flagged,
             its masks and dedispersed gulps bitwise the same chain
             with dq_flag_method 'plain'.
8. dq      — the flagged, calibrated beam search at the flagship width,
             built from blocks: the voltages of phase 5 with a tone at
             the centre of one PFB channel on one station from the 9th
             integration on -> copy -> pfb -> rfi_flag(window=16) ->
             gaincal(seeded per-station gains) (kernel K5b) -> beamform
             -> transpose -> fdmt -> detect, B_NINT integrations.  Launch
             counts are read from this run alone (W1s and W1 once a
             gulp: a gulp is one window; W1m three times, a grid
             over the 2,097,152 cells), every K5a, K2 and W1
             launch must take its vector kernel; the tone's cells must
             be flagged in every window from its onset, the beam powers
             and dedispersed frames bitwise equal to the same chain with
             every method 'plain', the first integration within 1e-4 of
             the f64 golden (gains applied, flagged cells zeroed), and
             gaincal -> beamform within 1e-5 of beamform(gains=) over 4
             integrations.

9. gpuspec — the gpuspec spectrometer (testbench/gpuspec_simple.py:
             88-101), unfused, from the port's BlockChainer:
             read_guppi_raw -> copy('cuda') -> transpose -> fft(fine_time,
             fftshift) -> detect('stokes') -> merge_axes(freq, fine_freq)
             -> reduce(freq, F_AVG) -> accumulate(N_INT) -> write_sigproc.
             (a) File to file at the flagship geometry (GS_FLAGSHIP,
             bench.py:259-274: 64 ch x 16,384 x 2 pol ci8 a frame,
             F_AVG 64, N_INT 24, 64 frames; the GUPPI file written to a
             temporary directory by the port's io) after copy('system'),
             the .fil held against this script's numpy golden within the
             testbench's FFT bound, 32 eps sqrt(nfft) max|want|.  (b)
             The same with write_sigproc on the 'cuda' ring, the egress
             stager on the path: its .fil byte-identical to (a)'s, every
             output gulp staged.  (c) bench.py's run_framework shape,
             array_source -> ... -> callback_sink on the card, at the
             flagship and at a real 128 MiB GUPPI block (GS_GUPPI:
             NTIME 524,288, N_INT 4, 8 blocks replayed 4 times):
             samples/s whole and steady state, host seconds by block and
             phase, peak device memory, each stage's CUDA-event time a
             gulp; a second run bitwise equal to the first; on the real
             block two channels of the first integration against an f64
             numpy golden, at the flagship every integration against
             (a)'s golden.  No hand kernel is on the path (asserted).
10. egress — benchmarks/egress_tpu.py's run_chain shape, array_source
             -> copy('cuda') -> a pooled DeviceSinkBlock, staged and
             blocking in turns, EG_PAIRS pairs, at bench.py's dump shape
             (EG_DUMP: 16 x (4, 16,384) f32, gulp 4, depth 8; every run
             bitwise equal to the source) and at the instrument's image
             frame (EG_IMAGE: 4096 x 128 x 128 cf32, 512 MiB a gulp, 12
             gulps replaying 4 distinct frames), there beside
             copy('system') -> callback_sink, the image egress's shape,
             and fed two ways: from the host (the replaying source ->
             copy('cuda'), run_chain's shape) and from frames already on
             the card (the replaying source writing the 'cuda' ring, as
             the instrument's FFT hands its image over; the sink then
             paces the chain).  One more run of each, 8 gulps, is checked
             gulp by gulp against the source.  Bytes/s on the host clock,
             whole run and steady state (from the 9th gulp on the host
             to the last, past the start-up backlog); one 512 MiB D2H
             through the stager, a pageable copy_ (into a buffer used
             before and into a new one) and a pinned copy_.

11. fusion — after [dq], on its voltages: the four chains the reference
             fuses by default, each fused (its blocks in
             `block_scope(fuse=True)` where the reference builds them
             so) and unfused in FUSION_PAIRS turns: the beam search
             (`lwa_beam_search_pipeline(fuse=)`, B_NINT integrations),
             the DQ beam search of [dq] with copy -> pfb -> rfi_flag ->
             gaincal -> beamform -> transpose -> fdmt in one fuse scope
             (B_NINT), the instrument (`lwa_instrument_pipeline(fuse=)`,
             cut
             to FX_NINT = 8 integrations, the first FX_KEEP images
             compared) and gpuspec (c) at GS_FLAGSHIP and GS_GUPPI.
             Each fused run prints its `fusion_report()` (groups,
             constituents, ring hops eliminated, refusals); every run's
             launch counts must equal the unfused run's and its outputs
             (dedispersed frames, images, integrated spectra) be bitwise
             the unfused run's.  Rates whole and steady, host seconds by
             block and phase, peak device memory; one beam gulp's pinned
             H2D time.

12. service — after [fusion], on [bengine]'s voltages, SV_NINT = 66
             integrations (the FDMT's max_delay is 64, so K1 is on the
             path: 2 outputs): (a) `Service(lwa_instrument_spec(voltages=...))`
             and `lwa_instrument_pipeline`, both fused as the spec
             builds them, in SV_PAIRS turns: exit code 0, every block
             "drained", lost == dup == 0, no fault, restart, heartbeat
             miss or deadman, images (checksummed, the first SV_KEEP
             whole) and candidates bitwise the bare run's, launches
             equal; steady frames/s, peak memory, start() and stop()
             seconds; the bare run is [fleet]'s reference for its inst
             tenant (it gathers the dedispersed beams too).  (b) The
             e2e fault, `FaultPlan(seed=7).raise_at("block.on_data",
             block="bengine", nth=1)`, on the first SV_FAULT_NINT = 8
             integrations: one restart naming bengine among its
             constituents, lost == dup == 0, the X images bitwise (a)'s
             first 8, exit code 0, peak within 1 GiB of (a)'s; the
             recovery time.  (c) The image sink waiting in
             its ring for the last image of SV_WEDGE_NINT while the D2H
             copy is parked, heartbeat 0.25 s x 8: the deadman's
             interrupt restarts the sink once, the parked copy goes on
             0.2 s after it; deadman -> restart time, stop() within its
             timeout.  (d) The FRB search of [main] built from the
             registry (a custom source, copy, transpose, fdmt, detect):
             candidates bitwise `frb_search_pipeline`'s.  (e) A
             mid-stream stop(timeout=SV_QUIESCE) after SV_STOP_AFTER
             images: no block wedged, the card synchronises, and
             memory_allocated returns within 1 GiB once the service is
             dropped.  Its launches go into `launches_by_path` as
             `service` (a's first run) and `service_fault` (b).

13. capture — after [service], on its voltages, everything fed from a
             real UDP socket on loopback through the port's capture
             engine, packets sent by the port's schedule walker:
             (a) `Service(lwa_frb_search_spec(rx, gulp_nframe=4096,
             max_delay=2048))` at [main]'s geometry (64 sources x 64 B =
             4096 u8 channels) on the first CP_NGULP = 4 gulps of
             frb_data() (16,384 frames, 1,048,576 packets of 76 B) at
             64,000 packets/s, real time: nmissing == ninvalid == nlate
             == 0, every packet landed, lost == dup == 0, every ring in
             the capture's 'system' space and the FDMT on the card
             (K1 12 merge steps x 4 gulps, nothing else; the whole
             stream staged once), the candidates (frame, dm_index)
             those of frb_search_pipeline on the same frames, SNRs
             within 1e-5 (the detector runs on a host ring here, on a
             'cuda' ring there; the FDMT input is the same bytes), the
             burst found; packets/s sent and ingested, frames/s, host
             seconds by block.  (b) The same stream, its first
             CP_B_NGULP = 2 gulps, asked for at 4x
             real time (256,000 packets/s; one walker thread sends what
             loopback takes): ngood, nmissing and the
             rates reported, not asserted, and the highest rate sent
             without loss named the sustained rate.  (c)
             `Service(lwa_instrument_spec(sock=rx, capture=CP_X))` at
             the flagship width, fused as the spec builds it, on the
             first CP_NINT = 2 integrations of [bengine]'s voltages
             (131,072 frames, 524,288 packets of 268 B) asked at
             CP_X_RATE packets/s, slots of 4096 frames and a capture
             ring holding the stream: no packet lost, exit code 0,
             every image bitwise the replay Service's on the same
             integrations, launches equal (K2, K4, K6b 2 each).  (d)
             `benchmarks_torch/frb_service.py`'s `--check` matrix on
             the card: every scenario passes, the restart storm's
             replay signature equal across its two runs; its wall
             time.  Launches go into `launches_by_path` as
             `capture_frb` (a), `capture_instrument` (c) and `chaos`
             (d).

             (e) The FRB search fed i4 packets
             (`frb_search_spec(packet_dtype='i4')`, the registry's
             unpack stage on the host) at [main]'s 4096 channels (64
             sources x 32 B) on CP_I4_NGULP gulps of frb_data() mapped
             to [-8, 7] at real time: nothing lost, candidates those of
             frb_search_pipeline fed the same values as i8.  Launches go
             into `launches_by_path` as `capture_i4`.

             (f) ROADMAP item 18: CP_FAN_NSHARD = 4
             `Service(lwa_frb_search_spec(rx_i))` at [main]'s full
             width, their sockets bound to one port with SO_REUSEPORT,
             fed by 4 walker flows of 16 sources each (one steered to
             each shard by probing sender sockets), 2 gulps of
             frb_data() holding the burst: Σ ngood equal to the packets
             sent, no repeats, each shard's K1 launches 12 a gulp
             (counted on its blocks' threads), each shard's candidates
             those of frb_search_pipeline on its flow's channels;
             frames/s a shard and in all, `health()["capture"]` of each,
             the NUMA placement of every host ring (where the kernel
             has NUMA maps).  (g) The instrument of (c) at
             CP_SLOTS = 16- and 256-frame slots: packets lost with the
             granted socket buffer, the images bitwise (c)'s replay
             where none is; the capture engine's Python entries a slot
             window (sys.setprofile: 1, the header callback, in about
             1,022 windows); `Ring(core=c)`'s page policy.  (h) 2 GiB
             through a 64 MiB host ring on the ring engine, every byte
             checked.  Launches as `capture_fanout` (f) and
             `capture_slots` (g).

14. xengine — the exact int8 X-engine (kernel X1) at the repo's int8
             configuration (benchmarks/XENGINE_TPU.md:59): 128 channels x
             512 inputs (256 stations x 2 pol), gulps of 1024 frames,
             one visibility frame (128 x 512 x 512 cf32) per 8192
             frames.  (a) XE_DISTINCT seeded ci4 frames (1 GiB, every
             byte a pair of values in [-8, 7]) replayed XE_REPLAY times,
             65,536 frames, 64 gulps, 8 integrations, three topologies:
             the raw head array_source(ci4) -> copy('cuda') ->
             correlate(8192, engine='int8') fused and unfused, and the
             reference's bench chain array_source(ci4) -> unpack (host,
             ci8) -> copy('cuda') -> correlate, cut to XE_CUT
             integrations.  All bitwise equal to each other, the first
             integration on XE_GOLDEN_CHANS bitwise an exact int64 numpy
             golden, an unfused run with xengine_method='plain' (XE_CUT
             integrations) bitwise too; frames/s steady (first
             visibility frame to last), the raw reads and the bytes they
             covered, X1's launches (fused == unfused); then
             XE_TRACE_NINT integrations of the fused raw head under
             torch.profiler, bitwise the fused run: over the steady
             window between X1 launches, the device's busy time and
             idle share, its ms a gulp by kind (H2D, X1, other kernels)
             and each host thread's top-level ops (the Chrome trace in
             traces/xengine_trace.json).  (b) The ci4
             F-engine: `lwa_beam_search_pipeline` at [bengine]'s width
             on FE_NINT integrations of its voltages, given as packed ci4
             and as ci8: beam powers bitwise equal, K2 and K4 launches
             equal and every K2 launch vector.  (c) The instrument with
             engine='int8' on XI_NINT integrations: images bitwise the
             same run with xengine_method='plain', X1 and K6b launched.
             Launches go into `launches_by_path` as `xengine_fused`,
             `xengine_unfused`, `xengine_unpack`, `xengine_plain`,
             `xengine_trace`,
             `fengine_ci4`, `fengine_ci8`, `instrument_int8` and
             `instrument_int8_plain`.

15. fir    — after [capture], on [bengine]'s voltages: FirBlock
             (benchmarks/fir_tpu.py's 16 taps at --nchan 1024) on the
             ci8 voltages read raw from the 'cuda' ring, 256 stations x
             2 pol = 1024 real lanes, seeded per-channel banks (16, 512),
             FIR_NGULP = 8 gulps of 65,536 frames, at decim 1 and 4
             (benchmarks/FIR_TPU.md's --decim 4): bitwise the same run
             with fir_method 'plain', the same frames in 2 gulps of 4x
             the length, and the fused group (copy -> fir,
             stateful_chain, the raw head) with the same K2 launches
             (8, every one vector); the first 4096 outputs on 4 channels
             within 2 ntap u M of an f64 golden; frames/s whole and
             steady.  `check_fir` times K2 at this shape (vector and
             scalar kernels, plain, F.conv1d, the bound) and reads
             ptxas's registers and spills of the 16-tap instantiations
             (the kernel record's `at_fir`).  Launches go into
             `launches_by_path` as `fir`, `fir_plain`, `fir_long`,
             `fir_fused` and their `fir_decim4*` twins.

16. async  — after [xengine]: the async gulp executor on [xengine]'s
             seeded ci4 replay at its configuration, cut to AS_NINT = 2
             integrations (16 gulps): (a) the raw head array_source(ci4)
             -> copy('cuda') -> correlate(8192, engine='int8') and (b)
             benchmarks/pipeline_async.py's chain, the host unpack
             first, each serialized (strict_sync + serialize_dispatch),
             sync (pipeline_async_depth 1) and async (depth 4), in
             AS_TURNS = 1 turn: every run's visibilities bitwise the
             sync raw head's (its first integration on channel 0 the
             int64 golden), X1 16 launches in each, the executor on the
             copy, correlate and sink blocks at depth 4 only; frames/s
             whole and steady, the per-block acquire/reserve stall map.
             Launches go into `launches_by_path` as
             `async_<chain>_<discipline>` (the first turn's).

17. map    — after [xengine], on [bengine]'s voltages: bf.map's kernel M1,
             one CUDA kernel generated per expression and built by nvcc
             (ops/map_codegen.py over csrc/map_common.cuh).  check_map
             holds M1 against its plain version at one B_GULP gulp of
             ci8 read raw (bitwise) and times it against its bytes bound
             (64 MiB in, 256 MiB out).  (a) benchmarks/map_tpu.py's
             MAP_FUNC ``y = 2.0f*x*x.conj() + 1.0f`` in its chain
             copy('cuda') -> map_block -> detect(scalar) -> sink on
             MAP_NGULP gulps of B_GULP frames, unfused and fused in
             MAP_TURNS turns and with map_method 'plain'; (b) its stencil
             ``y(t,s,p) = x(t,s,p) - x(t-1,s,p)`` (copy -> map -> sink),
             unfused and fused (stateful_chain) at gulps of B_GULP and
             B_GULP / MAP_SPLIT, and 'plain'; (c) MAP_FUNC on
             MAP_CI4_NGULP gulps of [xengine]'s seeded ci4 replay, and
             'plain'.  Each program: every run bitwise the first, the
             method 'cuda' (the plain runs 'plain'), one M1 launch a gulp
             fused and unfused (for MAP_FUNC and the stencil each on the
             vector path with 32-bit indices), the raw reads counted, the
             first frames against an exact golden; frames/s whole and
             steady.  Then nvcc's seconds and ptxas's registers and
             spills of each generated kernel, and a second Map on
             MAP_FUNC loading the built library with no nvcc run.
             check_map times every form of MAP_FORMS at the gulp's shape
             (the two main programs, f16, bf16, ci2, ci1 and complex64
             sqrt, the last beside `torch.sqrt`): bitwise (sqrt within
             MAP_CX_ULP ulps of max(|z|, |w|)), with the path taken, V,
             the index type, registers, spills, the bound and the share
             of it; the complex transcendentals on complex64 (within
             MAP_CX_ULP), and (d) runs the f16 program as a map_block
             chain over MAP_HALF_NGULP gulps, one M1 launch a gulp,
             bitwise its 'plain' run.  check_map also times the forward
             ``x(t+1) - x(t)`` and unbounded ``x(nt-1-t)`` programs on
             the raw ci8 gulp (M1's element path) among MAP_FORMS, and
             the eager explicit-index and scatter forms on the gulp as
             complex64 (B_GULP x 512, 256 MiB): the transpose (beside
             `a.t().contiguous()`), the band flip (beside `torch.flip`)
             and a scatter with repeated and dropped targets, each
             bitwise the plain engine's eager call, one launch (two for
             a scatter: the owners, then the writes), ms, plain ms,
             bound and share.  (e) Those eager calls through map() on
             card tensors, counted (5 launches), then MAP_FORWARD and
             MAP_REVERSE in copy -> map_block -> detect on MAP_NGULP
             gulps, each beside its 'plain' run and a fuse=True build
             that refuses the map (map_unbounded_index) and groups
             nothing: one M1 launch a gulp, bitwise, the first gulp
             against an exact golden.  Launches go into
             `launches_by_path` as `map_<program>_<run>` and
             `map_eager`.
18. fleet  — after [map], on [bengine]'s voltages: one FleetScheduler
             (fleet.py) on the card, tenants submitted in order: inst
             (lwa_instrument_spec at the flagship width, FL_INST_NINT
             integrations, priority 2), frb ([service] (d)'s registry
             FRB search, NGULP gulps, 1), map (MAP_FUNC on FL_MAP_NGULP
             gulps of [map]'s ci8 frames paced FL_MAP_PACE s a gulp,
             copy -> map -> a DeviceSinkBlock staged through the fleet
             pool with a quota of one output gulp, 0), flaky (the FRB
             search cut to FL_FLAKY_NGULP gulps, one fault in its FDMT,
             0) and huge (a ring demand above the fleet's).  The ring
             budget is the first three's rings, measured from their
             bare runs (inst's is [service] (a)'s bare run of the same
             66 integrations): flaky queues and is admitted when one
             completes;
             huge is rejected.  The map stage is respecced live to
             FL_MAP_FUNC2 (M1 builds a new kernel: cold) and back (the
             built library: warm).  Checks: inst's images, dedispersed
             beams (a gather sink on its FDMT, in both runs) and
             candidates bitwise its bare fused pipeline's; frb's
             dedispersed gulps and candidates bitwise [main]'s, the
             burst found; every map gulp bitwise the plain engine of the
             program live for it, lost == dup == 0; flaky restarts once,
             the others no fault and full budgets; the staging view
             never keeps more than its quota; the fleet's counters and
             exit code 0; each kernel's launches the sum of the tenants'
             bare runs less flaky's shed gulp, K5a/K5b/K6a/X1 none.
             Prints each tenant's steady frames/s beside its solo rate
             ([main], [service], [map]), the respecs' splice and
             downtime seconds and the cold nvcc seconds, admission p50
             and p99, the pool's stats, the peak device memory and
             `kernel_cache_info()`.  Launches go into `launches_by_path`
             as `fleet`.
19. ipc   — after [egress], at the end: the inter-process and file I/O
             plane on [main]'s FRB search at full width.  (d) First the
             limits, read and never changed: the free bytes of /dev/shm
             and /proc/sys/kernel/{shmmax,shmall,sem}; the shm ring is
             sized to IPC_RING_GULPS dedispersed gulps (32 MiB each) or
             what /dev/shm holds, the DADA ring to IPC_DADA_NBUFS buffers
             of a gulp or what shmmax and shmall allow.  (a) The FRB
             search with three sinks on its FDMT's 'cuda' ring: shm_send
             (min_readers 1), dada_ipc_send and serialize (IPC_FILE_SIZE:
             three sets of files), beside a gather_sink; two consumer
             processes (fresh interpreters that import only
             bifrost_tpu_torch) run shm_receive and a DadaHDU reader and
             print a checksum a gulp (a buffer) and the header; the files
             are read back with deserialize -> copy('cuda'); all three
             bitwise the gather (shm and DADA frame-major, their headers
             the gather's with the frame axis first), headers intact.  (b) A
             producer process writes frb_data()'s u8 frames into a DADA
             HDU, `python -m bifrost_tpu_torch.dada_bridge` forwards it
             into a shm ring, and the FRB search runs from
             read_psrdada_buffer -> copy('cuda') -> ...: dedispersed
             gulps and candidates bitwise [main]'s, the burst found.  (c)
             The FRB search without sinks, unpinned and with each block
             pinned to its own core (block_scope(core=) through
             frb_search_chain's `scope`, cores from
             os.sched_getaffinity), IPC_TURNS turns: each pinned thread's
             core read by affinity.get_core() inside it and from its bind
             proclog, outputs bitwise the unpinned run's.  K1 launches
             144 in every FRB run, every other kernel 0 (asserted);
             launches go into `launches_by_path` as `ipc`,
             `ipc_dada_ingest` and `ipc_affinity`.  Prints the producer's
             steady frames/s against [main]'s, each sink's bytes/s, the
             consumers' received bytes/s, the DADA-fed and the pinned and
             unpinned rates, with the card's name and power limit.

20. observe — after [main], at its full width: (a) [main]'s search
             with its detect sink held OB_HOLD s a gulp while the five
             tools (like_top, like_ps, like_pmap, like_bmon,
             pipeline2dot and pipeline2dot --rings), each started as
             ``python -m bifrost_tpu_torch.tools.<name>`` against this
             process, read its proclog tree: like_top's ring rows name
             every ring, like_pmap and pipeline2dot's ring nodes show
             h2d.out0 and transpose.out0 in 'cuda', like_bmon's rates are
             above 0, like_ps names the source and the sink, pipeline2dot
             draws every block edge.  (b) The unpaced search with the
             `trace` flag on inside trace.start_profile / stop_profile
             and one trace_scope: the Chrome trace (OB_TRACE_DIR) holds
             the range and one fdmt_merge_step_kernel event a counted K1
             launch; the card's idle share over the steady window, first
             to last K1 event, is printed.  (c) [main] with its source
             publishing its gulps (ArraySourceBlock.zero_copy, True by
             default) and copying them (the attribute set to False on
             the built pipeline), OB_TURNS = 1 turn: NGULP spans
             published by each
             zero-copy run, none by the others; steady frames/s and the
             source's and H2D's host seconds by phase.  Every run's
             dedispersed gulps are bitwise [main]'s, K1 144 launches
             each; launches go into `launches_by_path` as
             `observe_tools`, `observe_trace` and `observe_zc<0|1>_t<turn>`.

21. mesh  — after [fleet], the mesh plane (bifrost_tpu_torch.parallel) on
             virtual meshes of MESH_N = 8 positions backed by cuda:0
             (`virtual_devices`); one card runs the virtual form only.
             (a) The B-engine at [bengine]'s width: its seeded ci8 block
             read as MESH_NINT integrations of channelized voltages (16
             x 4096 channels x 256 stations x 2 pol a gulp; small
             integers, every sum exact) -> copy('cuda') -> beamform(8
             beams, N_INT) -> accumulate(MESH_TAIL), on (time, freq) =
             (4, 2), (time, beam) = (2, 4) and (freq, stand) = (2, 4)
             (the station label on 'stand'), each deferred and fused (one
             MeshFusedBlock) and per block (mesh_defer_reduce off), in
             MESH_TURNS = 1 turn beside the no-mesh chain: every
             output
             bitwise the no-mesh chain's; K4 gulps x 8 launches on the
             first two layouts and 0 on the third (its route
             'stand_matmul', read from the `<name>/beamform_plan` log);
             one all-reduce an emit deferred, one a gulp per block (the
             station layout's coherent psum a gulp either way); steady
             voltage frames/s and the shards' contiguous copies.  The
             PFB-fed beam search (copy -> pfb -> beamform under the
             (4, 2) mesh) on MESH_PFB_NINT integrations of the voltages:
             within 2 N_INT eps32 of the no-mesh chain (the PFB's output
             is not integer valued, so time shards reassociate), K2 once
             a time shard a gulp (4; the history handed over by one
             collective-permute a gulp), K4 once a shard.  (b) [xengine]'s int8 correlator (128 channels
             x 512 inputs, gulps of 1024) -> accumulate(MESH_X_NINT)
             fused by mesh_chain on (time, freq) = (2, 4), MESH_X_NINT
             integrations: bitwise the no-mesh run, X1 gulps x 8
             launches, one all-reduce in all (0 a gulp, 1 at the emit).
             (c) (a)'s first layout as a supervised `Service`
             (degrade_shards, mesh_collective_timeout_s 2 s) with
             position 5 marked lost and its gulp-3 dispatch wedged: the
             ShardFault declared within the timeout, shard_evict, the
             restart onto 7 survivors, every other output bitwise the
             clean run's, availability_pct below 100, the recovery time.
             (d) `make_fx_step` at MESH_FX on (time, freq) and (time,
             freq, stand) against `fx_step_reference` within eps32
             (log2 nfine + 2 + the summed terms) max|ref|.  Launches go
             into `launches_by_path` as `mesh_*`, and the collectives of
             the runs that launch K4 or X1 into their records'
             `mesh_collectives`.
22. surface — at the end: the JAX package's user surface on the card.
             `bf.asarray` to 'cuda' and back; `empty_like`/`zeros_like`
             of a CUDA tensor and of a pinned one, their spaces read
             by `get_space`; `memset_array` on a CUDA tensor; two
             `raw_malloc(..., 'cuda_host')` blocks, pinned (their
             backing tensors' `is_pinned()`), `memcpy2D` between them
             and `copy_array` from the card into a host `ndarray` over
             one; `ExternalStream` over a new `torch.cuda.Stream` (and
             over its raw cudaStream_t), the scope's work queued on
             that stream and not on the default one; `bf.fft.fft` and
             `Fft.init/execute` of a card tensor into a host `ndarray`
             within the FFT bound (32 eps32 sqrt(n) max|want|) of
             np.fft; `transpose` and `reduce` into host out-arrays,
             bitwise numpy on integer-valued data; `Fdmt.execute` at
             [main]'s geometry from a card tensor into a host
             `ndarray`, its K1 launches counted as the path `surface`
             and its output bitwise the plain merge step's; the v1
             `block.Pipeline` multi-add, FFT/IFFT and fold pipelines,
             each file byte-identical to the one a plain numpy
             computation of the same function writes.

The launch checks of every phase count all eleven kernels (K1, K2, K4,
K6a, K6b, K5a, K5b, X1, M1, W1s, W1).  The line before the last two
holds the kernel records as JSON, one for each of those kernels; then
the card's name and power limit; the last line is {"ok": true,
"device": {...}}.
"""

import contextlib
import gc
import glob
import json
import math
import threading
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

NCHAN, MAX_DELAY, GULP, NGULP = 4096, 2048, 4096, 12
F0, DF, DT = 40.0, 0.00928, 1e-3
DM_ROW, T0 = 1000, 3 * GULP + 1500
SEED = 20261016

# The B-engine beam search: lwa_instrument_spec's flagship geometry
# (bifrost_tpu/service.py:355-362), one integration per gulp.
NSTAND, NPOL, BCHAN, NTAP, N_INT, NBEAM = 256, 2, 4096, 4, 16, 8
B_MAX_DELAY, B_NINT, B_REPLAY = 64, 66, 16
B_F0, B_DT = 40.0, 1e-6
B_GULP = N_INT * BCHAN

# The imaging branch (bifrost_tpu/service.py:413-428): ngrid 128, the
# default positions and the (3, 3) kernel of ones; K6a's check and run
# use a seeded non-rank-1 (1, nvis, 3, 3) kernel plane.  X_PLAIN_NINT
# integrations are compared with the all-'plain' pipeline.
NGRID, M_KERN, X_PLAIN_NINT = 128, 3, 2
X_GOLDEN_CHANS = np.linspace(0, BCHAN - 1, 8).astype(np.int64)

# The data-quality paths: the FRB storm (the narrowband part of
# benchmarks/frb_service.py's RFI_STORM) from the third gulp on, the
# flagger of its rfi_storm scenario; the DQ beam search's tone and gains.
STORM = dict(n_storm=60, p_on=0.8, nb_amp=255)
FRB_FLAG = dict(algo="mad", thresh=6.0, mad_factor=4.0, window=16)
STORM_GULP0 = 2
DQ_WINDOW, DQ_TONE_INT, DQ_STATION, DQ_CHAN, DQ_AMP = 16, 8, 17, 1000, 16
DQ_FOLD = (6, 10)      # integrations of the fold-identity run

# The gpuspec spectrometer (bench.py:259-274; testbench/gpuspec_simple.py:
# 88-101): the repo's flagship, 64 channels x 16,384 fine samples x 2 pol
# of ci8 a frame, F_AVG 64, N_INT 24, 64 frames; and a real GUPPI block of
# the Breakthrough Listen recorder at the GBT (BLOCSIZE 134,217,728,
# OBSNCHAN 64, 2 pol, 8 bit: NTIME 524,288), F_AVG 64, N_INT cut to 4,
# 32 blocks (8 distinct, replayed 4 times).  Voltages are seeded integers
# in [-8, 8).  GS_GOLDEN_CHANS are the real block's output channels held
# against an f64 golden (one where the fftshift put a coarse channel's
# DC bin).
GS_FLAGSHIP = dict(name="flagship", nchan=64, ntime=16384, npol=2,
                   f_avg=64, n_int=24, nframe=64, ndistinct=64)
GS_GUPPI = dict(name="guppi_128MiB", nchan=64, ntime=524288, npol=2,
                f_avg=64, n_int=4, nframe=32, ndistinct=8)
GS_GOLDEN_CHANS = (1234, 32 * 8192 + 4096)

# The egress plane (bench.py:537-566, benchmarks/egress_tpu.py:197-231):
# array_source -> copy('cuda') -> a pooled DeviceSinkBlock, staged and
# blocking in turns, at bench.py's dump shape (16 frames of (4, 16,384)
# f32, gulp 4, depth 8) and at the instrument's image frame (4096 x 128 x
# 128 cf32, 512 MiB a gulp; 12 gulps replaying 4 distinct frames, the
# steady state from gulp `skip` on, a check run of 8 gulps), the latter
# beside copy('system') -> callback_sink, the image egress's shape, fed
# from the host and from the card.
EG_DUMP = dict(shape=(16, 4, 16384), gulp=4, depth=8)
EG_IMAGE = dict(shape=(4096, 128, 128), ndistinct=4, nframe=12,
                check_nframe=8, skip=8, depth=2)
EG_PAIRS = 1

# The fusion phase: the beam search and the DQ beam search over [dq]'s
# voltages (B_NINT integrations), the instrument cut to FX_NINT
# integrations (the first FX_KEEP images compared), gpuspec (c) at both
# geometries; FUSION_PAIRS turns of a fused and an unfused run each.
FUSION_PAIRS, FX_NINT, FX_KEEP = 1, 8, 2

# The service phase: the instrument as one supervised Service at the
# flagship width on [bengine]'s voltages, SV_NINT integrations deep (the
# FDMT's max_delay is 64 integrations, so it emits from the 65th: K1 is
# on the path), Service and bare pipeline in SV_PAIRS turns, SV_KEEP
# images compared whole; the wedge run SV_WEDGE_NINT deep; the
# mid-stream stop after SV_STOP_AFTER images with a SV_QUIESCE s quiesce.
SV_NINT, SV_PAIRS, SV_KEEP = 66, 1, 2
# (b)'s faulted run: the first SV_FAULT_NINT integrations.
SV_FAULT_NINT = 8
SV_WEDGE_NINT, SV_STOP_AFTER, SV_QUIESCE = 4, 3, 30.0

# The capture phase: the FRB search over UDP at [main]'s geometry
# (lwa_frb_search_spec: 64 sources x 64 B = 4096 u8 channels) on the
# first CP_NGULP gulps of frb_data(), at real time (1,000 frames/s =
# 64,000 packets/s) and 4x; the instrument over UDP
# (CP_X: 4 sources x 256 B = one 256 x 2 ci8 frame) on the first CP_NINT
# integrations of [bengine]'s voltages at CP_X_RATE packets/s (about
# what one schedule walker sends over loopback), slots of 4096 frames
# (the engine's ring callbacks take the GIL once a slot, and large slots
# keep the waits on the instrument's host threads few;
# capture_slots.py compares slot sizes) and a capture ring holding the
# whole stream; the chaos harness's --check.
CP_NGULP, CP_NSRC, CP_PAYLOAD, CP_B_NGULP = 4, 64, 64, 2
CP_RATES = (64_000, 256_000)
CP_NINT, CP_X_RATE = 2, 100_000
CP_X = dict(nsrc=4, max_payload_size=256, slot_ntime=4096)
# The 4x run (b) is cut to CP_B_NGULP gulps.  The SO_REUSEPORT fan-out
# (f): CP_FAN_NSHARD FRB searches at [main]'s width, CP_FAN_NGULP gulps
# from gulp CP_FAN_GULP0 (the burst's), one flow of CP_NSRC / CP_FAN_NSHARD sources
# a shard at CP_FAN_RATE packets/s (the four at real time together),
# steered with at most CP_FAN_PROBES probe flows; the instrument at
# CP_SLOTS-frame slots (g), the engine's Python entries over
# CP_ENTRIES_NFRAME frames; ring streaming (h): CP_STREAM_NBYTE through
# a CP_STREAM_RING-byte ring in CP_STREAM_GULP-byte spans.
CP_FAN_NSHARD, CP_FAN_NGULP, CP_FAN_RATE, CP_FAN_PROBES = 4, 2, 16_000, 256
CP_FAN_GULP0 = 2
CP_SLOTS, CP_ENTRIES_NFRAME = (16, 256), 16384
CP_STREAM_NBYTE, CP_STREAM_RING, CP_STREAM_GULP = 2 << 30, 64 << 20, 4 << 20

# The int8 X-engine (benchmarks/XENGINE_TPU.md:59, the repo's int8
# configuration for ci8/ci4 streams): 128 channels x 256 stations x 2
# pol, gulps of 1024 frames (the contraction depth), one visibility
# frame per 8192 frames; XE_DISTINCT seeded ci4 frames (1 GiB) replayed
# XE_REPLAY times.  The host-unpack chain and the 'plain' run are cut to
# XE_CUT integrations; XE_GOLDEN_CHANS of the first integration are held
# against an exact numpy golden; XE_EDGES are X1's edge shapes (ntime,
# nchan, nsp): around its 64-row warpgroups, its 128-station tiles, its
# 32-sample wgmma step and its 16-sample pitch; XE_GUARD the gulp
# guard's edge (ci8, every value -128, the largest sums); XE_TRACE_NINT
# integrations of the fused run are traced.  The ci4 F-engine runs
# FE_NINT integrations of
# [bengine]'s voltages, the int8 instrument XI_NINT; the i4 FRB capture
# CP_I4_NGULP gulps of 64 sources x 32 B (4096 i4 channels).
XE_NCHAN, XE_NSTAND, XE_NPOL, XE_GULP, XE_NINT = 128, 256, 2, 1024, 8192
XE_DISTINCT, XE_REPLAY, XE_CUT = 16384, 4, 2
XE_GOLDEN_CHANS = (0, 37, 64, 127)
XE_EDGES = ((64, 2, 100), (45, 3, 64), (1, 2, 70), (200, 1, 130),
            (1, 1, 1), (31, 2, 63), (33, 2, 65), (45, 1, 127),
            (200, 1, 128), (200, 2, 129), (129, 2, 200), (300, 2, 384))
XE_GUARD = (65535, 1, 64)     # the gulp guard's edge, every value -128
XE_TRACE_NINT = 2
FE_NINT, XI_NINT = 4, 2
CP_I4_NSRC, CP_I4_PAYLOAD, CP_I4_NGULP = 64, 32, 2

# The streaming FIR (benchmarks/fir_tpu.py's defaults: 16 taps, --nchan
# 1024; benchmarks/FIR_TPU.md's --decim 4): FirBlock on [bengine]'s ci8
# voltages (256 stations x 2 pol, 1024 real lanes) read raw from the
# 'cuda' ring, seeded per-channel banks (FIR_NTAP, 512), FIR_NGULP gulps
# of B_GULP frames at each of FIR_DECIMS, and the same frames as gulps
# FIR_LONG times as long; the first FIR_GOLDEN_NOUT outputs on channels
# FIR_GOLDEN_CHANS against an f64 golden.
FIR_NTAP, FIR_DECIMS, FIR_NGULP, FIR_LONG = 16, (1, 4), 8, 4
FIR_GOLDEN_CHANS, FIR_GOLDEN_NOUT = (0, 1, 137, 511), 4096

# The async gulp executor: [xengine]'s seeded ci4 replay at its
# configuration, cut to AS_NINT integrations; the raw head and the host-
# unpack chain, each serialized (strict_sync + serialize_dispatch), sync
# (depth 1) and async (depth AS_DEPTH), in AS_TURNS turns.
AS_NINT, AS_TURNS, AS_DEPTH = 2, 1, 4

# bf.map (benchmarks/map_tpu.py's programs, kernel M1): [bengine]'s ci8
# voltages read raw from the 'cuda' ring, MAP_NGULP gulps of B_GULP
# frames; MAP_FUNC in copy -> map -> detect(scalar), unfused and fused in
# MAP_TURNS turns, and 'plain'; the stencil MAP_STENCIL unfused and fused
# at gulps of B_GULP and B_GULP // MAP_SPLIT, and 'plain'; MAP_FUNC on
# MAP_CI4_NGULP gulps of [xengine]'s seeded ci4 replay.
MAP_FUNC = "y = 2.0f*x*x.conj() + 1.0f"
MAP_STENCIL = "y(t,s,p) = x(t,s,p) - x(t-1,s,p)"
MAP_AXES = ("t", "s", "p")
MAP_NGULP, MAP_TURNS, MAP_SPLIT, MAP_CI4_NGULP = 8, 1, 4, 8
# The half-type and packed-complex programs of [map],
# the half chains' gulps, and the complex transcendentals' tolerance in
# complex64 ulps of max(|z|, |w|) against PyTorch's kernels
# (tests/test_torch_gpu.py states why).
MAP_HALF_FUNC = "y = v * v - v * 0.5 + 1.25"
MAP_CPK_FUNC = "y = v * v.conj() + v * 2"
MAP_CX_FUNCS = ("sqrt", "log", "log2", "log10", "sin", "cos", "tan", "asin",
                "acos", "atan", "sinh", "cosh", "tanh", "rsqrt")
MAP_HALF_NGULP, MAP_CX_ULP = 4, 24
# bf.map's eager explicit-index and scatter forms on one gulp of
# [bengine]'s voltages as complex64 (B_GULP x NSTAND * NPOL, 256 MiB): the
# transpose (M1's tile path), the band flip (an injective scatter: one
# pass over its target), the transpose written as a scatter, and a
# scatter whose targets repeat (two sources a row) and half of whose
# sources fall outside the target (rows past its end: i // 2 +
# MAP_SCATTER_K >= B_GULP; two passes); the forward and unbounded (time
# reversal) streaming programs on the raw ci8 gulp, and as chains in
# [map] (e).
MAP_TRANSPOSE = "c(i,j) = a(j,i)"
MAP_FLIP = "c(i, nj-1-j) = a(i, j)"
MAP_STRANSPOSE = "c(j,i) = a(i,j)"
MAP_SCATTER = "c(i//2 + k, j) = a(i, j)"
MAP_SCATTER_K = 3 * B_GULP // 4
MAP_FORWARD = "y(t,s,p) = x(t+1,s,p) - x(t,s,p)"
MAP_REVERSE = "y(t,s,p) = x(nt-1-t,s,p)"
# complex64 sqrt at the ends of the f32 range (its scaled branches):
# FLT_MAX-sized parts, subnormal parts, zero against a tiny part.
MAP_SQRT_EDGES = ((3e38, 3e38), (-3.4028234e38, -3.4028234e38),
                  (3.4028234e38, 0.0), (-3.4e38, 1e-30), (1e30, 1e-30),
                  (0.0, 1e-44), (1e-44, 0.0), (-1e-44, 0.0), (1e-45, 1e-45),
                  (-1e-40, 3e-42), (2.0 ** 60, 1.0), (-(2.0 ** -60), 1e-21))
# The fleet (fleet.FleetScheduler, phase 18): on [bengine]'s voltages,
# four tenants sharing the card.  inst: lwa_instrument_spec at the
# flagship width cut to FL_INST_NINT integrations (the FDMT's
# B_MAX_DELAY-integration delay plus 2 that it emits, so K1 is on the
# tenant's path); frb: [service] (d)'s registry FRB search, all NGULP
# gulps; map: [map]'s ci8 frames, FL_MAP_NGULP gulps of B_GULP paced
# FL_MAP_PACE s a gulp, copy -> map (MAP_FUNC, respecced to FL_MAP_FUNC2
# after FL_RESPEC_AT[0] gulps and back after FL_RESPEC_AT[1]) -> a
# DeviceSinkBlock whose staging quota is one output gulp; flaky: the FRB
# search cut to FL_FLAKY_NGULP gulps with one fault in its FDMT (its
# gulp of index FL_FLAKY_NTH); huge: a ring demand above the fleet's.
FL_INST_NINT = B_MAX_DELAY + 2
if FL_INST_NINT != SV_NINT:
    # [fleet]'s inst tenant is held against [service]'s bare run
    raise ValueError(f"FL_INST_NINT {FL_INST_NINT} != SV_NINT {SV_NINT}")
# (the stream outlasts the cold respec's nvcc, during which the old map
# block drains on: 8 gulps ran out before the warm respec on a slower host)
FL_MAP_NGULP, FL_MAP_PACE, FL_RESPEC_AT = 16, 0.25, (2, 5)
FL_MAP_FUNC2 = "y = x * x.conj()"
FL_FLAKY_NGULP, FL_FLAKY_NTH = 4, 2
FL_STAGING = 1 << 30

# K6b's plan rebuilt per sequence: this many sequences of new positions.
RM_NSEQ = 4

# [ipc]: dedispersed gulps the shm ring holds, the DADA ring's buffers (a
# gulp each), the serializer's file size (bytes a ringlet: 4 gulps of a
# DM row), pinned/unpinned turns, a consumer's time limit in seconds.
IPC_RING_GULPS, IPC_DADA_NBUFS, IPC_FILE_SIZE = 4, 4, 4 * GULP * 4
IPC_TURNS, IPC_CHILD_TIMEOUT = 1, 300

# [observe]: [main]'s search with its detect sink held OB_HOLD s a gulp
# while the five tools read it from OB_TOOL_AFTER s on (each a process of
# its own, OB_TOOL_TIMEOUT s at most); the traced run's Chrome trace
# under OB_TRACE_DIR; OB_TURNS turns of zero-copy and copying runs.
OB_HOLD, OB_TOOL_TIMEOUT, OB_TURNS = 0.5, 120, 1
OB_TRACE_DIR = Path("traces") / "observe"
FF_TRACE_DIR = Path("traces") / "frbflag"
OB_TOOLS = (("like_top",), ("like_ps",), ("like_pmap",),
            ("like_bmon", "-i", "1.0"), ("pipeline2dot",),
            ("pipeline2dot", "--rings"))

# [mesh]: the mesh plane (parallel/) on one card, virtual meshes of
# MESH_N positions backed by cuda:0.  (a) the B-engine at [bengine]'s
# width on MESH_NINT integrations of channelized ci8 (its seeded block
# read as N_INT x BCHAN x NSTAND x NPOL frames: small integers, every sum
# exact), on each of MESH_LAYOUTS deferred and fused with an accumulate
# of MESH_TAIL and per block, MESH_TURNS turns beside the no-mesh chain;
# the PFB-fed beam search on MESH_PFB_NINT integrations of [bengine]'s
# voltages; (b) [xengine]'s correlator on (time, freq) = (2, 4) for
# MESH_X_NINT integrations; (c) (a)'s first layout as a Service with a
# wedged shard (MESH_FAULT); (d) make_fx_step at MESH_FX on both layouts.
MESH_N = 8
MESH_LAYOUTS = ((("time", "freq"), (4, 2), None),
                (("time", "beam"), (2, 4), None),
                (("freq", "stand"), (2, 4), {"station": "stand"}))
MESH_NINT, MESH_TAIL, MESH_TURNS, MESH_PFB_NINT = 16, 2, 1, 16
MESH_X_NINT = 2
MESH_FAULT = dict(timeout_s=2.0, lost=5, nth=6)
MESH_FX = dict(ntime=1024, nchan=64, nstand=64, npol=2, nfine=16, nbeam=8)

# Device-memory rate by card (NVIDIA data sheets), bytes/s
# [surface]: the FFT plan's (batch, n) and the transpose/reduce input.
SF_FFT = (64, 4096)
SF_ARR = (4096, 256)

_HBM_RATE = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
F32_PEAK = 67e12   # H100 SXM f32 outside the tensor cores, operations/s
INT8_PEAK = 1979e12   # H100 SXM dense int8 tensor cores, operations/s


# Solo rates and outputs of earlier phases that [fleet] compares against
# (main_path, service_path, map_path fill it).
SOLO = {}


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def free_device():
    """Collect the finished pipelines (blocks and rings refer to each
    other, so only the cycle collector frees their device rings) and
    hand the cached blocks back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def hbm_rate(kind):
    for key, rate in _HBM_RATE:
        if key in kind:
            return rate
    return 3.35e12


def cuda_time(fn, reps):
    """Mean milliseconds of fn() over `reps` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_time(fn, reps, calls=1):
    """Mean device milliseconds of the kernels fn() launches: fn is
    captured `calls` times in a CUDA graph and the graph replayed `reps`
    times, so the host's own time per launch drops out.  A measurement
    only: the port launches eagerly."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_time(graph.replay, reps) / calls


def bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def merge_chain(plan, tabs, state0, step):
    """The merge steps of one gulp (the executor's loop) from an initial
    state, through `step`."""
    return plan._merge_steps(state0.clone(), tabs, step)


def time_chain(plan, tabs, state0, step, reps):
    """Mean ms of one gulp's merge steps (the executor's loop, its
    second buffer allocated from the cache) over a scratch copy of
    `state0`: the work does not depend on the values, so the copy is
    made once, outside the timing."""
    scratch = state0.clone()
    return cuda_time(lambda: plan._merge_steps(scratch, tabs, step), reps)


def merge_bound(plan, ntime, rate, batch=1):
    """Least milliseconds for one gulp's merge steps over `batch` slices,
    launched at their exact row counts: per step and slice, each state
    row read once (a row read only as a delayed partner needs ntime -
    min(delay) of its samples), each output row written once; the tables
    once a step; the adds at the f32 rate.  -> (ms, bytes, adds)."""
    nbytes = nadds = 0
    for rowA, rowB, delay in plan._steps:
        n = len(rowA)
        need = dict.fromkeys(rowA.tolist(), ntime)
        for r, d in zip(rowB.tolist(), delay.tolist()):
            if r >= 0:
                need[r] = max(need.get(r, 0), ntime - d)
        nbytes += 4 * batch * (sum(need.values()) + n * ntime) + 12 * n
        nadds += batch * n * ntime
    return max(nbytes / rate, nadds / F32_PEAK) * 1e3, nbytes, nadds


def bound(nbytes, nops, rate):
    """-> (ms, 'bytes' or 'operations'): the larger of the bytes over the
    memory rate and the f32 operations over the f32 peak."""
    tb, to = nbytes / rate, nops / F32_PEAK
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def fir_work(nout, lanes, ntap, ncoef, in_bytes, decim=1):
    """Bytes and operations of one FIR MAC call: x (nout * decim rows)
    read once at its storage width (every row lies in a window while
    decim <= ntap), the f32 history and coefficients, the f32 output; a
    multiply and an add per tap and output."""
    nbytes = (nout * decim * lanes * in_bytes + (ntap - 1) * lanes * 4 +
              ntap * ncoef * 4 + nout * lanes * 4)
    return nbytes, 2 * ntap * nout * lanes


def beamform_work(ntime, nchan, nsp, nbeam, in_bytes):
    """Bytes and operations of one beamform call: the voltages at their
    storage width, the c64 weights, the f32 powers; 8 operations per
    station, beam and frame, 4 to detect and integrate."""
    nbytes = ntime * nchan * nsp * in_bytes + nbeam * nsp * 8 + \
        nbeam * nchan * 4
    return nbytes, ntime * nchan * nbeam * (8 * nsp + 4)


class Stamped(list):
    """A gather list that notes the host clock at each append: a gather
    sink appends a gulp once it is copied to the host, so the stamp is
    when that gulp was done on the card."""

    def __init__(self):
        super().__init__()
        self.stamps = []

    def append(self, x):
        super().append(x)
        self.stamps.append(time.perf_counter())


def kernel_counters():
    from bifrost_tpu_torch.ops import (beamform_kernel, dq_kernel,
                                       fdmt_kernel, fir_kernel,
                                       flag_kernel, map_kernel,
                                       romein_kernel, xengine_kernel)
    return {"fdmt_merge_step": fdmt_kernel.merge_step,
            "fir_mac": fir_kernel.fir_mac,
            "beamform_power": beamform_kernel.beamform_power,
            "romein_grid_general": romein_kernel.grid_general,
            "romein_grid_separable": romein_kernel.grid_separable,
            "dq_masked_fill": dq_kernel.masked_fill,
            "dq_gain_apply": dq_kernel.gain_apply,
            "flag_stats": flag_kernel.flag_stats,
            "flag_cross": flag_kernel.flag_cross,
            "flag_walk": flag_kernel.flag_walk,
            "xengine_int8": xengine_kernel.xengine_int8,
            "map_apply": map_kernel.map_apply}


def expected(**nonzero):
    """Launch counts: every kernel 0 but those named."""
    return {name: nonzero.get(name, 0) for name in kernel_counters()}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0
    for name in ("dq_masked_fill", "fir_mac", "map_apply", "flag_walk"):
        kernel_counters()[name].vector_launches = 0
    kernel_counters()["map_apply"].index64_launches = 0
    kernel_counters()["map_apply"].tile_launches = 0
    kernel_counters()["flag_stats"].select_launches = 0


def check_vectors(counts, name="dq_masked_fill"):
    """Every launch of kernel `name` (K5a or K2) in the run just read
    took its vector kernel."""
    nvec = kernel_counters()[name].vector_launches
    if nvec != counts[name]:
        raise AssertionError(f"{counts[name]} {name} launches, {nvec} of "
                             f"them vector")
    return nvec


def beam_fdmt_plan():
    """The beam search's FDMT plan, as its `bdetect_fdmt` block builds it
    from the PFB's header: 4096 channels from 40 MHz in steps of 1 /
    (4096 x 1 us), max_delay 64."""
    from bifrost_tpu_torch.ops import Fdmt
    return Fdmt().init(BCHAN, B_MAX_DELAY, B_F0, 1e-6 / (B_DT * BCHAN),
                       method="cuda")


def same_plan(a, b):
    return len(a._steps) == len(b._steps) and all(
        np.array_equal(x, y) for s, t in zip(a._steps, b._steps)
        for x, y in zip(s, t))


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def check_kernels(dev, kind):
    from bifrost_tpu_torch.ops import Fdmt
    from bifrost_tpu_torch.ops.fdmt_kernel import merge_step, merge_step_plain
    rng = np.random.default_rng(SEED)
    ntime = GULP + MAX_DELAY
    plan = Fdmt().init(NCHAN, MAX_DELAY, F0, DF, method="cuda")
    tabs = plan._device_tables("cuda", dev)
    worst = 0.0
    for b in plan._buckets:
        # The bucket's padded shape (a superset of its steps' shapes) and
        # its first step's padded tables.
        bnrows = b["nrows"]
        rowA, rowB, delay = (torch.from_numpy(t[0]).to(dev)
                             for t in b["tables"])
        state = torch.from_numpy(
            rng.standard_normal((bnrows, ntime)).astype(np.float32)).to(dev)
        state[:, ::5] = -0.0
        rand = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
            rng.integers(0, bnrows, bnrows),
            rng.integers(-1, bnrows, bnrows),
            rng.integers(0, ntime + 64, bnrows))]
        for tables in ((rowA, rowB, delay), tuple(rand)):
            out = torch.empty(bnrows, ntime, device=dev)
            merge_step(state, *tables, out=out)
            want = merge_step_plain(state, *tables)
            torch.cuda.synchronize()
            if not bits_equal(out, want):
                raise AssertionError(f"merge_step differs from plain at "
                                     f"({bnrows}, {ntime})")
            worst = max(worst, float((out - want).abs().max()))
        # A batch of 3 slices in one launch, into a slice of a larger
        # buffer (the executor's ping-pong layout), with random tables.
        n = bnrows // 2
        bstate = torch.stack([state[:n], state[n:2 * n].flip(0),
                              state[:n].neg()])
        rb = rand[1][:n]
        tables = (rand[0][:n] % n, torch.where(rb < 0, rb, rb % n),
                  rand[2][:n])
        bout = torch.empty(3, n + 8, ntime, device=dev)[:, :n]
        merge_step(bstate, *tables, out=bout)
        want = merge_step_plain(bstate, *tables)
        torch.cuda.synchronize()
        if not bits_equal(bout.contiguous(), want):
            raise AssertionError(f"batched merge_step differs from plain at "
                                 f"(3, {n}, {ntime})")
    x = torch.from_numpy(rng.integers(0, 256, (NCHAN, ntime))
                         .astype(np.float32)).to(dev)
    xf = torch.from_numpy(rng.standard_normal((NCHAN, ntime))
                          .astype(np.float32)).to(dev)
    xf[:, ::3] = -0.0
    for inp in (x, xf):
        plan.method = "cuda"
        got = plan.execute(inp)
        plan.method = "plain"
        want = plan.execute(inp)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise AssertionError("Fdmt.execute cuda != plain")
    plan.method = "cuda"
    phase("kernels", f"fdmt merge_step equal to plain (tolerance: bitwise, "
          f"max abs err {worst}) at buckets "
          f"{[b['nrows'] for b in plan._buckets]} x {ntime}; Fdmt.execute "
          f"cuda == plain bitwise (u8-valued and random f32 with -0.0)")

    # Time one gulp's merge steps (12 launches) at the main path's shapes,
    # from the initial state the path builds: `ms` and `plain_ms` each
    # with a clone of that state, as every K1 record has been timed;
    # `steps_ms` the merge steps alone.
    state0 = plan._init_state(x[None], tabs, max([len(plan._init_perm)] +
                                                 plan._step_need))
    ptabs = plan._device_tables("plain", dev)
    ms = cuda_time(lambda: merge_chain(plan, tabs, state0, merge_step), 20)
    plain_ms = cuda_time(
        lambda: merge_chain(plan, ptabs, state0, merge_step_plain), 5)
    steps_ms = time_chain(plan, tabs, state0, merge_step, 20)
    if not bits_equal(merge_chain(plan, tabs, state0, merge_step),
                      merge_chain(plan, ptabs, state0, merge_step_plain)):
        raise AssertionError("merge chain cuda != plain")
    bound_ms, nbytes, _ = merge_bound(plan, ntime, hbm_rate(kind))
    phase("kernels", f"fdmt merge_step: {ms:.4f} ms per gulp with a clone "
          f"of the {tuple(state0.shape)} initial state, {steps_ms:.4f} ms "
          f"for the merge steps alone ({len(plan._steps)} launches, each "
          f"at its step's exact row count), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e9:.3f} GB at "
          f"{hbm_rate(kind) / 1e12:.2f} TB/s), {kind}")
    beam = check_fdmt_beams(dev, kind, rng)
    return {"name": "fdmt_merge_step", "route": "cuda",
            "source": "bifrost_tpu_torch/csrc/fdmt.cu",
            "replaces": "bifrost_tpu/ops/fdmt_pallas.py:43",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "steps_ms": steps_ms, "at_beam_search": beam}


def check_fdmt_beams(dev, kind, rng):
    """K1 at the beam search's shape: the 8 beams' (4096, 65) FDMT gulps
    as one batch, one launch a merge step; Fdmt.execute 'cuda' against
    'plain' bitwise, then one gulp's merge steps timed beside the plain
    version and the bound.  -> the record's beam-search fields."""
    from bifrost_tpu_torch.ops import fdmt_kernel
    plan = beam_fdmt_plan()
    ntime = B_MAX_DELAY + 1
    x = torch.from_numpy(rng.standard_normal((NBEAM, BCHAN, ntime))
                         .astype(np.float32)).to(dev)
    x[..., ::3] = -0.0
    plan.method = "plain"
    want = plan.execute(x)
    plan.method = "cuda"
    before = fdmt_kernel.merge_step.launches
    got = plan.execute(x)
    torch.cuda.synchronize()
    per_gulp = fdmt_kernel.merge_step.launches - before
    if per_gulp != len(plan._steps) or not bits_equal(got, want):
        raise AssertionError(f"beam-search FDMT: {per_gulp} launches, "
                             f"bitwise {bits_equal(got, want)}")
    tabs = plan._device_tables("cuda", dev)
    ptabs = plan._device_tables("plain", dev)
    state0 = plan._init_state(x, tabs, max([len(plan._init_perm)] +
                                           plan._step_need))
    ms = time_chain(plan, tabs, state0, fdmt_kernel.merge_step, 50)
    plain_ms = time_chain(plan, ptabs, state0, fdmt_kernel.merge_step_plain,
                          10)
    scratch = state0.clone()
    device_ms = graph_time(lambda: plan._merge_steps(
        scratch, tabs, fdmt_kernel.merge_step), 50)
    bound_ms, nbytes, _ = merge_bound(plan, ntime, hbm_rate(kind), NBEAM)
    phase("kernels", f"fdmt merge_step at the beam search's shape "
          f"({NBEAM} beams x {BCHAN} ch x {ntime} samples, the "
          f"bdetect_fdmt plan): Fdmt.execute cuda == plain bitwise; "
          f"{ms:.4f} ms per FDMT gulp ({per_gulp} launches for all "
          f"{NBEAM} beams, launched from the host as the path does), "
          f"{device_ms:.4f} ms of it on the card (the same launches "
          f"replayed from a CUDA graph, a measurement only), plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes / 1e6:.3f} MB), {kind}")
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "launches_per_gulp": per_gulp, "batch": NBEAM, "ntime": ntime}


def check_fir(dev, kind, rng):
    """K2 at the B-engine PFB's MAC shapes: one gulp of 16 folded frames
    x (4096 channels x 512 inputs x 2) lanes, 3 history rows, the
    (4, 4096) prototype shared by 1024 lanes each, on the vector kernel
    (K2's edge shapes are card tests: tests/test_torch_gpu.py)."""
    from bifrost_tpu_torch.ops import fir_kernel, pfb_coeffs
    rep = NSTAND * NPOL * 2
    lanes = BCHAN * rep
    c = torch.from_numpy(pfb_coeffs(BCHAN, NTAP).astype(np.float32)).to(dev)
    cases = {
        "integer-valued int8 voltages": (
            torch.from_numpy(rng.integers(-8, 8, (N_INT, lanes))
                             .astype(np.int8)).to(dev),
            torch.from_numpy(rng.integers(-8, 8, (NTAP - 1, lanes))
                             .astype(np.float32)).to(dev)),
        "random f32": tuple(
            torch.from_numpy(rng.standard_normal((n, lanes))
                             .astype(np.float32)).to(dev)
            for n in (N_INT, NTAP - 1)),
    }
    worst = 0.0
    for name, (x, st) in cases.items():
        nvec = fir_kernel.fir_mac.vector_launches
        got = fir_kernel.fir_mac(x, c, st, 1, rep)
        want = fir_kernel.fir_mac_plain(x, c, st, 1, rep)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise AssertionError(f"fir_mac differs from plain on {name}")
        if fir_kernel.fir_mac.vector_launches != nvec + 1:
            raise AssertionError(f"fir_mac took its scalar kernel on {name}")
        worst = max(worst, float((got - want).abs().max()))
    x8, st8 = cases["integer-valued int8 voltages"]
    out = torch.empty(N_INT, lanes, device=dev)
    ms = cuda_time(lambda: fir_kernel.fir_mac(x8, c, st8, 1, rep, out=out),
                   20)
    plain_ms = cuda_time(
        lambda: fir_kernel.fir_mac_plain(x8, c, st8, 1, rep), 5)
    # The library yardstick: one depthwise conv1d over the history-
    # extended lanes (the JAX package's 'conv' method), in full f32.
    torch.backends.cudnn.allow_tf32 = False
    xin = torch.cat([st8, x8.float()]).T.contiguous()[None]
    wconv = c.flip(0).T.repeat_interleave(rep, 0)[:, None, :].contiguous()
    lib = F.conv1d(xin, wconv, groups=lanes)[0].T
    err = float((lib - out).abs().max() / out.abs().max())
    if err > 1e-5:
        raise AssertionError(f"conv1d differs from the MAC: rel {err}")
    library_ms = cuda_time(lambda: F.conv1d(xin, wconv, groups=lanes), 5)
    del xin, wconv, lib
    nbytes, nops = fir_work(N_INT, lanes, NTAP, BCHAN, 1)
    bound_ms, by = bound(nbytes, nops, hbm_rate(kind))
    phase("kernels", f"fir_mac equal to plain (tolerance: bitwise) on "
          f"{' and '.join(cases)} at ({N_INT}, {lanes}) lanes, rep {rep} "
          f"(vector kernel); "
          f"{ms:.4f} ms per gulp (1 launch), plain {plain_ms:.4f} ms, "
          f"conv1d {library_ms:.4f} ms (rel err {err:.2e}), bound "
          f"{bound_ms:.4f} ms ({by}: {nbytes / 1e9:.4f} GB, "
          f"{nops / 1e9:.4f} G ops), {kind}")
    fir16 = check_fir16(dev, kind, rng)
    return {"name": "fir_mac", "route": "cuda",
            "source": "bifrost_tpu_torch/csrc/fir.cu",
            "replaces": "bifrost_tpu/ops/fir_pallas.py:47",
            "launches": None, "max_abs_err": max(worst, fir16["max_abs_err"]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": library_ms, "at_fir": fir16}


def fir16_ptxas():
    """ptxas's registers and spilled bytes of K2's long-form
    instantiations at FIR_NTAP taps (the `fir_long` build), from this
    process's build log -> {'int8 cpt 4': (registers, spill stores,
    spill loads), ...}."""
    import re

    from bifrost_tpu_torch import build
    out, name = {}, None
    for ln in build.build_log.get("fir_long", {}).get("ptxas",
                                                      "").splitlines():
        m = re.search(r"fir_mac_vec_kernelI([af])Li(\d+)ELi(\d+)E", ln)
        if "Compiling entry function" in ln or "Function properties" in ln:
            name = None
            if m and int(m.group(2)) == FIR_NTAP:
                name = (f"{'int8' if m.group(1) == 'a' else 'f32'} cpt "
                        f"{m.group(3)}")
                out.setdefault(name, [None, None, None])
        elif name is not None and "spill stores" in ln:
            v = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            out[name][1:] = [int(x) for x in v[:2]]
        elif name is not None and "Used" in ln and "registers" in ln:
            out[name][0] = int(re.search(r"Used (\d+) registers",
                                         ln).group(1))
    return {k: tuple(v) for k, v in out.items()}


def check_fir16(dev, kind, rng):
    """K2 at [fir]'s shape: one gulp of B_GULP frames x 1024 lanes (256
    stations x 2 pol x (re, im)), FIR_NTAP taps, a column for each (re,
    im) pair (rep 2), at each of FIR_DECIMS: int8 input on the vector
    kernel's long form, f32 on the scalar kernel, and an unaligned copy
    of either (the scalar kernel), bitwise their plain version; int8
    timed by the vector and scalar kernels, the plain version and the
    conv1d yardstick, beside the bound; ptxas's registers and spills of
    the 16-tap instantiations.  -> the kernel record's `at_fir`
    fields."""
    from bifrost_tpu_torch.ops import fir_kernel
    lanes = NSTAND * NPOL * 2
    ncoef = lanes // 2
    c = torch.from_numpy(rng.standard_normal((FIR_NTAP, ncoef))
                         .astype(np.float32)).to(dev)
    st = torch.from_numpy(rng.standard_normal((FIR_NTAP - 1, lanes))
                          .astype(np.float32)).to(dev)
    x8 = torch.from_numpy(rng.integers(-128, 128, (B_GULP, lanes))
                          .astype(np.int8)).to(dev)
    xf = torch.from_numpy(rng.standard_normal((B_GULP, lanes))
                          .astype(np.float32)).to(dev)
    xf[::3, ::5] = -0.0

    def unaligned(x):
        y = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
        return y.view(x.shape).copy_(x)
    worst, out = 0.0, {"ptxas": fir16_ptxas()}
    torch.backends.cudnn.allow_tf32 = False
    for decim in FIR_DECIMS:
        nout = B_GULP // decim
        for name, x in (("int8", x8), ("f32", xf)):
            want = fir_kernel.fir_mac_plain(x, c, st, decim, 2)
            xs = unaligned(x)
            nvec = fir_kernel.fir_mac.vector_launches
            got = fir_kernel.fir_mac(x, c, st, decim, 2)
            gots = fir_kernel.fir_mac(xs, c, st, decim, 2)
            torch.cuda.synchronize()
            if fir_kernel.fir_mac.vector_launches != \
                    nvec + (name == "int8") or \
                    not bits_equal(got, want) or not bits_equal(gots, want):
                raise AssertionError(f"fir_mac at {FIR_NTAP} taps, decim "
                                     f"{decim}, {name}: a kernel differs "
                                     f"from plain, or the route")
            worst = max(worst, float((got - want).abs().max()))
            del want, got, gots, xs
        y = torch.empty(nout, lanes, device=dev)
        xs = unaligned(x8)
        ms = cuda_time(lambda: fir_kernel.fir_mac(x8, c, st, decim, 2,
                                                  out=y), 20)
        scalar_ms = cuda_time(lambda: fir_kernel.fir_mac(xs, c, st, decim, 2,
                                                         out=y), 5)
        plain_ms = cuda_time(
            lambda: fir_kernel.fir_mac_plain(x8, c, st, decim, 2), 3)
        xin = torch.cat([st, x8.float()]).T.contiguous()[None]
        wconv = c.flip(0).T.repeat_interleave(2, 0)[:, None, :].contiguous()
        lib = F.conv1d(xin, wconv, stride=decim, groups=lanes)[0].T
        fir_kernel.fir_mac(x8, c, st, decim, 2, out=y)
        err = float((lib - y).abs().max() / y.abs().max())
        if err > 1e-5:
            raise AssertionError(f"conv1d differs from the MAC: rel {err}")
        library_ms = cuda_time(
            lambda: F.conv1d(xin, wconv, stride=decim, groups=lanes), 3)
        nbytes, nops = fir_work(nout, lanes, FIR_NTAP, ncoef, 1, decim)
        bound_ms, by = bound(nbytes, nops, hbm_rate(kind))
        out[f"decim{decim}"] = {
            "ms": ms, "scalar_ms": scalar_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": by,
            "share_of_bound": bound_ms / ms}
        phase("kernels", f"fir_mac at [fir]'s shape ({B_GULP} x {lanes} "
              f"lanes, {FIR_NTAP} taps, rep 2, decim {decim}) equal to "
              f"plain (tolerance: bitwise): int8 on the vector kernel's "
              f"long form, f32 with -0.0 and unaligned copies of both on the "
              f"scalar kernel; int8: vector {ms:.4f} ms, scalar "
              f"{scalar_ms:.4f} ms, plain {plain_ms:.4f} ms, conv1d "
              f"{library_ms:.4f} ms (rel err {err:.2e}), bound "
              f"{bound_ms:.4f} ms ({by}: {nbytes / 1e9:.4f} GB, "
              f"{nops / 1e9:.4f} G ops), {100 * bound_ms / ms:.1f} % of it; "
              f"{kind}")
        del y, xs, xin, wconv, lib
    phase("kernels", f"fir_mac {FIR_NTAP}-tap instantiations (registers, "
          f"spill stores, spill loads): {out['ptxas']}")
    out["max_abs_err"] = worst
    return out


# K4's edge shapes: (nbeam, ci8, ntime, nchan, nsp, x offset in samples):
# frames 0, 1 and across the 256-row frame tile, channels not a multiple
# of a block's, stations 1 and across the 16 (c64) or 64 (ci8) station
# chunks, beams across the groups of 8, element copies (rows or the base
# not 16-byte aligned).
K4_EDGES = ((1, False, 1, 5, 300, 0), (3, True, 5, 30, 1, 0),
            (8, False, 16, 13, 513, 0), (9, True, 33, 5, 300, 0),
            (128, False, 5, 7, 64, 0), (8, True, 260, 3, 520, 0),
            (9, False, 260, 3, 40, 0), (8, False, 16, 9, 512, 1),
            (8, True, 16, 9, 512, 1), (8, False, 0, 5, 300, 0))


def check_beamform_edges(dev, rng):
    """K4 bitwise against its plain version on K4_EDGES."""
    from bifrost_tpu_torch.ops import beamform_kernel as bk
    for nbeam, ci8, ntime, nchan, nsp, off in K4_EDGES:
        n = ntime * nchan * nsp + off
        if ci8:
            x = torch.from_numpy(rng.integers(-128, 128, (n, 2)).astype(
                np.int8)).to(dev)[off:].view(ntime, nchan, nsp, 2)
        else:
            x = torch.randn(n, dtype=torch.complex64, device=dev)[off:] \
                .view(ntime, nchan, nsp)
        w = torch.randn(nbeam, nsp, dtype=torch.complex64, device=dev)
        got = bk.beamform_power(x, w)
        torch.cuda.synchronize()
        if not bits_equal(got, bk.beamform_power_plain(x, w)):
            raise AssertionError(f"beamform_power differs from plain at "
                                 f"{(nbeam, ci8, ntime, nchan, nsp, off)}")
    return len(K4_EDGES)


def check_beamform(dev, kind, rng):
    """K4 at the B-engine's shapes: one gulp of 16 spectra x 4096
    channels x 512 inputs, 8 beams; then K4_EDGES."""
    from bifrost_tpu_torch.ops import beamform_kernel as bk
    from bifrost_tpu_torch.service import default_beam_weights
    shape = (N_INT, BCHAN, NSTAND * NPOL)
    nsp = shape[2]

    def cplx(a, b):
        return torch.complex(torch.from_numpy(a), torch.from_numpy(b)).to(dev)

    ints = rng.integers(-8, 8, shape + (2,)).astype(np.int8)
    wi = torch.from_numpy(default_beam_weights(NBEAM, nsp)).to(dev)
    xf = cplx(*(rng.standard_normal(shape).astype(np.float32)
                for _ in range(2)))
    wf = cplx(*(rng.standard_normal((NBEAM, nsp)).astype(np.float32)
                for _ in range(2)))
    xi = cplx(ints[..., 0].astype(np.float32), ints[..., 1].astype(np.float32))
    cases = {"integer-valued c64": (xi, wi),
             "ci8 storage": (torch.from_numpy(ints).to(dev), wi),
             "random f32": (xf, wf)}
    worst = 0.0
    for name, (x, w) in cases.items():
        got = bk.beamform_power(x, w)
        want = bk.beamform_power_plain(x, w)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise AssertionError(f"beamform_power differs from plain on "
                                 f"{name}")
        worst = max(worst, float((got - want).abs().max()))
    del xi, cases
    out = torch.empty(NBEAM, BCHAN, device=dev)
    ms = cuda_time(lambda: bk.beamform_power(xf, wf, out=out), 20)
    plain_ms = cuda_time(lambda: bk.beamform_power_plain(xf, wf), 2)
    # The library yardstick, the matmul part only: the complex beams of
    # every channel, (C, T, S) @ (S, B), without detect or integrate.
    xp, wt = xf.permute(1, 0, 2).contiguous(), wf.T.contiguous()
    library_ms = cuda_time(lambda: torch.matmul(xp, wt), 10)
    nbytes, nops = beamform_work(*shape, NBEAM, 8)
    bound_ms, by = bound(nbytes, nops, hbm_rate(kind))
    geo = bk.launch_geometry(*shape, NBEAM, 8, xf.data_ptr())
    info = {f"{'ci8' if i8 else 'c64'} {'16-byte' if v else 'element'}":
            bk.kernel_info(i8, v) for i8 in (False, True)
            for v in (True, False)}
    if info["c64 16-byte"]["smem"] != geo["smem"]:
        raise AssertionError(f"launch_geometry's shared memory {geo} "
                             f"differs from the kernel's {info}")
    nedge = check_beamform_edges(dev, rng)
    phase("kernels", f"beamform_power equal to plain (tolerance: bitwise) "
          f"on integer-valued c64, ci8 storage and random f32 at "
          f"{shape} x {NBEAM} beams and on {nedge} edge shapes; launch "
          f"{geo}; instantiations {info}; {ms:.4f} ms per gulp (1 launch), "
          f"plain {plain_ms:.4f} ms, complex matmul alone (the beams, no "
          f"detect or integrate) {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({by}: {nbytes / 1e9:.4f} GB, "
          f"{nops / 1e9:.4f} G ops), {kind}")
    return {"name": "beamform_power", "route": "cuda",
            "source": "bifrost_tpu_torch/csrc/beamform.cu",
            "replaces": "bifrost_tpu/ops/beamform_pallas.py:54",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms,
            "library_call": "torch.matmul (C,T,S)@(S,B) complex64, the "
                            "matmul part only"}


def xe_work(ntime, nchan, nsp, kind):
    """Bytes and operations of one X1 call on ci4: the voltages read once
    (1 B a sample), the complex64 matrix written once; 8 int8 operations
    per frame and pair i <= j (four products, each a multiply and an
    add), the function's need, since v[c, j, i] = conj(v[c, i, j]).
    -> (ms bound, 'bytes' or 'operations', bytes, ops, the operations
    X1 does on the full matrix)."""
    nbytes = ntime * nchan * nsp + 8 * nchan * nsp * nsp
    nops = 8 * nchan * (nsp * (nsp + 1) // 2) * ntime
    tb, to = nbytes / hbm_rate(kind), nops / INT8_PEAK
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations"), \
        nbytes, nops, 8 * nchan * nsp * nsp * ntime


def check_xengine(dev, kind):
    """X1 at the int8 configuration's gulp (1024 frames x 128 channels x
    512 inputs) on ci4 and ci8 storage, on XE_EDGES and at XE_GUARD,
    bitwise against its plain version (f64 matmul, exact), each into an
    output prefilled with NaN, so that a tile left unwritten fails; timed
    as a whole call (`ms`, the corner turn and the tiles) and each kernel
    apart, beside the plain version and `torch._int_mm`."""
    from bifrost_tpu_torch.ops import xengine_kernel as xk
    nsp = XE_NSTAND * XE_NPOL
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def data(shape, fmt):
        if fmt == "ci4":
            return torch.randint(0, 256, shape, device=dev,
                                 dtype=torch.uint8, generator=gen)
        return torch.randint(-128, 128, shape + (2,), device=dev,
                             dtype=torch.int8, generator=gen)

    worst = 0.0
    cases = [(shape, fmt) for shape in ((XE_GULP, XE_NCHAN, nsp),) + XE_EDGES
             for fmt in ("ci4", "ci8")] + [(XE_GUARD, "guard")]
    for shape, fmt in cases:
        if fmt == "guard":
            fmt, x = "ci8", torch.full(shape + (2,), -128, device=dev,
                                       dtype=torch.int8)
        else:
            x = data(shape, fmt)
        got = torch.full(shape[1:] + shape[2:], complex(np.nan, np.nan),
                         dtype=torch.complex64, device=dev)
        xk.xengine_int8(x, fmt, got)
        want = xk.xengine_int8_plain(x, fmt)
        torch.cuda.synchronize()
        if not bits_equal(torch.view_as_real(got),
                          torch.view_as_real(want)):
            raise AssertionError(f"xengine_int8 differs from plain on "
                                 f"{fmt} {shape}")
        worst = max(worst, float((got - want).abs().max()))
    x4 = data((XE_GULP, XE_NCHAN, nsp), "ci4")
    out = torch.empty(XE_NCHAN, nsp, nsp, dtype=torch.complex64, device=dev)
    ms = cuda_time(lambda: xk.xengine_int8(x4, "ci4", out), 20)
    # Each kernel apart, through the library (uncounted: timing only).
    lib, tp = xk._library(), xk.pitch(XE_GULP)
    planes = torch.empty((2 * XE_NCHAN, nsp, tp), dtype=torch.int8,
                         device=dev)

    def checked(err):
        if err:
            raise RuntimeError(lib.xengine_error_string(err).decode())

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream
    turn_ms = cuda_time(lambda: checked(lib.xengine_corner_turn(
        x4.data_ptr(), 1, XE_GULP, XE_NCHAN, nsp, planes.data_ptr(), tp,
        stream())), 20)
    tiles_ms = cuda_time(lambda: checked(lib.xengine_tiles(
        planes.data_ptr(), tp, XE_NCHAN, nsp, out.data_ptr(), stream())), 20)
    del planes
    plain_ms = cuda_time(lambda: xk.xengine_int8_plain(x4, "ci4"), 2)
    # The library yardstick: torch._int_mm (cuBLASLt int8 -> int32), the
    # four products of every channel over planes unpacked beforehand into
    # the layouts it takes; it leaves out the unpack, the sums rr + ii
    # and ri - ir, the f32 conversion and the complex interleave.
    re, im = xk.planes(x4, "ci4")
    ar, ai = (p.permute(1, 2, 0).contiguous() for p in (re, im))
    br, bi = (p.permute(1, 0, 2).contiguous() for p in (re, im))
    del re, im

    def library():
        for c in range(XE_NCHAN):
            for a, b in ((ar, br), (ai, bi), (ar, bi), (ai, br)):
                torch._int_mm(a[c], b[c])
    library_ms = cuda_time(library, 5)
    del ar, ai, br, bi
    bound_ms, by, nbytes, nops, full_ops = xe_work(XE_GULP, XE_NCHAN, nsp,
                                                   kind)
    info = xk.kernel_info()
    phase("kernels", f"xengine_int8 (X1) equal to plain (tolerance: "
          f"bitwise, max abs err {worst}, outputs prefilled with NaN) on "
          f"ci4 and ci8 at {(XE_GULP, XE_NCHAN, nsp)}, on edge shapes "
          f"{XE_EDGES} and at the guard's edge {XE_GUARD} (ci8, all "
          f"-128); {ms:.4f} ms per gulp (1 call: corner turn alone "
          f"{turn_ms:.4f} ms, tiles alone {tiles_ms:.4f} ms), "
          f"{bound_ms / ms:.1%} of the bound, {nops / ms / 1e9:.1f} int8 "
          f"TOPS on the pairs i <= j ({nops / tiles_ms / 1e9:.1f} in the "
          f"tiles alone); plain (f64 matmul) {plain_ms:.4f} ms, "
          f"torch._int_mm x 4 x {XE_NCHAN} channels on pre-unpacked "
          f"planes {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}: "
          f"{nbytes / 1e9:.4f} GB at {hbm_rate(kind) / 1e12} TB/s, "
          f"{nops / 1e12:.4f} T int8 ops (pairs i <= j) at "
          f"{INT8_PEAK / 1e12} TOPS; the full matrix "
          f"{full_ops / 1e12:.4f} T ops, "
          f"{full_ops / INT8_PEAK * 1e3:.4f} ms); kernels (registers at "
          f"launch, local bytes, shared memory static / dynamic a block) "
          f"{info}; the tiles' consumers raised to 240 registers by "
          f"setmaxnreg; {kind}")
    return {"name": "xengine_int8", "route": "cuda",
            "source": "bifrost_tpu_torch/csrc/xengine.cu",
            "replaces": "bifrost_tpu/blocks/correlate.py:516",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms,
            "library_call": "torch._int_mm, 4 products a channel on "
                            "pre-unpacked int8 planes",
            "corner_turn_ms": turn_ms, "tiles_ms": tiles_ms}


def time_dft(dev, kind, rng):
    """The PFB's DFT stage at one gulp's shapes: 4 x 16 f32 matmuls of
    (4096, 4096) @ (4096, 512), TF32 off."""
    from bifrost_tpu_torch.ops.pfb_kernel import _dft_mats, dft
    nsp = NSTAND * NPOL
    z = torch.from_numpy(rng.standard_normal((N_INT, BCHAN * nsp * 2))
                         .astype(np.float32)).to(dev)
    wre, wim = (torch.from_numpy(a).to(dev) for a in _dft_mats(BCHAN))
    out = torch.empty(N_INT, BCHAN, nsp, dtype=torch.complex64, device=dev)
    ms = cuda_time(lambda: dft(z, wre, wim, BCHAN, nsp, 2, out=out), 3)
    nops = 4 * 2 * N_INT * BCHAN * BCHAN * nsp
    bound_ms = nops / F32_PEAK * 1e3
    phase("kernels", f"pfb DFT matmuls (torch.matmul, TF32 off): {ms:.4f} "
          f"ms per gulp ({4 * N_INT} matmuls of ({BCHAN}, {BCHAN}) @ "
          f"({BCHAN}, {nsp})), f32 bound {bound_ms:.4f} ms "
          f"({nops / 1e12:.4f} T ops at {F32_PEAK / 1e12:.0f} TFLOP/s), "
          f"{kind}")
    return ms


def bengine_path(dev):
    """The LWA beam-search chain at full width (module docstring, phase
    5).  -> (the kernels' launch counts in the main run, the voltages,
    the gathered beam powers and dedispersed frames, and the first
    integration's f64 golden spectra (N_INT, BCHAN, nsp))."""
    from bifrost_tpu_torch.ops import pfb_coeffs
    from bifrost_tpu_torch.service import (default_beam_weights,
                                           lwa_beam_search_pipeline)
    nsp = NSTAND * NPOL
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    block = rng.integers(-8, 8, (B_REPLAY * B_GULP, NSTAND, NPOL, 2),
                         dtype=np.int8)
    volt = np.concatenate([block] * (B_NINT // B_REPLAY) +
                          [block[:B_NINT % B_REPLAY * B_GULP]])
    phase("bengine", f"voltages: {volt.nbytes / 2**30:.2f} GiB of ci8 "
          f"({len(volt)} frames; a {B_REPLAY}-integration block replayed "
          f"{B_NINT / B_REPLAY:g} times), {time.perf_counter() - t0:.1f} s")

    def build(method, gather):
        return lwa_beam_search_pipeline(
            volt, nstand=NSTAND, npol=NPOL, nchan=BCHAN, ntap=NTAP,
            n_int=N_INT, nbeam=NBEAM, max_delay=B_MAX_DELAY,
            f0_mhz=B_F0, dt_s=B_DT, gulp_nframe=B_GULP, device=dev,
            pfb_method=method, beamform_method=method, fdmt_method=method,
            gather=gather, fuse=False)

    got = {"beams": Stamped(), "dedispersed": []}
    pipe, det, ledger = build(None, got)
    reset_counts()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = read_counts()
    wall = t1 - t0
    blocks = {b.name: b for b in pipe.blocks}
    fd = blocks["bdetect_fdmt"]
    nfdmt = B_NINT - B_MAX_DELAY           # FDMT gulps: one frame each
    expect = expected(fir_mac=B_NINT, beamform_power=B_NINT,
                      fdmt_merge_step=nfdmt * len(fd.fdmt._steps))
    if counts != expect:
        raise AssertionError(f"launches {counts}, expected {expect}")
    nvec = check_vectors(counts, "fir_mac")
    if not same_plan(fd.fdmt, beam_fdmt_plan()):
        raise AssertionError("bdetect_fdmt's plan differs from the one "
                             "[kernels] timed")
    s = ledger.summary()
    if s["lost_frames"] or s["duplicated_frames"] or \
            s["committed_frames"] != nfdmt:
        raise AssertionError(f"frame ledger: {s}")
    nframe = len(volt)
    # Steady state: from the first integration's powers to the last one's,
    # in voltage frames.  Not from the detector's first gulp: the FDMT's
    # input ring holds 3 x (1 + max_delay) frames, so everything up to the
    # beamformer may have finished the stream before the detector starts.
    stamps = got["beams"].stamps
    steady = (len(stamps) - 1) * B_GULP / (stamps[-1] - stamps[0])
    phase("bengine", f"beam search {NSTAND}x{NPOL} inputs x {BCHAN} ch, "
          f"{NBEAM} beams, {nframe} frames: {wall:.3f} s, "
          f"{nframe / wall:.1f} frames/s, {nframe * nsp / wall:.4g} "
          f"station-pol samples/s with start-up; first integration out "
          f"after {stamps[0] - t0:.3f} s, the detector's first gulp after "
          f"{ledger.first_sink_t - t0:.3f} s; steady state {steady:.1f} "
          f"frames/s, {steady * nsp:.4g} samples/s (first to last "
          f"integration out); launches {counts} (fdmt: {nfdmt} gulps x "
          f"{len(fd.fdmt._steps)} steps, {NBEAM} beams a launch; K2: "
          f"{nvec} vector); ledger {s}; "
          f"candidates {len(det.candidates)}")
    perf = {b.name: {k: round(v, 4) for k, v in b.perf_totals.items()}
            for b in pipe.blocks}
    phase("bengine", f"host seconds by block and phase: {json.dumps(perf)}")
    del pipe, det, blocks, fd

    ref = {"beams": [], "dedispersed": []}
    build("plain", ref)[0].run()
    for key, n in (("beams", B_NINT), ("dedispersed", nfdmt)):
        a, b = got[key], ref[key]
        if len(a) != n or len(b) != n:
            raise AssertionError(f"gathered {len(a)}/{len(b)} {key}")
        for x, y in zip(a, b):
            if x.shape != y.shape or not np.isfinite(x).all() or \
                    not np.array_equal(x.view(np.uint32), y.view(np.uint32)):
                raise AssertionError(f"{key}: kernels != plain")

    # The first integration against an f64 numpy golden: the FIR taps and
    # np.fft per the PFB's definition, then the beams (benchmarks/
    # e2e_tpu.py:286-298, 384-410).
    c = pfb_coeffs(BCHAN, NTAP)
    x = (block[:B_GULP, ..., 0].astype(np.float64) +
         1j * block[:B_GULP, ..., 1]).reshape(N_INT, BCHAN, nsp)
    z = np.zeros_like(x)
    for k in range(NTAP):
        z[k:] += c[k][None, :, None] * x[:N_INT - k]
    spec = np.fft.fft(z, axis=1)
    w = default_beam_weights(NBEAM, nsp).astype(np.complex128)
    beams = spec @ w.T                                # (t, c, b)
    golden = (beams.real ** 2 + beams.imag ** 2).sum(axis=0).T
    err = float(np.abs(got["beams"][0][0] - golden).max() /
                np.abs(golden).max())
    if not err <= 1e-4:
        raise AssertionError(f"first integration vs f64 golden: rel {err}")
    phase("bengine", f"beam powers ({B_NINT} x {NBEAM} x {BCHAN}) and "
          f"dedispersed frames ({nfdmt} x {NBEAM} x {B_MAX_DELAY}) bitwise "
          f"equal: kernels vs plain; first integration vs the f64 numpy "
          f"golden: max rel err {err:.3e} (limit 1e-4)")
    return counts, volt, got, spec


def romein_work(plan, npol, nvis, rate):
    """Least milliseconds of one gridding call: the visibilities read
    once (complex64), every grid cell written once, the plan's offsets
    and entries and the kernel planes read once; 8 (K6a) or 14 (K6b)
    operations for each in-grid contribution on each plane.  -> (ms,
    'bytes' or 'operations', bytes, operations)."""
    ncell = plan.ngrid * plan.ngrid
    planes = (plan.u, plan.v) if plan.separable else (plan.kern,)
    nbytes = (npol * nvis * 8 + npol * ncell * 8 + (ncell + 1) * 4 +
              plan.ncontrib * 4 + sum(p.numel() * 8 for p in planes))
    nops = npol * plan.ncontrib * (14 if plan.separable else 8)
    ms, by = bound(nbytes, nops, rate)
    return ms, by, nbytes, nops


def romein_layout(plan, npol, vs_bytes, rate):
    """The tiled plan's statistics and the floor that the data's layout
    sets: each tile's visibilities S_T gathered as whole 32-byte sectors
    at `vs_bytes` between visibilities (each sector read once a plane),
    each grid cell written once.  -> dict (sum |S_T| / nvis, sectors per
    plane, floor ms)."""
    t = plan.tiles
    tc, cv = t.tile_chunk0.cpu().numpy(), t.chunk_vis0.cpu().numpy()
    sv = t.svis.cpu().numpy().astype(np.int64)
    sectors = sum(np.unique(sv[cv[tc[i]]:cv[tc[i + 1]]] * vs_bytes // 32)
                  .size for i in range(tc.size - 1))
    ncell = plan.ngrid * plan.ngrid
    floor = npol * (sectors * 32 + ncell * 8) / rate * 1e3
    return {"st_ratio": sv.size / plan.ndata, "sectors": sectors,
            "floor_ms": floor}


def k6a_kernels(nvis):
    """The seeded non-rank-1 (1, nvis, 3, 3) kernel plane of K6a's
    check and run."""
    rng = np.random.default_rng(SEED + 6)
    return (rng.standard_normal((1, nvis, M_KERN, M_KERN)) +
            1j * rng.standard_normal((1, nvis, M_KERN, M_KERN))) \
        .astype(np.complex64)


def same_romein_plans(a, b, name):
    """Hold a device-origin plan `b` against the host-origin plan `a`,
    table by table, bitwise."""
    from bifrost_tpu_torch.ops.romein_kernel import Tiles
    if (a.origin, b.origin) != ("host", "device") or \
            a.separable != b.separable:
        raise AssertionError(f"{name}: plans {a.origin}/{b.origin}, "
                             f"separable {a.separable}/{b.separable}")
    names = ["offsets", "entries"] + (["u", "v"] if a.separable else
                                      ["kern"])
    tabs = [(n, getattr(a, n), getattr(b, n)) for n in names] + \
        [(n, getattr(a.tiles, n), getattr(b.tiles, n)) for n in Tiles.NAMES]
    for n, x, y in tabs:
        if x.dtype != y.dtype or x.shape != y.shape or not bits_equal(
                x.view(torch.int32), y.view(torch.int32)):
            raise AssertionError(f"{name}: device-origin table {n} differs "
                                 f"from the host-built one")


def romein_rebuilds(dev, uvw, kern, npol, nvis):
    """K6b's plan rebuilt for RM_NSEQ sequences, each with new positions
    (the patch corners shifted by the sequence number), from host arrays
    and from card tensors -> (host s, device s) in all."""
    from bifrost_tpu_torch.ops import Romein
    secs = [0.0, 0.0]
    for k in range(RM_NSEQ):
        pos = (uvw + k) % (NGRID - M_KERN)
        for i, p in enumerate((pos, torch.from_numpy(pos).to(dev))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Romein().init(p, kern, NGRID).plan(npol, nvis, dev)
            secs[i] += time.perf_counter() - t0
    return secs


def check_romein(dev, kind):
    """K6a and K6b at the imaging branch's shapes: one frame of 4096
    planes x 262,144 visibilities, laid out as the time-last ring span
    gives them (one complex64 every 16 bytes), gridded onto 128 x 128;
    K6b with the default kernel, K6a with the seeded non-rank-1 plane.
    Each against its plain version bitwise and against a rerun, timed
    beside the bound, the layout's floor and cuSPARSE SpMM
    (`torch.sparse.mm` with the plan as a CSR matrix); the tiled plan's
    geometry and statistics and each kernel instantiation's registers and
    shared memory on a line of their own.  -> the two kernel records."""
    from bifrost_tpu_torch import build
    from bifrost_tpu_torch.ops import Romein
    from bifrost_tpu_torch.ops.romein_kernel import (TILE, WARPS,
                                                     chunk_slots,
                                                     kernel_info)
    from bifrost_tpu_torch.service import default_grid_kernel, default_uvw
    npol, nsp = BCHAN, NSTAND * NPOL
    nvis = nsp * nsp
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    raw = torch.randn(npol, nvis, 2, 2, device=dev, generator=gen)
    data = torch.view_as_complex(raw)[..., 0]
    uvw = default_uvw(NSTAND, NPOL, NGRID, M_KERN)
    recs = []
    for name, kern, src in (
            ("romein_grid_separable", default_grid_kernel(M_KERN),
             "bifrost_tpu/ops/romein_pallas.py:505"),
            ("romein_grid_general", k6a_kernels(nvis),
             "bifrost_tpu/ops/romein_pallas.py:591")):
        t0 = time.perf_counter()
        plan, _ = Romein().init(uvw, kern, NGRID).plan(npol, nvis, dev)
        plan_s = time.perf_counter() - t0
        if plan.separable != (name == "romein_grid_separable"):
            raise AssertionError(f"{name}: wrong kernel chosen")
        # The same plan from card tensors (origin 'device').
        uvw_d = torch.from_numpy(uvw).to(dev)
        kern_d = torch.from_numpy(kern).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dplan, _ = Romein().init(uvw_d, kern_d, NGRID).plan(npol, nvis, dev)
        dplan_s = time.perf_counter() - t0
        same_romein_plans(plan, dplan, name)
        out = torch.empty(npol, NGRID, NGRID, dtype=torch.complex64,
                          device=dev)
        plan.grid(data, out, "cuda", False)
        again = torch.full_like(out, complex(-0.0, -0.0))
        plan.grid(data, again, "cuda", False)
        want = plan.grid(data, torch.empty_like(out), "plain", False)
        torch.cuda.synchronize()
        if not bits_equal(torch.view_as_real(out), torch.view_as_real(want)):
            raise AssertionError(f"{name} differs from plain")
        if not bits_equal(torch.view_as_real(out), torch.view_as_real(again)):
            raise AssertionError(f"{name}: a rerun differs")
        worst = float((out - want).abs().max())
        del want, again
        dout = torch.empty_like(out)
        dplan.grid(data, dout, "cuda", False)
        torch.cuda.synchronize()
        if not bits_equal(torch.view_as_real(out), torch.view_as_real(dout)):
            raise AssertionError(f"{name}: the device-origin plan's grid "
                                 f"differs from the host-origin plan's")
        del dout
        ms = cuda_time(lambda: plan.grid(data, out, "cuda", False), 20)
        dms = cuda_time(lambda: dplan.grid(data, out, "cuda", False), 20)
        seq = romein_rebuilds(dev, uvw, kern, npol, nvis) \
            if plan.separable else None
        seq_line = "" if seq is None else (
            f"rebuilt for {RM_NSEQ} sequences of new positions: host "
            f"{seq[0]:.3f} s, device {seq[1]:.3f} s in all; ")
        plain_ms = cuda_time(
            lambda: plan.grid(data, torch.empty_like(out), "plain", False),
            1)
        # The library yardstick: cuSPARSE SpMM, the plan as a (cells x
        # visibilities) CSR matrix of kernel values times the (nvis,
        # npol) visibilities, laid out once outside the timing.
        vis_of = torch.div(plan.entries.long(), M_KERN * M_KERN,
                           rounding_mode="floor")
        jk = plan.entries.long() % (M_KERN * M_KERN)
        vals = plan.u.reshape(-1)[jk // M_KERN] * \
            plan.v.reshape(-1)[jk % M_KERN] if plan.separable else \
            plan.kern.reshape(-1)[plan.entries.long()]
        csr = torch.sparse_csr_tensor(plan.offsets.long(), vis_of, vals,
                                      (NGRID * NGRID, nvis))
        dense = data.T.contiguous()
        lib = torch.sparse.mm(csr, dense).T.reshape(out.shape)
        lib_err = float((lib - out).abs().max() / out.abs().max())
        if not lib_err <= 1e-4:
            raise AssertionError(f"{name}: SpMM differs, rel {lib_err}")
        library_ms = cuda_time(lambda: torch.sparse.mm(csr, dense), 3)
        del lib, dense, csr, vals, vis_of, jk
        bound_ms, by, nbytes, nops = romein_work(plan, npol, nvis,
                                                 hbm_rate(kind))
        lay = romein_layout(plan, npol, data.stride(1) * 8, hbm_rate(kind))
        t = plan.tiles
        info = {f"{'sep' if sep else 'gen'}_{src}":
                kernel_info(sep, i, t.max_cells) for sep in (True, False)
                for i, src in enumerate(("global", "table", "chunk"))}
        spills = [ln.strip() for ln in
                  build.build_log.get("romein", {}).get("ptxas",
                                                        "").splitlines()
                  if "spill" in ln]
        phase("kernels", f"{name} tiled plan: tile {TILE}, chunk "
              f"{chunk_slots(plan.m)}, {WARPS} warps a block; {t.nchunk} "
              f"chunks, {t.items.numel()} items, at most {t.max_cells} "
              f"cells with contributions in a tile; sum |S_T| / nvis "
              f"{lay['st_ratio']:.4f}; {lay['sectors']} sectors of 32 B "
              f"per plane ({lay['sectors'] / nvis:.4f} per visibility at "
              f"{data.stride(1) * 8} B between visibilities); layout floor "
              f"{lay['floor_ms']:.4f} ms; plan {plan_s:.3f} s on the host, "
              f"{plan.tiles_build_s:.3f} s of it the tiled plan; from card "
              f"tensors (origin 'device') {dplan_s:.3f} s, "
              f"{dplan.tiles_build_s:.3f} s of it the tiled plan, every "
              f"table bitwise the host-built plan's; "
              f"{seq_line}"
              f"instantiations (regs per thread, spilled bytes per "
              f"thread, static + dynamic smem per block, blocks per SM): "
              f"{json.dumps(info)}; ptxas: {spills}")
        phase("kernels", f"{name} ({'K6b' if plan.separable else 'K6a'}) "
              f"equal to plain (tolerance: bitwise) and to a rerun at {npol} "
              f"planes x "
              f"{nvis} vis -> {NGRID}x{NGRID}, {plan.ncontrib} in-grid "
              f"contributions per plane (at most {plan.maxcount} in a "
              f"cell); {ms:.4f} ms per frame (1 launch), from the "
              f"device-origin plan {dms:.4f} ms ({100 * (dms / ms - 1):+.2f} "
              f"%, grid bitwise equal), plain "
              f"{plain_ms:.4f} ms, SpMM {library_ms:.4f} ms (rel err "
              f"{lib_err:.2e}), bound {bound_ms:.4f} ms ({by}: "
              f"{nbytes / 1e9:.4f} GB, {nops / 1e9:.4f} G ops), layout "
              f"floor {lay['floor_ms']:.4f} ms, {kind}")
        recs.append({"name": name, "route": "cuda",
                     "source": "bifrost_tpu_torch/csrc/romein.cu",
                     "replaces": src, "launches": None,
                     "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": by,
                     "library_ms": library_ms,
                     "library_call": "torch.sparse.mm (CSR cells x vis, "
                                     "complex64) @ (vis, planes), cuSPARSE "
                                     "SpMM",
                     "plan_host_s": plan_s, "plan_device_s": dplan_s,
                     "ms_device_origin": dms,
                     "plan_rebuilds_s": None if seq is None else
                     {"sequences": RM_NSEQ, "host": seq[0],
                      "device": seq[1]}})
        del out, plan, dplan, uvw_d, kern_d
    del raw, data
    return recs


def time_xstages(dev, kind):
    """The X branch's other device stages at one integration's shapes:
    the X-engine CGEMM (4096 x (512 x 16) @ (16 x 512), TF32 off), the
    image_t transpose into the time-last layout (one complex64 every 16
    bytes), the (4096, 128, 128) FFT, and the image's D2H into a pageable
    host layout like the system ring's.  -> dict of ms."""
    from bifrost_tpu_torch.blocks.correlate import xengine
    nsp = NSTAND * NPOL
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    x = torch.randn(N_INT, BCHAN, nsp, dtype=torch.complex64, device=dev,
                    generator=gen)
    vis = torch.empty(BCHAN, nsp, nsp, dtype=torch.complex64, device=dev)
    t = {"xengine": cuda_time(lambda: xengine(x, out=vis), 3)}
    ring = torch.empty(BCHAN * nsp * nsp, 2, dtype=torch.complex64,
                       device=dev)
    dst = ring[:, 0].view(vis.shape)
    t["image_t"] = cuda_time(lambda: dst.copy_(vis), 3)
    del ring, dst, vis, x
    grid = torch.empty(BCHAN * NGRID * NGRID, 4, dtype=torch.complex64,
                       device=dev)
    g = grid[:, 0].view(BCHAN, NGRID, NGRID)
    g.copy_(torch.randn(g.shape, dtype=torch.complex64, device=dev,
                        generator=gen))
    t["fft"] = cuda_time(lambda: torch.fft.fftn(g, dim=(1, 2)), 3)
    host = torch.empty(BCHAN * NGRID * NGRID, 4, dtype=torch.complex64)
    h = host[:, 0].view(g.shape)
    h.copy_(g)
    t0 = time.perf_counter()
    for _ in range(2):
        h.copy_(g)
    t["image_d2h"] = (time.perf_counter() - t0) / 2 * 1e3
    del grid, g, host, h
    nbytes = 8 * BCHAN * nsp * nsp
    xbound = bound(N_INT * BCHAN * nsp * 8 + nbytes,
                   8 * N_INT * BCHAN * nsp * nsp, hbm_rate(kind))[0]
    phase("kernels", f"X branch stages per integration: X-engine CGEMM "
          f"{t['xengine']:.4f} ms (torch.matmul, TF32 off; bound "
          f"{xbound:.4f} ms), "
          f"image_t transpose {t['image_t']:.4f} ms ({nbytes / 1e9:.3f} GB "
          f"each way), FFT {t['fft']:.4f} ms, image D2H (512 MiB to "
          f"pageable host memory, synchronous) {t['image_d2h']:.2f} ms on "
          f"the host clock, {kind}")
    return t


def instrument(dev, volt, gather=None, on_image=None, method=None,
               kernels=None, fuse=False, engine="f32", uvw=None):
    """`lwa_instrument_pipeline` at the flagship width over `volt`, with
    every kernel method pinned to `method`; unfused unless `fuse`."""
    from bifrost_tpu_torch.service import lwa_instrument_pipeline
    return lwa_instrument_pipeline(
        volt, nstand=NSTAND, npol=NPOL, nchan=BCHAN, ntap=NTAP,
        n_int=N_INT, nbeam=NBEAM, max_delay=B_MAX_DELAY, ngrid=NGRID,
        f0_mhz=B_F0, dt_s=B_DT, gulp_nframe=B_GULP, kernels=kernels,
        uvw=uvw, device=dev, pfb_method=method,
        beamform_method=method, fdmt_method=method, romein_method=method,
        gather=gather, on_image=on_image, fuse=fuse, engine=engine)


class Images(list):
    """An on_image callback: keeps host copies of the first `keep`
    images and stamps the host clock at every one."""

    def __init__(self, keep):
        super().__init__()
        self.keep, self.stamps = keep, []

    def __call__(self, grid):
        self.stamps.append(time.perf_counter())
        if len(self) < self.keep:
            self.append(grid[..., 0].clone(
                memory_format=torch.contiguous_format))


def images_equal(a, b, n):
    if len(a) < n or len(b) < n:
        raise AssertionError(f"kept {len(a)}/{len(b)} images, need {n}")
    for x, y in zip(a[:n], b[:n]):
        if x.shape != (BCHAN, NGRID, NGRID) or \
                not torch.isfinite(torch.view_as_real(x)).all() or \
                not bits_equal(torch.view_as_real(x), torch.view_as_real(y)):
            raise AssertionError("images: kernels != plain")


def instrument_path(dev, volt, bref, spec):
    """The whole instrument at full width (module docstring, phase 6).
    `bref`: [bengine]'s gathered outputs; `spec`: the first
    integration's f64 golden spectra.  -> launch counts of the main run
    and of the K6a run."""
    from bifrost_tpu_torch.service import default_uvw
    nsp = NSTAND * NPOL
    got = {"beams": [], "dedispersed": []}
    imgs = Images(X_PLAIN_NINT)
    pipe, det, ledger = instrument(dev, volt, got, imgs)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    blocks = {b.name: b for b in pipe.blocks}
    nfdmt = B_NINT - B_MAX_DELAY
    expect = expected(fir_mac=B_NINT, beamform_power=B_NINT,
                      fdmt_merge_step=nfdmt *
                      len(blocks["bdetect_fdmt"].fdmt._steps),
                      romein_grid_separable=B_NINT)
    if counts != expect:
        raise AssertionError(f"launches {counts}, expected {expect}")
    nvec = check_vectors(counts, "fir_mac")
    s = ledger.summary()
    if s["lost_frames"] or s["duplicated_frames"] or \
            s["committed_frames"] != nfdmt:
        raise AssertionError(f"frame ledger: {s}")
    for key in ("beams", "dedispersed"):
        a, b = got[key], bref[key]
        if len(a) != len(b) or not all(
                np.array_equal(x.view(np.uint32), y.view(np.uint32))
                for x, y in zip(a, b)):
            raise AssertionError(f"{key}: instrument != [bengine]")
    if len(imgs.stamps) != B_NINT:
        raise AssertionError(f"{len(imgs.stamps)} images, expected "
                             f"{B_NINT}")
    nframe = len(volt)
    st = imgs.stamps
    per_int = (st[-1] - st[0]) / (len(st) - 1)
    steady = B_GULP / per_int
    perf = {b.name: {k: round(v, 4) for k, v in b.perf_totals.items()}
            for b in pipe.blocks}
    d2h = blocks["image_d2h"].perf_totals["process"] / B_NINT
    rings = {r.name: round(r._buf.numel() * r._buf.element_size() / 2**30,
                           3)
             for r in pipe.rings if r._buf is not None and r._buf.is_cuda}
    phase("instrument", f"LWA instrument {NSTAND}x{NPOL} inputs x {BCHAN} "
          f"ch, {NBEAM} beams + imaging at ngrid {NGRID}, {nframe} frames "
          f"({B_NINT} integrations): {wall:.3f} s, {nframe / wall:.1f} "
          f"frames/s, {nframe * nsp / wall:.4g} station-pol samples/s "
          f"with start-up; first image after {st[0] - t0:.3f} s; steady "
          f"state {steady:.1f} frames/s ({per_int * 1e3:.1f} ms per "
          f"integration, first to last image); launches {counts} (K2: "
          f"{nvec} vector); "
          f"ledger {s}; candidates {len(det.candidates)}; peak device "
          f"memory {peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); "
          f"device rings GiB {json.dumps(rings)}; image D2H {d2h * 1e3:.1f} "
          f"ms per integration ({2**29 / d2h / 1e9:.2f} GB/s, host clock)")
    phase("instrument", f"host seconds by block and phase: "
          f"{json.dumps(perf)}")
    del pipe, det, ledger, blocks
    free_device()

    ref = Images(X_PLAIN_NINT)
    instrument(dev, volt[:X_PLAIN_NINT * B_GULP], on_image=ref,
               method="plain")[0].run()
    images_equal(imgs, ref, X_PLAIN_NINT)
    del ref
    free_device()

    # The first image on 8 channels against the f64 golden: s^H s of the
    # golden spectra, np.add.at gridding, np.fft.fft2.
    s8 = spec[:, X_GOLDEN_CHANS, :]                     # (t, 8, nsp)
    vis = np.einsum("tci,tcj->cij", np.conj(s8), s8).reshape(8, -1)
    uvw = default_uvw(NSTAND, NPOL, NGRID, M_KERN)
    grid = np.zeros((8, NGRID, NGRID), np.complex128)
    for j in range(M_KERN):
        for k in range(M_KERN):
            yy, xx = uvw[1] + j, uvw[0] + k
            ok = (yy >= 0) & (yy < NGRID) & (xx >= 0) & (xx < NGRID)
            np.add.at(grid, (slice(None), yy[ok], xx[ok]), vis[:, ok])
    golden = np.fft.fft2(grid, axes=(-2, -1))
    first = imgs[0][torch.from_numpy(X_GOLDEN_CHANS)].numpy()
    err = float(np.abs(first - golden).max() / np.abs(golden).max())
    if not err <= 1e-4:
        raise AssertionError(f"first image vs f64 golden: rel {err}")
    phase("instrument", f"beam powers and dedispersed frames bitwise equal "
          f"to [bengine]'s; the first {X_PLAIN_NINT} images ({BCHAN} x "
          f"{NGRID} x {NGRID}) bitwise equal: kernels vs every method "
          f"'plain'; the first image on channels {X_GOLDEN_CHANS.tolist()} "
          f"vs the f64 numpy golden: max rel err {err:.3e} (limit 1e-4)")

    # `uvw` as a card tensor: the gridder builds its plan on the card.
    from bifrost_tpu_torch import proclog
    mine = Images(X_PLAIN_NINT)
    pipe = instrument(dev, volt[:X_PLAIN_NINT * B_GULP], on_image=mine,
                      uvw=torch.from_numpy(uvw).to(dev))[0]
    reset_counts()
    pipe.run()
    torch.cuda.synchronize()
    dcounts = read_counts()
    grid = next(b for b in pipe.blocks if b.name == "image_grid")
    rep = grid.plan_report()
    row = proclog.load_by_pid(os.getpid()).get("image_grid", {}).get(
        "romein_plan", {})
    if rep["origin"] != "device" or row.get("origin") != "device" or \
            dcounts["romein_grid_separable"] != X_PLAIN_NINT:
        raise AssertionError(f"device-origin uvw run: report {rep}, "
                             f"proclog {row}, launches {dcounts}")
    images_equal(mine, imgs, X_PLAIN_NINT)
    phase("instrument", f"uvw as a card tensor ({X_PLAIN_NINT} "
          f"integrations): the gridder's plan built on the card (origin "
          f"{rep['origin']}, {row.get('plan_build_s')} s, proclog "
          f"image_grid/romein_plan {row}); images bitwise the host-origin "
          f"run's; launches {dcounts}")
    del pipe, grid, mine, imgs
    free_device()

    # K6a on a path: a non-rank-1 kernel, 2 integrations deep.
    kern = k6a_kernels(nsp * nsp)
    short = volt[:X_PLAIN_NINT * B_GULP]
    mine, ref = Images(X_PLAIN_NINT), Images(X_PLAIN_NINT)
    pipe = instrument(dev, short, on_image=mine, kernels=kern)[0]
    reset_counts()
    pipe.run()
    torch.cuda.synchronize()
    kcounts = read_counts()
    if kcounts["romein_grid_general"] != X_PLAIN_NINT or \
            kcounts["romein_grid_separable"] != 0 or \
            kcounts["dq_masked_fill"] or kcounts["dq_gain_apply"] or \
            kcounts["flag_walk"] or kcounts["flag_stats"] or \
            kcounts["flag_cross"]:
        raise AssertionError(f"non-rank-1 run launches {kcounts}")
    del pipe
    free_device()
    instrument(dev, short, on_image=ref, method="plain",
               kernels=kern)[0].run()
    images_equal(mine, ref, X_PLAIN_NINT)
    phase("instrument", f"non-rank-1 kernel run ({X_PLAIN_NINT} "
          f"integrations): launches {kcounts}; images bitwise equal: "
          f"kernels vs every method 'plain'")
    return counts, kcounts


def frb_data():
    """The FRB search's seeded u8 noise with one dispersed burst."""
    from bifrost_tpu_torch.blocks.testing import inject_burst
    rng = np.random.default_rng(SEED)
    data = rng.integers(0, 32, (GULP * NGULP, NCHAN)).astype(np.uint8)
    inject_burst(data, T0, DM_ROW, F0, DF, amp=60)
    return data


def check_burst(det):
    """The strongest candidate must be the injected burst: the injected
    curve rounds each channel's delay on its own, the FDMT splits delays
    band by band, so the peak lands within two rows, and within two
    frames of output frame T0 - MAX_DELAY (output frame k holds input
    frame k + MAX_DELAY)."""
    if not det.candidates:
        raise AssertionError("no candidate: the injected burst was missed")
    best = max(det.candidates, key=lambda c: c["snr"])
    if abs(best["dm_index"] - DM_ROW) > 2 or \
            abs(best["frame"] - (T0 - MAX_DELAY)) > 2:
        raise AssertionError(f"burst at dm row {DM_ROW}, frame "
                             f"{T0 - MAX_DELAY}; found {best}")
    return best


def main_path(dev):
    from bifrost_tpu_torch.service import frb_search_pipeline
    data = frb_data()

    pipe, det, ledger = frb_search_pipeline(data, GULP, MAX_DELAY, F0, DF,
                                            DT, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = read_counts()
    wall = t1 - t0
    # Steady state: the frames the sink committed after its first gulp,
    # over the time from that gulp's arrival to the end (start-up, the
    # first gulp's allocations and the FDMT plan, left out).
    steady = (ledger.committed_frames - ledger.first_sink_nframe) / \
        (t1 - ledger.first_sink_t)
    launches = counts["fdmt_merge_step"]

    spaces = {r.name: r.space for r in pipe.rings}
    if spaces["h2d.out0"] != "cuda" or spaces["transpose.out0"] != "cuda":
        raise AssertionError(f"device rings not in the cuda space: {spaces}")
    nsteps = len(det.iring.owner.fdmt._steps)    # 12 at full width
    if counts != expected(fdmt_merge_step=nsteps * NGULP):
        raise AssertionError(f"launches {counts}, expected "
                             f"{nsteps * NGULP} of fdmt_merge_step alone")
    s = ledger.summary()
    nout = GULP * NGULP - MAX_DELAY
    if s["lost_frames"] or s["duplicated_frames"] or \
            s["committed_frames"] != nout:
        raise AssertionError(f"frame ledger: {s}")
    best = check_burst(det)
    nframe = GULP * NGULP
    phase("main", f"FRB chain {NCHAN} ch x {nframe} frames: {wall:.3f} s, "
          f"{nframe / wall:.1f} frames/s, {nframe * NCHAN / wall:.4g} "
          f"samples/s with start-up; steady state {steady:.1f} frames/s, "
          f"{steady * NCHAN:.4g} samples/s (from the first committed "
          f"gulp); launches {launches}; ledger {s}; candidate {best}")
    # Host seconds per block and loop phase (device work is asynchronous:
    # 'process' is its enqueue, and a wait shows up where a block syncs).
    perf = {b.name: {k: round(v, 4) for k, v in b.perf_totals.items()}
            for b in pipe.blocks}
    phase("main", f"host seconds by block and phase: {json.dumps(perf)}")

    gathered = {}
    for method in ("cuda", "plain"):
        chunks = []
        pipe2, _, _ = frb_search_pipeline(data, GULP, MAX_DELAY, F0, DF, DT,
                                          device=dev, fdmt_method=method,
                                          gather=chunks)
        pipe2.run()
        gathered[method] = chunks
    a, b = gathered["cuda"], gathered["plain"]
    if len(a) != NGULP or len(b) != NGULP:
        raise AssertionError(f"gathered {len(a)}/{len(b)} gulps")
    for x, y in zip(a, b):
        if x.shape != y.shape or x.shape[0] != MAX_DELAY or \
                not np.isfinite(x).all() or \
                not np.array_equal(x.view(np.uint32), y.view(np.uint32)):
            raise AssertionError("dedispersed gulps: cuda != plain")
    # Independent of the card's arithmetic: the first gulp recomputed on
    # the CPU by the plain version.
    from bifrost_tpu_torch.ops import Fdmt
    host = Fdmt().init(NCHAN, MAX_DELAY, F0, DF).execute(
        torch.from_numpy(np.ascontiguousarray(data[:GULP + MAX_DELAY].T)))
    if not np.array_equal(a[0].view(np.uint32),
                          host[:, MAX_DELAY:].numpy().view(np.uint32)):
        raise AssertionError("first dedispersed gulp differs from the CPU")
    phase("main", f"dedispersed gulps ({sum(x.shape[1] for x in a)} "
          f"frames x {MAX_DELAY} rows) bitwise equal: fdmt cuda vs plain; "
          f"the first gulp also equals the CPU's")
    SOLO["frb"] = dict(steady=steady, gathered=a,
                       cands=list(det.candidates), counts=counts)
    return counts


def ob_tools(pid):
    """Start the five tools (OB_TOOLS) against process `pid`, all at
    once, each through ``python -m`` from this checkout -> their
    processes."""
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=root)
    return [(args, subprocess.Popen(
        [sys.executable, "-m", f"bifrost_tpu_torch.tools.{args[0]}",
         *args[1:], str(pid)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=root, env=env))
        for args in OB_TOOLS]


def ob_check_tools(outs, pipe):
    """The tools' outputs against the live pipeline they read: every
    ring in like_top's ring rows, h2d.out0 and transpose.out0 in the
    'cuda' space in like_pmap and pipeline2dot's ring nodes, like_bmon's
    rates above 0, like_ps's roles, every block edge in pipeline2dot.
    -> a summary dict."""
    pid = os.getpid()
    top, ps, pmap, bmon, dot, dot_rings = outs
    # The tools name a ring by its log name, unique among live rings.
    log = {r.name: r.log_name for r in pipe.rings}
    rings = set(log.values())
    top_rings = {ln.split("name=")[1] for ln in top.splitlines()
                 if ln.startswith("ring ")}
    if not rings <= top_rings:
        raise AssertionError(f"like_top ring rows {sorted(top_rings)}, "
                             f"pipeline rings {sorted(rings)}")
    spaces = {}
    for ln in pmap.splitlines():
        f = ln.split()
        if len(f) > 2 and f[0] in rings:
            spaces[f[0]] = f[1]
    if not rings <= spaces.keys() or spaces[log["h2d.out0"]] != "cuda" or \
            spaces[log["transpose.out0"]] != "cuda":
        raise AssertionError(f"like_pmap spaces {spaces}")
    rates = {}
    for ln in bmon.splitlines():
        if ln.startswith("rate ") and f"({pid}," in ln:
            rates[ln.split("'")[1]] = float(ln.rsplit(None, 1)[1])
    if not rates or max(rates.values()) <= 0:
        raise AssertionError(f"like_bmon rates {rates}:\n{bmon}")
    if str(pid) not in ps or "source" not in ps or "sink" not in ps:
        raise AssertionError(f"like_ps:\n{ps}")
    edges = set()
    for b in pipe.blocks:
        for r in b.irings:
            src = getattr(r, "base_ring", r).owner.name
            edges.add(f'"{pid}.{src}" -> "{pid}.{b.name}"')
    missing = [e for e in edges if e not in dot]
    if missing:
        raise AssertionError(f"pipeline2dot lacks {missing}:\n{dot}")
    for name in (log["h2d.out0"], log["transpose.out0"]):
        node = next((ln for ln in dot_rings.splitlines()
                     if f"ring.{name}\" [label=" in ln), "")
        if " cuda" not in node:
            raise AssertionError(f"pipeline2dot --rings: {name}: {node!r}")
    return {"rings": sorted(rings), "spaces": spaces,
            "bmon_MB_s": rates, "edges": len(edges)}


def ob_idle(path, ngulp):
    """The card's idle share over the traced run's steady window, from
    its first K1 launch to its last (xe_trace_summary's method: the
    union of kernels, copies and sets) -> (K1 events, idle share, busy
    ms a gulp, device ms a gulp by kind, the 8 device ops that take the
    most time a gulp as [(name cut to 60 characters, ms)])."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    dev_ev = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    k1 = sorted(e["ts"] for e in dev_ev
                if "fdmt_merge_step_kernel" in e.get("name", ""))
    if len(k1) < 2:
        return len(k1), None, None, {}, []
    lo, hi = k1[0], k1[-1]
    busy, end, kinds, names = 0.0, lo, {}, {}
    for e in dev_ev:
        name = e.get("name", "")
        if e["cat"] == "kernel":
            k = "K1" if "fdmt_merge_step_kernel" in name else \
                "other kernels"
        elif e["cat"] == "gpu_memset":
            k = "memset"
        else:
            k = next((d for d in ("HtoD", "DtoH", "DtoD") if d in name),
                     "memcpy")
        clip = max(0.0, min(e["ts"] + e["dur"], hi) - max(e["ts"], lo))
        kinds[k] = kinds.get(k, 0.0) + clip / 1e3 / (ngulp - 1)
        names[name[:60]] = names.get(name[:60], 0.0) + \
            clip / 1e3 / (ngulp - 1)
    for a, b in sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                       for e in dev_ev):
        if b > max(a, end):
            busy += b - max(a, end)
            end = b
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return (len(k1), 1 - busy / (hi - lo), busy / 1e3 / (ngulp - 1),
            {k: round(v, 4) for k, v in kinds.items()},
            [(n, round(v, 4)) for n, v in top])


def ob_run(dev, data, zero_copy=True, hold=0.0, on_start=None):
    """One FRB search as [main] runs it (`zero_copy` set on its source
    block), its
    detect sink held `hold` s a gulp; `on_start(pipe)` runs in this
    thread once the sink has its first gulp, while the pipeline runs on
    a thread of its own.  -> dict of the gathered dedispersed gulps,
    launches, wall and steady frames/s, the spans the source published,
    the source's and H2D's host seconds by phase, on_start's result."""
    import threading

    from bifrost_tpu_torch.service import frb_search_pipeline
    chunks = []
    pipe, det, ledger = frb_search_pipeline(data, GULP, MAX_DELAY, F0, DF,
                                            DT, device=dev, gather=chunks)
    src = next(r for r in pipe.rings
               if type(r.owner).__name__ == "ArraySourceBlock")
    src.owner.zero_copy = zero_copy
    if hold:
        on_data = det.on_data

        def held(ispan):
            time.sleep(hold)
            return on_data(ispan)
        det.on_data = held
    reset_counts()
    t0 = time.perf_counter()
    err, got = [], None
    if on_start is None:
        pipe.run()
    else:
        def drive():
            try:
                pipe.run()
            except BaseException as e:  # noqa: BLE001 — raised below
                err.append(e)
        th = threading.Thread(target=drive)
        th.start()
        try:
            while ledger.first_sink_t is None and th.is_alive():
                time.sleep(0.01)
            got = on_start(pipe)
        finally:
            th.join()
        if err:
            raise err[0]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = read_counts()
    nframe = GULP * NGULP
    perf = {b.name: {k: round(v, 4) for k, v in b.perf_totals.items()}
            for b in pipe.blocks if b is src.owner or b.name == "h2d"}
    if ledger.committed_frames != nframe - MAX_DELAY:
        raise AssertionError(f"frame ledger: {ledger.summary()}")
    return {"chunks": chunks, "counts": counts, "wall": t1 - t0,
            "frames_s": nframe / (t1 - t0),
            "steady": (ledger.committed_frames - ledger.first_sink_nframe)
            / (t1 - ledger.first_sink_t),
            "published": src.published_spans, "perf": perf,
            "nsteps": len(det.iring.owner.fdmt._steps), "got": got,
            "pipe": pipe}


def ob_same(run, ref, what):
    if len(run["chunks"]) != len(ref) or not all(
            a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                  b.view(np.uint32))
            for a, b in zip(run["chunks"], ref)):
        raise AssertionError(f"{what}: dedispersed gulps differ from "
                             f"[main]'s")


def observe_path(dev, ref):
    """[observe]: (a) the five tools against the live FRB search, its
    detect sink held OB_HOLD s a gulp; (b) the unpaced search traced
    (`trace` on, inside start_profile / stop_profile), the Chrome trace
    holding the trace_scope range and one fdmt_merge_step_kernel event a
    counted launch, the card's idle share over the steady window; (c)
    [main] zero-copy and copying in OB_TURNS turns.  `ref`: [main]'s
    dedispersed gulps, which every run equals bitwise.  -> launch counts
    by run."""
    from bifrost_tpu_torch import config, trace
    data = frb_data()
    counts = {}

    def tools(pipe):
        procs = ob_tools(os.getpid())
        outs = []
        for args, p in procs:
            out, err = p.communicate(timeout=OB_TOOL_TIMEOUT)
            if p.returncode != 0:
                raise AssertionError(f"{' '.join(args)}: exit "
                                     f"{p.returncode}: {err[-2000:]}")
            outs.append(out)
        return outs

    t0 = time.perf_counter()
    run = ob_run(dev, data, hold=OB_HOLD, on_start=tools)
    want = expected(fdmt_merge_step=run["nsteps"] * NGULP)
    if run["counts"] != want:
        raise AssertionError(f"(a) launches {run['counts']}, expected "
                             f"{want}")
    ob_same(run, ref, "(a)")
    summary = ob_check_tools(run["got"], run["pipe"])
    counts["observe_tools"] = run["counts"]
    phase("observe", f"(a) like_top, like_ps, like_pmap, like_bmon, "
          f"pipeline2dot (python -m, each a process) against the live "
          f"FRB search, detect held {OB_HOLD} s a gulp ({run['wall']:.1f} "
          f"s): rings {summary['rings']}; spaces {summary['spaces']}; "
          f"like_bmon MB/s {summary['bmon_MB_s']}; {summary['edges']} "
          f"block edges drawn; launches {run['counts']['fdmt_merge_step']}"
          f"; outputs bitwise [main]'s ({time.perf_counter() - t0:.1f} s)")
    del run
    free_device()

    t0 = time.perf_counter()
    shutil.rmtree(OB_TRACE_DIR, ignore_errors=True)
    config.set("trace", True)
    try:
        trace.start_profile(str(OB_TRACE_DIR), device=dev)
        try:
            with trace.trace_scope("observe.frb_search"):
                run = ob_run(dev, data)
        finally:
            path = trace.stop_profile()
    finally:
        config.reset("trace")
    names = {}
    for e in json.loads(Path(path).read_text())["traceEvents"]:
        n = e.get("name", "")
        if n == "observe.frb_search" or n.startswith("block:"):
            names[n] = names.get(n, 0) + 1
    nk1, idle, busy, kinds, _ = ob_idle(path, NGULP)
    launches = run["counts"]["fdmt_merge_step"]
    if run["counts"] != want or nk1 != launches:
        raise AssertionError(f"(b) fdmt_merge_step_kernel events {nk1}, "
                             f"launches {run['counts']}")
    if "observe.frb_search" not in names:
        raise AssertionError(f"(b) no trace_scope range in {path}: "
                             f"{sorted(names)}")
    ob_same(run, ref, "(b)")
    counts["observe_trace"] = run["counts"]
    phase("observe", f"(b) traced run ({Path(path).stat().st_size / 2**20:.1f}"
          f" MiB Chrome trace, {path}): ranges {names}; "
          f"fdmt_merge_step_kernel events {nk1} = launches {launches}; "
          f"steady {run['steady']:.1f} frames/s under the profiler; "
          f"outputs bitwise [main]'s ({time.perf_counter() - t0:.1f} s)")
    phase("observe", f"(b) the card over the steady window (first to last "
          f"K1 launch): idle share {idle:.4f}, busy {busy:.4f} ms a gulp; "
          f"device ms a gulp by kind {kinds} (the gather sink's D2H "
          f"included; a reading, not a check)")
    del run
    free_device()

    t0 = time.perf_counter()
    rows = []
    for turn in range(OB_TURNS):
        for zc in (True, False):
            run = ob_run(dev, data, zero_copy=zc)
            if run["counts"] != want:
                raise AssertionError(f"(c) launches {run['counts']}")
            if run["published"] != (NGULP if zc else 0):
                raise AssertionError(f"(c) zero_copy={zc}: "
                                     f"{run['published']} spans published")
            ob_same(run, ref, f"(c) zero_copy={zc}")
            counts[f"observe_zc{int(zc)}_t{turn}"] = run["counts"]
            rows.append({"turn": turn, "zero_copy": zc,
                         "steady_frames_s": round(run["steady"], 1),
                         "frames_s": round(run["frames_s"], 1),
                         "published": run["published"],
                         "host_s": run["perf"]})
            del run
            free_device()
    phase("observe", f"(c) [main] zero-copy and copying in {OB_TURNS} "
          f"turns, every run bitwise [main]'s, {NGULP} spans published "
          f"by each zero-copy run: {json.dumps(rows)} "
          f"({time.perf_counter() - t0:.1f} s)")
    return counts


def dq_work(ntime, ncell, elt_bytes, nrows=0, fill=False, gains=False):
    """Bytes and operations of one K5a or K5b call: the samples read
    once and written once at `elt_bytes` each; K5a's mask rows (1 byte a
    cell) and fill rows (4 bytes) or K5b's complex64 gains read once;
    a select per sample for K5a, 6 operations per sample for K5b."""
    nbytes = 2 * ntime * ncell * elt_bytes
    if gains:
        return nbytes + 8 * ncell, 6 * ntime * ncell
    return nbytes + nrows * ncell * (5 if fill else 1), ntime * ncell


# K5a's edge shapes: (complex, baseline fill, ntime, window, ncell, x
# layout, out layout, vector kernel): window 1, a window longer than the
# gulp, tail windows, windows longer than a thread's 16-frame group; the
# vector kernel on contiguous and padded spans with cell counts that are
# not a multiple of its width; the scalar kernel on a strided span, on a
# base off 16-byte alignment and on a row stride off it.
K5A_EDGES = ((False, True, 37, 8, 300, "contig", "contig", True),
             (False, True, 64, 16, 301, "padded", "padded", True),
             (False, False, 37, 8, 301, "contig", "contig", False),
             (True, False, 37, 8, 301, "padded", "padded", True),
             (True, False, 16, 1, 300, "contig", "contig", True),
             (False, True, 10, 64, 300, "contig", "contig", True),
             (False, True, 100, 40, 302, "padded", "padded", True),
             (False, False, 37, 8, 300, "offset", "offset", False),
             (True, False, 40, 16, 300, "contig", "offset", False),
             (False, True, 37, 8, 300, "contig", "strided", False))


def span(rows, cols, dtype, layout, dev):
    """A (rows, cols) tensor in `layout`: 'contig'; 'strided' (every
    third cell of a wider buffer); 'offset' (a buffer's cells from the
    second on); 'padded' (the first cols cells of rows padded to a
    16-byte stride)."""
    if layout == "strided":
        return torch.empty(rows, 3 * cols, dtype=dtype, device=dev)[:, ::3]
    if layout == "offset":
        return torch.empty(rows, cols + 1, dtype=dtype, device=dev)[:, 1:]
    if layout == "padded":
        per = 16 // torch.empty((), dtype=dtype).element_size()
        return torch.empty(rows, -(-cols // per) * per, dtype=dtype,
                           device=dev)[:, :cols]
    return torch.empty(rows, cols, dtype=dtype, device=dev)


def check_fill_edges(dev, gen):
    """K5a bitwise against its plain version on K5A_EDGES, each launch's
    kernel (vector or scalar) as the layout says."""
    from bifrost_tpu_torch.ops import dq_kernel as dk
    for cplx, baseline, ntime, window, ncell, xl, ol, vec in K5A_EDGES:
        dtype = torch.complex64 if cplx else torch.float32
        nrows = -(-ntime // window)
        x = span(ntime, ncell, dtype, xl, dev)
        x.copy_(torch.randn(ntime, ncell, dtype=dtype, device=dev,
                            generator=gen))
        x[::3, ::5] = -0.0
        mask = torch.rand(nrows, ncell, device=dev, generator=gen) < 0.3
        fill = torch.randn(nrows, ncell, device=dev, generator=gen) \
            if baseline else None
        out = span(ntime, ncell, dtype, ol, dev)
        nvec = dk.masked_fill.vector_launches
        dk.masked_fill(x, mask, fill, window, out=out)
        want = dk.masked_fill_plain(x, mask, fill, window)
        torch.cuda.synchronize()
        a, b = (torch.view_as_real(t) if cplx else t
                for t in (out.contiguous(), want))
        if dk.masked_fill.vector_launches - nvec != vec or \
                not bits_equal(a, b):
            case = (cplx, baseline, ntime, window, ncell, xl, ol)
            raise AssertionError(f"masked_fill at {case}: vector "
                                 f"{dk.masked_fill.vector_launches - nvec}"
                                 f", bitwise {bits_equal(a, b)}")
    return len(K5A_EDGES)


def check_dq(dev, kind):
    """K5a and K5b at the data-quality paths' shapes: K5a on [frbflag]'s
    (4096 frames x 4096 channels) f32 gulp with 256 windows of 16, and
    on [dq]'s (16 x 2,097,152) complex64 gulp with one window; K5b on
    the same complex gulp.  Each against its plain version bitwise, timed
    beside the bound and one PyTorch call for the same function
    (`torch.where` over the window-broadcast mask; complex `x * g`).
    -> the two kernel records, their primary numbers at [dq]'s shape."""
    from bifrost_tpu_torch.ops import dq_kernel as dk
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    rate = hbm_rate(kind)
    ncell = BCHAN * NSTAND * NPOL
    frb = torch.randn(GULP, NCHAN, device=dev, generator=gen)
    frb[::7, ::3] = -0.0
    cases = {
        "frb": (frb, torch.rand(GULP // FRB_FLAG["window"], NCHAN,
                                device=dev, generator=gen) < 0.05,
                FRB_FLAG["window"]),
        "dq": (torch.randn(N_INT, ncell, dtype=torch.complex64, device=dev,
                           generator=gen),
               torch.rand(1, ncell, device=dev, generator=gen) < 0.05,
               DQ_WINDOW)}
    fill = {}
    for name, (x, mask, window) in cases.items():
        out = torch.empty_like(x)
        nvec = dk.masked_fill.vector_launches
        dk.masked_fill(x, mask, None, window, out=out)
        want = dk.masked_fill_plain(x, mask, None, window)
        torch.cuda.synchronize()
        a, b = (torch.view_as_real(t) if t.is_complex() else t
                for t in (out, want))
        if not bits_equal(a, b):
            raise AssertionError(f"masked_fill differs from plain ({name})")
        if dk.masked_fill.vector_launches != nvec + 1:
            raise AssertionError(f"masked_fill took its scalar kernel "
                                 f"({name})")
        ntime, nc = x.shape
        nrows = mask.shape[0]
        xw = x.view(nrows, window, nc)
        mw = mask.view(nrows, 1, nc)
        zero = torch.zeros((), dtype=x.dtype, device=dev)
        lib = torch.where(mw, zero, xw).view(x.shape)
        if not torch.equal(lib, out):
            raise AssertionError(f"torch.where differs from K5a ({name})")
        nbytes, nops = dq_work(ntime, nc, x.element_size(), nrows)
        fill[name] = {
            "ms": cuda_time(lambda: dk.masked_fill(x, mask, None, window,
                                                   out=out), 20),
            "plain_ms": cuda_time(
                lambda: dk.masked_fill_plain(x, mask, None, window), 5),
            "library_ms": cuda_time(lambda: torch.where(mw, zero, xw), 20),
            "bound_ms": bound(nbytes, nops, rate)[0],
            "bound_by": bound(nbytes, nops, rate)[1],
            "max_abs_err": float((a - b).abs().max()), "gb": nbytes / 1e9}
        del out, want, lib
    x = cases["dq"][0]
    g = torch.randn(ncell, dtype=torch.complex64, device=dev, generator=gen)
    out = torch.empty_like(x)
    dk.gain_apply(x, g, out=out)
    want = dk.gain_apply_plain(x, g)
    torch.cuda.synchronize()
    if not bits_equal(torch.view_as_real(out), torch.view_as_real(want)):
        raise AssertionError("gain_apply differs from plain")
    lib = x * g
    lib_err = float((lib - out).abs().max() / out.abs().max())
    if not lib_err <= 1e-6:
        raise AssertionError(f"x * g differs from K5b: rel {lib_err}")
    nbytes, nops = dq_work(N_INT, ncell, 8, gains=True)
    gain = {"ms": cuda_time(lambda: dk.gain_apply(x, g, out=out), 20),
            "plain_ms": cuda_time(lambda: dk.gain_apply_plain(x, g), 5),
            "library_ms": cuda_time(lambda: x * g, 20),
            "bound_ms": bound(nbytes, nops, rate)[0],
            "bound_by": bound(nbytes, nops, rate)[1],
            "max_abs_err": float((out - want).abs().max()),
            "gb": nbytes / 1e9}
    del out, want, lib, cases, x, g, frb
    nedge = check_fill_edges(dev, gen)
    for name, t in fill.items():
        phase("kernels", f"dq_masked_fill (K5a) equal to plain (tolerance: "
              f"bitwise) at [{'frbflag' if name == 'frb' else 'dq'}]'s "
              f"gulp (vector kernel) and on {nedge} edge shapes; "
              f"{t['ms']:.4f} ms per gulp (1 launch), plain "
              f"{t['plain_ms']:.4f} ms, torch.where {t['library_ms']:.4f} "
              f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
              f"{t['gb']:.4f} GB), {kind}")
    phase("kernels", f"dq_gain_apply (K5b) equal to plain (tolerance: "
          f"bitwise) at ({N_INT}, {ncell}) complex64; {gain['ms']:.4f} ms "
          f"per gulp (1 launch), plain {gain['plain_ms']:.4f} ms, complex "
          f"x * g {gain['library_ms']:.4f} ms (rel err {lib_err:.2e}), "
          f"bound {gain['bound_ms']:.4f} ms ({gain['bound_by']}: "
          f"{gain['gb']:.4f} GB), {kind}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rec_fill = {"name": "dq_masked_fill", "route": "cuda",
                "source": "bifrost_tpu_torch/csrc/dq.cu",
                "replaces": "bifrost_tpu/ops/dq_pallas.py:45",
                "launches": None, **{k: fill["dq"][k] for k in keys},
                "library_call": "torch.where(mask, 0, x) with the window "
                                "mask broadcast",
                "at_frbflag": {k: fill["frb"][k] for k in keys}}
    rec_gain = {"name": "dq_gain_apply", "route": "cuda",
                "source": "bifrost_tpu_torch/csrc/dq.cu",
                "replaces": "bifrost_tpu/ops/dq_pallas.py:78",
                "launches": None, **{k: gain[k] for k in keys},
                "library_call": "complex64 x * g (a timing yardstick: "
                                "another rounding)"}
    return [rec_fill, rec_gain]


# W1's edge shapes: (windows, cells, frames a window): [frbflag]'s 256
# windows of 4096 channels, [dq]'s one window of 2,097,152 cells, tail
# segments of 12 frames (an SK threshold that is not an f32 product) and
# of 5, the ring's chunks of 32 windows (9: one partial chunk; 33: a
# chunk and one window; 97: past the ring's three stages) with 16-byte row
# stores (4112 cells: a partial block of 16) and element stores
# (statistics and state read through element strides at 3, 9 and 97).
W1_EDGES = ((256, 4096, 16), (1, 2_097_152, 16), (1, 4096, 12),
            (3, 1000, 5), (9, 300, 16), (33, 4112, 16), (97, 1000, 5))
W1_PARAMS = (FRB_FLAG["thresh"], FRB_FLAG["mad_factor"], 0.25)
# W1s's edge shapes: (windows, frames a window, cells, strided):
# [frbflag]'s and [dq]'s, windows of 1 to 32 frames (its register form).
W1S_EDGES = ((256, 16, 4096, False), (1, 16, 2_097_152, False),
             (3, 2, 1000, True), (4, 5, 300, False), (2, 12, 777, True),
             (5, 17, 129, False), (3, 32, 64, True), (1, 1, 100, False))
# W1s's select form (windows above 32 frames): odd and even m, windows in
# shared memory (up to 6144 frames) and read from device memory in each
# pass (65,536), partial tiles of 8 cells, the SK tree's ragged chunks
# (4097) and levels (65,536: three), strided power; NaN and +-0 windows
# from `stats_power`.  [frbflag]'s gulp as one window is timed apart.
W1S_SELECT_EDGES = ((1, 33, 100, False), (2, 40, 77, True),
                    (3, 63, 50, False), (1, 64, 129, True),
                    (2, 75, 40, False), (1, 4096, 300, True),
                    (1, 4097, 64, False), (1, 65_536, 24, False))
# W1m's edge shapes: (windows, cells, strided, NaN rows): one and two
# cells, odd and even rows, rows with NaN MADs (one all NaN, one with
# every other cell NaN), the block-a-row form's limit (16,384) and the
# grid form above it; [frbflag]'s 256 x 4096 and [dq]'s 1 x 2,097,152
# are timed apart.
W1M_EDGES = ((3, 1, False, False), (3, 2, False, True), (4, 7, True, True),
             (5, 40, False, False), (2, 41, True, True),
             (3, 16_384, False, True), (2, 16_385, True, True))


def walk_case(algo, n, ncell, m, seed, dev, strided):
    """Statistics and state for W1's edge checks (the card tests'
    `_walk_case`): warm counts 0, 1, 5, WARM_CAP - 1 and WARM_CAP; -0.0
    centres and statistics, one NaN statistic in a few cells; in window
    0, cells tied exactly with each threshold in f32, as the plain walk
    computes it -> (stats, state) on `dev`, cells every other element of
    a wider buffer where `strided`."""
    from bifrost_tpu_torch.ops.flag_kernel import WARM_CAP
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p_thresh, p_mad = f32(W1_PARAMS[0]), f32(W1_PARAMS[1])
    sig, eps = f32(1.4826), f32(1e-6)
    k = np.arange(ncell)
    warm = rng.choice(np.array([0, 0, 1, 5, WARM_CAP - 1, WARM_CAP], f32),
                      ncell)
    c = rng.uniform(1, 4, ncell).astype(f32)
    s = rng.uniform(0.2, 1, ncell).astype(f32)
    c[k % 13 == 6] = -0.0
    z = rng.standard_normal((n, ncell)).astype(f32)
    u = rng.uniform(0.3, 6, (n, ncell)).astype(f32)
    stats = [c + f32(6) * z * s, s * u, rng.uniform(0.3, 1, n).astype(f32)] \
        if algo == "mad" else [f32(1) + f32(2) * z, c * u]
    for j, a in enumerate(stats[:2]):
        a[rng.random(a.shape) < 0.01] = -0.0
        nan = k % 31 == 7 + j
        a[rng.integers(0, n, ncell)[nan], nan] = np.nan
    warmed = warm > 0
    if algo == "mad":
        t0, t1, t2 = (k % 13 == 1) & warmed, (k % 13 == 2) & warmed, \
            (k % 13 == 3) & ~warmed
        c[t0] = 0.0
        stats[0][0, t0] = p_thresh * (sig * s[t0] + eps)
        stats[1][0, t1] = p_mad * (s[t1] + eps)
        stats[1][0, t2] = p_mad * (stats[2][0] + eps)
    else:
        thr = f32(float(p_thresh) * float(f32(np.sqrt(4.0 / max(m, 2)))))
        t1 = (k % 13 == 2) & warmed
        stats[0][0, k % 13 == 1] = f32(1) - thr
        c[t1] = 0.0
        stats[1][0, t1] = p_mad * (c[t1] + eps)

    def put(a):
        t = torch.from_numpy(a).to(dev)
        if not strided or a.ndim < 2:
            return t
        wide = torch.full(a.shape[:-1] + (2 * a.shape[-1],), float("nan"),
                          device=dev)
        wide[..., ::2] = t
        return wide[..., ::2]
    return [put(a) for a in stats], put(np.stack([c, s, warm]))


def stats_power(n, m, ncell, seed, strided, dev):
    """(n, m, ncell) f32 power for W1s's edge checks (the card tests'
    `_stats_power`): exponential noise; NaN samples of both signs, -0.0
    and +0.0 ties, infinities, small integers, all-equal and all-NaN
    cells; cells every other element of a wider buffer where
    `strided`."""
    rng = np.random.default_rng(seed)
    pw = rng.exponential(1.0, (n, m, ncell)).astype(np.float32)
    k = np.arange(ncell)
    special = np.concatenate([
        np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0], np.float32),
        np.array([0xFFC00000], np.uint32).view(np.float32)])
    sel = (rng.random(pw.shape) < 0.2) & (k % 7 == 1)
    pw[sel] = rng.choice(special, pw.shape)[sel]
    pw[:, :, k % 7 == 2] = rng.choice(np.array([0.0, -0.0], np.float32),
                                      (n, m, int((k % 7 == 2).sum())))
    pw[:, :, k % 7 == 3] = rng.integers(0, 3, (n, m, int((k % 7 == 3)
                                                        .sum())))
    pw[:, :, k % 7 == 4] = 2.5
    pw[:, :, k % 97 == 5] = np.nan
    t = torch.from_numpy(pw).to(dev)
    if not strided:
        return t
    wide = torch.full((n, m, 2 * ncell), float("nan"), device=dev)
    wide[..., ::2] = t
    return wide[..., ::2]


def walk_work(n, ncell):
    """Bytes and operations of one 'mad' W1 call: the median and MAD rows
    and the (n,) cross-cell median read once, the mask (1 byte) and fill
    (4) rows written, the (3, ncell) state read and written; about 20 f32
    operations a cell and window."""
    return n * ncell * 13 + 24 * ncell + 4 * n, 20 * n * ncell


def stats_work(n, m, ncell):
    """Bytes and operations of one 'mad' W1s call: the n x m x ncell f32
    samples read once, the median and MAD rows written.  The register
    form (m <= 32): a (window, cell) takes Batcher's odd-even merge sort
    of P = the next power of two of m keys (P/4 log2(P) (log2(P) - 1) +
    P - 1 compare-exchanges of two operations), a bitonic merge of P
    (P/2 log2(P)), and m deviations (two operations each).  The select
    form: eight passes over the m samples of some four operations each
    (the key or the deviation's key, its digit and prefix test)."""
    if m > 32:
        ops = 8 * 4 * m
    else:
        p = max(2, 1 << (m - 1).bit_length())
        lg = p.bit_length() - 1
        ops = 2 * (p * lg * (lg - 1) // 4 + p - 1 + p * lg // 2) + 2 * m
    return 4 * n * m * ncell + 8 * n * ncell, ops * n * ncell


def cross_work(n, ncell):
    """Bytes and operations of one W1m call: the (n, ncell) MAD rows read
    once, the (n,) medians written; four (a row a block) or three (a
    grid a row) passes of some four operations an element."""
    return 4 * n * ncell + 4 * n, 16 * n * ncell


def walk_equal(got, want):
    return torch.equal(got[0], want[0]) and bits_equal(got[1], want[1]) \
        and bits_equal(got[2], want[2])


# The latency a dependent instruction waits for its operand on Hopper's
# FP32, integer and predicate pipes (cycles), for W1's latency floor: an
# assumed figure, not measured on the card; the floor is only as good as
# it (`check_flag` prints the walk's measured time a window beside it).
CHAIN_LATENCY = 4
_NO_DEST = ("ST", "RED", "ATOM", "BAR", "BRA", "EXIT", "BSYNC", "BSSY",
            "WARPSYNC", "CALL", "RET", "NOP", "DEPBAR", "MEMBAR", "YIELD",
            "CCTL", "LDGDEPBAR", "LDGSTS", "ARRIVES")
_LOADS = ("LD", "S2R", "CS2R", "S2UR", "ULDC")
_REG = re.compile(r"(?<![\w.])(U?R\d+|U?P\d)(?!\w)")


def chain_depth(seg):
    """The longest dependent path through the SASS instructions `seg`
    (straight-line, in order), in cycles: each instruction CHAIN_LATENCY
    after the latest of its operands; loads start paths (their results
    do not depend on the carry), stores and branches end them."""
    depth = {}
    for ins in seg:
        m = re.match(r"(?:@!?(U?P\d|PT)\s+)?(\S+)\s*(.*)", ins)
        guard, op, rest = m.group(1), m.group(2), m.group(3)
        base = op.split(".")[0]
        args = [a.strip() for a in rest.split(",")] if rest else []
        if base.startswith(_NO_DEST):
            continue
        dests = []
        while args and len(dests) < 2 and re.fullmatch(r"U?P\d|PT", args[0]):
            dests.append(args.pop(0))
        if not dests and args and _REG.fullmatch(args[0]):
            dests.append(args.pop(0))
        srcs = _REG.findall(" ".join(args)) + \
            ([guard] + dests if guard else [])
        d = 0 if base.startswith(_LOADS) else \
            CHAIN_LATENCY + max([depth.get(r, 0) for r in srcs] or [0])
        for r in dests:
            if r != "PT":
                depth[r] = d
    return max(depth.values() or [0])


def walk_chain(part, lib=None):
    """W1's walker in the SASS (cuobjdump) of `lib` (the built flag
    library by default): of the basic blocks (runs of instructions with
    no branch and no branch target inside) of the kernel whose name holds
    `part`, the one with the most FSETPs -> {windows in it (its flag-byte
    loads), instructions a window, dependent cycles a window
    (`chain_depth`)}."""
    from bifrost_tpu_torch import build
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    lib = lib or build._target("flag")[2]
    text = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120).stdout
    for sec in text.split("Function : ")[1:]:
        if part not in sec.split("\n", 1)[0]:
            continue
        ins = [(int(a, 16), body.strip()) for a, body in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sec)]
        targets = {int(t, 16) for _, b in ins for t in re.findall(
            r"\b(?:BRA|BSSY)\s+(?:\S+\s*,\s*)?0x([0-9a-f]+)", b)}
        blocks, cur = [], []
        for addr, body in ins:
            if addr in targets and cur:
                blocks.append(cur)
                cur = []
            cur.append(body)
            if re.search(r"\b(BRA|BSSY|BSYNC|EXIT|BAR|WARPSYNC)\b", body):
                blocks.append(cur)
                cur = []
        blocks.append(cur)
        seg = max(blocks, key=lambda b: sum("FSETP" in x for x in b))
        nwin = sum(re.search(r"\bLDS\.U8\b", b) is not None for b in seg)
        if not nwin:
            break
        return {"windows": nwin, "instructions": len(seg) / nwin,
                "cycles": chain_depth(seg) / nwin}
    raise AssertionError(f"no walker block of {part} in the SASS")


def busy_clock(dev):
    """The SM clock (MHz) nvidia-smi reads while the card spins a sleep
    kernel, and the card's maximum."""
    torch.cuda._sleep(2_000_000_000)
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    torch.cuda.synchronize()
    return [float(v) for v in out.split("\n")[0].split(",")]


def cross_rows(n, ncell, strided, nans, seed, dev):
    """(n, ncell) f32 MAD rows for W1m's edge checks (the card tests'):
    exponential values at a level per cell, ties at 0 and 2; with `nans`
    every other cell of the first row NaN and the last row all NaN;
    cells every other element of a wider buffer where `strided`."""
    rng = np.random.default_rng(seed)
    mad = (rng.exponential(1.0, (n, ncell)) *
           rng.uniform(0.5, 4.0, ncell)).astype(np.float32)
    mad[:, ::9] = 0.0
    mad[:, 1::13] = 2.0
    if nans:
        mad[0, ::2] = np.nan
        mad[-1] = np.nan
    t = torch.from_numpy(mad).to(dev)
    if not strided:
        return t
    wide = torch.full((n, 2 * ncell), 7.0, device=dev)
    wide[:, ::2] = t
    return wide[:, ::2]


def nan_equal(a, b):
    """Bitwise where b is not NaN, NaN where it is."""
    nan = torch.isnan(b)
    return a.shape == b.shape and torch.equal(torch.isnan(a), nan) and \
        torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def cross_launches(ncell):
    """W1m's kernel launches for one window row of ncell cells."""
    from bifrost_tpu_torch.ops import flag_kernel as fk
    return 1 if fk.cross_form(ncell) == "row" else 3


def check_flag(dev, kind):
    """W1s, W1m and W1 against their plain versions: W1s bitwise on
    W1S_EDGES (its register form) and W1S_SELECT_EDGES (its select form,
    windows above 32 frames) for both algorithms, each launch's form
    counted; W1m against `stats.median` on W1M_EDGES (a NaN compared as
    a NaN); W1 bitwise on W1_EDGES for both algorithms (the caller's
    state left as it was).  Then at the flagger paths' shapes, the
    statistics of a seeded exponential power gulp of [frbflag] (4096
    frames x 4096 channels, 256 windows of 16) and of [dq] (16 x
    2,097,152 cells, one window), 'mad', W1m's cross-cell median of
    their MAD rows and W1's walk of them from the baseline a first walk
    leaves.  Each timed beside its plain version and its bytes bound; W1s
    beside the torch-sort pass it replaces (its library call, checked
    bitwise equal on these inputs) and W1s 'sk'; W1m beside the
    torch.sort-based `stats.median` it replaces (its library call, also
    its plain version); W1 beside its latency floor (`walk_chain` x
    windows / `busy_clock`, at an assumed CHAIN_LATENCY).  Then W1s's
    select form at the flag block's default of one window a gulp
    ([frbflag]'s 1 x 4096 x 4096) through `Flag._window_stats`, both
    algorithms, bitwise its plain version, timed beside the route it
    replaces (for 'mad' its plain version, the key sorts; for 'sk'
    `spectral_kurtosis`'s batched sums), and W1m on that window's MAD
    row.  -> the three records, their primary numbers at [frbflag]'s
    shape."""
    from bifrost_tpu_torch.ops import Flag
    from bifrost_tpu_torch.ops import flag_kernel as fk
    from bifrost_tpu_torch.ops.stats import median, spectral_kurtosis
    nstat = nsel = ncross = nedge = 0
    for algo in ("mad", "sk"):
        for n, m, ncell, strided in W1S_EDGES + W1S_SELECT_EDGES:
            if algo == "sk" and m < 2:
                continue
            pw = stats_power(n, m, ncell, SEED + m, strided, dev)
            sel = fk.stats_form(m) == "select"
            before = fk.flag_stats.launches, fk.flag_stats.select_launches
            got = fk.flag_stats(pw, algo)
            want = fk.flag_stats_plain(pw, algo)
            torch.cuda.synchronize()
            if (fk.flag_stats.launches, fk.flag_stats.select_launches) != \
                    (before[0] + 1, before[1] + sel) or not all(
                        bits_equal(a, b.contiguous())
                        for a, b in zip(got, want)):
                raise AssertionError(f"flag_stats differs from plain "
                                     f"('{algo}', {n} x {m} x {ncell})")
            nsel += sel
            nstat += not sel
        for n, ncell, m in W1_EDGES:
            stats, state = walk_case(algo, n, ncell, m, SEED + n, dev,
                                     strided=n in (3, 9, 97))
            keep = state.clone()
            before = fk.flag_walk.launches
            got = fk.flag_walk(stats, m, state, W1_PARAMS, algo)
            want = fk.flag_walk_plain(stats, m, state, W1_PARAMS, algo)
            torch.cuda.synchronize()
            if fk.flag_walk.launches != before + 1 or \
                    not walk_equal(got, want) or \
                    not bits_equal(state, keep) or not want[0].any():
                raise AssertionError(f"flag_walk differs from plain ('{algo}'"
                                     f", {n} x {ncell}, m {m})")
            nedge += 1
    for n, ncell, strided, nans in W1M_EDGES:
        mad = cross_rows(n, ncell, strided, nans, SEED + ncell, dev)
        before = fk.flag_cross.launches
        got = fk.flag_cross(mad)
        want = fk.flag_cross_plain(mad)
        torch.cuda.synchronize()
        if fk.flag_cross.launches != before + cross_launches(ncell) or \
                not nan_equal(got, want) or nans != bool(got.isnan().any()):
            raise AssertionError(f"flag_cross differs from plain ({n} x "
                                 f"{ncell})")
        ncross += 1
    del pw, got, want, stats, state, keep, mad
    rate = hbm_rate(kind)
    chain = walk_chain("flag_walk_ringILb1E")
    mhz, max_mhz = busy_clock(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    ts, tm, tw = {}, {}, {}
    for name, ntime, ncell, w in (
            ("frbflag", GULP, NCHAN, FRB_FLAG["window"]),
            ("dq", N_INT, BCHAN * NSTAND * NPOL, DQ_WINDOW)):
        plan = Flag(method="cuda").init(w, algo="mad")
        n = ntime // w
        pw = torch.empty(n, w, ncell, device=dev).exponential_(generator=gen)

        def torch_pass():
            m0 = median(pw, dim=1, keepdim=True)
            return m0[:, 0], median((pw - m0).abs(), dim=1, keepdim=False)
        st = fk.flag_stats(pw, "mad")
        want = fk.flag_stats_plain(pw, "mad")
        lib = torch_pass()
        torch.cuda.synchronize()
        if not all(bits_equal(a, b.contiguous()) and
                   bits_equal(a, c.contiguous())
                   for a, b, c in zip(st, want, lib)):
            raise AssertionError(f"flag_stats differs from plain or from the "
                                 f"torch pass ({name})")
        del want, lib
        nbytes, nops = stats_work(n, w, ncell)
        ts[name] = {
            "ms": graph_time(lambda: fk.flag_stats(pw, "mad"), 5, 20),
            "event_ms": cuda_time(lambda: fk.flag_stats(pw, "mad"), 20),
            "plain_ms": cuda_time(lambda: fk.flag_stats_plain(pw, "mad"), 3),
            "library_ms": cuda_time(torch_pass, 3),
            "sk_ms": graph_time(lambda: fk.flag_stats(pw, "sk"), 5, 20),
            "bound_ms": bound(nbytes, nops, rate)[0],
            "bound_by": bound(nbytes, nops, rate)[1],
            "max_abs_err": 0.0, "gb": nbytes / 1e9, "shape": (n, w, ncell)}
        del pw
        before = fk.flag_cross.launches
        cross = fk.flag_cross(st[1])
        want = fk.flag_cross_plain(st[1])
        torch.cuda.synchronize()
        if fk.flag_cross.launches != before + cross_launches(ncell) or \
                not bits_equal(cross, want):
            raise AssertionError(f"flag_cross differs from plain ({name})")
        nbytes, nops = cross_work(n, ncell)
        tm[name] = {
            "ms": graph_time(lambda: fk.flag_cross(st[1]), 5, 20),
            "event_ms": cuda_time(lambda: fk.flag_cross(st[1]), 20),
            "plain_ms": cuda_time(lambda: fk.flag_cross_plain(st[1]), 20),
            "library_ms": cuda_time(
                lambda: median(st[1], dim=1, keepdim=False), 20),
            "bound_ms": bound(nbytes, nops, rate)[0],
            "bound_by": bound(nbytes, nops, rate)[1],
            "max_abs_err": 0.0, "gb": nbytes / 1e9, "shape": (n, ncell),
            "form": fk.cross_form(ncell),
            "launches_a_call": cross_launches(ncell)}
        stats = (st[0], st[1], cross)
        del st, want
        state = fk.flag_walk(stats, w, plan.init_state(ncell, dev),
                             W1_PARAMS, "mad")[2]
        v0 = fk.flag_walk.vector_launches
        got = fk.flag_walk(stats, w, state, W1_PARAMS, "mad")
        want = fk.flag_walk_plain(stats, w, state, W1_PARAMS, "mad")
        torch.cuda.synchronize()
        if not walk_equal(got, want) or \
                fk.flag_walk.vector_launches != v0 + (n == 1):
            raise AssertionError(f"flag_walk differs from plain ({name})")
        nbytes, nops = walk_work(n, ncell)
        tw[name] = {
            "ms": graph_time(lambda: fk.flag_walk(stats, w, state, W1_PARAMS,
                                                  "mad"), 5, 20),
            "event_ms": cuda_time(lambda: fk.flag_walk(
                stats, w, state, W1_PARAMS, "mad"), 20),
            "plain_ms": cuda_time(lambda: fk.flag_walk_plain(
                stats, w, state, W1_PARAMS, "mad"), 3),
            "library_ms": None,
            "bound_ms": bound(nbytes, nops, rate)[0],
            "bound_by": bound(nbytes, nops, rate)[1],
            "latency_floor_ms": chain["cycles"] * n / (mhz * 1e3)
            if n > 1 else None,
            "form": fk.walk_form(stats, state),
            "max_abs_err": float((got[1] - want[1]).abs().max()),
            "gb": nbytes / 1e9, "shape": (n, ncell),
            "flagged": float(got[0].float().mean())}
        del stats, state, got, want, cross
        free_device()
    # W1s's select form at the flag block's default: one window a gulp.
    long = {"shape": (1, GULP, NCHAN)}
    pw = torch.empty(*long["shape"], device=dev).exponential_(generator=gen)
    nbytes, nops = stats_work(*long["shape"])
    for algo in ("mad", "sk"):
        plan = Flag(method="cuda").init(GULP, algo=algo)
        mad = algo == "mad"
        before = (fk.flag_stats.launches, fk.flag_stats.select_launches,
                  fk.flag_cross.launches)
        got = plan._window_stats(pw, kernel=True)
        want = fk.flag_stats_plain(pw, algo)
        torch.cuda.synchronize()
        if (fk.flag_stats.launches, fk.flag_stats.select_launches,
                fk.flag_cross.launches) != (before[0] + 1, before[1] + 1,
                                            before[2] + mad) or \
                not all(bits_equal(a, b) for a, b in zip(got, want)) or \
                (mad and not bits_equal(got[2], median(
                    want[1], dim=1, keepdim=False))):
            raise AssertionError(f"the select form differs from plain "
                                 f"('{algo}', {long['shape']})")
        if mad:
            def library():
                m0 = median(pw, dim=1, keepdim=True)
                return median((pw - m0).abs(), dim=1, keepdim=False)
        else:
            def library():
                return spectral_kurtosis(pw, dim=1), pw.sum(dim=1) / GULP
        long[algo] = {
            "ms": graph_time(lambda: fk.flag_stats(pw, algo), 5, 20),
            "event_ms": cuda_time(lambda: fk.flag_stats(pw, algo), 20),
            "plain_ms": cuda_time(lambda: fk.flag_stats_plain(pw, algo), 3),
            "library_ms": cuda_time(library, 3),
            # 'sk': three operations a sample
            "bound_ms": bound(nbytes, nops if mad else 3 * GULP * NCHAN,
                              rate)[0],
            "bound_by": bound(nbytes, nops if mad else 3 * GULP * NCHAN,
                              rate)[1]}
        if mad:
            row = got[1]
            nb, no = cross_work(1, NCHAN)
            long["cross"] = {
                "ms": graph_time(lambda: fk.flag_cross(row), 5, 20),
                "event_ms": cuda_time(lambda: fk.flag_cross(row), 20),
                "plain_ms": cuda_time(lambda: fk.flag_cross_plain(row), 20),
                "library_ms": cuda_time(
                    lambda: median(row, dim=1, keepdim=False), 20),
                "bound_ms": bound(nb, no, rate)[0],
                "bound_by": bound(nb, no, rate)[1], "shape": (1, NCHAN)}
            del row
        del got, want
    long["gb"] = nbytes / 1e9
    long["passes"] = {"mad": 8, "sk": 1}
    long["smem_frames"] = fk._constant("kSelSmemFrames")
    del pw
    free_device()
    for name in ts:
        r, x, q = ts[name], tm[name], tw[name]
        phase("kernels", f"flag_stats (W1s, register form) 'mad' equal to "
              f"plain and to the torch-sort pass (tolerance: bitwise) at "
              f"[{name}]'s {r['shape'][0]} x {r['shape'][1]} x "
              f"{r['shape'][2]}, and to plain on {nstat} register-form and "
              f"{nsel} select-form edge cases; {r['ms']:.4f} ms per gulp on "
              f"the card (1 launch, from a CUDA graph; {r['event_ms']:.4f} "
              f"launched from the host; 'sk' {r['sk_ms']:.4f}), plain "
              f"{r['plain_ms']:.4f} ms, the torch pass it replaces "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['gb']:.4f} GB), {kind}")
        phase("kernels", f"flag_cross (W1m, {x['form']} form, "
              f"{x['launches_a_call']} launch(es) a gulp) equal to "
              f"stats.median (tolerance: bitwise; a NaN as a NaN on the "
              f"edges) at [{name}]'s {x['shape'][0]} x {x['shape'][1]} MAD "
              f"rows and on {ncross} edge cases; {x['ms']:.4f} ms per gulp "
              f"on the card (from a CUDA graph; {x['event_ms']:.4f} "
              f"launched from the host), plain {x['plain_ms']:.4f} ms, the "
              f"torch.sort pass it replaces (stats.median) "
              f"{x['library_ms']:.4f} ms, bound {x['bound_ms']:.4f} ms "
              f"({x['bound_by']}: {x['gb']:.4f} GB), {kind}")
        floor = "" if q["latency_floor_ms"] is None else \
            f", latency floor {q['latency_floor_ms']:.4f} ms (assumed " \
            f"{CHAIN_LATENCY} cycles a dependent instruction; measured " \
            f"{q['ms'] / q['shape'][0] * 1e6:.1f} ns a window)"
        phase("kernels", f"flag_walk (W1, {q['form']} form) equal to plain "
              f"(tolerance: bitwise) at [{name}]'s {q['shape'][0]} x "
              f"{q['shape'][1]} (flagged {q['flagged']:.4f}) and on {nedge} "
              f"edge cases; {q['ms']:.4f} ms per gulp on the card (1 launch,"
              f" from a CUDA graph; {q['event_ms']:.4f} launched from the "
              f"host), plain "
              f"{q['plain_ms']:.4f} ms, bound {q['bound_ms']:.4f} ms "
              f"({q['bound_by']}: {q['gb']:.4f} GB){floor}, {kind}")
    phase("kernels", f"W1's walker (SASS of flag_walk_ring 'mad'): "
          f"{chain['windows']} windows a loop body, "
          f"{chain['instructions']:.1f} instructions and "
          f"{chain['cycles']:.1f} dependent cycles a window at "
          f"{CHAIN_LATENCY} a dependent instruction (assumed, not "
          f"measured); SM clock {mhz:.0f} MHz busy (max {max_mhz:.0f}) by "
          f"nvidia-smi")
    lm, ls, lc = long["mad"], long["sk"], long["cross"]
    phase("kernels", f"flag_stats (W1s, select form) at the flag block's "
          f"default of one window a gulp ({long['shape'][0]} x "
          f"{long['shape'][1]} x {long['shape'][2]}, Flag._window_stats, 1 "
          f"launch, equal to plain, tolerance: bitwise): 'mad' "
          f"{lm['ms']:.4f} ms per gulp (from a CUDA graph; "
          f"{lm['event_ms']:.4f} launched from the host; "
          f"{long['passes']['mad']} passes over the window, one read from "
          f"device memory: windows up to {long['smem_frames']} frames sit "
          f"in shared memory), plain (the key sorts, the \"torch\" route it "
          f"replaces) {lm['plain_ms']:.4f} ms, the torch-sort pass "
          f"{lm['library_ms']:.4f} ms; 'sk' {ls['ms']:.4f} ms "
          f"({ls['event_ms']:.4f} from the host; 1 pass), plain (the tree "
          f"sums) {ls['plain_ms']:.4f} ms, spectral_kurtosis's sums (the "
          f"route it replaces) {ls['library_ms']:.4f} ms; bound "
          f"{lm['bound_ms']:.4f} ms (bytes: {long['gb']:.4f} GB); W1m on "
          f"its 1 x {NCHAN} MAD row {lc['ms']:.4f} ms (from a CUDA graph; "
          f"{lc['event_ms']:.4f} from the host), plain {lc['plain_ms']:.4f}"
          f", stats.median {lc['library_ms']:.4f}, bound "
          f"{lc['bound_ms']:.6f} ms, {kind}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    rec_s = {"name": "flag_stats", "route": "cuda",
             "source": "bifrost_tpu_torch/csrc/flag.cu",
             "replaces": "bifrost_tpu/ops/flag.py:190",
             "launches": None, **{k: ts["frbflag"][k] for k in keys},
             "event_ms": ts["frbflag"]["event_ms"],
             "sk_ms": ts["frbflag"]["sk_ms"],
             "library_call": "the torch pass it replaces: stats.median "
                             "(torch.sort) of the window, then of |x - "
                             "med|",
             "at_dq": {k: ts["dq"][k] for k in keys + ("event_ms", "sk_ms")},
             "select_one_window_a_gulp": long}
    rec_m = {"name": "flag_cross", "route": "cuda",
             "source": "bifrost_tpu_torch/csrc/flag.cu",
             "replaces": "bifrost_tpu/ops/flag.py:198",
             "launches": None, **{k: tm["frbflag"][k] for k in keys},
             "event_ms": tm["frbflag"]["event_ms"],
             "form": tm["frbflag"]["form"],
             "library_call": "the torch.sort pass it replaces: stats.median "
                             "of the MAD rows (also its plain version)",
             "at_dq": {k: tm["dq"][k] for k in keys + (
                 "event_ms", "form", "launches_a_call")}}
    rec_w = {"name": "flag_walk", "route": "cuda",
             "source": "bifrost_tpu_torch/csrc/flag.cu",
             "replaces": "bifrost_tpu/ops/flag.py:269",
             "launches": None, **{k: tw["frbflag"][k] for k in keys},
             "event_ms": tw["frbflag"]["event_ms"],
             "latency_floor_ms": tw["frbflag"]["latency_floor_ms"],
             "chain": {**chain, "sm_mhz": mhz, "max_sm_mhz": max_mhz},
             "library_call": "none: no single PyTorch call computes a "
                             "recurrence over windows",
             "at_dq": {k: tw["dq"][k] for k in keys + ("event_ms",)}}
    return [rec_s, rec_m, rec_w]


def ff_steady(ledger, t1):
    """Steady frames/s of an FRB chain from its first committed gulp to
    the end of its run at host time t1."""
    return (ledger.committed_frames - ledger.first_sink_nframe) / \
        (t1 - ledger.first_sink_t)


def frbflag_path(dev):
    """The FRB search with the RFI flagger (module docstring, phase 7).
    -> the kernels' launch counts in the main run."""
    from bifrost_tpu_torch import config, trace
    from bifrost_tpu_torch.blocks.testing import narrowband_storm
    from bifrost_tpu_torch.service import frb_search_pipeline
    data = frb_data()
    frame0 = STORM_GULP0 * GULP
    chans, on = narrowband_storm(data, frame0=frame0, seed=SEED + 7,
                                 **STORM)
    masks = []
    chunks = []
    pipe, det, ledger = frb_search_pipeline(
        data, GULP, MAX_DELAY, F0, DF, DT, device=dev, gather=chunks,
        rfi_flag=dict(FRB_FLAG, on_mask=masks.append))
    reset_counts()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = read_counts()
    wall = t1 - t0
    steady = ff_steady(ledger, t1)
    blocks = {b.name: b for b in pipe.blocks}
    nsteps = len(blocks["fdmt"].fdmt._steps)
    # GULP is a multiple of the window: one W1s (the register form), one
    # W1m (a block a window row) and one W1 launch a gulp (the ring
    # form), as K5a.
    expect = expected(fdmt_merge_step=nsteps * NGULP, dq_masked_fill=NGULP,
                      flag_stats=NGULP, flag_cross=NGULP, flag_walk=NGULP)
    if counts != expect:
        raise AssertionError(f"launches {counts}, expected {expect}")
    nvec = check_vectors(counts)
    route = blocks["flag"].plan_report()["stats_route"]
    nvec_w1 = kernel_counters()["flag_walk"].vector_launches
    if route != ["registers"] or nvec_w1 or \
            kernel_counters()["flag_stats"].select_launches:
        raise AssertionError(f"W1s/W1: stats_route {route}, one-window "
                             f"launches {nvec_w1}")
    s = ledger.summary()
    if s["lost_frames"] or s["duplicated_frames"] or \
            s["committed_frames"] != GULP * NGULP - MAX_DELAY:
        raise AssertionError(f"frame ledger: {s}")
    best = check_burst(det)
    # Every storm cell on for more than half of a window's frames must be
    # flagged in that window, in every window after the onset.
    w = FRB_FLAG["window"]
    m = np.concatenate(masks)[frame0 // w:]              # (nwin, NCHAN)
    busy = on.reshape(-1, w, len(chans)).sum(axis=1) > w // 2
    missed = int((busy & ~m[:, chans]).sum())
    if missed or len(masks) != NGULP:
        raise AssertionError(f"{missed} busy storm windows not flagged")
    clean = np.ones(NCHAN, bool)
    clean[chans] = False
    allm = np.concatenate(masks)
    clean_share = float(allm[:, clean].mean())
    flag = blocks["flag"]
    nframe = GULP * NGULP
    phase("frbflag", f"flagged FRB chain {NCHAN} ch x {nframe} frames, "
          f"storm of {len(chans)} channels (p_on {STORM['p_on']}) from "
          f"gulp {STORM_GULP0}: {wall:.3f} s, {nframe / wall:.1f} frames/s "
          f"with start-up; steady state {steady:.1f} frames/s (from the "
          f"first committed gulp; W1's walk); launches {counts} (K5a: "
          f"{nvec} vector); ledger {s}; candidate {best}; busy storm "
          f"windows flagged "
          f"{int(busy.sum())}/{int(busy.sum())}; flagged fraction "
          f"{flag.flagged_fraction:.6f}; clean cells flagged "
          f"{clean_share:.6f}")
    perf = {b.name: {k: round(v, 4) for k, v in b.perf_totals.items()}
            for b in pipe.blocks}
    phase("frbflag", f"host seconds by block and phase: {json.dumps(perf)}")
    del pipe, det, blocks, flag
    rates = {"W1": steady}
    for tag, fdmt_method in (("flagger plain", None),
                             ("all plain", "plain")):
        ref = []
        config.set("dq_flag_method", "plain")
        try:
            pipe, _, led = frb_search_pipeline(
                data, GULP, MAX_DELAY, F0, DF, DT, device=dev, gather=ref,
                fdmt_method=fdmt_method, rfi_flag=FRB_FLAG)
            reset_counts()
            pipe.run()
            torch.cuda.synchronize()
            rates[tag] = ff_steady(led, time.perf_counter())
        finally:
            config.reset("dq_flag_method")
        if read_counts()["flag_walk"] or len(chunks) != NGULP or \
                len(ref) != NGULP:
            raise AssertionError(f"{tag}: gathered {len(chunks)}/{len(ref)} "
                                 f"gulps, launches {read_counts()}")
        for x, y in zip(chunks, ref):
            if x.shape != y.shape or not np.isfinite(x).all() or \
                    not np.array_equal(x.view(np.uint32), y.view(np.uint32)):
                raise AssertionError(f"flagged dedispersed gulps: kernels != "
                                     f"{tag}")
        del pipe, led, ref
        free_device()
    phase("frbflag", f"dedispersed gulps ({NGULP} x {MAX_DELAY} x {GULP}) "
          f"bitwise equal: W1, K5a and K1 vs dq_flag_method 'plain' (K1 on)"
          f" and vs dq_flag_method and fdmt_method 'plain'; steady frames/s "
          f"in this process, one after the other: "
          f"{json.dumps({k: round(v, 1) for k, v in rates.items()})}")

    # The chain with W1, traced: the card's idle share and its top ops.
    shutil.rmtree(FF_TRACE_DIR, ignore_errors=True)
    traced = []
    pipe, _, led = frb_search_pipeline(
        data, GULP, MAX_DELAY, F0, DF, DT, device=dev, gather=traced,
        rfi_flag=FRB_FLAG)
    reset_counts()
    trace.start_profile(str(FF_TRACE_DIR), device=dev)
    try:
        pipe.run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        path = trace.stop_profile()
    tcounts = read_counts()
    host = {b.name: {k: round(v, 4) for k, v in b.perf_totals.items()}
            for b in pipe.blocks}
    nk1, idle, busy, kinds, top = ob_idle(path, NGULP)
    if tcounts != expect or nk1 != tcounts["fdmt_merge_step"] or \
            not all(np.array_equal(x.view(np.uint32), y.view(np.uint32))
                    for x, y in zip(traced, chunks)):
        raise AssertionError(f"traced run: K1 events {nk1}, launches "
                             f"{tcounts}")
    phase("frbflag", f"traced run ({path}; outputs bitwise the first run's, "
          f"launches equal): steady {ff_steady(led, t1):.1f} frames/s under "
          f"the profiler; over the steady window (first to last K1 launch) "
          f"the card idle {idle:.4f}, busy {busy:.4f} ms a gulp; device ms a "
          f"gulp by kind {kinds}; top device ops, ms a gulp: "
          f"{json.dumps(top)}; host s by block and phase "
          f"{json.dumps(host)}")
    del pipe, led, traced
    free_device()
    return {"frbflag": counts,
            "frbflag_one_window": frbflag_one_window(dev, data, chans, on,
                                                     nsteps)}


def frbflag_one_window(dev, data, chans, on, nsteps):
    """The flagged FRB search at the flag block's default window
    (`rfi_flag=dict(algo='mad')`: one window a gulp of 4096 frames x
    4096 channels) on [frbflag]'s data and storm: W1s's select form, W1m
    (a block the window row), W1's one-window form (four cells a thread)
    and K5a once a gulp each; every storm channel on for more than half
    of a gulp flagged in that gulp; masks and dedispersed gulps bitwise
    the same chain with dq_flag_method 'plain'.  -> the launch counts."""
    from bifrost_tpu_torch import config
    from bifrost_tpu_torch.service import frb_search_pipeline
    runs = {}
    for method in ("cuda", "plain"):
        masks, chunks = [], []
        config.set("dq_flag_method", method)
        try:
            pipe, _, led = frb_search_pipeline(
                data, GULP, MAX_DELAY, F0, DF, DT, device=dev, gather=chunks,
                rfi_flag=dict(algo="mad", on_mask=masks.append))
            reset_counts()
            t0 = time.perf_counter()
            pipe.run()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        finally:
            config.reset("dq_flag_method")
        flag = {b.name: b for b in pipe.blocks}["flag"]
        runs[method] = dict(
            masks=masks, chunks=chunks, counts=read_counts(),
            select=kernel_counters()["flag_stats"].select_launches,
            vec=[kernel_counters()[name].vector_launches
                 for name in ("dq_masked_fill", "flag_walk")],
            route=flag.plan_report()["stats_route"], wall=t1 - t0,
            steady=ff_steady(led, t1), flagged=flag.flagged_fraction)
        del pipe, led, flag
        free_device()
    k, p = runs["cuda"], runs["plain"]
    counts = k["counts"]
    expect = expected(fdmt_merge_step=nsteps * NGULP, dq_masked_fill=NGULP,
                      flag_stats=NGULP, flag_cross=NGULP, flag_walk=NGULP)
    if counts != expect or k["select"] != NGULP or \
            k["route"] != ["select"] or p["counts"] != expected(
                fdmt_merge_step=nsteps * NGULP):
        raise AssertionError(f"one window a gulp: launches {counts} "
                             f"(select form {k['select']}), route "
                             f"{k['route']}; plain {p['counts']}")
    if k["vec"] != [NGULP, NGULP]:
        raise AssertionError(f"one window a gulp: K5a and W1 vector "
                             f"launches {k['vec']}")
    if len(k["masks"]) != NGULP or len(p["masks"]) != NGULP or \
            len(k["chunks"]) != NGULP or len(p["chunks"]) != NGULP:
        raise AssertionError("one window a gulp: gathered "
                             f"{len(k['masks'])}/{len(p['masks'])} masks, "
                             f"{len(k['chunks'])}/{len(p['chunks'])} gulps")
    for a, b in zip(k["masks"], p["masks"]):
        if a.shape != (1, NCHAN) or not np.array_equal(a, b):
            raise AssertionError("one window a gulp: masks != plain")
    for x, y in zip(k["chunks"], p["chunks"]):
        if x.shape != y.shape or not np.isfinite(x).all() or \
                not np.array_equal(x.view(np.uint32), y.view(np.uint32)):
            raise AssertionError("one window a gulp: dedispersed gulps != "
                                 "plain")
    m = np.concatenate(k["masks"])[STORM_GULP0:]
    busy = on.reshape(-1, GULP, len(chans)).sum(axis=1) > GULP // 2
    missed = int((busy & ~m[:, chans]).sum())
    if missed or not busy.any():
        raise AssertionError(f"one window a gulp: {missed} busy storm "
                             f"gulps not flagged")
    phase("frbflag", f"flagged FRB chain at the flag block's default window "
          f"(one window a gulp of {GULP} x {NCHAN}): launches {counts} "
          f"(W1s's select form {k['select']}, W1's one-window form four "
          f"cells a thread {k['vec'][1]}, K5a vector {k['vec'][0]}); "
          f"stats_route {k['route']}; busy storm gulps flagged "
          f"{int(busy.sum())}/{int(busy.sum())}; flagged fraction "
          f"{k['flagged']:.6f}; masks and dedispersed gulps ({NGULP} x "
          f"{MAX_DELAY} x {GULP}) bitwise equal to dq_flag_method 'plain'; "
          f"steady frames/s {k['steady']:.1f} (plain flagger "
          f"{p['steady']:.1f}); {k['wall']:.3f} s with start-up")
    return counts


def dq_chain(dev, volt, gains, method=None, gather=None, on_mask=None,
             fold=False, fuse=False):
    """The flagged, calibrated beam search built from blocks (module
    docstring, phase 8), every kernel method pinned to `method`.  With
    `fold`, the flagged stream instead feeds gaincal -> beamform and
    beamform(gains=) side by side, gathered into gather['cal'] and
    gather['fold'].  With `fuse`, the blocks from the H2D copy to the
    FDMT are built in one `block_scope(fuse=True)` (phase 11).  ->
    (pipeline, detector, ledger)."""
    import contextlib
    from bifrost_tpu_torch import blocks as bl
    from bifrost_tpu_torch.pipeline import Pipeline, block_scope
    from bifrost_tpu_torch.service import (CandidateDetectBlock,
                                           FrameLedger, default_beam_weights)
    w = default_beam_weights(NBEAM, NSTAND * NPOL)
    pipe = Pipeline(device=dev)
    ledger = FrameLedger()
    det = None
    with pipe, (block_scope(fuse=True) if fuse
                else contextlib.nullcontext()):
        src = bl.array_source(volt, B_GULP, header={
            "dtype": "ci8", "labels": ["time", "station", "pol"],
            "scales": [[0.0, B_DT], None, None], "units": ["s", None, None],
            "cfreq": B_F0, "cfreq_units": "MHz"}, name="ingest")
        h2d = bl.copy(src, space="cuda", name="fengine_h2d")
        f = bl.pfb(h2d, BCHAN, ntap=NTAP, method=method, name="fengine_pfb")
        fl = bl.rfi_flag(f, window=DQ_WINDOW, algo="mad", method=method,
                         on_mask=on_mask, name="dq_flag")
        cal = bl.gaincal(fl, gains, axis="station", method=method,
                         name="dq_cal")
        b = bl.beamform(cal, w, N_INT, method=method, name="bengine")
        if fold:
            bl.gather_sink(b, gather["cal"], name="gather_cal")
            bf = bl.beamform(fl, w, N_INT, gains=gains, method=method,
                             name="bengine_fold")
            bl.gather_sink(bf, gather["fold"], name="gather_fold")
            return pipe, det, ledger
        t = bl.transpose(b, ["beam", "freq", "time"], name="bdetect_t")
        d = bl.fdmt(t, max_delay=B_MAX_DELAY, method=method,
                    name="bdetect_fdmt")
        det = CandidateDetectBlock(d, threshold=8.0, name="bdetect")
        det.ledger = ledger
        if "beams" in gather:
            bl.gather_sink(b, gather["beams"], name="gather_beams")
        bl.gather_sink(d, gather["dedispersed"], name="gather_dedispersed")
    return pipe, det, ledger


class ToneMasks(object):
    """An on_mask callback: keeps the first window's whole mask and, for
    every window, whether all of the tone's cells were flagged."""

    def __init__(self):
        self.first, self.tone = None, []

    def __call__(self, m):
        if self.first is None:
            self.first = m[0].copy()
        self.tone.append(bool(m[:, DQ_CHAN, DQ_STATION].all()))


def dq_path(dev, volt, spec):
    """The flagged, calibrated beam search at full width (module
    docstring, phase 8).  `volt`: [bengine]'s voltages (changed in
    place: the tone is added); `spec`: the first integration's f64
    golden spectra.  -> the kernels' launch counts in the main run."""
    from bifrost_tpu_torch.blocks.testing import inject_tone
    from bifrost_tpu_torch.service import default_beam_weights
    nsp = NSTAND * NPOL
    inject_tone(volt, DQ_TONE_INT * B_GULP, DQ_STATION, DQ_CHAN, BCHAN,
                DQ_AMP)
    rng = np.random.default_rng(SEED + 8)
    gains = (0.5 + rng.random(NSTAND) +
             0.3j * rng.standard_normal(NSTAND)).astype(np.complex64)
    got = {"beams": Stamped(), "dedispersed": []}
    tm = ToneMasks()
    pipe, det, ledger = dq_chain(dev, volt, gains, gather=got, on_mask=tm)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    blocks = {b.name: b for b in pipe.blocks}
    nfdmt = B_NINT - B_MAX_DELAY
    # W1m: three launches a gulp (a grid over the 2,097,152 cells).
    expect = expected(fir_mac=B_NINT, beamform_power=B_NINT,
                      dq_masked_fill=B_NINT, dq_gain_apply=B_NINT,
                      flag_stats=B_NINT, flag_cross=3 * B_NINT,
                      flag_walk=B_NINT,
                      fdmt_merge_step=nfdmt *
                      len(blocks["bdetect_fdmt"].fdmt._steps))
    if counts != expect:
        raise AssertionError(f"launches {counts}, expected {expect}")
    nvec = check_vectors(counts)
    nvec_fir = check_vectors(counts, "fir_mac")
    # One window a gulp: W1's one-window form, four cells a thread.
    check_vectors(counts, "flag_walk")
    route = blocks["dq_flag"].plan_report()["stats_route"]
    if route != ["registers"]:
        raise AssertionError(f"W1s: stats_route {route}")
    s = ledger.summary()
    if s["lost_frames"] or s["duplicated_frames"] or \
            s["committed_frames"] != nfdmt:
        raise AssertionError(f"frame ledger: {s}")
    if len(tm.tone) != B_NINT or not all(tm.tone[DQ_TONE_INT:]):
        raise AssertionError(f"tone cells unflagged in windows "
                             f"{[i for i, t in enumerate(tm.tone) if not t]}")
    stamps = got["beams"].stamps
    steady = (len(stamps) - 1) * B_GULP / (stamps[-1] - stamps[0])
    flag = blocks["dq_flag"]
    nframe = len(volt)
    phase("dq", f"flagged, calibrated beam search {NSTAND}x{NPOL} inputs "
          f"x {BCHAN} ch, {NBEAM} beams, {nframe} frames, tone on station "
          f"{DQ_STATION} channel {DQ_CHAN} from integration {DQ_TONE_INT}: "
          f"{wall:.3f} s, {nframe / wall:.1f} frames/s with start-up; "
          f"steady state {steady:.1f} frames/s, {steady * nsp:.4g} "
          f"samples/s (first to last integration out); launches {counts} "
          f"(K5a: {nvec} vector, K2: {nvec_fir} vector); ledger {s}; "
          f"candidates "
          f"{len(det.candidates)}; tone cells "
          f"flagged in windows {DQ_TONE_INT}..{B_NINT - 1}: yes; flagged "
          f"fraction {flag.flagged_fraction:.6f}; peak device memory "
          f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated)")
    perf = {b.name: {k: round(v, 4) for k, v in b.perf_totals.items()}
            for b in pipe.blocks}
    phase("dq", f"host seconds by block and phase: {json.dumps(perf)}")
    del pipe, det, ledger, blocks, flag
    free_device()

    ref = {"beams": [], "dedispersed": []}
    dq_chain(dev, volt, gains, method="plain", gather=ref)[0].run()
    for key, n in (("beams", B_NINT), ("dedispersed", nfdmt)):
        a, b = got[key], ref[key]
        if len(a) != n or len(b) != n:
            raise AssertionError(f"gathered {len(a)}/{len(b)} {key}")
        for x, y in zip(a, b):
            if x.shape != y.shape or not np.isfinite(x).all() or \
                    not np.array_equal(x.view(np.uint32), y.view(np.uint32)):
                raise AssertionError(f"{key}: kernels != plain")
    free_device()

    # The first integration against the f64 golden, the gains applied and
    # the cells of the first window's mask zeroed.
    g_sp = np.repeat(gains, NPOL).astype(np.complex128)
    zeroed = tm.first.reshape(BCHAN, nsp)
    sc = spec * g_sp[None, None, :]
    sc[:, zeroed] = 0
    w = default_beam_weights(NBEAM, nsp).astype(np.complex128)
    beams = sc @ w.T
    golden = (beams.real ** 2 + beams.imag ** 2).sum(axis=0).T
    err = float(np.abs(got["beams"][0][0] - golden).max() /
                np.abs(golden).max())
    if not err <= 1e-4:
        raise AssertionError(f"first integration vs f64 golden: rel {err}")

    # The fold identity: K5b on the samples against the gains folded
    # into the weights, on one flagged stream.
    lo, hi = DQ_FOLD
    fg = {"cal": [], "fold": []}
    dq_chain(dev, volt[lo * B_GULP:hi * B_GULP], gains, gather=fg,
             fold=True)[0].run()
    a, b = np.concatenate(fg["cal"]), np.concatenate(fg["fold"])
    if a.shape != (hi - lo, NBEAM, BCHAN) or a.shape != b.shape:
        raise AssertionError(f"fold run shapes {a.shape} {b.shape}")
    fold_err = float(np.abs(a - b).max() / np.abs(b).max())
    if not fold_err <= 1e-5:
        raise AssertionError(f"gaincal -> beamform vs beamform(gains=): rel "
                             f"{fold_err}")
    phase("dq", f"beam powers ({B_NINT} x {NBEAM} x {BCHAN}) and "
          f"dedispersed frames ({nfdmt} x {NBEAM} x {B_MAX_DELAY}) bitwise "
          f"equal: kernels vs every method 'plain'; first integration vs "
          f"the f64 golden (gains applied, {int(zeroed.sum())} flagged "
          f"cells zeroed): max rel err {err:.3e} (limit 1e-4); gaincal -> "
          f"beamform vs beamform(gains=) over integrations {lo}..{hi - 1}: "
          f"max rel err {fold_err:.3e} of the peak (limit 1e-5)")
    return counts


def fusion_report_line(rep):
    """The fused groups (rule, constituents, ring hops) and refusals."""
    groups = "; ".join(f"{g['name']} [{g['rule']}, "
                       f"{g['ring_hops_eliminated']} hops]"
                       for g in rep["groups"])
    return (f"{len(rep['groups'])} group(s): {groups}; ring hops "
            f"eliminated {rep['ring_hops_eliminated']}; refused "
            f"{json.dumps(rep['refused'])}")


def fusion_run(dev, build, fused):
    """One timed run of build(fused) -> (pipeline, stamped outputs):
    -> dict of its outputs, launch counts, wall, stamps, peak bytes,
    host seconds by block and phase and fusion report."""
    pipe, outs = build(fused)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    rep = pipe.fusion_report()
    if bool(rep["groups"]) != fused:
        raise AssertionError(f"fused={fused} run: {fusion_report_line(rep)}")
    return {"fused": fused, "outs": outs, "counts": counts, "wall": wall,
            "t0": t0, "peak": torch.cuda.max_memory_allocated(dev),
            "report": rep,
            "perf": {b.name: {k: round(v, 4)
                              for k, v in b.perf_totals.items()}
                     for b in pipe.blocks}}


def fusion_chain(dev, tag, build, nframe, per_out, unit, scale, equal):
    """FUSION_PAIRS turns of a fused and an unfused run of build(fused);
    every run's outputs equal the first unfused run's (`equal`), and its
    launch counts too.  `nframe` input frames, `per_out` of them an
    output; rates in `unit` are frames times `scale`.  -> the first
    fused run's launch counts."""
    runs = []
    for _ in range(FUSION_PAIRS):
        for fused in (True, False):
            runs.append(fusion_run(dev, build, fused))
            free_device()
    ref = runs[1]
    for r in runs:
        if r["counts"] != ref["counts"]:
            raise AssertionError(f"{tag}: fused={r['fused']} launches "
                                 f"{r['counts']}, unfused {ref['counts']}")
        equal(r["outs"], ref["outs"])
    rates = []
    for r in runs:
        st = r["outs"].stamps
        steady = (len(st) - 1) * per_out / (st[-1] - st[0]) \
            if len(st) > 1 else float("nan")
        rates.append(f"{'fused' if r['fused'] else 'unfused'} "
                     f"{nframe * scale / r['wall']:.4g} whole, "
                     f"{steady * scale:.4g} steady "
                     f"({1e3 * per_out / steady:.2f} ms an output), peak "
                     f"{r['peak'] / 2**30:.2f} GiB")
    phase("fusion", f"{tag}: {fusion_report_line(runs[0]['report'])}")
    phase("fusion", f"{tag}: {nframe} frames, {unit} (whole run; steady "
          f"from the first output to the last), in turns: "
          f"{'; '.join(rates)}; launches equal fused and unfused: "
          f"{ref['counts']}; outputs equal: every run bitwise the first "
          f"unfused run's")
    for r in runs[:2]:
        phase("fusion", f"{tag}: host seconds by block and phase, "
              f"{'fused' if r['fused'] else 'unfused'}: "
              f"{json.dumps(r['perf'])}")
    return runs[0]["counts"]


def equal_arrays(a, b):
    if len(a) != len(b) or not len(a):
        raise AssertionError(f"{len(a)} outputs against {len(b)}")
    for x, y in zip(a, b):
        x, y = (t.cpu().numpy() if isinstance(t, torch.Tensor) else t
                for t in (x, y))
        if x.shape != y.shape or not np.isfinite(x).all() or \
                not np.array_equal(x.view(np.uint8), y.view(np.uint8)):
            raise AssertionError("fused != unfused")


def fusion_path(dev, kind, volt):
    """The four chains the reference fuses by default, fused and unfused
    in turns (module docstring, phase 11).  `volt`: [dq]'s voltages.
    -> the kernels' launch counts of each chain's first fused run."""
    from bifrost_tpu_torch.service import lwa_beam_search_pipeline
    nsp = NSTAND * NPOL
    counts = {}

    def bsearch(fused):
        got = {"dedispersed": Stamped()}
        pipe = lwa_beam_search_pipeline(
            volt, nstand=NSTAND, npol=NPOL, nchan=BCHAN, ntap=NTAP,
            n_int=N_INT, nbeam=NBEAM, max_delay=B_MAX_DELAY, f0_mhz=B_F0,
            dt_s=B_DT, gulp_nframe=B_GULP, device=dev, gather=got,
            fuse=fused)[0]
        return pipe, got["dedispersed"]

    counts["fusion_bsearch"] = fusion_chain(
        dev, "beam search", bsearch, len(volt), B_GULP,
        "station-pol samples/s", nsp, equal_arrays)
    # A fused group runs its H2D head and its stages on one stream, so
    # a gulp's copy no longer overlaps the gulp before's compute: one
    # gulp's pinned H2D, the time that exposes.
    src = torch.from_numpy(volt[:B_GULP]).pin_memory()
    dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
    phase("fusion", f"one beam-search gulp's H2D ({src.numel() / 2**20:.0f}"
          f" MiB, pinned): "
          f"{cuda_time(lambda: dst.copy_(src, non_blocking=True), 10):.3f} "
          f"ms")
    del src, dst

    gains = (0.5 + np.random.default_rng(SEED + 8).random(NSTAND) +
             0.3j * np.random.default_rng(SEED + 9).standard_normal(
                 NSTAND)).astype(np.complex64)

    def dq(fused):
        got = {"dedispersed": Stamped()}
        pipe = dq_chain(dev, volt, gains, gather=got, fuse=fused)[0]
        return pipe, got["dedispersed"]

    counts["fusion_dq"] = fusion_chain(
        dev, "DQ beam search", dq, len(volt), B_GULP,
        "station-pol samples/s", nsp, equal_arrays)
    c = counts["fusion_dq"]
    if not c["flag_stats"] == c["flag_walk"] == c["dq_masked_fill"] == \
            B_NINT or c["flag_cross"] != 3 * B_NINT:
        raise AssertionError(f"DQ beam search: W1s, W1 and K5a once a gulp, "
                             f"W1m three times, launches {c}")

    short = volt[:FX_NINT * B_GULP]

    def instr(fused):
        imgs = Images(FX_KEEP)
        pipe = instrument(dev, short, gather={"dedispersed": []},
                          on_image=imgs, fuse=fused)[0]
        return pipe, imgs

    counts["fusion_instrument"] = fusion_chain(
        dev, f"instrument ({FX_NINT} integrations)", instr, len(short),
        B_GULP, "station-pol samples/s", nsp,
        lambda a, b: images_equal(a, b, FX_KEEP))

    rng = np.random.default_rng(0)
    for g in (GS_FLAGSHIP, GS_GUPPI):
        gv = gs_voltages(g, rng)
        src = gv if len(gv) == g["nframe"] else np.concatenate(
            [gv] * (g["nframe"] // len(gv)))

        def spectro(fused):
            import bifrost_tpu_torch as bt
            from bifrost_tpu_torch.blocks import array_source, callback_sink
            outs = Stamped()

            def keep(t):
                outs.append(t.clone())
                torch.cuda.current_stream().synchronize()
                outs.stamps[-1] = time.perf_counter()

            with bt.Pipeline(device=dev) as pipe:
                bc = bt.BlockChainer()
                gs_chain(bc, g, lambda b: b.custom(array_source)(
                    src, 1, header={
                        "dtype": "ci8",
                        "labels": ["time", "freq", "fine_time", "pol"]}),
                    fused)
                bc.custom(callback_sink)(on_data=keep)
            return pipe, outs

        c = fusion_chain(
            dev, f"gpuspec {g['name']}", spectro, g["nframe"], g["n_int"],
            "samples/s", g["nchan"] * g["ntime"] * g["npol"], equal_arrays)
        if any(c.values()):
            raise AssertionError(f"gpuspec launched hand kernels: {c}")
        counts[f"fusion_gpuspec_{g['name']}"] = c
        del gv, src
        free_device()
    return counts


# ----------------------------------------------------------------- service
class Fingerprints(Images):
    """An on_image callback for the service phase: keeps host copies of
    the first `keep` images (compared bitwise) and two checksums of
    every image's words (their sum and a position-weighted sum, mod
    2**64), stamping the host clock at each."""

    def __init__(self, keep):
        super().__init__(keep)
        self.sums = []

    weights = None       # 1, 2, 3, ... as int64, cached

    def __call__(self, grid):
        super().__call__(grid)
        w = torch.view_as_real(grid).reshape(-1).view(torch.int64)
        if Fingerprints.weights is None or \
                Fingerprints.weights.numel() != w.numel():
            Fingerprints.weights = torch.arange(1, w.numel() + 1,
                                                dtype=torch.int64)
        self.sums.append((int(w.sum()), int((w * Fingerprints.weights)
                                            .sum())))


def sv_spec(volt, imgs, cands, **kw):
    """`lwa_instrument_spec` at the flagship width over `volt`."""
    from bifrost_tpu_torch.service import lwa_instrument_spec
    return lwa_instrument_spec(
        voltages=volt, nstand=NSTAND, npol=NPOL, nchan=BCHAN, ntap=NTAP,
        n_int=N_INT, nbeam=NBEAM, max_delay=B_MAX_DELAY, ngrid=NGRID,
        f0_mhz=B_F0, dt_s=B_DT, gulp_nframe=B_GULP, on_image=imgs,
        on_candidate=cands.append, **kw)


def gather_dedispersed(spec, gather):
    """`spec` (sv_spec's) with a gather sink on its beam FDMT's output,
    where `lwa_instrument_pipeline(gather={'dedispersed': ...})` puts
    one."""
    from bifrost_tpu_torch.blocks.testing import gather_sink
    stage = spec.stages[-1]
    make = stage.params["factory"]

    def factory(up):
        det = make(up)
        gather_sink(det.irings[0].owner, gather, name="gather_dedispersed")
        return det
    stage.params["factory"] = factory
    return spec


def sv_run(dev, volt, service, plan=None):
    """One instrument run, as a supervised Service or the bare pipeline
    -> dict of images, candidates, ledger summary, launches, wall, the
    steady rate, peak bytes, start()/stop() seconds, events, report; the
    bare run also its dedispersed frames and ring bytes ([fleet]'s
    reference for its inst tenant)."""
    from bifrost_tpu_torch.fleet import pipeline_ring_bytes
    from bifrost_tpu_torch.service import Service
    imgs, cands, events, ded = Fingerprints(SV_KEEP), [], [], []
    if service:
        svc = Service(sv_spec(volt, imgs, cands), name="sv", device=dev)
        svc.on_event(events.append)
        if plan is not None:
            svc.pipeline._fuse_device_chains()
            plan.attach(svc.pipeline)
    else:
        pipe, det, ledger = instrument(dev, volt, on_image=imgs, fuse=True,
                                       gather={"dedispersed": ded})
        det.on_candidate = cands.append
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    out = {}
    try:
        if service:
            svc.start()
            if not svc.wait(timeout=600):
                raise AssertionError("service run did not finish")
            t1 = time.perf_counter()
            report = svc.stop()
            out["stop_s"] = time.perf_counter() - t1
            out["start_s"] = svc.start_s
            out["report"] = report
            out["ledger"] = report.ledger
            if svc._run_error is not None:
                raise svc._run_error
        else:
            pipe.run()
            out["ledger"] = ledger.summary()
            out.update(ded=ded, ring_bytes=pipeline_ring_bytes(pipe))
    finally:
        if plan is not None:
            plan.detach()
    torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    out["counts"] = read_counts()
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    st = imgs.stamps
    out["steady"] = B_GULP * (len(st) - 1) / (st[-1] - st[0]) \
        if len(st) > 1 else float("nan")
    out.update(imgs=imgs, cands=cands, events=events)
    return out


def sv_check_clean(r):
    rep = r["report"]
    c = rep.counters
    if rep.exit_code != 0 or not rep.drain.clean or \
            any(v["outcome"] != "drained"
                for v in rep.drain.blocks.values()):
        raise AssertionError(f"clean service run: {rep!r}")
    if c["faults"] or c["restarts"] or c["heartbeat_misses"] or \
            c["deadman_interrupts"] or c["escalations"]:
        raise AssertionError(f"clean service run counters {c}; events "
                             f"{[e.as_dict() for e in r['events']]}")


def sv_same_images(a, b, what, n=SV_NINT):
    """The first `n` images of `a` and `b` bitwise (by checksum; the
    first SV_KEEP whole); `a` holds n."""
    if len(a.sums) != n or a.sums != b.sums[:n]:
        raise AssertionError(f"{what}: image checksums differ "
                             f"({len(a.sums)}/{len(b.sums)} images)")
    images_equal(a, b, min(SV_KEEP, n))


def service_path(dev, volt):
    """The instrument as one supervised Service (module docstring, phase
    12).  `volt`: [bengine]'s voltages.  -> launch counts of the clean
    service run and of the faulted one, and the bare pipeline's run
    (`sv_run`), which [fleet]'s inst tenant is held against."""
    from bifrost_tpu_torch.faultinject import FaultPlan
    nsp = NSTAND * NPOL
    volt = volt[:SV_NINT * B_GULP]
    nfdmt = SV_NINT - B_MAX_DELAY

    # (a) Clean runs, Service and bare pipeline in turns.
    runs = []
    for _ in range(SV_PAIRS):
        for service in (True, False):
            runs.append(sv_run(dev, volt, service))
            free_device()
    ref = runs[1]
    SOLO["inst"] = dict(steady=ref["steady"])
    want = expected(fir_mac=SV_NINT, beamform_power=SV_NINT,
                    romein_grid_separable=SV_NINT,
                    fdmt_merge_step=ref["counts"]["fdmt_merge_step"])
    if ref["counts"] != want or not ref["counts"]["fdmt_merge_step"]:
        raise AssertionError(f"bare launches {ref['counts']}")
    for r in runs:
        if r["counts"] != ref["counts"]:
            raise AssertionError(f"launches {r['counts']} != bare "
                                 f"{ref['counts']}")
        s = r["ledger"]
        if s["lost_frames"] or s["duplicated_frames"] or \
                s["committed_frames"] != nfdmt:
            raise AssertionError(f"ledger {s}")
        sv_same_images(r["imgs"], ref["imgs"], "service vs bare")
        if r["cands"] != ref["cands"]:
            raise AssertionError("candidates differ")
        if "report" in r:
            sv_check_clean(r)
    clean = runs[0]
    rates = "; ".join(
        f"{'service' if 'report' in r else 'bare'} "
        f"{r['steady']:.1f} steady ({SV_NINT * B_GULP / r['wall']:.1f} "
        f"whole), peak {r['peak'] / 2**30:.2f} GiB"
        + (f", start() {r['start_s']:.3f} s, stop() {r['stop_s']:.3f} s"
           if "report" in r else "") for r in runs)
    phase("service", f"(a) clean: Service(lwa_instrument_spec) and "
          f"lwa_instrument_pipeline (fused) in turns, {SV_NINT} "
          f"integrations, frames/s: {rates}; launches equal "
          f"{ref['counts']}; images ({SV_NINT} checksummed, the first "
          f"{SV_KEEP} compared whole) and {len(ref['cands'])} candidates "
          f"bitwise equal; exit code 0, every block drained, ledger "
          f"{clean['ledger']}, no fault, restart, heartbeat miss or "
          f"deadman")
    phase("service", f"(a) drain report of the first service run: "
          f"{json.dumps(clean['report'].drain.as_dict()['blocks'])}")

    # (b) One injected fault, as benchmarks/e2e_tpu.py:189-191 arms it.
    plan = FaultPlan(seed=7)
    plan.raise_at("block.on_data", block="bengine", nth=1)
    f = sv_run(dev, volt[:SV_FAULT_NINT * B_GULP], True, plan)
    free_device()
    rep = f["report"]
    restarts = [e for e in f["events"] if e.kind == "restart"]
    if not plan.fired(site="block.on_data") or len(restarts) != 1 or \
            "bengine" not in restarts[0].details.get("constituents", ()):
        raise AssertionError(f"fault run events "
                             f"{[e.as_dict() for e in f['events']]}")
    s = f["ledger"]
    if s["lost_frames"] or s["duplicated_frames"] or rep.exit_code != 0:
        raise AssertionError(f"fault run: {rep!r}")
    sv_same_images(f["imgs"], clean["imgs"], "X branch, fault vs clean",
                   SV_FAULT_NINT)
    if f["peak"] > clean["peak"] + 2**30:
        raise AssertionError(f"fault run peak {f['peak']} > clean "
                             f"{clean['peak']} + 1 GiB")
    rec = rep.recovery
    phase("service", f"(b) FaultPlan(seed=7).raise_at('block.on_data', "
          f"block='bengine', nth=1): fired {len(plan.fired())}; one "
          f"restart of {restarts[0].block} "
          f"(constituents {restarts[0].details['constituents']}, "
          f"shed {restarts[0].details.get('shed_nframe')} frames); "
          f"recovery (fault -> first healthy gulp) {rec['last_s']:.4f} s; "
          f"exit code {rep.exit_code}; ledger {s}; X-branch images "
          f"bitwise the clean run's; {f['steady']:.1f} frames/s steady; "
          f"peak {f['peak'] / 2**30:.2f} GiB (clean "
          f"{clean['peak'] / 2**30:.2f}); launches {f['counts']}")

    # (c) A block wedged in a ring wait: the image sink waits for the
    # last image while the D2H copy is parked (stamping its heartbeat,
    # scaffolding), until the supervisor's deadman_interrupt releases
    # it; upstream has finished, so only the sink goes stale.
    from bifrost_tpu_torch.service import Service
    short = volt[:SV_WEDGE_NINT * B_GULP]
    import threading
    release, marks = threading.Event(), {}

    def on_ev(ev):
        if ev.kind == "deadman_interrupt" and ev.block == "image_sink":
            marks["deadman"] = ev.time
            # The parked copy goes on 0.2 s later: the sink's interrupt
            # surfaces before its gulp could arrive.
            threading.Timer(0.2, release.set).start()
        if ev.kind == "restart" and ev.block == "image_sink":
            marks["restart"] = ev.time

    imgs = Fingerprints(0)
    svc = Service(sv_spec(short, imgs, [], heartbeat_interval_s=0.25,
                          heartbeat_misses=8, quiesce_timeout_s=10.0),
                  name="sv_wedge", device=dev)
    svc.on_event(on_ev)
    svc.pipeline._fuse_device_chains()
    plan = FaultPlan(seed=7)
    plan.wedge_at("block.on_data", block="image_d2h",
                  nth=SV_WEDGE_NINT - 1, release=release, timeout=60.0,
                  stamp_heartbeat=True)
    plan.attach(svc.pipeline)
    try:
        svc.start()
        if not svc.wait(timeout=120):
            raise AssertionError("wedge run did not finish")
        t1 = time.perf_counter()
        rep = svc.stop()
        stop_s = time.perf_counter() - t1
    finally:
        plan.detach()
        release.set()
    c = rep.counters
    if c["restarts"] != 1 or c["deadman_interrupts"] < 1 or \
            c["escalations"] or "restart" not in marks or \
            len(imgs.stamps) != SV_WEDGE_NINT or stop_s > 10.0 + 1.0 or \
            rep.ledger["lost_frames"] or rep.ledger["duplicated_frames"]:
        raise AssertionError(f"wedge run: {rep!r}; {len(imgs.stamps)} "
                             f"images; stop {stop_s:.3f} s")
    phase("service", f"(c) image_d2h parked before its last gulp, "
          f"image_sink waiting in its ring: heartbeat 0.25 s x 8; "
          f"counters {c}; deadman -> restart "
          f"{marks['restart'] - marks['deadman']:.4f} s; "
          f"{len(imgs.stamps)} images; exit code {rep.exit_code}; stop() "
          f"{stop_s:.3f} s")
    del svc, imgs
    free_device()

    # (d) The FRB search as a registry-built service.
    from bifrost_tpu_torch.blocks import array_source
    from bifrost_tpu_torch.service import (ServiceSpec, StageSpec,
                                           frb_search_pipeline)
    data = frb_data()
    cands = []
    spec = ServiceSpec([
        StageSpec("custom", name="capture", params=dict(
            factory=lambda up: array_source(data, GULP, header={
                "labels": ["time", "freq"],
                "scales": [[0.0, DT], [F0, DF]],
                "units": ["s", "MHz"]}))),
        StageSpec("copy"),
        StageSpec("transpose", params=dict(axes=["freq", "time"],
                                           gulp_nframe=GULP)),
        StageSpec("fdmt", params=dict(max_delay=MAX_DELAY,
                                      gulp_nframe=GULP)),
        StageSpec("detect", params=dict(on_candidate=cands.append,
                                        gulp_nframe=GULP)),
    ])
    svc = Service(spec, name="sv_frb", device=dev)
    t0 = time.perf_counter()
    svc.start()
    if not svc.wait(timeout=300):
        raise AssertionError("FRB service did not finish")
    rep = svc.stop()
    wall = time.perf_counter() - t0
    bare = []
    frb_search_pipeline(data, GULP, MAX_DELAY, F0, DF, DT, device=dev,
                        on_candidate=bare.append)[0].run()
    if rep.exit_code != 0 or cands != bare or not cands or \
            rep.ledger["committed_frames"] != GULP * NGULP - MAX_DELAY:
        raise AssertionError(f"FRB service: {rep!r}")
    check_burst(svc.blocks["detect"])
    phase("service", f"(d) FRB search from the registry (custom source, "
          f"copy, transpose, fdmt, detect): {wall:.3f} s; exit code 0; "
          f"{len(cands)} candidates bitwise frb_search_pipeline's; the "
          f"burst found")
    del svc, data
    free_device()

    # (e) A mid-stream stop(timeout=) of the instrument.
    free_device()
    before = torch.cuda.memory_allocated(dev)
    imgs = Fingerprints(0)
    svc = Service(sv_spec(volt, imgs, []), name="sv_stop", device=dev)
    svc.start()
    while len(imgs.stamps) < SV_STOP_AFTER and svc.running:
        time.sleep(0.01)
    t1 = time.perf_counter()
    rep = svc.stop(timeout=SV_QUIESCE)
    stop_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    drain = rep.drain.as_dict()
    del svc
    free_device()
    after = torch.cuda.memory_allocated(dev)
    if rep.drain.wedged or rep.exit_code == 2 or \
            after > before + 2**30 or stop_s > SV_QUIESCE + 2.0:
        raise AssertionError(f"mid-stream stop: {rep!r}; memory "
                             f"{before} -> {after}")
    outcomes = {}
    for v in drain["blocks"].values():
        outcomes[v["outcome"]] = outcomes.get(v["outcome"], 0) + 1
    phase("service", f"(e) stop(timeout={SV_QUIESCE}) after "
          f"{SV_STOP_AFTER} images: {stop_s:.3f} s (drain elapsed "
          f"{drain['elapsed_s']} s), outcomes {outcomes}, exit code "
          f"{rep.exit_code}, {len(imgs.stamps)} images; "
          f"torch.cuda.synchronize() ok; memory_allocated "
          f"{before / 2**30:.3f} -> {after / 2**30:.3f} GiB once dropped")
    return runs[0]["counts"], f["counts"], ref


def cp_packets(frames, nsrc, rate_pps):
    """A compiled schedule of `frames` ((nframe, nsrc * payload) uint8)
    as 'simple' packets, packet (t, s) carrying bytes [s * payload,
    (s + 1) * payload) of frame t, in order, one every 1 / rate_pps s.
    -> (slab bytes, records)."""
    nframe, nbyte = frames.shape
    payload = nbyte // nsrc
    pkt = np.empty((nframe, nsrc), dtype=[
        ("seq", "<u8"), ("src", "<u2"), ("pad", "<u2"),
        ("payload", "u1", payload)])
    pkt["seq"] = np.arange(nframe)[:, None]
    pkt["src"] = np.arange(nsrc)[None, :]
    pkt["pad"] = 0
    pkt["payload"] = frames.reshape(nframe, nsrc, payload)
    return pkt.tobytes(), cp_records(pkt.size, pkt.dtype.itemsize, rate_pps)


def cp_records(n, size, rate_pps):
    from bifrost_tpu_torch.udp import TRANSMIT_RECORD_DTYPE
    recs = np.zeros(n, dtype=TRANSMIT_RECORD_DTYPE)
    recs["offset"] = np.arange(n, dtype=np.uint64) * size
    recs["size"] = size
    recs["t_ns"] = (np.arange(n) * (1e9 / rate_pps)).astype(np.uint64)
    return recs


def cp_socket():
    """A capture socket on loopback, port 0, 0.05 s receive timeout;
    -> (socket, SO_RCVBUF bytes as the kernel granted it)."""
    import socket as pysock
    from bifrost_tpu_torch.udp import UDPSocket
    rx = UDPSocket().bind("127.0.0.1", 0)
    rx.set_timeout(0.05)
    s = pysock.socket(fileno=os.dup(rx.fileno()))
    rcvbuf = s.getsockopt(pysock.SOL_SOCKET, pysock.SO_RCVBUF)
    s.close()
    return rx, rcvbuf


def cp_drive(svc, capb, rx, slab, recs):
    """Start `svc`, walk the schedule into `rx`, wait until the capture
    has drained the socket (its counters still for 0.5 s), stop (the
    quiesce ends the capture, committing its last windows, and drains the
    chain).  -> dict of walker stats, the stop's report, wall seconds."""
    from bifrost_tpu_torch.udp import UDPSocket, UDPTransmit
    tx_sock = UDPSocket().connect("127.0.0.1", rx.port)
    tx = UDPTransmit(tx_sock)
    svc.start()
    t0 = time.perf_counter()
    try:
        tx.start_schedule(slab, recs, batch_npkt=64)
        walk = tx.wait_schedule()
        last, still = None, time.perf_counter()
        deadline = still + 120.0
        while time.perf_counter() < deadline:
            cur = capb.stats
            if cur != last:
                last, still = cur, time.perf_counter()
            elif time.perf_counter() - still > 0.5:
                break
            time.sleep(0.05)
        report = svc.stop(timeout=60.0)
        torch.cuda.synchronize()
    finally:
        tx_sock.shutdown()
        rx.shutdown()
    wall = time.perf_counter() - t0
    if svc._run_error is not None:
        raise svc._run_error
    return {"walk": walk, "report": report, "wall": wall,
            "stats": capb.final_stats}


def cp_frb_run(dev, slab, recs):
    """One FRB search over UDP (`Service(lwa_frb_search_spec(rx,
    gulp_nframe=GULP, max_delay=MAX_DELAY))`) -> run dict."""
    from bifrost_tpu_torch.service import Service, lwa_frb_search_spec
    rx, rcvbuf = cp_socket()
    cands = []
    svc = Service(lwa_frb_search_spec(
        rx, nsrc=CP_NSRC, max_payload_size=CP_PAYLOAD, gulp_nframe=GULP,
        max_delay=MAX_DELAY, f0_mhz=F0, df_mhz=DF, dt_s=DT,
        on_candidate=cands.append), name="cp_frb", device=dev)
    reset_counts()
    r = cp_drive(svc, svc.blocks["capture"], rx, slab, recs)
    r.update(counts=read_counts(), cands=cands, svc=svc, rcvbuf=rcvbuf)
    return r


def cp_rates(r):
    """-> (packets/s the walker sent, packets/s the engine landed), both
    over the walk's wall time."""
    w = r["walk"]
    return (w["nsent"] / w["wall_s"], r["stats"]["ngood"] / w["wall_s"])


def capture_path(dev, volt):
    """The socket-fed paths (module docstring, phase 13).  `volt`:
    [bengine]'s voltages.  -> launch counts of (a) at real time, (c) and
    (d)."""
    import importlib.util
    from bifrost_tpu_torch.service import (Service, frb_search_pipeline,
                                           lwa_instrument_spec)
    out = {}

    # (a) The FRB search over UDP at real time, against the replay.
    data = frb_data()[:CP_NGULP * GULP]
    nframe = len(data)
    npkt = nframe * CP_NSRC
    slab, recs = cp_packets(data, CP_NSRC, CP_RATES[0])
    a = cp_frb_run(dev, slab, recs)
    svc = a["svc"]
    st, rep = a["stats"], a["report"]
    if st != {"ngood": npkt, "nmissing": 0, "ninvalid": 0, "nlate": 0,
              "nrepeat": 0}:
        raise AssertionError(f"capture at {CP_RATES[0]} packets/s: {st}")
    s = rep.ledger
    if rep.exit_code != 0 or s["lost_frames"] or s["duplicated_frames"] \
            or s["committed_frames"] != nframe - MAX_DELAY:
        raise AssertionError(f"FRB over UDP: {rep!r}")
    spaces = {r.name: r.space for r in svc.pipeline.rings}
    fd = svc.blocks["fdmt"]
    if set(spaces.values()) != {"system"} or \
            torch.device(fd.device).type != dev.type:
        raise AssertionError(f"rings {spaces}, fdmt on {fd.device}")
    nsteps = len(fd.fdmt._steps)
    if a["counts"] != expected(fdmt_merge_step=nsteps * CP_NGULP) or \
            fd._frames_staged != nframe:
        raise AssertionError(f"launches {a['counts']}, expected "
                             f"{nsteps * CP_NGULP} of K1; staged "
                             f"{fd._frames_staged} frames")
    ref = []
    frb_search_pipeline(data, GULP, MAX_DELAY, F0, DF, DT, device=dev,
                        on_candidate=ref.append)[0].run()
    got = a["cands"]
    if [(c["frame"], c["dm_index"]) for c in got] != \
            [(c["frame"], c["dm_index"]) for c in ref] or not ref or \
            any(abs(x["snr"] - y["snr"]) > 1e-5 * abs(y["snr"])
                for x, y in zip(got, ref)):
        raise AssertionError(f"candidates over UDP {got} != replay {ref}")
    best = check_burst(svc.blocks["detect"])
    sent, ingested = cp_rates(a)
    perf = {b.name: {k: round(v, 4) for k, v in b.perf_totals.items()}
            for b in svc.pipeline.blocks}
    phase("capture", f"(a) Service(lwa_frb_search_spec(rx, gulp_nframe="
          f"{GULP}, max_delay={MAX_DELAY})): {nframe} frames of {NCHAN} "
          f"ch as {npkt} packets of {12 + CP_PAYLOAD} B at "
          f"{CP_RATES[0]} packets/s (SO_RCVBUF {a['rcvbuf']} B): sent "
          f"{sent:.1f} packets/s, ingested {ingested:.1f}; "
          f"{nframe / a['wall']:.1f} frames/s through stop(); stats {st}; "
          f"ledger {s}; rings {sorted(set(spaces.values()))}, the FDMT "
          f"on {fd.device} ({fd._frames_staged} frames staged); launches "
          f"{a['counts']}; {len(got)} candidates equal to "
          f"frb_search_pipeline's in (frame, dm_index), SNR within 1e-5 "
          f"(largest difference "
          f"{max(abs(x['snr'] - y['snr']) for x, y in zip(got, ref)):.3g}"
          f"); burst {best}")
    phase("capture", f"(a) host seconds by block and phase: "
          f"{json.dumps(perf)}")
    out["capture_frb"] = a["counts"]
    del svc, a
    free_device()

    # (b) The same stream asked for at 4x real time: reported
    # only.  The sustained rate is the highest rate SENT without loss.
    sustained = sent
    nb = CP_B_NGULP * GULP * CP_NSRC
    for rate in CP_RATES[1:]:
        b = cp_frb_run(dev, slab[:nb * (12 + CP_PAYLOAD)],
                       cp_records(nb, 12 + CP_PAYLOAD, rate))
        sent, ingested = cp_rates(b)
        st = b["stats"]
        if st["nmissing"] == 0 and st["ngood"] == nb:
            sustained = max(sustained, sent)
        phase("capture", f"(b) asked {rate} packets/s ({rate // CP_RATES[0]}"
              f"x real time): sent {sent:.1f} packets/s (walker "
              f"{b['walk']}), ingested {ingested:.1f}; ngood {st['ngood']}, "
              f"nmissing {st['nmissing']}, ninvalid {st['ninvalid']}, "
              f"nlate {st['nlate']}; ledger {b['report'].ledger}; exit "
              f"code {b['report'].exit_code}")
        del b
        free_device()
    phase("capture", f"(b) sustained capture rate (the highest sent with "
          f"nmissing == 0): {sustained:.1f} packets/s, "
          f"{sustained / CP_NSRC:.1f} frames/s of {NCHAN} ch")
    del slab, recs

    # (c) The instrument over UDP against its replay Service.
    volt = volt[:CP_NINT * B_GULP]
    frames = volt.reshape(len(volt), -1).view(np.uint8)
    npkt = len(volt) * CP_X["nsrc"]
    c, imgs, cands, counts, rcvbuf = cp_x_run(dev, frames,
                                              CP_X["slot_ntime"])
    rimgs, rcands = Fingerprints(CP_NINT), []
    rsvc = Service(sv_spec(volt, rimgs, rcands), name="cp_x_replay",
                   device=dev)
    reset_counts()
    rsvc.start()
    if not rsvc.wait(timeout=600):
        raise AssertionError("replay service run did not finish")
    rrep = rsvc.stop()
    torch.cuda.synchronize()
    rcounts = read_counts()
    del rsvc
    free_device()
    st, rep = c["stats"], c["report"]
    want = expected(fir_mac=CP_NINT, beamform_power=CP_NINT,
                    romein_grid_separable=CP_NINT)
    if st != {"ngood": npkt, "nmissing": 0, "ninvalid": 0, "nlate": 0,
              "nrepeat": 0} or rep.exit_code != 0 or \
            rrep.exit_code != 0 or counts != rcounts or counts != want:
        raise AssertionError(f"instrument over UDP: stats {st}, launches "
                             f"{counts} (replay {rcounts}), {rep!r}")
    if len(imgs.sums) != CP_NINT or imgs.sums != rimgs.sums:
        raise AssertionError(f"instrument over UDP: {len(imgs.sums)} "
                             f"images, checksums differ from the replay's")
    images_equal(imgs, rimgs, CP_NINT)
    if cands != rcands:
        raise AssertionError("instrument over UDP: candidates differ")
    sent, ingested = cp_rates(c)
    phase("capture", f"(c) Service(lwa_instrument_spec(sock=rx, capture="
          f"{CP_X} + buffer_ntime {len(volt)})): {CP_NINT} integrations, "
          f"{len(volt)} frames as {npkt} packets of "
          f"{12 + CP_X['max_payload_size']} B asked at {CP_X_RATE} "
          f"packets/s (SO_RCVBUF {rcvbuf} B): sent {sent:.1f}, ingested "
          f"{ingested:.1f} packets/s; {len(volt) / c['wall']:.1f} frames/s "
          f"through stop() (real time would be {4 * 10**6} packets/s); "
          f"stats {st}; exit code 0; {CP_NINT} images bitwise the replay "
          f"Service's; launches {counts}, the replay's")
    out["capture_instrument"] = counts
    del imgs
    free_device()

    # (d) The port's chaos matrix on the card.
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmarks_torch", "frb_service.py")
    spec_ = importlib.util.spec_from_file_location("torch_frb_service", path)
    harness = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(harness)
    reset_counts()
    t0 = time.perf_counter()
    rc = harness._check(0, str(dev))
    wall = time.perf_counter() - t0
    counts = read_counts()
    # rfi_storm's gulps of 64 frames are 4 whole windows: one W1s, one W1m
    # (a block a row) and one W1 launch a gulp, as K5a.
    if rc != 0 or not counts["fdmt_merge_step"] or \
            not counts["dq_masked_fill"] or \
            counts != expected(fdmt_merge_step=counts["fdmt_merge_step"],
                               dq_masked_fill=counts["dq_masked_fill"],
                               flag_stats=counts["dq_masked_fill"],
                               flag_cross=counts["dq_masked_fill"],
                               flag_walk=counts["dq_masked_fill"]):
        raise AssertionError(f"chaos --check: rc {rc}, launches {counts}")
    phase("capture", f"(d) benchmarks_torch/frb_service.py --check on "
          f"{dev}: every scenario passed, the restart storm's signature "
          f"equal across its two runs; {wall:.1f} s; launches {counts}")
    out["chaos"] = counts
    out["capture_i4"] = cp_i4_path(dev)
    free_device()
    out["capture_fanout"] = cp_fanout_path(dev)
    free_device()
    out["capture_slots"] = cp_slots_path(dev, frames, rimgs, rcands,
                                         rcounts)
    del rimgs
    free_device()
    cp_ring_stream()
    return out


def cp_x_run(dev, frames, slot):
    """The instrument over UDP (CP_X's packets of `frames` at CP_X_RATE,
    capture slots of `slot` frames, a capture ring holding the whole
    stream) -> (cp_drive's dict, images, candidates, launch counts,
    SO_RCVBUF granted)."""
    from bifrost_tpu_torch.service import Service, lwa_instrument_spec
    slab, recs = cp_packets(frames, CP_X["nsrc"], CP_X_RATE)
    rx, rcvbuf = cp_socket()
    imgs, cands = Fingerprints(CP_NINT), []
    spec = lwa_instrument_spec(
        sock=rx, capture=dict(CP_X, slot_ntime=slot,
                              buffer_ntime=len(frames)),
        nstand=NSTAND, npol=NPOL, nchan=BCHAN, ntap=NTAP, n_int=N_INT,
        nbeam=NBEAM, max_delay=B_MAX_DELAY, ngrid=NGRID, f0_mhz=B_F0,
        dt_s=B_DT, gulp_nframe=B_GULP, on_image=imgs,
        on_candidate=cands.append)
    svc = Service(spec, name=f"cp_x{slot}", device=dev)
    reset_counts()
    c = cp_drive(svc, svc.blocks["ingest"], rx, slab, recs)
    counts = read_counts()
    del slab, recs, svc
    return c, imgs, cands, counts, rcvbuf


def cp_fanout_path(dev):
    """(f) ROADMAP item 18 on the card: CP_FAN_NSHARD capture sockets on
    one port (SO_REUSEPORT), each the socket of one
    `Service(lwa_frb_search_spec(...))` at [main]'s full width (4096 u8
    channels, gulp 4096, max_delay 2048), fed by CP_FAN_NSHARD walker
    flows of 16 of the 64 sources each, one flow steered to each shard
    (udp.reuseport_senders), CP_FAN_NGULP gulps of frb_data() from its gulp
    CP_FAN_GULP0 (the burst's) at CP_FAN_RATE packets/s a flow.  Σ ngood equals the packets sent, no repeats; each shard's
    K1 launches (12 a gulp: check_kernels holds K1 bitwise its plain
    version at this shape); each shard's candidates equal to
    frb_search_pipeline's on the frames with only its flow's channels.
    -> launch counts."""
    import sys as _sys

    from bifrost_tpu_torch.service import (Service, frb_search_pipeline,
                                           lwa_frb_search_spec)
    from bifrost_tpu_torch.udp import (UDPSocket, UDPTransmit,
                                       reuseport_senders)
    fdmt_mod = _sys.modules["bifrost_tpu_torch.ops.fdmt"]
    nshard = CP_FAN_NSHARD
    per = CP_NSRC // nshard
    data = frb_data()[CP_FAN_GULP0 * GULP:
                      (CP_FAN_GULP0 + CP_FAN_NGULP) * GULP]
    nframe = len(data)
    rx0 = UDPSocket().bind("127.0.0.1", 0, reuseport=True)
    rxs = [rx0] + [UDPSocket().bind("127.0.0.1", rx0.port, reuseport=True)
                   for _ in range(nshard - 1)]
    for rx in rxs:
        rx.set_timeout(0.05)
    senders = reuseport_senders(rxs, probes=CP_FAN_PROBES)
    cands = [[] for _ in range(nshard)]
    svcs = [Service(lwa_frb_search_spec(
        rx, nsrc=CP_NSRC, max_payload_size=CP_PAYLOAD, gulp_nframe=GULP,
        max_delay=MAX_DELAY, f0_mhz=F0, df_mhz=DF, dt_s=DT,
        on_candidate=cands[i].append), name=f"cp_fan{i}", device=dev)
        for i, rx in enumerate(rxs)]
    flows = []
    for g in range(nshard):
        cols = data[:, g * per * CP_PAYLOAD:(g + 1) * per * CP_PAYLOAD]
        slab, recs = cp_packets(np.ascontiguousarray(cols), per,
                                CP_FAN_RATE)
        pkt = np.frombuffer(slab, dtype=[("seq", "<u8"), ("src", "<u2"),
                                         ("pad", "<u2"),
                                         ("payload", "u1", CP_PAYLOAD)])
        pkt = pkt.copy()
        pkt["src"] += g * per
        flows.append((pkt.tobytes(), recs))
    by_thread = {}
    real = fdmt_mod.merge_step

    def counted(*a, **k):
        ident = threading.get_ident()
        by_thread[ident] = by_thread.get(ident, 0) + 1
        return real(*a, **k)

    fdmt_mod.merge_step = counted
    reset_counts()
    try:
        for svc in svcs:
            svc.start()
        t0 = time.perf_counter()
        txs = [UDPTransmit(sock) for sock in senders]
        for tx, (slab, recs) in zip(txs, flows):
            tx.start_schedule(slab, recs, batch_npkt=64)
        walks = [tx.wait_schedule() for tx in txs]
        last, still = None, time.perf_counter()
        while time.perf_counter() - still < 0.5 and \
                time.perf_counter() - t0 < 120:
            cur = [svc.blocks["capture"].stats for svc in svcs]
            if cur != last:
                last, still = cur, time.perf_counter()
            time.sleep(0.05)
        health = [svc.health()["capture"] for svc in svcs]
        host_rings = [(r.name, r.space, r.page_nodes() or "no NUMA maps")
                      for svc in svcs for r in svc.pipeline.rings
                      if r.space != "cuda"]
        reports = [svc.stop(timeout=60.0) for svc in svcs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        fdmt_mod.merge_step = real
        for sock in senders:
            sock.shutdown()
        for rx in rxs:
            rx.shutdown()
    counts = read_counts()
    for svc in svcs:
        if svc._run_error is not None:
            raise svc._run_error
    stats = [svc.blocks["capture"].final_stats for svc in svcs]
    shard_k1 = [sum(n for ident, n in by_thread.items()
                    if any(ident in getattr(b, "_thread_idents", ())
                           for b in svc.pipeline.blocks))
                for svc in svcs]
    nsteps = len(svcs[0].blocks["fdmt"].fdmt._steps)
    sent = sum(w["nsent"] for w in walks)
    if sent != nframe * CP_NSRC or any(w["ndropped"] for w in walks) or \
            sum(st["ngood"] for st in stats) != sent or \
            any(st["nrepeat"] or st["ngood"] != nframe * per
                for st in stats) or \
            any(r.exit_code != 0 or r.ledger["lost_frames"]
                for r in reports):
        raise AssertionError(f"fan-out: walkers {walks}, stats {stats}, "
                             f"reports {reports}")
    if shard_k1 != [nsteps * CP_FAN_NGULP] * nshard or \
            counts != expected(fdmt_merge_step=nsteps * CP_FAN_NGULP *
                               nshard):
        raise AssertionError(f"fan-out K1 launches by shard {shard_k1}, "
                             f"counts {counts}")
    for g in range(nshard):
        masked = np.zeros_like(data)
        sl = slice(g * per * CP_PAYLOAD, (g + 1) * per * CP_PAYLOAD)
        masked[:, sl] = data[:, sl]
        ref = []
        frb_search_pipeline(masked, GULP, MAX_DELAY, F0, DF, DT, device=dev,
                            on_candidate=ref.append)[0].run()
        got = cands[g]
        if not ref or [(c["frame"], c["dm_index"]) for c in got] != \
                [(c["frame"], c["dm_index"]) for c in ref] or \
                any(abs(x["snr"] - y["snr"]) > 1e-5 * abs(y["snr"])
                    for x, y in zip(got, ref)):
            raise AssertionError(f"shard {g} candidates {got} != {ref}")
    rates = [round(w["nsent"] / w["wall_s"], 1) for w in walks]
    phase("capture", f"(f) {nshard} x Service(lwa_frb_search_spec(rx_i, "
          f"gulp_nframe={GULP}, max_delay={MAX_DELAY})) on one SO_REUSEPORT "
          f"port, {nshard} walker flows of {per} sources, one steered to "
          f"each shard: {nframe} frames of {NCHAN} ch, {sent} packets "
          f"sent at {rates} packets/s a flow; ngood {[st['ngood'] for st in stats]} "
          f"(sum {sum(st['ngood'] for st in stats)} = sent), nrepeat "
          f"{[st['nrepeat'] for st in stats]}, nmissing "
          f"{[st['nmissing'] for st in stats]}; {nframe / wall:.1f} frames/s "
          f"a shard, {nshard * nframe / wall:.1f} in all, "
          f"{sent / wall:.1f} packets/s in all, through stop() ({wall:.2f} "
          f"s); K1 launches by shard {shard_k1} ({nsteps} a gulp); "
          f"candidates by shard {[len(c) for c in cands]}, each equal to "
          f"frb_search_pipeline's on its flow's channels; health capture "
          f"{health}; host rings (name, space, (pages by NUMA node, "
          f"policies)) {host_rings}")
    return counts


def cp_entries(frames, slot):
    """Python entries a slot window: a bare UDPCapture of CP_X's packets
    of `frames` at CP_X_RATE into a host ring, slots of `slot` frames,
    with every Python function entered straight from inside the engine's
    recv counted (sys.setprofile, this thread) -> (entries, windows,
    stats)."""
    import inspect
    import sys as _sys

    from bifrost_tpu_torch.ring import Ring
    from bifrost_tpu_torch.udp import UDPCapture, UDPSocket, UDPTransmit
    slab, recs = cp_packets(frames, CP_X["nsrc"], CP_X_RATE)
    rx, _ = cp_socket()
    ring = Ring(space="system", name="cp_entries")
    nbyte = frames.shape[1] // CP_X["nsrc"]
    cap = UDPCapture("simple", rx, ring, nsrc=CP_X["nsrc"], src0=0,
                     max_payload_size=nbyte, buffer_ntime=len(frames),
                     slot_ntime=slot, header_callback=lambda s: (s, {
                         "_tensor": {"dtype": "u8",
                                     "shape": [-1, frames.shape[1]]}}))
    src, first = inspect.getsourcelines(UDPCapture._call)
    at_engine = first + next(i for i, ln in enumerate(src)
                             if "fn(self.obj" in ln)
    entries = []

    def prof(frame, event, arg):
        up = frame.f_back
        if event == "call" and up is not None and \
                up.f_code is UDPCapture._call.__code__ and \
                up.f_lineno == at_engine:
            entries.append(frame.f_code.co_name)

    tx_sock = UDPSocket().connect("127.0.0.1", rx.port)
    tx = UDPTransmit(tx_sock)
    tx.start_schedule(slab, recs, batch_npkt=64)
    _sys.setprofile(prof)
    try:
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline:
            if cap.recv() == 3 and not tx.schedule_stats()["running"]:
                break
    finally:
        _sys.setprofile(None)
    tx.wait_schedule()
    nwindow = cap.nwindow
    cap.end()
    stats = cap.stats
    cap.close()
    tx_sock.shutdown()
    rx.shutdown()
    return entries, nwindow, stats


def cp_slots_path(dev, frames, rimgs, rcands, rcounts):
    """(g) The instrument over UDP at CP_SLOTS-frame slots (K2, K4, K6b on
    its path), the packets of (c), with the granted socket buffer: the
    packets lost at each slot size ((c) is the 4096-frame run); where
    none is lost, the images are bitwise (c)'s replay Service's.  Then the Python entries a slot window
    of the capture engine at 16-frame slots (cp_entries), and where
    `Ring(core=)` puts host pages.  -> launch counts of the first run."""
    from bifrost_tpu_torch import affinity
    from bifrost_tpu_torch.ring import Ring
    out = None
    npkt = len(frames) * CP_X["nsrc"]
    want = expected(fir_mac=CP_NINT, beamform_power=CP_NINT,
                    romein_grid_separable=CP_NINT)
    for slot in CP_SLOTS:
        c, imgs, cands, counts, rcvbuf = cp_x_run(dev, frames, slot)
        st, rep = c["stats"], c["report"]
        if rep.exit_code != 0 or counts != want or counts != rcounts or \
                st["ngood"] + st["nmissing"] != npkt or st["nrepeat"]:
            raise AssertionError(f"instrument over UDP at {slot}-frame "
                                 f"slots: stats {st}, launches {counts}, "
                                 f"{rep!r}")
        same = "not compared (packets lost)"
        if st["nmissing"] == 0:
            if imgs.sums != rimgs.sums or cands != rcands:
                raise AssertionError(f"{slot}-frame slots: images or "
                                     f"candidates differ from the replay")
            same = "bitwise the replay Service's"
        sent, ingested = cp_rates(c)
        phase("capture", f"(g) the instrument over UDP at {slot}-frame "
              f"slots ({CP_X['nsrc'] * slot} packets a window), {npkt} "
              f"packets asked at {CP_X_RATE} packets/s (SO_RCVBUF {rcvbuf} "
              f"B): sent {sent:.1f}, ingested {ingested:.1f} packets/s; "
              f"lost {st['nmissing']} of {npkt}; stats {st}; "
              f"{len(frames) / c['wall']:.1f} frames/s through stop(); "
              f"{len(imgs.sums)} images {same}; launches {counts}")
        out = out or counts
        del imgs
        free_device()
    nent = CP_ENTRIES_NFRAME
    entries, nwindow, st = cp_entries(frames[:nent], 16)
    if entries != ["_cb"] or nwindow < nent // 16 - 2:
        raise AssertionError(f"Python entries {entries[:8]} "
                             f"({len(entries)}) in {nwindow} windows")
    cores = sorted(os.sched_getaffinity(0))
    placed = []
    for core in (cores[0], cores[-1]):
        ring = Ring(space="system", name=f"cp_numa{core}", core=core)
        ring.resize(1 << 24, 1 << 26)
        where = ring.page_nodes()
        node = affinity.core_node(core)
        if ring.core != core or (where is not None and node is not None and
                                 f"prefer:{node}" not in where[1]):
            raise AssertionError(f"Ring(core={core}): core {ring.core}, "
                                 f"pages and policy {where}")
        placed.append((core, node, "no NUMA maps" if where is None
                       else (where[0], sorted(where[1]))))
        del ring
    phase("capture", f"(g) Python entries of the capture engine: "
          f"{len(entries)} ({entries}) in {nwindow} slot windows of 16 "
          f"frames ({nent} frames, stats {st}): "
          f"{len(entries) / nwindow:.5f} a window; Ring(core=c) host "
          f"pages (core, its node, (pages by node, policies) or why "
          f"not read): {placed}")
    return out


def cp_ring_stream():
    """(h) verify/SKILL.md's ring-streaming sanity on the engine:
    CP_STREAM_NBYTE through a CP_STREAM_RING-byte host ring, a writer
    thread filling CP_STREAM_GULP-byte spans with a counter and a
    guaranteed reader checking every byte of each."""
    from bifrost_tpu_torch.ring import Ring
    width = 4096
    gulp = CP_STREAM_GULP // width
    ngulp = CP_STREAM_NBYTE // CP_STREAM_GULP
    ring = Ring(space="system", name="cp_stream")
    hdr = {"name": "stream", "_tensor": {"dtype": "u8",
                                         "shape": [-1, width]}}
    ring.begin_writing()
    wseq = ring.begin_sequence(hdr, gulp, CP_STREAM_RING // width)
    iseq = ring.open_sequence("earliest", guarantee=True)

    def writer():
        for i in range(ngulp):
            with wseq.reserve(gulp) as sp:
                sp.data.fill_(i % 251)
        wseq.end()
        ring.end_writing()

    t0 = time.perf_counter()
    th = threading.Thread(target=writer, daemon=True)
    th.start()
    bad = nread = 0
    for i, sp in enumerate(iseq.read(gulp)):
        # Eight bytes a compare: each word must hold the gulp's byte
        # eight times over.
        d = sp.data.reshape(-1).view(torch.int64)
        bad += int((d != (i % 251) * 0x0101010101010101).sum())
        nread += d.numel() * 8
    th.join(60)
    wall = time.perf_counter() - t0
    iseq.close()
    if bad or nread != CP_STREAM_NBYTE or th.is_alive():
        raise AssertionError(f"ring streaming: {nread} bytes read, {bad} "
                             f"wrong")
    phase("capture", f"(h) ring streaming on the engine: {nread} bytes "
          f"through a {ring.capacity}-byte host ring in "
          f"{CP_STREAM_GULP}-byte spans, every byte checked: "
          f"{nread / wall / 1e9:.3f} GB/s ({wall:.2f} s)")


def cp_i4_path(dev):
    """(e) The FRB search fed i4 packets (module docstring, phase 13):
    seeded noise in [-8, 3] with a dispersed burst of 4 (so every value
    fits i4) on CP_I4_NGULP gulps of 4096 channels, packed two a byte,
    MSB-first.  -> launch counts."""
    from bifrost_tpu_torch.blocks.testing import inject_burst
    from bifrost_tpu_torch.service import (Service, frb_search_pipeline,
                                           frb_search_spec)
    rng = np.random.default_rng(SEED + 4)
    nframe = CP_I4_NGULP * GULP
    vals = rng.integers(-8, 4, (nframe, NCHAN)).astype(np.int8)
    inject_burst(vals, GULP + GULP // 3, DM_ROW, F0, DF, amp=4)
    packed = ((vals[:, 0::2] & 0xF).astype(np.uint8) << 4) | \
        (vals[:, 1::2] & 0xF).astype(np.uint8)
    npkt = nframe * CP_I4_NSRC
    slab, recs = cp_packets(packed, CP_I4_NSRC, CP_RATES[0])
    rx, rcvbuf = cp_socket()
    cands = []
    svc = Service(frb_search_spec(
        rx, CP_I4_NSRC, CP_I4_PAYLOAD, buffer_ntime=8192, slot_ntime=16,
        gulp_nframe=GULP, max_delay=MAX_DELAY, f0_mhz=F0, df_mhz=DF,
        dt_s=DT, packet_dtype="i4", on_candidate=cands.append),
        name="cp_i4", device=dev)
    reset_counts()
    r = cp_drive(svc, svc.blocks["capture"], rx, slab, recs)
    counts = read_counts()
    st, rep = r["stats"], r["report"]
    nsteps = len(svc.blocks["fdmt"].fdmt._steps)
    if st != {"ngood": npkt, "nmissing": 0, "ninvalid": 0, "nlate": 0,
              "nrepeat": 0} or rep.exit_code != 0 or \
            rep.ledger["lost_frames"] or \
            counts != expected(fdmt_merge_step=nsteps * CP_I4_NGULP):
        raise AssertionError(f"i4 capture: stats {st}, launches {counts}, "
                             f"{rep!r}")
    ref = []
    frb_search_pipeline(vals, GULP, MAX_DELAY, F0, DF, DT, device=dev,
                        on_candidate=ref.append)[0].run()
    if not ref or [(c["frame"], c["dm_index"]) for c in cands] != \
            [(c["frame"], c["dm_index"]) for c in ref] or \
            any(abs(x["snr"] - y["snr"]) > 1e-5 * abs(y["snr"])
                for x, y in zip(cands, ref)):
        raise AssertionError(f"i4 candidates {cands} != replay {ref}")
    sent, ingested = cp_rates(r)
    phase("capture", f"(e) Service(frb_search_spec(rx, {CP_I4_NSRC}, "
          f"{CP_I4_PAYLOAD}, packet_dtype='i4')): stages "
          f"{[b.name for b in svc.pipeline.blocks]}; {nframe} frames of "
          f"{NCHAN} i4 ch as {npkt} packets of {12 + CP_I4_PAYLOAD} B "
          f"(SO_RCVBUF {rcvbuf} B): sent {sent:.1f}, ingested "
          f"{ingested:.1f} packets/s; stats {st}; ledger {rep.ledger}; "
          f"launches {counts}; {len(cands)} candidates equal to "
          f"frb_search_pipeline's on the same values as i8 (best "
          f"{max(cands, key=lambda c: c['snr'])})")
    del svc
    free_device()
    return counts


def xe_source(frames, nframe):
    """A source of `nframe` ci4 [time, freq, station, pol] frames in gulps
    of XE_GULP, replaying `frames` (uint8, one sample a byte) in turn."""
    import contextlib

    from bifrost_tpu_torch.pipeline import SourceBlock
    src = torch.from_numpy(frames)

    class Source(SourceBlock):
        def create_reader(self, name):
            @contextlib.contextmanager
            def reader():
                self.i = 0
                yield self
            return reader()

        def on_sequence(self, reader, name):
            return [{"name": name, "_tensor": {
                "dtype": "ci4", "shape": [-1] + list(src.shape[1:]),
                "labels": ["time", "freq", "station", "pol"],
                "scales": [[0.0, 1e-6], [0.0, 1.0], None, None],
                "units": ["s", None, None, None]}}]

        def on_data(self, reader, ospans):
            if self.i >= nframe:
                return [0]
            a = self.i % len(src)
            ospans[0].data.copy_(src[a:a + XE_GULP])
            self.i += XE_GULP
            return [XE_GULP]

    return Source(["ci4"], XE_GULP, name="xe_replay")


def discipline_flags(mode):
    """The config flags of an executor discipline: 'serialized'
    (strict_sync + serialize_dispatch), 'sync' (depth 1) or 'async'
    (depth AS_DEPTH)."""
    if mode == "serialized":
        return {"strict_sync": True, "serialize_dispatch": True}
    return {"pipeline_async_depth": AS_DEPTH if mode == "async" else 1}


def xe_run(dev, frames, nframe, topo, method=None, profile=False,
           discipline=None):
    """One X-engine run over `nframe` replayed frames: topo 'fused' or
    'unfused' (the raw head) or 'unpack' (the host unpack first).  -> dict
    of the visibility frames (on the card), the host clock when each was
    done, wall seconds, launch counts, the raw reads (count, bytes), each
    block's share of host seconds waiting in acquire and reserve and its
    executor depth; with `profile`, the run under torch.profiler (CPU and
    CUDA) and its blocks' host seconds by phase too ('prof', 'blocks').
    `discipline`: an executor discipline (discipline_flags) for the run."""
    import contextlib

    from bifrost_tpu_torch import block_scope, config
    from bifrost_tpu_torch.blocks import (callback_sink, copy, correlate,
                                          unpack)
    from bifrost_tpu_torch.pipeline import FusedTransformBlock, Pipeline
    outs, stamps = [], []

    def keep(a):
        outs.append(a.clone())
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    flags = dict(discipline_flags(discipline) if discipline else {})
    if method is not None:
        flags["xengine_method"] = method
    for k, v in flags.items():
        config.set(k, v)
    try:
        with Pipeline(device=dev) as pipe:
            src = xe_source(frames, nframe)
            if topo == "unpack":
                src = unpack(src)
            scope = block_scope(fuse=True) if topo == "fused" else \
                contextlib.nullcontext()
            with scope:
                x = correlate(copy(src, space="cuda"), XE_NINT,
                              engine="int8")
            callback_sink(x, on_data=keep, gulp_nframe=1)
            reset_counts()
            prof = xe_profiler() if profile else contextlib.nullcontext()
            with prof:
                t0 = time.perf_counter()
                pipe.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
    finally:
        for k in flags:
            config.reset(k)
    groups = [b for b in pipe.blocks if isinstance(b, FusedTransformBlock)]
    if bool(groups) != (topo == "fused"):
        raise AssertionError(f"{topo} run: fused groups {groups}")
    stall = {}
    for b in pipe.blocks:
        tot = sum(b.perf_totals.values())
        if tot > 0:
            stall[b.name] = round(100 * (b.perf_totals.get("acquire", 0) +
                                         b.perf_totals.get("reserve", 0)) /
                                  tot, 1)
    # The correlate block counts its storage-form reads fused (its raw
    # step, behind the group's H2D head) and unfused alike.
    run = {"outs": outs, "stamps": stamps, "wall": wall,
           "counts": read_counts(), "raw": (x._raw_reads, x._raw_read_nbyte),
           "stall": stall,
           "depths": {b.name: b._exec_async_depth for b in pipe.blocks}}
    if profile:
        run["prof"] = prof
        run["blocks"] = {b.name: dict(b.perf_totals) for b in pipe.blocks}
    return run


def xe_profiler():
    """torch.profiler over CPU and CUDA, recording the host ops of every
    thread (the pipeline's blocks run on their own) where this PyTorch
    offers it."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return torch.profiler.profile(activities=acts)
    return torch.profiler.profile(activities=acts, experimental_config=cfg)


def xe_trace_summary(run, ngulp):
    """Where one profiled X-engine run's time went, read from the
    profiler's Chrome trace (written to traces/xengine_trace.json)
    over the steady window from the first gulp's X1 tiles kernel to the
    last's (ngulp - 1 gulps): the device's busy time there (the union of
    kernels, copies and sets) and idle share, its ms a gulp by kind (H2D,
    D2H, D2D, X1, other kernels), and each host thread's top-level ops
    with the most time (ms a gulp); and the blocks' host seconds by
    phase over the whole run -> dict."""
    path = Path("traces") / "xengine_trace.json"
    path.parent.mkdir(exist_ok=True)
    run["prof"].export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    dev_ev = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    tiles = sorted(e["ts"] for e in dev_ev if "tiles_kernel" in
                   e.get("name", ""))
    out = {"gulps": ngulp, "wall_ms_a_gulp": run["wall"] * 1e3 / ngulp,
           "x1_tiles_launches_traced": len(tiles)}
    if len(tiles) >= 2:
        lo, hi = tiles[0], tiles[-1]
        n = len(tiles) - 1

        def clip(e):
            return max(0.0, min(e["ts"] + e["dur"], hi) - max(e["ts"], lo))
        kinds = {}
        for e in dev_ev:
            name = e.get("name", "")
            if e["cat"] == "kernel":
                k = "X1" if ("corner_turn" in name or "tiles_kernel" in
                             name) else "other kernels"
            elif e["cat"] == "gpu_memset":
                k = "memset"
            else:
                k = next((d for d in ("HtoD", "DtoH", "DtoD") if d in name),
                         "memcpy")
            kinds[k] = kinds.get(k, 0.0) + clip(e) / 1e3 / n
        busy, end = 0.0, lo
        for a, b in sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                           for e in dev_ev):
            if b > max(a, end):
                busy += b - max(a, end)
                end = b
        host = {}
        for tid in sorted({e["tid"] for e in events
                           if e.get("cat") == "cpu_op"}, key=str):
            tops, end = {}, None
            for e in sorted((e for e in events if e.get("cat") == "cpu_op"
                             and e["tid"] == tid), key=lambda e: e["ts"]):
                if end is not None and e["ts"] < end:
                    continue          # nested in a top-level op
                end = e["ts"] + e["dur"]
                tops[e["name"]] = tops.get(e["name"], 0.0) + clip(e) / 1e3 / n
            top = sorted(((k, round(v, 4)) for k, v in tops.items()
                          if v > 0.01), key=lambda kv: -kv[1])[:4]
            if top:
                host[f"thread {tid}"] = dict(top)
        out.update({"steady_ms_a_gulp": (hi - lo) / 1e3 / n,
                    "device_busy_ms_a_gulp": busy / 1e3 / n,
                    "idle_share": 1 - busy / (hi - lo),
                    "device_ms_a_gulp": {k: round(v, 4)
                                         for k, v in kinds.items()},
                    "host_top_level_ms_a_gulp": host})
    out["blocks_host_s"] = {b: {k: round(v, 4) for k, v in t.items()}
                            for b, t in run["blocks"].items()}
    return out


def xe_golden(frames, chans):
    """The first integration's visibilities on `chans`, exact: the int8
    planes as f64 (every partial sum an integer below 2**53), held as
    int64 -> {chan: (vr, vi)}."""
    out = {}
    for c in chans:
        b = frames[:XE_NINT, c].reshape(XE_NINT, -1).view(np.int8)
        re = (b >> 4).astype(np.float64)
        im = ((b << 4).astype(np.int8) >> 4).astype(np.float64)
        out[c] = (np.rint(re.T @ re + im.T @ im).astype(np.int64),
                  np.rint(re.T @ im - im.T @ re).astype(np.int64))
    return out


def xe_frames():
    """[xengine]'s seeded ci4 frames (also [async]'s and [map]'s)."""
    rng = np.random.default_rng(SEED + 12)
    return rng.integers(0, 256, (XE_DISTINCT, XE_NCHAN, XE_NSTAND,
                                 XE_NPOL), dtype=np.uint8)


def xengine_path(dev, kind, volt):
    """The int8 X-engine paths (module docstring, phase 14).  `volt`:
    [bengine]'s voltages.  -> launch counts by path."""
    from bifrost_tpu_torch import config
    from bifrost_tpu_torch.service import lwa_beam_search_pipeline
    nsp = XE_NSTAND * XE_NPOL
    out = {}

    # (a) The channelized ci4 correlator.
    t0 = time.perf_counter()
    frames = xe_frames()
    nframe = XE_DISTINCT * XE_REPLAY
    ngulp, nint = nframe // XE_GULP, nframe // XE_NINT
    phase("xengine", f"voltages: {frames.nbytes / 2**30:.2f} GiB of ci4 "
          f"({XE_DISTINCT} frames of {XE_NCHAN} x {nsp}), replayed "
          f"{XE_REPLAY} times; {time.perf_counter() - t0:.1f} s")
    runs = {topo: xe_run(dev, frames, nframe, topo)
            for topo in ("fused", "unfused")}
    cut = XE_CUT * XE_NINT
    runs["unpack"] = xe_run(dev, frames, cut, "unpack")
    runs["plain"] = xe_run(dev, frames, cut, "unfused", method="plain")
    ref = runs["fused"]["outs"]
    if len(ref) != nint or len(runs["unfused"]["outs"]) != nint:
        raise AssertionError(f"{len(ref)} visibility frames, expected "
                             f"{nint}")
    for topo, r in runs.items():
        for k, v in enumerate(r["outs"]):
            if v.shape != (1, XE_NCHAN, XE_NSTAND, XE_NPOL, XE_NSTAND,
                           XE_NPOL) or \
                    not bits_equal(torch.view_as_real(v),
                                   torch.view_as_real(ref[k])):
                raise AssertionError(f"xengine {topo} frame {k} differs "
                                     f"from the fused run's")
    first = ref[0][0].reshape(XE_NCHAN, nsp, nsp)
    for c, (vr, vi) in xe_golden(frames, XE_GOLDEN_CHANS).items():
        v = first[c].cpu()
        if not (np.array_equal(v.real.numpy().astype(np.int64), vr) and
                np.array_equal(v.imag.numpy().astype(np.int64), vi) and
                np.array_equal(v.real.numpy(), vr.astype(np.float32))):
            raise AssertionError(f"xengine: channel {c} differs from the "
                                 f"int64 golden")
    want = {"fused": expected(xengine_int8=ngulp),
            "unfused": expected(xengine_int8=ngulp),
            "unpack": expected(xengine_int8=cut // XE_GULP),
            "plain": expected()}
    rate = {}
    for topo, r in runs.items():
        if r["counts"] != want[topo]:
            raise AssertionError(f"xengine {topo}: launches {r['counts']}, "
                                 f"expected {want[topo]}")
        st = r["stamps"]
        rate[topo] = ((len(st) - 1) * XE_NINT / (st[-1] - st[0]),
                      len(r["outs"]) * XE_NINT / r["wall"])
        out[f"xengine_{topo}"] = r["counts"]
    nbyte = {"fused": nframe * XE_NCHAN * nsp,
             "unfused": nframe * XE_NCHAN * nsp,
             "unpack": 2 * cut * XE_NCHAN * nsp,
             "plain": cut * XE_NCHAN * nsp}
    for topo, r in runs.items():
        if r["raw"] != (nbyte[topo] // (XE_GULP * XE_NCHAN * nsp *
                                       (2 if topo == "unpack" else 1)),
                        nbyte[topo]):
            raise AssertionError(f"xengine {topo}: raw reads {r['raw']}")
    phase("xengine", f"(a) ci4 correlator {XE_NCHAN} ch x {nsp} inputs, "
          f"gulp {XE_GULP}, {XE_NINT} frames an integration, {nframe} "
          f"frames: fused, unfused and (first {XE_CUT} integrations) "
          f"host-unpack and xengine_method='plain' runs bitwise equal; "
          f"integration 0 on channels {XE_GOLDEN_CHANS} bitwise the int64 "
          f"golden; frames/s (steady, whole) "
          f"{ {k: (round(a, 1), round(b, 1)) for k, (a, b) in rate.items()} }"
          f"; raw reads (gulps, bytes) "
          f"{ {k: r['raw'] for k, r in runs.items()} }; X1 launches "
          f"{ {k: r['counts']['xengine_int8'] for k, r in runs.items()} }; "
          f"{kind}")

    # The fused raw head again, under torch.profiler: where a gulp's time
    # goes (H2D, X1, the chunk add, the host).
    ntr = XE_TRACE_NINT * XE_NINT
    tr = xe_run(dev, frames, ntr, "fused", profile=True)
    if tr["counts"] != expected(xengine_int8=ntr // XE_GULP) or \
            len(tr["outs"]) != XE_TRACE_NINT or \
            not all(bits_equal(torch.view_as_real(v),
                               torch.view_as_real(ref[k]))
                    for k, v in enumerate(tr["outs"])):
        raise AssertionError(f"xengine trace run: launches {tr['counts']}, "
                             f"{len(tr['outs'])} frames, or differs")
    out["xengine_trace"] = tr["counts"]
    summary = xe_trace_summary(tr, ntr // XE_GULP)
    phase("xengine", f"(a) trace of the fused raw head, {XE_TRACE_NINT} "
          f"integrations ({ntr // XE_GULP} gulps) under torch.profiler, "
          f"bitwise the fused run's: {json.dumps(summary)}; {kind}")
    del tr
    del runs, ref, first, frames
    free_device()

    # (b) The ci4 F-engine against its ci8 twin.
    v8 = volt[:FE_NINT * B_GULP]
    v4 = ((v8[..., 0] & 0xF).astype(np.uint8) << 4) | \
        (v8[..., 1] & 0xF).astype(np.uint8)
    beams, counts, vec = {}, {}, {}
    for name, v in (("ci4", v4), ("ci8", v8)):
        got = {"beams": []}
        pipe = lwa_beam_search_pipeline(
            v, nstand=NSTAND, npol=NPOL, nchan=BCHAN, ntap=NTAP,
            n_int=N_INT, nbeam=NBEAM, max_delay=B_MAX_DELAY, f0_mhz=B_F0,
            dt_s=B_DT, gulp_nframe=B_GULP, device=dev, gather=got,
            fuse=False, voltage_dtype=name)[0]
        reset_counts()
        t0 = time.perf_counter()
        pipe.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = read_counts()
        vec[name] = check_vectors(counts[name], "fir_mac")
        beams[name] = np.concatenate(got["beams"])
        out[f"fengine_{name}"] = counts[name]
        phase("xengine", f"(b) beam search on {FE_NINT} integrations of "
              f"{name} voltages: {wall:.2f} s, launches {counts[name]}")
        del pipe, got
        free_device()
    if counts["ci4"] != counts["ci8"] or \
            counts["ci4"]["fir_mac"] != FE_NINT or \
            counts["ci4"]["beamform_power"] != FE_NINT or \
            vec["ci4"] != FE_NINT or \
            beams["ci4"].shape != (FE_NINT, NBEAM, BCHAN) or \
            not np.array_equal(beams["ci4"].view(np.int32),
                               beams["ci8"].view(np.int32)):
        raise AssertionError(f"ci4 F-engine: launches {counts}, vector "
                             f"{vec}, beams equal "
                             f"{np.array_equal(beams['ci4'], beams['ci8'])}")
    phase("xengine", f"(b) ci4 F-engine: {FE_NINT} x {NBEAM} x {BCHAN} beam "
          f"powers bitwise the ci8 run's; K2 and K4 {FE_NINT} launches "
          f"each, every K2 launch vector, as ci8")

    # (c) The instrument with the int8 X-engine against xengine 'plain'.
    v = volt[:XI_NINT * B_GULP]
    imgs, icounts = {}, {}
    for method in (None, "plain"):
        im = Images(XI_NINT)
        if method is not None:
            config.set("xengine_method", method)
        try:
            pipe = instrument(dev, v, on_image=im, engine="int8")[0]
            reset_counts()
            t0 = time.perf_counter()
            pipe.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            if method is not None:
                config.reset("xengine_method")
        key = "instrument_int8" + ("_plain" if method else "")
        icounts[key], imgs[key] = read_counts(), im
        out[key] = icounts[key]
        del pipe
        free_device()
        phase("xengine", f"(c) {key}: {XI_NINT} integrations, {wall:.2f} "
              f"s, launches {icounts[key]}")
    common = dict(fir_mac=XI_NINT, beamform_power=XI_NINT,
                  romein_grid_separable=XI_NINT)
    if icounts["instrument_int8"] != expected(xengine_int8=XI_NINT,
                                              **common) or \
            icounts["instrument_int8_plain"] != expected(**common):
        raise AssertionError(f"int8 instrument launches {icounts}")
    images_equal(imgs["instrument_int8"], imgs["instrument_int8_plain"],
                 XI_NINT)
    phase("xengine", f"(c) instrument engine='int8': {XI_NINT} images "
          f"bitwise the xengine_method='plain' run's; X1 {XI_NINT} "
          f"launches, K6b {XI_NINT}")
    return out


def fir_run(dev, volt, nframe, gulp, decim, coeffs, method=None,
            fuse=False):
    """One FirBlock run over the first `nframe` of [bengine]'s voltages,
    array_source -> copy('cuda') -> fir (in a fuse scope when `fuse`) ->
    callback_sink on the card.  -> dict of the output gulps (on the
    card), the host clock when each was done, wall seconds, launch counts
    and the raw reads (count, bytes)."""
    import contextlib

    from bifrost_tpu_torch import block_scope
    from bifrost_tpu_torch.blocks import (array_source, callback_sink, copy,
                                          fir)
    from bifrost_tpu_torch.pipeline import FusedTransformBlock, Pipeline
    outs, stamps = [], []

    def keep(a):
        outs.append(a.clone())
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    with Pipeline(device=dev) as pipe:
        src = array_source(volt[:nframe], gulp, header={
            "dtype": "ci8", "labels": ["time", "station", "pol"],
            "scales": [[0.0, B_DT], None, None],
            "units": ["s", None, None]})
        with block_scope(fuse=True) if fuse else contextlib.nullcontext():
            f = fir(copy(src, space="cuda"), coeffs, decim=decim,
                    method=method)
        callback_sink(f, on_data=keep)
        reset_counts()
        t0 = time.perf_counter()
        pipe.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = [b for b in pipe.blocks if isinstance(b, FusedTransformBlock)]
    if bool(groups) != fuse:
        raise AssertionError(f"fir run (fuse {fuse}): groups {groups}")
    # The FIR block counts its storage-form reads fused (its raw step,
    # behind the group's H2D head) and unfused alike.
    return {"outs": outs, "stamps": stamps, "wall": wall,
            "counts": read_counts(), "raw": (f._raw_reads, f._raw_read_nbyte)}


def fir_golden(volt, coeffs, decim, nout, chans):
    """The first `nout` outputs of the FIR on flat channels `chans` of
    the ci8 voltages, from a zero history, in f64, and the magnitude
    filter M (sum |x| |c|, the scale of the f32 rounding bound)."""
    ntap = coeffs.shape[0]
    n = nout * decim
    v = volt[:n].reshape(n, -1, 2)[:, chans].astype(np.float64)
    x = np.concatenate([np.zeros((ntap - 1,) + v.shape[1:]), v])
    c = coeffs[:, chans].astype(np.float32).astype(np.float64)[..., None]
    y = sum(x[k:k + n] * c[ntap - 1 - k] for k in range(ntap))
    m = sum(np.abs(x[k:k + n]) * np.abs(c[ntap - 1 - k])
            for k in range(ntap))
    return y[::decim], m[::decim]


def fir_path(dev, kind, volt, at_fir):
    """The streaming FIR (module docstring, phase 15).  `volt`:
    [bengine]'s voltages; `at_fir`: check_fir16's timings.  -> launch
    counts by path."""
    nsp = NSTAND * NPOL
    rng = np.random.default_rng(SEED + 14)
    coeffs = rng.standard_normal((FIR_NTAP, nsp))
    nframe = FIR_NGULP * B_GULP
    chans, ng = np.array(FIR_GOLDEN_CHANS), FIR_GOLDEN_NOUT
    out = {}
    for decim in FIR_DECIMS:
        nout = nframe // decim
        runs = {"unfused": fir_run(dev, volt, nframe, B_GULP, decim,
                                   coeffs)}
        ref = torch.cat(runs["unfused"]["outs"])
        if ref.shape != (nout, NSTAND, NPOL) or \
                ref.dtype != torch.complex64 or \
                not bool(torch.isfinite(torch.view_as_real(ref)).all()):
            raise AssertionError(f"fir decim {decim}: output {ref.shape} "
                                 f"{ref.dtype}")
        g, m = fir_golden(volt, coeffs, decim, ng, chans)
        y = ref[:ng].reshape(ng, -1)[:, chans].cpu().numpy()
        err = np.maximum(np.abs(y.real - g[..., 0]), np.abs(y.imag -
                                                          g[..., 1]))
        if not np.all(err <= 2 * FIR_NTAP * 2.0 ** -24 * m.max(-1)):
            raise AssertionError(f"fir decim {decim}: beyond the f32 "
                                 f"rounding bound of the f64 golden")
        for name, kw in (("plain", dict(method="plain")),
                         ("long", dict(gulp=FIR_LONG * B_GULP)),
                         ("fused", dict(fuse=True))):
            gulp = kw.pop("gulp", B_GULP)
            runs[name] = fir_run(dev, volt, nframe, gulp, decim, coeffs,
                                 **kw)
            got = torch.cat(runs[name]["outs"])
            if not bits_equal(torch.view_as_real(got),
                              torch.view_as_real(ref)):
                raise AssertionError(f"fir decim {decim}: the {name} run "
                                     f"differs from the unfused run")
            del got
            runs[name]["outs"] = None
        want = {"unfused": FIR_NGULP, "fused": FIR_NGULP, "plain": 0,
                "long": FIR_NGULP // FIR_LONG}
        tag = "fir" if decim == 1 else f"fir_decim{decim}"
        for name, r in runs.items():
            if r["counts"] != expected(fir_mac=want[name]):
                raise AssertionError(f"fir decim {decim} {name}: launches "
                                     f"{r['counts']}")
            nreads = FIR_NGULP // FIR_LONG if name == "long" else FIR_NGULP
            if r["raw"] != (nreads, nframe * nsp * 2):
                raise AssertionError(f"fir decim {decim} {name}: raw reads "
                                     f"{r['raw']}")
            out[tag + ("" if name == "unfused" else f"_{name}")] = \
                r["counts"]
        reset_counts()
        runs["unfused"]["outs"] = None
        st = runs["unfused"]["stamps"]
        rates = {k: round(nframe / r["wall"], 1) for k, r in runs.items()}
        t = at_fir[f"decim{decim}"]
        phase("fir", f"FirBlock, ci8 {NSTAND} x {NPOL} read raw from the "
              f"'cuda' ring ({2 * nsp} lanes), {FIR_NTAP} taps, decim "
              f"{decim}, {FIR_NGULP} gulps of {B_GULP} frames: bitwise the "
              f"'plain' run on the card, {FIR_NGULP // FIR_LONG} gulps of "
              f"{FIR_LONG * B_GULP} and the fused group (K2 launches equal, "
              f"{want['fused']}), the first {ng} outputs within 2 ntap u M "
              f"of an f64 golden on channels {chans.tolist()}; K2 launches "
              f"{ {k: r['counts']['fir_mac'] for k, r in runs.items()} }, "
              f"every one vector; frames/s whole {rates}, steady "
              f"{(len(st) - 1) * B_GULP / (st[-1] - st[0]):.1f}; K2 at "
              f"this shape (check_fir16): {t['ms']:.4f} ms a gulp, "
              f"{100 * t['share_of_bound']:.1f} % of its {t['bound_ms']:.4f} "
              f"ms bound, F.conv1d {t['library_ms']:.4f} ms; {kind}")
        del runs, ref
        free_device()
    return out


def ptxas_kernels(text):
    """{mangled kernel: (registers, spill-store bytes)} from ptxas -v."""
    import re
    out, kernel = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            kernel = m.group(1)
            out[kernel] = [None, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and kernel:
            out[kernel][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and kernel:
            out[kernel][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def map_program_info():
    """nvcc's seconds (0.0 where the library was on disk) and ptxas's
    registers and spill stores of each generated M1 library loaded in
    this process, by index type -> {name: (seconds, {'int32': (registers,
    spill bytes), 'int64': ...})}."""
    from bifrost_tpu_torch import build
    out = {}
    for e in build.generated_log:
        if e["kind"] != "cuda":
            continue
        ks = ptxas_kernels(e["ptxas"])
        out[e["name"]] = (round(e["seconds"], 2), {
            pre + idx: next((v for k, v in ks.items()
                             if f"{kern}I{c}E" in k), (None, None))
            for idx, c in (("int32", "i"), ("int64", "x"))
            for pre, kern in (("", "map_kernel"), ("tile_", "map_tile"))})
    return out


# [map]'s timed forms at the gulp (B_GULP, NSTAND, NPOL): (tag, program,
# axis names, input name, input DataType (None: a logical tensor),
# logical rank, bytes in and out a sample, f32 operations a sample,
# bitwise its plain version).  ci8 and the stencil are the main programs,
# on [bengine]'s voltages read raw, as are the forward and the unbounded
# (time reversal) programs (M1's element path).
MAP_FORMS = (
    ("ci8", MAP_FUNC, None, None, "ci8", 3, 2, 8, 14, True),
    ("stencil", MAP_STENCIL, MAP_AXES, None, "ci8", 3, 2, 8, 2, True),
    ("forward", MAP_FORWARD, MAP_AXES, None, "ci8", 3, 2, 8, 2, True),
    ("reverse", MAP_REVERSE, MAP_AXES, None, "ci8", 3, 2, 8, 0, True),
    ("f16", MAP_HALF_FUNC, None, "v", None, 3, 2, 2, 4, True),
    ("bf16", MAP_HALF_FUNC, None, "v", None, 3, 2, 2, 4, True),
    ("ci2", MAP_CPK_FUNC, None, "v", "ci2", 2, 0.5, 8, 10, True),
    ("ci1", MAP_CPK_FUNC, None, "v", "ci1", 2, 0.25, 8, 10, True),
    ("csqrt", "y = sqrt(v)", None, "v", None, 3, 8, 8, 0, False),
)


def map_form_inputs(dev, raw):
    """The input of each of MAP_FORMS: `raw` (the ci8 gulp) for the main
    programs, seeded tensors on the card for the rest (f16 and bf16 of
    3 sigma, ci2 and ci1 bytes, complex64 of |z| in (0.1, 10))."""
    shape = (B_GULP, NSTAND, NPOL)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 16)
    x = {"ci8": raw, "stencil": raw, "forward": raw, "reverse": raw}
    for tag, dt in (("f16", torch.float16), ("bf16", torch.bfloat16)):
        x[tag] = (torch.randn(shape, device=dev, generator=gen) * 3).to(dt)
    for tag, nbit in (("ci2", 2), ("ci1", 1)):
        x[tag] = torch.randint(0, 256, (B_GULP, NSTAND * NPOL * nbit // 4),
                               device=dev, generator=gen, dtype=torch.uint8)
    x["csqrt"] = torch.polar(torch.exp(torch.empty(shape, device=dev).uniform_(
        np.log(0.1), np.log(10), generator=gen)),
        torch.empty(shape, device=dev).uniform_(-np.pi, np.pi,
                                                generator=gen))
    return x


def map_programs(inputs):
    """MAP_FORMS' programs -> {tag: (Map, Program)}."""
    from bifrost_tpu_torch.ops.map import Map
    out = {}
    for tag, func, axes, in_name, dt, rank, *_ in MAP_FORMS:
        op = Map(func, axis_names=axes, in_name=in_name)
        out[tag] = (op, op.program(dt if dt is not None else
                                   inputs[tag].dtype, rank))
    return out


def time_map_form(dev, kind, form, op, prog, x):
    """One of MAP_FORMS: M1 (one launch) against its plain version
    (bitwise, or within MAP_CX_ULP), timed with the plain version and
    its bound -> record {ms, plain_ms, bound_ms, bound_by, share, path,
    vec, index, registers, spill_bytes, err}, M1's output)."""
    from bifrost_tpu_torch.ops import map_kernel
    tag, _, _, _, _, _, in_b, out_b, ops, exact = form
    out_shape = map_kernel.logical_shape(x, prog.inputs[0])
    carry = op.carry_init(out_shape[1:], prog.inputs[0].dtype, dev) \
        if op.fuse_form == "stencil" else None
    before = map_kernel.map_apply.launches
    got, gc = map_kernel.map_apply(prog, [x], out_shape, [], carry)
    if map_kernel.map_apply.launches != before + 1:
        raise AssertionError(f"map {tag}: not one M1 launch")
    plan = dict(map_kernel.map_apply.last)
    want, wc = map_kernel.map_apply_plain(prog, [x], out_shape, [], carry)
    torch.cuda.synchronize()
    g, w = got[0], want[0]
    abs_err = max_abs_diff(g, w)
    if gc is not None:
        abs_err = max(abs_err, max_abs_diff(gc, wc))
    if exact:
        if not bits_equal(g.view(torch.uint8), w.view(torch.uint8)) or (
                gc is not None and not bits_equal(gc.view(torch.uint8),
                                                  wc.view(torch.uint8))):
            raise AssertionError(f"M1 ({tag}) differs from its plain "
                                 f"version")
        err = 0.0
    else:
        err = cx_ulps(g, w, x)
        if not err <= MAP_CX_ULP:
            raise AssertionError(f"M1 ({tag}): {err} ulps")
    outs = [g]
    ms = cuda_time(lambda: map_kernel.map_apply(prog, [x], out_shape, [],
                                                carry, outs), 20)
    plain_ms = cuda_time(lambda: map_kernel.map_apply_plain(
        prog, [x], out_shape, [], carry), 5)
    nsamp = math.prod(out_shape)
    bound_ms, by = bound(nsamp * (in_b + out_b), nsamp * ops,
                         hbm_rate(kind))
    regs, spill = map_program_info().get(prog.name, (0, {}))[1].get(
        plan["index"], (None, None))
    del got, want, w
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "share": bound_ms / ms, "path": plan["path"],
            "vec": plan["vec"], "index": plan["index"],
            "grid": plan["grid"], "block": plan["block"],
            "registers": regs, "spill_bytes": spill, "err": err,
            "max_abs_err": abs_err}, g


def max_abs_diff(got, want):
    """max |got - want| over every component, in f64."""
    g = torch.view_as_real(got) if got.is_complex() else got
    w = torch.view_as_real(want) if want.is_complex() else want
    return float((g.double() - w.double()).abs().max())


def map_form_line(tag, form, r):
    err = "bitwise" if form[-1] else f"{r['err']:.2f} ulps"
    return (f"{tag} {form[1]!r}: {err}; {r['path']} path, V {r['vec']}, "
            f"{r['index']} ({r['registers']} registers, "
            f"{r['spill_bytes']} B spilled; grid {r['grid']} x block "
            f"{r['block']}); {r['ms']:.4f} ms a gulp, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {100 * r['share']:.1f} % of it")


def check_map(dev, kind, volt):
    """M1 at the [map] phase's main-path shape: one gulp of B_GULP frames
    of [bengine]'s ci8 voltages (NSTAND x NPOL) read raw through
    MAP_FUNC and the stencil, against their plain version (bitwise: the
    input is integer-exact), each on the vector path and 32-bit indices;
    M1's ms a gulp by CUDA events, the plain version's, the bytes bound
    (2 B in and 8 B out a sample); an i4 stencil read packed, and no
    silent fall back.  Builds every [map] program in parallel first (one
    nvcc each, the eager explicit-index and scatter programs of
    map_eager_calls among them) and runs check_map_new_forms and
    check_map_eager."""
    from concurrent.futures import ThreadPoolExecutor

    from bifrost_tpu_torch.ops import map_kernel
    from bifrost_tpu_torch.ops.map import Map, map as eager_map
    raw = torch.from_numpy(volt[:B_GULP]).to(dev)
    inputs = map_form_inputs(dev, raw)
    progs = map_programs(inputs)
    op4 = Map("y(t,c) = x(t,c) * 3 - x(t-1, c+1)", axis_names=("t", "c"))
    prog4 = op4.program("i4", 2)
    zq = inputs["csqrt"][:B_GULP // 4]
    cx_func = "; ".join(f"{fn}_ = {fn}(v)" for fn in MAP_CX_FUNCS)
    # map_path's ci4 chain (its frames [time, freq, station, pol]) builds
    # here too, and the eager explicit-index and scatter programs
    eager = map_eager_calls(raw)
    extra = [prog4, Map(MAP_FUNC).program("ci4", 4)] + [
        e["program"][0] for e in eager.values()]
    with ThreadPoolExecutor(len(progs) + len(extra) + 1) as pool:
        builds = [pool.submit(map_kernel.prepare, p) for p in
                  [p for _, p in progs.values()] + extra]
        before = map_kernel.map_apply.launches
        cx_got = pool.submit(eager_map, cx_func, {"v": zq})
        for b in builds:
            b.result()
        cx_got = cx_got.result()
    cx_launches = map_kernel.map_apply.launches - before
    recs = {}
    for form in MAP_FORMS[:2]:
        tag = form[0]
        recs[tag] = time_map_form(dev, kind, form, *progs[tag], raw)[0]
        if recs[tag]["path"] != "vector" or recs[tag]["index"] != "int32":
            raise AssertionError(f"M1 ({tag}): {recs[tag]['path']} path, "
                                 f"{recs[tag]['index']}")
    # Packed real storage read in the kernel (an i4 stencil, bitwise),
    # and no silent fall back: a program M1 does not implement raises
    # for a card tensor under 'auto'.
    raw4 = torch.from_numpy(np.random.default_rng(SEED + 15).integers(
        0, 256, (4096, 256), dtype=np.uint8)).to(dev)
    carry = op4.carry_init((512,), torch.int8, dev)
    got, gc = map_kernel.map_apply(prog4, [raw4], (4096, 512), [], carry)
    want, wc = map_kernel.map_apply_plain(prog4, [raw4], (4096, 512), [],
                                          carry)
    if not (bits_equal(got[0], want[0]) and bits_equal(gc, wc)):
        raise AssertionError("M1 (i4 stencil) differs from its plain "
                             "version")
    i4_path = map_kernel.map_apply.last["path"]
    try:
        Map("y = Complex(v, v)").execute(raw4.half())
    except NotImplementedError:
        pass
    else:
        raise AssertionError("map: a program M1 does not implement ran on "
                             "the card")
    del raw4, got, want
    new = check_map_new_forms(dev, kind, progs, inputs, cx_func, cx_got,
                              cx_launches)
    new.update(check_map_eager(kind, eager))
    del eager
    phase("map", "map_apply (M1) against plain at "
          f"({B_GULP}, {NSTAND}, {NPOL}) ci8 read raw (64 MiB in, 256 MiB "
          f"out; tolerance: bitwise, integer-exact ci8): " +
          "; ".join(map_form_line(f[0], f, recs[f[0]])
                    for f in MAP_FORMS[:2]) +
          f"; library: none (no single PyTorch call computes a user "
          f"expression); an i4 stencil read packed bitwise its plain "
          f"version ({i4_path} path); 'auto' on a program M1 does not "
          f"implement (Complex of f16: complex32) raised; {kind}")
    ci8, st = recs["ci8"], recs["stencil"]
    rec = {"name": "map_apply", "route": "cuda",
           "source": "bifrost_tpu_torch/csrc/map_common.cuh",
           "replaces": "bifrost_tpu/ops/map.py:421",
           "launches": None, "max_abs_err": None, "ms": ci8["ms"],
           "plain_ms": ci8["plain_ms"], "bound_ms": ci8["bound_ms"],
           "bound_by": ci8["bound_by"], "library_ms": None,
           "path": ci8["path"], "vec": ci8["vec"], "index": ci8["index"],
           "registers": ci8["registers"], "spill_bytes": ci8["spill_bytes"],
           "at_stencil_ms": st["ms"], "at_stencil": st}
    rec.update(new)
    # every timed form's max |M1 - plain| (csqrt's within MAP_CX_ULP)
    rec["max_abs_err"] = max(r["max_abs_err"] for r in
                             [ci8, st] + list(new.values()))
    return rec


def check_map_new_forms(dev, kind, progs, inputs, cx_func, cx_got,
                        cx_launches):
    """M1's half, packed-complex and complex-math forms of MAP_FORMS at
    [map]'s gulp shape: f16 and bf16, ci2 and ci1 bytes (bitwise their
    plain versions), `sqrt` on complex64 (within MAP_CX_ULP, timed beside
    `torch.sqrt` on the same tensor), each with its path, V, index type,
    registers and spills, ms, plain ms and bound; every complex
    transcendental of MAP_CX_FUNCS within MAP_CX_ULP at a quarter of the
    gulp, as the outputs of one eager call (`cx_got`, one launch).  ->
    {'at_<form>': record}."""
    from bifrost_tpu_torch import config
    from bifrost_tpu_torch.ops.map import map as eager_map
    zq = inputs["csqrt"][:B_GULP // 4]
    config.set("map_method", "plain")
    try:
        cx_want = eager_map(cx_func, {"v": zq})
    finally:
        config.reset("map_method")
    worst = {fn: round(cx_ulps(cx_got[f"{fn}_"], cx_want[f"{fn}_"], zq), 2)
             for fn in MAP_CX_FUNCS}
    if cx_launches != 1 or not max(worst.values()) <= MAP_CX_ULP:
        raise AssertionError(f"M1 complex transcendentals: {cx_launches} "
                             f"launches, ulps {worst}")
    del cx_got, cx_want, zq
    out, lines = {}, []
    for form in MAP_FORMS[2:]:
        tag = form[0]
        r, y = time_map_form(dev, kind, form, *progs[tag], inputs[tag])
        if tag == "csqrt":
            z = inputs[tag]
            zs = torch.empty_like(z)
            r["library_ms"] = cuda_time(lambda: torch.sqrt(z, out=zs), 20)
            r["bitwise_torch_sqrt"] = bool(bits_equal(
                zs.view(torch.uint8), y.view(torch.uint8)))
            r["ulps_torch_sqrt"] = cx_ulps(y, zs, z)
            (r["edge_ulps"], r["edge_ulps_torch_sqrt"],
             r["edge_nonfinite_torch_sqrt"]) = sqrt_edges_ulps(
                dev, progs[tag][1])
            del zs
        if tag == "reverse":
            # the nearest PyTorch call: the raw ci8 gulp reversed in time,
            # int8 pairs out (M1 writes complex64)
            x = inputs[tag]
            r["library_ms"] = cuda_time(lambda: torch.flip(x, [0]), 20)
        del y
        out[f"at_{tag}"] = r
        lines.append(map_form_line(tag, form, r) + (
            f"; torch.sqrt {r['library_ms']:.4f} ms (M1 bitwise it: "
            f"{r['bitwise_torch_sqrt']}, {r['ulps_torch_sqrt']:.2f} ulps; "
            f"at {len(MAP_SQRT_EDGES)} points at the ends of the f32 "
            f"range, against torch.sqrt in complex128: M1 "
            f"{r['edge_ulps']:.2f} ulps, torch.sqrt in complex64 "
            f"{r['edge_ulps_torch_sqrt']:.4g} where finite, not finite at "
            f"{r['edge_nonfinite_torch_sqrt']})"
            if tag == "csqrt" else
            f"; torch.flip(x, [0]) on the raw ci8 gulp {r['library_ms']:.4f}"
            f" ms (int8 out: 128 MiB moved against M1's 320 MiB)"
            if tag == "reverse" else ""))
    phase("map", f"forward, unbounded, half, packed-complex, complex-math "
          f"forms at ({B_GULP}, {NSTAND}, {NPOL}): " + "; ".join(lines) +
          f"; complex64 transcendentals (one eager call, one launch) vs "
          f"PyTorch's kernels, ulps of max(|z|, |w|) at |z| in (0.1, 10) "
          f"(limit {MAP_CX_ULP}): {worst}; {kind}")
    return out


def map_eager_calls(raw):
    """[map]'s eager explicit-index and scatter calls on one raw ci8 gulp
    -> {tag: {'func', 'data', 'shape', 'program': ops.map.eager_program's
    (Program, inputs, scalars, grid, outputs)}}: `a` the gulp as complex64
    (B_GULP, NSTAND * NPOL), `c` a zero target."""
    from bifrost_tpu_torch.ops.map import eager_program
    a = torch.complex(raw[..., 0].float(), raw[..., 1].float()).reshape(
        B_GULP, NSTAND * NPOL)
    n, m = a.shape
    calls = {"transpose": (MAP_TRANSPOSE, {"a": a}, (m, n)),
             "flip": (MAP_FLIP, {"a": a, "c": torch.zeros_like(a)}, (n, m)),
             "stranspose": (MAP_STRANSPOSE, {"a": a, "c": torch.zeros(
                 (m, n), dtype=a.dtype, device=a.device)}, (n, m)),
             "scatter": (MAP_SCATTER, {"a": a, "c": torch.zeros_like(a),
                                       "k": MAP_SCATTER_K}, (n, m))}
    return {tag: {"func": f, "data": d, "shape": sh,
                  "program": eager_program(f, d, ("i", "j"), sh)}
            for tag, (f, d, sh) in calls.items()}


def map_eager_written(tag, n, m):
    """Target elements the eager call `tag` writes (its scatter's
    winners; all for a gather)."""
    if tag != "scatter":
        return n * m
    return len({i // 2 + MAP_SCATTER_K for i in range(n)} & set(range(n))) * m


# Each eager call's path, scatter passes and launches (check_map_eager).
MAP_EAGER_PLANS = {"transpose": ("tile", (0,), 1),
                   "flip": ("vector", (3,), 1),
                   "stranspose": ("tile", (3,), 1),
                   "scatter": ("element", (1, 2), 2)}


def check_map_eager(kind, eager):
    """M1 on the eager transpose, band flip, transpose written as a
    scatter, and repeated-target scatter of `eager` (map_eager_calls) at
    one gulp: each bitwise the plain engine's eager call on the card, its
    path, passes and launches as MAP_EAGER_PLANS (the injective scatters
    one pass over the target: no copy of it, no owner words; the
    repeated-target scatter the owners, then the writes), ms by CUDA
    events (and replayed from a CUDA graph: the card's time without the
    host's), the plain call's ms, the bytes bound (each input element the
    call needs read once: a scatter's winning sources and the target
    elements it leaves, each output element written once) and its share,
    beside `a.t().contiguous()` and `torch.flip(a, [1])` (no single
    PyTorch call scatters with the last one's semantics) -> {'at_<tag>':
    record}."""
    from bifrost_tpu_torch import config
    from bifrost_tpu_torch.ops import map_kernel
    from bifrost_tpu_torch.ops.map import map as eager_map
    out, lines = {}, []
    info = map_program_info()
    for tag, e in eager.items():
        prog, ins, scal, grid, _ = e["program"]
        data, func, shape = e["data"], e["func"], e["shape"]
        a = data["a"]
        before = map_kernel.map_apply.launches
        got = map_kernel.map_apply(prog, ins, grid, scal)[0][0]
        n = map_kernel.map_apply.launches - before
        plan = dict(map_kernel.map_apply.last)
        scratch = dict(data, **({"c": data["c"].clone()} if "c" in data
                                else {}))
        config.set("map_method", "plain")
        try:
            want = eager_map(func, dict(scratch), axis_names=("i", "j"),
                             shape=shape)
            want = want.clone()
            plain_ms = cuda_time(lambda: eager_map(
                func, dict(scratch), axis_names=("i", "j"), shape=shape), 3)
        finally:
            config.reset("map_method")
        torch.cuda.synchronize()
        if not bits_equal(torch.view_as_real(got), torch.view_as_real(want)):
            raise AssertionError(f"M1 eager {tag} differs from the plain "
                                 f"engine")
        if (plan["path"], plan["passes"], n) != MAP_EAGER_PLANS[tag]:
            raise AssertionError(f"M1 eager {tag}: {plan['path']} path, "
                                 f"passes {plan['passes']}, {n} launches; "
                                 f"want {MAP_EAGER_PLANS[tag]}")
        del want, scratch
        ms = cuda_time(lambda: map_kernel.map_apply(prog, ins, grid, scal),
                       10)
        # the card's own time: the call replayed from a CUDA graph, its
        # host work (the launch words, the owners) left out; a measurement
        graph_ms = graph_time(
            lambda: map_kernel.map_apply(prog, ins, grid, scal), 10)
        libname, library = {
            "transpose": ("a.t().contiguous()", lambda: a.t().contiguous()),
            "stranspose": ("a.t().contiguous()",
                           lambda: a.t().contiguous()),
            "flip": ("torch.flip(a, [1])", lambda: torch.flip(a, [1]))}.get(
                tag, (None, None))
        library_ms = cuda_time(library, 10) if library else None
        nel, esz = a.numel(), a.element_size()
        written = map_eager_written(tag, *a.shape)
        nbytes = (written + (nel - written if prog.scatters else 0) +
                  nel) * esz
        bound_ms, by = bound(nbytes, 0, hbm_rate(kind))
        regs, spill = info.get(prog.name, (0, {}))[1].get(
            ("tile_" if plan["path"] == "tile" else "") + plan["index"],
            (None, None))
        r = {"ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": by, "share": bound_ms / ms,
             "library_ms": library_ms, "launches_a_call": n,
             "path": plan["path"], "passes": list(plan["passes"]),
             "scatter": plan["scatter"], "vec": plan["vec"],
             "index": plan["index"], "grid": plan["grid"],
             "block": plan["block"], "registers": regs,
             "spill_bytes": spill, "written": written, "max_abs_err": 0.0}
        out[f"at_{tag}"] = r
        lib = (f"{libname} {library_ms:.4f} ms" if library else
               "library: none (no PyTorch call scatters with these "
               "semantics)")
        lines.append(
            f"{tag} {func!r} over {shape}: bitwise, {n} launches "
            f"({r['path']} path, "
            f"{'passes ' + str(r['passes']) + ', ' if r['scatter'] else ''}"
            f"{r['index']}, {regs} registers, {spill} "
            f"B spilled; grid {r['grid']} x block {r['block']}); "
            f"{ms:.4f} ms a call ({graph_ms:.4f} from a CUDA graph), plain "
            f"{plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({by}, {nbytes / 2**20:.0f} MiB), "
            f"{100 * r['share']:.1f} % of it; {lib}")
        del got
    phase("map", f"eager explicit-index and scatter forms on one gulp as "
          f"complex64 {tuple(a.shape)} (256 MiB; the repeated scatter's "
          f"targets two sources a row, the sources of i >= "
          f"{2 * (B_GULP - MAP_SCATTER_K)} dropped): " + "; ".join(lines) +
          f"; {kind}")
    return out


def sqrt_edges_ulps(dev, prog):
    """M1's complex64 sqrt (`prog`, MAP_FORMS' csqrt) at MAP_SQRT_EDGES
    against torch.sqrt of the same points in complex128 on the card (the
    complex64 kernel overflows and loses subnormals there): finite,
    within MAP_CX_ULP complex64 ulps of max(|z|, |w|), taken in
    complex128. -> (M1's ulps, torch.sqrt's complex64 ulps where it is
    finite, the points where it is not)."""
    from bifrost_tpu_torch.ops import map_kernel
    rank = prog.inputs[0].rank
    z = torch.tensor([complex(a, b) for a, b in MAP_SQRT_EDGES],
                     dtype=torch.complex64, device=dev)
    z = z.reshape((1,) * (rank - 1) + (-1,))
    got = map_kernel.map_apply(prog, [z], tuple(z.shape), [], None)[0][0]
    z2 = z.to(torch.complex128)
    want = torch.sqrt(z2)
    scale = torch.maximum(z2.abs(), want.abs())[..., None]

    def ulps(y):
        d = (torch.view_as_real(y).double() - torch.view_as_real(want)).abs()
        ok = torch.isfinite(torch.view_as_real(y)).all(-1, keepdim=True)
        d = torch.where(ok, d / scale, 0.0)
        return float(d.max()) / 2.0 ** -24, int((~ok).sum())
    err, bad = ulps(got)
    if bad or not err <= MAP_CX_ULP:
        raise AssertionError(f"M1 complex64 sqrt at the ends of the f32 "
                             f"range: {got.tolist()} vs {want.tolist()}")
    return (err,) + ulps(torch.sqrt(z))


def cx_ulps(got, want, z):
    """max |got - want| in complex64 ulps of max(|z|, |want|)."""
    scale = torch.maximum(z.abs(), want.abs()).double()[..., None]
    d = (torch.view_as_real(got).double() -
         torch.view_as_real(want).double()).abs() / scale
    return float(d.max()) / 2.0 ** -24


def map_run(dev, source, func, axes=None, fuse=False, detect=True,
            method=None, groups=None):
    """One map chain, `source` -> copy('cuda') -> map_block(func) (->
    detect(scalar)) -> callback_sink on the card, in one fuse scope when
    `fuse` (the chain of benchmarks/map_tpu.py:97-130).  -> dict of the
    output gulps (on the card), the host clock when each was done, wall
    seconds, launch counts, the map block's raw reads (count, bytes) and
    plan report, its name, and the fusion report.  `groups`: whether the
    run forms fused groups (default: `fuse`)."""
    import contextlib

    from bifrost_tpu_torch import block_scope
    from bifrost_tpu_torch.blocks import (callback_sink, copy,
                                          detect as detect_block, map_block)
    from bifrost_tpu_torch.pipeline import FusedTransformBlock, Pipeline
    outs, stamps = [], []

    def keep(a):
        outs.append(a.clone())
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    with Pipeline(device=dev) as pipe:
        src = source()
        with block_scope(fuse=True) if fuse else contextlib.nullcontext():
            m = map_block(copy(src, space="cuda"), func, axis_names=axes,
                          method=method)
            out = detect_block(m, mode="scalar") if detect else m
        callback_sink(out, on_data=keep)
        reset_counts()
        t0 = time.perf_counter()
        pipe.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    want = fuse if groups is None else groups
    groups = [b for b in pipe.blocks if isinstance(b, FusedTransformBlock)]
    if bool(groups) != want:
        raise AssertionError(f"map run (fuse {fuse}): groups {groups}")
    m1 = kernel_counters()["map_apply"]
    return {"outs": outs, "stamps": stamps, "wall": wall,
            "counts": read_counts(), "raw": (m._raw_reads,
                                             m._raw_read_nbyte),
            "vector": m1.vector_launches, "index64": m1.index64_launches,
            "report": m.plan_report(), "name": m.name,
            "fusion": pipe.fusion_report()}


def map_same(a, b):
    a, b = torch.cat(a), torch.cat(b)
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return bits_equal(a, b)


def map_chains(tag, runs, ngulp, nframe, storage_nbyte, kind,
               vector=False):
    """Hold every run of one program against the first (bitwise), its M1
    launches (one a gulp; none for 'plain'; with `vector` each on the
    vector path with 32-bit indices) and raw reads, and print its rates
    -> launch counts by run name."""
    ref = runs[next(iter(runs))]
    out = {}
    for name, r in runs.items():
        if not map_same(r["outs"], ref["outs"]):
            raise AssertionError(f"map {tag}: the {name} run differs from "
                                 f"the {next(iter(runs))} run")
        plain = name.startswith("plain")
        n = r["gulps"]
        if r["counts"] != expected(map_apply=0 if plain else n):
            raise AssertionError(f"map {tag} {name}: launches "
                                 f"{r['counts']}")
        if vector and (r["vector"] != r["counts"]["map_apply"] or
                       r["index64"]):
            raise AssertionError(f"map {tag} {name}: {r['vector']} of "
                                 f"{r['counts']['map_apply']} launches on "
                                 f"the vector path, {r['index64']} with "
                                 f"64-bit indices")
        if r["raw"] != (n, storage_nbyte):
            raise AssertionError(f"map {tag} {name}: raw reads {r['raw']}")
        want = "plain" if plain else "cuda"
        if r["report"]["method"] != want:
            raise AssertionError(f"map {tag} {name}: method "
                                 f"{r['report']['method']}")
        out[f"map_{tag}_{name}"] = r["counts"]
    rates = {name: round(nframe / r["wall"], 1) for name, r in runs.items()}
    steady = {name: round((len(r["stamps"]) - 1) * (nframe // r["gulps"]) /
                          (r["stamps"][-1] - r["stamps"][0]), 1)
              for name, r in runs.items() if len(r["stamps"]) > 1}
    fused = next((r["fusion"] for r in runs.values()
                  if r["fusion"]["groups"]), None)
    phase("map", f"{tag}: {len(runs)} runs bitwise equal ({list(runs)}), "
          f"M1 launches "
          f"{ {k: r['counts']['map_apply'] for k, r in runs.items()} } "
          f"(one a gulp, {ngulp} gulps of {nframe // ngulp} frames; on the "
          f"vector path { {k: r['vector'] for k, r in runs.items()} }), raw "
          f"reads {ref['raw']}; frames/s whole {rates}, steady {steady}; "
          f"fused group "
          f"{[(g['rule'], g['constituents']) for g in fused['groups']] if fused else None}; "
          f"{kind}")
    return out


def map_path(dev, kind, volt):
    """bf.map on the card (module docstring, phase 17).  `volt`:
    [bengine]'s voltages.  -> launch counts by path."""
    from bifrost_tpu_torch import build
    from bifrost_tpu_torch.blocks import array_source
    from bifrost_tpu_torch.ops.map import Map
    nframe = MAP_NGULP * B_GULP
    hdr = {"dtype": "ci8", "labels": ["time", "station", "pol"],
           "scales": [[0.0, B_DT], None, None], "units": ["s", None, None]}
    raw_nbyte = nframe * NSTAND * NPOL * 2

    def source(gulp):
        return lambda: array_source(volt[:nframe], gulp, header=hdr)
    out = {}

    # (a) The elementwise program, copy -> map -> detect, in turns.
    runs = {}
    for turn in range(MAP_TURNS):
        for fuse in (False, True):
            name = f"{'fused' if fuse else 'unfused'}{turn + 1}"
            runs[name] = map_run(dev, source(B_GULP), MAP_FUNC, fuse=fuse)
            runs[name]["gulps"] = MAP_NGULP
    runs["plain"] = map_run(dev, source(B_GULP), MAP_FUNC, method="plain")
    runs["plain"]["gulps"] = MAP_NGULP
    y = torch.cat(runs["unfused1"]["outs"])
    if y.shape != (nframe, NSTAND, NPOL) or y.dtype != torch.float32 or \
            not bool(torch.isfinite(y).all()):
        raise AssertionError(f"map elementwise: output {y.shape} {y.dtype}")
    # golden on the first frames: |2 x x* + 1|^2 in f64
    x = volt[:256].astype(np.float64)
    g = 2 * (x[..., 0] ** 2 + x[..., 1] ** 2) + 1
    if not np.array_equal(y[:256].cpu().numpy(), (g * g).astype(np.float32)):
        raise AssertionError("map elementwise: differs from the exact golden")
    del y
    st = runs["unfused1"]["stamps"]
    SOLO["map"] = dict(steady=(len(st) - 1) * B_GULP / (st[-1] - st[0]))
    out.update(map_chains("elementwise", runs, MAP_NGULP, nframe,
                          raw_nbyte, kind, vector=True))
    del runs
    free_device()

    # (b) The stencil, fused and unfused, at gulps of B_GULP and of
    # B_GULP // MAP_SPLIT.
    runs = {}
    for gulp, tag in ((B_GULP, ""), (B_GULP // MAP_SPLIT, "_split")):
        for fuse in (False, True):
            name = f"{'fused' if fuse else 'unfused'}{tag}"
            runs[name] = map_run(dev, source(gulp), MAP_STENCIL, MAP_AXES,
                                 fuse=fuse, detect=False)
            runs[name]["gulps"] = nframe // gulp
            if fuse and not any(gr["rule"] == "stateful_chain" for gr in
                                runs[name]["fusion"]["groups"]):
                raise AssertionError(f"map stencil: {runs[name]['fusion']}")
    runs["plain"] = map_run(dev, source(B_GULP), MAP_STENCIL, MAP_AXES,
                            detect=False, method="plain")
    runs["plain"]["gulps"] = MAP_NGULP
    y = torch.cat(runs["unfused"]["outs"])[:B_GULP + 4]
    xs = volt[:B_GULP + 4].astype(np.float32)
    xz = xs[..., 0] + 1j * xs[..., 1]
    d = xz - np.concatenate([np.zeros_like(xz[:1]), xz[:-1]])
    if not np.array_equal(y.cpu().numpy(), d.astype(np.complex64)):
        raise AssertionError("map stencil: differs from the exact golden")
    del y
    out.update(map_chains("stencil", runs, MAP_NGULP, nframe, raw_nbyte,
                          kind, vector=True))
    del runs
    free_device()

    # (c) The elementwise program on [xengine]'s seeded ci4 replay.
    frames = xe_frames()
    ci4_nframe = MAP_CI4_NGULP * XE_GULP
    nsp = XE_NSTAND * XE_NPOL
    runs = {}
    for name, method in (("unfused", None), ("plain", "plain")):
        runs[name] = map_run(dev, lambda: xe_source(frames, ci4_nframe),
                             MAP_FUNC, method=method)
        runs[name]["gulps"] = MAP_CI4_NGULP
    b = frames[:4].astype(np.int16)
    re_, im_ = (b.astype(np.int8) >> 4).astype(np.float64), \
        ((b << 4).astype(np.uint8).astype(np.int8) >> 4).astype(np.float64)
    g = 2 * (re_ ** 2 + im_ ** 2) + 1
    y = torch.cat(runs["unfused"]["outs"])[:4].cpu().numpy()
    if not np.array_equal(y, (g * g).astype(np.float32)):
        raise AssertionError("map ci4: differs from the exact golden")
    out.update(map_chains("ci4", runs, MAP_CI4_NGULP, ci4_nframe,
                          ci4_nframe * XE_NCHAN * nsp, kind))
    del runs, frames
    free_device()

    # (d) The f16 program as a map_block chain on the card: one M1 launch
    # a gulp, bitwise its 'plain' run (a numpy source has no bf16: bf16
    # is held at the kernel level in check_map).
    hnframe = MAP_HALF_NGULP * B_GULP
    rng = np.random.default_rng(SEED + 17)
    base = (rng.standard_normal((hnframe, NSTAND, NPOL)) * 3).astype(
        np.float32)
    for tag in ("f16",):
        data = base.astype(np.float16)
        hhdr = {"labels": ["time", "station", "pol"]}
        runs = {}
        for name, method in (("unfused", None), ("plain", "plain")):
            runs[name] = map_run(
                dev, lambda: array_source(data, B_GULP, header=dict(hhdr)),
                MAP_HALF_FUNC, detect=False, method=method)
        for name, r in runs.items():
            n = 0 if name == "plain" else MAP_HALF_NGULP
            if r["counts"] != expected(map_apply=n):
                raise AssertionError(f"map {tag} {name}: launches "
                                     f"{r['counts']}")
            out[f"map_{tag}_{name}"] = r["counts"]
        y = torch.cat(runs["unfused"]["outs"])
        if y.shape != (hnframe, NSTAND, NPOL) or not map_same(
                runs["unfused"]["outs"], runs["plain"]["outs"]):
            raise AssertionError(f"map {tag}: M1 chain != plain chain")
        rates = {k: round(hnframe / r["wall"], 1) for k, r in runs.items()}
        phase("map", f"{tag} chain {MAP_HALF_FUNC!r} (copy -> map_block, "
              f"{MAP_HALF_NGULP} gulps of {B_GULP} frames): bitwise its "
              f"'plain' run, one M1 launch a gulp "
              f"({runs['unfused']['counts']['map_apply']}), output "
              f"{y.dtype}; frames/s whole {rates}; {kind}")
        del runs, y, data
        free_device()
    del base

    # (e) The eager explicit-index and scatter calls of check_map as a
    # user calls them (counted), then the forward program and the time
    # reversal (per-gulp streaming forms, M1's element path) in copy ->
    # map_block -> detect, each beside its 'plain' run and a fuse=True
    # build, which refuses the map (map_unbounded_index) and puts it in
    # no group.
    out.update(map_eager_path(dev, volt))
    for tag, func in (("forward", MAP_FORWARD), ("reverse", MAP_REVERSE)):
        runs = {"unfused": map_run(dev, source(B_GULP), func, MAP_AXES),
                "fused": map_run(dev, source(B_GULP), func, MAP_AXES,
                                 fuse=True, groups=False),
                "plain": map_run(dev, source(B_GULP), func, MAP_AXES,
                                 method="plain")}
        for r in runs.values():
            r["gulps"] = MAP_NGULP
        fz, name = runs["fused"]["fusion"], runs["fused"]["name"]
        if fz["refused"].get(name) != "map_unbounded_index" or any(
                name in g["constituents"] for g in fz["groups"]):
            raise AssertionError(f"map {tag}: fusion {fz}")
        y = torch.cat(runs["unfused"]["outs"])[:B_GULP].cpu().numpy()
        x = volt[:B_GULP].astype(np.float64)
        t = np.arange(B_GULP)
        src = np.minimum(t + 1, B_GULP - 1) if tag == "forward" else \
            B_GULP - 1 - t
        d = x[src] - (x if tag == "forward" else 0)
        if not np.array_equal(y, (d[..., 0] ** 2 + d[..., 1] ** 2)
                              .astype(np.float32)):
            raise AssertionError(f"map {tag}: differs from the exact "
                                 f"golden on the first gulp")
        del y, x, d
        out.update(map_chains(tag, runs, MAP_NGULP, nframe, raw_nbyte,
                              kind))
        phase("map", f"{tag}: the fuse=True build refused {name} "
              f"({fz['refused'][name]}), groups "
              f"{[g['constituents'] for g in fz['groups']]}; the first "
              f"gulp's detected powers equal the exact golden; {kind}")
        del runs
        free_device()

    # The generated kernels' builds, and a second Map on the same
    # expression: its library loads from build/map/ with no nvcc run.
    info = map_program_info()
    build.clear_generated()
    nlog = len(build.generated_log)
    again = Map(MAP_FUNC)
    again.prepare("ci8", 3, device=dev)
    warm = build.generated_log[nlog:]
    if len(warm) != 1 or warm[0]["nvcc"]:
        raise AssertionError(f"map: the second Map rebuilt: {warm}")
    phase("map", f"generated kernels (nvcc s, by index type registers "
          f"and spill stores): {info}; a second Map({MAP_FUNC!r}) loaded the "
          f"built library with no nvcc run ({warm[0]['seconds']} s); "
          f"{kind}")
    return out


def map_eager_path(dev, volt):
    """[map] (e)'s eager calls: the transpose, band flip, transpose as a
    scatter and repeated-target scatter of map_eager_calls on the first
    gulp of `volt`, through ops.map.map on card tensors ('auto'),
    counted: one M1 launch each, two for the repeated-target scatter, the
    two transposes on the tile path; each bitwise the plain engine ->
    {'map_eager': launch counts}."""
    from bifrost_tpu_torch import config
    from bifrost_tpu_torch.ops.map import map as eager_map
    raw = torch.from_numpy(volt[:B_GULP]).to(dev)
    calls = map_eager_calls(raw)
    del raw
    got = {}
    reset_counts()
    for tag, e in calls.items():
        got[tag] = eager_map(e["func"], dict(e["data"]),
                             axis_names=("i", "j"), shape=e["shape"])
        if "c" in e["data"]:
            got[tag] = got[tag].clone()
            e["data"]["c"].zero_()
    torch.cuda.synchronize()
    counts = read_counts()
    tiles = kernel_counters()["map_apply"].tile_launches
    if counts != expected(map_apply=5) or tiles != 2:
        raise AssertionError(f"map eager: launches {counts}, {tiles} on "
                             f"the tile path")
    config.set("map_method", "plain")
    try:
        for tag, e in calls.items():
            want = eager_map(e["func"], dict(e["data"]),
                             axis_names=("i", "j"), shape=e["shape"])
            if not bits_equal(torch.view_as_real(got[tag]),
                              torch.view_as_real(want)):
                raise AssertionError(f"map eager {tag}: M1 != plain")
    finally:
        config.reset("map_method")
    phase("map", f"(e) eager calls {[e['func'] for e in calls.values()]} "
          f"through map() on card tensors: launches {counts['map_apply']} "
          f"(1 + 1 + 1 + 2; {tiles} on the tile path), each bitwise the "
          f"plain engine")
    del calls, got
    free_device()
    return {"map_eager": counts}


def frb_spec(tag, data, gather, cands, plan=None):
    """[service] (d)'s registry FRB search over `data`, its blocks named
    `<stage>` for the tenant 'frb' and `<tag>_<stage>` otherwise; the
    detect stage also gathers the dedispersed gulps (`gather`, host
    copies, stamped).  With `plan`, the FDMT stage is built by a factory
    that attaches the plan to the pipeline as it is built."""
    from bifrost_tpu_torch.blocks import FdmtBlock, array_source
    from bifrost_tpu_torch.blocks.testing import gather_sink
    from bifrost_tpu_torch.pipeline import get_default_pipeline
    from bifrost_tpu_torch.service import (CandidateDetectBlock,
                                           ServiceSpec, StageSpec)

    def named(stage):
        return stage if tag == "frb" else f"{tag}_{stage}"

    def fdmt(up):
        b = FdmtBlock(up, max_delay=MAX_DELAY, gulp_nframe=GULP,
                      name=named("fdmt"))
        plan.attach(get_default_pipeline())
        return b

    def detect(up):
        gather_sink(up, gather, name=named("gather"))
        return CandidateDetectBlock(up, on_candidate=cands.append,
                                    gulp_nframe=GULP, name=named("detect"))

    fdmt_stage = StageSpec("custom", name="fdmt", params=dict(
        factory=fdmt)) if plan is not None else \
        StageSpec("fdmt", name=named("fdmt"), params=dict(
            max_delay=MAX_DELAY, gulp_nframe=GULP))
    return ServiceSpec([
        StageSpec("custom", name="capture", params=dict(
            factory=lambda up: array_source(data, GULP, header={
                "labels": ["time", "freq"],
                "scales": [[0.0, DT], [F0, DF]],
                "units": ["s", "MHz"]}, name=named("capture")))),
        StageSpec("copy", name=named("copy")),
        StageSpec("transpose", name=named("transpose"), params=dict(
            axes=["freq", "time"], gulp_nframe=GULP)),
        fdmt_stage,
        StageSpec("custom", name="detect", tier="detect",
                  params=dict(factory=detect)),
    ])


def fleet_path(dev, kind, volt, inst_bare):
    """Four tenants sharing the card under one FleetScheduler (module
    docstring, phase 18).  `volt`: [bengine]'s voltages; `inst_bare`:
    [service]'s bare run of the instrument (`service_path`), FL_INST_NINT
    integrations, the inst tenant's reference.  -> launch counts by
    path."""
    import threading
    from types import SimpleNamespace

    from bifrost_tpu_torch import build
    from bifrost_tpu_torch.blocks.testing import ArraySourceBlock
    from bifrost_tpu_torch.cache import kernel_cache_info
    from bifrost_tpu_torch.egress import DeviceSinkBlock
    from bifrost_tpu_torch.faultinject import FaultPlan
    from bifrost_tpu_torch.fleet import (FleetScheduler, TenantSpec,
                                         pipeline_ring_bytes)
    from bifrost_tpu_torch.service import (FrameLedger, ServiceSpec,
                                           StageSpec, frb_search_pipeline)
    ivolt = volt[:FL_INST_NINT * B_GULP]
    mnframe = FL_MAP_NGULP * B_GULP
    mvolt = volt[:mnframe]
    hdr = {"dtype": "ci8", "labels": ["time", "station", "pol"],
           "scales": [[0.0, B_DT], None, None], "units": ["s", None, None]}
    data = frb_data()
    fdata = data[:FL_FLAKY_NGULP * GULP]
    nfdmt = FL_INST_NINT - B_MAX_DELAY

    # ---- the tenants alone: outputs, launches, ring bytes (inst's from
    # [service]'s bare run of the same FL_INST_NINT integrations)
    bimgs, bcands, bded = inst_bare["imgs"], inst_bare["cands"], \
        inst_bare["ded"]
    bare_inst, rb_inst = inst_bare["counts"], inst_bare["ring_bytes"]
    fgather = []
    pipe, det, _ = frb_search_pipeline(fdata, GULP, MAX_DELAY, F0, DF, DT,
                                       device=dev, gather=fgather)
    reset_counts()
    pipe.run()
    torch.cuda.synchronize()
    bare_flaky = read_counts()
    nsteps = len(det.iring.owner.fdmt._steps)
    rb_frb = pipeline_ring_bytes(pipe)
    del pipe, det, fgather
    free_device()
    plain = {}
    for func in (MAP_FUNC, FL_MAP_FUNC2):
        r = map_run(dev, lambda: ArraySourceBlock(mvolt, B_GULP, header=hdr),
                    func, detect=False, method="plain")
        plain[func] = [o.cpu() for o in r["outs"]]
        del r
        free_device()
    r = map_run(dev, lambda: ArraySourceBlock(mvolt, B_GULP, header=hdr),
                MAP_FUNC, detect=False)
    bare_map = r["counts"]
    del r
    free_device()
    k1 = bare_inst["fdmt_merge_step"]        # the beam FDMT's steps
    if bare_inst != expected(fir_mac=FL_INST_NINT,
                             beamform_power=FL_INST_NINT,
                             romein_grid_separable=FL_INST_NINT,
                             fdmt_merge_step=k1) or not k1 or k1 % nfdmt or \
            bare_flaky != expected(fdmt_merge_step=FL_FLAKY_NGULP * nsteps) \
            or bare_map != expected(map_apply=FL_MAP_NGULP):
        raise AssertionError(f"bare launches: inst {bare_inst}, flaky "
                             f"{bare_flaky}, map {bare_map}")

    # ---- the map tenant: a paced replay -> copy -> map -> a staged sink
    class PacedReplay(ArraySourceBlock):
        def on_data(self, reader, ospans):
            time.sleep(FL_MAP_PACE)
            return super().on_data(reader, ospans)

    gulp_nbyte = B_GULP * NSTAND * NPOL * 8          # one complex64 gulp
    sink_log = SimpleNamespace(outs=[], stamps=[], frames=[], retained=[],
                               ledger=FrameLedger(), view=None, seq=-1)

    class Sink(DeviceSinkBlock):
        def on_sink_sequence(self, iseq):
            sink_log.seq += 1
            sink_log.ledger.note_sequence(sink_log.seq)

        def on_sink_data(self, arr, frame_offset):
            sink_log.outs.append(np.array(arr))
            sink_log.stamps.append(time.perf_counter())
            sink_log.frames.append(frame_offset)
            sink_log.ledger.note_sink(sink_log.seq, frame_offset,
                                      len(arr))
            if self.egress_pool is not None:
                sink_log.view = self.egress_pool
                sink_log.retained.append(
                    self.egress_pool.stats()["retained_bytes"])

    def map_stage(func):
        return StageSpec("map", name="map", params=dict(func=func))

    map_spec = ServiceSpec([
        StageSpec("custom", name="replay", params=dict(
            factory=lambda up: PacedReplay(mvolt, B_GULP, header=hdr,
                                           name="map_replay"))),
        StageSpec("copy", name="map_copy"),
        map_stage(MAP_FUNC),
        StageSpec("custom", name="sink", tier="detect", params=dict(
            factory=lambda up: Sink(up, name="map_sink"))),
    ])

    # ---- the fleet
    icands, fcands, lcands, ided = [], [], [], []
    iimgs = Fingerprints(SV_KEEP)
    fgather, lgather = Stamped(), Stamped()
    plan = FaultPlan(seed=7)
    plan.raise_at("block.on_data", block="flaky_fdmt", nth=FL_FLAKY_NTH)
    # The map pipeline's rings are sized at its first sequence: declare
    # its demand from a bare build of the same topology.
    from bifrost_tpu_torch.blocks import copy as copy_block, map_block
    from bifrost_tpu_torch.blocks.testing import callback_sink
    from bifrost_tpu_torch.pipeline import Pipeline
    with Pipeline(device=dev) as p:
        s_ = ArraySourceBlock(mvolt[:2 * B_GULP], B_GULP, header=hdr)
        callback_sink(map_block(copy_block(s_, space="cuda"), MAP_FUNC),
                      on_data=lambda a: None)
        p.run()
    rb_map = pipeline_ring_bytes(p)
    del p, s_
    free_device()
    R = rb_inst + rb_frb + rb_map + rb_frb // 2
    fleet = FleetScheduler(name="fl", device=dev, ring_bytes_total=R,
                           staging_bytes_total=FL_STAGING,
                           health_interval_s=0.05)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    tenants = {}
    tenants["inst"] = fleet.submit(TenantSpec(
        "inst", gather_dedispersed(sv_spec(ivolt, iimgs, icands), ided),
        priority=2,
        ring_bytes=rb_inst))
    tenants["frb"] = fleet.submit(TenantSpec(
        "frb", lambda: frb_spec("frb", data, fgather, fcands), priority=1,
        ring_bytes=rb_frb))
    map_tenant = tenants["map"] = fleet.submit(TenantSpec(
        "map", map_spec, priority=0, ring_bytes=rb_map,
        staging_bytes=gulp_nbyte))
    tenants["flaky"] = fleet.submit(TenantSpec(
        "flaky", lambda: frb_spec("flaky", fdata, lgather, lcands, plan),
        priority=0, ring_bytes=rb_frb))
    tenants["huge"] = fleet.submit(TenantSpec(
        "huge", lambda: frb_spec("huge", fdata, [], []), ring_bytes=R + 1))
    states = {n: t.state for n, t in tenants.items()}
    if states != {"inst": "running", "frb": "running", "map": "running",
                  "flaky": "queued", "huge": "rejected"}:
        raise AssertionError(f"admission: {states}")
    fleet.start()

    # The respecs land mid-stream, keyed to the sink's gulp count; the
    # tenants that do not fault keep every block's budget full.
    nbudget = [0]
    olds, recs, builds = [], [], []

    def check_budgets():
        for n in ("inst", "frb", "map"):
            sup = tenants[n].supervisor()
            if sup is None:
                continue
            rem = sup.budget_remaining()
            if any(v != sup.policies.get(b, sup.policy).max_restarts
                   for b, v in rem.items()):
                raise AssertionError(f"tenant {n}'s budgets {rem}")
            nbudget[0] += 1

    def wait_gulps(n):
        """Until the map stage has done `n` gulps (the sink, which copies
        each 256 MiB gulp to the host, may lag it by the rings' depth)."""
        deadline = time.monotonic() + 300
        while True:
            svc = map_tenant.service
            blk = svc.blocks["map"] if svc is not None else None
            if blk is not None and blk._loop_frame >= n * B_GULP:
                return len(sink_log.outs)
            if time.monotonic() > deadline or map_tenant.state != "running":
                raise AssertionError(f"map tenant at {len(sink_log.outs)} "
                                     f"gulps, {map_tenant.state}")
            check_budgets()
            time.sleep(0.002)

    at_sink = []
    for n, func in zip(FL_RESPEC_AT, (FL_MAP_FUNC2, MAP_FUNC)):
        at_sink.append(wait_gulps(n))
        olds.append(map_tenant.service.blocks["map"])
        nlog = len(build.generated_log)
        # The wait for the replacement's first gulp covers a cold nvcc.
        recs.append(fleet.respec("map", "map", map_stage(func),
                                 timeout=120.0))
        builds.append(build.generated_log[nlog:])
    deadline = time.monotonic() + 600
    while not fleet.wait(timeout=0.2, drain_queue=True):
        check_budgets()
        if time.monotonic() > deadline:
            raise AssertionError("the fleet did not finish")
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.synchronize()
    snap = fleet.snapshot()
    rep = fleet.stop()
    plan.detach()

    # ---- checks: the scheduler's decisions and counters
    c = rep.counters
    want_c = {"submitted": 5, "admitted": 4, "queued": 1, "rejected": 1,
              "preempted": 0, "completed": 4, "respecs": 2,
              "quota_violations": 0, "queued_at_stop": 0}
    if any(c[k] != v for k, v in want_c.items()) or rep.exit_code != 0:
        raise AssertionError(f"fleet counters {c}, exit {rep.exit_code}; "
                             f"{rep!r}")
    kinds = [e["kind"] for e in fleet.events_for(tenant="flaky")]
    if kinds[:2] != ["queue", "admit"] or tenants["flaky"].admissions != 1:
        raise AssertionError(f"flaky's events {kinds}")
    ex = {n: rep.tenants[n]["exit"] for n in ("inst", "frb", "map",
                                              "flaky")}
    for n, e in ex.items():
        led = e["ledger"]
        if e["exit_code"] != 0 or led["lost_frames"] or \
                led["duplicated_frames"]:
            raise AssertionError(f"tenant {n}: {e}")
        want_restarts = 1 if n == "flaky" else 0
        if e["counters"]["restarts"] != want_restarts or \
                e["counters"]["faults"] != want_restarts:
            raise AssertionError(f"tenant {n} counters {e['counters']}")
    if ex["flaky"]["ledger"]["restart_shed_frames"] != GULP or \
            not plan.fired(site="block.on_data"):
        raise AssertionError(f"flaky: {ex['flaky']}")
    if not nbudget[0]:
        raise AssertionError("no budget sample")
    # ---- inst: images, dedispersed beams and candidates bitwise the bare
    # fused pipeline's
    if len(iimgs.sums) != FL_INST_NINT or iimgs.sums != bimgs.sums:
        raise AssertionError(f"inst: image checksums differ "
                             f"({len(iimgs.sums)}/{len(bimgs.sums)})")
    images_equal(iimgs, bimgs, SV_KEEP)
    if sum(x.shape[-1] for x in bded) != nfdmt or len(ided) != len(bded) \
            or any(x.shape != y.shape or not np.array_equal(
                x.view(np.uint32), y.view(np.uint32))
                for x, y in zip(ided, bded)):
        raise AssertionError("inst: dedispersed beams differ from the bare "
                             "run's")
    if icands != bcands or ex["inst"]["ledger"]["committed_frames"] != \
            nfdmt:
        raise AssertionError(f"inst: candidates {icands} != {bcands}")
    # ---- frb: dedispersed output and candidates bitwise [main]'s
    main = SOLO["frb"]
    if len(fgather) != NGULP or any(
            not np.array_equal(x.view(np.uint32), y.view(np.uint32))
            for x, y in zip(fgather, main["gathered"])):
        raise AssertionError("frb: dedispersed gulps differ from [main]'s")
    if fcands != main["cands"] or not fcands:
        raise AssertionError("frb: candidates differ from [main]'s")
    best = check_burst(SimpleNamespace(candidates=fcands))
    # ---- map: every gulp the plain engine of the program live for it
    seams = [o._loop_frame for o in olds]
    if len(sink_log.outs) != FL_MAP_NGULP or \
            sum(len(o) for o in sink_log.outs) != mnframe or \
            any(s % B_GULP for s in seams) or \
            not 0 < seams[0] < seams[1] < mnframe:
        raise AssertionError(f"map: {len(sink_log.outs)} gulps, seams "
                             f"{seams}")
    live = []
    for g, y in enumerate(sink_log.outs):
        f = g * B_GULP
        func = MAP_FUNC if f < seams[0] or f >= seams[1] else FL_MAP_FUNC2
        live.append(func)
        want = plain[func][g].numpy()
        if y.shape != want.shape or not np.array_equal(
                y.view(np.uint32), want.view(np.uint32)):
            raise AssertionError(f"map gulp {g}: differs from the plain "
                                 f"engine of {func!r}")
    mled = sink_log.ledger.summary()
    if mled["lost_frames"] or mled["duplicated_frames"] or \
            mled["committed_frames"] != mnframe or \
            ex["map"]["counters"]["respecs"] != 2:
        raise AssertionError(f"map ledger {mled}; {ex['map']}")
    cold = [e for e in builds[0] if e["nvcc"]]
    if len(cold) != 1 or any(e["nvcc"] for e in builds[1]):
        raise AssertionError(f"map builds: cold {builds[0]}, warm "
                             f"{builds[1]}")
    # ---- staging: the view never kept more than its quota
    st = sink_log.view.stats() if sink_log.view is not None else None
    if st is None or max(sink_log.retained) > gulp_nbyte or \
            st["over_quota_allocs"] < 1 or st["quota_bytes"] != gulp_nbyte:
        raise AssertionError(f"staging view {st}, retained "
                             f"{sink_log.retained}")
    # ---- launches: the sum of the tenants' bare runs, flaky's shed gulp
    # out (its FDMT gulp faulted before the kernel)
    want = {k: bare_inst[k] + main["counts"][k] + bare_flaky[k] +
            bare_map[k] for k in bare_inst}
    want["fdmt_merge_step"] -= nsteps
    if counts != want:
        raise AssertionError(f"fleet launches {counts}, expected {want}")
    for k in ("dq_masked_fill", "dq_gain_apply", "flag_stats", "flag_cross",
              "flag_walk", "romein_grid_general", "xengine_int8"):
        if counts[k]:
            raise AssertionError(f"fleet: {k} launched")

    # ---- the readings
    def steady(stamps, unit):
        return (len(stamps) - 1) * unit / (stamps[-1] - stamps[0]) \
            if len(stamps) > 1 else float("nan")
    rates = {
        "inst": (steady(iimgs.stamps, B_GULP), SOLO["inst"]["steady"]),
        "frb": (steady(fgather.stamps, GULP), main["steady"]),
        "map": (steady(sink_log.stamps, B_GULP), SOLO["map"]["steady"]),
        "flaky": (steady(lgather.stamps, GULP), main["steady"]),
    }
    total = (FL_INST_NINT * B_GULP + NGULP * GULP + mnframe +
             FL_FLAKY_NGULP * GULP) / wall
    phase("fleet", f"FleetScheduler('fl', ring_bytes_total {R / 2**30:.2f} "
          f"GiB, staging {FL_STAGING >> 20} MiB) on {kind}: inst "
          f"(lwa_instrument_spec, {FL_INST_NINT} integrations, priority 2), "
          f"frb ({NGULP} gulps, 1), map ({FL_MAP_NGULP} gulps paced "
          f"{FL_MAP_PACE} s, 0) admitted; flaky queued, then admitted "
          f"({kinds}); huge rejected ({tenants['huge'].reject_reason}); "
          f"{wall:.3f} s; exit code {rep.exit_code} (the JAX contract: 0 "
          f"with no preemption, no degraded exit and none queued); "
          f"counters {c}")
    phase("fleet", "steady frames/s, fleet against solo (earlier phases of "
          "this run): " + "; ".join(
              f"{n} {a:.1f} against {b:.1f}" for n, (a, b) in rates.items())
          + f"; the fleet's total {total:.1f} frames/s (all frames over "
          f"the fleet's wall)")
    phase("fleet", "respecs of map (cold, then warm): " + "; ".join(
        f"{r['stage']} -> {f!r}: outcome {r['outcome']}, splice_s "
        f"{r['splice_s']}, downtime_s {r['downtime_s']}, resumed at frame "
        f"{s} (the sink then at {k} gulps)" for r, f, s, k in
        zip(recs, (FL_MAP_FUNC2, MAP_FUNC), seams, at_sink))
        + f"; the cold build's nvcc {cold[0]['seconds']:.2f} s, the warm "
        f"one loaded ({len(builds[1])} library loads, no nvcc)")
    el = snap["elastic"]
    phase("fleet", f"admission -> first gulp p50 {el['admission_p50_s']} "
          f"s, p99 {el['admission_p99_s']} s ({el['admission_samples']} "
          f"samples); the map view's stats {st} (retained at most "
          f"{max(sink_log.retained)} of quota {gulp_nbyte}); the pool "
          f"{ {k: v for k, v in rep_pool(fleet).items()} }; "
          f"torch.cuda.max_memory_allocated {peak / 2**30:.2f} GiB; "
          f"kernel_cache_info {kernel_cache_info()}")
    phase("fleet", f"checks: inst's {FL_INST_NINT} images (checksums; the "
          f"first {SV_KEEP} whole), {len(ided)} dedispersed gulps "
          f"({nfdmt} frames of {NBEAM} beams) and {len(icands)} candidates "
          f"bitwise its bare fused run; frb's {NGULP} dedispersed gulps and "
          f"{len(fcands)} candidates bitwise [main]'s, the burst {best}; "
          f"map's {FL_MAP_NGULP} gulps bitwise the plain engine of the "
          f"live program ({[f == MAP_FUNC for f in live]}), ledger "
          f"{mled}; flaky one restart (shed {GULP} frames), the others "
          f"no fault, no restart, budgets full; launches {counts} == "
          f"inst + frb + map + flaky alone, less flaky's shed gulp "
          f"({nsteps} K1 steps); {nbudget[0]} budget samples")
    return {"fleet": counts}


def rep_pool(fleet):
    s = fleet.staging_pool.stats()
    return {k: s[k] for k in ("total_bytes", "retained_bytes", "allocated",
                              "dropped")}


def async_path(dev, kind):
    """The async gulp executor (module docstring, phase 16): [xengine]'s
    replay cut to AS_NINT integrations, the raw head and the host-unpack
    chain under the three disciplines in AS_TURNS turns.  -> launch
    counts by path (the first turn's)."""
    t0 = time.perf_counter()
    frames = xe_frames()
    nframe = AS_NINT * XE_NINT
    ngulp = nframe // XE_GULP
    phase("async", f"voltages: [xengine]'s {XE_DISTINCT} ci4 frames, "
          f"{time.perf_counter() - t0:.1f} s")
    modes = ("serialized", "sync", "async")
    topos = ("unfused", "unpack")
    runs = {(t, m): [] for t in topos for m in modes}
    for turn in range(AS_TURNS):
        for topo in topos:
            for mode in modes:
                r = xe_run(dev, frames, nframe, topo, discipline=mode)
                if turn:
                    r["outs"] = [o.cpu() for o in r["outs"]]
                runs[(topo, mode)].append(r)
    ref = runs[("unfused", "sync")][0]["outs"]
    first = ref[0][0].reshape(XE_NCHAN, -1, XE_NSTAND * XE_NPOL)[0].cpu()
    (vr, vi), = xe_golden(frames, (0,)).values()
    if len(ref) != AS_NINT or \
            not np.array_equal(first.real.numpy().astype(np.int64), vr) or \
            not np.array_equal(first.imag.numpy().astype(np.int64), vi):
        raise AssertionError("async: the sync run's first integration "
                             "differs from the int64 golden")
    out, lines = {}, {}
    for (topo, mode), rs in runs.items():
        for turn, r in enumerate(rs):
            if len(r["outs"]) != AS_NINT or not all(
                    bits_equal(torch.view_as_real(v.to(dev)),
                               torch.view_as_real(ref[k]))
                    for k, v in enumerate(r["outs"])):
                raise AssertionError(f"async {topo} {mode} turn {turn}: "
                                     f"visibilities differ from the sync "
                                     f"raw head's")
            if r["counts"] != expected(xengine_int8=ngulp):
                raise AssertionError(f"async {topo} {mode}: launches "
                                     f"{r['counts']}")
            on = sorted(n for n, d in r["depths"].items() if d)
            want = 3 if mode == "async" else 0     # copy, correlate, sink
            if len(on) != want or any(r["depths"][n] != AS_DEPTH
                                      for n in on):
                raise AssertionError(f"async {topo} {mode}: executor "
                                     f"depths {r['depths']}")
        out[f"async_{topo}_{mode}"] = rs[0]["counts"]
        lines[f"{topo} {mode}"] = {
            "frames_per_s_whole": [round(nframe / r["wall"], 1)
                                   for r in rs],
            "frames_per_s_steady": [round(
                (len(r["stamps"]) - 1) * XE_NINT /
                (r["stamps"][-1] - r["stamps"][0]), 1) for r in rs],
            "stall_pct": rs[-1]["stall"],
            "x1_launches": rs[0]["counts"]["xengine_int8"]}
    phase("async", f"ci4 correlator at [xengine]'s configuration, "
          f"{AS_NINT} integrations ({ngulp} gulps), raw head and host "
          f"unpack, serialized / sync / async (depth {AS_DEPTH}) in "
          f"{AS_TURNS} turns: every run bitwise the sync raw head's "
          f"(integration 0, channel 0 the int64 golden), X1 {ngulp} "
          f"launches each; {json.dumps(lines)}; {kind}")
    del runs, ref, frames
    free_device()
    return out


def gs_voltages(g, rng):
    """`g['ndistinct']` frames of ci8 voltages in storage form, (frame,
    chan, time, pol, (re, im)) int8: for the flagship the values of
    bench.py:270-274 (re and im each drawn by `rng.integers(-8, 8,
    shape)`), for the real block the same range drawn as int8."""
    shape = (g["ndistinct"], g["nchan"], g["ntime"], g["npol"])
    v = np.empty(shape + (2,), np.int8)
    if g is GS_FLAGSHIP:
        v[..., 0] = rng.integers(-8, 8, shape)
        v[..., 1] = rng.integers(-8, 8, shape)
    else:
        v[...] = rng.integers(-8, 8, v.shape, dtype=np.int8)
    return v


def write_guppi(path, volt):
    """`volt` (frame, chan, time, pol, 2) int8 as a GUPPI RAW file, one
    block a frame, through the port's io."""
    from bifrost_tpu_torch.io import guppi_raw
    _, nchan, ntime, npol, _ = volt.shape
    with open(path, "wb") as f:
        for b, frame in enumerate(volt):
            guppi_raw.write_header(f, {
                "BLOCSIZE": frame.nbytes, "OBSNCHAN": nchan, "NPOL": npol,
                "NBITS": 8, "OBSFREQ": 1420.0, "OBSBW": -187.5,
                "PKTIDX": b, "SRC_NAME": "CHIPSMOKE", "TELESCOP": "GBT"})
            f.write(frame.tobytes())


def gs_stokes(x):
    """numpy Stokes (I, Q, U, V) of (..., 2 pol, chan, fine) spectra."""
    x0, x1 = x[..., 0, :, :], x[..., 1, :, :]
    p0, p1 = np.abs(x0) ** 2, np.abs(x1) ** 2
    xy = x0 * np.conj(x1)
    return np.stack([p0 + p1, p0 - p1, 2 * xy.real, -2 * xy.imag], axis=-3)


def gs_golden(volt, g):
    """numpy golden of the gpuspec chain (testbench/gpuspec_simple.py:26,
    which this script may not import): complex64 FFT of the whole fine
    axis, fftshift, Stokes, (freq, fine) merged, F_AVG summed, N_INT
    integrated, frame by frame.  -> (nint, 4, nchan * ntime / f_avg)."""
    n_int, f_avg = g["n_int"], g["f_avg"]
    out = []
    for i in range(g["nframe"] // n_int):
        acc = 0
        for k in range(i * n_int, (i + 1) * n_int):
            v = volt[k % len(volt)]
            xc = (v[..., 0].astype(np.float32) +
                  1j * v[..., 1].astype(np.float32)).transpose(2, 0, 1)
            spec = np.fft.fftshift(np.fft.fft(xc, axis=-1), axes=-1)
            s = gs_stokes(spec).reshape(4, -1)
            acc = acc + s.reshape(4, -1, f_avg).sum(axis=-1)
        out.append(acc)
    return np.stack(out)


def gs_bound(nfreq, f_avg, want):
    """The testbench's FFT bound: 32 eps_f32 sqrt(nfft) max|want|."""
    return 32 * np.finfo(np.float32).eps * np.sqrt(nfreq * f_avg) * \
        np.abs(want).max()


def gs_chain(bc, g, head, fuse=False):
    """The testbench chain after its source on the port's BlockChainer
    (copy('cuda') for copy('tpu')): unfused, or with `fuse` its device
    blocks in `block_scope(fuse=True)` as testbench/gpuspec_simple.py:
    89-98 builds them."""
    import contextlib
    import bifrost_tpu_torch as bt
    head(bc)
    with bt.block_scope(fuse=True) if fuse else contextlib.nullcontext():
        bc.blocks.copy("cuda")
        bc.blocks.transpose(["time", "pol", "freq", "fine_time"])
        bc.blocks.fft(axes="fine_time", axis_labels="fine_freq",
                      apply_fftshift=True)
        bc.blocks.detect(mode="stokes")
        bc.views.merge_axes("freq", "fine_freq", label="freq")
        bc.blocks.reduce("freq", g["f_avg"])
        bc.blocks.accumulate(g["n_int"])


def gs_file_run(dev, g, raw, outdir, staged):
    """(a)/(b): GUPPI file -> chain -> .fil; with `staged` the SIGPROC
    sink reads the 'cuda' ring itself (the egress stager on the path),
    else after copy('system').  -> (.fil bytes, staged gulps, drained
    gulps, wall s)."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.blocks import SigprocSinkBlock

    class Sink(SigprocSinkBlock):
        def on_sink_sequence_end(self, iseq):
            self.staged = self._egress.staged_gulps \
                if self._egress is not None else 0
            super().on_sink_sequence_end(iseq)

    with bt.Pipeline(device=dev) as pipe:
        bc = bt.BlockChainer()
        gs_chain(bc, g, lambda b: b.blocks.read_guppi_raw([raw],
                                                          gulp_nframe=1))
        if not staged:
            bc.blocks.copy("system")
        snk = bc.custom(Sink)(path=outdir)
        t0 = time.perf_counter()
        pipe.run()
        wall = time.perf_counter() - t0
    with open(snk.filename, "rb") as f:
        return f.read(), snk.staged, snk._egress_drained_gulps, wall


def gs_framework_run(dev, g, volt, fuse=False):
    """(c): bench.py's run_framework shape, array_source -> ... ->
    callback_sink on the card (fused with `fuse`); the sink keeps each
    integrated spectrum on the card and waits for it (the back-pressure
    of a dump).  -> (outputs, stamps, wall s, peak bytes, host s by
    block and phase)."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.blocks import array_source, callback_sink
    src_data = volt if len(volt) == g["nframe"] else np.concatenate(
        [volt] * (g["nframe"] // len(volt)))
    outs = Stamped()

    def keep(t):
        outs.append(t.clone())
        torch.cuda.current_stream().synchronize()
        outs.stamps[-1] = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with bt.Pipeline(device=dev) as pipe:
        bc = bt.BlockChainer()
        gs_chain(bc, g, lambda b: b.custom(array_source)(
            src_data, 1, header={
                "dtype": "ci8",
                "labels": ["time", "freq", "fine_time", "pol"]}), fuse)
        bc.custom(callback_sink)(on_data=keep)
        t0 = time.perf_counter()
        pipe.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    perf = {b.name: {k: round(v, 4) for k, v in b.perf_totals.items()}
            for b in pipe.blocks}
    del src_data
    return outs, outs.stamps, wall, \
        torch.cuda.max_memory_allocated(dev), perf


def gs_stage_times(dev, g, volt):
    """CUDA-event ms of one gulp of each device stage, called as the
    blocks call them: the transpose to (time, pol, freq, fine), the FFT
    (complex lift, torch.fft, fftshift, into the span), Stokes detect,
    the F_AVG reduce and the accumulate's add.  -> dict of ms."""
    from bifrost_tpu_torch.blocks.detect import detect_fn
    from bifrost_tpu_torch.ndarray import complex_view
    from bifrost_tpu_torch.ops.fft import Fft
    from bifrost_tpu_torch.ops.reduce import reduce_to
    from bifrost_tpu_torch.ops.transpose import transpose
    nchan, ntime, npol, f_avg = g["nchan"], g["ntime"], g["npol"], \
        g["f_avg"]
    x = torch.from_numpy(volt[:1]).to(dev)
    xt = torch.empty(1, npol, nchan, ntime, 2, dtype=torch.int8,
                     device=dev)
    t = {"transpose": cuda_time(lambda: transpose(xt, x, [0, 3, 1, 2]), 5)}
    fft = Fft()
    fft.axes, fft.kind, fft.apply_fftshift = (3,), "c2c", True
    spec = torch.empty(1, npol, nchan, ntime, dtype=torch.complex64,
                       device=dev)
    t["fft"] = cuda_time(lambda: fft.execute(complex_view(xt, "ci8"),
                                             spec), 5)
    st = torch.empty(1, 4, nchan, ntime, device=dev)
    t["detect"] = cuda_time(lambda: detect_fn(spec, "stokes", 1, 2,
                                              out=st), 5)
    nf = nchan * ntime // f_avg
    red = torch.empty(1, 4, nf, device=dev)
    t["reduce"] = cuda_time(lambda: red.copy_(reduce_to(
        st.view(1, 4, nchan * ntime), (1, 4, nf), "sum")), 5)
    acc = red.clone()
    t["accumulate"] = cuda_time(lambda: acc.add_(red), 5)
    return t


def gpuspec_path(dev, kind):
    """The gpuspec spectrometer (module docstring, phase 9).  -> the
    kernels' launch counts over (c)'s first run at both geometries."""
    import shutil
    import tempfile
    rng = np.random.default_rng(0)
    g = GS_FLAGSHIP
    t0 = time.perf_counter()
    volt = gs_voltages(g, rng)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gpuspec_")
    try:
        raw = f"{tmp}/flagship.raw"
        write_guppi(raw, volt)
        phase("gpuspec", f"flagship GUPPI file: {g['nframe']} blocks of "
              f"{volt[0].nbytes / 2**20:.0f} MiB ({g['nchan']} ch x "
              f"{g['ntime']} x {g['npol']} pol ci8), "
              f"{time.perf_counter() - t0:.1f} s")
        runs = {}
        for staged in (False, True):
            out = f"{tmp}/{'b' if staged else 'a'}"
            os.makedirs(out)
            runs[staged] = gs_file_run(dev, g, raw, out, staged)
        fil_a, _, _, wall_a = runs[False]
        fil_b, nstaged, ndrained, wall_b = runs[True]
        nint = g["nframe"] // g["n_int"]
        if fil_a != fil_b:
            raise AssertionError("staged .fil differs from copy('system')'s")
        if nstaged != nint or ndrained != nint:
            raise AssertionError(f"staged {nstaged}, drained {ndrained} "
                                 f"gulps; {nint} output gulps")
        from bifrost_tpu_torch.io import sigproc
        with sigproc.SigprocFile(f"{tmp}/a/flagship.raw.fil") as sf:
            data = np.array(sf.read(sf.nframe))
        t1 = time.perf_counter()
        want = gs_golden(volt, g)
        nfreq = g["nchan"] * g["ntime"] // g["f_avg"]
        err = float(np.abs(data.astype(np.float64) - want).max())
        lim = gs_bound(nfreq, g["f_avg"], want)
        if data.shape != want.shape or not np.isfinite(data).all() or \
                not err <= lim:
            raise AssertionError(f"(a) .fil {data.shape} vs golden "
                                 f"{want.shape}: max err {err} > {lim}")
        phase("gpuspec", f"(a) file to file {wall_a:.3f} s, (b) sink on the "
              f"'cuda' ring {wall_b:.3f} s: .fil {data.shape} byte-identical"
              f", {nstaged} of {nint} output gulps staged; vs the numpy "
              f"golden max abs err {err:.4g} (bound {lim:.4g}, golden "
              f"{time.perf_counter() - t1:.1f} s)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    counts = {}
    for g in (GS_FLAGSHIP, GS_GUPPI):
        t0 = time.perf_counter()
        if g is not GS_FLAGSHIP:
            del volt
            volt = gs_voltages(g, rng)
        gen_s = time.perf_counter() - t0
        reset_counts()
        outs, stamps, wall, peak, perf = gs_framework_run(dev, g, volt)
        counts[g["name"]] = read_counts()
        if counts[g["name"]] != expected():
            raise AssertionError(f"launches {counts[g['name']]}: the "
                                 f"gpuspec path runs no hand kernel")
        outs2, stamps2, wall2, _, _ = gs_framework_run(dev, g, volt)
        nint = g["nframe"] // g["n_int"]
        if len(outs) != nint or len(outs2) != nint or not all(
                bits_equal(a, b) for a, b in zip(outs, outs2)) or \
                not all(torch.isfinite(a).all() for a in outs):
            raise AssertionError("(c) second run differs from the first")
        spf = g["nchan"] * g["ntime"] * g["npol"]
        nsamp = g["nframe"] * spf

        def steady(st):
            return (len(st) - 1) * g["n_int"] * spf / (st[-1] - st[0]) \
                if len(st) > 1 else float("nan")

        stage = gs_stage_times(dev, g, volt)
        phase("gpuspec", f"(c) {g['name']}: {g['nframe']} frames of "
              f"{g['nchan']} ch x {g['ntime']} x {g['npol']} pol ci8 "
              f"(F_AVG {g['f_avg']}, N_INT {g['n_int']}; voltages "
              f"{gen_s:.1f} s): run 1 {wall:.3f} s, {nsamp / wall:.4g} "
              f"samples/s whole, {steady(stamps):.4g} steady (first to "
              f"last integration out); run 2 {wall2:.3f} s, "
              f"{nsamp / wall2:.4g} whole, {steady(stamps2):.4g} steady; "
              f"bitwise equal; peak {peak / 2**30:.2f} GiB; device ms a "
              f"gulp " + ", ".join(f"{k} {v:.4f}" for k, v in stage.items())
              + f" (sum {sum(stage.values()):.4f}); launches "
              f"{counts[g['name']]}; {kind}")
        phase("gpuspec", f"(c) {g['name']} host seconds by block and phase "
              f"(run 1): {json.dumps(perf)}")
        if g is GS_FLAGSHIP:
            got = np.stack([o.reshape(4, -1).cpu().numpy() for o in outs])
            err = float(np.abs(got.astype(np.float64) - want).max())
            if got.shape != want.shape or not err <= lim:
                raise AssertionError(f"(c) flagship {got.shape} vs (a)'s "
                                     f"golden {want.shape}: max err {err} "
                                     f"> {lim}")
            phase("gpuspec", f"(c) flagship, {nint} integrations vs (a)'s "
                  f"numpy golden: max abs err {err:.4g} (bound {lim:.4g})")
        else:
            gs_check_channels(g, volt, outs[0])
        del outs, outs2
        free_device()
    return counts


def gs_check_channels(g, volt, got):
    """The real block's first integrated spectrum on GS_GOLDEN_CHANS
    against an f64 numpy golden of the same chain."""
    nchan, ntime, f_avg = g["nchan"], g["ntime"], g["f_avg"]
    got = got.reshape(4, -1).cpu().numpy()
    worst = 0.0
    for k in GS_GOLDEN_CHANS:
        ch, f0 = divmod(k * f_avg, ntime)
        acc = 0
        for fr in range(g["n_int"]):
            v = volt[fr % len(volt), ch].astype(np.float64)   # (t, pol, 2)
            xc = (v[..., 0] + 1j * v[..., 1]).T                # (pol, t)
            spec = np.fft.fftshift(np.fft.fft(xc, axis=-1), axes=-1)
            s = gs_stokes(spec[:, None, f0:f0 + f_avg])[:, 0]
            acc = acc + s.sum(axis=-1)
        lim = gs_bound(nchan * ntime // f_avg, f_avg, acc)
        err = float(np.abs(got[:, k] - acc).max())
        if not err <= lim:
            raise AssertionError(f"channel {k}: {got[:, k]} vs f64 golden "
                                 f"{acc}: err {err} > {lim}")
        worst = max(worst, err / lim)
    phase("gpuspec", f"(c) {g['name']} first integration on channels "
          f"{GS_GOLDEN_CHANS} vs the f64 numpy golden: worst error "
          f"{worst:.3g} of the FFT bound")


class EgressSink(object):
    """The pooled DeviceSinkBlock of benchmarks/egress_tpu.py: counts the
    bytes handed to it and stamps the host clock at each gulp;
    `check(frame_offset, arr)` (optional) verifies a gulp."""

    def __new__(cls, iring, check=None):
        from bifrost_tpu_torch.egress import DeviceSinkBlock

        class Sink(DeviceSinkBlock):
            def on_sink_sequence(self, iseq):
                self.egressed_bytes = 0
                self.bad = []
                self.stamps = []

            def on_sink_data(self, arr, frame_offset):
                self.stamps.append(time.perf_counter())
                self.egressed_bytes += arr.nbytes
                if check is not None and not check(frame_offset, arr):
                    self.bad.append(frame_offset)

        return Sink(iring, name="egress_sink")


class ReplaySource(object):
    """A source of `nframe` one-frame gulps replaying `frames` in turn
    (numpy into a 'system' ring, a tensor on the card into a 'cuda'
    ring): the image stream without the memory of every frame."""

    def __new__(cls, frames, nframe):
        import contextlib

        from bifrost_tpu_torch.pipeline import SourceBlock
        on_card = isinstance(frames, torch.Tensor)
        src = frames if on_card else torch.from_numpy(frames)

        class Source(SourceBlock):
            def create_reader(self, name):
                @contextlib.contextmanager
                def reader():
                    self.i = 0
                    yield self
                return reader()

            def on_sequence(self, reader, name):
                return [{"name": name, "_tensor": {
                    "dtype": "cf32", "shape": [-1] + list(src.shape[1:]),
                    "labels": ["time", "chan", "v", "u"]}}]

            def on_data(self, reader, ospans):
                if self.i == nframe:
                    return [0]
                ospans[0].data[0].copy_(src[self.i % len(src)])
                self.i += 1
                return [1]

        return Source(["images"], 1, space="cuda" if on_card else "system",
                      name="replay")


def eg_run(dev, feed, nbyte, mode, depth, check=None, skip=0):
    """One timed run of feed() (the block whose output is the 'cuda'
    ring) -> sink, `mode` 'staged' or 'blocking' (the DeviceSinkBlock) or
    'copy' (copy('system') -> callback_sink); `nbyte` the stream's bytes.
    -> ((bytes/s whole run, bytes/s from gulp `skip` on the host to the
    last), sink, host s by block and phase)."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch import config
    from bifrost_tpu_torch.blocks import callback_sink, copy
    config.set("egress_staging", mode == "staged")
    config.set("pipeline_async_depth", depth if mode == "staged" else 1)
    try:
        with bt.Pipeline(device=dev) as pipe:
            d = feed()
            if mode == "copy":
                got = {"n": 0, "bad": [], "stamps": []}

                def count(t):
                    got["stamps"].append(time.perf_counter())
                    off = got["n"] // (t.numel() * t.element_size() //
                                       len(t)) if len(t) else 0
                    got["n"] += t.numel() * t.element_size()
                    if check is not None and not check(off, t.numpy()):
                        got["bad"].append(off)
                snk = callback_sink(copy(d, space="system", name="d2h"),
                                    on_data=count, name="egress_sink")
            else:
                snk = EgressSink(d, check=check)
            t0 = time.perf_counter()
            pipe.run()
            dt = time.perf_counter() - t0
    finally:
        config.reset("pipeline_async_depth")
        config.reset("egress_staging")
    if mode == "copy":
        snk.egressed_bytes, snk.bad = got["n"], got["bad"]
        snk.stamps = got["stamps"]
    elif mode == "staged" and not snk._egress_drained_gulps:
        raise AssertionError("the stager was not engaged")
    perf = {b.name: {k: round(v, 4) for k, v in b.perf_totals.items()}
            for b in pipe.blocks}
    if snk.egressed_bytes != nbyte or snk.bad:
        raise AssertionError(f"{mode}: {snk.egressed_bytes} of {nbyte} "
                             f"bytes, gulps differing at {snk.bad}")
    st = snk.stamps
    steady = (len(st) - 1 - skip) * (nbyte / len(st)) / (st[-1] - st[skip]) \
        if len(st) > skip + 1 else float("nan")
    return (nbyte / dt, steady), snk, perf


def eg_d2h_times(dev, nbyte, reps=3):
    """Host ms of one `nbyte` device->host copy: the stager (one copy
    into a pinned pool buffer on its stream, then the wait), a
    pageable `copy_` into a buffer used before (the copy block's D2H
    into its ring), into a new pageable buffer each time (the blocking
    sink path's), and one pinned `copy_`."""
    from bifrost_tpu_torch.egress import EgressStager
    from bifrost_tpu_torch.ring import TensorInfo
    x = torch.ones(nbyte // 4, device=dev)
    tinfo = TensorInfo({"_tensor": {"dtype": "f32",
                                    "shape": [-1, nbyte // 4 // 1024]}})
    st = EgressStager("d2h", depth=2, device=dev)
    pageable = torch.empty(nbyte // 4)
    pinned = torch.empty(nbyte // 4, pin_memory=True)
    t = {}
    for name, fn in (
            ("stager", lambda: st.release(_wait(st.stage(
                x.view(1024, -1), tinfo, 1024, 0)))),
            ("pageable", lambda: pageable.copy_(x)),
            ("pageable_new", lambda: torch.empty(nbyte // 4).copy_(x)),
            ("pinned", lambda: pinned.copy_(x))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        t[name] = (time.perf_counter() - t0) / reps * 1e3
    st.close()
    return t


def _wait(ticket):
    ticket.wait()
    return ticket


def egress_path(dev, kind):
    """The egress plane (module docstring, phase 10).  -> the kernels'
    launch counts over the runs."""
    reset_counts()
    rng = np.random.default_rng(0)
    dump = rng.random(EG_DUMP["shape"]).astype(np.float32)
    gulps = {}

    def dump_feed():
        from bifrost_tpu_torch.blocks import array_source, copy
        return copy(array_source(dump, EG_DUMP["gulp"]), space="cuda",
                    name="h2d")

    def keep(mode):
        def check(off, arr):
            gulps.setdefault(mode, []).append(np.array(arr))
            return True
        return check

    rates = {"staged": [], "blocking": []}
    for _ in range(EG_PAIRS):
        for mode in ("staged", "blocking"):
            gulps.pop(mode, None)
            bps, _, perf = eg_run(dev, dump_feed, dump.nbytes, mode,
                                  EG_DUMP["depth"], keep(mode))
            rates[mode].append(bps[0])
            got = np.concatenate(gulps[mode])
            if not np.array_equal(got.view(np.uint32),
                                  dump.view(np.uint32)):
                raise AssertionError(f"dump {mode}: output differs")
    phase("egress", f"bench.py dump shape {EG_DUMP['shape']} f32, gulp "
          f"{EG_DUMP['gulp']}, depth {EG_DUMP['depth']}, {EG_PAIRS} pairs "
          f"in turns: staged " + ", ".join(f"{r:.4g}" for r in
                                           rates["staged"]) +
          " B/s; blocking " + ", ".join(f"{r:.4g}" for r in
                                        rates["blocking"]) +
          " B/s (host clock); every run bitwise equal to the source")

    g = EG_IMAGE
    gen = torch.Generator().manual_seed(SEED)
    frame = torch.randn(g["shape"], dtype=torch.complex64,
                        generator=gen).numpy()
    frames = np.stack([frame * (i + 1) for i in range(g["ndistinct"])])
    del frame
    on_card = torch.from_numpy(frames).to(dev)
    nb = frames[0].nbytes
    from bifrost_tpu_torch.blocks import copy
    feeds = {
        "host": lambda n: lambda: copy(ReplaySource(frames, n),
                                       space="cuda", name="h2d"),
        "card": lambda n: lambda: ReplaySource(on_card, n)}

    def same(off, arr):
        return np.array_equal(arr.view(np.uint64),
                              frames[off % len(frames)][None].view(np.uint64))

    modes = ("staged", "blocking", "copy")
    rates = {(f, m): [] for f in feeds for m in modes}
    perfs = {}
    for _ in range(EG_PAIRS):
        for f in feeds:
            for mode in modes:
                bps, _, perfs[f"{f} {mode}"] = eg_run(
                    dev, feeds[f](g["nframe"]), g["nframe"] * nb, mode,
                    g["depth"], skip=g["skip"])
                rates[f, mode].append(bps)
    for f in feeds:
        for mode in modes:
            eg_run(dev, feeds[f](g["check_nframe"]), g["check_nframe"] * nb,
                   mode, g["depth"], check=same)
    del on_card
    d2h = eg_d2h_times(dev, nb)
    counts = read_counts()
    if counts != expected():
        raise AssertionError(f"launches {counts}: the egress runs no hand "
                             f"kernel")

    def fmt(rs):
        return ", ".join(f"{w:.4g} / {st:.4g}" for w, st in rs)

    for f, how in (("host", "from the host: replaying source -> "
                    "copy('cuda')"),
                   ("card", "from the card: replaying source on the "
                    "'cuda' ring")):
        phase("egress", f"image frame {g['shape']} cf32 ({nb / 2**20:.0f} "
              f"MiB a gulp, {g['nframe']} gulps of {g['ndistinct']} "
              f"distinct frames, depth {g['depth']}) fed {how}; "
              f"{EG_PAIRS} rounds in turns, B/s on the host clock, whole "
              f"run / steady from gulp {g['skip']} to the last: staged "
              f"{fmt(rates[f, 'staged'])}; blocking "
              f"{fmt(rates[f, 'blocking'])}; copy('system') -> "
              f"callback_sink {fmt(rates[f, 'copy'])}; every gulp of one "
              f"more run of each ({g['check_nframe']} gulps) bitwise equal "
              f"to the source; {kind}")
    phase("egress", f"one {nb / 2**20:.0f} MiB D2H alone: stager "
          f"{d2h['stager']:.2f} ms, pageable copy_ {d2h['pageable']:.2f} "
          f"ms (into a new buffer {d2h['pageable_new']:.2f} ms), pinned "
          f"copy_ {d2h['pinned']:.2f} ms; {kind}")
    phase("egress", f"image frame host seconds by block and phase (last "
          f"round): {json.dumps(perfs)}")
    return counts


IPC_SHM_CONSUMER = r"""
import hashlib, json, sys, time
import numpy as np
from bifrost_tpu_torch import Pipeline
from bifrost_tpu_torch.blocks import callback_sink, shm_receive
name, gulp = sys.argv[1], int(sys.argv[2])
stamps, sizes, spent = [], [], [0.0]
def on_sequence(h):
    print("HEADER " + json.dumps(h, sort_keys=True), flush=True)
def on_data(d):
    t0 = time.perf_counter()
    a = np.ascontiguousarray(d.numpy())
    digest = hashlib.sha256(a).hexdigest()
    stamps.append(time.perf_counter())
    spent[0] += stamps[-1] - t0
    sizes.append(a.nbytes)
    print("GULP %d %s" % (a.nbytes, digest), flush=True)
with Pipeline(device="cpu") as pipe:
    callback_sink(shm_receive(name, gulp_nframe=gulp),
                  on_sequence=on_sequence, on_data=on_data)
    pipe.run()
print("DONE %d %d %.6f %.6f" % (sum(sizes), sizes[0],
                                stamps[-1] - stamps[0], spent[0]),
      flush=True)
"""

IPC_DADA_CONSUMER = r"""
import hashlib, sys, time
from bifrost_tpu_torch.io.dada_ipc import DadaHDU
key, timeout = int(sys.argv[1], 0), float(sys.argv[2])
deadline = time.monotonic() + timeout
while True:
    try:
        hdu = DadaHDU(key, create=False)
        break
    except (OSError, RuntimeError):
        if time.monotonic() > deadline:
            raise
        time.sleep(0.05)
try:
    header = hdu.read_header(timeout=timeout)
    if header is None:
        raise SystemExit("no DADA header")
    print("HEADER " + header.replace("\n", "\\n"), flush=True)
    stamps, sizes, spent = [], [], 0.0
    while True:
        got = hdu.data.open_read_buf(timeout=timeout)
        if got is None:
            raise SystemExit("no DADA buffer within the timeout")
        if got == "EOD":
            break
        buf, nbyte = got
        t0 = time.perf_counter()
        digest = hashlib.sha256(buf[:nbyte]).hexdigest()
        hdu.data.mark_cleared()
        stamps.append(time.perf_counter())
        spent += stamps[-1] - t0
        sizes.append(nbyte)
        print("GULP %d %s" % (nbyte, digest), flush=True)
finally:
    hdu.close()
print("DONE %d %d %.6f %.6f" % (sum(sizes), sizes[0], stamps[-1] - stamps[0],
                                spent), flush=True)
"""

IPC_DADA_PRODUCER = r"""
import sys
import numpy as np
from bifrost_tpu_torch.blocks.testing import inject_burst
from bifrost_tpu_torch.io.dada_ipc import DadaHDU
key = int(sys.argv[1], 0)
seed, gulp, ngulp, nchan, t0, dm_row, f0, df, dt = (
    int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]),
    int(sys.argv[6]), int(sys.argv[7]), float(sys.argv[8]),
    float(sys.argv[9]), float(sys.argv[10]))
rng = np.random.default_rng(seed)
data = rng.integers(0, 32, (gulp * ngulp, nchan)).astype(np.uint8)
inject_burst(data, t0, dm_row, f0, df, amp=60)
raw = memoryview(data).cast("B")
hdu = DadaHDU(key, create=False)
try:
    hdu.write_header(
        "HDR_VERSION 1.0\nOBS_ID frb_ipc\nNBIT 8\nNDIM 1\nNPOL 1\n"
        "NCHAN %d\nFREQ %r\nCHAN_BW %r\nTSAMP %r\n" % (nchan, f0, df,
                                                     dt * 1e6))
    hdu.data.start_of_data()
    off = 0
    while off < len(raw):
        buf, _ = hdu.data.open_write_buf(timeout=120)
        n = min(len(buf), len(raw) - off)
        buf[:n] = raw[off:off + n]
        hdu.data.mark_filled(n)
        off += n
    hdu.data.end_of_data()
finally:
    hdu.close()
print("PRODUCER-DONE %d" % len(raw), flush=True)
"""


def ipc_limits():
    """The limits of /dev/shm and SysV IPC, read (never changed)."""
    st = os.statvfs("/dev/shm")
    lim = {"dev_shm_free": st.f_bavail * st.f_frsize}
    for key in ("shmmax", "shmall", "sem"):
        with open(f"/proc/sys/kernel/{key}") as f:
            lim[key] = f.read().split()
    lim["shmmax"] = int(lim["shmmax"][0])
    lim["shmall_bytes"] = int(lim["shmall"][0]) * os.sysconf("SC_PAGE_SIZE")
    return lim


def ipc_sizes(lim, gulp_nbyte, wire_frame):
    """-> (shm ring bytes, DADA nbufs, DADA bufsz) within the limits: aim
    for IPC_RING_GULPS and IPC_DADA_NBUFS gulps; a ring smaller than a
    gulp still carries it (the wrap), never a frame cut."""
    cap = min(IPC_RING_GULPS * gulp_nbyte, lim["dev_shm_free"] // 2)
    cap = cap // wire_frame * wire_frame
    if cap < wire_frame:
        raise AssertionError(f"/dev/shm has {lim['dev_shm_free']} bytes "
                             f"free: no room for a shm ring")
    bufsz = min(gulp_nbyte, lim["shmmax"]) // wire_frame * wire_frame
    nbufs = min(IPC_DADA_NBUFS, lim["shmall_bytes"] // 2 // max(1, bufsz))
    if bufsz < wire_frame or nbufs < 2:
        raise AssertionError(f"SysV limits {lim}: no room for a DADA ring "
                             f"of 2 buffers of a frame")
    return cap, nbufs, bufsz


def ipc_child(code, args, out_path):
    """A fresh interpreter running `code` (only bifrost_tpu_torch is
    imported there), its output to `out_path`."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)],
                            stdout=open(out_path, "w"),
                            stderr=subprocess.STDOUT, env=env,
                            cwd=str(Path(__file__).resolve().parent))


def ipc_wait(proc, out_path, what):
    """Wait for a child within IPC_CHILD_TIMEOUT; -> its output lines.  A
    child that fails or overruns fails the phase."""
    try:
        rc = proc.wait(timeout=IPC_CHILD_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    text = Path(out_path).read_text()
    if rc != 0:
        raise AssertionError(f"{what} exited {rc}:\n{text[-3000:]}")
    return text.splitlines()


def ipc_kill(procs):
    for proc in procs:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def ipc_remove_dada(key, nbufs):
    """Remove an HDU's SysV segments and semaphores where they are left
    (a run that failed before its sink's shutdown)."""
    from bifrost_tpu_torch.io import dada_ipc as di
    for base, n in ((key, nbufs), (key + di.HDR_KEY_OFFSET, 2)):
        for k in range(base, base + n + 1):
            try:
                di._shm_rm(di._shmget(k, 0, 0))
            except OSError:
                pass
        try:
            di._sem_rm(di._semget(base, 0, 0))
        except OSError:
            pass


def ipc_digests(lines):
    """-> (header line, [(nbyte, sha256)], (total bytes, first gulp's
    bytes, seconds first to last gulp, seconds copying and hashing))."""
    head = [ln[7:] for ln in lines if ln.startswith("HEADER ")]
    gulps = [(int(ln.split()[1]), ln.split()[2]) for ln in lines
             if ln.startswith("GULP ")]
    done = [ln.split()[1:] for ln in lines if ln.startswith("DONE ")]
    if len(head) != 1 or not done:
        raise AssertionError(f"consumer output: {lines[-5:]}")
    total, first, secs, spent = int(done[0][0]), int(done[0][1]), \
        float(done[0][2]), float(done[0][3])
    return head[0], gulps, (total, first, secs, spent)


def sha(a):
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


def ipc_pinned(cores):
    """A scope factory that pins the i-th block built to cores[i % n]."""
    import itertools
    import bifrost_tpu_torch as bt
    it = itertools.cycle(cores)
    return lambda name: bt.block_scope(core=next(it))


def ipc_frb(dev, src_fn, gather, headers=None, cores=None, sinks=None):
    """One FRB search in a new pipeline: `src_fn()` the source block,
    then frb_search_chain; `sinks(fdmt_block)` adds sinks on the FDMT's
    ring; `cores`: the i-th block built is pinned to cores[i % n].  ->
    (detector, ledger, pipeline, seconds, steady frames/s)."""
    import bifrost_tpu_torch as bt
    from bifrost_tpu_torch.blocks import gather_sink
    from bifrost_tpu_torch.service import frb_search_chain
    scope = ipc_pinned(cores) if cores else None

    def at(name):
        return scope(name) if scope else contextlib.nullcontext()
    pipe = bt.Pipeline(device=dev)
    with pipe:
        with at("capture"):
            src = src_fn()
        det, ledger = frb_search_chain(src, GULP, MAX_DELAY, scope=scope)
        fd = det.iring.owner
        with at("ipc_gather"):
            gather_sink(fd, gather, headers, name="ipc_gather")
        if sinks is not None:
            sinks(fd)
    reset_counts()
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = read_counts()
    nsteps = len(fd.fdmt._steps)
    if counts != expected(fdmt_merge_step=nsteps * NGULP):
        raise AssertionError(f"launches {counts}: expected "
                             f"{nsteps * NGULP} of fdmt_merge_step alone")
    steady = (ledger.committed_frames - ledger.first_sink_nframe) / \
        (t1 - ledger.first_sink_t)
    return det, ledger, pipe, t1 - t0, steady, counts


def frb_src(data):
    from bifrost_tpu_torch.blocks import array_source
    return lambda: array_source(data, GULP, header={
        "labels": ["time", "freq"], "scales": [[0.0, DT], [F0, DF]],
        "units": ["s", "MHz"]}, name="capture")


def same_gulps(a, b):
    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x.view(np.uint32),
                                              y.view(np.uint32))
        for x, y in zip(a, b))


def ipc_stamp(sink):
    """Note the host clock at each gulp the sink retires."""
    sink.stamps = []
    drain = sink._drain_one_egress

    def stamped():
        drain()
        sink.stamps.append(time.perf_counter())
    sink._drain_one_egress = stamped


def ipc_rate(sink, nbyte_after_first):
    st = sink.stamps
    return nbyte_after_first / (st[-1] - st[0]) if len(st) > 1 \
        else float("nan")


def ipc_path(dev, kind, smi, ref):
    """The inter-process and file I/O plane (module docstring, phase 19).
    `ref`: [main]'s steady rate, dedispersed gulps and candidates.  ->
    launch counts by path."""
    import tempfile
    from bifrost_tpu_torch import affinity, proclog, shmring
    from bifrost_tpu_torch.blocks import (copy, dada_ipc_send, deserialize,
                                          gather_sink, read_psrdada_buffer,
                                          serialize, shm_send)
    from bifrost_tpu_torch.io import dada_ipc
    from bifrost_tpu_torch.ring import frame_major_header

    data = frb_data()
    pid = os.getpid()
    shm_name, bridge_name = f"ipc_{pid}", f"ipc_bridge_{pid}"
    key = 0x51000000 + (pid & 0xFFFF) * 0x400
    key_in = key + 0x200
    gulp_nbyte = MAX_DELAY * GULP * 4
    wire_frame = MAX_DELAY * 4
    lim = ipc_limits()
    cap, nbufs, bufsz = ipc_sizes(lim, gulp_nbyte, wire_frame)
    phase("ipc", f"limits: /dev/shm {lim['dev_shm_free']} B free, shmmax "
          f"{lim['shmmax']}, shmall {lim['shmall'][0]} pages "
          f"({lim['shmall_bytes']} B), sem {' '.join(lim['sem'])}; chose "
          f"a shm ring of {cap} B ({cap / gulp_nbyte:.2f} gulps of "
          f"{gulp_nbyte} B) and a DADA ring of {nbufs} x {bufsz} B")
    tmp = tempfile.mkdtemp(prefix="ipc_")
    procs = []
    counts = {}
    try:
        # (a) three sinks on the FDMT's ring, two consumer processes.
        shm_out, dada_out = f"{tmp}/shm.out", f"{tmp}/dada.out"
        procs.append(ipc_child(IPC_SHM_CONSUMER, [shm_name, GULP], shm_out))
        procs.append(ipc_child(IPC_DADA_CONSUMER, [hex(key),
                                                  IPC_CHILD_TIMEOUT],
                               dada_out))
        sinks = {}

        def add_sinks(fd):
            sinks["shm"] = shm_send(fd, shm_name, data_capacity=cap,
                                    min_readers=1,
                                    reader_timeout=IPC_CHILD_TIMEOUT)
            sinks["dada"] = dada_ipc_send(fd, key, nbufs=nbufs, bufsz=bufsz,
                                          write_timeout=IPC_CHILD_TIMEOUT,
                                          name="ipc_dada")
            sinks["serialize"] = serialize(fd, path=f"{tmp}/ser",
                                           max_file_size=IPC_FILE_SIZE,
                                           name="ipc_serialize")
            for snk in sinks.values():
                ipc_stamp(snk)
        os.makedirs(f"{tmp}/ser")
        gather, headers = [], []
        det, ledger, pipe, wall, steady, counts["ipc"] = ipc_frb(
            dev, frb_src(data), gather, headers, sinks=add_sinks)
        shm_lines = ipc_wait(procs[0], shm_out, "shm consumer")
        dada_lines = ipc_wait(procs[1], dada_out, "DADA consumer")
        if not same_gulps(gather, ref["gathered"]):
            raise AssertionError("[ipc] gather differs from [main]'s")
        hdr = headers[0]
        wire_hdr = json.loads(json.dumps(frame_major_header(hdr)))
        logical = np.concatenate(gather, axis=1)          # (dm, frames)
        wire = [np.ascontiguousarray(g.T) for g in gather]
        frames = np.concatenate(wire)                     # (frames, dm)
        # shm: the consumer's frame-major gulps of GULP frames.
        shm_head, shm_gulps, shm_done = ipc_digests(shm_lines)
        want = [(frames[f:f + GULP].nbytes, sha(frames[f:f + GULP]))
                for f in range(0, len(frames), GULP)]
        if shm_gulps != want:
            raise AssertionError(f"shm stream differs: {len(shm_gulps)} "
                                 f"gulps against {len(want)}")
        if json.loads(shm_head) != wire_hdr:
            raise AssertionError(f"shm header {shm_head} != {wire_hdr}")
        # DADA: buffers of bufsz within each gulp, frame-major.
        dada_head, dada_bufs, dada_done = ipc_digests(dada_lines)
        want = [(len(w.reshape(-1)[o:o + bufsz // 4]) * 4,
                 sha(w.reshape(-1)[o:o + bufsz // 4]))
                for w in wire for o in range(0, w.size, bufsz // 4)]
        if dada_bufs != want:
            raise AssertionError(f"DADA stream differs: {len(dada_bufs)} "
                                 f"buffers against {len(want)}")
        dada_hdr = dict(ln.split(" ", 1) for ln in
                        dada_head.split("\\n") if " " in ln)
        if json.loads(dada_hdr["TENSOR_JSON"]) != wire_hdr["_tensor"] or \
                dada_hdr.get("NAME") != str(hdr["name"]):
            raise AssertionError(f"DADA header {dada_hdr} != {wire_hdr}")
        # serialize: three or more sets of files, read back on the card.
        names = glob.glob(f"{tmp}/ser/*.bf.json")
        dats = glob.glob(f"{tmp}/ser/*.dat")
        nsets = len({os.path.basename(f).split(".")[2] for f in dats})
        if len(names) != 1 or nsets < 3:
            raise AssertionError(f"serialized {names}, {nsets} file sets")
        with open(names[0]) as f:
            if json.load(f) != json.loads(json.dumps(hdr)):
                raise AssertionError("serialized header differs")
        back = []
        import bifrost_tpu_torch as bt
        with bt.Pipeline(device=dev) as rpipe:
            gather_sink(copy(deserialize([names[0][:-5]], GULP),
                             space="cuda", name="ipc_h2d"), back,
                        name="ipc_back")
            rpipe.run()
        torch.cuda.synchronize()
        if not np.array_equal(np.concatenate(back, axis=1).view(np.uint32),
                              logical.view(np.uint32)):
            raise AssertionError("deserialized stream differs")
        check_burst(det)
        after = sum(g.nbytes for g in gather[1:])
        rates = {k: ipc_rate(v, after) for k, v in sinks.items()}
        phase("ipc", f"(a) FRB search {NCHAN} ch x {GULP * NGULP} frames "
              f"with shm_send, dada_ipc_send and serialize on its FDMT's "
              f"'cuda' ring: {wall:.3f} s, steady {steady:.1f} frames/s "
              f"against [main]'s {ref['steady']:.1f} "
              f"({steady / ref['steady'] * 100:.1f} %); sink B/s on the "
              f"host clock, first to last gulp: " +
              ", ".join(f"{k} {v:.4g}" for k, v in rates.items()) +
              f"; consumers received shm {shm_done[0]} B at "
              f"{(shm_done[0] - shm_done[1]) / shm_done[2]:.4g} B/s, DADA "
              f"{dada_done[0]} B at "
              f"{(dada_done[0] - dada_done[1]) / dada_done[2]:.4g} B/s; "
              f"the consumers' own copy and hash seconds shm "
              f"{shm_done[3]:.3f}, DADA {dada_done[3]:.3f} of "
              f"{shm_done[2]:.3f}, {dada_done[2]:.3f}; "
              f"{len(shm_gulps)} shm gulps, {len(dada_bufs)} DADA buffers "
              f"and {len(dats)} files in {nsets} sets bitwise the gather; "
              f"staged {sinks['shm']._egress_drained_gulps} / "
              f"{sinks['dada']._egress_drained_gulps} gulps; launches "
              f"{counts['ipc']['fdmt_merge_step']}; {smi}")
        if not sinks["shm"]._egress_drained_gulps or \
                not sinks["dada"]._egress_drained_gulps:
            raise AssertionError("shm/DADA sinks did not take the staged "
                                 "path")
        perf = {b.name: {k: round(v, 4) for k, v in b.perf_totals.items()}
                for b in pipe.blocks}
        phase("ipc", f"(a) host seconds by block and phase: "
              f"{json.dumps(perf)}")
        del pipe, sinks, gather, back, logical, wire, frames
        free_device()

        # (b) a DADA producer -> the bridge -> read_psrdada_buffer.
        hdu = dada_ipc.DadaHDU(key_in, nbufs=4,
                               bufsz=min(GULP * NCHAN, lim["shmmax"]),
                               create=True)
        try:
            prod_out, br_out = f"{tmp}/producer.out", f"{tmp}/bridge.out"
            procs.append(ipc_child(IPC_DADA_PRODUCER, [
                hex(key_in), SEED, GULP, NGULP, NCHAN, T0, DM_ROW, F0, DF,
                DT], prod_out))
            env = dict(os.environ,
                       PYTHONPATH=str(Path(__file__).resolve().parent))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "bifrost_tpu_torch.dada_bridge",
                 "--key", hex(key_in), "--name", bridge_name, "--oneshot",
                 "--gulp-frames", str(GULP), "--timeout",
                 str(IPC_CHILD_TIMEOUT), "--capacity",
                 str(min(4 * GULP * NCHAN, cap))],
                stdout=open(br_out, "w"), stderr=subprocess.STDOUT,
                env=env, cwd=str(Path(__file__).resolve().parent)))

            def typed(dada):
                return {"_tensor": {
                    "dtype": "u8", "shape": [-1, int(dada["NCHAN"])],
                    "labels": ["time", "freq"],
                    "scales": [[0.0, float(dada["TSAMP"]) / 1e6],
                               [float(dada["FREQ"]),
                                float(dada["CHAN_BW"])]],
                    "units": ["s", "MHz"]}}
            got = []
            det2, _, _, wall2, steady2, counts["ipc_dada_ingest"] = ipc_frb(
                dev, lambda: read_psrdada_buffer(bridge_name, typed, GULP),
                got)
            ipc_wait(procs[2], prod_out, "DADA producer")
            br = ipc_wait(procs[3], br_out, "dada_bridge")
        finally:
            hdu.close()
        if not same_gulps(got, ref["gathered"]):
            raise AssertionError("DADA-fed dedispersed gulps differ from "
                                 "[main]'s")
        if det2.candidates != ref["cands"]:
            raise AssertionError("DADA-fed candidates differ from [main]'s")
        best = check_burst(det2)
        phase("ipc", f"(b) DADA HDU -> dada_bridge -> read_psrdada_buffer "
              f"-> FRB search: {wall2:.3f} s, steady {steady2:.1f} "
              f"frames/s against [main]'s {ref['steady']:.1f}; "
              f"dedispersed gulps and candidates bitwise [main]'s, "
              f"candidate {best}; bridge: {br[-1]}; launches "
              f"{counts['ipc_dada_ingest']['fdmt_merge_step']}; {smi}")
        del got
        free_device()

        # (c) unpinned against every block on its own core, in turns.
        avail = sorted(os.sched_getaffinity(0))
        rates = {"unpinned": [], "pinned": []}
        outs = {}
        total = None
        for _ in range(IPC_TURNS):
            for mode in ("unpinned", "pinned"):
                cores = avail if mode == "pinned" else None
                seen = {}
                out = []
                det3, _, pipe3, _, st3, c3 = ipc_frb(
                    dev, frb_src(data), out, cores=cores,
                    sinks=lambda fd: ipc_cores(fd.pipeline, seen))
                total = c3 if total is None else \
                    {k: total[k] + c3[k] for k in total}
                rates[mode].append(st3)
                outs.setdefault(mode, out)
                if not same_gulps(out, outs["unpinned"]):
                    raise AssertionError(f"{mode} run differs")
                if mode == "pinned":
                    tree = proclog.load_by_pid(os.getpid())
                    for i, b in enumerate(pipe3.blocks):
                        core = avail[i % len(avail)]
                        bind = tree.get(b.name, {}).get("bind", {})
                        if seen.get(b.name) != core or \
                                bind.get("core") != core:
                            raise AssertionError(
                                f"{b.name}: pinned to {core}, get_core "
                                f"{seen.get(b.name)}, bind {bind}")
                elif any(v != -1 for v in seen.values()):
                    raise AssertionError(f"unpinned threads: {seen}")
                del pipe3
        counts["ipc_affinity"] = total
        if not same_gulps(outs["pinned"], ref["gathered"]):
            raise AssertionError("pinned run differs from [main]'s")
        phase("ipc", f"(c) FRB search without sinks, {IPC_TURNS} turns, "
              f"steady frames/s unpinned " +
              ", ".join(f"{r:.1f}" for r in rates["unpinned"]) +
              "; each block on its own core of " + str(avail) + " " +
              ", ".join(f"{r:.1f}" for r in rates["pinned"]) +
              f"; every pinned thread's core from affinity.get_core() and "
              f"its bind proclog, outputs bitwise; {smi}")
    finally:
        ipc_kill(procs)
        for name in (shm_name, bridge_name):
            try:
                shmring.unlink(name)
            except Exception:  # noqa: BLE001 — already gone
                pass
        ipc_remove_dada(key, nbufs)
        ipc_remove_dada(key_in, 4)
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


def ipc_cores(pipe, seen):
    """Have each block of `pipe` note, from inside its thread, the core
    affinity.get_core() reads there."""
    from bifrost_tpu_torch import affinity
    for b in list(pipe.blocks):
        run = b.main

        def main(b=b, run=run):
            seen[b.name] = affinity.get_core()
            return run()
        b.main = main


def mesh_of(dev, axes, shape=None):
    from bifrost_tpu_torch.parallel import make_mesh, virtual_devices
    return make_mesh(devices=virtual_devices(MESH_N, dev), axis_names=axes,
                     shape=shape)


def mesh_b_run(dev, arr, w, mesh=None, shard=None, defer=True, tail=False,
               pfb=False):
    """One B-engine run: array_source(arr) -> copy('cuda') [-> pfb] ->
    beamform(w, N_INT) [-> accumulate(MESH_TAIL)] -> a sink on the card,
    in a mesh scope where `mesh` is given (and a fuse scope with `tail`,
    the mesh_chain rule's), `mesh_defer_reduce` = `defer`.  `arr`:
    channelized ci8 (time, freq, station, pol, 2), or with `pfb`
    [bengine]'s (time, station, pol, 2) voltages.  -> dict of the output
    frames (on the card), their host stamps, wall seconds, launch counts,
    the collectives, the shard copies, the fused groups and the
    beamform route."""
    from bifrost_tpu_torch import block_scope, config, proclog
    from bifrost_tpu_torch.blocks import (accumulate, array_source,
                                          beamform, callback_sink, copy)
    from bifrost_tpu_torch.blocks import pfb as pfb_block
    from bifrost_tpu_torch.parallel import collective
    from bifrost_tpu_torch.parallel import shard as pshard
    from bifrost_tpu_torch.pipeline import MeshFusedBlock, Pipeline
    outs, stamps = [], []

    def keep(a):
        outs.append(a.clone())
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    scope = {}
    if mesh is not None:
        scope["mesh"] = mesh
        if shard:
            scope["shard"] = shard
        if tail:
            scope["fuse"] = True
    if pfb:
        hdr = {"dtype": "ci8", "labels": ["time", "station", "pol"],
               "scales": [[0.0, B_DT], None, None]}
        gulp = B_GULP
    else:
        hdr = {"dtype": "ci8",
               "labels": ["time", "freq", "station", "pol"]}
        gulp = N_INT
    config.set("mesh_defer_reduce", defer)
    try:
        with Pipeline(device=dev) as pipe:
            src = array_source(arr, gulp, header=hdr)
            with block_scope(**scope):
                x = copy(src, space="cuda")
                if pfb:
                    x = pfb_block(x, BCHAN, ntap=NTAP)
                b = beamform(x, w, N_INT, gulp_nframe=N_INT)
                head = b
                if tail:
                    b = accumulate(b, MESH_TAIL)
            callback_sink(b, on_data=keep, gulp_nframe=1)
            pipe._fuse_device_chains()
            reset_counts()
            collective.reset_totals()
            pshard.reset_copy_stats()
            t0 = time.perf_counter()
            pipe.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        config.reset("mesh_defer_reduce")
    groups = [g.name for g in pipe.blocks if isinstance(g, MeshFusedBlock)]
    row = proclog.load_by_pid(os.getpid()).get(head.log_name, {})
    return {"outs": outs, "stamps": stamps, "wall": wall,
            "counts": read_counts(), "coll": collective.totals(),
            "copies": pshard.copy_stats(), "groups": groups,
            "route": row.get("beamform_plan", {}).get("route")}


def mesh_steady(run, frames_per_out):
    st = run["stamps"]
    return (len(st) - 1) * frames_per_out / (st[-1] - st[0])


def mesh_same(a, b, what):
    if len(a) != len(b) or not all(bits_equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: not bitwise equal "
                             f"({len(a)} vs {len(b)} frames)")


def mesh_a(dev, volt, counts, colls):
    """(a): the B-engine on the three layouts and the PFB-fed beam
    search (module docstring, phase 21)."""
    from bifrost_tpu_torch.service import default_beam_weights
    nsp = NSTAND * NPOL
    nspec = MESH_NINT * N_INT
    chan = volt[:nspec * BCHAN].reshape(nspec, BCHAN, NSTAND, NPOL, 2)
    w = default_beam_weights(NBEAM, nsp)
    nout = MESH_NINT // MESH_TAIL
    per_out = N_INT * MESH_TAIL * BCHAN       # voltage frames an output
    rates = {}
    for turn in range(MESH_TURNS):
        ref = mesh_b_run(dev, chan, w, tail=True)
        if ref["counts"] != expected(beamform_power=MESH_NINT):
            raise AssertionError(f"no-mesh launches {ref['counts']}")
        rates.setdefault("no mesh", []).append(mesh_steady(ref, per_out))
        if turn == 0:
            counts["mesh_a_nomesh"] = ref["counts"]
        for axes, shape, shard in MESH_LAYOUTS:
            mesh = mesh_of(dev, axes, shape)
            tag = "_".join(axes)
            stand = shard is not None
            for defer in (True, False):
                r = mesh_b_run(dev, chan, w, mesh=mesh, shard=shard,
                               defer=defer, tail=True)
                mode = "deferred_fused" if defer else "per_block"
                mesh_same(r["outs"], ref["outs"], f"[mesh] (a) {tag} {mode}")
                nk4 = 0 if stand else MESH_NINT * MESH_N
                if r["counts"] != expected(beamform_power=nk4):
                    raise AssertionError(f"{tag} {mode}: launches "
                                         f"{r['counts']}, K4 {nk4} expected")
                # Deferred: the one psum over 'time' at each emit (none
                # per gulp); the station layout's coherent psum is per gulp
                # by construction.  Per block: one psum a gulp.
                nred = MESH_NINT if (stand or not defer) else nout
                if r["coll"]["ops"] != {"all-reduce": nred}:
                    raise AssertionError(f"{tag} {mode}: collectives "
                                         f"{r['coll']}, {nred} expected")
                if defer and len(r["groups"]) != 1:
                    raise AssertionError(f"{tag}: groups {r['groups']}")
                want = "stand_matmul" if stand else "k4_per_shard"
                if r["route"] != want:
                    raise AssertionError(f"{tag}: route {r['route']}")
                rates.setdefault(f"{tag} {mode}", []).append(
                    mesh_steady(r, per_out))
                if turn == 0:
                    counts[f"mesh_a_{tag}_{mode}"] = r["counts"]
                    colls[f"mesh_a_{tag}_{mode}"] = r["coll"]
                    phase("mesh", f"(a) {tag} {dict(mesh.shape)} {mode}: "
                          f"{nout} outputs bitwise the no-mesh chain's; "
                          f"route {r['route']}; K4 {nk4} launches "
                          f"({MESH_NINT} gulps x {MESH_N if nk4 else 0} "
                          f"shards); collectives {r['coll']} over "
                          f"{MESH_NINT} gulps and {nout} emits; shard "
                          f"copies {r['copies']}; groups {r['groups']}")
    phase("mesh", "(a) steady voltage frames/s (first output to last, "
          f"{nout} outputs of {per_out} frames), {MESH_TURNS} turns: " +
          "; ".join(f"{k} {', '.join(f'{v:.1f}' for v in vs)}"
                    for k, vs in rates.items()))

    # The PFB-fed beam search: the time-sharded PFB (K2 a time shard, the
    # history handed over by one collective-permute a gulp) ahead of the
    # sharded K4.  The PFB's output is not integer valued, so the
    # time-sharded sums reassociate: within 2 N_INT eps32 of the no-mesh
    # chain, elementwise relative (each power a sum of N_INT non-negative
    # terms).
    v = volt[:MESH_PFB_NINT * B_GULP]
    ref = mesh_b_run(dev, v, w, pfb=True)
    mesh = mesh_of(dev, ("time", "freq"))
    r = mesh_b_run(dev, v, w, mesh=mesh, pfb=True)
    nt = mesh.shape["time"]
    pfb_shards = nt if N_INT // nt >= NTAP - 1 else 1
    tol = 2 * N_INT * float(np.finfo(np.float32).eps)
    err = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
              for a, b in zip(r["outs"], ref["outs"]))
    if len(r["outs"]) != MESH_PFB_NINT or not err <= tol:
        raise AssertionError(f"PFB-fed mesh beam search: rel err {err} "
                             f"(limit {tol})")
    want = expected(fir_mac=MESH_PFB_NINT * pfb_shards,
                    beamform_power=MESH_PFB_NINT * MESH_N)
    colls_want = {"all-reduce": MESH_PFB_NINT}
    if pfb_shards > 1:
        colls_want["collective-permute"] = MESH_PFB_NINT
    if r["counts"] != want or r["coll"]["ops"] != colls_want:
        raise AssertionError(f"PFB-fed launches {r['counts']}, "
                             f"collectives {r['coll']}")
    counts["mesh_a_pfb"] = r["counts"]
    colls["mesh_a_pfb"] = r["coll"]
    phase("mesh", f"(a) PFB-fed beam search on (time, freq) = (4, 2), "
          f"{MESH_PFB_NINT} integrations: max rel err {err:.3e} vs the "
          f"no-mesh chain (limit 2 N_INT eps32 = {tol:.3e}); launches "
          f"K2 {r['counts']['fir_mac']} ({MESH_PFB_NINT} gulps x "
          f"{pfb_shards} time shards), K4 {r['counts']['beamform_power']}"
          f"; collectives {r['coll']} (the PFB's halo a gulp, one psum an "
          f"emit); steady "
          f"{mesh_steady(r, N_INT * BCHAN):.1f} vs "
          f"{mesh_steady(ref, N_INT * BCHAN):.1f} voltage frames/s no mesh")


def mesh_x_run(dev, frames, nframe, mesh=None):
    """[xengine]'s raw head -> correlate(XE_NINT, int8) ->
    accumulate(MESH_X_NINT), fused by the mesh_chain rule under `mesh`
    -> dict as mesh_b_run's."""
    from bifrost_tpu_torch import block_scope
    from bifrost_tpu_torch.blocks import (accumulate, callback_sink, copy,
                                          correlate)
    from bifrost_tpu_torch.parallel import collective
    from bifrost_tpu_torch.parallel import shard as pshard
    from bifrost_tpu_torch.pipeline import MeshFusedBlock, Pipeline
    outs, stamps = [], []

    def keep(a):
        outs.append(a.clone())
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    scope = {"mesh": mesh, "fuse": True} if mesh is not None else {}
    with Pipeline(device=dev) as pipe:
        src = xe_source(frames, nframe)
        with block_scope(**scope):
            c = correlate(copy(src, space="cuda"), XE_NINT, engine="int8")
            a = accumulate(c, MESH_X_NINT)
        callback_sink(a, on_data=keep, gulp_nframe=1)
        pipe._fuse_device_chains()
        reset_counts()
        collective.reset_totals()
        pshard.reset_copy_stats()
        t0 = time.perf_counter()
        pipe.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"outs": outs, "stamps": stamps, "wall": wall,
            "counts": read_counts(), "coll": collective.totals(),
            "copies": pshard.copy_stats(),
            "groups": [g.name for g in pipe.blocks
                       if isinstance(g, MeshFusedBlock)]}


def mesh_b(dev, counts, colls):
    """(b): [xengine]'s int8 correlator on (time, freq) = (2, 4)."""
    frames = xe_frames()
    nframe = MESH_X_NINT * XE_NINT
    ngulp = nframe // XE_GULP
    ref = mesh_x_run(dev, frames, nframe)
    r = mesh_x_run(dev, frames, nframe,
                   mesh=mesh_of(dev, ("time", "freq")))
    for x, y in zip(r["outs"], ref["outs"]):
        if not bits_equal(torch.view_as_real(x), torch.view_as_real(y)):
            raise AssertionError("[mesh] (b): not bitwise the no-mesh run")
    if len(r["outs"]) != 1 or len(ref["outs"]) != 1:
        raise AssertionError(f"[mesh] (b): {len(r['outs'])} outputs")
    if r["counts"] != expected(xengine_int8=ngulp * MESH_N) or \
            ref["counts"] != expected(xengine_int8=ngulp):
        raise AssertionError(f"[mesh] (b) launches {r['counts']} / "
                             f"{ref['counts']}")
    if r["coll"]["ops"] != {"all-reduce": 1} or len(r["groups"]) != 1:
        raise AssertionError(f"[mesh] (b): collectives {r['coll']}, "
                             f"groups {r['groups']}")
    counts["mesh_b_fused"] = r["counts"]
    counts["mesh_b_nomesh"] = ref["counts"]
    colls["mesh_b_fused"] = r["coll"]
    nsp = XE_NSTAND * XE_NPOL
    phase("mesh", f"(b) int8 X-engine {XE_NCHAN} ch x {nsp} inputs, "
          f"gulps of {XE_GULP}, {MESH_X_NINT} integrations of {XE_NINT} "
          f"fused with accumulate({MESH_X_NINT}) on (time, freq) = (2, 4): "
          f"bitwise the no-mesh run; X1 {r['counts']['xengine_int8']} "
          f"launches ({ngulp} gulps x {MESH_N} shards); collectives "
          f"{r['coll']}: 0 over {ngulp} gulps, 1 all-reduce at the 1 emit; "
          f"shard copies {r['copies']}; {nframe / r['wall']:.1f} frames/s "
          f"whole vs {nframe / ref['wall']:.1f} no mesh")


def mesh_c(dev, volt, counts):
    """(c): (a)'s first layout as a supervised Service, a shard lost and
    its dispatch wedged (module docstring, phase 21)."""
    from bifrost_tpu_torch import block_scope, config
    from bifrost_tpu_torch.blocks import array_source, beamform, copy
    from bifrost_tpu_torch.faultinject import FaultPlan
    from bifrost_tpu_torch.parallel import faultdomain
    from bifrost_tpu_torch.pipeline import SinkBlock
    from bifrost_tpu_torch.service import (Service, ServiceSpec, StageSpec,
                                           default_beam_weights)
    from bifrost_tpu_torch.supervise import RestartPolicy
    nspec = MESH_NINT * N_INT
    chan = volt[:nspec * BCHAN].reshape(nspec, BCHAN, NSTAND, NPOL, 2)
    w = default_beam_weights(NBEAM, NSTAND * NPOL)
    clean = mesh_b_run(dev, chan, w)["outs"]
    mesh = mesh_of(dev, ("time", "freq"))
    lost = str(mesh.devices.flat[MESH_FAULT["lost"]])
    got = []

    class Keep(SinkBlock):
        def on_sequence(self, iseq):
            pass

        def on_data(self, ispan):
            got.append(ispan.data.clone())

    def scoped(fn):
        def factory(up, **k):
            with block_scope(mesh=mesh):
                return fn(up)
        return factory

    hdr = {"dtype": "ci8", "labels": ["time", "freq", "station", "pol"]}
    spec = ServiceSpec([
        StageSpec("custom", name="src", params=dict(
            factory=lambda _up, **k: array_source(chan, N_INT, header=hdr,
                                                  name="mesh_src"))),
        StageSpec("custom", name="h2d", params=dict(factory=scoped(
            lambda up: copy(up, space="cuda", name="mesh_h2d")))),
        StageSpec("custom", name="bengine", params=dict(factory=scoped(
            lambda up: beamform(up, w, N_INT, gulp_nframe=N_INT,
                                name="mesh_bengine"))),
            restart=RestartPolicy(max_restarts=4, window_s=60.0,
                                  backoff=0.01)),
        StageSpec("custom", name="sink", params=dict(
            factory=lambda up, **k: Keep(up, name="mesh_sink"))),
    ], degrade_shards=True)
    faultdomain.reset()
    config.set("mesh_collective_timeout_s", MESH_FAULT["timeout_s"])
    release = threading.Event()
    marks = {}
    try:
        svc = Service(spec, device=dev)
        svc.on_event(lambda ev: marks.setdefault(ev.kind, time.monotonic()))
        svc.pipeline._fuse_device_chains()
        plan = FaultPlan(seed=SEED)
        plan.lose_shard_at("shard.lost", lost, block="mesh_bengine",
                           nth=MESH_FAULT["nth"])
        plan.call_at("shard.dispatch",
                     lambda *a: marks.setdefault("wedged", time.monotonic()),
                     block="mesh_bengine", nth=MESH_FAULT["nth"])
        plan.wedge_at("shard.dispatch", block="mesh_bengine",
                      nth=MESH_FAULT["nth"], release=release, timeout=60.0)
        plan.attach(svc.pipeline)
        reset_counts()
        svc.start()
        svc.wait(timeout=300)
        rep = svc.stop(timeout=30)
        plan.detach()
        counts["mesh_c_fault"] = read_counts()
        blk = svc.blocks["bengine"]
        survivors = blk.bound_mesh.devices.size
    finally:
        release.set()
        config.reset("mesh_collective_timeout_s")
    shed = MESH_FAULT["nth"] // 2          # two dispatches a gulp
    keep_idx = [i for i in range(MESH_NINT) if i != shed]
    mesh_same(got, [clean[i] for i in keep_idx], "[mesh] (c) stream")
    declared = marks["shard_fault"] - marks["wedged"]
    avail = rep.availability
    c = rep.counters
    # The wedged dispatch runs once the watchdog unparks it (its powers
    # are then shed with the fault): shed + 1 gulps on the full mesh.
    nk4 = (shed + 1) * MESH_N + (MESH_NINT - shed - 1)
    if not (c["shard_faults"] == 1 and c["shard_evictions"] == 1 and
            c["escalations"] == 0 and survivors == MESH_N - 1 and
            declared <= MESH_FAULT["timeout_s"] + 1.0 and
            avail["availability_pct"] < 100.0 and
            avail["shard_recovery"]["count"] == 1 and
            rep.ledger["shard_shed_frames"] == N_INT and
            counts["mesh_c_fault"]["beamform_power"] == nk4 and
            faultdomain.evicted_devices() == [lost]):
        raise AssertionError(f"[mesh] (c): counters {c}, survivors "
                             f"{survivors}, declared after {declared:.3f} s,"
                             f" availability {avail}, ledger {rep.ledger}, "
                             f"launches {counts['mesh_c_fault']}")
    phase("mesh", f"(c) Service on (time, freq) = (4, 2), {lost} lost and "
          f"its gulp-{shed} dispatch wedged: ShardFault declared "
          f"{declared:.3f} s after the wedge (timeout "
          f"{MESH_FAULT['timeout_s']} s), shard_evict, restart onto "
          f"{survivors} survivors; {len(got)} of {MESH_NINT} outputs, "
          f"bitwise the clean run's but the shed one; exit code "
          f"{rep.exit_code}, ledger shard_shed_frames "
          f"{rep.ledger['shard_shed_frames']}, lost "
          f"{rep.ledger['lost_frames']}; availability_pct "
          f"{avail['availability_pct']}; recovery "
          f"{avail['shard_recovery']['last_s']:.3f} s; K4 launches "
          f"{counts['mesh_c_fault']['beamform_power']} ({shed + 1} gulps x "
          f"{MESH_N}, the wedged one's shed, + {MESH_NINT - shed - 1} x 1 "
          f"on the survivors, time replicated)")
    faultdomain.reset()


def mesh_d(dev):
    """(d): make_fx_step on both layouts against fx_step_reference."""
    from bifrost_tpu_torch.parallel import make_fx_step
    from bifrost_tpu_torch.parallel.fx import fx_step_reference
    f = MESH_FX
    rng = np.random.default_rng(SEED + 21)
    x = rng.integers(-8, 8, (f["ntime"], f["nchan"], f["nstand"], f["npol"],
                             2)).astype(np.int8)
    nsp = f["nstand"] * f["npol"]
    w = (rng.integers(-3, 4, (f["nbeam"], nsp)) +
         1j * rng.integers(-3, 4, (f["nbeam"], nsp))).astype(np.complex64)
    ref = fx_step_reference(x, w, f["nfine"])
    eps = float(np.finfo(np.float32).eps)
    nblock = f["ntime"] // f["nfine"]
    for axes in (("time", "freq"), ("time", "freq", "stand")):
        step = make_fx_step(mesh_of(dev, axes), nfine=f["nfine"])
        t0 = time.perf_counter()
        got = [o.cpu().numpy() for o in step(x, w)]
        secs = time.perf_counter() - t0
        errs = []
        for g, r, nterms, name in zip(got, ref, (nblock, nblock * nsp,
                                                 nblock * nsp),
                                      ("vis", "beam_pow", "spec")):
            # eps32 x (log2(nfine) butterfly stages + the summed terms)
            # x the output's magnitude
            tol = eps * (math.log2(f["nfine"]) + 2 + nterms) * \
                float(np.abs(r).max())
            e = float(np.abs(g - r).max())
            if g.shape != r.shape or not e <= tol:
                raise AssertionError(f"[mesh] (d) {axes} {name}: err {e} "
                                     f"(limit {tol})")
            errs.append(f"{name} {e:.3e} <= {tol:.3e}")
        phase("mesh", f"(d) make_fx_step {axes} at {f}: {'; '.join(errs)} "
              f"(limit eps32 (log2 nfine + 2 + terms) max|ref|); "
              f"{secs:.3f} s")


def mesh_path(dev, kind, volt, smi):
    """The mesh plane on one card (module docstring, phase 21).  ->
    (launch counts by path, collective counts by path)."""
    counts, colls = {}, {}
    phase("mesh", f"virtual meshes of {MESH_N} positions on {dev} "
          f"({kind}; {smi}); one card runs the virtual form only")
    mesh_a(dev, volt, counts, colls)
    free_device()
    mesh_b(dev, counts, colls)
    free_device()
    mesh_c(dev, volt, counts)
    free_device()
    mesh_d(dev)
    return counts, colls


def sf_ascii(arr):
    """The bytes v1 `WriteAsciiBlock` writes for one gulp of `arr`: its
    values (complex as interleaved (re, im) floats) each followed by a
    space."""
    arr = np.asarray(arr)
    if arr.dtype == np.complex64:
        arr = arr.view(np.float32)
    return "".join(str(v) + " " for v in arr.ravel())


def sf_fold_plain(data, fch1, foff, tsamp, tstart, bins, period):
    """The fold histogram by a plain loop over samples (FoldBlock's
    arithmetic: the MJD start in seconds, each channel's dispersion
    delay, zero here, and the phase bin of each sample)."""
    hist = np.zeros(bins, np.float64)
    counts = np.zeros(bins, np.int64)
    t0 = tstart * 86400.0
    for i in range(data.shape[0]):
        for c in range(data.shape[1]):
            arrival = t0 + tsamp * i
            b = int(np.floor(np.fmod(arrival, period) / period * bins))
            hist[b] += float(data[i, c])
            counts[b] += 1
    return np.where(counts > 0, hist / np.maximum(counts, 1),
                    0.0).astype(np.float32)


def sf_v1(tmp):
    """The v1 legacy Pipelines (tests/test_legacy_block.py's multi-add,
    FFT/IFFT and fold), each file against a plain numpy computation's."""
    from bifrost_tpu_torch import block as blk
    from bifrost_tpu_torch.io.sigproc import write_header
    rng = np.random.default_rng(SEED + 22)
    a = np.arange(8, dtype=np.float32)
    b = a * 10
    arr = rng.standard_normal(16).astype(np.float32)
    nsamp, nchan, bins, period, tsamp = 1024, 2, 8, 8e-4, 1e-4
    t = np.arange(nsamp) * tsamp
    pulse = (np.fmod(t, period) < tsamp).astype(np.uint8) * 100
    data = np.repeat(pulse[:, None], nchan, axis=1) + 10
    fil = tmp / "p.fil"
    with open(fil, "wb") as f:
        write_header(f, {"nchans": nchan, "nifs": 1, "nbits": 8,
                         "tsamp": tsamp, "tstart": 0.0, "fch1": 400.0,
                         "foff": 0.0, "data_type": 1})
        f.write(data.astype(np.uint8).tobytes())
    out = {k: str(tmp / f"{k}.txt") for k in ("add", "fft", "fold")}
    blk.Pipeline([
        (blk.TestingBlock(a), [], ["a"]), (blk.TestingBlock(b), [], ["b"]),
        (blk.MultiAddBlock(), {"in_1": "a", "in_2": "b", "out_sum": "s"}),
        (blk.WriteAsciiBlock(out["add"]), ["s"], [])]).main()
    blk.Pipeline([
        (blk.TestingBlock(arr), [], [0]), (blk.FFTBlock(), [0], [1]),
        (blk.IFFTBlock(), [1], [2]),
        (blk.WriteAsciiBlock(out["fft"]), [2], [])]).main()
    blk.Pipeline([
        (blk.SigprocReadBlock(str(fil)), [], [0]),
        (blk.FoldBlock(bins=bins, period=period, dispersion_measure=0),
         [0], [1]),
        (blk.WriteAsciiBlock(out["fold"]), [1], [])]).main()
    spec = np.fft.fft(arr.astype(np.complex64)).astype(np.complex64)
    want = {"add": sf_ascii(a + b),
            "fft": sf_ascii(np.fft.ifft(spec).astype(np.complex64)),
            "fold": sf_ascii(sf_fold_plain(data, 400.0, 0.0, tsamp, 0.0,
                                           bins, period))}
    for k, path in out.items():
        got = open(path).read()
        if got != want[k]:
            raise AssertionError(f"[surface] v1 {k}: {got[:80]!r} != "
                                 f"{want[k][:80]!r}")
    return {k: len(w) for k, w in want.items()}


def surface_path(dev, kind, smi):
    """[surface] (module docstring, phase 22).  -> {'surface': counts}."""
    import tempfile
    import bifrost_tpu_torch as bf
    from bifrost_tpu_torch import memory
    from bifrost_tpu_torch.ops import Fdmt, Fft, reduce, transpose
    t_start = time.perf_counter()
    bf.device.set_device(dev)
    rng = np.random.default_rng(SEED + 23)
    a = rng.integers(0, 16, SF_ARR).astype(np.float32)
    # (a) spaces: to the card and back, likes, memset
    t = bf.asarray(a, space="cuda")
    back = bf.asarray(t, space="system")
    if not (t.is_cuda and bf.get_space(t) == "cuda" and
            type(back) is bf.ndarray and back.tobytes() == a.tobytes()):
        raise AssertionError("[surface] asarray to 'cuda' and back")
    pinned = bf.asarray(a, space="cuda_host")
    likes = {}
    for name, src in (("cuda", t), ("cuda_host", pinned)):
        for like in (bf.empty_like, bf.zeros_like):
            y = like(src)
            likes[f"{like.__name__}({name})"] = bf.get_space(y)
            if bf.get_space(y) != name or y.shape != src.shape or \
                    y.dtype != src.dtype or y.device != src.device:
                raise AssertionError(f"[surface] {like.__name__} of a "
                                     f"{name} tensor: {bf.get_space(y)}")
            if like is bf.zeros_like and bool(y.any()):
                raise AssertionError(f"[surface] zeros_like({name})")
    m = t.clone()
    bf.memset_array(m, 0xFF)
    if not bool((m.view(torch.int32) == -1).all()):
        raise AssertionError("[surface] memset_array on the card")
    # (b) pinned raw blocks, memcpy2D, copy_array into a raw block
    rows, width = SF_ARR[0], SF_ARR[1] * 4
    p1 = memory.raw_malloc(rows * width, "cuda_host")
    p2 = memory.raw_malloc(rows * 2 * width, "cuda_host")
    try:
        pin = (memory.raw_pinned(p1), memory.raw_pinned(p2))
        if not all(pin) or memory.raw_get_space(p1) != "cuda_host":
            raise AssertionError(f"[surface] raw_malloc 'cuda_host' "
                                 f"pinned {pin}")
        h1 = bf.ndarray(buffer=p1, shape=SF_ARR, dtype="f32",
                        space="cuda_host")
        bf.copy_array(h1, t)                       # card -> raw block
        if h1.tobytes() != a.tobytes():
            raise AssertionError("[surface] copy_array into a raw block")
        memory.memset(p2, 0, rows * 2 * width)
        memory.memcpy2D(p2, 2 * width, p1, width, width, rows)
        h2 = bf.ndarray(buffer=p2, shape=(rows, 2 * SF_ARR[1]),
                        dtype="f32")
        if h2[:, :SF_ARR[1]].tobytes() != a.tobytes() or \
                h2[:, SF_ARR[1]:].any():
            raise AssertionError("[surface] memcpy2D between raw blocks")
    finally:
        memory.raw_free(p1)
        memory.raw_free(p2)
    # (c) ExternalStream: the scope's work is queued on the stream
    stream = torch.cuda.Stream(dev)
    torch.cuda.synchronize()
    with bf.device.ExternalStream(stream):
        on = torch.cuda.current_stream(dev) == stream
        torch.cuda._sleep(200_000_000)
        queued = not stream.query()
        idle = torch.cuda.default_stream(dev).query()
        y = bf.fft.fft(t.to(torch.complex64), axes=1)
    done = stream.query()
    with bf.device.ExternalStream(stream.cuda_stream):
        raw_on = torch.cuda.current_stream(dev).cuda_stream == \
            stream.cuda_stream
    if not (on and queued and idle and done and raw_on and y.is_cuda):
        raise AssertionError(f"[surface] ExternalStream: current {on}, "
                             f"queued {queued}, default idle {idle}, "
                             f"synced {done}, raw address {raw_on}")
    # (d) FFT from the card into host ndarrays
    x = torch.from_numpy((rng.standard_normal(SF_FFT) + 1j *
                          rng.standard_normal(SF_FFT)).astype(
                              np.complex64)).to(dev)
    want = np.fft.fft(x.cpu().numpy(), axis=1)
    o1 = bf.empty(SF_FFT, dtype="cf32")
    bf.fft.fft(x, o1, axes=1)
    o2 = bf.zeros(SF_FFT, dtype="cf32")
    plan = Fft()
    plan.init(x, o2, axes=1)
    plan.execute(x, o2)
    fbound = 32 * float(np.finfo(np.float32).eps) * math.sqrt(SF_FFT[1]) \
        * float(np.abs(want).max())
    ferr = float(np.abs(np.asarray(o1) - want).max())
    if not (ferr <= fbound and o1.tobytes() == o2.tobytes()):
        raise AssertionError(f"[surface] fft into a host ndarray: err "
                             f"{ferr} (bound {fbound})")
    # (e) transpose and reduce into host out-arrays, bitwise numpy
    ot = np.empty(SF_ARR[::-1], np.float32).view(bf.ndarray)
    transpose(ot, t, axes=(1, 0))
    osum = np.empty((SF_ARR[0], 1), np.float32).view(bf.ndarray)
    reduce(t, osum, "sum")
    omax = np.empty((1, SF_ARR[1]), np.float32).view(bf.ndarray)
    reduce(t, omax, "max")
    if ot.tobytes() != np.ascontiguousarray(a.T).tobytes() or \
            osum.tobytes() != a.sum(axis=1, keepdims=True).tobytes() or \
            omax.tobytes() != a.max(axis=0, keepdims=True).tobytes():
        raise AssertionError("[surface] transpose/reduce into host arrays")
    # (f) Fdmt at [main]'s geometry into a host ndarray: K1 on the path
    xf = torch.from_numpy(np.ascontiguousarray(
        frb_data()[:GULP].T.astype(np.float32))).to(dev)
    fplan = Fdmt().init(NCHAN, MAX_DELAY, F0, DF, method="cuda")
    fout = bf.empty((MAX_DELAY, GULP), dtype="f32")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fplan.execute(xf, fout)
    fdmt_s = time.perf_counter() - t0
    counts = read_counts()
    nsteps = len(fplan._steps)
    if counts != expected(fdmt_merge_step=nsteps):
        raise AssertionError(f"[surface] Fdmt launches {counts}, expected "
                             f"{nsteps} of fdmt_merge_step alone")
    t0 = time.perf_counter()               # warm: tables built, cached
    fplan.execute(xf, fout)
    warm_s = time.perf_counter() - t0
    plain = Fdmt().init(NCHAN, MAX_DELAY, F0, DF, method="plain") \
        .execute(xf).cpu().numpy()
    if not (np.isfinite(fout).all() and
            np.array_equal(np.asarray(fout).view(np.uint32),
                           plain.view(np.uint32))):
        raise AssertionError("[surface] Fdmt into a host ndarray: cuda "
                             "!= plain")
    del xf, plain
    # (g) the v1 legacy blocks
    with tempfile.TemporaryDirectory() as tmp:
        v1 = sf_v1(Path(tmp))
    bf.device._tls.device = None
    phase("surface", f"{kind} ({smi}): asarray cuda and back bitwise; "
          f"likes {likes}; memset_array on the card; raw_malloc "
          f"'cuda_host' x 2 pinned {pin}, memcpy2D {rows} rows of "
          f"{width} B and copy_array card -> raw block bitwise; "
          f"ExternalStream: current {on}, work queued on it (default "
          f"stream idle {idle}), synced on exit {done}, raw cudaStream_t "
          f"{raw_on}; fft {SF_FFT} into host ndarrays err {ferr:.3e} <= "
          f"{fbound:.3e}, one-shot and Fft.init/execute bitwise; "
          f"transpose, reduce sum/max {SF_ARR} into host arrays bitwise "
          f"numpy; Fdmt {NCHAN} x {GULP}, max_delay {MAX_DELAY} into a "
          f"host ndarray {fdmt_s * 1e3:.3f} ms first, {warm_s * 1e3:.3f} "
          f"ms warm (with its pageable D2H), K1 "
          f"launches {counts['fdmt_merge_step']}, bitwise plain; v1 "
          f"multi-add, FFT/IFFT, fold files byte-identical to plain numpy "
          f"({v1} bytes); {time.perf_counter() - t_start:.2f} s")
    return {"surface": counts}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    phase("device", f"{kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; nvidia-smi: {smi}")

    from bifrost_tpu_torch import build
    secs = build.build_all()
    regs = [ln.strip() for name in build.build_log
            for ln in build.build_log[name]["ptxas"].splitlines()
            if "registers" in ln]
    phase("build", f"{secs:.2f} s for {list(build.SOURCES)}; {regs}")

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    recs = [check_kernels(dev, kind), check_fir(dev, kind, rng),
            check_beamform(dev, kind, rng), check_xengine(dev, kind)]
    time_dft(dev, kind, rng)
    recs += check_romein(dev, kind)
    recs += check_dq(dev, kind)
    recs += check_flag(dev, kind)
    time_xstages(dev, kind)
    free_device()
    t1 = time.perf_counter()
    counts = {"frb": main_path(dev)}
    free_device()
    t1b = time.perf_counter()
    counts.update(observe_path(dev, SOLO["frb"]["gathered"]))
    free_device()
    t2 = time.perf_counter()
    counts.update(frbflag_path(dev))
    free_device()
    t3 = time.perf_counter()
    counts["bengine"], volt, bgot, spec = bengine_path(dev)
    free_device()
    t4 = time.perf_counter()
    counts["instrument"], counts["instrument_k6a"] = instrument_path(
        dev, volt, bgot, spec)
    del bgot
    free_device()
    t5 = time.perf_counter()
    counts["dq"] = dq_path(dev, volt, spec)
    free_device()
    t5b = time.perf_counter()
    counts.update(fusion_path(dev, kind, volt))
    free_device()
    t5c = time.perf_counter()
    counts["service"], counts["service_fault"], inst_bare = \
        service_path(dev, volt)
    free_device()
    t5d = time.perf_counter()
    counts.update(capture_path(dev, volt))
    free_device()
    t5e = time.perf_counter()
    counts.update(fir_path(dev, kind, volt, recs[1]["at_fir"]))
    free_device()
    t5f = time.perf_counter()
    counts.update(xengine_path(dev, kind, volt))
    free_device()
    t5h = time.perf_counter()
    recs.append(check_map(dev, kind, volt))
    counts.update(map_path(dev, kind, volt))
    free_device()
    t5i = time.perf_counter()
    counts.update(fleet_path(dev, kind, volt, inst_bare))
    del inst_bare
    free_device()
    t5m = time.perf_counter()
    mesh_counts, mesh_colls = mesh_path(dev, kind, volt, smi)
    counts.update(mesh_counts)
    del volt, spec
    ipc_ref = SOLO["frb"]
    SOLO.clear()
    free_device()
    t5g = time.perf_counter()
    counts.update(async_path(dev, kind))
    free_device()
    t6 = time.perf_counter()
    for name, c in gpuspec_path(dev, kind).items():
        counts[f"gpuspec_{name}"] = c
    free_device()
    t7 = time.perf_counter()
    counts["egress"] = egress_path(dev, kind)
    free_device()
    t8 = time.perf_counter()
    counts.update(ipc_path(dev, kind, smi, ipc_ref))
    del ipc_ref
    free_device()
    t9 = time.perf_counter()
    counts.update(surface_path(dev, kind, smi))
    phase("timing", f"build {secs:.1f} s, kernels {t1 - t0:.1f} s, main "
          f"{t1b - t1:.1f} s, observe {t2 - t1b:.1f} s, frbflag {t3 - t2:.1f} s, bengine "
          f"{t4 - t3:.1f} s, instrument {t5 - t4:.1f} s, dq "
          f"{t5b - t5:.1f} s, fusion {t5c - t5b:.1f} s, service "
          f"{t5d - t5c:.1f} s, capture {t5e - t5d:.1f} s, fir "
          f"{t5f - t5e:.1f} s, xengine {t5h - t5f:.1f} s, map "
          f"{t5i - t5h:.1f} s, fleet {t5m - t5i:.1f} s, mesh "
          f"{t5g - t5m:.1f} s, async "
          f"{t6 - t5g:.1f} s, gpuspec "
          f"{t7 - t6:.1f} s, egress "
          f"{t8 - t7:.1f} s, ipc {t9 - t8:.1f} s, surface "
          f"{time.perf_counter() - t9:.1f} s")
    by_path = {name: {path: c[name] for path, c in counts.items()}
               for name in kernel_counters()}
    for rec in recs:
        rec["launches_by_path"] = by_path[rec["name"]]
        rec["launches"] = sum(by_path[rec["name"]].values())
        if rec["name"] in ("beamform_power", "xengine_int8"):
            # The collectives of the [mesh] runs that launch this kernel.
            rec["mesh_collectives"] = {
                path: c for path, c in mesh_colls.items()
                if by_path[rec["name"]].get(path)}
    print(json.dumps({"kernels": recs}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
