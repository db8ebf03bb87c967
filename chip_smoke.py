"""Chip smoke run of bifrost_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile every CUDA source of the port (one nvcc each, in
             parallel) from this checkout.
3. kernels — hold each kernel against its plain PyTorch version at the
             shapes the main paths give it, bitwise, and time both, the
             bound and a library call for the same function; time the
             PFB's DFT matmuls per gulp.
4. main    — drive the FRB-search chain (`frb_search_pipeline`) at full
             width: 4096 channels of u8 power at the LWA band (40 MHz,
             9.28 kHz, 1 ms), FDMT max_delay 2048, gulps of 4096 frames,
             12 gulps, with a dispersed burst injected from a fixed seed.
             The kernels' launch counts are read from this run alone.
             The dedispersed gulps of the same chain are then compared
             bitwise against the chain with fdmt_method='plain'.
5. bengine — drive the LWA beam-search chain (`lwa_beam_search_pipeline`)
             at `lwa_instrument_spec`'s flagship width: ci8 voltages of
             256 stations x 2 pol, PFB 4096 channels x 4 taps, 8 beams
             integrated over 16 spectra, FDMT max_delay 64, one
             integration (65,536 frames) per gulp, 80 integrations (a
             16-integration block of seeded noise replayed 5 times).
             Launch counts are read from this run alone; steady state
             is timed from the first integration's beam powers to the
             last one's.  Its beam powers and dedispersed frames are
             compared bitwise against the chain with every method
             'plain', and the first integration's powers against an
             f64 numpy golden.

The line before the last holds the kernel records as JSON; the last line
is {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

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
B_MAX_DELAY, B_NINT, B_REPLAY = 64, 80, 16
B_F0, B_DT = 40.0, 1e-6
B_GULP = N_INT * BCHAN

# Device-memory rate by card (NVIDIA data sheets), bytes/s
_HBM_RATE = (("H200", 4.8e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
F32_PEAK = 67e12   # H100 SXM f32 outside the tensor cores, operations/s


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


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


def bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def merge_chain(plan, tabs, state0, step):
    """The merge steps of one gulp (the executor's loop) from an initial
    state, through `step`."""
    return plan._merge_steps(state0.clone(), tabs, step)


def merge_bound(plan, ntime, rate):
    """Least milliseconds for one gulp's merge steps, launched at their
    exact row counts: per step, each state row read once (a row read only
    as a delayed partner needs ntime - min(delay) of its samples), each
    output row written once, and the tables; the adds at the f32 rate.
    -> (ms, bytes, adds)."""
    nbytes = nadds = 0
    for rowA, rowB, delay in plan._steps:
        n = len(rowA)
        need = dict.fromkeys(rowA.tolist(), ntime)
        for r, d in zip(rowB.tolist(), delay.tolist()):
            if r >= 0:
                need[r] = max(need.get(r, 0), ntime - d)
        nbytes += 4 * (sum(need.values()) + n * ntime) + 12 * n
        nadds += n * ntime
    return max(nbytes / rate, nadds / F32_PEAK) * 1e3, nbytes, nadds


def bound(nbytes, nops, rate):
    """-> (ms, 'bytes' or 'operations'): the larger of the bytes over the
    memory rate and the f32 operations over the f32 peak."""
    tb, to = nbytes / rate, nops / F32_PEAK
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def fir_work(nout, lanes, ntap, ncoef, in_bytes):
    """Bytes and operations of one FIR MAC call (decim 1): x read once at
    its storage width, the f32 history and prototype, the f32 output;
    a multiply and an add per tap and output."""
    nbytes = (nout * lanes * in_bytes + (ntap - 1) * lanes * 4 +
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
    from bifrost_tpu_torch.ops import beamform_kernel, fdmt_kernel, fir_kernel
    return {"fdmt_merge_step": fdmt_kernel.merge_step,
            "fir_mac": fir_kernel.fir_mac,
            "beamform_power": beamform_kernel.beamform_power}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


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

    # Time one gulp's merge steps (12 launches) at the main path's shapes.
    state0 = torch.zeros(max(plan._step_need), ntime, device=dev)
    state0[:len(plan._init_perm)] = torch.from_numpy(rng.integers(
        0, 512, (len(plan._init_perm), ntime)).astype(np.float32)).to(dev)
    ptabs = plan._device_tables("plain", dev)
    ms = cuda_time(lambda: merge_chain(plan, tabs, state0, merge_step), 20)
    plain_ms = cuda_time(
        lambda: merge_chain(plan, ptabs, state0, merge_step_plain), 5)
    if not bits_equal(merge_chain(plan, tabs, state0, merge_step),
                      merge_chain(plan, ptabs, state0, merge_step_plain)):
        raise AssertionError("merge chain cuda != plain")
    bound_ms, nbytes, _ = merge_bound(plan, ntime, hbm_rate(kind))
    phase("kernels", f"fdmt merge_step: {ms:.4f} ms per gulp "
          f"({len(plan._steps)} launches, each at its step's exact row "
          f"count), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({nbytes / 1e9:.3f} GB at {hbm_rate(kind) / 1e12:.2f} TB/s), "
          f"{kind}")
    return {"name": "fdmt_merge_step", "route": "cuda",
            "source": "bifrost_tpu_torch/csrc/fdmt.cu",
            "replaces": "bifrost_tpu/ops/fdmt_pallas.py:43",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None}


def check_fir(dev, kind, rng):
    """K2 at the B-engine PFB's MAC shapes: one gulp of 16 folded frames
    x (4096 channels x 512 inputs x 2) lanes, 3 history rows, the
    (4, 4096) prototype shared by 1024 lanes each."""
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
        got = fir_kernel.fir_mac(x, c, st, 1, rep)
        want = fir_kernel.fir_mac_plain(x, c, st, 1, rep)
        torch.cuda.synchronize()
        if not bits_equal(got, want):
            raise AssertionError(f"fir_mac differs from plain on {name}")
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
          f"{' and '.join(cases)} at ({N_INT}, {lanes}) lanes, rep {rep}; "
          f"{ms:.4f} ms per gulp (1 launch), plain {plain_ms:.4f} ms, "
          f"conv1d {library_ms:.4f} ms (rel err {err:.2e}), bound "
          f"{bound_ms:.4f} ms ({by}: {nbytes / 1e9:.4f} GB, "
          f"{nops / 1e9:.4f} G ops), {kind}")
    return {"name": "fir_mac", "route": "cuda",
            "source": "bifrost_tpu_torch/csrc/fir.cu",
            "replaces": "bifrost_tpu/ops/fir_pallas.py:47",
            "launches": None, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms}


def check_beamform(dev, kind, rng):
    """K4 at the B-engine's shapes: one gulp of 16 spectra x 4096
    channels x 512 inputs, 8 beams."""
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
    phase("kernels", f"beamform_power equal to plain (tolerance: bitwise) "
          f"on integer-valued c64, ci8 storage and random f32 at "
          f"{shape} x {NBEAM} beams; {ms:.4f} ms per gulp (1 launch), "
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
    5).  -> the kernels' launch counts in the main run."""
    from bifrost_tpu_torch.ops import pfb_coeffs
    from bifrost_tpu_torch.service import (default_beam_weights,
                                           lwa_beam_search_pipeline)
    nsp = NSTAND * NPOL
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    block = rng.integers(-8, 8, (B_REPLAY * B_GULP, NSTAND, NPOL, 2),
                         dtype=np.int8)
    volt = np.concatenate([block] * (B_NINT // B_REPLAY))
    phase("bengine", f"voltages: {volt.nbytes / 2**30:.2f} GiB of ci8 "
          f"({len(volt)} frames; a {B_REPLAY}-integration block replayed "
          f"{B_NINT // B_REPLAY} times), {time.perf_counter() - t0:.1f} s")

    def build(method, gather):
        return lwa_beam_search_pipeline(
            volt, nstand=NSTAND, npol=NPOL, nchan=BCHAN, ntap=NTAP,
            n_int=N_INT, nbeam=NBEAM, max_delay=B_MAX_DELAY,
            f0_mhz=B_F0, dt_s=B_DT, gulp_nframe=B_GULP, device=dev,
            pfb_method=method, beamform_method=method, fdmt_method=method,
            gather=gather)

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
    expect = {"fir_mac": B_NINT, "beamform_power": B_NINT,
              "fdmt_merge_step": nfdmt * NBEAM * len(fd.fdmt._steps)}
    if counts != expect:
        raise AssertionError(f"launches {counts}, expected {expect}")
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
          f"{NBEAM} beams x {len(fd.fdmt._steps)} steps); ledger {s}; "
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
    return counts


def main_path(dev):
    from bifrost_tpu_torch.blocks.testing import inject_burst
    from bifrost_tpu_torch.service import frb_search_pipeline
    rng = np.random.default_rng(SEED)
    data = rng.integers(0, 32, (GULP * NGULP, NCHAN)).astype(np.uint8)
    inject_burst(data, T0, DM_ROW, F0, DF, amp=60)

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
    if counts != {"fdmt_merge_step": nsteps * NGULP, "fir_mac": 0,
                  "beamform_power": 0}:
        raise AssertionError(f"launches {counts}, expected "
                             f"{nsteps * NGULP} of fdmt_merge_step alone")
    s = ledger.summary()
    nout = GULP * NGULP - MAX_DELAY
    if s["lost_frames"] or s["duplicated_frames"] or \
            s["committed_frames"] != nout:
        raise AssertionError(f"frame ledger: {s}")
    if not det.candidates:
        raise AssertionError("no candidate: the injected burst was missed")
    best = max(det.candidates, key=lambda c: c["snr"])
    # The injected curve rounds each channel's delay on its own, the FDMT
    # splits delays band by band: the peak lands within two rows, and
    # within two frames of output frame T0 - MAX_DELAY (output frame k
    # holds input frame k + MAX_DELAY).
    if abs(best["dm_index"] - DM_ROW) > 2 or \
            abs(best["frame"] - (T0 - MAX_DELAY)) > 2:
        raise AssertionError(f"burst at dm row {DM_ROW}, frame "
                             f"{T0 - MAX_DELAY}; found {best}")
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
    return launches, nframe / wall


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
            check_beamform(dev, kind, rng)]
    time_dft(dev, kind, rng)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    frb_launches, _ = main_path(dev)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    bcounts = bengine_path(dev)
    phase("timing", f"build {secs:.1f} s, kernels {t1 - t0:.1f} s, main "
          f"{t2 - t1:.1f} s, bengine {time.perf_counter() - t2:.1f} s")
    by_path = {"fdmt_merge_step": {"frb": frb_launches,
                                   "bengine": bcounts["fdmt_merge_step"]},
               "fir_mac": {"bengine": bcounts["fir_mac"]},
               "beamform_power": {"bengine": bcounts["beamform_power"]}}
    for rec in recs:
        rec["launches_by_path"] = by_path[rec["name"]]
        rec["launches"] = sum(by_path[rec["name"]].values())
    print(json.dumps({"kernels": recs}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
