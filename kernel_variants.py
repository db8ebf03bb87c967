"""Time the port's redesigned kernels against variants of their sources on
a CUDA card: the FIR MAC K2, the FDMT merge step K1, the B-engine K4 and
the masked fill K5a.

    python3 kernel_variants.py [--rounds N] [--only K2,K1]

Each variant is the port's source (bifrost_tpu_torch/csrc/fir.cu,
fdmt.cu, beamform.cu or dq.cu) with a few lines replaced (VARIANTS below:
every replaced text must occur exactly once) or, for a first design no
longer in the source, a whole source kept here (K1's first design: one
thread per output sample, launched once per beam).  K1's staged design
(FDMT_STAGED: a block stages a group of rows' distinct input rows in
shared memory) is a kernel kept here and put into the source by
substitution.  Each is compiled with the port's nvcc flags into
bifrost_tpu_torch/build/variants/, one nvcc each, all at once.  Every
variant runs through the port's own wrapper (its library and, for K4,
its geometry constants swapped in), is held bitwise against the plain
version, and is timed by CUDA events on chip_smoke.py's shapes: K2 on
one beam-search gulp (16 x 4,194,304 int8 lanes, rep 1024, 4 taps); K1
on one FRB gulp's 12 merge steps (4096 channels, 6,144 samples; also
held, untimed, on one step with random tables) and on one beam-search
FDMT gulp's 12 (8 beams x 4096 channels x 65 samples); K4 on one
beam-search gulp (16 x 4096 x 512 complex64, 8 beams); K5a on
[frbflag]'s gulp (4096 x 4096 f32, windows of 16) and [dq]'s (16 x
2,097,152 complex64, one window).  F.conv1d, torch.matmul
and torch.where are timed in the same rounds.  Prints each variant's
registers and spilled bytes by kernel from ptxas, one line per round, and
last the card's name and power limit and a JSON object of the times
(ms).
"""

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs
from bifrost_tpu_torch import build
from bifrost_tpu_torch.ops import beamform_kernel as bk
from bifrost_tpu_torch.ops import dq_kernel as dk
from bifrost_tpu_torch.ops import fdmt_kernel as fdk
from bifrost_tpu_torch.ops import fir_kernel as fk

# K1 as first built: one thread per (row, sample), grid.y over rows,
# one launch per slice of a batch (the per-beam loop it ran under).
FDMT_FIRST = r"""
#include <cstdint>
#include <cuda_runtime.h>
namespace {
constexpr int kThreads = 256;
__global__ void fdmt_merge_step_kernel(const float* __restrict__ state,
                                       float* __restrict__ out,
                                       const int* __restrict__ rowA,
                                       const int* __restrict__ rowB,
                                       const int* __restrict__ delay,
                                       int64_t nrows, int64_t ntime) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= ntime) return;
    for (int64_t r = blockIdx.y; r < nrows; r += gridDim.y) {
        const int ra = rowA[r];
        const int rb = rowB[r];
        const int64_t d = delay[r];
        const float a = state[(int64_t)ra * ntime + t];
        float b = 0.0f;
        if (rb >= 0 && t >= d) b = state[(int64_t)rb * ntime + (t - d)];
        out[r * ntime + t] = a + b;
    }
}
}  // namespace
extern "C" {
int fdmt_merge_step(const float* state, float* out, const int* rowA,
                    const int* rowB, const int* delay, long long batch,
                    long long nrows, long long ntime, long long sbs,
                    long long obs, void* stream) {
    if (batch <= 0 || nrows <= 0 || ntime <= 0) return 0;
    dim3 block(kThreads);
    dim3 grid((unsigned)((ntime + kThreads - 1) / kThreads),
              (unsigned)(nrows < 65535 ? nrows : 65535));
    for (long long b = 0; b < batch; ++b)
        fdmt_merge_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
            state + b * sbs, out + b * obs, rowA, rowB, delay, nrows, ntime);
    return (int)cudaGetLastError();
}
const char* fdmt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
}  // extern "C"
"""

# K1 staged through shared memory, for 16-byte aligned rows (the FRB
# search's): a block owns kStageRows consecutive output rows of one slice
# and walks kWalk tiles of kTile samples.  It finds the distinct A rows and
# B rows among its rows from the tables, copies each once a tile into
# shared memory with cp.async (a B row over the tile widened by the spread
# of its rows' delays, zeros left of sample 0), the next tile's copies
# issued before the current tile's rows are written from shared memory
# with 16-byte stores (two buffers where kWalk > 1).  A B row whose delays
# spread wider than kHalo is read from device memory as the kernel as
# built does.  The arithmetic is the kernel's: a + b, +0.0f for a row with
# no partner or t < d.
FDMT_STAGED = r"""
constexpr int kStageRows = 8;
constexpr int kStageThreads = 128;
constexpr int kWalk = 1;
constexpr int kTile = 4 * kStageThreads;
constexpr int kHalo = 8;
// A staged B row: from the aligned piece at or before t0 - max(delay),
// the tile and the spread, plus the piece the last cut reaches into.
constexpr int kSegB = kTile + kHalo + 4;
constexpr int kBuf = kStageRows * (kTile + kSegB);   // floats a buffer
constexpr int kBufs = kWalk > 1 ? 2 : 1;

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool in) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(in ? 16 : 0));
}

__global__ void __launch_bounds__(kStageThreads)
fdmt_merge_staged_kernel(const float* __restrict__ state,
                         float* __restrict__ out,
                         const int* __restrict__ rowA,
                         const int* __restrict__ rowB,
                         const int* __restrict__ delay, int64_t nrows,
                         int64_t ntime, int64_t sbs, int64_t obs) {
    extern __shared__ float4 stage4[];
    float* const smem = reinterpret_cast<float*>(stage4);
    __shared__ int ra[kStageRows], rb[kStageRows], dl[kStageRows];
    __shared__ int sa[kStageRows], sbi[kStageRows], direct[kStageRows];
    __shared__ int hib[kStageRows];
    const int64_t ntile = (ntime + kTile - 1) / kTile;
    const int64_t nwalk = (ntile + kWalk - 1) / kWalk;
    const int64_t ngroup = (nrows + kStageRows - 1) / kStageRows;
    const int64_t blk = blockIdx.x;
    const int64_t tile0 = blk % nwalk * kWalk;
    const int64_t r0 = blk / nwalk % ngroup * kStageRows;
    const int64_t b = blk / (nwalk * ngroup);
    const int ntl = ntile - tile0 < kWalk ? (int)(ntile - tile0) : kWalk;
    const float* sb = state + b * sbs;
    float* ob = out + b * obs;
    const int tid = threadIdx.x;
    const int nv = nrows - r0 < kStageRows ? (int)(nrows - r0) : kStageRows;
    if (tid < nv) {
        ra[tid] = rowA[r0 + tid];
        rb[tid] = rowB[r0 + tid];
        dl[tid] = delay[r0 + tid];
    }
    __syncthreads();
    if (tid < nv) {
        // Slot of a row's A (B) data: the first row of the group with
        // the same A (B) row.
        int j = 0;
        while (ra[j] != ra[tid]) ++j;
        sa[tid] = j;
        if (rb[tid] >= 0) {
            int first = -1, lo = 0, hi = 0;
            for (int m = 0; m < nv; ++m) {
                if (rb[m] != rb[tid]) continue;
                if (first < 0) { first = m; lo = hi = dl[m]; }
                lo = min(lo, dl[m]);
                hi = max(hi, dl[m]);
            }
            sbi[tid] = first;
            direct[tid] = hi - lo > kHalo;
            hib[tid] = hi;
        }
    }
    __syncthreads();
    // Copy tile i's distinct rows into its buffer, as one commit group.
    auto stage = [&](int i) {
        const int64_t t0 = (tile0 + i) * kTile;
        float* sA = smem + (i % kBufs) * kBuf;
        float* sB = sA + kStageRows * kTile;
        for (int j = 0; j < nv; ++j) {
            if (sa[j] == j) {
                const float* src = sb + (int64_t)ra[j] * ntime;
                for (int m = tid; m < kTile / 4; m += kStageThreads) {
                    const int64_t p = t0 + 4 * m;
                    const bool in = p < ntime;
                    cp16(sA + j * kTile + 4 * m, in ? src + p : src, in);
                }
            }
            if (rb[j] >= 0 && sbi[j] == j && !direct[j]) {
                const float* src = sb + (int64_t)rb[j] * ntime;
                const int64_t base = (t0 - hib[j]) & ~3LL;
                for (int m = tid; m < kSegB / 4; m += kStageThreads) {
                    const int64_t p = base + 4 * m;
                    const bool in = p >= 0 && p < ntime;
                    cp16(sB + j * kSegB + 4 * m, in ? src + p : src, in);
                }
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    stage(0);
    for (int i = 0; i < ntl; ++i) {
        if (kBufs > 1 && i + 1 < ntl) {
            stage(i + 1);
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        __syncthreads();
        const int64_t t0 = (tile0 + i) * kTile;
        const float* sA = smem + (i % kBufs) * kBuf;
        const float* sB = sA + kStageRows * kTile;
        const int64_t t = t0 + 4 * tid;
        for (int k = 0; k < nv && t < ntime; ++k) {
            const float4 a = *reinterpret_cast<const float4*>(
                sA + sa[k] * kTile + 4 * tid);
            float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
            if (rb[k] >= 0) {
                const int64_t s = t - dl[k];
                const int off = (int)(s & 3);
                float4 q0, q1;
                if (direct[k]) {
                    const float* row = sb + (int64_t)rb[k] * ntime;
                    q0 = piece(row, s - off, ntime);
                    q1 = off ? piece(row, s - off + 4, ntime) : q0;
                } else {
                    const int j = sbi[k];
                    const float* seg = sB + j * kSegB +
                                       (s - off - ((t0 - hib[j]) & ~3LL));
                    q0 = *reinterpret_cast<const float4*>(seg);
                    q1 = off ? *reinterpret_cast<const float4*>(seg + 4)
                             : q0;
                }
                bv = cut(q0, q1, off);
            }
            *reinterpret_cast<float4*>(ob + (r0 + k) * ntime + t) =
                make_float4(__fadd_rn(a.x, bv.x), __fadd_rn(a.y, bv.y),
                            __fadd_rn(a.z, bv.z), __fadd_rn(a.w, bv.w));
        }
        if (kBufs == 1 && i + 1 < ntl) {
            __syncthreads();
            stage(i + 1);
        }
        __syncthreads();
    }
}

void launch_staged(const float* state, float* out, const int* rowA,
                   const int* rowB, const int* delay, int64_t batch,
                   int64_t nrows, int64_t ntime, int64_t sbs, int64_t obs,
                   cudaStream_t st) {
    const int smem = (int)sizeof(float) * kBufs * kBuf;
    cudaFuncSetAttribute(fdmt_merge_staged_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const int64_t ntile = (ntime + kTile - 1) / kTile;
    const int64_t n = batch * ((nrows + kStageRows - 1) / kStageRows) *
                      ((ntile + kWalk - 1) / kWalk);
    fdmt_merge_staged_kernel<<<(unsigned)n, kStageThreads, smem, st>>>(
        state, out, rowA, rowB, delay, nrows, ntime, sbs, obs);
}

}  // namespace
"""

# The substitutions that put FDMT_STAGED into fdmt.cu for aligned rows.
STAGED = [("}  // namespace\n", FDMT_STAGED.lstrip("\n")),
          ("        fdmt_merge_step_kernel<true><<<grid, kThreads, 0, st>>>(\n"
           "            state, out, rowA, rowB, delay, batch, nrows, ntime, "
           "sbs, obs);",
           "        launch_staged(state, out, rowA, rowB, delay, batch, "
           "nrows, ntime, sbs,\n                      obs, st);")]

# name -> (source, [(text, replacement), ...] or a whole source); "as
# built" first.
VARIANTS = {
    "K2 as built": ("fir", []),
    "K2 first design": ("fir", [(
        "    if (vec) {\n        constexpr int V",
        "    if (false) {\n        constexpr int V")]),
    "K2 16 int8 lanes": ("fir", [("kLanesInt8 = 8;", "kLanesInt8 = 16;")]),
    "K2 4 int8 lanes": ("fir", [("kLanesInt8 = 8;", "kLanesInt8 = 4;")]),
    "K2 4 frames a thread": ("fir", [("kFrameCut = 8;", "kFrameCut = 4;")]),
    "K2 16 frames a thread": ("fir", [("kFrameCut = 8;", "kFrameCut = 16;")]),
    "K2 4 rows ahead": ("fir", [("kRowsAhead = 16;", "kRowsAhead = 4;")]),
    "K2 8 rows ahead": ("fir", [("kRowsAhead = 16;", "kRowsAhead = 8;")]),
    "K2 256 threads": ("fir", [("kThreads = 128;", "kThreads = 256;")]),
    "K2 no blocks an SM asked": ("fir", [(
        "__launch_bounds__(kThreads, kBlocksPerSM)\nfir_mac_vec_kernel",
        "__launch_bounds__(kThreads)\nfir_mac_vec_kernel")]),
    "K2 4 blocks an SM": ("fir", [("kBlocksPerSM = 3;", "kBlocksPerSM = 4;")]),
    "K1 as built": ("fdmt", []),
    "K1 first design": ("fdmt", FDMT_FIRST),
    "K1 2 rows a thread": ("fdmt", [("kGroupRows = 4;", "kGroupRows = 2;")]),
    "K1 8 rows a thread": ("fdmt", [("kGroupRows = 4;", "kGroupRows = 8;")]),
    "K1 16 rows a thread": ("fdmt", [
        ("kGroupRows = 4;", "kGroupRows = 16;")]),
    "K1 256 threads": ("fdmt", [("kThreads = 128;", "kThreads = 256;")]),
    "K1 element accesses": ("fdmt", [
        ("const bool vec = ntime % 4 == 0", "const bool vec = false")]),
    "K1 staged 8 rows": ("fdmt", STAGED),
    "K1 staged 4 rows": ("fdmt", STAGED + [
        ("kStageRows = 8;", "kStageRows = 4;")]),
    "K1 staged 16 rows": ("fdmt", STAGED + [
        ("kStageRows = 8;", "kStageRows = 16;")]),
    "K1 staged 8 rows 256 threads": ("fdmt", STAGED + [
        ("kStageThreads = 128;", "kStageThreads = 256;")]),
    "K1 staged 8 rows 4 tiles": ("fdmt", STAGED + [
        ("kWalk = 1;", "kWalk = 4;")]),
    "K1 staged 4 rows 4 tiles": ("fdmt", STAGED + [
        ("kStageRows = 8;", "kStageRows = 4;"), ("kWalk = 1;", "kWalk = 4;")]),
    "K1 staged 4 rows 12 tiles": ("fdmt", STAGED + [
        ("kStageRows = 8;", "kStageRows = 4;"),
        ("kWalk = 1;", "kWalk = 12;")]),
    "K1 staged 2 rows 4 tiles": ("fdmt", STAGED + [
        ("kStageRows = 8;", "kStageRows = 2;"), ("kWalk = 1;", "kWalk = 4;")]),
    "K4 as built": ("beamform", []),
    "K4 first design": ("beamform", [
        ("kRows = 256;", "kRows = 128;"),
        ("kRowBytes = 128;", "kRowBytes = 256;"),
        ("kStages = 2;", "kStages = 3;"),
        ("#pragma unroll\n                for (int q = 0;",
         "#pragma unroll 4\n                for (int q = 0;")]),
    "K4 128 rows": ("beamform", [("kRows = 256;", "kRows = 128;")]),
    "K4 64 rows": ("beamform", [("kRows = 256;", "kRows = 64;")]),
    "K4 3 stages": ("beamform", [("kStages = 2;", "kStages = 3;")]),
    "K4 256-byte rows": ("beamform", [
        ("kRowBytes = 128;", "kRowBytes = 256;")]),
    "K4 256-byte rows 3 stages": ("beamform", [
        ("kRowBytes = 128;", "kRowBytes = 256;"),
        ("kStages = 2;", "kStages = 3;")]),
    "K4 3 blocks an SM": ("beamform", [
        ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 3)")]),
    "K4 2 rows a thread": ("beamform", [
        ("kRowsPerThread = 1;", "kRowsPerThread = 2;")]),
    "K4 pieces unrolled by 4": ("beamform", [(
        "#pragma unroll\n                for (int q = 0;",
        "#pragma unroll 4\n                for (int q = 0;")]),
    "K4 pieces not unrolled": ("beamform", [(
        "#pragma unroll\n                for (int q = 0;",
        "#pragma unroll 1\n                for (int q = 0;")]),
    "K5a as built": ("dq", []),
    "K5a scalar kernel": ("dq", [
        ("    if (vec) {\n", "    if (false) {\n")]),
    "K5a evict-first": ("dq", [("{ return *p; }", "{ return __ldcs(p); }"),
                               ("{ *p = v; }", "{ __stcs(p, v); }")]),
    "K5a 2 in flight": ("dq", [("kUnroll = 4;", "kUnroll = 2;")]),
    "K5a 8 in flight": ("dq", [("kUnroll = 4;", "kUnroll = 8;")]),
    "K5a 128 threads": ("dq", [("kThreads = 256;", "kThreads = 128;")]),
}


def compile_all(out_dir, names):
    """One nvcc per variant in `names`, all at once -> {name: (library,
    ptxas)}."""
    procs = {}
    for i, name in enumerate(names):
        src, subs = VARIANTS[name]
        if isinstance(subs, str):
            text = subs
        else:
            text = (build.CSRC / f"{src}.cu").read_text()
            for old, new in subs:
                if text.count(old) != 1:
                    raise RuntimeError(f"{name}: {old!r} occurs "
                                       f"{text.count(old)} times in "
                                       f"{src}.cu")
                text = text.replace(old, new)
        cu = out_dir / f"v{i}_{src}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = (lib, ptxas_summary(log))
    return out


def ptxas_summary(log):
    """{kernel (mangled name): 'R regs, S B spilled'} from ptxas -v."""
    info, kernel = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            kernel = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and kernel:
            info[kernel] = f"{m.group(1)} B spilled"
        m = re.search(r"Used (\d+) registers", ln)
        if m and kernel:
            info[kernel] = f"{m.group(1)} regs, {info.get(kernel, '')}"
    return info


MODULES = {"beamform": bk, "dq": dk, "fir": fk, "fdmt": fdk}


@contextlib.contextmanager
def swapped(name, lib):
    """The port's wrapper of `name`'s kernel running `lib` (and, for K4,
    that build's geometry constants)."""
    mod = MODULES[VARIANTS[name][0]]
    saved = {k: getattr(mod, k) for k in
             ("_lib", "ROWS", "GROUP", "MAX_BEAMS", "ROW_BYTES", "STAGES")
             if hasattr(mod, k)}
    load = build.load
    build.load = lambda _: ctypes.CDLL(str(lib))
    try:
        mod._lib = None
        mod._library()
        if mod is bk:
            text = (lib.with_suffix(".cu")).read_text()
            val = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
            bk.ROWS, bk.ROW_BYTES, bk.STAGES = (
                int(val[k]) for k in ("kRows", "kRowBytes", "kStages"))
        yield
    finally:
        build.load = load
        for k, v in saved.items():
            setattr(mod, k, v)


def k2_case(dev, gen):
    """One beam-search gulp of K2: int8 (16, 4096 x 1024) lanes, 3 f32
    history rows, the (4, 4096) prototype; with the conv1d yardstick."""
    from bifrost_tpu_torch.ops import pfb_coeffs
    rep = cs.NSTAND * cs.NPOL * 2
    lanes = cs.BCHAN * rep
    x = torch.randint(-8, 8, (cs.N_INT, lanes), dtype=torch.int8,
                      device=dev, generator=gen)
    st = torch.randint(-8, 8, (cs.NTAP - 1, lanes), device=dev,
                       generator=gen).float()
    c = torch.from_numpy(pfb_coeffs(cs.BCHAN, cs.NTAP).astype(np.float32)) \
        .to(dev)
    out = torch.empty(cs.N_INT, lanes, device=dev)
    torch.backends.cudnn.allow_tf32 = False
    xin = torch.cat([st, x.float()]).T.contiguous()[None]
    wconv = c.flip(0).T.repeat_interleave(rep, 0)[:, None, :].contiguous()
    return {"args": (x, c, st, 1, rep), "out": out,
            "want": fk.fir_mac_plain(x, c, st, 1, rep),
            "library": lambda: F.conv1d(xin, wconv, groups=lanes)}


def k1_cases(dev, gen):
    """One FDMT gulp's merge steps at the FRB search's shape and at the
    beam search's (8 beams in one batch): (plan, device tables, initial
    state, the plain chain's result); and one step on random tables:
    (state, tables, the plain step's result)."""
    from bifrost_tpu_torch.ops import Fdmt
    frb = Fdmt().init(cs.NCHAN, cs.MAX_DELAY, cs.F0, cs.DF, method="cuda")
    x = torch.randint(0, 256, (cs.NCHAN, cs.GULP + cs.MAX_DELAY),
                      device=dev, generator=gen).float()
    beam = cs.beam_fdmt_plan()
    xb = torch.randn(cs.NBEAM, cs.BCHAN, cs.B_MAX_DELAY + 1, device=dev,
                     generator=gen)
    cases = {}
    for key, plan, xi in (("frb", frb, x), ("beams", beam, xb)):
        tabs = plan._device_tables("cuda", dev)
        state0 = plan._init_state(xi, tabs, max([len(plan._init_perm)] +
                                                plan._step_need))
        want = cs.merge_chain(plan, plan._device_tables("plain", dev),
                              state0, fdk.merge_step_plain)
        cases[key] = (plan, tabs, state0, want.clone())
    # One step on random tables over the FRB state: rows without a
    # partner, delays spread wide and past the row's end.
    st = cases["frb"][2]
    n = len(frb._steps[0][0])
    tabs = [torch.randint(lo, hi, (n,), dtype=torch.int32, device=dev,
                          generator=gen)
            for lo, hi in ((0, n), (-1, n), (0, st.shape[-1] + 64))]
    rand = (st[:n], tabs, fdk.merge_step_plain(st[:n], *tabs))
    return cases, rand


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default="",
                    help="comma-separated kernel IDs (K2,K1,K4,K5a)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    only = [k for k in args.only.split(",") if k]
    names = [n for n in VARIANTS if not only or n.split()[0] in only]
    kernels = {n.split()[0] for n in names}
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = compile_all(out_dir, names)
    for name, (_, ptxas) in libs.items():
        print(f"[ptxas] {name}: {ptxas}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    lib_calls = {}
    if "K2" in kernels:
        k2 = k2_case(dev, gen)
        lib_calls["F.conv1d"] = (k2["library"], 5)
    if "K1" in kernels:
        k1, k1rand = k1_cases(dev, gen)
    if "K4" in kernels:
        shape = (cs.N_INT, cs.BCHAN, cs.NSTAND * cs.NPOL)
        x = torch.randn(shape, dtype=torch.complex64, device=dev,
                        generator=gen)
        w = torch.randn(cs.NBEAM, shape[2], dtype=torch.complex64,
                        device=dev, generator=gen)
        pout = torch.empty(cs.NBEAM, cs.BCHAN, device=dev)
        pwant = bk.beamform_power_plain(x, w)
        xp, wt = x.permute(1, 0, 2).contiguous(), w.T.contiguous()
        lib_calls["torch.matmul"] = (lambda: torch.matmul(xp, wt), 10)
    if "K5a" in kernels:
        ncell = cs.BCHAN * cs.NSTAND * cs.NPOL
        fills = {
            "frb": (torch.randn(cs.GULP, cs.NCHAN, device=dev,
                                generator=gen),
                    torch.rand(cs.GULP // 16, cs.NCHAN, device=dev,
                               generator=gen) < 0.05, 16),
            "dq": (torch.randn(cs.N_INT, ncell, dtype=torch.complex64,
                               device=dev, generator=gen),
                   torch.rand(1, ncell, device=dev, generator=gen) < 0.05,
                   cs.DQ_WINDOW)}
        fwant = {k: dk.masked_fill_plain(*v[:2], None, v[2])
                 for k, v in fills.items()}
        fout = {k: torch.empty_like(v[0]) for k, v in fills.items()}
        for k, (fx, fm, win) in fills.items():
            mw = fm.view(fm.shape[0], 1, -1)
            xw = fx.view(fm.shape[0], win if k == "frb" else fx.shape[0], -1)
            zero = torch.zeros((), dtype=fx.dtype, device=dev)
            lib_calls[f"torch.where {k}"] = (
                lambda mw=mw, xw=xw, zero=zero: torch.where(mw, zero, xw), 20)

    def run(name, row):
        """Check variant `name` bitwise on its shapes and time it."""
        kid = name.split()[0]
        if kid == "K2":
            fk.fir_mac(*k2["args"], out=k2["out"])
            torch.cuda.synchronize()
            if not cs.bits_equal(k2["out"], k2["want"]):
                raise AssertionError(f"{name} differs from plain")
            row[name] = cs.cuda_time(
                lambda: fk.fir_mac(*k2["args"], out=k2["out"]), 20)
        elif kid == "K1":
            rst, rtabs, rwant = k1rand
            rout = torch.empty_like(rwant)
            fdk.merge_step(rst, *rtabs, out=rout)
            torch.cuda.synchronize()
            if not cs.bits_equal(rout, rwant):
                raise AssertionError(f"{name} differs from plain (random "
                                     f"tables)")
            for key, (plan, tabs, state0, want) in k1.items():
                got = cs.merge_chain(plan, tabs, state0, fdk.merge_step)
                torch.cuda.synchronize()
                if not cs.bits_equal(got, want):
                    raise AssertionError(f"{name} differs from plain "
                                         f"({key})")
                row[f"{name} {key}"] = cs.time_chain(
                    plan, tabs, state0, fdk.merge_step,
                    20 if key == "frb" else 50)
                if key == "beams":
                    scratch = state0.clone()
                    row[f"{name} {key} device"] = cs.graph_time(
                        lambda: plan._merge_steps(scratch, tabs,
                                                  fdk.merge_step), 50)
        elif kid == "K4":
            bk.beamform_power(x, w, out=pout)
            torch.cuda.synchronize()
            if not cs.bits_equal(pout, pwant):
                raise AssertionError(f"{name} differs from plain")
            row[name] = cs.cuda_time(
                lambda: bk.beamform_power(x, w, out=pout), 20)
        else:
            for k, (fx, fm, win) in fills.items():
                dk.masked_fill(fx, fm, None, win, out=fout[k])
                torch.cuda.synchronize()
                a, b = (torch.view_as_real(t) if t.is_complex() else t
                        for t in (fout[k], fwant[k]))
                if not cs.bits_equal(a, b):
                    raise AssertionError(f"{name} differs from plain ({k})")
                row[f"{name} {k}"] = cs.cuda_time(
                    lambda: dk.masked_fill(fx, fm, None, win, out=fout[k]),
                    20)

    times = {}
    for rnd in range(args.rounds):
        row = {k: cs.cuda_time(f, reps) for k, (f, reps) in lib_calls.items()}
        for name, (lib, _) in libs.items():
            with swapped(name, lib):
                run(name, row)
        print(f"[round {rnd}] " + ", ".join(f"{k} {v:.4f}"
                                             for k, v in row.items()),
              flush=True)
        for k, v in row.items():
            times.setdefault(k, []).append(v)
    print(smi)
    print(json.dumps({"device": kind, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
