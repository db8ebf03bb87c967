"""Time the port's redesigned kernels against variants of their sources on
a CUDA card: the FIR MAC K2, the FDMT merge step K1, the B-engine K4, the
masked fill K5a, the int8 X-engine X1 and bf.map's generated kernel M1.

    python3 kernel_variants.py [--rounds N] [--only K2,K1,M1]

Each variant is the port's source (bifrost_tpu_torch/csrc/fir.cu,
fdmt.cu, beamform.cu, dq.cu or xengine.cu) with a few lines replaced
(VARIANTS below: every replaced text must occur exactly once) or, for a
first design no longer in the source, a whole source kept here (K1's
first design: one thread per output sample, launched once per beam; X1's:
mma.sync from staged scalar loads over the full matrix).  K1's staged design
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
2,097,152 complex64, one window); X1 on the int8 X-engine's gulp (1024
frames x 128 channels x 512 inputs ci4; also held, untimed, on ci8 and
at 200 x 2 x 129, into outputs prefilled with NaN).  F.conv1d,
torch.matmul, torch.where and torch._int_mm are timed in the same
rounds.  M1 (--only M1) runs chip_smoke.py's MAP_FORMS (the ci8
program, the stencil, f16, bf16, ci2, ci1, complex64 sqrt) at [map]'s
gulp (65,536 x 256 x 2): its first design (M1_FIRST_HEADER and
M1_FIRST_BODIES below, built with the same flags and launched with its
own launch words), the port's generator, and variants of it (twice the
V: a thread's span of the widest operand 32 bytes; one wave of blocks;
stores without the streaming hint); each held against the plain (the
port's also timed as a CUDA graph, its device time without the host's
launch cost) version (bitwise; sqrt within chip_smoke.MAP_CX_ULP ulps), timed with
`torch.sqrt` beside sqrt, and counted in SASS (cuobjdump): each loop's
instructions, loads, stores and calls, and the kernel's 64-bit divide
sequences (I2F.U64.RP).  M1e (--only M1e) runs M1's eager
explicit-index form on [map]'s eager shape (65,536 x 512 complex64):
the transpose on the tile path at the port's 32 x 32 tiles and at 64 x
32, 32 x 64 and 64 x 64, with its store phase not unrolled; the
transpose written as a scatter; the band flip (one pass, the vector
path) at the port's V = 2 and at 4 and 8, with two and four vector items
a thread in flight; a straight copy on the same vector path (M1E_VARIANTS),
each bitwise the plain engine, in turns beside a.t().contiguous(),
torch.flip and a.clone().  Prints each variant's
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
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import chip_smoke as cs
from bifrost_tpu_torch import build
from bifrost_tpu_torch.ops import beamform_kernel as bk
from bifrost_tpu_torch.ops import dq_kernel as dk
from bifrost_tpu_torch.ops import fdmt_kernel as fdk
from bifrost_tpu_torch.ops import fir_kernel as fk
from bifrost_tpu_torch.ops import xengine_kernel as xk

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

# X1 as first built (csrc/xengine.cu before its redesign): a block a
# channel and a 64 x 64 tile of the full matrix, staging one sample at a
# time into shared memory, mma.sync.m16n8k32 s8; its entry point takes
# the scratch planes of the wrapper and ignores them, and it has no
# kernels apart.
XENGINE_FIRST = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // stations a block side
constexpr int kDepth = 64;     // time samples a shared-memory stage
constexpr int kPitch = 80;     // bytes a shared row: kDepth + 16
constexpr int kThreads = 128;  // four warps, 2 x 2 over the tile
constexpr int kQuads = kTile * kDepth / 4 / kThreads;  // words a thread a side

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One sample's (re, im) as int8, zero past the edges.
__device__ __forceinline__ void sample(const uint8_t* x, int fmt, int64_t idx,
                                       bool ok, int& re, int& im) {
    re = 0;
    im = 0;
    if (!ok) return;
    if (fmt == 0) {
        char2 v = reinterpret_cast<const char2*>(x)[idx];
        re = v.x;
        im = v.y;
    } else {
        int b = x[idx];
        re = static_cast<int8_t>(b) >> 4;
        im = static_cast<int8_t>(b << 4) >> 4;
    }
}

// Stage `t0`'s samples of stations [s0, s0 + kTile) into re/im rows.
__device__ __forceinline__ void load_side(const uint8_t* x, int fmt,
                                          int64_t ntime, int64_t tstride,
                                          int64_t cbase, int64_t nsp,
                                          int64_t s0, int64_t t0,
                                          int8_t* sr, int8_t* si) {
    const int s = threadIdx.x % kTile;
    const int h = threadIdx.x / kTile;
    const bool sok = s0 + s < nsp;
#pragma unroll
    for (int k = 0; k < kQuads; ++k) {
        const int tq = h + (kThreads / kTile) * k;
        uint32_t wr = 0, wi = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int64_t t = t0 + tq * 4 + u;
            int re, im;
            sample(x, fmt, t * tstride + cbase + s0 + s, sok && t < ntime,
                   re, im);
            wr |= (uint32_t)(re & 0xff) << (8 * u);
            wi |= (uint32_t)(im & 0xff) << (8 * u);
        }
        *reinterpret_cast<uint32_t*>(sr + s * kPitch + tq * 4) = wr;
        *reinterpret_cast<uint32_t*>(si + s * kPitch + tq * 4) = wi;
    }
}

__global__ void __launch_bounds__(kThreads)
xengine_kernel(const uint8_t* __restrict__ x, int fmt, int64_t ntime,
               int64_t nchan, int64_t nsp, float2* __restrict__ out) {
    __shared__ __align__(16) int8_t sAr[kTile * kPitch];
    __shared__ __align__(16) int8_t sAi[kTile * kPitch];
    __shared__ __align__(16) int8_t sBr[kTile * kPitch];
    __shared__ __align__(16) int8_t sBi[kTile * kPitch];

    const int64_t c = blockIdx.z;
    const int64_t i0 = (int64_t)blockIdx.y * kTile;
    const int64_t j0 = (int64_t)blockIdx.x * kTile;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
    const int g = lane >> 2, q = lane & 3;
    const int64_t tstride = nchan * nsp;
    const int64_t cbase = c * nsp;

    int accr[2][4][4], accp[2][4][4], accq[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                accr[mi][ni][e] = accp[mi][ni][e] = accq[mi][ni][e] = 0;

    for (int64_t t0 = 0; t0 < ntime; t0 += kDepth) {
        __syncthreads();
        load_side(x, fmt, ntime, tstride, cbase, nsp, i0, t0, sAr, sAi);
        load_side(x, fmt, ntime, tstride, cbase, nsp, j0, t0, sBr, sBi);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kDepth; kk += 32) {
            uint32_t ar[2][4], ai[2][4], br[4][2], bi[4][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const int r = (wm + mi * 16 + g) * kPitch + kk + q * 4;
                ar[mi][0] = *reinterpret_cast<const uint32_t*>(sAr + r);
                ar[mi][1] = *reinterpret_cast<const uint32_t*>(sAr + r + 8 * kPitch);
                ar[mi][2] = *reinterpret_cast<const uint32_t*>(sAr + r + 16);
                ar[mi][3] = *reinterpret_cast<const uint32_t*>(sAr + r + 8 * kPitch + 16);
                ai[mi][0] = *reinterpret_cast<const uint32_t*>(sAi + r);
                ai[mi][1] = *reinterpret_cast<const uint32_t*>(sAi + r + 8 * kPitch);
                ai[mi][2] = *reinterpret_cast<const uint32_t*>(sAi + r + 16);
                ai[mi][3] = *reinterpret_cast<const uint32_t*>(sAi + r + 8 * kPitch + 16);
            }
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int r = (wn + ni * 8 + g) * kPitch + kk + q * 4;
                br[ni][0] = *reinterpret_cast<const uint32_t*>(sBr + r);
                br[ni][1] = *reinterpret_cast<const uint32_t*>(sBr + r + 16);
                bi[ni][0] = *reinterpret_cast<const uint32_t*>(sBi + r);
                bi[ni][1] = *reinterpret_cast<const uint32_t*>(sBi + r + 16);
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) {
                    mma_s8(accr[mi][ni], ar[mi], br[ni]);
                    mma_s8(accr[mi][ni], ai[mi], bi[ni]);
                    mma_s8(accp[mi][ni], ar[mi], bi[ni]);
                    mma_s8(accq[mi][ni], ai[mi], br[ni]);
                }
        }
    }

    float2* oc = out + c * nsp * nsp;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int64_t i = i0 + wm + mi * 16 + g + (e >= 2 ? 8 : 0);
                const int64_t j = j0 + wn + ni * 8 + q * 2 + (e & 1);
                if (i < nsp && j < nsp)
                    oc[i * nsp + j] = make_float2(
                        __int2float_rn(accr[mi][ni][e]),
                        __int2float_rn(accp[mi][ni][e] - accq[mi][ni][e]));
            }
}

}  // namespace

extern "C" {
int xengine_int8(const void* x, int fmt, long long ntime, long long nchan,
                 long long nsp, void* planes, long long tp, void* out,
                 void* stream) {
    if (ntime < 1 || nchan < 1 || nsp < 1) return 0;
    if (nchan > 65535) return (int)cudaErrorInvalidConfiguration;
    const unsigned nt = (unsigned)((nsp + kTile - 1) / kTile);
    dim3 grid(nt, nt, (unsigned)nchan);
    xengine_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, fmt, ntime, nchan, nsp, (float2*)out);
    return (int)cudaGetLastError();
}
int xengine_corner_turn(const void*, int, long long, long long, long long,
                        void*, long long, void*) {
    return (int)cudaErrorNotSupported;
}
int xengine_tiles(void*, long long, long long, long long, void*, void*) {
    return (int)cudaErrorNotSupported;
}
int xengine_kernel_info(int, int* regs, int* local_bytes, int* static_smem,
                        int* dynamic_smem) {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, xengine_kernel);
    if (e != cudaSuccess) return (int)e;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *static_smem = (int)attr.sharedSizeBytes;
    *dynamic_smem = 0;
    return 0;
}
const char* xengine_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
}  // extern "C"
"""

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
    "X1 as built": ("xengine", []),
    "X1 first design": ("xengine", XENGINE_FIRST),
    "X1 one wgmma group in flight": ("xengine", [
        ("            wgmma_wait<0>();\n            fence_acc(accr);\n"
         "            fence_acc(accp);\n            fence_acc(accq);\n"
         "            mbar_arrive(&empty[s]);\n",
         "            wgmma_wait<1>();\n            fence_acc(accr);\n"
         "            fence_acc(accp);\n            fence_acc(accq);\n"
         "            if (kt > 0) mbar_arrive(&empty[(s + kStages - 1) % "
         "kStages]);\n"),
        ("        // Accumulator layout of m64nN",
         "        wgmma_wait<0>();\n        fence_acc(accr);\n"
         "        fence_acc(accp);\n        fence_acc(accq);\n"
         "        // Accumulator layout of m64nN")]),
    "X1 2 stages": ("xengine", [("kStages = 3;", "kStages = 2;")]),
    "X1 128 x 64 tiles, 4 stages": ("xengine", [
        ("kTileN = 128;", "kTileN = 64;"), ("kStages = 3;", "kStages = 4;")]),
    "X1 64 x 128 tiles, 2 stages, 2 blocks an SM": ("xengine", [
        ("kTileM = 128;", "kTileM = 64;"), ("kStages = 3;", "kStages = 2;"),
        ("kConsumerRegs = 240;", "kConsumerRegs = 232;"),
        ("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, 2)")]),
    "X1 corner turn swizzled": ("xengine", [
        ("tile[0][16 * q + 4 * g + s][r]",
         "tile[0][16 * q + 4 * g + s][r ^ 4 * q]"),
        ("tile[1][16 * q + 4 * g + s][r]",
         "tile[1][16 * q + 4 * g + s][r ^ 4 * q]"),
        ("&tile[pl][st][4 * m]", "&tile[pl][st][4 * (m ^ (st / 16))]")]),
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


MODULES = {"beamform": bk, "dq": dk, "fir": fk, "fdmt": fdk,
           "xengine": xk}


@contextlib.contextmanager
def swapped(name, lib):
    """The port's wrapper of `name`'s kernel running `lib` (and, for K4,
    that build's geometry constants).  X1's wrapper reads only the
    planes' pitch from its source, which no variant changes."""
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


def x1_cases(dev, gen):
    """X1's gulp of the int8 X-engine (ci4) with outputs, the plain
    version's results and the torch._int_mm yardstick (chip_smoke's:
    four products a channel on planes unpacked beforehand); ci8 at the
    same shape and ci4 at 200 x 2 x 129 for the bitwise check alone."""
    nsp = cs.XE_NSTAND * cs.XE_NPOL
    shapes = {"ci4": (cs.XE_GULP, cs.XE_NCHAN, nsp),
              "ci8": (cs.XE_GULP, cs.XE_NCHAN, nsp),
              "ci4 edge": (200, 2, 129)}
    cases = {}
    for key, shape in shapes.items():
        fmt = key.split()[0]
        x = (torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                           generator=gen) if fmt == "ci4" else
             torch.randint(-128, 128, shape + (2,), dtype=torch.int8,
                           device=dev, generator=gen))
        out = torch.empty(shape[1], shape[2], shape[2],
                          dtype=torch.complex64, device=dev)
        cases[key] = (x, fmt, out, xk.xengine_int8_plain(x, fmt))
    re, im = xk.planes(cases["ci4"][0], "ci4")
    ar, ai = (p.permute(1, 2, 0).contiguous() for p in (re, im))
    br, bi = (p.permute(1, 0, 2).contiguous() for p in (re, im))

    def library():
        for c in range(cs.XE_NCHAN):
            for a, b in ((ar, br), (ai, bi), (ar, bi), (ai, br)):
                torch._int_mm(a[c], b[c])
    return cases, library


# M1's first design (the generator's output before its Hopper redesign):
# one output element a grid-stride loop step, the element's coordinates
# by a 64-bit `%` and `/` of every axis' extent, 64-bit offsets, scalar
# loads and stores, the complex transcendentals in f64.  M1_FIRST_HEADER
# is its csrc/map_common.cuh; m1_first_source(tag) is the kernel its
# generator wrote for chip_smoke.MAP_FORMS' program `tag`: the common
# preamble and launch code around M1_FIRST_BODIES[tag] (the statements,
# the per-element function and map_item).  m1_first_meta packs its launch
# words: n, ncarry, the output shape and strides, the input's logical
# shape, strides and component stride; a launch takes a grid of
# ceil((n + ncarry) / 256) blocks, at most 132 * 64.
M1_FIRST_BLOCK, M1_FIRST_MAX_GRID = 256, 132 * 64


def m1_first_meta(out, x, storage_strides, ncarry=0):
    """The launch words of a rank-r program: output tensor `out`, input
    of logical shape x[0] read through (strides, component stride)
    `storage_strides`."""
    shape, (strides, cs_) = x, storage_strides
    m = [out.numel(), ncarry] + list(out.shape) + list(out.stride())
    return m + list(shape) + list(strides) + [cs_]


def m1_first_grid(n):
    return max(1, min(-(-n // M1_FIRST_BLOCK), M1_FIRST_MAX_GRID))


def m1_first_source(tag):
    body = M1_FIRST_BODIES[tag]
    nm = re.search(r"struct P \{ long long m\[(\d+)\]", body).group(1)
    return M1_FIRST_PREAMBLE + body + M1_FIRST_LAUNCH.replace("@NM@", nm)


M1_FIRST_HEADER = r'''// The run-time support of bf.map's generated kernels (kernel M1).
//
// ops/map_codegen.py turns one user expression of the map mini-language
// into a CUDA C++ source that includes this header: a complex type, the
// operators on it, the loads of every storage form a stream arrives in,
// and the math functions with the semantics of the port's plain engine
// (PyTorch's operators, which for these functions are JAX's):
//
// - `/` on integers is true division (the operands become float first,
//   the code generator casts them); `//` and `%` floor, as Python does;
// - integer +, -, *, negation and powers wrap (computed unsigned);
// - round and rint round half to even (rint), as jnp.round does;
// - mmin/mmax propagate a NaN, as jnp.minimum/maximum and
//   torch.minimum/maximum do (C's fminf does not);
// - rsqrt is 1/sqrt, not the approximate rsqrtf;
// - the complex product is (ac - bd, ad + bc) and the quotient follows
//   c10::complex's (numpy's) scaled algorithm;
// - cvt<T> follows astype / Tensor.to: a complex value cast to a real
//   type keeps its real part, a real value cast to complex gets a zero
//   imaginary part, a float cast to an integer truncates.
//
// - f16 and bf16 are storage types: every operator converts its
//   operands to f32, computes there and rounds the result back to the
//   storage type (round to nearest even), as PyTorch's kernels do with
//   their f32 "opmath"; a Python scalar that PyTorch's card kernels read
//   straight into f32 (+, -, * with a CPU scalar) is passed to the f32
//   operator unrounded by the generator;
// - the complex transcendentals (sqrt, log, log2, log10, sin, cos, tan,
//   asin, acos, atan, sinh, cosh, tanh, rsqrt, pow) are computed in f64
//   and rounded to the component type, with the formulas named at each:
//   within a few ulps of |z| (or of the result where it is larger) of
//   PyTorch's c10::complex / thrust kernels away from the branch cuts,
//   not bitwise.
//
// Every function is __host__ __device__, so a generated source also
// compiles with the host C++ compiler: the CPU tests run the generated
// statement bodies against the plain engine with no card.  Kernels are
// built with --fmad=false (and the host build with -ffp-contract=off),
// so no multiply and add are contracted: the plain engine rounds each
// operator on its own.

#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>

// A generated source that uses f16 or bf16 defines MAP_HALF_TYPES first:
// the card's conversion instructions come from CUDA's half headers, which
// cost every other kernel's build a second.
#if defined(__CUDACC__) && defined(MAP_HALF_TYPES)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#define MAP_HALF_INTRINSICS 1
#endif

#ifdef __CUDACC__
#define MAP_HD __host__ __device__ __forceinline__
#else
#define MAP_HD inline
#endif

namespace bfmap {

// ------------------------------------------------- half storage types
MAP_HD uint32_t f32_bits(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
MAP_HD float bits_f32(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// f32 -> f16 bits, round to nearest even; a NaN becomes the quiet NaN
// 0x7e00 with its sign (c10::Half's host conversion).
MAP_HD uint16_t f16_from_f32(float f) {
#if defined(__CUDA_ARCH__) && defined(MAP_HALF_INTRINSICS)
  return __half_as_ushort(__float2half_rn(f));
#else
  const uint32_t x = f32_bits(f);
  const uint32_t sign = (x >> 16) & 0x8000u;
  const uint32_t ax = x & 0x7fffffffu;
  if (ax > 0x7f800000u) return static_cast<uint16_t>(sign | 0x7e00u);
  if (ax >= 0x477ff000u) return static_cast<uint16_t>(sign | 0x7c00u);
  if (ax >= 0x38800000u) {              // a normal half
    const uint32_t r = ax - 0x38000000u;
    return static_cast<uint16_t>(
        sign | ((r + 0xfffu + ((r >> 13) & 1u)) >> 13));
  }
  // below 2**-14: a multiple of 2**-24, rounded to nearest even (v and
  // its fraction are exact in f32)
  const float v = bits_f32(ax) * 16777216.0f;
  uint32_t m = static_cast<uint32_t>(v);
  const float frac = v - static_cast<float>(m);
  if (frac > 0.5f || (frac == 0.5f && (m & 1u))) ++m;
  return static_cast<uint16_t>(sign | m);
#endif
}
MAP_HD float f16_to_f32(uint16_t h) {
#if defined(__CUDA_ARCH__) && defined(MAP_HALF_INTRINSICS)
  return __half2float(__ushort_as_half(h));
#else
  const uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
  const uint32_t e = (h >> 10) & 0x1fu, m = h & 0x3ffu;
  if (e == 0x1f) return bits_f32(sign | 0x7f800000u | (m << 13));
  if (e) return bits_f32(sign | ((e + 112u) << 23) | (m << 13));
  const float v = static_cast<float>(m) * 5.9604644775390625e-8f;
  return sign ? -v : v;
#endif
}
// f32 -> bf16 bits, round to nearest even; a NaN becomes 0x7fc0
// (c10::BFloat16's host conversion).
MAP_HD uint16_t bf16_from_f32(float f) {
#if defined(__CUDA_ARCH__) && defined(MAP_HALF_INTRINSICS)
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
#else
  const uint32_t x = f32_bits(f);
  if ((x & 0x7fffffffu) > 0x7f800000u) return 0x7fc0u;
  return static_cast<uint16_t>((x + 0x7fffu + ((x >> 16) & 1u)) >> 16);
#endif
}
MAP_HD float bf16_to_f32(uint16_t h) {
  return bits_f32(static_cast<uint32_t>(h) << 16);
}

// A 16-bit float in storage: constructed from an f32 (rounded), read as
// an f32 (exact).  Its operators round each result, as c10::Half's do.
template <int KIND>  // 0 f16, 1 bf16
struct half_t {
  uint16_t bits;
  MAP_HD half_t() : bits(0) {}
  MAP_HD explicit half_t(float v)
      : bits(KIND == 0 ? f16_from_f32(v) : bf16_from_f32(v)) {}
  MAP_HD operator float() const {
    return KIND == 0 ? f16_to_f32(bits) : bf16_to_f32(bits);
  }
};
using f16 = half_t<0>;
using bf16 = half_t<1>;

template <int K>
MAP_HD half_t<K> operator+(half_t<K> a, half_t<K> b) {
  return half_t<K>(float(a) + float(b));
}
template <int K>
MAP_HD half_t<K> operator-(half_t<K> a, half_t<K> b) {
  return half_t<K>(float(a) - float(b));
}
template <int K>
MAP_HD half_t<K> operator*(half_t<K> a, half_t<K> b) {
  return half_t<K>(float(a) * float(b));
}
template <int K>
MAP_HD half_t<K> operator/(half_t<K> a, half_t<K> b) {
  return half_t<K>(float(a) / float(b));
}
template <int K>
MAP_HD half_t<K> operator-(half_t<K> a) {
  half_t<K> r;
  r.bits = static_cast<uint16_t>(a.bits ^ 0x8000u);
  return r;
}

template <typename T> struct is_half : std::false_type {};
template <int K> struct is_half<half_t<K>> : std::true_type {};
// Floating point, the storage halves included.
template <typename T>
struct is_fp : std::integral_constant<bool, std::is_floating_point<T>::value ||
                                                is_half<T>::value> {};

template <typename T>
struct cx {
  T re, im;
  MAP_HD cx() : re(0), im(0) {}
  MAP_HD cx(T r, T i) : re(r), im(i) {}
};

template <typename T> struct is_cx : std::false_type {};
template <typename T> struct is_cx<cx<T>> : std::true_type {};
template <typename T> struct comp { using type = T; };
template <typename T> struct comp<cx<T>> { using type = T; };

// ------------------------------------------------------------- casts
template <typename To, typename From>
MAP_HD To cvt(From v) {
  if constexpr (is_cx<To>::value) {
    using C = typename comp<To>::type;
    if constexpr (is_cx<From>::value) {
      return To(static_cast<C>(v.re), static_cast<C>(v.im));
    } else {
      return To(static_cast<C>(v), C(0));
    }
  } else if constexpr (std::is_same<To, bool>::value) {
    if constexpr (is_cx<From>::value) {
      return v.re != 0 || v.im != 0;
    } else {
      return v != 0;
    }
  } else if constexpr (is_cx<From>::value) {
    return static_cast<To>(v.re);
  } else {
    return static_cast<To>(v);
  }
}

template <typename T>
MAP_HD bool truth(T v) { return cvt<bool>(v); }

// Integer arithmetic that wraps: computed on the unsigned type of the
// same width, then converted back (two's complement).
template <typename T>
using uns = typename std::make_unsigned<
    typename std::conditional<std::is_same<T, bool>::value, uint8_t,
                              T>::type>::type;

// ----------------------------------------------------- the operators
template <typename T>
MAP_HD T op_add(T a, T b) {
  if constexpr (is_half<T>::value) {
    return T(float(a) + float(b));
  } else if constexpr (is_cx<T>::value) {
    return T(a.re + b.re, a.im + b.im);
  } else if constexpr (std::is_integral<T>::value) {
    return static_cast<T>(static_cast<uns<T>>(
        static_cast<uns<T>>(a) + static_cast<uns<T>>(b)));
  } else {
    return a + b;
  }
}

template <typename T>
MAP_HD T op_sub(T a, T b) {
  if constexpr (is_half<T>::value) {
    return T(float(a) - float(b));
  } else if constexpr (is_cx<T>::value) {
    return T(a.re - b.re, a.im - b.im);
  } else if constexpr (std::is_integral<T>::value) {
    return static_cast<T>(static_cast<uns<T>>(
        static_cast<uns<T>>(a) - static_cast<uns<T>>(b)));
  } else {
    return a - b;
  }
}

template <typename T>
MAP_HD T op_mul(T a, T b) {
  if constexpr (is_half<T>::value) {
    return T(float(a) * float(b));
  } else if constexpr (is_cx<T>::value) {
    return T(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
  } else if constexpr (std::is_integral<T>::value) {
    return static_cast<T>(static_cast<uns<T>>(
        static_cast<uns<T>>(a) * static_cast<uns<T>>(b)));
  } else {
    return a * b;
  }
}

template <typename T>
MAP_HD T op_neg(T a) {
  if constexpr (is_half<T>::value) {
    return -a;
  } else if constexpr (is_cx<T>::value) {
    return T(-a.re, -a.im);
  } else if constexpr (std::is_integral<T>::value) {
    return static_cast<T>(static_cast<uns<T>>(
        uns<T>(0) - static_cast<uns<T>>(a)));
  } else {
    return -a;
  }
}

// True division (floats and complex; the generator makes integer
// operands float first).  The complex quotient is c10::complex's.
template <typename T>
MAP_HD T op_div(T a, T b) {
  if constexpr (is_half<T>::value) {
    return T(float(a) / float(b));
  } else if constexpr (is_cx<T>::value) {
    using C = typename comp<T>::type;
    C ar = a.re, ai = a.im, c = b.re, d = b.im;
    C abs_c = c < 0 ? -c : c;
    C abs_d = d < 0 ? -d : d;
    if (abs_c >= abs_d) {
      if (abs_c == C(0) && abs_d == C(0)) {
        return T(ar / abs_c, ai / abs_d);
      }
      C rat = d / c;
      C scl = C(1.0) / (c + d * rat);
      return T((ar + ai * rat) * scl, (ai - ar * rat) * scl);
    }
    C rat = c / d;
    C scl = C(1.0) / (d + c * rat);
    return T((ar * rat + ai) * scl, (ai * rat - ar) * scl);
  } else {
    return a / b;
  }
}

// Floor division: Python's and torch.floor_divide's.
template <typename T>
MAP_HD T op_floordiv(T a, T b) {
  if constexpr (is_half<T>::value) {
    return T(op_floordiv<float>(float(a), float(b)));
  } else if constexpr (std::is_integral<T>::value) {
    if ((a < 0) != (b < 0)) {
      T q = static_cast<T>(a / b);
      T r = static_cast<T>(a % b);
      return r ? static_cast<T>(q - 1) : q;
    }
    return static_cast<T>(a / b);
  } else {
    if (b == T(0)) return a / b;
    T mod = std::fmod(a, b);
    T div = (a - mod) / b;
    if ((mod != 0) && ((b < 0) != (mod < 0))) div -= T(1);
    T fl;
    if (div != 0) {
      fl = std::floor(div);
      if (div - fl > T(0.5)) fl += T(1.0);
    } else {
      fl = std::copysign(T(0), a / b);
    }
    return fl;
  }
}

// Floor modulo: the result takes the divisor's sign.
template <typename T>
MAP_HD T op_mod(T a, T b) {
  if constexpr (is_half<T>::value) {
    return T(op_mod<float>(float(a), float(b)));
  } else if constexpr (std::is_integral<T>::value) {
    T m = static_cast<T>(a % b);
    if ((m != 0) && ((b < 0) != (m < 0))) m = static_cast<T>(m + b);
    return m;
  } else {
    T m = std::fmod(a, b);
    if ((m != 0) && ((b < 0) != (m < 0))) m += b;
    return m;
  }
}

// Integer power by squaring, wrapping; a negative exponent gives what
// torch's integer pow gives (1 for a base of 1, +-1 for -1, else 0).
template <typename T, typename E>
MAP_HD T powi(T a, E b) {
  if (b < 0) {
    if (a == 1) return T(1);
    if (a == -1) return (b % 2 == 0) ? T(1) : T(-1);
    return T(0);
  }
  T r = 1;
  while (b) {
    if (b & 1) r = op_mul<T>(r, a);
    b /= 2;
    a = op_mul<T>(a, a);
  }
  return r;
}

template <typename T>
MAP_HD T op_pow(T a, T b) {
  if constexpr (is_half<T>::value) {
    return T(std::pow(float(a), float(b)));
  } else if constexpr (std::is_integral<T>::value) {
    return powi<T, T>(a, b);
  } else {
    return std::pow(a, b);
  }
}

template <typename T>
MAP_HD T op_and(T a, T b) {
  if constexpr (std::is_same<T, bool>::value) return a && b;
  else return static_cast<T>(a & b);
}
template <typename T>
MAP_HD T op_or(T a, T b) {
  if constexpr (std::is_same<T, bool>::value) return a || b;
  else return static_cast<T>(a | b);
}
template <typename T>
MAP_HD T op_xor(T a, T b) {
  if constexpr (std::is_same<T, bool>::value) return a != b;
  else return static_cast<T>(a ^ b);
}
// Shifts as PyTorch's: a shift by a negative amount or by the width or
// more gives 0 to the left and the sign fill to the right; a left shift
// wraps (computed on the unsigned type).
template <typename T>
MAP_HD T op_shl(T a, T b) {
  if (b < 0 || b >= T(8 * sizeof(T))) return T(0);
  return static_cast<T>(static_cast<uns<T>>(static_cast<uns<T>>(a)
                                            << static_cast<int>(b)));
}
template <typename T>
MAP_HD T op_shr(T a, T b) {
  if (b < 0 || b >= T(8 * sizeof(T))) return a < 0 ? T(-1) : T(0);
  return static_cast<T>(a >> static_cast<int>(b));
}
template <typename T>
MAP_HD T op_invert(T a) {
  if constexpr (std::is_same<T, bool>::value) return !a;
  else return static_cast<T>(~a);
}

template <typename T>
MAP_HD bool op_eq(T a, T b) {
  if constexpr (is_cx<T>::value) return a.re == b.re && a.im == b.im;
  else return a == b;
}
template <typename T>
MAP_HD bool op_ne(T a, T b) { return !op_eq<T>(a, b); }

// -------------------------------------------------- the math functions
template <typename T>
MAP_HD T mmin(T a, T b) {
  if constexpr (is_fp<T>::value) {
    if (a != a) return a;
    if (b != b) return b;
  }
  return a < b ? a : b;
}
template <typename T>
MAP_HD T mmax(T a, T b) {
  if constexpr (is_fp<T>::value) {
    if (a != a) return a;
    if (b != b) return b;
  }
  return a > b ? a : b;
}

template <typename T>
MAP_HD T mabs(T a) {
  if constexpr (is_half<T>::value) {
    T r;
    r.bits = static_cast<uint16_t>(a.bits & 0x7fffu);
    return r;
  } else if constexpr (std::is_integral<T>::value) {
    return a < 0 ? op_neg<T>(a) : a;
  } else {
    return std::fabs(a);
  }
}
template <typename C>
MAP_HD C mabs(cx<C> a) { return std::hypot(a.re, a.im); }

template <typename T> MAP_HD T mfloor(T a) {
  if constexpr (std::is_integral<T>::value) return a;
  else if constexpr (is_half<T>::value) return T(std::floor(float(a)));
  else return std::floor(a);
}
template <typename T> MAP_HD T mceil(T a) {
  if constexpr (std::is_integral<T>::value) return a;
  else if constexpr (is_half<T>::value) return T(std::ceil(float(a)));
  else return std::ceil(a);
}
// Half to even, as jnp.round and torch.round.
template <typename T> MAP_HD T mrint(T a) {
  if constexpr (std::is_integral<T>::value) return a;
  else if constexpr (is_half<T>::value) return T(std::rint(float(a)));
  else return std::rint(a);
}
template <typename T> MAP_HD T msqrt(T a) {
  if constexpr (is_half<T>::value) return T(std::sqrt(float(a)));
  else return std::sqrt(a);
}
// 1/sqrt: the square root rounded to T first, as the plain engine
// divides 1 by torch.sqrt's result.
template <typename T> MAP_HD T mrsqrt(T a) {
  if constexpr (is_half<T>::value) return T(1.0f / float(msqrt<T>(a)));
  else return T(1) / std::sqrt(a);
}

template <typename C>
MAP_HD cx<C> mexp(cx<C> a) {
  C m = std::exp(a.re);
  return cx<C>(m * std::cos(a.im), m * std::sin(a.im));
}
template <typename T> MAP_HD T mexp(T a) { return std::exp(a); }

// --------------------------------------------- complex transcendentals
// Each is computed on cx<double> and rounded to the component type.
using cxd = cx<double>;

template <typename C>
MAP_HD cx<C> cx_round(cxd a) {
  return cx<C>(static_cast<C>(a.re), static_cast<C>(a.im));
}
template <typename C>
MAP_HD cxd cx_wide(cx<C> a) { return cxd(a.re, a.im); }

// Principal square root (Kahan): no cancellation on either half-plane.
MAP_HD cxd csqrt_d(cxd z) {
  const double x = z.re, y = z.im;
  if (x == 0 && y == 0) return cxd(0.0, y);
  if (std::isinf(y)) return cxd(INFINITY, y);
  const double t = std::sqrt((std::fabs(x) + std::hypot(x, y)) * 0.5);
  if (x >= 0) return cxd(t, y / (2 * t));
  return cxd(std::fabs(y) / (2 * t), std::copysign(t, y));
}
MAP_HD cxd clog_d(cxd z) {
  return cxd(std::log(std::hypot(z.re, z.im)), std::atan2(z.im, z.re));
}
// log(1 + d) for small d without the cancellation of 1 + d.
MAP_HD cxd clog1p_d(cxd d) {
  return cxd(0.5 * std::log1p(2 * d.re + (d.re * d.re + d.im * d.im)),
             std::atan2(d.im, 1 + d.re));
}
MAP_HD cxd cexp_d(cxd z) {
  const double m = std::exp(z.re);
  return cxd(m * std::cos(z.im), m * std::sin(z.im));
}
MAP_HD cxd csinh_d(cxd z) {
  return cxd(std::sinh(z.re) * std::cos(z.im),
             std::cosh(z.re) * std::sin(z.im));
}
MAP_HD cxd ccosh_d(cxd z) {
  return cxd(std::cosh(z.re) * std::cos(z.im),
             std::sinh(z.re) * std::sin(z.im));
}
// tanh (Kahan's formula; the large-|x| limit where it would overflow).
MAP_HD cxd ctanh_d(cxd z) {
  const double x = z.re, y = z.im;
  if (std::fabs(x) > 22) {
    const double e = std::exp(-std::fabs(x));
    return cxd(std::copysign(1.0, x), 4 * std::sin(y) * std::cos(y) * e * e);
  }
  const double t = std::tan(y), b = 1 + t * t, s = std::sinh(x);
  const double r = std::sqrt(1 + s * s), d = 1 + b * s * s;
  return cxd(b * r * s / d, t / d);
}
// asinh(w) = log(w + sqrt(w^2 + 1)) on Re w >= 0 (odd otherwise), as
// log1p(w + w^2 / (sqrt(w^2 + 1) + 1)) so a small w keeps its digits.
MAP_HD cxd casinh_d(cxd w) {
  if (std::signbit(w.re)) {
    const cxd r = casinh_d(cxd(-w.re, -w.im));
    return cxd(-r.re, -r.im);
  }
  const cxd w2(w.re * w.re - w.im * w.im, 2 * w.re * w.im);
  const cxd s = csqrt_d(cxd(w2.re + 1, w2.im));
  const cxd q = op_div<cxd>(w2, cxd(s.re + 1, s.im));
  return clog1p_d(cxd(w.re + q.re, w.im + q.im));
}
// s = a + b and its rounding error e (Knuth's TwoSum).
MAP_HD double two_sum(double a, double b, double& e) {
  const double s = a + b, bb = s - a;
  e = (a - (s - bb)) + (b - bb);
  return s;
}
// atanh(w) = (log(1 + w) - log(1 - w)) / 2, in the forms without
// cancellation: Re = log1p(4u / ((1 - u)^2 + v^2)) / 4,
// Im = atan2(2v, 1 - u^2 - v^2) / 2, 1 - u^2 - v^2 summed from the
// exact squares (fma) so it keeps its digits near |w| = 1; on Re w >= 0
// (odd otherwise), where the log1p argument is not near -1.
MAP_HD cxd catanh_d(cxd w) {
  if (std::signbit(w.re)) {
    const cxd r = catanh_d(cxd(-w.re, -w.im));
    return cxd(-r.re, -r.im);
  }
  const double u = w.re, v = w.im, a = 1 - u;
  const double uh = u * u, ul = std::fma(u, u, -uh);
  const double vh = v * v, vl = std::fma(v, v, -vh);
  double e1, e2;
  const double s1 = two_sum(1.0, -uh, e1);
  const double s2 = two_sum(s1, -vh, e2);
  const double d = s2 + (((e1 + e2) - ul) - vl);
  return cxd(0.25 * std::log1p(4 * u / (a * a + v * v)),
             0.5 * std::atan2(2 * v, d));
}

template <typename C>
MAP_HD cx<C> msqrt(cx<C> a) { return cx_round<C>(csqrt_d(cx_wide(a))); }
template <typename C>
MAP_HD cx<C> mlog(cx<C> a) { return cx_round<C>(clog_d(cx_wide(a))); }
template <typename C>
MAP_HD cx<C> mlog2(cx<C> a) {
  const cxd l = clog_d(cx_wide(a));
  const double k = 1.4426950408889634;          // 1 / log(2)
  return cx_round<C>(cxd(l.re * k, l.im * k));
}
template <typename C>
MAP_HD cx<C> mlog10(cx<C> a) {
  const cxd l = clog_d(cx_wide(a));
  const double k = 0.43429448190325176;         // 1 / log(10)
  return cx_round<C>(cxd(l.re * k, l.im * k));
}
template <typename C>
MAP_HD cx<C> msinh(cx<C> a) { return cx_round<C>(csinh_d(cx_wide(a))); }
template <typename C>
MAP_HD cx<C> mcosh(cx<C> a) { return cx_round<C>(ccosh_d(cx_wide(a))); }
template <typename C>
MAP_HD cx<C> mtanh(cx<C> a) { return cx_round<C>(ctanh_d(cx_wide(a))); }
// sin z = -i sinh(iz), cos z = cosh(iz), tan z = -i tanh(iz).
template <typename C>
MAP_HD cx<C> msin(cx<C> a) {
  const cxd r = csinh_d(cxd(-double(a.im), a.re));
  return cx_round<C>(cxd(r.im, -r.re));
}
template <typename C>
MAP_HD cx<C> mcos(cx<C> a) {
  return cx_round<C>(ccosh_d(cxd(-double(a.im), a.re)));
}
template <typename C>
MAP_HD cx<C> mtan(cx<C> a) {
  const cxd r = ctanh_d(cxd(-double(a.im), a.re));
  return cx_round<C>(cxd(r.im, -r.re));
}
// asin z = -i asinh(iz), acos z = pi/2 - asin z, atan z = -i atanh(iz).
template <typename C>
MAP_HD cx<C> masin(cx<C> a) {
  const cxd r = casinh_d(cxd(-double(a.im), a.re));
  return cx_round<C>(cxd(r.im, -r.re));
}
template <typename C>
MAP_HD cx<C> macos(cx<C> a) {
  const cxd r = casinh_d(cxd(-double(a.im), a.re));
  return cx_round<C>(cxd(1.5707963267948966 - r.im, r.re));
}
template <typename C>
MAP_HD cx<C> matan(cx<C> a) {
  const cxd r = catanh_d(cxd(-double(a.im), a.re));
  return cx_round<C>(cxd(r.im, -r.re));
}
template <typename C>
MAP_HD cx<C> mrsqrt(cx<C> a) {
  return op_div<cx<C>>(cx<C>(C(1), C(0)), msqrt(a));
}
// z ** w = exp(w log z), as thrust::pow.
template <typename C>
MAP_HD cx<C> mpow(cx<C> z, cx<C> w) {
  const cxd l = clog_d(cx_wide(z)), e = cx_wide(w);
  return cx_round<C>(cexp_d(cxd(e.re * l.re - e.im * l.im,
                                e.re * l.im + e.im * l.re)));
}

template <typename C>
MAP_HD cx<C> mconj(cx<C> a) { return cx<C>(a.re, -a.im); }
template <typename C>
MAP_HD C mmag2(cx<C> a) { return a.re * a.re + a.im * a.im; }

// ----------------------------------------------- loads by storage form
template <typename T>
MAP_HD T ld_real(const void* p, long long off) {
  return static_cast<const T*>(p)[off];
}
// A complex tensor: (re, im) pairs of its component type.
template <typename C>
MAP_HD cx<C> ld_cx(const void* p, long long off) {
  const C* q = static_cast<const C*>(p) + 2 * off;
  return cx<C>(q[0], q[1]);
}
// Complex-integer ring storage (ci8, ci16, ci32): the integer component
// type with a trailing (re, im) axis, `cs` elements between the two.
template <typename C, typename I>
MAP_HD cx<C> ld_pair(const void* p, long long off, long long cs) {
  const I* q = static_cast<const I*>(p) + off;
  return cx<C>(static_cast<C>(q[0]), static_cast<C>(q[cs]));
}
// Packed ci4: one sample a byte, the real part in the high nibble
// (MSB first), each nibble sign-extended (ops/unpack.py).
template <typename C>
MAP_HD cx<C> ld_ci4(const void* p, long long off) {
  uint8_t b = static_cast<const uint8_t*>(p)[off];
  int re = static_cast<int8_t>(b & 0xF0) >> 4;
  int im = static_cast<int8_t>(static_cast<uint8_t>(b << 4)) >> 4;
  return cx<C>(static_cast<C>(re), static_cast<C>(im));
}
// Packed ci2 and ci1: 8 / (2 NBIT) samples a byte along the last axis,
// each (re, im) pair of fields MSB first and sign-extended (the field
// order of ops/unpack.py).  `off` is the byte, `pos` the sample in it.
template <typename C, int NBIT>
MAP_HD cx<C> ld_cpacked(const void* p, long long off, long long pos) {
  constexpr int PER = 8 / NBIT;
  const uint8_t b = static_cast<const uint8_t*>(p)[off];
  const int sh = 8 - NBIT;
  const uint8_t fr = static_cast<uint8_t>(b >> ((PER - 1 - 2 * pos) * NBIT));
  const uint8_t fi = static_cast<uint8_t>(b >> ((PER - 2 - 2 * pos) * NBIT));
  const int re = static_cast<int8_t>(static_cast<uint8_t>(fr << sh)) >> sh;
  const int im = static_cast<int8_t>(static_cast<uint8_t>(fi << sh)) >> sh;
  return cx<C>(static_cast<C>(re), static_cast<C>(im));
}
// Packed real storage (i4/u4, i2/u2, i1/u1): 8 / NBIT samples a byte
// along the last axis, MSB first; a signed field is sign-extended by
// the shifts of ops/unpack.py.  `off` is the byte, `pos` the field.
template <typename T, int NBIT>
MAP_HD T ld_packed(const void* p, long long off, long long pos) {
  constexpr int PER = 8 / NBIT;
  const uint8_t b = static_cast<const uint8_t*>(p)[off];
  const uint8_t v = static_cast<uint8_t>(
      (b >> ((PER - 1 - pos) * NBIT)) & ((1 << NBIT) - 1));
  if constexpr (std::is_signed<T>::value) {
    return static_cast<T>(
        static_cast<int8_t>(static_cast<uint8_t>(v << (8 - NBIT))) >>
        (8 - NBIT));
  } else {
    return static_cast<T>(v);
  }
}

template <typename T>
MAP_HD void st(void* p, long long off, T v) {
  if constexpr (is_cx<T>::value) {
    using C = typename comp<T>::type;
    C* q = static_cast<C*>(p) + 2 * off;
    q[0] = v.re;
    q[1] = v.im;
  } else {
    static_cast<T*>(p)[off] = v;
  }
}

// A gather index as jnp indexing takes it: a negative index wraps once,
// then the index is clamped to the axis.
MAP_HD long long wrapclamp(long long i, long long n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

MAP_HD double bits_f64(long long v) {
  union { long long i; double d; } u;
  u.i = v;
  return u.d;
}

}  // namespace bfmap
'''

M1_FIRST_PREAMBLE = r'''// Generated by bifrost_tpu_torch/ops/map_codegen.py: kernel M1 for one bf.map
// program (the port's counterpart of the jnp closure of
// bifrost_tpu/ops/map.py:421-511).  Statements:
'''

M1_FIRST_LAUNCH = r'''
#ifdef __CUDACC__
__global__ void __launch_bounds__(256) map_kernel(const P p) {
  const long long total = p.m[0] + p.m[1];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    map_item(p, i);
  }
}

extern "C" int map_launch(const long long* m, void* const* ptr, int grid,
                          int block, void* stream) {
  P p;
  for (int k = 0; k < @NM@; ++k) p.m[k] = m[k];
  for (int k = 0; k < 4; ++k) p.ptr[k] = ptr[k];
  if (p.m[0] + p.m[1] == 0) return 0;
  map_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* map_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
#else
extern "C" int map_host(const long long* m, void* const* ptr) {
  P p;
  for (int k = 0; k < @NM@; ++k) p.m[k] = m[k];
  for (int k = 0; k < 4; ++k) p.ptr[k] = ptr[k];
  const long long total = p.m[0] + p.m[1];
  for (long long i = 0; i < total; ++i) map_item(p, i);
  return 0;
}
#endif
'''

M1_FIRST_BODIES = {
    'ci8': r'''//   y = 2.0*x*conj(x) + 1.0
#include "map_common.cuh"
using namespace bfmap;
#define NOFF 0LL
#define CARRY_IN 2
#define CARRY_OUT 3
struct P { long long m[15]; void* ptr[4]; };
MAP_HD cx<float> s0(const P& p, const long long* c) {
  const cx<float> v0 = ld_pair<float, int8_t>(p.ptr[0], ((c[0]) * p.m[11] + (c[1]) * p.m[12] + (c[2]) * p.m[13]), p.m[14]);
  const cx<float> v1 = op_mul<cx<float>>(cvt<cx<float>>(((double)0x1.0000000000000p+1)), cvt<cx<float>>(v0));
  const cx<float> v2 = ld_pair<float, int8_t>(p.ptr[0], ((c[0]) * p.m[11] + (c[1]) * p.m[12] + (c[2]) * p.m[13]), p.m[14]);
  const cx<float> v3 = mconj(cvt<cx<float>>(v2));
  const cx<float> v4 = op_mul<cx<float>>(cvt<cx<float>>(v1), cvt<cx<float>>(v3));
  const cx<float> v5 = op_add<cx<float>>(cvt<cx<float>>(v4), cvt<cx<float>>(((double)0x1.0000000000000p+0)));
  return cvt<cx<float>>(v5);
}

MAP_HD void map_item(const P& p, long long i) {
  if (i < p.m[0]) {
    long long c[3];
    long long r = i;
    c[2] = r % p.m[4]; r /= p.m[4];
    c[1] = r % p.m[3]; r /= p.m[3];
    c[0] = r % p.m[2]; r /= p.m[2];
    st<cx<float>>(p.ptr[1], c[0] * p.m[5] + c[1] * p.m[6] + c[2] * p.m[7], cvt<cx<float>>(s0(p, c)));
  } else {
    (void)0;
  }
}
''',
    'stencil': r'''//   y(t, s, p) = x(t,s,p) - x(t-1,s,p)
#include "map_common.cuh"
using namespace bfmap;
#define NOFF 1LL
#define CARRY_IN 2
#define CARRY_OUT 3
struct P { long long m[15]; void* ptr[4]; };
MAP_HD cx<float> s0(const P& p, const long long* c) {
  long long g0[3] = {wrapclamp((long long)(((int32_t)(c[0] + NOFF))), (p.m[8] + NOFF)), wrapclamp((long long)(((int32_t)(c[1]))), p.m[9]), wrapclamp((long long)(((int32_t)(c[2]))), p.m[10])};
  const cx<float> v1 = (g0[0] < NOFF) ? ld_cx<float>(p.ptr[CARRY_IN], ((g0[0]) * p.m[9] + g0[1]) * p.m[10] + g0[2]) : ld_pair<float, int8_t>(p.ptr[0], (((g0[0] - NOFF)) * p.m[11] + (g0[1]) * p.m[12] + (g0[2]) * p.m[13]), p.m[14]);
  const int32_t v2 = op_sub<int32_t>(cvt<int32_t>(((int32_t)(c[0] + NOFF))), cvt<int32_t>(((long long)1LL)));
  long long g3[3] = {wrapclamp((long long)(v2), (p.m[8] + NOFF)), wrapclamp((long long)(((int32_t)(c[1]))), p.m[9]), wrapclamp((long long)(((int32_t)(c[2]))), p.m[10])};
  const cx<float> v4 = (g3[0] < NOFF) ? ld_cx<float>(p.ptr[CARRY_IN], ((g3[0]) * p.m[9] + g3[1]) * p.m[10] + g3[2]) : ld_pair<float, int8_t>(p.ptr[0], (((g3[0] - NOFF)) * p.m[11] + (g3[1]) * p.m[12] + (g3[2]) * p.m[13]), p.m[14]);
  const cx<float> v5 = op_sub<cx<float>>(cvt<cx<float>>(v1), cvt<cx<float>>(v4));
  return cvt<cx<float>>(v5);
}

MAP_HD void map_item(const P& p, long long i) {
  if (i < p.m[0]) {
    long long c[3];
    long long r = i;
    c[2] = r % p.m[4]; r /= p.m[4];
    c[1] = r % p.m[3]; r /= p.m[3];
    c[0] = r % p.m[2]; r /= p.m[2];
    st<cx<float>>(p.ptr[1], c[0] * p.m[5] + c[1] * p.m[6] + c[2] * p.m[7], cvt<cx<float>>(s0(p, c)));
  } else {
    // the next carry: frame f of the last NOFF of [carry; gulp]
    long long j = i - p.m[0];
    long long chan = p.m[1] / NOFF;
    long long f = j / chan, r = j % chan;
    long long c[3];
    c[2] = r % p.m[10]; r /= p.m[10];
    c[1] = r % p.m[9]; r /= p.m[9];
    long long s = p.m[8] + f;
    cx<float> v = s < NOFF ? ld_cx<float>(p.ptr[CARRY_IN], s * chan + j % chan) : ld_pair<float, int8_t>(p.ptr[0], (((s - NOFF)) * p.m[11] + (c[1]) * p.m[12] + (c[2]) * p.m[13]), p.m[14]);
    st<cx<float>>(p.ptr[CARRY_OUT], j, v);
  }
}
''',
    'f16': r'''//   y = v * v - v * 0.5 + 1.25
#define MAP_HALF_TYPES 1
#include "map_common.cuh"
using namespace bfmap;
#define NOFF 0LL
#define CARRY_IN 2
#define CARRY_OUT 3
struct P { long long m[15]; void* ptr[4]; };
MAP_HD f16 s0(const P& p, const long long* c) {
  const f16 v0 = ld_real<f16>(p.ptr[0], ((c[0]) * p.m[11] + (c[1]) * p.m[12] + (c[2]) * p.m[13]));
  const f16 v1 = ld_real<f16>(p.ptr[0], ((c[0]) * p.m[11] + (c[1]) * p.m[12] + (c[2]) * p.m[13]));
  const f16 v2 = op_mul<f16>(cvt<f16>(v0), cvt<f16>(v1));
  const f16 v3 = ld_real<f16>(p.ptr[0], ((c[0]) * p.m[11] + (c[1]) * p.m[12] + (c[2]) * p.m[13]));
  const f16 v4 = f16(op_mul<float>(cvt<float>(cvt<f16>(v3)), cvt<float>(((double)0x1.0000000000000p-1))));
  const f16 v5 = op_sub<f16>(cvt<f16>(v2), cvt<f16>(v4));
  const f16 v6 = f16(op_add<float>(cvt<float>(cvt<f16>(v5)), cvt<float>(((double)0x1.4000000000000p+0))));
  return cvt<f16>(v6);
}

MAP_HD void map_item(const P& p, long long i) {
  if (i < p.m[0]) {
    long long c[3];
    long long r = i;
    c[2] = r % p.m[4]; r /= p.m[4];
    c[1] = r % p.m[3]; r /= p.m[3];
    c[0] = r % p.m[2]; r /= p.m[2];
    st<f16>(p.ptr[1], c[0] * p.m[5] + c[1] * p.m[6] + c[2] * p.m[7], cvt<f16>(s0(p, c)));
  } else {
    (void)0;
  }
}
''',
    'bf16': r'''//   y = v * v - v * 0.5 + 1.25
#define MAP_HALF_TYPES 1
#include "map_common.cuh"
using namespace bfmap;
#define NOFF 0LL
#define CARRY_IN 2
#define CARRY_OUT 3
struct P { long long m[15]; void* ptr[4]; };
MAP_HD bf16 s0(const P& p, const long long* c) {
  const bf16 v0 = ld_real<bf16>(p.ptr[0], ((c[0]) * p.m[11] + (c[1]) * p.m[12] + (c[2]) * p.m[13]));
  const bf16 v1 = ld_real<bf16>(p.ptr[0], ((c[0]) * p.m[11] + (c[1]) * p.m[12] + (c[2]) * p.m[13]));
  const bf16 v2 = op_mul<bf16>(cvt<bf16>(v0), cvt<bf16>(v1));
  const bf16 v3 = ld_real<bf16>(p.ptr[0], ((c[0]) * p.m[11] + (c[1]) * p.m[12] + (c[2]) * p.m[13]));
  const bf16 v4 = bf16(op_mul<float>(cvt<float>(cvt<bf16>(v3)), cvt<float>(((double)0x1.0000000000000p-1))));
  const bf16 v5 = op_sub<bf16>(cvt<bf16>(v2), cvt<bf16>(v4));
  const bf16 v6 = bf16(op_add<float>(cvt<float>(cvt<bf16>(v5)), cvt<float>(((double)0x1.4000000000000p+0))));
  return cvt<bf16>(v6);
}

MAP_HD void map_item(const P& p, long long i) {
  if (i < p.m[0]) {
    long long c[3];
    long long r = i;
    c[2] = r % p.m[4]; r /= p.m[4];
    c[1] = r % p.m[3]; r /= p.m[3];
    c[0] = r % p.m[2]; r /= p.m[2];
    st<bf16>(p.ptr[1], c[0] * p.m[5] + c[1] * p.m[6] + c[2] * p.m[7], cvt<bf16>(s0(p, c)));
  } else {
    (void)0;
  }
}
''',
    'ci2': r'''//   y = v * conj(v) + v * 2
#include "map_common.cuh"
using namespace bfmap;
#define NOFF 0LL
#define CARRY_IN 2
#define CARRY_OUT 3
struct P { long long m[11]; void* ptr[4]; };
MAP_HD cx<float> s0(const P& p, const long long* c) {
  const cx<float> v0 = ld_cpacked<float, 2>(p.ptr[0], (c[0]) * p.m[8] + ((c[1]) / 2) * p.m[9], (c[1]) % 2);
  const cx<float> v1 = ld_cpacked<float, 2>(p.ptr[0], (c[0]) * p.m[8] + ((c[1]) / 2) * p.m[9], (c[1]) % 2);
  const cx<float> v2 = mconj(cvt<cx<float>>(v1));
  const cx<float> v3 = op_mul<cx<float>>(cvt<cx<float>>(v0), cvt<cx<float>>(v2));
  const cx<float> v4 = ld_cpacked<float, 2>(p.ptr[0], (c[0]) * p.m[8] + ((c[1]) / 2) * p.m[9], (c[1]) % 2);
  const cx<float> v5 = op_mul<cx<float>>(cvt<cx<float>>(v4), cvt<cx<float>>(((long long)2LL)));
  const cx<float> v6 = op_add<cx<float>>(cvt<cx<float>>(v3), cvt<cx<float>>(v5));
  return cvt<cx<float>>(v6);
}

MAP_HD void map_item(const P& p, long long i) {
  if (i < p.m[0]) {
    long long c[2];
    long long r = i;
    c[1] = r % p.m[3]; r /= p.m[3];
    c[0] = r % p.m[2]; r /= p.m[2];
    st<cx<float>>(p.ptr[1], c[0] * p.m[4] + c[1] * p.m[5], cvt<cx<float>>(s0(p, c)));
  } else {
    (void)0;
  }
}
''',
    'ci1': r'''//   y = v * conj(v) + v * 2
#include "map_common.cuh"
using namespace bfmap;
#define NOFF 0LL
#define CARRY_IN 2
#define CARRY_OUT 3
struct P { long long m[11]; void* ptr[4]; };
MAP_HD cx<float> s0(const P& p, const long long* c) {
  const cx<float> v0 = ld_cpacked<float, 1>(p.ptr[0], (c[0]) * p.m[8] + ((c[1]) / 4) * p.m[9], (c[1]) % 4);
  const cx<float> v1 = ld_cpacked<float, 1>(p.ptr[0], (c[0]) * p.m[8] + ((c[1]) / 4) * p.m[9], (c[1]) % 4);
  const cx<float> v2 = mconj(cvt<cx<float>>(v1));
  const cx<float> v3 = op_mul<cx<float>>(cvt<cx<float>>(v0), cvt<cx<float>>(v2));
  const cx<float> v4 = ld_cpacked<float, 1>(p.ptr[0], (c[0]) * p.m[8] + ((c[1]) / 4) * p.m[9], (c[1]) % 4);
  const cx<float> v5 = op_mul<cx<float>>(cvt<cx<float>>(v4), cvt<cx<float>>(((long long)2LL)));
  const cx<float> v6 = op_add<cx<float>>(cvt<cx<float>>(v3), cvt<cx<float>>(v5));
  return cvt<cx<float>>(v6);
}

MAP_HD void map_item(const P& p, long long i) {
  if (i < p.m[0]) {
    long long c[2];
    long long r = i;
    c[1] = r % p.m[3]; r /= p.m[3];
    c[0] = r % p.m[2]; r /= p.m[2];
    st<cx<float>>(p.ptr[1], c[0] * p.m[4] + c[1] * p.m[5], cvt<cx<float>>(s0(p, c)));
  } else {
    (void)0;
  }
}
''',
    'csqrt': r'''//   y = sqrt(v)
#include "map_common.cuh"
using namespace bfmap;
#define NOFF 0LL
#define CARRY_IN 2
#define CARRY_OUT 3
struct P { long long m[15]; void* ptr[4]; };
MAP_HD cx<float> s0(const P& p, const long long* c) {
  const cx<float> v0 = ld_cx<float>(p.ptr[0], ((c[0]) * p.m[11] + (c[1]) * p.m[12] + (c[2]) * p.m[13]));
  const cx<float> v1 = msqrt(cvt<cx<float>>(v0));
  return cvt<cx<float>>(v1);
}

MAP_HD void map_item(const P& p, long long i) {
  if (i < p.m[0]) {
    long long c[3];
    long long r = i;
    c[2] = r % p.m[4]; r /= p.m[4];
    c[1] = r % p.m[3]; r /= p.m[3];
    c[0] = r % p.m[2]; r /= p.m[2];
    st<cx<float>>(p.ptr[1], c[0] * p.m[5] + c[1] * p.m[6] + c[2] * p.m[7], cvt<cx<float>>(s0(p, c)));
  } else {
    (void)0;
  }
}
''',
}


def m1_build_first(out_dir):
    """M1's first design for every form of M1_FIRST_BODIES, one nvcc
    each, all at once -> {tag: (library, ptxas)}."""
    (out_dir / "map_common.cuh").write_text(M1_FIRST_HEADER)
    flags = [f if f != str(build.CSRC) else str(out_dir)
             for f in build.MAP_NVCC_FLAGS]
    procs = {}
    for tag in M1_FIRST_BODIES:
        cu = out_dir / f"m1_first_{tag}.cu"
        cu.write_text(m1_first_source(tag))
        lib = cu.with_suffix(".so")
        procs[tag] = (lib, subprocess.Popen(
            [build.nvcc_path(), *flags, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for M1 first {tag}:\n{log}")
        dll = ctypes.CDLL(str(lib))
        dll.map_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
        dll.map_launch.restype = ctypes.c_int
        out[tag] = (lib, dll, ptxas_summary(log))
    return out


def m1_first_launch(dll, prog, x, out, carry, carry_out):
    """One launch of M1's first design on the port's operands."""
    from bifrost_tpu_torch.ops import map_kernel as mk
    ncarry = carry_out.numel() if carry_out is not None else 0
    m = m1_first_meta(out, mk.logical_shape(x, prog.inputs[0]),
                      mk._storage_strides(x, prog.inputs[0]), ncarry)
    ptrs = [x.data_ptr(), out.data_ptr(),
            carry.data_ptr() if carry is not None else 0,
            carry_out.data_ptr() if carry_out is not None else 0]
    err = dll.map_launch((ctypes.c_longlong * len(m))(*m),
                         (ctypes.c_void_p * 4)(*ptrs),
                         m1_first_grid(out.numel() + ncarry),
                         M1_FIRST_BLOCK,
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"M1 first design: launch error {err}")


def sass_loops(lib, part):
    """The SASS (cuobjdump) of the kernel whose name holds `part` in
    library `lib` -> (instructions, 64-bit divide sequences (I2F.U64.RP),
    32-bit ones (I2F.U32.RP), [(instructions, loads, stores, calls,
    divide sequences) of each loop, a backward branch's body])."""
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120).stdout
    for sec in text.split("Function : ")[1:]:
        if part not in sec.split("\n", 1)[0]:
            continue
        ins = [(int(a, 16), body.strip()) for a, body in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sec)]
        loops = []
        for addr, body in ins:
            m = re.search(r"\bBRA\s+(?:\S+\s+)?0x([0-9a-f]+)", body)
            if m and int(m.group(1), 16) <= addr:
                lo = int(m.group(1), 16)
                seg = [b for a, b in ins if lo <= a <= addr]
                loops.append((len(seg), sum("LDG" in b for b in seg),
                              sum("STG" in b for b in seg),
                              sum("CALL" in b for b in seg),
                              sum(".RP" in b and "I2F" in b for b in seg)))
        return (len(ins), sum("I2F.U64.RP" in b for _, b in ins),
                sum("I2F.U32.RP" in b for _, b in ins), loops)
    return None


# M1's variants: name -> (V from the port's program's, a text
# substitution in the generated source or None).
M1_VARIANTS = {
    "M1": (lambda v: v, None),
    "M1 2V": (lambda v: min(32, 2 * v), None),
    "M1 grid x1": (lambda v: v, ("* occ * 4;", "* occ;")),
    # the 16-byte stores without the streaming hint: the header inlined
    # into the source, its store replaced
    "M1 plain stores": (lambda v: v, (
        '#include "map_common.cuh"',
        (build.CSRC / "map_common.cuh").read_text().replace(
            "      __stcs(static_cast<w16_t*>(q) + k, v);",
            "      static_cast<w16_t*>(q)[k] = v;"))),
}


def m1_yardsticks(inputs, dev):
    """One PyTorch call per form moving the same bytes (a measure of
    what the card's memory delivers for that traffic, not the same
    function; torch.sqrt is the same function) -> {tag: (name, fn)}."""
    raw = inputs["ci8"]
    f32 = torch.empty(raw.shape, dtype=torch.float32, device=dev)
    out = {"ci8": ("copy_ int8 -> f32", lambda: f32.copy_(raw))}
    out["stencil"] = out["ci8"]
    for tag in ("f16", "bf16"):
        x = inputs[tag]
        y = torch.empty_like(x)
        out[tag] = (f"add {tag}", lambda x=x, y=y: torch.add(x, 1.25, out=y))
    c64 = torch.empty(raw.shape[:-1], dtype=torch.complex64, device=dev)
    for tag in ("ci2", "ci1"):
        out[tag] = ("fill_ complex64", lambda: c64.fill_(1))
    z = inputs["csqrt"]
    zs = torch.empty_like(z)
    out["csqrt"] = ("torch.sqrt", lambda: torch.sqrt(z, out=zs))
    return out


def m1_cases(dev, gen):
    """MAP_FORMS at [map]'s gulp: inputs (a seeded ci8 gulp for the main
    programs), the port's programs and M1_VARIANTS of them, plain outputs
    -> dict."""
    from concurrent.futures import ThreadPoolExecutor
    from bifrost_tpu_torch.ops import map_kernel as mk
    raw = torch.randint(-128, 128, (cs.B_GULP, cs.NSTAND, cs.NPOL, 2),
                        dtype=torch.int8, device=dev, generator=gen)
    inputs = cs.map_form_inputs(dev, raw)
    variants = {}
    for name, (shape, sub) in M1_VARIANTS.items():
        variants[name] = cs.map_programs(inputs)
        for _, prog in variants[name].values():
            prog.set_vec(shape(prog.vec))
            if sub is not None:
                if prog.source.count(sub[0]) != 1:
                    raise RuntimeError(f"{name}: {sub[0]!r} not once")
                prog.source = prog.source.replace(*sub)
                prog.name = f"map_{name.split()[-1]}_{prog.key}"
    allp = [pr for v in variants.values() for _, pr in v.values()]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(mk.prepare, allp))
    progs = variants["M1"]
    cases = {}
    for form in cs.MAP_FORMS:
        tag = form[0]
        op, prog = progs[tag]
        x = inputs[tag]
        shape = mk.logical_shape(x, prog.inputs[0])
        carry = op.carry_init(shape[1:], prog.inputs[0].dtype, dev) \
            if op.fuse_form == "stencil" else None
        want, wc = mk.map_apply_plain(prog, [x], shape, [], carry)
        cases[tag] = {"form": form, "op": op, "x": x, "shape": shape,
                      "carry": carry, "want": want[0], "wc": wc,
                      "progs": {name: v[tag][1]
                                for name, v in variants.items()}}
    cases["yardsticks"] = m1_yardsticks(inputs, dev)
    return cases


def m1_check(tag, case, got, gc):
    """Hold one M1 output (and next carry) against the plain version."""
    want, wc = case["want"], case["wc"]
    if case["form"][-1]:
        ok = cs.bits_equal(got.view(torch.uint8), want.view(torch.uint8))
        if gc is not None:
            ok = ok and cs.bits_equal(gc.view(torch.uint8),
                                      wc.view(torch.uint8))
    else:
        ok = cs.cx_ulps(got, want, case["x"]) <= cs.MAP_CX_ULP
    if not ok:
        raise AssertionError(f"{tag} differs from plain")


def m1_run(dev, gen, rounds, out_dir):
    """M1's designs in turns (first, the port's, its variants, then back)
    on each form; SASS counts -> {name: [ms a round]}."""
    from bifrost_tpu_torch.ops import map_kernel as mk
    firsts = m1_build_first(out_dir)
    cases = m1_cases(dev, gen)
    yards = cases.pop("yardsticks")
    for tag, case in cases.items():
        print(f"[ptxas] M1 first {tag}: {firsts[tag][2]}", flush=True)
        for name, prog in case["progs"].items():
            info = cs.map_program_info().get(prog.name)
            print(f"[ptxas] {name} {tag} (V {prog.vec}, run {prog.run}"
                  f"{', ' + prog.vec_note if prog.vec_note else ''}): "
                  f"{info}", flush=True)
        for name, lib, part in (
                ("M1 first", firsts[tag][0], "map_kernel1P"),
                ("M1", build.generated_path(case["progs"]["M1"].name,
                                            case["progs"]["M1"].source),
                 "map_kernelIiE")):
            print(f"[sass] {name} {tag} ({Path(lib).name}): "
                  f"{sass_loops(lib, part)}", flush=True)
    times = {}
    for rnd in range(rounds):
        row = {}
        for tag, case in cases.items():
            x, shape, carry = case["x"], case["shape"], case["carry"]
            out = torch.empty_like(case["want"])
            cfirst = torch.empty_like(carry) if carry is not None else None
            dll = firsts[tag][1]
            order = ["M1 first"] + list(M1_VARIANTS)
            for name in order + order[::-1]:
                out.fill_(0)
                if name == "M1 first":
                    def fn():
                        m1_first_launch(dll, case["progs"]["M1"], x, out,
                                        carry, cfirst)
                    fn()
                    gc = cfirst
                else:
                    def fn(prog=case["progs"][name]):
                        return mk.map_apply(prog, [x], shape, [], carry,
                                            [out])
                    gc = fn()[1]
                torch.cuda.synchronize()
                m1_check(f"{name} {tag}", case, out, gc)
                row.setdefault(f"{name} {tag}", []).append(
                    cs.cuda_time(fn, 20))
            yname, yfn = yards[tag]
            row[f"{yname} ({tag})"] = [cs.cuda_time(yfn, 20)]
            # the port's launches captured in a CUDA graph: device time,
            # without the host's time a launch
            row[f"M1 graph {tag}"] = [cs.graph_time(
                lambda prog=case["progs"]["M1"]: mk.map_apply(
                    prog, [x], shape, [], carry, [out]), 20)]
        row = {k: sum(v) / len(v) for k, v in row.items()}
        print(f"[round {rnd}] " + ", ".join(f"{k} {v:.4f}"
                                             for k, v in row.items()),
              flush=True)
        for k, v in row.items():
            times.setdefault(k, []).append(v)
    return times


# M1's eager explicit-index form (--only M1e) on chip_smoke's [map] eager
# shape, 65,536 x 512 complex64: name -> (program, grid axes are
# chip_smoke's (n, m) or swapped, the tile for 8-byte reads, V, a text
# substitution).  The port's choices first: 32 x 32 tiles, V from
# choose_vec (2 complex64), one vector item a thread at a time.
M1E_ITEMS_ONE = """  for (U i = tid; i < nvec; i += stride) {
    Item<I> it;
    vec_load<I>(p, (I)i, it);
    vec_store<I>(p, it);
  }
"""


def m1e_items(k):
    """The gather form's vector loop with `k` items a thread in flight."""
    its = ", ".join(f"it{j}" for j in range(k))
    ld = "\n".join(f"    if (i + {j} * stride < nvec) vec_load<I>(p, "
                   f"(I)(i + {j} * stride), it{j});" for j in range(k))
    st = "\n".join(f"    if (i + {j} * stride < nvec) vec_store<I>(p, "
                   f"it{j});" for j in range(k))
    return (M1E_ITEMS_ONE, f"  for (U i = tid; i < nvec; i += {k} * "
            f"stride) {{\n    Item<I> {its};\n{ld}\n{st}\n  }}\n")


M1E_STORE_ROLLED = (
    "#pragma unroll\n  for (int u = 0; u < TP * TQ / NT; ++u) {\n"
    "    const int k = t + u * NT, tq",
    "#pragma unroll 1\n  for (int u = 0; u < TP * TQ / NT; ++u) {\n"
    "    const int k = t + u * NT, tq")
M1E_VARIANTS = {
    "M1e transpose": ("c(i,j) = a(j,i)", True, None, None, None),
    "M1e transpose 64x32": ("c(i,j) = a(j,i)", True, (64, 32), None, None),
    "M1e transpose 32x64": ("c(i,j) = a(j,i)", True, (32, 64), None, None),
    "M1e transpose 64x64": ("c(i,j) = a(j,i)", True, (64, 64), None, None),
    "M1e transpose store rolled": ("c(i,j) = a(j,i)", True, None, None,
                                   M1E_STORE_ROLLED),
    "M1e scatter transpose": ("c(j,i) = a(i,j)", False, None, None, None),
    "M1e flip": ("c(i, nj-1-j) = a(i, j)", False, None, None, None),
    "M1e flip V4": ("c(i, nj-1-j) = a(i, j)", False, None, 4, None),
    "M1e flip V8": ("c(i, nj-1-j) = a(i, j)", False, None, 8, None),
    "M1e flip 2 items": ("c(i, nj-1-j) = a(i, j)", False, None, None,
                         m1e_items(2)),
    "M1e flip 4 items": ("c(i, nj-1-j) = a(i, j)", False, None, None,
                         m1e_items(4)),
    "M1e copy": ("c(i,j) = a(i,j)", False, None, None, None),
}


def m1e_run(dev, gen, rounds):
    """M1's eager forms and M1E_VARIANTS of them, each held bitwise
    against the plain engine's eager call, timed in turns (forward, then
    backward, each round) beside `a.t().contiguous()`, `torch.flip(a,
    [1])` and `a.clone()` -> {name: [ms a round, ...]}."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from bifrost_tpu_torch import config
    from bifrost_tpu_torch.ops import map_codegen, map_kernel as mk
    from bifrost_tpu_torch.ops.map import (clear_map_cache, eager_program,
                                           map as eager_map)
    n, m = cs.B_GULP, cs.NSTAND * cs.NPOL
    a = torch.complex(torch.randn(n, m, device=dev, generator=gen),
                      torch.randn(n, m, device=dev, generator=gen))
    cases = {}
    for name, (func, swap, tiles, vec, sub) in M1E_VARIANTS.items():
        shape = (m, n) if swap else (n, m)
        data = {"a": a}
        if func.startswith(("c(j,i)", "c(i, nj")):     # a scatter's target
            data["c"] = torch.zeros((m, n) if func.startswith("c(j,i)")
                                    else (n, m), dtype=a.dtype, device=dev)
        keep = dict(map_codegen.TILES)
        if tiles:
            map_codegen.TILES[8] = tiles
        clear_map_cache()
        try:
            prog, ins, scal, grid, _ = eager_program(func, data, ("i", "j"),
                                                     shape)
        finally:
            map_codegen.TILES.clear()
            map_codegen.TILES.update(keep)
        if vec:
            prog.set_vec(vec)
        if sub:
            if prog.source.count(sub[0]) != 1:
                raise AssertionError(f"{name}: the text to replace is not "
                                     f"in the source once")
            prog.source = prog.source.replace(sub[0], sub[1])
        prog.name = "map_" + hashlib.sha256(
            prog.source.encode()).hexdigest()[:16]
        cases[name] = (prog, ins, scal, grid, func, data, shape)
    clear_map_cache()
    with ThreadPoolExecutor(len(cases)) as pool:
        list(pool.map(lambda c: mk.prepare(c[0]), cases.values()))
    info = cs.map_program_info()
    config.set("map_method", "plain")
    try:
        for name, (prog, ins, scal, grid, func, data, shape) in \
                cases.items():
            got = mk.map_apply(prog, ins, grid, scal)[0][0]
            plan = dict(mk.map_apply.last)
            want = eager_map(func, {k: v.clone() for k, v in data.items()},
                             axis_names=("i", "j"), shape=shape)
            torch.cuda.synchronize()
            if not cs.bits_equal(torch.view_as_real(got),
                                 torch.view_as_real(want)):
                raise AssertionError(f"{name} differs from plain")
            regs = info[prog.name][1].get(("tile_" if plan["path"] == "tile"
                                           else "") + plan["index"])
            print(f"[M1e] {name}: {func!r} over {shape}, {plan['path']} "
                  f"path, V {plan['vec']}, grid {plan['grid']}, "
                  f"(registers, spill bytes) {regs}, bitwise", flush=True)
            del got, want
    finally:
        config.reset("map_method")
    lib = {"a.t().contiguous()": lambda: a.t().contiguous(),
           "torch.flip(a, [1])": lambda: torch.flip(a, [1]),
           "a.clone()": lambda: a.clone()}
    times = {k: [] for k in list(cases) + list(lib)}
    for rnd in range(rounds):
        for name in list(cases) + list(cases)[::-1]:
            prog, ins, scal, grid = cases[name][:4]
            times[name].append(cs.cuda_time(
                lambda: mk.map_apply(prog, ins, grid, scal), 20))
        for name, fn in lib.items():
            times[name].append(cs.cuda_time(fn, 20))
        print(f"[round {rnd}] " + ", ".join(
            f"{k} {v[-1]:.4f}" for k, v in times.items()), flush=True)
    return times


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default="",
                    help="comma-separated kernel IDs (K2,K1,K4,K5a,X1,M1,"
                         "M1e)")
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
    m1_times = {}
    if not only or "M1" in only:
        gen = torch.Generator(device=dev)
        gen.manual_seed(cs.SEED)
        m1_times = m1_run(dev, gen, args.rounds, out_dir)
        cs.free_device()
    if not only or "M1e" in only:
        gen = torch.Generator(device=dev)
        gen.manual_seed(cs.SEED)
        m1_times.update(m1e_run(dev, gen, args.rounds))
        cs.free_device()
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

    if "X1" in kernels:
        x1, x1_library = x1_cases(dev, gen)
        lib_calls["torch._int_mm x 4 x 128"] = (x1_library, 5)

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
        elif kid == "X1":
            for key, (xx, fmt, xout, xwant) in x1.items():
                xout.fill_(complex(float("nan"), float("nan")))
                xk.xengine_int8(xx, fmt, xout)
                torch.cuda.synchronize()
                if not cs.bits_equal(torch.view_as_real(xout),
                                     torch.view_as_real(xwant)):
                    raise AssertionError(f"{name} differs from plain "
                                         f"({key})")
            xx, fmt, xout, _ = x1["ci4"]
            row[name] = cs.cuda_time(lambda: xk.xengine_int8(xx, fmt, xout),
                                     20)
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
    times.update(m1_times)
    print(smi)
    print(json.dumps({"device": kind, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
