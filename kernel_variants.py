"""Time the port's redesigned kernels against variants of their sources on
a CUDA card: the FIR MAC K2, the FDMT merge step K1, the B-engine K4, the
masked fill K5a and the int8 X-engine X1.

    python3 kernel_variants.py [--rounds N] [--only K2,K1]

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
rounds.  Prints each variant's
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", default="",
                    help="comma-separated kernel IDs (K2,K1,K4,K5a,X1)")
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
    print(smi)
    print(json.dumps({"device": kind, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
