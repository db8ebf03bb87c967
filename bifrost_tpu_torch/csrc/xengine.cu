// The exact int8 X-engine for Hopper (sm_90a), kernel X1.
//
//   v[c, i, j] = sum_t conj(x[t, c, i]) * x[t, c, j]
//
// on integer voltages, as vr = rr + ii and vi = ri - ir with every product
// and sum in int32, then each converted to f32 (round to nearest).  It has
// no Pallas counterpart: the JAX package computes the same four int8 x int8
// -> int32 products with jnp.einsum(..., preferred_element_type=int32)
// outside any kernel (bifrost_tpu/blocks/correlate.py, _xengine_planes_core).
// Under the correlate block's gulp guard (T < 65,536 frames) no int32 sum
// can overflow, so the result is bitwise the JAX engine's.
//
// Input: the gulp in canonical (time, freq, station*pol) order, contiguous,
// in one of two storage forms: ci8 (int8 re, im pairs, 2 bytes a sample) or
// packed ci4 (one byte a sample, re in the high nibble).  The kernel
// sign-extends the nibbles in registers.  Output: complex64 (nchan, nsp,
// nsp), contiguous (a ring span or a scratch tensor).
//
// Bound: operations.  8 * nchan * nsp^2 * T int8 operations against 1-2
// bytes a sample in and 8 bytes a visibility out; at the main path's 128 x
// 512 x 1024 that is 0.14 ms at the card's 1,979 dense int8 TOPS against
// 0.10 ms of bytes.
//
// Design (simple first; wgmma, TMA and the Hermitian half are later work):
// a block takes one channel and a 64 x 64 tile of (i, j), four warps of 32 x
// 32 each.  It walks time in stages of 64 samples: the block loads the
// stage's 64 stations of the i side and of the j side (coalesced over
// stations), splits re and im, and stores them transposed, station-major
// with time contiguous, into shared memory, so that both mma operands are
// 32-bit words of four consecutive time samples.  The row pitch of 80 bytes
// puts the eight rows a fragment load touches on distinct banks.  Each warp
// then runs mma.sync.m16n8k32 (s8 x s8 -> s32) on three accumulators: rr +
// ii, ri and ir (ri - ir is taken at the end: negating an int8 operand
// would overflow at -128).  Stations past nsp and samples past T load as
// zeros and add nothing; stores past nsp are masked.
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

// X1 on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  x: (ntime, nchan, nsp) samples, contiguous, fmt 0 = ci8 pairs,
// 1 = packed ci4; out: (nchan, nsp, nsp) complex64, contiguous.
int xengine_int8(const void* x, int fmt, long long ntime, long long nchan,
                 long long nsp, void* out, void* stream) {
    if (ntime < 1 || nchan < 1 || nsp < 1) return 0;
    if (nchan > 65535) return (int)cudaErrorInvalidConfiguration;
    const unsigned nt = (unsigned)((nsp + kTile - 1) / kTile);
    dim3 grid(nt, nt, (unsigned)nchan);
    xengine_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, fmt, ntime, nchan, nsp, (float2*)out);
    return (int)cudaGetLastError();
}

const char* xengine_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
