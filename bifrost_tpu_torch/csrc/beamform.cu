// B-engine for Hopper (sm_90a): per channel, complex beams over stations,
// detected and summed over time, in one pass.
//
// Replaces bifrost_tpu/ops/beamform_pallas.py::_beamform_fn, the Pallas TPU
// MXU kernel with fused detect and integrate.  For channel c and beam b,
// over the T frames of x (T, C, S) complex (f32 pairs, or int8 pairs of ci8
// storage lifted to f32 in registers, which is exact) and weights
// w (B, S) complex f32, with no conjugation of w:
//
//   br, bi = +0.0f; for s ascending:  br += xr*wr;  br -= xi*wi;
//                                     bi += xr*wi;  bi += xi*wr;
//   p[b, c] = sum over t ascending, from +0.0f, of (br*br + bi*bi)
//
// every product and sum rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, which nvcc never contracts into an FMA), so the result is
// bitwise the plain PyTorch version's (ops/beamform_kernel.py).
//
// Bound: HBM bytes at this path's shapes.  Each voltage sample (8 bytes of
// c64, 2 of ci8) feeds 8 operations per beam, so with few beams (8 here)
// the card's ratio of operations to bytes is far above the work's; the beam
// never reaches device memory.  Design: one block per channel.  The block's
// (frame, beam) pairs are its threads, beam fastest, and it walks the frames
// in tiles of TT = blockDim / B (at most 32 frames and 128 pairs).  Each
// tile's voltages are staged into shared memory in station chunks by
// coalesced loads (a channel's stations are contiguous), then every thread
// reduces its pair over the chunk in station order, reading the weights
// through the read-only cache.  The powers of a tile land in shared memory
// and the tile's first row of threads adds them to its beam's sum in frame
// order.  The Pallas kernel's
// 8-channel and 128-lane padding exist only for Mosaic and are dropped: at
// 8 beams, padding beams to 128 would be 16 times the work.  Element offsets
// are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 128;   // (frame, beam) pairs per block, at most
constexpr int kRows = 32;     // frames per tile, at most
constexpr int kChunk = 128;   // stations staged per pass

__device__ __forceinline__ float2 lift(float2 v) { return v; }
__device__ __forceinline__ float2 lift(char2 v) {
    return make_float2((float)v.x, (float)v.y);
}

template <typename T>
__global__ void beamform_kernel(const T* __restrict__ x,
                                const float2* __restrict__ w,
                                float* __restrict__ out, int64_t ntime,
                                int64_t nchan, int64_t nsp, int nbeam) {
    __shared__ float2 xs[kRows][kChunk + 1];    // +1: no bank conflicts
    __shared__ float ps[kPairs];
    const int64_t c = blockIdx.x;
    const int tid = threadIdx.x;
    const int tt_n = blockDim.x / nbeam;        // frames per tile
    const int tt = tid / nbeam;
    const int b = tid % nbeam;
    float acc = 0.0f;
    for (int64_t t0 = 0; t0 < ntime; t0 += tt_n) {
        const int nt = (int)(ntime - t0 < tt_n ? ntime - t0 : tt_n);
        float br = 0.0f, bi = 0.0f;
        for (int64_t s0 = 0; s0 < nsp; s0 += kChunk) {
            const int ns = (int)(nsp - s0 < kChunk ? nsp - s0 : kChunk);
            __syncthreads();
            for (int i = tid; i < nt * ns; i += blockDim.x) {
                const int r = i / ns, s = i % ns;
                xs[r][s] = lift(x[((t0 + r) * nchan + c) * nsp + s0 + s]);
            }
            __syncthreads();
            if (tt < nt) {
                const float2* wb = w + (int64_t)b * nsp + s0;
                for (int s = 0; s < ns; ++s) {
                    const float2 v = xs[tt][s];
                    const float2 q = __ldg(wb + s);
                    br = __fadd_rn(br, __fmul_rn(v.x, q.x));
                    br = __fsub_rn(br, __fmul_rn(v.y, q.y));
                    bi = __fadd_rn(bi, __fmul_rn(v.x, q.y));
                    bi = __fadd_rn(bi, __fmul_rn(v.y, q.x));
                }
            }
        }
        if (tt < nt)
            ps[tid] = __fadd_rn(__fmul_rn(br, br), __fmul_rn(bi, bi));
        __syncthreads();
        if (tt == 0)
            for (int r = 0; r < nt; ++r)
                acc = __fadd_rn(acc, ps[r * nbeam + b]);
    }
    if (tt == 0) out[(int64_t)b * nchan + c] = acc;
}

template <typename T>
int launch(const void* x, const void* w, float* out, long long ntime,
           long long nchan, long long nsp, int nbeam, void* stream) {
    if (nchan <= 0) return 0;
    if (nbeam <= 0 || nbeam > kPairs || nsp <= 0)
        return (int)cudaErrorInvalidValue;
    int tt = kPairs / nbeam < kRows ? kPairs / nbeam : kRows;
    if (tt > ntime) tt = ntime > 0 ? (int)ntime : 1;
    dim3 grid((unsigned)nchan);
    beamform_kernel<T><<<grid, tt * nbeam, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const float2*)w, out, ntime, nchan, nsp, nbeam);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  x: (ntime, nchan, nsp) complex, as f32 (re, im) pairs
// (x_int8 == 0) or int8 pairs (x_int8 != 0); w: (nbeam, nsp) complex f32
// pairs, 1 <= nbeam <= 128; nsp >= 1; out: (nbeam, nchan) f32.  ntime may
// be 0 (the powers are then +0.0).
int beamform_power(const void* x, int x_int8, const void* w, float* out,
                   long long ntime, long long nchan, long long nsp,
                   int nbeam, void* stream) {
    if (x_int8)
        return launch<char2>(x, w, out, ntime, nchan, nsp, nbeam, stream);
    return launch<float2>(x, w, out, ntime, nchan, nsp, nbeam, stream);
}

const char* beamform_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
