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
// Bound: HBM bytes at this path's shapes (8 beams: 8 operations per beam
// and 8-byte sample), but only just: with no FMA the operations are as many
// FMUL/FADD instructions, close to the byte time on 132 SMs, so loads and
// arithmetic must overlap.  Design:
// - A thread owns kRowsPerThread (frame, channel) rows and a group of
//   kGroup beams (16 accumulators a row): each voltage it reads from shared
//   memory feeds every beam of the group, each weight every row.  More
//   beams run as more blocks (one per group, groups fastest, so a tile's
//   groups read its voltages from L2).  One row a thread measured fastest:
//   two halve the warps an SM, which costs more than the weight loads they
//   share save.
// - A block's kRows rows are `frames` frames x `chans` channels, frames
//   outer; all frames of a channel stay in one block, in tiles of `frames`
//   frames, so the frame sum runs in one place: each tile's powers land in
//   shared memory and one thread per (channel, beam) adds them in frame
//   order, carrying its sum across tiles.
// - Voltages stream through a ring of kStages chunks of kRowBytes bytes a
//   row (16 c64 or 64 ci8 stations), copied by cp.async (16 bytes where a
//   row's bytes are 16-byte aligned, else one element each) while the
//   previous chunk is summed.  Small chunks and a two-deep ring keep a
//   block of 256 rows at 70 KB of shared memory (a tile's powers reuse
//   the ring), so two blocks share an SM and one block's loads overlap the
//   other's sums; a third block (80 registers a thread) measured no faster
//   (PERF.md §6 has the geometries measured).  The 16-byte pieces of row
//   r are XOR-swizzled by r & 7, so the 8 rows of a 16-byte shared load
//   phase hit distinct banks.  The chunk's weights are staged beside it as
//   [s][b], read by every thread of a warp at one address (a broadcast).
//   The last, short chunk is summed by a loop with a runtime bound;
//   chunking cuts the station loop, never its order.
// Element offsets are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;      // (frame, channel) rows per block
constexpr int kRowsPerThread = 1;  // rows a thread sums
constexpr int kThreads = kRows / kRowsPerThread;
constexpr int kGroup = 8;       // beams per block: a thread's register tile
constexpr int kMaxBeams = 128;  // beams a launch
constexpr int kRowBytes = 128;  // bytes of a row staged per chunk
constexpr int kStages = 2;      // chunks in the ring
constexpr int kPieces = kRowBytes / 16;
static_assert(kPieces % 8 == 0, "the swizzle permutes 8 pieces of a row");
static_assert(kRows % kRowsPerThread == 0, "whole rows a thread");

template <typename T>
struct Elem;
template <>
struct Elem<float2> {   // complex64: 2 stations a 16-byte piece
    static constexpr int kPer = 2;
    __device__ static float2 get(uint4 v, int j) {
        return j ? make_float2(__uint_as_float(v.z), __uint_as_float(v.w))
                 : make_float2(__uint_as_float(v.x), __uint_as_float(v.y));
    }
    __device__ static float2 lift(float2 v) { return v; }
};
template <>
struct Elem<char2> {    // ci8 storage: 8 stations a 16-byte piece
    static constexpr int kPer = 8;
    __device__ static float2 get(uint4 v, int j) {
        const unsigned u[4] = {v.x, v.y, v.z, v.w};
        const unsigned q = u[j >> 1];
        const int h = 16 * (j & 1);
        return make_float2((float)((int)(q << (24 - h)) >> 24),
                           (float)((int)(q << (16 - h)) >> 24));
    }
    __device__ static float2 lift(char2 v) {
        return make_float2((float)v.x, (float)v.y);
    }
};

template <typename T>
__host__ __device__ constexpr int stations() { return kRowBytes / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
    return kRows * kRowBytes + stations<T>() * kGroup * (int)sizeof(float2);
}
// The ring, then the row offsets; a tile's powers reuse the first stage.
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
    return kStages * stage_bytes<T>() + kRows * (int)sizeof(int64_t);
}
static_assert(kRows * kGroup * (int)sizeof(float) <= kRows * kRowBytes,
              "a tile's powers fit in a stage");

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
    return a < b ? a : b;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of byte `b` of row r's chunk in a stage: 16-byte pieces
// swizzled by r & 7.
__device__ __forceinline__ int swz(int r, int b) {
    return r * kRowBytes + ((((b >> 4) ^ (r & 7))) << 4) + (b & 15);
}

// One element copy of the unaligned path: c64 by cp.async, ci8 by hand.
__device__ __forceinline__ void copy_elem(float2* dst, const float2* src) {
    cp_async8(dst, src);
}
__device__ __forceinline__ void copy_elem(char2* dst, const char2* src) {
    *dst = *src;
}

// The station step of a thread's rows for the kGroup beams of the group,
// in the plain version's order.
__device__ __forceinline__ void step(const float2* v, const float2* ws,
                                     float (*br)[kGroup],
                                     float (*bi)[kGroup]) {
    const float4* w4 = reinterpret_cast<const float4*>(ws);
#pragma unroll
    for (int p = 0; p < kGroup / 2; ++p) {
        const float4 q = w4[p];
        const float wr[2] = {q.x, q.z}, wi[2] = {q.y, q.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int b = 2 * p + h;
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i) {
                br[i][b] = __fadd_rn(br[i][b], __fmul_rn(v[i].x, wr[h]));
                br[i][b] = __fsub_rn(br[i][b], __fmul_rn(v[i].y, wi[h]));
                bi[i][b] = __fadd_rn(bi[i][b], __fmul_rn(v[i].x, wi[h]));
                bi[i][b] = __fadd_rn(bi[i][b], __fmul_rn(v[i].y, wr[h]));
            }
        }
    }
}

struct Args {
    const void* x;
    const float2* w;
    float* out;
    int64_t ntime, nchan, nsp;
    int nbeam, frames, chans, groups;
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
beamform_kernel(const Args a) {
    constexpr int E = (int)sizeof(T);
    constexpr int CS = stations<T>();
    constexpr int R = kRowsPerThread;
    extern __shared__ __align__(16) unsigned char smem[];
    int64_t* rowoff = reinterpret_cast<int64_t*>(smem + kStages *
                                                 stage_bytes<T>());
    float* ps = reinterpret_cast<float*>(smem);   // after the chunk loop
    const unsigned char* xb = static_cast<const unsigned char*>(a.x);

    // The thread's rows tid + i * kThreads, each frame tr of channel cr.
    const int tid = threadIdx.x;
    const int g = blockIdx.x % a.groups;
    const int64_t c0 = (int64_t)(blockIdx.x / a.groups) * a.chans;
    const int nb = min(kGroup, a.nbeam - g * kGroup);
    const float2* wg = a.w + (int64_t)g * kGroup * a.nsp;
    int row[R], tr[R], cr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        row[i] = tid + i * kThreads;
        tr[i] = row[i] / a.chans;
        cr[i] = row[i] - tr[i] * a.chans;
    }
    const int64_t nchunk = (a.nsp + CS - 1) / CS;
    constexpr int kAcc = kGroup * R;   // (channel, beam) sums a thread
    float acc[kAcc];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;

    for (int64_t t0 = 0; t0 < a.ntime; t0 += a.frames) {
        const int nt = (int)lmin(a.frames, a.ntime - t0);
#pragma unroll
        for (int i = 0; i < R; ++i)
            rowoff[row[i]] = (tr[i] < nt && c0 + cr[i] < a.nchan)
                ? ((t0 + tr[i]) * a.nchan + c0 + cr[i]) * a.nsp * E : -1;
        __syncthreads();

        // Stage chunk k (voltages and the group's weights) into its buffer.
        auto stage_chunk = [&](int64_t k) {
            unsigned char* st = smem + (int)(k % kStages) * stage_bytes<T>();
            float2* ws = reinterpret_cast<float2*>(st + kRows * kRowBytes);
            const int64_t s0 = k * CS;
            const int ns = (int)lmin(CS, a.nsp - s0);
            if constexpr (kVec) {
                const int pr = ns * E / 16;
#pragma unroll 4
                for (int i = tid; i < kRows * kPieces; i += kThreads) {
                    const int r = i / kPieces, q = i % kPieces;
                    const int64_t off = rowoff[r];
                    if (off >= 0 && q < pr)
                        cp_async16(st + swz(r, 16 * q),
                                   xb + off + s0 * E + 16 * q);
                }
            } else {
                for (int i = tid; i < kRows * CS; i += kThreads) {
                    const int r = i / CS, s = i % CS;
                    const int64_t off = rowoff[r];
                    if (off >= 0 && s < ns)
                        copy_elem(reinterpret_cast<T*>(st + swz(r, E * s)),
                                  reinterpret_cast<const T*>(
                                      xb + off + (s0 + s) * E));
                }
            }
            for (int i = tid; i < CS * kGroup; i += kThreads) {
                const int s = i / kGroup, b = i % kGroup;
                if (s < ns && b < nb)
                    cp_async8(ws + i, wg + (int64_t)b * a.nsp + s0 + s);
            }
            cp_async_commit();
        };

        float br[R][kGroup], bi[R][kGroup];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int b = 0; b < kGroup; ++b) br[i][b] = bi[i][b] = 0.0f;
#pragma unroll
        for (int k = 0; k < kStages - 1; ++k) {
            if (k < nchunk) stage_chunk(k);
            else cp_async_commit();
        }
        for (int64_t k = 0; k < nchunk; ++k) {
            cp_async_wait<kStages - 2>();
            __syncthreads();   // chunk k landed; chunk k - 1 summed by all
            if (k + kStages - 1 < nchunk) stage_chunk(k + kStages - 1);
            else cp_async_commit();
            const unsigned char* st = smem + (int)(k % kStages) *
                                                 stage_bytes<T>();
            const float2* ws = reinterpret_cast<const float2*>(
                st + kRows * kRowBytes);
            const int ns = (int)lmin(CS, a.nsp - k * CS);
            float2 v[R];
            if (ns == CS) {
#pragma unroll
                for (int q = 0; q < kPieces; ++q) {
                    uint4 u[R];
#pragma unroll
                    for (int i = 0; i < R; ++i)
                        u[i] = *reinterpret_cast<const uint4*>(
                            st + swz(row[i], 16 * q));
#pragma unroll
                    for (int j = 0; j < Elem<T>::kPer; ++j) {
#pragma unroll
                        for (int i = 0; i < R; ++i)
                            v[i] = Elem<T>::get(u[i], j);
                        step(v, ws + (q * Elem<T>::kPer + j) * kGroup, br,
                             bi);
                    }
                }
            } else {
                for (int s = 0; s < ns; ++s) {
#pragma unroll
                    for (int i = 0; i < R; ++i)
                        v[i] = Elem<T>::lift(*reinterpret_cast<const T*>(
                            st + swz(row[i], E * s)));
                    step(v, ws + s * kGroup, br, bi);
                }
            }
        }

        // Detect into the idle ring (every copy has landed); then one
        // thread per (channel, beam) adds the tile's powers in frame order.
        __syncthreads();
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
            for (int b = 0; b < kGroup; ++b)
                ps[row[i] * kGroup + b] = __fadd_rn(
                    __fmul_rn(br[i][b], br[i][b]),
                    __fmul_rn(bi[i][b], bi[i][b]));
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kAcc; ++j) {
            const int k = tid + j * kThreads;
            if (k < a.chans * kGroup)
                for (int i = 0; i < nt; ++i)
                    acc[j] = __fadd_rn(acc[j], ps[i * a.chans * kGroup + k]);
        }
    }
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
        const int k = tid + j * kThreads;
        const int cc = k / kGroup, b = k % kGroup;
        if (k < a.chans * kGroup && b < nb && c0 + cc < a.nchan)
            a.out[(int64_t)(g * kGroup + b) * a.nchan + c0 + cc] = acc[j];
    }
}

template <typename T, bool kVec>
cudaError_t prepare() {
    return cudaFuncSetAttribute(beamform_kernel<T, kVec>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_bytes<T>());
}

template <typename T, bool kVec>
int launch(const Args& a, void* stream) {
    const cudaError_t err = prepare<T, kVec>();
    if (err != cudaSuccess) return (int)err;
    const int64_t tiles = (a.nchan + a.chans - 1) / a.chans;
    beamform_kernel<T, kVec><<<(unsigned)(tiles * a.groups), kThreads,
                               smem_bytes<T>(), (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename T, bool kVec>
int info(int* regs, int* local_bytes, int* smem, int* blocks_per_sm) {
    cudaError_t err = prepare<T, kVec>();
    cudaFuncAttributes fa;
    if (err == cudaSuccess)
        err = cudaFuncGetAttributes(&fa, beamform_kernel<T, kVec>);
    if (err != cudaSuccess) return (int)err;
    *regs = fa.numRegs;
    *local_bytes = (int)fa.localSizeBytes;
    *smem = smem_bytes<T>();
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, beamform_kernel<T, kVec>, kThreads, smem_bytes<T>());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  x: (ntime, nchan, nsp) complex, as f32 (re, im) pairs
// (x_int8 == 0) or int8 pairs (x_int8 != 0); w: (nbeam, nsp) complex f32
// pairs, 1 <= nbeam <= 128; nsp >= 1; out: (nbeam, nchan) f32.  ntime may
// be 0 (the powers are then +0.0).  A block holds `frames` frames of
// `chans` channels (frames * chans <= 128, frames <= max(ntime, 1));
// vec != 0 copies 16-byte pieces, which needs x and nsp * (8 or 2) bytes
// to be 16-byte aligned.
int beamform_power(const void* x, int x_int8, const void* w, float* out,
                   long long ntime, long long nchan, long long nsp,
                   int nbeam, int frames, int chans, int vec, void* stream) {
    if (nchan <= 0) return 0;
    const int esize = x_int8 ? 2 : 8;
    if (nbeam <= 0 || nbeam > kMaxBeams || nsp <= 0 || ntime < 0 ||
        frames < 1 || chans < 1 || frames * chans > kRows ||
        (vec && ((uintptr_t)x % 16 || nsp * esize % 16)))
        return (int)cudaErrorInvalidValue;
    const Args a{x, (const float2*)w, out, ntime, nchan, nsp, nbeam, frames,
                 chans, (nbeam + kGroup - 1) / kGroup};
    if (x_int8)
        return vec ? launch<char2, true>(a, stream)
                   : launch<char2, false>(a, stream);
    return vec ? launch<float2, true>(a, stream)
               : launch<float2, false>(a, stream);
}

// Registers, spilled bytes per thread, dynamic shared memory per block and
// resident blocks per SM of one instantiation; returns a CUDA error code.
int beamform_info(int x_int8, int vec, int* regs, int* local_bytes,
                  int* smem, int* blocks_per_sm) {
    if (x_int8)
        return vec ? info<char2, true>(regs, local_bytes, smem, blocks_per_sm)
                   : info<char2, false>(regs, local_bytes, smem,
                                        blocks_per_sm);
    return vec ? info<float2, true>(regs, local_bytes, smem, blocks_per_sm)
               : info<float2, false>(regs, local_bytes, smem, blocks_per_sm);
}

const char* beamform_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
