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
// packed ci4 (one byte a sample, re in the high nibble).  Output: complex64
// (nchan, nsp, nsp), contiguous (a ring span or a scratch tensor), the full
// matrix.  Scratch: int8 planes (2 * nchan, nsp, tp), tp = T rounded up to
// kPitch, allocated by the caller.
//
// Bound: bytes.  1-2 bytes a sample in and 8 bytes a visibility out; the
// function needs 8 int8 operations per frame and pair i <= j, since
// v[c, j, i] = conj(v[c, i, j]).  At the main path's 1024 x 128 x 512 ci4
// that is 0.10 ms of bytes at 3.35 TB/s against 0.07 ms of operations at
// the card's 1,979 dense int8 TOPS.
//
// Design: two kernels a call.
//
// (1) corner_turn reads the gulp once and writes the re and im planes
// station-major with time contiguous, the K-major layout wgmma takes for
// 8-bit operands.  A block turns 128 stations x 128 samples of one
// channel: 16-byte loads, eight threads a row (128 bytes of ci4, 256 of
// ci8), the ci8 pairs split or the ci4 nibbles sign-extended per byte in
// registers, 4 x 4 byte transposes by byte permutes into a shared tile,
// then 16-byte stores, eight threads a 128-byte plane row.
// Samples from T to tp are written as zeros; they add nothing.  (Its
// first version, each thread storing 16-byte pieces of four plane rows
// straight from registers, 32 rows a warp instruction, took 0.39-0.41 ms
// at the main shape.)
//
// (2) tiles computes a kTileM x kTileN tile of (i, j) a block for one
// channel, only the tiles that hold a pair i <= j (the Hermitian half:
// 10 of 16 at nsp 512), a channel's tiles consecutive in blockIdx.x so that
// its planes stay in L2.  One producer thread keeps TMA tiled loads (128-
// byte swizzle, kKTile samples of time a row) of the i side's and the j
// side's re and im tiles in flight into a ring of kStages stages guarded by
// full/empty mbarriers; a diagonal tile loads its planes once and reads
// them as both sides.  TMA zero-fills stations past nsp and samples past
// tp.  Two consumer warpgroups, 64 rows of i each, issue
// wgmma.mma_async m64nNk32 s8 x s8 -> s32 from shared memory, four
// products a 32-sample step into three accumulators: rr + ii, ri and ir
// (ri - ir is taken at the end: negating an int8 operand would overflow at
// -128).  The three take 3 * kTileN / 2 registers a thread, so setmaxnreg
// moves the producer's registers to the consumers.  The epilogue writes
// v[i, j] for i <= j (16 bytes a thread where nsp is even) and, for i < j,
// the mirror v[j, i] = (vr, ir - ri) straight from the registers: the four
// threads of a row write 64 contiguous bytes, and the eight rows of a warp
// 64 contiguous bytes of each mirrored row, whole 32-byte sectors, so the
// stores are not staged through shared memory (ir - ri, not -(ri - ir),
// keeps a zero +0.0 as the plain version has it).
//
// Choices measured with kernel_variants.py (PERF.md): 128 x 64 tiles, 64 x
// 128 tiles at two blocks an SM, two stages, a wgmma group left in flight
// across stages and a swizzled shared tile in the corner turn were none
// faster.  Three accumulators fit the consumers' 240 registers without
// spills, so the two-accumulator form vi = [re_i | im_i] . [im_j | ~re_j] +
// sum_t im_i (~re = -re - 1 cannot overflow) was not needed.
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kKTile = 128;    // samples of time a stage: one swizzle row
constexpr int kTileM = 128;    // stations of the i side a block
constexpr int kTileN = 128;    // stations of the j side a block
constexpr int kStages = 3;     // stages in the ring
constexpr int kPitch = 16;     // the planes' time pitch is a multiple of it
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;
constexpr int kTurnThreads = 256;
constexpr int kTurnStations = 128;  // a corner-turn block's tile
constexpr int kTurnTimes = 128;

constexpr int kConsumers = kTileM / 64;          // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBytesA = kTileM * kKTile;         // one plane's i tile
constexpr int kBytesB = kTileN * kKTile;
constexpr int kStageBytes = 2 * kBytesA + 2 * kBytesB;
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
constexpr int kAcc = kTileN / 2;                 // int32 a thread a sum
static_assert(kTileM % 64 == 0 && (kTileM % kTileN == 0 ||
                                   kTileN % kTileM == 0), "tile shape");
static_assert(kTileN == 64 || kTileN == 128, "wgmma width");
static_assert(kTurnThreads == 2 * kTurnStations && kTurnTimes == 128,
              "corner turn: 8 threads a row of 16-station pieces, 4 times "
              "a thread, 128-byte rows");

// ---------------------------------------------------------------------------
// Corner turn.

// The low nibble of each byte, sign-extended to the byte.
__device__ __forceinline__ uint32_t nibbles(uint32_t w) {
    return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// Raw bytes of four stations (ci8 pairs in w.x, w.y; ci4 bytes in w.x) ->
// their int8 re and im words (station s in byte s): ci8 pairs split, ci4
// nibbles sign-extended (re the high one).
template <int kFmt>
__device__ __forceinline__ void split(uint2 w, uint32_t& re, uint32_t& im) {
    if (kFmt == 0) {
        re = __byte_perm(w.x, w.y, 0x6420);
        im = __byte_perm(w.x, w.y, 0x7531);
    } else {
        re = nibbles(w.x >> 4);
        im = nibbles(w.x);
    }
}

// Four words of four stations each (w[u]: time u) -> o[s]: station s's
// four times.
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&o)[4]) {
    const uint32_t a = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t b = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t c = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t d = __byte_perm(w[2], w[3], 0x7362);
    o[0] = __byte_perm(a, c, 0x5410);
    o[1] = __byte_perm(a, c, 0x7632);
    o[2] = __byte_perm(b, d, 0x5410);
    o[3] = __byte_perm(b, d, 0x7632);
}

// The raw bytes of stations n .. n+15 at sample offset `row` (= (t *
// nchan + c) * nsp), zeros past nsp: 16 bytes (ci4) or 32 (ci8) as words.
// kVec: rows of whole 16-byte pieces, x 16-byte aligned.
template <int kFmt, bool kVec>
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ x,
                                         int64_t row, int64_t n, int64_t nsp,
                                         uint32_t (&w)[kFmt == 0 ? 8 : 4]) {
#pragma unroll
    for (int i = 0; i < (kFmt == 0 ? 8 : 4); ++i) w[i] = 0;
    if constexpr (kVec) {
        const uint4* p =
            reinterpret_cast<const uint4*>(x + (kFmt == 0 ? 2 : 1) * (row + n));
        const uint4 a = p[0];
        w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
        if constexpr (kFmt == 0) {
            if (n + 8 < nsp) {
                const uint4 b = p[1];
                w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
            }
        }
    } else {
#pragma unroll
        for (int s = 0; s < 16; ++s) {
            if (n + s < nsp) {
                if constexpr (kFmt == 0)
                    w[s / 2] |= (x[2 * (row + n + s)] |
                                 (uint32_t)x[2 * (row + n + s) + 1] << 8)
                                << (16 * (s % 2));
                else
                    w[s / 4] |= (uint32_t)x[row + n + s] << (8 * (s % 4));
            }
        }
    }
}

// Grid (stations / kTurnStations, tp / kTurnTimes, nchan): a block turns
// a tile of 128 stations x 128 samples of one channel.  Thread k loads
// stations 16 (k % 8) .. + 15 at the 4 times 4 (k / 8) .. + 3 (8 threads
// a row: 128 or 256 contiguous bytes), splits and transposes them to
// words of 4 times a station and stores those into a shared tile per
// plane, rows of 128 bytes a station (a swizzle that put a warp's 32
// word stores on 32 banks measured no faster: the kernel waits on device
// memory).  Then each thread writes 16-byte pieces of whole rows, 8
// threads a 128-byte row of a plane.
template <int kFmt, bool kVec>
__global__ void __launch_bounds__(kTurnThreads)
corner_turn_kernel(const uint8_t* __restrict__ x, int64_t ntime,
                   int64_t nchan, int64_t nsp, int64_t tp,
                   int8_t* __restrict__ planes) {
    __shared__ __align__(16) uint32_t tile[2][kTurnStations][kTurnTimes / 4];
    const int k = threadIdx.x;
    const int q = k % 8, r = k / 8;
    const int64_t n0 = (int64_t)blockIdx.x * kTurnStations;
    const int64_t t0 = (int64_t)blockIdx.y * kTurnTimes;
    const int64_t c = blockIdx.z;
    const int64_t n = n0 + 16 * q;
    uint32_t raw[4][kFmt == 0 ? 8 : 4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int64_t t = t0 + 4 * r + u;
        if (t < ntime && n < nsp)
            load_row<kFmt, kVec>(x, (t * nchan + c) * nsp, n, nsp, raw[u]);
        else
#pragma unroll
            for (int i = 0; i < (kFmt == 0 ? 8 : 4); ++i) raw[u][i] = 0;
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {          // stations 4g .. 4g + 3 of 16
        uint32_t wr[4], wi[4], o[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            if constexpr (kFmt == 0)
                split<0>(make_uint2(raw[u][2 * g], raw[u][2 * g + 1]), wr[u],
                         wi[u]);
            else
                split<1>(make_uint2(raw[u][g], 0), wr[u], wi[u]);
        }
        transpose4(wr, o);
#pragma unroll
        for (int s = 0; s < 4; ++s) tile[0][16 * q + 4 * g + s][r] = o[s];
        transpose4(wi, o);
#pragma unroll
        for (int s = 0; s < 4; ++s) tile[1][16 * q + 4 * g + s][r] = o[s];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2 * kTurnStations * kTurnTimes / 16 / kTurnThreads;
         ++i) {
        const int idx = k + kTurnThreads * i;
        const int m = idx % 8, st = (idx / 8) % kTurnStations;
        const int pl = idx / (8 * kTurnStations);
        if (n0 + st < nsp && t0 + 16 * m < tp)
            *reinterpret_cast<uint4*>(
                planes + ((2 * c + pl) * nsp + n0 + st) * tp + t0 + 16 * m) =
                *reinterpret_cast<const uint4*>(
                    &tile[pl][st][4 * m]);
    }
}

// ---------------------------------------------------------------------------
// The tiles: TMA, mbarriers, wgmma.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

// One box (kKTile samples x rows stations of one plane) into `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int k, int row, int plane,
                                         uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(k), "r"(row), "r"(plane), "r"(smem_u32(bar))
        : "memory");
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of
// 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sdesc(const void* p) {
    const uint64_t a = smem_u32(p);
    return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
    for (int k = 0; k < N; ++k) asm volatile("" : "+r"(d[k]) :: "memory");
}

#define XE_D8(b)                                                         \
    "+r"(d[b]), "+r"(d[b + 1]), "+r"(d[b + 2]), "+r"(d[b + 3]),          \
        "+r"(d[b + 4]), "+r"(d[b + 5]), "+r"(d[b + 6]), "+r"(d[b + 7])

// d (m64 x N, s32) += A (m64 x k32, s8) * B (N x k32, s8)^T.
template <int N>
__device__ __forceinline__ void wgmma(int (&d)[N / 2], uint64_t a,
                                      uint64_t b) {
    if constexpr (N == 128) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63}, "
            "%64, %65, p;\n}\n"
            : XE_D8(0), XE_D8(8), XE_D8(16), XE_D8(24), XE_D8(32), XE_D8(40),
              XE_D8(48), XE_D8(56)
            : "l"(a), "l"(b), "r"(1));
    } else {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31}, "
            "%32, %33, p;\n}\n"
            : XE_D8(0), XE_D8(8), XE_D8(16), XE_D8(24)
            : "l"(a), "l"(b), "r"(1));
    }
}

#undef XE_D8

// Grid (tile pairs holding some i <= j, nchan).  Threads 0 .. 128 *
// kConsumers - 1 are the consumers, the last warpgroup the producer.
__global__ void __launch_bounds__(kThreads, 1)
tiles_kernel(const __grid_constant__ CUtensorMap mapA,
             const __grid_constant__ CUtensorMap mapB, int64_t nk,
             int64_t nsp, int nb, float2* __restrict__ out) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ring = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
    uint64_t* empty = full + kStages;

    // Tile pair: row tile a takes column tiles a * kTileM / kTileN .. nb-1.
    int a = 0, p = blockIdx.x;
    while (p >= nb - a * kTileM / kTileN) {
        p -= nb - a * kTileM / kTileN;
        ++a;
    }
    const int b = a * kTileM / kTileN + p;
    const int i0 = a * kTileM, j0 = b * kTileN;
    const int c = blockIdx.y;
    const bool same = kTileM == kTileN && a == b;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 128 * kConsumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == kConsumers) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(kProducerRegs));
        if (threadIdx.x == 128 * kConsumers) {
            const uint32_t bytes = same ? 2 * kBytesA : kStageBytes;
            int s = 0;
            uint32_t ph = 0;
            for (int64_t kt = 0; kt < nk; ++kt) {
                mbar_wait(&empty[s], ph ^ 1);
                mbar_expect_tx(&full[s], bytes);
                uint8_t* st = ring + s * kStageBytes;
                const int k0 = (int)(kt * kKTile);
                tma_load(st, &mapA, k0, i0, 2 * c, &full[s]);
                tma_load(st + kBytesA, &mapA, k0, i0, 2 * c + 1, &full[s]);
                if (!same) {
                    tma_load(st + 2 * kBytesA, &mapB, k0, j0, 2 * c,
                             &full[s]);
                    tma_load(st + 2 * kBytesA + kBytesB, &mapB, k0, j0,
                             2 * c + 1, &full[s]);
                }
                if (++s == kStages) {
                    s = 0;
                    ph ^= 1;
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(kConsumerRegs));
        int accr[kAcc], accp[kAcc], accq[kAcc];
#pragma unroll
        for (int e = 0; e < kAcc; ++e) accr[e] = accp[e] = accq[e] = 0;
        int s = 0;
        uint32_t ph = 0;
        for (int64_t kt = 0; kt < nk; ++kt) {
            mbar_wait(&full[s], ph);
            const uint8_t* st = ring + s * kStageBytes;
            const uint8_t* ar = st + wg * 64 * kKTile;
            const uint8_t* ai = ar + kBytesA;
            const uint8_t* br = same ? st : st + 2 * kBytesA;
            const uint8_t* bi = br + kBytesB;
            fence_acc(accr);
            fence_acc(accp);
            fence_acc(accq);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
            for (int k = 0; k < kKTile; k += 32) {
                wgmma<kTileN>(accr, sdesc(ar + k), sdesc(br + k));
                wgmma<kTileN>(accr, sdesc(ai + k), sdesc(bi + k));
                wgmma<kTileN>(accp, sdesc(ar + k), sdesc(bi + k));
                wgmma<kTileN>(accq, sdesc(ai + k), sdesc(br + k));
            }
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            wgmma_wait<0>();
            fence_acc(accr);
            fence_acc(accp);
            fence_acc(accq);
            mbar_arrive(&empty[s]);
            if (++s == kStages) {
                s = 0;
                ph ^= 1;
            }
        }

        // Accumulator layout of m64nN: warp w's rows 16w + lane / 4 (+ 8),
        // columns 8k + 2 (lane % 4) (+ 1).
        const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
        const int64_t ib = i0 + wg * 64 + warp * 16 + lane / 4;
        const int64_t jb = j0 + (lane % 4) * 2;
        float2* oc = out + (int64_t)c * nsp * nsp;
        const bool even = (nsp & 1) == 0;
#pragma unroll
        for (int k = 0; k < kTileN / 8; ++k) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int64_t i = ib + 8 * h, j = jb + 8 * k;
                const int e = 4 * k + 2 * h;
                if (i >= nsp || i > j + 1) continue;
                const float r0 = __int2float_rn(accr[e]);
                const float r1 = __int2float_rn(accr[e + 1]);
                if (even && i <= j && j + 1 < nsp) {
                    *reinterpret_cast<float4*>(oc + i * nsp + j) =
                        make_float4(r0, __int2float_rn(accp[e] - accq[e]),
                                    r1,
                                    __int2float_rn(accp[e + 1] - accq[e + 1]));
                } else {
                    if (i <= j && j < nsp)
                        oc[i * nsp + j] =
                            make_float2(r0, __int2float_rn(accp[e] - accq[e]));
                    if (j + 1 < nsp)
                        oc[i * nsp + j + 1] = make_float2(
                            r1, __int2float_rn(accp[e + 1] - accq[e + 1]));
                }
                if (i < j && j < nsp)
                    oc[j * nsp + i] =
                        make_float2(r0, __int2float_rn(accq[e] - accp[e]));
                if (i < j + 1 && j + 1 < nsp)
                    oc[(j + 1) * nsp + i] = make_float2(
                        r1, __int2float_rn(accq[e + 1] - accp[e + 1]));
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Host side.

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Errors of this file's own, beside cudaError_t's (all positive).
constexpr int kErrNoEncoder = -1;   // no cuTensorMapEncodeTiled to call
constexpr int kErrEncode = -2;      // cuTensorMapEncodeTiled refused the map
constexpr int kErrPitch = -3;       // tp < ntime or tp % kPitch != 0

// libcuda's cuTensorMapEncodeTiled, found through the runtime, so that
// the library needs no link against libcuda.
EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// The planes (2 * nchan, nsp, tp) as a 3-D map of boxes of kKTile samples
// x `rows` stations of one plane, 128-byte swizzle, zeros out of bounds.
int plane_map(CUtensorMap* map, void* planes, long long tp, long long nsp,
              long long nchan, int rows) {
    EncodeTiled enc = encoder();
    if (enc == nullptr) return kErrNoEncoder;
    const cuuint64_t dims[3] = {(cuuint64_t)tp, (cuuint64_t)nsp,
                                (cuuint64_t)(2 * nchan)};
    const cuuint64_t strides[2] = {(cuuint64_t)tp, (cuuint64_t)(tp * nsp)};
    const cuuint32_t box[3] = {kKTile, (cuuint32_t)rows, 1};
    const cuuint32_t step[3] = {1, 1, 1};
    const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, planes, dims,
                           strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// Tile pairs holding a pair i <= j: row tile a takes column tiles
// a * kTileM / kTileN .. nb - 1.
long long tile_pairs(long long nsp, int* nb_out) {
    const long long na = (nsp + kTileM - 1) / kTileM;
    const long long nb = (nsp + kTileN - 1) / kTileN;
    long long n = 0;
    for (long long a = 0; a < na; ++a) n += nb - a * kTileM / kTileN;
    *nb_out = (int)nb;
    return n;
}

}  // namespace

extern "C" {

// The corner turn alone on `stream`: x (ntime, nchan, nsp) samples,
// contiguous, fmt 0 = ci8 pairs, 1 = packed ci4 -> planes (2 * nchan, nsp,
// tp) int8, plane 2c re and 2c + 1 im of channel c.  Returns
// cudaGetLastError() after the launch (0 on success) or a negative error of
// this file.
int xengine_corner_turn(const void* x, int fmt, long long ntime,
                        long long nchan, long long nsp, void* planes,
                        long long tp, void* stream) {
    if (ntime < 1 || nchan < 1 || nsp < 1) return 0;
    if (nchan > 65535) return (int)cudaErrorInvalidConfiguration;
    if (tp < ntime || tp % kPitch) return kErrPitch;
    const bool vec = nsp % (fmt == 0 ? 8 : 16) == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    dim3 grid((unsigned)((nsp + kTurnStations - 1) / kTurnStations),
              (unsigned)((tp + kTurnTimes - 1) / kTurnTimes), (unsigned)nchan);
    auto kernel = fmt == 0 ? (vec ? corner_turn_kernel<0, true>
                                  : corner_turn_kernel<0, false>)
                           : (vec ? corner_turn_kernel<1, true>
                                  : corner_turn_kernel<1, false>);
    kernel<<<grid, kTurnThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)x, ntime, nchan, nsp, tp, (int8_t*)planes);
    return (int)cudaGetLastError();
}

// The tiles alone on `stream`: planes as xengine_corner_turn writes them
// -> out (nchan, nsp, nsp) complex64, contiguous.
int xengine_tiles(void* planes, long long tp, long long nchan, long long nsp,
                  void* out, void* stream) {
    if (tp < 1 || nchan < 1 || nsp < 1) return 0;
    if (nchan > 65535) return (int)cudaErrorInvalidConfiguration;
    if (tp % kPitch) return kErrPitch;
    CUtensorMap mapA, mapB;
    int err = plane_map(&mapA, planes, tp, nsp, nchan, kTileM);
    if (!err) err = plane_map(&mapB, planes, tp, nsp, nchan, kTileN);
    if (err) return err;
    cudaError_t e = cudaFuncSetAttribute(
        tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    int nb;
    const long long npair = tile_pairs(nsp, &nb);
    dim3 grid((unsigned)npair, (unsigned)nchan);
    tiles_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        mapA, mapB, (tp + kKTile - 1) / kKTile, nsp, nb, (float2*)out);
    return (int)cudaGetLastError();
}

// X1 on `stream`: the corner turn, then the tiles.  `planes` is the
// scratch (2 * nchan, nsp, tp) int8, tp a multiple of kPitch >= ntime.
int xengine_int8(const void* x, int fmt, long long ntime, long long nchan,
                 long long nsp, void* planes, long long tp, void* out,
                 void* stream) {
    const int err = xengine_corner_turn(x, fmt, ntime, nchan, nsp, planes, tp,
                                        stream);
    return err ? err : xengine_tiles(planes, tp, nchan, nsp, out, stream);
}

// Registers a thread (at launch: setmaxnreg then moves the producer's to
// the consumers), local bytes, static and dynamic shared memory a block
// of kernel `which`: 0 the corner turn on ci4, 1 the tiles, 2 the corner
// turn on ci8 (both for aligned rows of whole station quads).
int xengine_kernel_info(int which, int* regs, int* local_bytes,
                        int* static_smem, int* dynamic_smem) {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(
        &attr, which == 0   ? (const void*)corner_turn_kernel<1, true>
               : which == 1 ? (const void*)tiles_kernel
                            : (const void*)corner_turn_kernel<0, true>);
    if (e != cudaSuccess) return (int)e;
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    *static_smem = (int)attr.sharedSizeBytes;
    *dynamic_smem = which == 1 ? kSmemBytes : 0;
    return 0;
}

const char* xengine_error_string(int err) {
    switch (err) {
        case kErrNoEncoder:
            return "cuTensorMapEncodeTiled is not available";
        case kErrEncode:
            return "cuTensorMapEncodeTiled refused the planes' map";
        case kErrPitch:
            return "the planes' time pitch is below ntime or not a "
                   "multiple of 16";
        default:
            return cudaGetErrorString((cudaError_t)err);
    }
}

}  // extern "C"
