// Romein gridding for Hopper (sm_90a): visibilities scattered onto an
// (ngrid x ngrid) UV plane per leading "pol" plane, as a gather over a plan
// sorted by destination cell.
//
// Replaces the two Pallas TPU gridders of bifrost_tpu/ops/romein_pallas.py:
//   K6a  _gridder_fn      general per-visibility m x m kernels:
//          grid[y+j, x+k] += d * K[j, k]
//   K6b  _gridder_sep_fn  rank-1 kernels K[j, k] = u[j] v[k]:
//          grid[y+j, x+k] += u[j] * (d * v[k])
// The TPU form bins visibilities into 128 x 128 supertiles and places them
// with one-hot matmuls because the TPU has no scatter; none of that is
// carried over.  Here the plan (ops/romein.py, built once on the host) lists
// every in-grid contribution sorted by destination cell, CSR style:
// offsets[cell] .. offsets[cell + 1] index `entries`, each entry the code
// vis * m*m + j * m + k, in ascending code order within a cell.  Out-of-grid
// contributions are not in the plan, so they drop on every side.
//
// One thread per (plane, cell) walks its cell's list in order and sums the
// contributions from +0.0f, every product and sum rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, never contracted into an FMA): the order
// is fixed, so reruns are bit-identical and the result is bitwise the plain
// PyTorch version's (ops/romein_kernel.py), which walks the same lists rank
// by rank.  No atomics.
//
// Kernel planes are kept as broadcasts: `kps` is the element stride between
// the kernel planes of consecutive data planes (0 when one plane serves all)
// and `kvis` says whether the kernel varies per visibility.
//
// Bound: HBM bytes at the imaging path's shapes (each visibility read once,
// each grid cell written once); each visibility feeds m*m contributions of
// 8 (K6a) or 14 (K6b) operations.  Design: threads over cells fastest, so
// the blocks in flight share one or two data planes and the m*m re-reads of
// a visibility hit L2; the plan (a few MB) is shared by every plane and
// stays in L2.  Data and grid are addressed by element strides, so a
// time-last ring span (one frame per ringlet row) is read and written in
// place.  Simple, not fast: lanes of a warp walk lists of different length.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                       __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

// SEP == false: ka is the (.., m, m) kernel plane, kb unused.
// SEP == true:  ka is u, kb is v, each (.., m).
template <bool SEP>
__global__ void romein_kernel(const float2* __restrict__ data, int64_t ps_in,
                              int64_t vs_in, const int* __restrict__ offsets,
                              const int* __restrict__ entries, int64_t ncell,
                              int64_t ncellblk, const float2* __restrict__ ka,
                              const float2* __restrict__ kb, int64_t kps,
                              int kvis, int m, float2* __restrict__ out,
                              int64_t ps_out, int64_t cs_out, int accumulate) {
    const int64_t blk = blockIdx.x;
    const int64_t p = blk / ncellblk;
    const int64_t cell = (blk - p * ncellblk) * kThreads + threadIdx.x;
    if (cell >= ncell) return;
    const int mm = m * m;
    const int e0 = __ldg(offsets + cell), e1 = __ldg(offsets + cell + 1);
    const float2* d = data + p * ps_in;
    const float2* pa = ka + p * kps;
    const float2* pb = SEP ? kb + p * kps : nullptr;
    float ar = 0.0f, ai = 0.0f;
    for (int e = e0; e < e1; ++e) {
        const int code = __ldg(entries + e);
        const int vis = code / mm;
        const int jk = code - vis * mm;
        const float2 x = d[(int64_t)vis * vs_in];
        float2 c;
        if (SEP) {
            const int j = jk / m, k = jk - j * m;
            const int64_t kv = kvis ? (int64_t)vis * m : 0;
            c = cmul(__ldg(pa + kv + j), cmul(x, __ldg(pb + kv + k)));
        } else {
            const int64_t kv = kvis ? (int64_t)vis * mm : 0;
            c = cmul(x, __ldg(pa + kv + jk));
        }
        ar = __fadd_rn(ar, c.x);
        ai = __fadd_rn(ai, c.y);
    }
    float2* o = out + p * ps_out + cell * cs_out;
    if (accumulate) {
        const float2 g = *o;
        ar = __fadd_rn(g.x, ar);
        ai = __fadd_rn(g.y, ai);
    }
    *o = make_float2(ar, ai);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  data: complex f32 pairs, plane p's visibility v at
// p * ps_in + v * vs_in; offsets: ncell + 1 int32; entries: int32 codes;
// separable == 0: ka the m x m kernel planes (kb unused); separable != 0:
// ka = u, kb = v; kps: kernel plane stride in complex elements (0 when one
// plane is shared); kvis != 0 when kernels vary per visibility; out:
// plane p's cell c at p * ps_out + c * cs_out, overwritten, or added to
// when accumulate != 0.  Strides are in complex elements.
int romein_grid(const void* data, long long ps_in, long long vs_in,
                const int* offsets, const int* entries, long long ncell,
                long long nplane, const void* ka, const void* kb,
                long long kps, int kvis, int m, int separable, void* out,
                long long ps_out, long long cs_out, int accumulate,
                void* stream) {
    if (ncell <= 0 || nplane <= 0) return 0;
    if (m <= 0) return (int)cudaErrorInvalidValue;
    const long long ncellblk = (ncell + kThreads - 1) / kThreads;
    const long long nblk = ncellblk * nplane;
    if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)nblk);
    cudaStream_t s = (cudaStream_t)stream;
    if (separable)
        romein_kernel<true><<<grid, kThreads, 0, s>>>(
            (const float2*)data, ps_in, vs_in, offsets, entries, ncell,
            ncellblk, (const float2*)ka, (const float2*)kb, kps, kvis, m,
            (float2*)out, ps_out, cs_out, accumulate);
    else
        romein_kernel<false><<<grid, kThreads, 0, s>>>(
            (const float2*)data, ps_in, vs_in, offsets, entries, ncell,
            ncellblk, (const float2*)ka, nullptr, kps, kvis, m,
            (float2*)out, ps_out, cs_out, accumulate);
    return (int)cudaGetLastError();
}

const char* romein_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
