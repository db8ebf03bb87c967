// Data-quality apply kernels for Hopper (sm_90a): the RFI flagger's masked
// fill (K5a) and the gain calibrator's complex gain multiply (K5b).
//
// Replaces the two Pallas TPU kernels of bifrost_tpu/ops/dq_pallas.py:
//   K5a  _fill_fn  y = where(mask > 0, fill, x) on (ntime, ncell) f32 planes
//   K5b  _gain_fn  (re*gr - im*gi, re*gi + im*gr), gains broadcast over time
//
// The TPU kernels take FULL-RATE planes padded to 128 lanes x 8-row tiles:
// the flagger repeats its per-window mask and fill rows up to frame rate,
// and a complex stream is split into (re, im) planes and recombined after.
// None of that is carried over.  K5a reads x, the per-window mask rows
// (nrows, ncell) and, for a baseline fill only, the fill rows, and takes row
// t / window for frame t (which also covers a short tail window).  A complex
// stream is one launch: the interleaved (re, im) pair of a cell shares the
// cell's mask and is moved with it.  K5b reads complex64
// samples and the (ncell,) complex64 gains and writes complex64.
//
// Arithmetic: K5a selects, so it is bitwise equal to its plain version on
// every input.  K5b rounds every product and sum on its own (__fmul_rn,
// __fsub_rn, __fadd_rn, which nvcc never contracts into an FMA) in the plain
// version's order, so it too is bitwise equal to its plain version on every
// input.
//
// Bound: HBM bytes.  Each sample costs a select (K5a) or 6 operations (K5b)
// against 8 to 16 bytes moved, far below the card's ratio of operations to
// bytes.  Samples and outputs are addressed by element strides (frame,
// cell), so a ring span is read and written in place.
//
// K5a's design: where x and y hold their cells contiguously with 16-byte
// aligned bases and row strides (every main path's gulp), the vector
// kernel moves 16 bytes an access (4 f32 cells or 2 complex64 cells).  Its
// grid is cell vectors x (row, frame group) items, a frame group being up
// to kFrames frames of one mask row's window; a thread takes its cells'
// mask (and fill) once per item and walks the item's frames by pointer
// increments, kUnroll loads in flight, with no division or multiply in the
// frame loop, and a cell count that is not a multiple of the vector width
// is finished by a scalar tail in the same kernel.  Other layouts (a
// strided span) take the scalar kernel: one element a thread, a frame a
// grid row, the mask row found by dividing.  The wrapper picks the kernel
// by layout and counts the vector launches.
//
// K5b's design: a 2-D grid, threads over cells (so a warp's loads and
// stores are coalesced and the gain row is read once per frame from L2),
// blockIdx.y over frames, so no thread divides a 64-bit index.  Simple, not
// tuned: one element a thread.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;
constexpr int kFrames = 16;   // frames of one window an item walks
constexpr int kUnroll = 4;    // 16-byte loads in flight a thread

// A sample vector's load and store: plain accesses (evict-first hints
// measured no faster on the card, PERF.md §6).
__device__ __forceinline__ float4 load_vec(const float4* p) { return *p; }
__device__ __forceinline__ void store_vec(float4* p, float4 v) { *p = v; }

// The K5a item j: mask row r and its frames [t0, t0 + nt).
struct Item {
    int64_t r, t0;
    int nt;
};
__device__ __forceinline__ Item item(int64_t j, int64_t groups,
                                     int64_t ntime, int64_t window) {
    const int64_t r = j / groups;
    const int64_t f0 = (j - r * groups) * kFrames;
    const int64_t t0 = r * window + f0;
    int64_t n = window - f0 < ntime - t0 ? window - f0 : ntime - t0;
    return {r, t0, (int)(n < kFrames ? n : kFrames)};
}

// The scalar kernel: one element a thread, any element strides, a frame a
// grid row.
__device__ __forceinline__ void put_fill(float* y, const float* fill,
                                         int64_t k) {
    *y = fill ? fill[k] : 0.0f;
}
__device__ __forceinline__ void put_fill(float2* y, const float*, int64_t) {
    *y = make_float2(0.0f, 0.0f);
}

template <typename T>
__global__ void masked_fill_kernel(const T* __restrict__ x, int64_t xs_t,
                                   int64_t xs_c, T* __restrict__ y,
                                   int64_t ys_t, int64_t ys_c,
                                   const unsigned char* __restrict__ mask,
                                   const float* __restrict__ fill,
                                   int64_t ntime, int64_t ncell,
                                   int64_t window) {
    const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= ncell) return;
    for (int64_t t = blockIdx.y; t < ntime; t += gridDim.y) {
        const int64_t k = (t / window) * ncell + c;
        T* out = y + t * ys_t + c * ys_c;
        if (mask[k])
            put_fill(out, fill, k);
        else
            *out = x[t * xs_t + c * xs_c];
    }
}

// The vector kernel, on f32 lanes: kFpc floats a cell (1 for f32, 2 for
// complex64), 4 / kFpc cells a 16-byte vector.  Strides count floats.
template <int kFpc>
__global__ void masked_fill_vec_kernel(const float* __restrict__ x,
                                       int64_t xs_t, float* __restrict__ y,
                                       int64_t ys_t,
                                       const unsigned char* __restrict__ mask,
                                       const float* __restrict__ fill,
                                       int64_t ntime, int64_t ncell,
                                       int64_t window, int64_t groups,
                                       int64_t items) {
    constexpr int kCells = 4 / kFpc;
    const int64_t nvec = ncell / kCells;
    const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t c0 = v * kCells;
    if (c0 >= ncell) return;
    // A vector's mask (and fill) cells are one aligned word when the row
    // length is a multiple of the vector's cells and the base is aligned.
    const bool mwords = ncell % kCells == 0 && (uintptr_t)mask % kCells == 0;
    const bool fwords = ncell % 4 == 0 && (uintptr_t)fill % 16 == 0;
    for (int64_t j = blockIdx.y; j < items; j += gridDim.y) {
        const Item it = item(j, groups, ntime, window);
        const unsigned char* mrow = mask + it.r * ncell;
        const float* frow = fill ? fill + it.r * ncell : nullptr;
        if (v >= nvec) {   // the scalar tail: the last ncell % kCells cells
            for (int64_t c = c0; c < ncell; ++c) {
                const float* xp = x + it.t0 * xs_t + c * kFpc;
                float* yp = y + it.t0 * ys_t + c * kFpc;
                const bool m = mrow[c] != 0;
                const float f = frow ? frow[c] : 0.0f;
                for (int t = 0; t < it.nt; ++t, xp += xs_t, yp += ys_t)
#pragma unroll
                    for (int h = 0; h < kFpc; ++h) yp[h] = m ? f : xp[h];
            }
            continue;
        }
        bool m[4];
        float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (kCells == 4 && mwords) {
            const uchar4 w = *reinterpret_cast<const uchar4*>(mrow + c0);
            m[0] = w.x; m[1] = w.y; m[2] = w.z; m[3] = w.w;
        } else if (kCells == 2 && mwords) {
            const uchar2 w = *reinterpret_cast<const uchar2*>(mrow + c0);
            m[0] = m[1] = w.x;
            m[2] = m[3] = w.y;
        } else {
#pragma unroll
            for (int h = 0; h < 4; ++h) m[h] = mrow[c0 + h / kFpc];
        }
        if (frow) {   // f32 only
            if (fwords) {
                const float4 w = *reinterpret_cast<const float4*>(frow + c0);
                f[0] = w.x; f[1] = w.y; f[2] = w.z; f[3] = w.w;
            } else {
#pragma unroll
                for (int h = 0; h < 4; ++h) f[h] = frow[c0 + h];
            }
        }
        const int64_t xs4 = xs_t / 4, ys4 = ys_t / 4;
        const float4* xp = reinterpret_cast<const float4*>(
            x + it.t0 * xs_t + c0 * kFpc);
        float4* yp = reinterpret_cast<float4*>(y + it.t0 * ys_t + c0 * kFpc);
        auto sel = [&](float4 a) {
            return make_float4(m[0] ? f[0] : a.x, m[1] ? f[1] : a.y,
                               m[2] ? f[2] : a.z, m[3] ? f[3] : a.w);
        };
        int t = 0;
        for (; t + kUnroll <= it.nt; t += kUnroll) {
            float4 a[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) a[u] = load_vec(xp + u * xs4);
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
                store_vec(yp + u * ys4, sel(a[u]));
            xp += kUnroll * xs4;
            yp += kUnroll * ys4;
        }
        for (; t < it.nt; ++t, xp += xs4, yp += ys4)
            store_vec(yp, sel(load_vec(xp)));
    }
}

// K5a's items: (row, frame group) pairs, and groups a row.
void items_for(long long ntime, long long window, int64_t* groups,
               int64_t* items) {
    const int64_t per = window < ntime ? window : ntime;
    *groups = (per + kFrames - 1) / kFrames;
    *items = ((ntime + window - 1) / window) * *groups;
}

__global__ void gain_apply_kernel(const float2* __restrict__ x, int64_t xs_t,
                                  int64_t xs_c, const float2* __restrict__ g,
                                  float2* __restrict__ y, int64_t ys_t,
                                  int64_t ys_c, int64_t ntime,
                                  int64_t ncell) {
    const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= ncell) return;
    const float2 q = g[c];
    for (int64_t t = blockIdx.y; t < ntime; t += gridDim.y) {
        const float2 v = x[t * xs_t + c * xs_c];
        y[t * ys_t + c * ys_c] = make_float2(
            __fsub_rn(__fmul_rn(v.x, q.x), __fmul_rn(v.y, q.y)),
            __fadd_rn(__fmul_rn(v.x, q.y), __fmul_rn(v.y, q.x)));
    }
}

dim3 grid_for(long long ntime, long long ncell) {
    return dim3((unsigned)((ncell + kThreads - 1) / kThreads),
                (unsigned)(ntime < kMaxGridY ? ntime : kMaxGridY));
}

}  // namespace

extern "C" {

// K5a on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  x, y: (ntime, ncell) f32 (is_complex == 0) or complex64 pairs
// (is_complex != 0) with element strides (xs_t, xs_c) and (ys_t, ys_c) counted
// in those elements; mask: (ceil(ntime / window), ncell) uint8, contiguous;
// fill: the same shape in f32, or null for zeros (complex streams take
// null).  y must not overlap x.  vec != 0 takes the vector kernel, which
// needs xs_c == ys_c == 1 and x, y and their row strides 16-byte aligned.
int dq_masked_fill(const void* x, long long xs_t, long long xs_c, void* y,
                   long long ys_t, long long ys_c, const unsigned char* mask,
                   const float* fill, long long ntime, long long ncell,
                   long long window, int is_complex, int vec, void* stream) {
    if (ntime <= 0 || ncell <= 0) return 0;
    if (window <= 0 || (is_complex && fill)) return (int)cudaErrorInvalidValue;
    const int esize = is_complex ? 8 : 4;
    if (vec && (xs_c != 1 || ys_c != 1 || (uintptr_t)x % 16 ||
                (uintptr_t)y % 16 || xs_t * esize % 16 || ys_t * esize % 16))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    if (vec) {
        int64_t groups, items;
        items_for(ntime, window, &groups, &items);
        const int64_t nv = (ncell * esize / 4 + 3) / 4;   // vectors, tail too
        const dim3 grid((unsigned)((nv + kThreads - 1) / kThreads),
                        (unsigned)(items < kMaxGridY ? items : kMaxGridY));
        const int fpc = esize / 4;
        if (is_complex)
            masked_fill_vec_kernel<2><<<grid, kThreads, 0, st>>>(
                (const float*)x, xs_t * fpc, (float*)y, ys_t * fpc, mask,
                nullptr, ntime, ncell, window, groups, items);
        else
            masked_fill_vec_kernel<1><<<grid, kThreads, 0, st>>>(
                (const float*)x, xs_t, (float*)y, ys_t, mask, fill, ntime,
                ncell, window, groups, items);
        return (int)cudaGetLastError();
    }
    const dim3 grid = grid_for(ntime, ncell);
    if (is_complex)
        masked_fill_kernel<float2><<<grid, kThreads, 0, st>>>(
            (const float2*)x, xs_t, xs_c, (float2*)y, ys_t, ys_c, mask,
            nullptr, ntime, ncell, window);
    else
        masked_fill_kernel<float><<<grid, kThreads, 0, st>>>(
            (const float*)x, xs_t, xs_c, (float*)y, ys_t, ys_c, mask, fill,
            ntime, ncell, window);
    return (int)cudaGetLastError();
}

// K5b on `stream`; returns cudaGetLastError() after the launch.  x, y:
// (ntime, ncell) complex64 pairs with element strides counted in complex
// elements; g: (ncell,) complex64, contiguous.  y must not overlap x.
int dq_gain_apply(const void* x, long long xs_t, long long xs_c,
                  const void* g, void* y, long long ys_t, long long ys_c,
                  long long ntime, long long ncell, void* stream) {
    if (ntime <= 0 || ncell <= 0) return 0;
    gain_apply_kernel<<<grid_for(ntime, ncell), kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const float2*)x, xs_t, xs_c, (const float2*)g, (float2*)y, ys_t,
        ys_c, ntime, ncell);
    return (int)cudaGetLastError();
}

const char* dq_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
