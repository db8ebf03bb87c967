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
// cell's mask and is moved as one 8-byte element.  K5b reads complex64
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
// bytes.  Design: a 2-D grid, threads over cells (so a warp's loads and
// stores are coalesced and the mask and gain rows are read once per frame
// from L2), blockIdx.y over frames, so no thread divides a 64-bit index.
// Samples and outputs are addressed by element strides (frame, cell), so a
// ring span is read and written in place.  Simple, not tuned: one element a
// thread, no vector loads wider than the element.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxGridY = 65535;

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
// null).  y must not overlap x.
int dq_masked_fill(const void* x, long long xs_t, long long xs_c, void* y,
                   long long ys_t, long long ys_c, const unsigned char* mask,
                   const float* fill, long long ntime, long long ncell,
                   long long window, int is_complex, void* stream) {
    if (ntime <= 0 || ncell <= 0) return 0;
    if (window <= 0 || (is_complex && fill)) return (int)cudaErrorInvalidValue;
    dim3 grid = grid_for(ntime, ncell);
    if (is_complex)
        masked_fill_kernel<float2><<<grid, kThreads, 0,
                                     (cudaStream_t)stream>>>(
            (const float2*)x, xs_t, xs_c, (float2*)y, ys_t, ys_c, mask,
            nullptr, ntime, ncell, window);
    else
        masked_fill_kernel<float><<<grid, kThreads, 0,
                                    (cudaStream_t)stream>>>(
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
