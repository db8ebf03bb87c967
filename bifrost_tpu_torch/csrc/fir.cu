// Per-lane FIR multiply-accumulate for Hopper (sm_90a).
//
// Replaces bifrost_tpu/ops/fir_pallas.py::_fir_fn, the Pallas TPU
// channels-on-lanes FIR tile walk (and, through it, the MAC stage of
// bifrost_tpu/ops/pfb_pallas.py::pfb_tiled).  For output frame j and lane L,
// with t = j * decim and the (ntap - 1) carried history rows in front of x:
//
//   y[j, L] = sum over k = 0 .. ntap-1, ascending, starting from +0.0f, of
//             xh[t + k, L] * h[ntap - 1 - k, L / rep]
//
// where xh is `state` (ntap - 1 rows, f32) followed by `x` (f32 or int8,
// lifted to f32 in registers, which is exact).  `rep` lanes share one
// coefficient column: 1 for a plain FIR, nstream * ncomp for the PFB, whose
// folded lanes are (chan * nstream + stream) * ncomp + comp, so the kernel
// indexes the (ntap, nchan) prototype rather than a folded bank.
//
// Bound: HBM bytes.  Each output costs ntap multiplies and adds against one
// 4-byte store and, once per input element, a 1- or 4-byte load; the card's
// ratio of operations to bytes is far above that.  Design: one thread per
// (output frame, lane); threads of a block walk lanes, so every load and
// store of a warp is coalesced; the ntap rows a thread reads are read by the
// ntap neighbouring output frames too, and stay in L2 between them.  The
// Pallas kernel's 8-row lead padding, 128-lane padding and materialised tile
// copies exist only for Mosaic and are dropped: a thread reads the history
// rows where they lie.  Products and sums are rounded separately
// (__fmul_rn, __fadd_rn, which nvcc never contracts into an FMA), so the
// result is bitwise the plain PyTorch version's (ops/fir_kernel.py).
// Element offsets are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void fir_mac_kernel(const T* __restrict__ x,
                               const float* __restrict__ state,
                               const float* __restrict__ coeffs,
                               float* __restrict__ out, int64_t nout,
                               int64_t lanes, int ntap, int decim,
                               int64_t rep, int64_t ncoef) {
    const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int hist = ntap - 1;
    const int64_t col = lane / rep;
    for (int64_t j = blockIdx.y; j < nout; j += gridDim.y) {
        const int64_t t = j * decim;
        float acc = 0.0f;
        for (int k = 0; k < ntap; ++k) {
            const int64_t r = t + k;
            const float v = r < hist
                ? state[r * lanes + lane]
                : (float)x[(r - hist) * lanes + lane];
            acc = __fadd_rn(acc, __fmul_rn(v, coeffs[(int64_t)(hist - k) *
                                                     ncoef + col]));
        }
        out[j * lanes + lane] = acc;
    }
}

template <typename T>
int launch(const void* x, const float* state, const float* coeffs,
           float* out, long long nout, long long lanes, int ntap, int decim,
           long long rep, long long ncoef, void* stream) {
    if (nout <= 0 || lanes <= 0) return 0;
    dim3 block(kThreads);
    dim3 grid((unsigned)((lanes + kThreads - 1) / kThreads),
              (unsigned)(nout < 65535 ? nout : 65535));
    fir_mac_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)x, state, coeffs, out, nout, lanes, ntap, decim, rep,
        ncoef);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the MAC on `stream`; returns cudaGetLastError() after the launch
// (0 on success).  x: (nin, lanes) f32 (x_int8 == 0) or int8 (x_int8 != 0),
// nin = (nout - 1) * decim + 1 at least; state: (ntap - 1, lanes) f32, unused
// when ntap == 1; coeffs: (ntap, ncoef) f32 with ncoef * rep == lanes;
// out: (nout, lanes) f32.
int fir_mac(const void* x, int x_int8, const float* state,
            const float* coeffs, float* out, long long nout,
            long long lanes, int ntap, int decim, long long rep,
            long long ncoef, void* stream) {
    if (x_int8)
        return launch<int8_t>(x, state, coeffs, out, nout, lanes, ntap,
                              decim, rep, ncoef, stream);
    return launch<float>(x, state, coeffs, out, nout, lanes, ntap, decim,
                         rep, ncoef, stream);
}

const char* fir_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
