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
// indexes the (ntap, nchan) prototype rather than a folded bank.  Products
// and sums are rounded separately (__fmul_rn, __fadd_rn, which nvcc never
// contracts into an FMA), so both kernels below are bitwise the plain
// PyTorch version's (ops/fir_kernel.py).  Element offsets are 64-bit.
//
// Bound: HBM bytes.  Each output costs ntap multiplies and adds against one
// 4-byte store and, once per input element, a 1- or 4-byte load; the card's
// ratio of operations to bytes is far above that.
//
// The vector kernel (every main path's call): a thread owns V lanes of
// every row, kLanesInt8 of int8 x (one 8-byte load a row) or kLanesF32 of
// f32 x (one 16-byte load), and walks the rows of xh in order, from its
// first output frame's window to its last.  The TPU kernel's property is
// kept: each input byte and each history row is read from device memory
// once, by one load a row, and each output is stored once, by 16-byte
// stores.  The last ntap rows stay in registers as f32 (a ring whose slots
// are compile-time indices: the row loop is unrolled by a multiple of
// ntap, which ntap's template value makes possible), the loads of the
// next kRowsAhead rows (rounded up to a multiple of ntap) are issued
// together before any of them is used, and an output is summed and
// stored as soon as the row that closes its window has arrived.  The
// coefficients are read once, before the row loop: where `rep` is a
// multiple of V all V lanes share one column and a thread holds ntap
// scalars, else ntap x V.  Rows that lie in no output's window (decim >
// ntap) are not loaded.  A gulp of more than kFrameCut output frames is
// cut among threads along grid.y; each cut re-reads the ntap - 1 rows in
// front of its first frame.  Eight int8 lanes and eight frames a thread,
// with all of a thread's rows loaded at once, measured fastest (PERF.md
// §6): sixteen lanes or sixteen frames hold more registers a thread and
// leave fewer warps an SM to hide the loads.  Asking ptxas for three
// blocks of 128 threads an SM lets the int8 4-tap kernel use 152
// registers (126 unasked), and it ran 3 % faster with 12 warps an SM
// than with 16.
//
// The scalar kernel (the second route, the first design): one thread per
// (output frame, lane), one 1- or 4-byte load per tap.  It takes what the
// vector kernel cannot prove it can: lanes not a multiple of V, a base of
// x, state or out that is not 16-byte aligned, or ntap above kMaxTap.  The
// wrapper decides the route and counts the vector launches; the launch
// checks the proof again.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // threads a block, both kernels
constexpr int kBlocksPerSM = 3; // vector blocks an SM: ptxas's register cap
constexpr int kLanesInt8 = 8;   // lanes of a row a vector thread owns: int8
constexpr int kLanesF32 = 4;    // ... and f32
constexpr int kRowsAhead = 16;  // rows whose loads a thread issues at once
constexpr int kFrameCut = 8;    // output frames a vector thread walks
constexpr int kMaxTap = 8;      // ntap 1 .. kMaxTap take the vector kernel
constexpr int64_t kMaxGridY = 65535;

// The V lanes a vector thread owns of x's rows, and their bytes as loaded.
template <typename T>
constexpr int kLanes = sizeof(T) == 1 ? kLanesInt8 : kLanesF32;
template <int B> struct Piece;
template <> struct Piece<16> { using type = uint4; };
template <> struct Piece<8> { using type = uint2; };
template <> struct Piece<4> { using type = unsigned int; };

// One input row's piece lifted to V f32 lanes (int8 lanes exactly).
template <int N>
__device__ __forceinline__ void lift_i8(const unsigned int* q,
                                        float (&w)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
        w[i] = (float)(int8_t)(q[i / 4] >> (8 * (i % 4)));
}
template <int N>
__device__ __forceinline__ void lift_f32(const unsigned int* q,
                                         float (&w)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = __uint_as_float(q[i]);
}
__device__ __forceinline__ void lift(const uint4& r, float (&w)[16]) {
    const unsigned int q[4] = {r.x, r.y, r.z, r.w};
    lift_i8<16>(q, w);
}
__device__ __forceinline__ void lift(const uint4& r, float (&w)[4]) {
    const unsigned int q[4] = {r.x, r.y, r.z, r.w};
    lift_f32<4>(q, w);
}
__device__ __forceinline__ void lift(const uint2& r, float (&w)[8]) {
    const unsigned int q[2] = {r.x, r.y};
    lift_i8<8>(q, w);
}
__device__ __forceinline__ void lift(const unsigned int& r, float (&w)[4]) {
    lift_i8<4>(&r, w);
}

// V consecutive f32 lanes (V a multiple of 4) in 16-byte accesses.
template <int V>
__device__ __forceinline__ void load_lanes(const float* p, float (&w)[V]) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
        const float4 s = reinterpret_cast<const float4*>(p)[q];
        w[4 * q] = s.x;
        w[4 * q + 1] = s.y;
        w[4 * q + 2] = s.z;
        w[4 * q + 3] = s.w;
    }
}
template <int V>
__device__ __forceinline__ void store_lanes(float* p, const float (&w)[V]) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
        reinterpret_cast<float4*>(p)[q] = make_float4(
            w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
}

template <typename T, int NTAP, bool SHARED>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
fir_mac_vec_kernel(const T* __restrict__ x, const float* __restrict__ state,
                   const float* __restrict__ coeffs, float* __restrict__ out,
                   int64_t nout, int64_t lanes, int decim, int64_t rep,
                   int64_t ncoef, int64_t jper) {
    constexpr int V = kLanes<T>;
    static_assert(V % 4 == 0, "a thread's lanes are whole 16-byte stores");
    using Raw = typename Piece<V * sizeof(T)>::type;
    constexpr int HIST = NTAP - 1;
    constexpr int U = NTAP * ((kRowsAhead + NTAP - 1) / NTAP);
    constexpr int NC = SHARED ? 1 : V;
    const int64_t vi = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (vi >= lanes / V) return;
    const int64_t lane0 = vi * V;
    const int64_t j0 = (int64_t)blockIdx.y * jper;
    const int64_t j1 = j0 + jper < nout ? j0 + jper : nout;
    if (j0 >= j1) return;

    // Tap k multiplies h[ntap - 1 - k] of the lane's column.
    float c[NTAP][NC];
#pragma unroll
    for (int k = 0; k < NTAP; ++k)
#pragma unroll
        for (int v = 0; v < NC; ++v)
            c[k][v] = coeffs[(int64_t)(HIST - k) * ncoef + (lane0 + v) / rep];

    // xh rows Rs .. Re: the windows of outputs j0 .. j1-1.  A row's ring
    // slot is (R - Rs) % NTAP; Rb - Rs is a multiple of U, hence of NTAP.
    const int64_t Rs = j0 * decim;
    const int64_t Re = (j1 - 1) * decim + HIST;
    const int hmod = HIST % decim;   // phase of the row closing a window
    const bool every = decim <= HIST;   // every row lies in some window
    const T* xp = x + lane0;
    const float* sp = state + lane0;
    float* op = out + j0 * lanes + lane0;
    float win[NTAP][V];
    int ph = 0;   // (R - Rs) % decim, for the R at the top of each step
    for (int64_t Rb = Rs; Rb <= Re; Rb += U) {
        Raw raw[U];
        int p = ph;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int64_t R = Rb + u;
            if (R >= HIST && R <= Re && (every || p <= HIST))
                raw[u] = *reinterpret_cast<const Raw*>(
                    xp + (R - HIST) * lanes);
            p = p + 1 == decim ? 0 : p + 1;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int64_t R = Rb + u;
            if (R > Re) break;
            float (&w)[V] = win[u % NTAP];
            if (R < HIST) {
                load_lanes<V>(sp + R * lanes, w);
            } else if (every || ph <= HIST) {
                lift(raw[u], w);
            }
            if (R - Rs >= HIST && ph == hmod) {
                float acc[V];
#pragma unroll
                for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
                for (int k = 0; k < NTAP; ++k) {
                    const float (&r)[V] = win[(u + 1 + k) % NTAP];
#pragma unroll
                    for (int v = 0; v < V; ++v)
                        acc[v] = __fadd_rn(
                            acc[v], __fmul_rn(r[v], c[k][SHARED ? 0 : v]));
                }
                store_lanes<V>(op, acc);
                op += lanes;
            }
            ph = ph + 1 == decim ? 0 : ph + 1;
        }
    }
}

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

template <typename T, int NTAP>
void launch_vec(const void* x, const float* state, const float* coeffs,
                float* out, int64_t nout, int64_t lanes, int decim,
                int64_t rep, int64_t ncoef, bool shared, cudaStream_t st) {
    constexpr int V = kLanes<T>;
    int64_t jper = (nout + kMaxGridY - 1) / kMaxGridY;
    if (jper < kFrameCut) jper = kFrameCut;
    const dim3 grid((unsigned)((lanes / V + kThreads - 1) / kThreads),
                    (unsigned)((nout + jper - 1) / jper));
    if (shared)
        fir_mac_vec_kernel<T, NTAP, true><<<grid, kThreads, 0, st>>>(
            (const T*)x, state, coeffs, out, nout, lanes, decim, rep, ncoef,
            jper);
    else
        fir_mac_vec_kernel<T, NTAP, false><<<grid, kThreads, 0, st>>>(
            (const T*)x, state, coeffs, out, nout, lanes, decim, rep, ncoef,
            jper);
}

template <typename T>
int launch(const void* x, const float* state, const float* coeffs,
           float* out, long long nout, long long lanes, int ntap, int decim,
           long long rep, long long ncoef, int vec, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (vec) {
        constexpr int V = kLanes<T>;
        const bool shared = rep % V == 0;
        if (lanes % V || ntap > kMaxTap || (uintptr_t)x % 16 ||
            (uintptr_t)out % 16 || (ntap > 1 && (uintptr_t)state % 16))
            return (int)cudaErrorInvalidValue;
        switch (ntap) {
#define FIR_TAP(n)                                                          \
    case n:                                                                 \
        launch_vec<T, n>(x, state, coeffs, out, nout, lanes, decim, rep,    \
                         ncoef, shared, st);                                \
        break;
            FIR_TAP(1) FIR_TAP(2) FIR_TAP(3) FIR_TAP(4)
            FIR_TAP(5) FIR_TAP(6) FIR_TAP(7) FIR_TAP(8)
#undef FIR_TAP
        }
        return (int)cudaGetLastError();
    }
    dim3 grid((unsigned)((lanes + kThreads - 1) / kThreads),
              (unsigned)(nout < kMaxGridY ? nout : kMaxGridY));
    fir_mac_kernel<T><<<grid, kThreads, 0, st>>>(
        (const T*)x, state, coeffs, out, nout, lanes, ntap, decim, rep,
        ncoef);
    return (int)cudaGetLastError();
}

static_assert(kMaxTap == 8, "fir_mac's switch instantiates ntap 1 .. 8");

}  // namespace

extern "C" {

// Launch the MAC on `stream`; returns cudaGetLastError() after the launch
// (0 on success).  x: (nin, lanes) f32 (x_int8 == 0) or int8 (x_int8 != 0),
// nin = (nout - 1) * decim + 1 at least; state: (ntap - 1, lanes) f32, unused
// when ntap == 1; coeffs: (ntap, ncoef) f32 with ncoef * rep == lanes;
// out: (nout, lanes) f32; all contiguous.  vec != 0 takes the vector
// kernel, which needs lanes a multiple of its width V (kLanesInt8 or
// kLanesF32), x, state and out 16-byte aligned and 1 <= ntap <= kMaxTap;
// else it returns cudaErrorInvalidValue and launches nothing.
int fir_mac(const void* x, int x_int8, const float* state,
            const float* coeffs, float* out, long long nout,
            long long lanes, int ntap, int decim, long long rep,
            long long ncoef, int vec, void* stream) {
    if (nout <= 0 || lanes <= 0) return 0;
    if (ntap < 1 || decim < 1 || rep < 1) return (int)cudaErrorInvalidValue;
    if (x_int8)
        return launch<int8_t>(x, state, coeffs, out, nout, lanes, ntap,
                              decim, rep, ncoef, vec, stream);
    return launch<float>(x, state, coeffs, out, nout, lanes, ntap, decim,
                         rep, ncoef, vec, stream);
}

const char* fir_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
