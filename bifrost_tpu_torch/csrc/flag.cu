// The RFI flagger's baseline walk for Hopper (sm_90a): kernel W1.
//
// Replaces no Pallas kernel.  The JAX plan walks its windows on the device
// as one jax.lax.scan of its per-window step (bifrost_tpu/ops/flag.py:
// 257-281, the step at :176-233), outside Pallas; without this kernel the
// port walked them from the host, some 28 small launches a window.  Here
// the carry-free statistics of every window come from one batched torch
// pass (ops/flag.py `_window_stats`), and one launch walks the recurrence:
// a thread per cell carries (center, scale, warm) in registers through the
// windows 0..n-1 in order and writes each window's mask and fill row, then
// the new state.
//
//   'mad': warmed = warm > 0; ref_c = warmed ? c : med; ref_s = warmed ?
//          s : mad; bad = |med - ref_c| > p_thresh * (SIGMA * ref_s + EPS)
//          | mad > p_mad * (ref_s + EPS) | (!warmed & mad > p_mad *
//          (cross + EPS)); on a good window c = ref_c + alpha * (med -
//          ref_c), s likewise with mad, else c = ref_c, s = ref_s.
//   'sk':  ref_c = warmed ? c : mean; bad = |sk - 1| > sk_thresh |
//          (warmed & |mean - ref_c| > p_mad * (ref_c + EPS)); the centre's
//          EMA with mean; s = sk.
//   Both:  warm = min(warm + 1, warm_cap) on a good window; fill = ref_c.
//
// Arithmetic: every product, sum and difference is rounded on its own
// (__fmul_rn, __fadd_rn, __fsub_rn, which nvcc never contracts into an
// FMA) in the plain version's order, every test is written in its
// direction (a > b, so a NaN statistic gives the plain version's mask) and
// the selects keep the sign of zero, so W1 is bitwise equal to its plain
// version (ops/flag_kernel.py flag_walk_plain) on every input.  The
// constants (SIGMA, EPS, the parameters, the SK threshold) come from the
// wrapper as the f32 values the plain version ends up using.
//
// Bound: bytes, 13 a cell and window ('mad': med, mad, mask, fill; 'sk':
// sk, mean, mask, fill) plus 24 a cell for the state, against about 10
// operations.  At the FRB search's 256 windows of 4096 cells only 4096
// threads walk 256 dependent steps, so the walk is latency-bound there:
// each thread loads the statistics of kAhead windows at once (they do not
// depend on the carry), so a chunk costs one memory latency, not kAhead.
// Simple, not tuned.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 8;   // windows whose statistics a thread loads at once

struct Params {
    float p_thresh, p_mad, alpha, sigma, eps, sk_thresh, warm_cap;
};

// A (rows, cells) f32 input addressed by element strides.
struct Rows {
    const float* p;
    int64_t sr, sc;
    __device__ __forceinline__ float at(int64_t i, int64_t c) const {
        return p[i * sr + c * sc];
    }
};

template <bool kMad>
__global__ void flag_walk_kernel(Rows s0, Rows s1, Rows cross, Rows state,
                                 unsigned char* __restrict__ bad,
                                 float* __restrict__ fill,
                                 float* __restrict__ state_out, int64_t nwin,
                                 int64_t ncell, Params p) {
    const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= ncell) return;
    float cb = state.at(0, c), sb = state.at(1, c), warm = state.at(2, c);
    for (int64_t i0 = 0; i0 < nwin; i0 += kAhead) {
        const int64_t left = nwin - i0;
        const int nk = left < kAhead ? (int)left : kAhead;
        float u[kAhead], v[kAhead], x[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
            if (k < nk) {
                u[k] = s0.at(i0 + k, c);
                v[k] = s1.at(i0 + k, c);
                if (kMad) x[k] = cross.at(i0 + k, 0);
            }
        }
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
            if (k >= nk) continue;
            const bool warmed = warm > 0.0f;
            float ref_c, ref_s;
            bool is_bad;
            if (kMad) {
                const float med = u[k], mad = v[k];
                ref_c = warmed ? cb : med;
                ref_s = warmed ? sb : mad;
                const bool cold =
                    mad > __fmul_rn(p.p_mad, __fadd_rn(x[k], p.eps));
                const float tc = __fmul_rn(
                    p.p_thresh, __fadd_rn(__fmul_rn(p.sigma, ref_s), p.eps));
                is_bad = (fabsf(__fsub_rn(med, ref_c)) > tc) |
                         (mad > __fmul_rn(p.p_mad, __fadd_rn(ref_s, p.eps))) |
                         (!warmed & cold);
                if (!is_bad) {
                    cb = __fadd_rn(ref_c,
                                   __fmul_rn(p.alpha, __fsub_rn(med, ref_c)));
                    sb = __fadd_rn(ref_s,
                                   __fmul_rn(p.alpha, __fsub_rn(mad, ref_s)));
                } else {
                    cb = ref_c;
                    sb = ref_s;
                }
            } else {
                const float sk = u[k], mean = v[k];
                ref_c = warmed ? cb : mean;
                is_bad = (fabsf(__fsub_rn(sk, 1.0f)) > p.sk_thresh) |
                         (warmed &
                          (fabsf(__fsub_rn(mean, ref_c)) >
                           __fmul_rn(p.p_mad, __fadd_rn(ref_c, p.eps))));
                cb = is_bad ? ref_c
                            : __fadd_rn(ref_c, __fmul_rn(
                                                   p.alpha,
                                                   __fsub_rn(mean, ref_c)));
                sb = sk;
            }
            if (!is_bad) {
                const float w = __fadd_rn(warm, 1.0f);
                warm = w > p.warm_cap ? p.warm_cap : w;   // NaN stays NaN
            }
            const int64_t o = (i0 + k) * ncell + c;
            bad[o] = is_bad;
            fill[o] = ref_c;
        }
    }
    state_out[c] = cb;
    state_out[ncell + c] = sb;
    state_out[2 * ncell + c] = warm;
}

}  // namespace

extern "C" {

// W1 on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  algo: 0 'mad' (s0 med, s1 mad, cross the (nwin,) cross-cell
// median MAD), 1 'sk' (s0 sk, s1 mean, cross unused).  s0, s1, state:
// f32 with element strides (row, cell) counted in floats; cross: f32 with
// element stride cross_s.  state: (3, ncell) [center, scale, warm] read;
// state_out: a contiguous (3, ncell) f32 written (never the state read);
// bad (uint8) and fill (f32): contiguous (nwin, ncell) written.
int flag_walk(int algo, const float* s0, long long s0_r, long long s0_c,
              const float* s1, long long s1_r, long long s1_c,
              const float* cross, long long cross_s, const float* state,
              long long st_r, long long st_c, unsigned char* bad,
              float* fill, float* state_out, long long nwin, long long ncell,
              float p_thresh, float p_mad, float alpha, float sigma,
              float eps, float sk_thresh, float warm_cap, void* stream) {
    if (nwin <= 0 || ncell <= 0) return 0;
    if ((algo != 0 && algo != 1) || (algo == 0 && !cross))
        return (int)cudaErrorInvalidValue;
    const Params p{p_thresh, p_mad, alpha, sigma, eps, sk_thresh, warm_cap};
    const Rows r0{s0, s0_r, s0_c}, r1{s1, s1_r, s1_c},
        rx{cross, cross_s, 0}, rs{state, st_r, st_c};
    const dim3 grid((unsigned)((ncell + kThreads - 1) / kThreads));
    const cudaStream_t st = (cudaStream_t)stream;
    if (algo == 0)
        flag_walk_kernel<true><<<grid, kThreads, 0, st>>>(
            r0, r1, rx, rs, bad, fill, state_out, nwin, ncell, p);
    else
        flag_walk_kernel<false><<<grid, kThreads, 0, st>>>(
            r0, r1, rx, rs, bad, fill, state_out, nwin, ncell, p);
    return (int)cudaGetLastError();
}

const char* flag_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
