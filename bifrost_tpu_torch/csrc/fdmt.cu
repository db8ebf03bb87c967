// FDMT merge step for Hopper (sm_90a).
//
// Replaces bifrost_tpu/ops/fdmt_pallas.py::_shift_add_fn, the Pallas TPU
// shift-accumulate kernel, together with the row gathers around it in the
// JAX scan body (bifrost_tpu/ops/fdmt.py:418-431): one pass computes, for
// every slice b of a batch (the JAX package's vmap over beams),
//
//   out[b, r, t] = state[b, rowA[r], t]
//                + ((rowB[r] >= 0 && t >= d[r]) ? state[b, rowB[r], t - d[r]]
//                                               : 0.0f)
//
// A row with no partner still adds +0.0f, as the JAX scan body does, so
// -0.0 inputs come out +0.0 and the result is bitwise the plain version's
// on every input.  The kernel reads one state buffer and writes the other
// (ping-pong), because rows read other rows.  Element offsets are 64-bit.
//
// Bound: HBM bytes.  Each output element costs one add against two 4-byte
// loads and one 4-byte store, far below the card's ratio of operations to
// bytes; the bound counts each distinct input row once.  Design:
// - One launch per merge step covers the whole batch: a thread owns four
//   consecutive samples t .. t+3 of one slice and walks a group of
//   kGroupRows consecutive output rows (threads of a warp walk t, so every
//   access of a warp is coalesced).  Consecutive output rows of the plan
//   share their input rows (from one row to the next either rowA stays
//   and the delay grows by one, or rowB stays), so the kernel requests
//   some 1.8 times the distinct row data; which cache level serves the
//   repeats is not measured.  Two ways of skipping them measured slower
//   (PERF.md §6): keeping the last rows in registers (the loads then
//   depend on comparisons and no longer issue together), and staging a
//   group of rows' distinct input rows in shared memory with cp.async
//   (a block's copies wait before its stores, and the more rows a group
//   shares, the fewer blocks fit; kernel_variants.py keeps that design).
// - Where every row starts 16-byte aligned (ntime a multiple of 4, the
//   bases and batch strides too: the FRB search), samples move as 16-byte
//   loads and stores, and the delayed samples are cut in registers from
//   the aligned pieces around t - d (one piece where t - d is aligned).
//   Elsewhere (the beam search's 65-sample rows) the same walk moves one
//   element at a time.
// The Pallas kernel's 8-row blocks and left padding exist only for Mosaic
// and are dropped.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // threads a block
constexpr int kGroupRows = 4;   // consecutive output rows a thread walks

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

// The aligned piece [base, base + 4) of a row, zeros left of sample 0 and
// at or past the row's end (a piece is either wholly inside or outside).
__device__ __forceinline__ float4 piece(const float* row, int64_t base,
                                        int64_t ntime) {
    return base >= 0 && base < ntime ? load4(row + base)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Samples off .. off+3 of the 8 samples in (q0, q1).
__device__ __forceinline__ float4 cut(const float4& q0, const float4& q1,
                                      int off) {
    switch (off) {
        case 0: return q0;
        case 1: return make_float4(q0.y, q0.z, q0.w, q1.x);
        case 2: return make_float4(q0.z, q0.w, q1.x, q1.y);
        default: return make_float4(q0.w, q1.x, q1.y, q1.z);
    }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
fdmt_merge_step_kernel(const float* __restrict__ state,
                       float* __restrict__ out,
                       const int* __restrict__ rowA,
                       const int* __restrict__ rowB,
                       const int* __restrict__ delay, int64_t batch,
                       int64_t nrows, int64_t ntime, int64_t sbs,
                       int64_t obs) {
    const int64_t nchunk = (ntime + 3) / 4;
    const int64_t ngroup = (nrows + kGroupRows - 1) / kGroupRows;
    const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (i >= batch * ngroup * nchunk) return;
    const int64_t t = 4 * (i % nchunk);
    const int64_t g = i / nchunk % ngroup;
    const int64_t b = i / (nchunk * ngroup);
    const float* sb = state + b * sbs;
    float* ob = out + b * obs;
    const int64_t r0 = g * kGroupRows;
#pragma unroll
    for (int k = 0; k < kGroupRows; ++k) {
        const int64_t r = r0 + k;
        if (r >= nrows) break;
        const int ra = rowA[r], rb = rowB[r];
        const int64_t d = delay[r];
        if (VEC) {
            const float4 a = load4(sb + (int64_t)ra * ntime + t);
            float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
            if (rb >= 0) {
                // Samples t-d .. t-d+3 from the aligned pieces around
                // them; the shift is the same for the whole row.
                const int64_t s = t - d;
                const int off = (int)(s & 3);
                const float* row = sb + (int64_t)rb * ntime;
                const float4 q0 = piece(row, s - off, ntime);
                const float4 q1 = off ? piece(row, s - off + 4, ntime) : q0;
                bv = cut(q0, q1, off);
            }
            *reinterpret_cast<float4*>(ob + r * ntime + t) = make_float4(
                __fadd_rn(a.x, bv.x), __fadd_rn(a.y, bv.y),
                __fadd_rn(a.z, bv.z), __fadd_rn(a.w, bv.w));
        } else {
            const float* pa = sb + (int64_t)ra * ntime;
            const float* pb = sb + (int64_t)rb * ntime;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int64_t tj = t + j;
                if (tj >= ntime) break;
                float bj = 0.0f;
                if (rb >= 0 && tj >= d) bj = pb[tj - d];
                ob[r * ntime + tj] = __fadd_rn(pa[tj], bj);
            }
        }
    }
}

}  // namespace

extern "C" {

// Launch one merge step on `stream` for `batch` slices; returns
// cudaGetLastError() after the launch (0 on success).  state: slices of
// (>= every table row + 1, ntime) f32, each contiguous, `sbs` elements
// apart; out: slices of (nrows, ntime) f32, each contiguous, `obs` elements
// apart, a different buffer; tables: (nrows,) int32, delays >= 0.
int fdmt_merge_step(const float* state, float* out, const int* rowA,
                    const int* rowB, const int* delay, long long batch,
                    long long nrows, long long ntime, long long sbs,
                    long long obs, void* stream) {
    if (batch <= 0 || nrows <= 0 || ntime <= 0) return 0;
    const bool vec = ntime % 4 == 0 && sbs % 4 == 0 && obs % 4 == 0 &&
                     (uintptr_t)state % 16 == 0 && (uintptr_t)out % 16 == 0;
    const int64_t n = batch * ((nrows + kGroupRows - 1) / kGroupRows) *
                      ((ntime + 3) / 4);
    const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
    const cudaStream_t st = (cudaStream_t)stream;
    if (vec)
        fdmt_merge_step_kernel<true><<<grid, kThreads, 0, st>>>(
            state, out, rowA, rowB, delay, batch, nrows, ntime, sbs, obs);
    else
        fdmt_merge_step_kernel<false><<<grid, kThreads, 0, st>>>(
            state, out, rowA, rowB, delay, batch, nrows, ntime, sbs, obs);
    return (int)cudaGetLastError();
}

const char* fdmt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
