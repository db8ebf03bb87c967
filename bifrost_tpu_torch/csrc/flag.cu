// The RFI flagger's window step for Hopper (sm_90a): kernels W1s, W1m and
// W1.
//
// Replace no Pallas kernel.  The JAX plan walks its windows on the device
// as one jax.lax.scan of its per-window step (bifrost_tpu/ops/flag.py:
// 257-281, the step at :176-233), outside Pallas.  The step has a
// carry-free half, each window's statistics, and a carried half, the
// baseline recurrence.  Here the statistics are W1s (and, for 'mad', the
// cross-cell median W1m) and the recurrence is W1.
//
// W1s (flag_stats): the statistics of n windows of m frames.  Two forms,
// chosen by m.
// - The register form (m <= kMaxM): a thread a (window, cell), the
//   window's m samples in registers.  A warp reads 32 neighbouring cells
//   of one frame row at once.
//   'mad': the median of the m samples and the median of |x - med|, each
//          selected in registers: the samples' total-order keys (below)
//          through Batcher's odd-even merge sort of P = the next power of
//          two (padding keys sort last; 63 compare-exchanges for P = 16);
//          the deviations of the sorted samples fall, then rise, so one
//          bitonic merge of P sorts them.  A window of m = P (the
//          flagger's 16) has its middle indices compiled in.
//   'sk':  S1 and S2 summed over the m frames in frame order.
// - The select form (m > kMaxM; the flag block's default of one window a
//   gulp): a block a tile of kSelCells cells of one window (a 32-byte
//   sector of each frame row).
//   'mad': a radix select of the middle one or two keys, four passes of
//          an 8-bit digit (most significant first) with each cell's
//          histograms in shared memory; the two middle ranks share a
//          histogram until their digits part.  The median's select reads
//          the samples' keys, then the MAD's select reads |x - med|'s keys,
//          computed from x and the median on the fly (never written out):
//          eight passes over the window.  A window of at most
//          kSelSmemFrames frames is copied into shared memory once
//          (cp.async) and its eight passes read it there; a longer one is
//          read from device memory (through L2) in each pass, by a grid
//          small enough that the tiles in flight fit in L2.
//   'sk':  S1 and S2 as a tree of fan-out kFan (32): the frames in chunks
//          of 32 (the last one shorter) each summed in frame order, the
//          chunk sums in chunks of 32 summed in chunk order, and so on
//          until one sum remains.  For m <= 32 that is frame order, the
//          register form's.  A thread sums a chunk; a round of the block's
//          kFan chunks a cell is one node of the second level, which one
//          thread a cell carries up the levels above.
// The key of x is its bits as an int32, the lower 31 bits flipped when
// the sign is set (so -0.0 comes before +0.0), and INT_MAX for every NaN
// (last, whatever its sign, as torch.sort places NaNs); a NaN comes back
// as 0x7fffffff.
// Both forms: an even m takes (lo + hi) / 2 of the two middle values, each
// operation rounded on its own; 'sk' then takes SK = ck * (m * S2 / (S1 *
// S1 + EPS) - 1), ck = (m + 1) / (m - 1) as an f32 value, and mean = S1 /
// m.  The plain version (ops/flag_kernel.py flag_stats_plain) sorts the
// same keys and sums in the same tree, so the two are bitwise equal.
// Bound: bytes, 4m in and 8 out a (window, cell); the register form does
// some 14m key operations ('mad' at m = 16: the sort, the merge, the
// deviations), the select form about eight passes of a few.
//
// W1m (flag_cross): the cross-cell median MAD of each window, the median
// of an (n, ncell) row of MADs, as the same radix select of the middle one
// or two keys.  A row of at most kCrossRowCells cells: a block a row,
// copied into shared memory, four 8-bit passes there (one launch).  A
// longer row ([dq]'s 2,097,152 cells): three launches a row, each a grid
// over the row that counts one digit (11, 11, then 10 bits) into a
// histogram in shared memory a block and adds it into the row's histogram
// in device memory; the last block to finish (a counter) selects the
// digit, clears the histogram for the next launch, and in the third
// writes the median.  MADs are non-negative or NaN, so ordering their
// floats (torch.sort, stats.median) and ordering their keys pick the same
// values: the keys of non-negative floats are their bits, which order as
// the floats, and every NaN sorts last in both.  Bound: bytes, 4 ncell in
// and 4 out a row.
//
// W1 (flag_walk): the baseline recurrence over the windows 0..n-1 in
// order for each cell, from the statistics (W1s's, or any (n, ncell)
// rows read through element strides):
//   'mad': warmed = warm > 0; ref_c = warmed ? c : med; ref_s = warmed ?
//          s : mad; bad = |med - ref_c| > p_thresh * (SIGMA * ref_s + EPS)
//          | mad > p_mad * (ref_s + EPS) | (!warmed & cold), cold = mad >
//          p_mad * (cross + EPS); on a good window c = ref_c + alpha *
//          (med - ref_c), s likewise with mad, else c = ref_c, s = ref_s.
//   'sk':  ref_c = warmed ? c : mean; bad = skbad | (warmed & |mean -
//          ref_c| > p_mad * (ref_c + EPS)), skbad = |sk - 1| > sk_thresh;
//          the centre's EMA with mean; s = sk.
//   Both:  warm = min(warm + 1, warm_cap) on a good window; fill = ref_c.
// Two forms, chosen on the host by n:
// - the ring (n > 1): a block walks 32 cells.  Four copier warps stage
//   the statistics of the next kAhead chunks of kChunk windows into a
//   kStages-deep ring in shared memory with cp.async (their source
//   pointers advanced chunk by chunk), compute the carry-free tests
//   (cold, skbad) there, and store the walker's mask and fill rows of the
//   chunk before with 16-byte stores.  The walker warp reads only shared
//   memory: a whole chunk's statistics into registers at once, then its
//   steps unrolled and branch-free, so after the first chunk it never
//   waits on device memory and its chain holds only what depends on the
//   carry.  At the FRB search's 256 windows x 4096 cells, 128 blocks
//   spread the walk over the SMs; the bound there is the chain's latency
//   (chip_smoke.py's latency floor), not the 13 bytes a cell and window.
// - one window (n == 1, the DQ plane's 2,097,152 cells): a thread a cell,
//   or four cells with 16-byte loads and stores where strides and
//   alignment allow; no ring, few registers, full occupancy.  Bound:
//   bytes, 13 a cell plus 24 for the state.
//
// Arithmetic: every product, sum, difference and quotient is rounded on
// its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, which nvcc never
// contracts into an FMA) in the plain version's order, every test is
// written in its direction (a > b, so a NaN statistic gives the plain
// version's mask) and the selects keep the sign of zero, so W1 is bitwise
// equal to its plain walk (ops/flag_kernel.py flag_walk_plain) on every
// input.  The constants (SIGMA, EPS, the parameters, the SK threshold)
// come from the wrapper as the f32 values the plain versions use.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ------------------------------------------------------------------ W1s
constexpr int kMaxM = 32;          // the register form's longest window
constexpr int kStatThreads = 128;
constexpr int kTop = INT_MAX;      // the key of a NaN and of padding

__device__ __forceinline__ int key_of(float x) {
    const int b = __float_as_int(x);
    return isnan(x) ? kTop : b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float val_of(int k) {
    return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// Batcher's odd-even merge sort of P inputs (P a power of two), as a list
// of compare-exchanges (lo, hi): 63 for 16 inputs, 191 for 32.
template <int P>
struct OddEven {
    int n = 0;
    int lo[P * P] = {}, hi[P * P] = {};
    __host__ __device__ constexpr OddEven() {
        for (int p = 1; p < P; p <<= 1)
            for (int k = p; k >= 1; k >>= 1)
                for (int j = k % p; j <= P - 1 - k; j += 2 * k)
                    for (int i = 0; i < k && i < P - j - k; ++i)
                        if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
                            lo[n] = i + j;
                            hi[n] = i + j + k;
                            ++n;
                        }
    }
};

// Sort P keys ascending.
template <int P>
__device__ __forceinline__ void sort_keys(int (&a)[P]) {
    constexpr OddEven<P> net{};
#pragma unroll
    for (int q = 0; q < net.n; ++q) {
        const int x = a[net.lo[q]], y = a[net.hi[q]];
        a[net.lo[q]] = min(x, y);
        a[net.hi[q]] = max(x, y);
    }
}

// Sort a bitonic sequence of P keys (one that falls, then rises) ascending.
template <int P>
__device__ __forceinline__ void bitonic_merge(int (&a)[P]) {
#pragma unroll
    for (int j = P >> 1; j > 0; j >>= 1) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
            const int l = i ^ j;
            if (l > i) {
                const int lo = min(a[i], a[l]), hi = max(a[i], a[l]);
                a[i] = lo;
                a[l] = hi;
            }
        }
    }
}

// The median of the m sorted keys a[0..m): the middle value, or (lo + hi)
// / 2 of the two middle values for an even m.
template <int P>
__device__ __forceinline__ float middle(const int (&a)[P], int m) {
    const int h = m >> 1;
    int lo = a[0], hi = a[0];
#pragma unroll
    for (int j = 0; j < P; ++j) {
        if (j == h) hi = a[j];
        if (j == h - 1) lo = a[j];
    }
    const float v = val_of(hi);
    return (m & 1) ? v : __fdiv_rn(__fadd_rn(val_of(lo), v), 2.0f);
}

// W1s: x(i, j, c) = pw[i * sn + j * sm + c * sc], i < n windows, j < m
// frames, c < ncell cells; out0/out1 contiguous (n, ncell).  kFull: m ==
// P, no padding (the middle indices are then compiled in).
template <bool kMad, int P, bool kFull>
__global__ void __launch_bounds__(kStatThreads)
flag_stats_kernel(const float* __restrict__ pw, int64_t sn, int64_t sm,
                  int64_t sc, int64_t n, int m_, int64_t ncell,
                  float* __restrict__ out0, float* __restrict__ out1,
                  float ck, float eps) {
    const int m = kFull ? P : m_;
    const int64_t c = (int64_t)blockIdx.x * kStatThreads + threadIdx.x;
    if (c >= ncell) return;
    for (int64_t i = blockIdx.y; i < n; i += gridDim.y) {
        const float* p = pw + i * sn + c * sc;
        const int64_t o = i * ncell + c;
        if (kMad) {
            int a[P];
#pragma unroll
            for (int j = 0; j < P; ++j)
                a[j] = j < m ? key_of(__ldg(p + j * sm)) : kTop;
            sort_keys<P>(a);
            const float med = middle<P>(a, m);
            // |x - med| of the sorted samples: its bits are those of x -
            // med with the sign cleared, its key those bits (NaN: kTop).
#pragma unroll
            for (int j = 0; j < P; ++j) {
                const float d = __fsub_rn(val_of(a[j]), med);
                a[j] = j < m && !isnan(d) ? __float_as_int(d) & 0x7fffffff
                                          : kTop;
            }
            bitonic_merge<P>(a);
            out0[o] = med;
            out1[o] = middle<P>(a, m);
        } else {
            float x[P];
#pragma unroll
            for (int j = 0; j < P; ++j)
                x[j] = j < m ? __ldg(p + j * sm) : 0.0f;
            float s1 = x[0], s2 = __fmul_rn(x[0], x[0]);
#pragma unroll
            for (int j = 1; j < P; ++j) {
                if (j < m) {
                    s1 = __fadd_rn(s1, x[j]);
                    s2 = __fadd_rn(s2, __fmul_rn(x[j], x[j]));
                }
            }
            const float mf = (float)m;
            out0[o] = __fmul_rn(
                ck, __fsub_rn(__fdiv_rn(__fmul_rn(mf, s2),
                                        __fadd_rn(__fmul_rn(s1, s1), eps)),
                              1.0f));
            out1[o] = __fdiv_rn(s1, mf);
        }
    }
}

template <bool kMad>
int launch_stats(const float* pw, int64_t sn, int64_t sm, int64_t sc,
                 int64_t n, int m, int64_t ncell, float* out0, float* out1,
                 float ck, float eps, cudaStream_t st) {
    const dim3 grid((unsigned)((ncell + kStatThreads - 1) / kStatThreads),
                    (unsigned)(n < 65535 ? n : 65535));
#define W1S_LAUNCH(P)                                                    \
    if (m == P)                                                          \
        flag_stats_kernel<kMad, P, true><<<grid, kStatThreads, 0, st>>>( \
            pw, sn, sm, sc, n, m, ncell, out0, out1, ck, eps);           \
    else                                                                 \
        flag_stats_kernel<kMad, P, false><<<grid, kStatThreads, 0, st>>>(\
            pw, sn, sm, sc, n, m, ncell, out0, out1, ck, eps)
    if (m <= 2) {
        W1S_LAUNCH(2);
    } else if (m <= 4) {
        W1S_LAUNCH(4);
    } else if (m <= 8) {
        W1S_LAUNCH(8);
    } else if (m <= 16) {
        W1S_LAUNCH(16);
    } else {
        W1S_LAUNCH(kMaxM);
    }
#undef W1S_LAUNCH
    return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- W1
struct Params {
    float p_thresh, p_mad, alpha, sigma, eps, sk_thresh, warm_cap;
};

// One window of one cell: u, v the statistics (med, mad / sk, mean),
// flag the carry-free test (cold / skbad); the carry (cb, sb, warm) in
// place -> is_bad, ref_c.  Branch-free: both outcomes are computed and
// one selected, so a warp whose cells disagree does not diverge.
template <bool kMad>
__device__ __forceinline__ void walk_step(float u, float v, bool flag,
                                          const Params& p, float& cb,
                                          float& sb, float& warm,
                                          bool& is_bad, float& ref_c) {
    const bool warmed = warm > 0.0f;
    if (kMad) {
        const float med = u, mad = v;
        ref_c = warmed ? cb : med;
        const float ref_s = warmed ? sb : mad;
        const float tc = __fmul_rn(
            p.p_thresh, __fadd_rn(__fmul_rn(p.sigma, ref_s), p.eps));
        is_bad = (fabsf(__fsub_rn(med, ref_c)) > tc) |
                 (mad > __fmul_rn(p.p_mad, __fadd_rn(ref_s, p.eps))) |
                 (!warmed & flag);
        const float ec =
            __fadd_rn(ref_c, __fmul_rn(p.alpha, __fsub_rn(med, ref_c)));
        const float es =
            __fadd_rn(ref_s, __fmul_rn(p.alpha, __fsub_rn(mad, ref_s)));
        cb = is_bad ? ref_c : ec;
        sb = is_bad ? ref_s : es;
    } else {
        const float sk = u, mean = v;
        ref_c = warmed ? cb : mean;
        is_bad = flag | (warmed & (fabsf(__fsub_rn(mean, ref_c)) >
                                   __fmul_rn(p.p_mad,
                                             __fadd_rn(ref_c, p.eps))));
        const float ec =
            __fadd_rn(ref_c, __fmul_rn(p.alpha, __fsub_rn(mean, ref_c)));
        cb = is_bad ? ref_c : ec;
        sb = sk;
    }
    const float w = __fadd_rn(warm, 1.0f);
    const float wc = w > p.warm_cap ? p.warm_cap : w;   // NaN stays NaN
    warm = is_bad ? warm : wc;
}

// The carry-free test of one window: 'mad' cold (x the cross-cell median
// MAD), 'sk' skbad.
template <bool kMad>
__device__ __forceinline__ bool carry_free(float u, float v, float x,
                                           const Params& p) {
    return kMad ? v > __fmul_rn(p.p_mad, __fadd_rn(x, p.eps))
                : fabsf(__fsub_rn(u, 1.0f)) > p.sk_thresh;
}

// A (rows, cells) f32 input addressed by element strides.
struct Rows {
    const float* p;
    int64_t sr, sc;
    __device__ __forceinline__ const float* at(int64_t i, int64_t c) const {
        return p + i * sr + c * sc;
    }
};

// --- the ring form
constexpr int kCells = 32;                 // cells a block: one walker warp
constexpr int kChunk = 32;                 // windows a chunk
constexpr int kStages = 4;                 // chunks of statistics staged
constexpr int kAhead = kStages - 1;        // chunks in flight past the walk
constexpr int kCopiers = 4;                // copier warps
constexpr int kCopyThreads = 32 * kCopiers;
constexpr int kRingThreads = 32 + kCopyThreads;

struct Stage {
    float u[kChunk][kCells];
    float v[kChunk][kCells];
    float x[kChunk];
    unsigned char f[kChunk][kCells];
};

struct __align__(16) OutStage {
    float fill[kChunk][kCells];
    unsigned char bad[kChunk][kCells];
};

__device__ __forceinline__ void cp_async4(void* smem, const float* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kAhead - 1 of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait_ahead() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
}

// The copier warps' own barrier (the walker does not take part).
__device__ __forceinline__ void copiers_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kCopyThreads) : "memory");
}

template <bool kMad>
__global__ void __launch_bounds__(kRingThreads)
flag_walk_ring(Rows s0, Rows s1, Rows cross, Rows state,
               unsigned char* __restrict__ bad, float* __restrict__ fill,
               float* __restrict__ state_out, int nwin, int64_t ncell,
               Params p, bool vec_store) {
    __shared__ __align__(16) Stage stage[kStages];
    __shared__ OutStage out[2];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t cell0 = (int64_t)blockIdx.x * kCells;
    const int ncb = (int)(ncell - cell0 < kCells ? ncell - cell0 : kCells);
    const int nchunk = (nwin + kChunk - 1) / kChunk;
    const int t = threadIdx.x - 32;        // copier thread, 0..127

    // Copiers: chunk ch's statistics into its stage (one cp.async group).
    // A copier thread takes the cell t % 32 of the windows t / 32 + 4r;
    // its sources advance by pointer, chunk by chunk.
    const int l = t & 31, kq = t >> 5;
    const float* g0 = s0.at(kq, cell0 + l);
    const float* g1 = s1.at(kq, cell0 + l);
    const float* gx = cross.at(t, 0);
    auto issue = [&](int ch) {
        if (ch < nchunk) {
            Stage& s = stage[ch % kStages];
            const int left = nwin - ch * kChunk;
            if (l < ncb) {
                const float* a = g0;
                const float* b = g1;
                for (int k = kq; k < kChunk && k < left; k += kCopiers) {
                    cp_async4(&s.u[k][l], a);
                    cp_async4(&s.v[k][l], b);
                    a += kCopiers * s0.sr;
                    b += kCopiers * s1.sr;
                }
            }
            if (kMad && t < kChunk && t < left) cp_async4(&s.x[t], gx);
            g0 += kChunk * s0.sr;
            g1 += kChunk * s1.sr;
            gx += kChunk * cross.sr;
        }
        cp_async_commit();
    };
    // Copiers: chunk ch's carry-free tests, once its copies have landed.
    auto tests = [&](int ch) {
        Stage& s = stage[ch % kStages];
        const int left = nwin - ch * kChunk;
        for (int k = kq; k < kChunk && k < left; k += kCopiers)
            s.f[k][l] = carry_free<kMad>(s.u[k][l], s.v[k][l],
                                         kMad ? s.x[k] : 0.0f, p);
    };
    // Copiers: chunk ch's mask and fill rows to device memory.
    auto store = [&](int ch) {
        const OutStage& o = out[ch % 2];
        const int i0 = ch * kChunk;
        const int nk = nwin - i0 < kChunk ? nwin - i0 : kChunk;
        if (vec_store) {
            // a row: 2 16-byte units of mask, 8 of fill
            for (int e = t; e < nk * 10; e += kCopyThreads) {
                const int k = e / 10, part = e % 10;
                const int64_t row = (int64_t)(i0 + k) * ncell + cell0;
                if (part < 2) {
                    if (part * 16 < ncb)
                        *reinterpret_cast<uint4*>(bad + row + part * 16) =
                            *reinterpret_cast<const uint4*>(
                                &o.bad[k][part * 16]);
                } else if ((part - 2) * 4 < ncb) {
                    *reinterpret_cast<float4*>(fill + row + (part - 2) * 4) =
                        *reinterpret_cast<const float4*>(
                            &o.fill[k][(part - 2) * 4]);
                }
            }
        } else {
            for (int e = t; e < nk * kCells; e += kCopyThreads) {
                const int k = e >> 5, l = e & 31;
                if (l < ncb) {
                    const int64_t at = (int64_t)(i0 + k) * ncell + cell0 + l;
                    bad[at] = o.bad[k][l];
                    fill[at] = o.fill[k][l];
                }
            }
        }
    };

    float cb = 0.0f, sb = 0.0f, warm = 0.0f;
    if (warp == 0) {
        if (lane < ncb) {
            cb = *state.at(0, cell0 + lane);
            sb = *state.at(1, cell0 + lane);
            warm = *state.at(2, cell0 + lane);
        }
    } else {
        for (int ch = 0; ch < kAhead; ++ch) issue(ch);
        cp_async_wait_ahead();
        copiers_sync();
        tests(0);
    }
    __syncthreads();
    for (int ch = 0; ch < nchunk; ++ch) {
        if (warp == 0) {
            const Stage& s = stage[ch % kStages];
            OutStage& o = out[ch % 2];
            const int i0 = ch * kChunk;
            const int nk = nwin - i0 < kChunk ? nwin - i0 : kChunk;
            auto step = [&](int k, float u, float v, bool f) {
                bool is_bad;
                float ref_c;
                walk_step<kMad>(u, v, f, p, cb, sb, warm, is_bad, ref_c);
                o.bad[k][lane] = is_bad;
                o.fill[k][lane] = ref_c;
            };
            if (nk == kChunk) {
                // The chunk's statistics into registers first: its stores
                // below would otherwise hold each load back.
                float u[kChunk], v[kChunk];
                bool f[kChunk];
#pragma unroll
                for (int k = 0; k < kChunk; ++k) {
                    u[k] = s.u[k][lane];
                    v[k] = s.v[k][lane];
                    f[k] = s.f[k][lane];
                }
#pragma unroll
                for (int k = 0; k < kChunk; ++k) step(k, u[k], v[k], f[k]);
            } else {
                for (int k = 0; k < nk; ++k)
                    step(k, s.u[k][lane], s.v[k][lane], s.f[k][lane]);
            }
        } else {
            // chunk ch + kAhead into the stage chunk ch - 1 left
            issue(ch + kAhead);
            if (ch >= 1) store(ch - 1);
            cp_async_wait_ahead();
            copiers_sync();
            if (ch + 1 < nchunk) tests(ch + 1);
        }
        __syncthreads();
    }
    if (warp == 0) {
        if (lane < ncb) {
            const int64_t c = cell0 + lane;
            state_out[c] = cb;
            state_out[ncell + c] = sb;
            state_out[2 * ncell + c] = warm;
        }
    } else {
        store(nchunk - 1);
    }
}

// --- the one-window form: V cells a thread (V = 4: 16-byte accesses, the
// cells contiguous and aligned, ncell a multiple of 4).
constexpr int kOneThreads = 256;

template <bool kMad, int V>
__global__ void __launch_bounds__(kOneThreads, 2048 / kOneThreads)
flag_walk_one(Rows s0, Rows s1, Rows cross, Rows state,
              unsigned char* __restrict__ bad, float* __restrict__ fill,
              float* __restrict__ state_out, int64_t ncell, Params p) {
    const int64_t c = ((int64_t)blockIdx.x * kOneThreads + threadIdx.x) * V;
    if (c >= ncell) return;
    float u[V], v[V], cb[V], sb[V], warm[V];
    if (V == 4) {
        auto load4 = [](const float* q) {
            return __ldg(reinterpret_cast<const float4*>(q));
        };
        const float4 a = load4(s0.at(0, c)), b = load4(s1.at(0, c));
        const float4 x = load4(state.at(0, c)), y = load4(state.at(1, c)),
                     z = load4(state.at(2, c));
        u[0] = a.x; u[1] = a.y; u[2] = a.z; u[3] = a.w;
        v[0] = b.x; v[1] = b.y; v[2] = b.z; v[3] = b.w;
        cb[0] = x.x; cb[1] = x.y; cb[2] = x.z; cb[3] = x.w;
        sb[0] = y.x; sb[1] = y.y; sb[2] = y.z; sb[3] = y.w;
        warm[0] = z.x; warm[1] = z.y; warm[2] = z.z; warm[3] = z.w;
    } else {
        u[0] = __ldg(s0.at(0, c));
        v[0] = __ldg(s1.at(0, c));
        cb[0] = __ldg(state.at(0, c));
        sb[0] = __ldg(state.at(1, c));
        warm[0] = __ldg(state.at(2, c));
    }
    const float x = kMad ? __ldg(cross.at(0, 0)) : 0.0f;
    unsigned char b[V];
    float f[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
        bool is_bad;
        walk_step<kMad>(u[q], v[q], carry_free<kMad>(u[q], v[q], x, p), p,
                        cb[q], sb[q], warm[q], is_bad, f[q]);
        b[q] = is_bad;
    }
    if (V == 4) {
        *reinterpret_cast<uchar4*>(bad + c) = make_uchar4(b[0], b[1], b[2],
                                                          b[3]);
        *reinterpret_cast<float4*>(fill + c) = make_float4(f[0], f[1], f[2],
                                                           f[3]);
        *reinterpret_cast<float4*>(state_out + c) =
            make_float4(cb[0], cb[1], cb[2], cb[3]);
        *reinterpret_cast<float4*>(state_out + ncell + c) =
            make_float4(sb[0], sb[1], sb[2], sb[3]);
        *reinterpret_cast<float4*>(state_out + 2 * ncell + c) =
            make_float4(warm[0], warm[1], warm[2], warm[3]);
    } else {
        bad[c] = b[0];
        fill[c] = f[0];
        state_out[c] = cb[0];
        state_out[ncell + c] = sb[0];
        state_out[2 * ncell + c] = warm[0];
    }
}

template <bool kMad>
int launch_walk(int form, Rows r0, Rows r1, Rows rx, Rows rs,
                unsigned char* bad, float* fill, float* state_out,
                int64_t nwin, int64_t ncell, const Params& p,
                cudaStream_t st) {
    if (form == 0) {
        const dim3 grid((unsigned)((ncell + kCells - 1) / kCells));
        const bool vec = ncell % 16 == 0 &&
                         ((uintptr_t)bad | (uintptr_t)fill) % 16 == 0;
        flag_walk_ring<kMad><<<grid, kRingThreads, 0, st>>>(
            r0, r1, rx, rs, bad, fill, state_out, (int)nwin, ncell, p, vec);
    } else {
        const int v = form == 2 ? 4 : 1;
        const int64_t nthr = (ncell + v - 1) / v;
        const dim3 grid((unsigned)((nthr + kOneThreads - 1) / kOneThreads));
        if (v == 4)
            flag_walk_one<kMad, 4><<<grid, kOneThreads, 0, st>>>(
                r0, r1, rx, rs, bad, fill, state_out, ncell, p);
        else
            flag_walk_one<kMad, 1><<<grid, kOneThreads, 0, st>>>(
                r0, r1, rx, rs, bad, fill, state_out, ncell, p);
    }
    return (int)cudaGetLastError();
}

// ------------------------------------------- W1s's select form and W1m
constexpr int kSelCells = 8;          // cells a tile: a 32-byte sector a row
constexpr int kSelSlots = 128;        // 'mad': threads a cell
constexpr int kSelThreads = kSelCells * kSelSlots;
constexpr int kSelSmemFrames = 6144;  // 'mad': windows held in shared memory
constexpr int kFan = 32;              // 'sk': the sum tree's fan-out
constexpr int kSumThreads = kSelCells * kFan;
constexpr int kLevels = 8;            // 'sk': tree levels above the rounds
constexpr int kBins = 256;            // an 8-bit digit a pass
constexpr int kHistStride = 2 * kBins + 1;   // a group's two histograms,
                                             // padded: groups' bins in other banks
constexpr int kCrossThreads = 512;
constexpr int kCrossRowCells = 16384; // W1m: rows held in shared memory
constexpr int kXBins = 2048;          // W1m's long rows: 11-bit digits
constexpr int kGridRows = 65535;      // W1m's long rows: rows a launch

// The selection of the keys of ranks r0 <= r1 (r1 - r0 <= 1) among a
// group's keys, as unsigned (sign bit flipped): the digits chosen so far
// and each rank within the keys that carry its digits.
struct SelGroup {
    unsigned pre[2];
    unsigned rank[2];
    int split;        // the two ranks' digits differ
};

template <int G>
struct SelShared {
    unsigned hist[G][kHistStride];
    SelGroup grp[G];
};

// One warp: the bin of rank r among the NB counts h[0..NB) and r's rank
// within that bin (every lane gets both): a lane sums NB / 32 bins, a
// scan across the lanes finds the lane that holds rank r, and that lane's
// bins are searched the same way (above 256 bins) or walked.  Counts with
// no rank r (a group that holds no keys) give bin 0.
template <int NB>
__device__ __forceinline__ void find_bin(const unsigned* h, unsigned r,
                                         int lane, unsigned& bin,
                                         unsigned& rest) {
    constexpr int kPer = NB / 32;
    const unsigned* q = h + lane * kPer;
    unsigned s = 0;
#pragma unroll 8
    for (int k = 0; k < kPer; ++k) s += q[(k + lane) & (kPer - 1)];
    unsigned incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, incl > r);
    const int at = hit ? __ffs(hit) - 1 : 0;
    if constexpr (kPer > 8) {
        const unsigned excl = __shfl_sync(0xffffffffu, incl - s, at);
        find_bin<kPer>(h + at * kPer, r - excl, lane, bin, rest);
        bin += at * kPer;
    } else {
        unsigned b = 0, left = 0;
        if (lane == at) {
            unsigned acc = incl - s;
            for (int k = 0; k < kPer; ++k) {
                if (r < acc + q[k]) {
                    b = lane * kPer + k;
                    left = r - acc;
                    break;
                }
                acc += q[k];
            }
        }
        bin = __shfl_sync(0xffffffffu, b, at);
        rest = __shfl_sync(0xffffffffu, left, at);
    }
}

// The next digit of a selection from the counts of its keys (h0, and h1
// once the ranks' digits have parted).
__device__ __forceinline__ SelGroup next_digit(const SelGroup& g,
                                               const unsigned* h0,
                                               const unsigned* h1,
                                               int bits, int lane,
                                               bool wide) {
    unsigned b0, b1, n0, n1;
    if (wide) {
        find_bin<kXBins>(h0, g.rank[0], lane, b0, n0);
        find_bin<kXBins>(g.split ? h1 : h0, g.rank[1], lane, b1, n1);
    } else {
        find_bin<kBins>(h0, g.rank[0], lane, b0, n0);
        find_bin<kBins>(g.split ? h1 : h0, g.rank[1], lane, b1, n1);
    }
    return SelGroup{{g.pre[0] << bits | b0, g.pre[1] << bits | b1},
                    {n0, n1}, g.split || b0 != b1};
}

// Count key u into the histograms of a selection whose digits so far are
// p0, p1: `top` u's bits above the digit d (0 in the first pass).
__device__ __forceinline__ void count_key(unsigned* h0, unsigned* h1,
                                          unsigned top, unsigned d,
                                          unsigned p0, unsigned p1,
                                          bool split) {
    if (top == p0)
        atomicAdd(h0 + d, 1u);
    else if (split && top == p1)
        atomicAdd(h1 + d, 1u);
}

// The keys of ranks r0 <= r1 (r1 - r0 <= 1) among each group's `count`
// keys, key(j) the total-order key of the group's element j, which its T
// threads read at j = t, t + T, ...: four passes of an 8-bit digit, most
// significant first.  Every thread of the block calls it; a group that is
// not `live` reads nothing (its result is undefined).  -> lo, hi.
template <int G, int T, class Key>
__device__ __forceinline__ void select2(SelShared<G>& s, int g, int t,
                                        bool live, int64_t count,
                                        unsigned r0, unsigned r1,
                                        const Key& key, int& lo, int& hi) {
    constexpr int kWarps = G * T / 32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();                   // the block's reads of s are done
    if (lane == 0)
        for (int q = warp; q < G; q += kWarps)
            s.grp[q] = SelGroup{{0u, 0u}, {r0, r1}, 0};
    for (int p = 0; p < 4; ++p) {
        for (int e = threadIdx.x; e < G * kHistStride; e += G * T)
            (&s.hist[0][0])[e] = 0u;
        __syncthreads();
        const int shift = 24 - 8 * p;
        if (live) {
            const SelGroup gr = s.grp[g];
            unsigned* h = s.hist[g];
#pragma unroll 4
            for (int64_t j = t; j < count; j += T) {
                const unsigned u = (unsigned)key(j) ^ 0x80000000u;
                count_key(h, h + kBins, p ? u >> (shift + 8) : 0u,
                          (u >> shift) & (kBins - 1), gr.pre[0], gr.pre[1],
                          gr.split);
            }
        }
        __syncthreads();
        for (int q = warp; q < G; q += kWarps) {
            const SelGroup nx = next_digit(s.grp[q], s.hist[q],
                                           s.hist[q] + kBins, 8, lane,
                                           false);
            __syncwarp();
            if (lane == 0) s.grp[q] = nx;
        }
        __syncthreads();
    }
    lo = (int)(s.grp[g].pre[0] ^ 0x80000000u);
    hi = (int)(s.grp[g].pre[1] ^ 0x80000000u);
}

// The median of m values from the keys of its middle ranks.
__device__ __forceinline__ float middle_of(int lo, int hi, int64_t m) {
    const float v = val_of(hi);
    return (m & 1) ? v : __fdiv_rn(__fadd_rn(val_of(lo), v), 2.0f);
}

// The key of |x - med|: its bits (the sign cleared), kTop for a NaN.
__device__ __forceinline__ int dev_key(float x, float med) {
    const float d = __fsub_rn(x, med);
    return isnan(d) ? kTop : __float_as_int(d) & 0x7fffffff;
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// W1s's select form, 'mad': a block a tile of kSelCells cells of one
// window, kSelSlots threads a cell; kSmem: the tile in shared memory
// (frame-major, kSelCells floats a frame).
template <bool kSmem>
__global__ void __launch_bounds__(kSelThreads)
flag_select_mad(const float* __restrict__ pw, int64_t sn, int64_t sm,
                int64_t sc, int64_t n, int64_t m, int64_t ncell,
                float* __restrict__ out0, float* __restrict__ out1) {
    extern __shared__ float xs[];
    __shared__ SelShared<kSelCells> s;
    const int g = threadIdx.x % kSelCells, t = threadIdx.x / kSelCells;
    const int64_t ntc = (ncell + kSelCells - 1) / kSelCells;
    const unsigned r0 = (unsigned)((m - 1) / 2), r1 = (unsigned)(m / 2);
    for (int64_t tile = blockIdx.x; tile < n * ntc; tile += gridDim.x) {
        const int64_t i = tile / ntc, c = tile % ntc * kSelCells + g;
        const bool live = c < ncell;
        const float* p = pw + i * sn + (live ? c : 0) * sc;
        if (kSmem) {
            __syncthreads();           // the last tile's reads of xs are done
            if (live)
                for (int64_t j = t; j < m; j += kSelSlots)
                    cp_async4(&xs[j * kSelCells + g], p + j * sm);
            cp_async_commit();
            cp_async_wait_all();       // select2 syncs the block
        }
        auto x_at = [&](int64_t j) {
            return kSmem ? xs[j * kSelCells + g] : __ldg(p + j * sm);
        };
        int lo, hi;
        select2<kSelCells, kSelSlots>(
            s, g, t, live, m, r0, r1,
            [&](int64_t j) { return key_of(x_at(j)); }, lo, hi);
        const float med = middle_of(lo, hi, m);
        select2<kSelCells, kSelSlots>(
            s, g, t, live, m, r0, r1,
            [&](int64_t j) { return dev_key(x_at(j), med); }, lo, hi);
        if (live && t == 0) {
            out0[i * ncell + c] = med;
            out1[i * ncell + c] = middle_of(lo, hi, m);
        }
    }
}

// W1s's select form, 'sk': a block a tile of kSelCells cells of one
// window, a thread a chunk of kFan frames, a round kFan chunks a cell.
__global__ void __launch_bounds__(kSumThreads)
flag_select_sk(const float* __restrict__ pw, int64_t sn, int64_t sm,
               int64_t sc, int64_t n, int64_t m, int64_t ncell,
               float* __restrict__ out0, float* __restrict__ out1, float ck,
               float eps) {
    __shared__ float part[2][kFan][kSelCells];
    const int g = threadIdx.x % kSelCells, t = threadIdx.x / kSelCells;
    const int64_t ntc = (ncell + kSelCells - 1) / kSelCells;
    const int64_t nchunk = (m + kFan - 1) / kFan;
    const int64_t nround = (nchunk + kFan - 1) / kFan;
    for (int64_t tile = blockIdx.x; tile < n * ntc; tile += gridDim.x) {
        const int64_t i = tile / ntc, c = tile % ntc * kSelCells + g;
        const bool live = c < ncell;
        const float* p = pw + i * sn + (live ? c : 0) * sc;
        // thread t == 0 of a cell: the open node of each level above the
        // rounds, and the total
        float a1[kLevels], a2[kLevels], s1 = 0.0f, s2 = 0.0f;
        for (int64_t r = 0; r < nround; ++r) {
            const int64_t q = r * kFan + t;
            if (live && q < nchunk) {
                const int nf = (int)(m - q * kFan < kFan ? m - q * kFan
                                                         : kFan);
                const float* a = p + q * kFan * sm;
                float x[kFan];
#pragma unroll
                for (int j = 0; j < kFan; ++j)
                    x[j] = j < nf ? __ldg(a + j * sm) : 0.0f;
                float c1 = x[0], c2 = __fmul_rn(x[0], x[0]);
#pragma unroll
                for (int j = 1; j < kFan; ++j) {
                    if (j < nf) {
                        c1 = __fadd_rn(c1, x[j]);
                        c2 = __fadd_rn(c2, __fmul_rn(x[j], x[j]));
                    }
                }
                part[0][t][g] = c1;
                part[1][t][g] = c2;
            }
            __syncthreads();
            if (live && t == 0) {
                const int nq = (int)(nchunk - r * kFan < kFan
                                     ? nchunk - r * kFan : kFan);
                float v1 = part[0][0][g], v2 = part[1][0][g];
                for (int k = 1; k < nq; ++k) {
                    v1 = __fadd_rn(v1, part[0][k][g]);
                    v2 = __fadd_rn(v2, part[1][k][g]);
                }
                // round r, complete: up the levels while it closes a node
                int64_t idx = r, cnt = nround;
                int lv = 0;
                while (cnt > 1) {
                    if (idx % kFan == 0) {
                        a1[lv] = v1;
                        a2[lv] = v2;
                    } else {
                        a1[lv] = __fadd_rn(a1[lv], v1);
                        a2[lv] = __fadd_rn(a2[lv], v2);
                    }
                    if (idx % kFan != kFan - 1 && idx != cnt - 1) break;
                    v1 = a1[lv];
                    v2 = a2[lv];
                    idx /= kFan;
                    cnt = (cnt + kFan - 1) / kFan;
                    ++lv;
                }
                if (cnt == 1) {
                    s1 = v1;
                    s2 = v2;
                }
            }
            __syncthreads();
        }
        if (live && t == 0) {
            const float mf = (float)m;
            out0[i * ncell + c] = __fmul_rn(
                ck, __fsub_rn(__fdiv_rn(__fmul_rn(mf, s2),
                                        __fadd_rn(__fmul_rn(s1, s1), eps)),
                              1.0f));
            out1[i * ncell + c] = __fdiv_rn(s1, mf);
        }
    }
}

int sm_count() {
    int dev = 0, nsm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    return nsm > 0 ? nsm : 1;
}

// Raise a kernel's dynamic shared memory limit once a device.
template <class F>
cudaError_t allow_smem(F* kernel, int bytes, bool (&done)[64]) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
    return e;
}

bool g_sel_smem[64], g_cross_smem[64];

int launch_select(bool mad, const float* pw, int64_t sn, int64_t sm,
                  int64_t sc, int64_t n, int64_t m, int64_t ncell,
                  float* out0, float* out1, float ck, float eps,
                  cudaStream_t st) {
    const int64_t tiles = n * ((ncell + kSelCells - 1) / kSelCells);
    if (!mad) {
        const unsigned grid = (unsigned)(tiles < INT_MAX ? tiles : INT_MAX);
        flag_select_sk<<<grid, kSumThreads, 0, st>>>(
            pw, sn, sm, sc, n, m, ncell, out0, out1, ck, eps);
    } else if (m <= kSelSmemFrames) {
        const int bytes = (int)(m * kSelCells * sizeof(float));
        const cudaError_t e = allow_smem(
            flag_select_mad<true>, kSelSmemFrames * kSelCells * 4,
            g_sel_smem);
        if (e != cudaSuccess) return (int)e;
        const unsigned grid = (unsigned)(tiles < INT_MAX ? tiles : INT_MAX);
        flag_select_mad<true><<<grid, kSelThreads, bytes, st>>>(
            pw, sn, sm, sc, n, m, ncell, out0, out1);
    } else {
        // as many tiles in flight as fit in some 24 MiB of L2, at least
        // a block an SM
        const int64_t tile_bytes = m * kSelCells * 4;
        int64_t grid = ((int64_t)24 << 20) / tile_bytes;
        const int64_t nsm = sm_count();
        grid = grid < nsm ? nsm : grid > 2 * nsm ? 2 * nsm : grid;
        grid = grid < tiles ? grid : tiles;
        flag_select_mad<false><<<(unsigned)grid, kSelThreads, 0, st>>>(
            pw, sn, sm, sc, n, m, ncell, out0, out1);
    }
    return (int)cudaGetLastError();
}

// W1m, a row a block: rows of at most kCrossRowCells cells.
__global__ void __launch_bounds__(kCrossThreads)
flag_cross_row(const float* __restrict__ mad, int64_t sr, int64_t sc,
               int64_t n, int64_t ncell, float* __restrict__ out) {
    extern __shared__ float xs[];
    __shared__ SelShared<1> s;
    const unsigned r0 = (unsigned)((ncell - 1) / 2),
                   r1 = (unsigned)(ncell / 2);
    for (int64_t i = blockIdx.x; i < n; i += gridDim.x) {
        __syncthreads();               // the last row's reads of xs are done
        const float* p = mad + i * sr;
        for (int64_t j = threadIdx.x; j < ncell; j += kCrossThreads)
            cp_async4(&xs[j], p + j * sc);
        cp_async_commit();
        cp_async_wait_all();
        int lo, hi;
        select2<1, kCrossThreads>(
            s, 0, threadIdx.x, true, ncell, r0, r1,
            [&](int64_t j) { return key_of(xs[j]); }, lo, hi);
        if (threadIdx.x == 0) out[i] = middle_of(lo, hi, ncell);
    }
}

// W1m's long rows: a row's histograms of one digit and its selection,
// in device memory (zeroed before the first pass).
struct CrossScratch {
    unsigned hist[2][kXBins];
    SelGroup sel;
    unsigned done;
};

// Pass p (0, 1, 2: bits 31-21, 20-10, 9-0) of W1m over rows row0 +
// blockIdx.y, the blocks of a row a grid over its cells.
__global__ void __launch_bounds__(kCrossThreads)
flag_cross_pass(const float* __restrict__ mad, int64_t sr, int64_t sc,
                int64_t row0, int64_t ncell, float* __restrict__ out,
                CrossScratch* __restrict__ scratch, int p) {
    __shared__ unsigned h[2 * kXBins];
    __shared__ SelGroup sel;
    __shared__ int last;
    const int64_t i = row0 + blockIdx.y;
    CrossScratch& x = scratch[i];
    const int shift = p == 0 ? 21 : p == 1 ? 10 : 0;
    const int bits = p == 2 ? 10 : 11;
    if (threadIdx.x == 0)
        sel = p ? x.sel
                : SelGroup{{0u, 0u},
                           {(unsigned)((ncell - 1) / 2),
                            (unsigned)(ncell / 2)},
                           0};
    __syncthreads();
    const SelGroup gr = sel;
    // the second histogram only once the ranks' digits have parted
    const int nh = gr.split ? 2 * kXBins : kXBins;
    for (int e = threadIdx.x; e < nh; e += kCrossThreads) h[e] = 0u;
    __syncthreads();
    const float* row = mad + i * sr;
    for (int64_t j = (int64_t)blockIdx.x * kCrossThreads + threadIdx.x;
         j < ncell; j += (int64_t)gridDim.x * kCrossThreads) {
        const unsigned u = (unsigned)key_of(__ldg(row + j * sc)) ^
                           0x80000000u;
        count_key(h, h + kXBins, p ? u >> (shift + bits) : 0u,
                  (u >> shift) & ((1u << bits) - 1), gr.pre[0], gr.pre[1],
                  gr.split);
    }
    __syncthreads();
    unsigned* gh = &x.hist[0][0];
    for (int e = threadIdx.x; e < nh; e += kCrossThreads)
        if (h[e]) atomicAdd(gh + e, h[e]);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&x.done, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    // The last block of the row: the row's counts, then cleared for the
    // next pass.
    __threadfence();
    for (int e = threadIdx.x; e < nh; e += kCrossThreads) {
        h[e] = __ldcg(gh + e);
        gh[e] = 0u;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
        const SelGroup nx = next_digit(gr, h, h + kXBins, bits,
                                       threadIdx.x, true);
        if (threadIdx.x == 0) {
            if (p < 2)
                x.sel = nx;
            else
                out[i] = middle_of((int)(nx.pre[0] ^ 0x80000000u),
                                   (int)(nx.pre[1] ^ 0x80000000u), ncell);
            x.done = 0u;
        }
    }
}

int launch_cross(int form, const float* mad, int64_t sr, int64_t sc,
                 int64_t n, int64_t ncell, float* out, void* scratch,
                 cudaStream_t st) {
    if (form == 0) {
        const int bytes = (int)(ncell * sizeof(float));
        const cudaError_t e = allow_smem(
            flag_cross_row, kCrossRowCells * 4, g_cross_smem);
        if (e != cudaSuccess) return (int)e;
        flag_cross_row<<<(unsigned)(n < INT_MAX ? n : INT_MAX),
                         kCrossThreads, bytes, st>>>(mad, sr, sc, n, ncell,
                                                     out);
        return (int)cudaGetLastError();
    }
    cudaError_t e = cudaMemsetAsync(scratch, 0, n * sizeof(CrossScratch),
                                    st);
    if (e != cudaSuccess) return (int)e;
    int64_t gx = (ncell + kCrossThreads * 8 - 1) / (kCrossThreads * 8);
    const int64_t cap = 4 * (int64_t)sm_count();
    gx = gx < cap ? gx : cap;
    for (int64_t row0 = 0; row0 < n; row0 += kGridRows) {
        const int64_t nr = n - row0 < kGridRows ? n - row0 : kGridRows;
        for (int p = 0; p < 3; ++p) {
            flag_cross_pass<<<dim3((unsigned)gx, (unsigned)nr),
                              kCrossThreads, 0, st>>>(
                mad, sr, sc, row0, ncell, out,
                (CrossScratch*)scratch, p);
            e = cudaGetLastError();
            if (e != cudaSuccess) return (int)e;
        }
    }
    return 0;
}

}  // namespace

extern "C" {

// W1s on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  algo: 0 'mad' (out0 med, out1 mad), 1 'sk' (out0 sk, out1
// mean; ck = (m + 1) / (m - 1) as f32).  pw: f32 (n, m, ncell) with
// element strides (sn, sm, sc); out0, out1: contiguous (n, ncell) f32.
// The register form for m <= kMaxM, the select form above.
int flag_stats(int algo, const float* pw, long long sn, long long sm,
               long long sc, long long n, long long m, long long ncell,
               float* out0, float* out1, float ck, float eps, void* stream) {
    if (n <= 0 || ncell <= 0) return 0;
    if ((algo != 0 && algo != 1) || m < 1 || m > INT_MAX ||
        (algo == 1 && m < 2))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    if (m > kMaxM)
        return launch_select(algo == 0, pw, sn, sm, sc, n, m, ncell, out0,
                             out1, ck, eps, st);
    return algo == 0
               ? launch_stats<true>(pw, sn, sm, sc, n, (int)m, ncell, out0,
                                    out1, ck, eps, st)
               : launch_stats<false>(pw, sn, sm, sc, n, (int)m, ncell, out0,
                                     out1, ck, eps, st);
}

// W1m on `stream`; returns cudaGetLastError() after its launches (0 on
// success).  mad: f32 (n, ncell) with element strides (sr, sc); out: a
// contiguous (n,) f32.  form: 0 a block a row (ncell <= kCrossRowCells;
// one launch), 1 a grid a row (three launches for each kGridRows rows,
// `scratch` n * flag_cross_scratch_bytes() bytes of device memory,
// zeroed here on the stream).
int flag_cross(int form, const float* mad, long long sr, long long sc,
               long long n, long long ncell, float* out, void* scratch,
               void* stream) {
    if (n <= 0) return 0;
    if (ncell < 1 || ncell > INT_MAX || form < 0 || form > 1 ||
        (form == 0 && ncell > kCrossRowCells) || (form == 1 && !scratch))
        return (int)cudaErrorInvalidValue;
    return launch_cross(form, mad, sr, sc, n, ncell, out, scratch,
                        (cudaStream_t)stream);
}

long long flag_cross_scratch_bytes() { return sizeof(CrossScratch); }

// W1 on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  algo: 0 'mad' (s0 med, s1 mad, cross the (nwin,) cross-cell
// median MAD), 1 'sk' (s0 sk, s1 mean, cross unused).  form: 0 the ring
// (nwin > 1), 1 one window a thread a cell, 2 one window four cells a
// thread (s0, s1 and state cell stride 1, 16-byte aligned rows, ncell a
// multiple of 4).  s0, s1, state: f32 with element strides (row, cell)
// counted in floats; cross: f32 with element stride cross_s.  state: (3,
// ncell) [center, scale, warm] read; state_out: a contiguous (3, ncell)
// f32 written (never the state read); bad (uint8) and fill (f32):
// contiguous (nwin, ncell) written.
int flag_walk(int algo, int form, const float* s0, long long s0_r,
              long long s0_c, const float* s1, long long s1_r,
              long long s1_c, const float* cross, long long cross_s,
              const float* state, long long st_r, long long st_c,
              unsigned char* bad, float* fill, float* state_out,
              long long nwin, long long ncell, float p_thresh, float p_mad,
              float alpha, float sigma, float eps, float sk_thresh,
              float warm_cap, void* stream) {
    if (nwin <= 0 || ncell <= 0) return 0;
    if ((algo != 0 && algo != 1) || (algo == 0 && !cross) || form < 0 ||
        form > 2 || (form == 0) != (nwin > 1) || nwin > INT_MAX)
        return (int)cudaErrorInvalidValue;
    const Params p{p_thresh, p_mad, alpha, sigma, eps, sk_thresh, warm_cap};
    const Rows r0{s0, s0_r, s0_c}, r1{s1, s1_r, s1_c},
        rx{cross, cross_s, 0}, rs{state, st_r, st_c};
    const cudaStream_t st = (cudaStream_t)stream;
    return algo == 0 ? launch_walk<true>(form, r0, r1, rx, rs, bad, fill,
                                         state_out, nwin, ncell, p, st)
                     : launch_walk<false>(form, r0, r1, rx, rs, bad, fill,
                                          state_out, nwin, ncell, p, st);
}

const char* flag_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
