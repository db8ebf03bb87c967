// Romein gridding for Hopper (sm_90a): visibilities scattered onto an
// (ngrid x ngrid) UV plane per leading "pol" plane, as a tiled gather over
// a plan built once on the host.
//
// Replaces the two Pallas TPU gridders of bifrost_tpu/ops/romein_pallas.py:
//   K6a  _gridder_fn      general per-visibility m x m kernels:
//          grid[y+j, x+k] += d * K[j, k]
//   K6b  _gridder_sep_fn  rank-1 kernels K[j, k] = u[j] v[k]:
//          grid[y+j, x+k] += u[j] * (d * v[k])
// The TPU form bins visibilities into 128 x 128 supertiles and places them
// with one-hot matmuls because the TPU has no scatter; none of that is
// carried over.
//
// The order.  The CSR plan (ops/romein.py `build_plan`) lists each cell's
// in-grid contributions in ascending code order, code = vis * m*m + j * m
// + k; a cell takes at most one contribution from a visibility, so that is
// ascending visibility order.  Each (plane, cell) is summed in that order
// into one accumulator that starts at +0.0f, every product and sum rounded
// on its own (__fmul_rn, __fadd_rn, __fsub_rn, never contracted into an
// FMA), then written (+0.0f for an empty cell) or added to the grid as
// g + acc.  The plain PyTorch versions (ops/romein_kernel.py) sum the same
// lists in the same order, so kernel and plain version are bitwise equal
// and reruns are bit-identical.  No atomics.
//
// What bounds it.  The work is a sparse product: a fixed (cells x
// visibilities) matrix, m*m non-zeros a column, times every data plane.
// Its bound counts each visibility read once (8 bytes), but the imaging
// path hands over a time-last ring span (one complex64 every 16 bytes),
// so any read of a visibility costs a 32-byte sector that holds two
// visibilities of two frames, and a tile's visibilities lie scattered
// over the plane.  Such scattered sectors come from device memory far
// below its streaming rate, so the gather alone takes about as long as a
// library SpMM over a plane-contiguous copy of the data.  The walk, 8
// (K6a) or 14 (K6b) f32 instructions per contribution and plane plus the
// entry's decoding and loads, adds its own time, and the two overlap
// only in part (PERF.md times them apart with romein_bounds.py).  A walk
// with one thread per (plane, cell) would re-read the whole plan for every
// plane, gather every visibility once per cell it touches through an
// uncoalesced 8-byte load, and run each warp as long as its longest cell
// list.
//
// The design.  The tiled plan (ops/romein.py `build_tiles`) cuts the grid
// into kTile x kTile tiles; for each tile the distinct visibilities S_T it
// touches, ascending, are cut into chunks of kChunk slots; each (chunk,
// cell) holds the cell's contributions from that chunk (one "item"), and
// a chunk's items are dealt to the block's warps at plan time, heaviest
// first.  One block takes one (tile, group of 32 planes); lane = plane.
// - The plan is read once per group of 32 planes, by broadcast loads:
//   every lane of a warp walks the same item, so no lane diverges.
// - For each chunk the block gathers d[p0..p0+31, S_T[chunk]] into shared
//   memory with cp.async, kStages chunks deep, so that the next chunks'
//   gathers overlap this chunk's arithmetic; the chunk's entries, items
//   and warp table come with it.  Consecutive threads take
//   consecutive slots of one plane, so the gather coalesces along the
//   runs of consecutive visibilities in S_T; each plane's visibilities
//   are read about once (a sixth more, where patches straddle tiles).
// - Accumulators live in shared memory as [cell][plane], one row for each
//   cell of the tile that has contributions (the plan maps the others to
//   none and they are written as +0.0): a cell's items run in chunk
//   order, one warp per item, and blocks sync between chunks.  The fewer
//   rows, the more of the SM's 256 KB is left to L1.
// - The tile is written through shared memory, consecutive threads on
//   consecutive cells of one plane.
// - Kernel taps come from shared memory where they can: a shared kernel's
//   taps as one table, a shared per-visibility kernel's taps staged with
//   each chunk's slots; per-plane kernels are read from device memory.
// - Plane groups run fastest, so the blocks in flight share one tile's
//   plan and taps in L2.
// Rows of the [row][plane] arrays are swizzled (plane p of row r at column
// p ^ (r & 31)) so that a warp reading one row and a warp reading one
// plane of 32 rows both run without bank conflicts; each entry carries
// its slot's swizzled row offset in bytes.  Data and grid are addressed
// by element strides, so a time-last ring span is read and written in
// place; kernel planes stay broadcasts (`kps` the element stride between
// the kernel planes of consecutive data planes, 0 when one serves all;
// `kvis` whether they vary per visibility).
//
// The tiled plan's geometry is the constexprs kTile, kChunk, kEntries and
// kWarps below; ops/romein_kernel.py reads them from this file, so the
// plan and the kernel are cut alike.
//
// Build switches of romein_bounds.py (at the repo root), which serves
// PERF.md's open question on the gridders (how far the gather and the
// walk overlap): the port's build sets none.  ROMEIN_SKIP_GATHER stages
// no data (the walk runs over whatever shared memory holds);
// ROMEIN_SKIP_WALK sums nothing (the chunks are staged, the tiles
// written); ROMEIN_TAPS_GLOBAL reads every kernel tap from device memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;      // cells per tile side
constexpr int kChunk = 32;     // most visibility slots in a chunk
constexpr int kEntries = 288;  // most contributions in a chunk
constexpr int kWarps = 8;      // warps per block
constexpr int kStages = 2;     // chunk buffers
constexpr int kTaps = 64;      // most kernel taps in a shared table
constexpr int kThreads = 32 * kWarps;
constexpr int kCells = kTile * kTile;
constexpr int kRowsPerPass = kThreads / kChunk;
static_assert(kThreads % kChunk == 0, "a gather pass covers whole rows");
static_assert(kChunk <= 256 && kCells <= 65536, "byte offsets, 16-bit cells");

// Where a contribution's kernel taps come from: device memory (per-plane
// kernels, or too many taps to stage); a table of the shared kernel's
// taps in shared memory; or, for a shared per-visibility kernel, each
// chunk's slots' taps staged with the chunk.
enum { kFromGlobal = 0, kFromTable = 1, kFromChunk = 2 };

// One chunk buffer: the data [slot][plane], the chunk's kernel taps
// [slot][tap] (kFromChunk), the slot -> visibility map, the entries, the
// items (at most one per cell) and the warp table.
struct Stage {
    float2 x[kChunk * 32];
    float2 kv[kEntries];
    int vmap[kChunk];
    unsigned tent[kEntries];
    int items[kCells];
    int2 wtab[kWarps + 1];
};
// Shared memory: the chunk ring, the tap table, the tile's cell map
// (local cell -> accumulator row, -1 for a cell without contributions),
// then one accumulator row [32 planes] per cell with contributions, as
// many as the plan's fullest tile has.
constexpr size_t kFixedBytes =
    kStages * sizeof(Stage) + sizeof(float2) * kTaps + sizeof(int) * kCells;

size_t smem_bytes(int max_cells) {
    return kFixedBytes + sizeof(float2) * 32 * (size_t)max_cells;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                       __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

// Plane p of row r of a [row][32] array.
__device__ __forceinline__ int swz(int r, int p) { return r * 32 + (p ^ (r & 31)); }

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(N)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
    const float2* data;
    int64_t ps_in, vs_in;
    int nplane, ngrid, ntx, m, taps, kvis, max_cells;
    const int* tile_chunk0;
    const int* cellmap;
    const int* chunk_vis0;
    const int* svis;
    const int2* wtab;
    const int* items;
    const unsigned* tent;
    const float2* ka;
    const float2* kb;
    int64_t kps;
    float2* out;
    int64_t ps_out, cs_out;
    int accumulate;
};

// Stage chunk g into `st`: the visibilities of planes p0..p0+31, the
// slot -> visibility map, the slots' kernel taps (kFromChunk), and the
// chunk's entries, items and warp table.
template <bool SEP, int KSRC>
__device__ __forceinline__ void gather(const Args& a, int g, int p0,
                                       Stage* st) {
    const int t = threadIdx.x;
    const int v0 = __ldg(a.chunk_vis0 + g);
    const int n = __ldg(a.chunk_vis0 + g + 1) - v0;
    const int s = t % kChunk;
    const int r0 = t / kChunk;
    if (s < n) {
        const int vis = __ldg(a.svis + v0 + s);
        if (r0 == 0) st->vmap[s] = vis;
        const float2* src = a.data + (int64_t)vis * a.vs_in;
#pragma unroll
        for (int i = 0; i < 32 / kRowsPerPass; ++i) {
            const int r = r0 + i * kRowsPerPass;
#ifndef ROMEIN_SKIP_GATHER
            if (p0 + r < a.nplane)
                cp_async<8>(st->x + swz(s, r), src + (int64_t)(p0 + r) * a.ps_in);
#endif
        }
        if (KSRC == kFromChunk) {
            // SEP: u[vis, 0..m) then v[vis, 0..m); else K[vis, 0..m*m).
            for (int i = r0; i < a.taps; i += kRowsPerPass) {
                const float2* k = SEP && i >= a.m
                    ? a.kb + (int64_t)vis * a.m + (i - a.m)
                    : a.ka + (int64_t)vis * (SEP ? a.m : a.taps) + i;
                cp_async<8>(st->kv + s * a.taps + i, k);
            }
        }
    }
    const int2 w0 = __ldg(a.wtab + g * kWarps);
    const int2 w1 = __ldg(a.wtab + (g + 1) * kWarps);
    for (int i = t; i < w1.y - w0.y; i += kThreads)
        cp_async<4>(st->tent + i, a.tent + w0.y + i);
    for (int i = t; i < w1.x - w0.x; i += kThreads)
        cp_async<4>(st->items + i, a.items + w0.x + i);
    if (t <= kWarps) cp_async<8>(st->wtab + t, a.wtab + g * kWarps + t);
}

// SEP == false: ka is the (.., m, m) kernel plane, kb unused.
// SEP == true:  ka is u, kb is v, each (.., m).
template <bool SEP, int KSRC>
__global__ void __launch_bounds__(kThreads, 2) romein_tiled(const Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    Stage* stage = reinterpret_cast<Stage*>(smem);
    float2* ktab = reinterpret_cast<float2*>(smem + kStages * sizeof(Stage));
    int* cmap = reinterpret_cast<int*>(ktab + kTaps);
    float2* acc = reinterpret_cast<float2*>(smem + kFixedBytes);

    // Plane groups run fastest: the blocks in flight share one tile's
    // plan and kernel taps in L2.
    const int ngroup = (a.nplane + 31) / 32;
    const int tile = blockIdx.x / ngroup;
    const int p0 = (blockIdx.x % ngroup) * 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned lane8 = lane << 3;
    const int m = a.m;
    // Lanes past the last plane compute on garbage and write nothing;
    // their kernel plane is the last one.
    const int64_t pk = (int64_t)min(p0 + lane, a.nplane - 1) * a.kps;
    const float2* pa = a.ka + pk;
    const float2* pb = SEP ? a.kb + pk : nullptr;

    for (int i = threadIdx.x; i < a.max_cells * 32; i += kThreads)
        acc[i] = make_float2(0.0f, 0.0f);
    for (int i = threadIdx.x; i < kCells; i += kThreads)
        cmap[i] = __ldg(a.cellmap + (int64_t)tile * kCells + i);
    if (KSRC == kFromTable)
        for (int i = threadIdx.x; i < a.taps; i += kThreads)
            ktab[i] = SEP && i >= m ? a.kb[i - m] : a.ka[i];

    const int g0 = __ldg(a.tile_chunk0 + tile);
    const int g1 = __ldg(a.tile_chunk0 + tile + 1);
    // A ring of kStages chunk buffers: chunk g + kStages - 1 is gathered
    // while chunk g is walked (one cp.async group per chunk, empty past
    // the last), into the buffer that chunk g - 1 left.
    for (int i = 0; i < kStages - 1; ++i) {
        if (g0 + i < g1) gather<SEP, KSRC>(a, g0 + i, p0, stage + i);
        cp_async_commit();
    }
    for (int g = g0; g < g1; ++g) {
        const int gn = g + kStages - 1;
        if (gn < g1)
            gather<SEP, KSRC>(a, gn, p0, stage + (gn - g0) % kStages);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncthreads();
        const Stage& st = stage[(g - g0) % kStages];
        const int2 wb = st.wtab[0];
        const int2 w0 = st.wtab[warp];
        const int i1 = st.wtab[warp + 1].x - wb.x;
        const unsigned* e = st.tent + (w0.y - wb.y);
#ifndef ROMEIN_SKIP_WALK
        for (int it = w0.x - wb.x; it < i1; ++it) {
            const int item = st.items[it];
            const int cell = item & 0xffff, cnt = item >> 16;
            float2* ac = acc + swz(cell, lane);
            float ar = ac->x, ai = ac->y;
#pragma unroll 4
            for (int q = 0; q < cnt; ++q) {
                // The entry's low half is its slot's row offset in
                // st.x, in bytes, swizzled for lane 0.
                const unsigned code = e[q];
                const unsigned off = code & 0xffff;
                const int slot = off >> 8;
                const int j = (code >> 16) & 0xff, k = code >> 24;
                const float2 x = *reinterpret_cast<const float2*>(
                    reinterpret_cast<const char*>(st.x) + (off ^ lane8));
                float2 c;
                if (KSRC == kFromTable) {
                    c = SEP ? cmul(ktab[j], cmul(x, ktab[m + k]))
                            : cmul(x, ktab[j * m + k]);
                } else if (KSRC == kFromChunk) {
                    const float2* kt = st.kv + slot * a.taps;
                    c = SEP ? cmul(kt[j], cmul(x, kt[m + k]))
                            : cmul(x, kt[j * m + k]);
                } else if (SEP) {
                    const int kv = a.kvis ? st.vmap[slot] * m : 0;
                    c = cmul(__ldg(pa + kv + j), cmul(x, __ldg(pb + kv + k)));
                } else {
                    const int kv = a.kvis ? st.vmap[slot] * (m * m) : 0;
                    c = cmul(x, __ldg(pa + kv + j * m + k));
                }
                ar = __fadd_rn(ar, c.x);
                ai = __fadd_rn(ai, c.y);
            }
            e += cnt;
            *ac = make_float2(ar, ai);
        }
#endif
        __syncthreads();
    }
    if (g0 == g1) __syncthreads();

    const int ty = tile / a.ntx, tx = tile - ty * a.ntx;
    for (int i = threadIdx.x; i < kCells * 32; i += kThreads) {
        const int r = i / kCells, lc = i % kCells;
        const int y = ty * kTile + lc / kTile, x = tx * kTile + lc % kTile;
        if (p0 + r >= a.nplane || y >= a.ngrid || x >= a.ngrid) continue;
        const int row = cmap[lc];
        float2 v = row >= 0 ? acc[swz(row, r)] : make_float2(0.0f, 0.0f);
        float2* o = a.out + (int64_t)(p0 + r) * a.ps_out +
                    ((int64_t)y * a.ngrid + x) * a.cs_out;
        if (a.accumulate) {
            const float2 gv = *o;
            v = make_float2(__fadd_rn(gv.x, v.x), __fadd_rn(gv.y, v.y));
        }
        *o = v;
    }
}

template <bool SEP, int KSRC>
const void* kernel_fn() {
    return reinterpret_cast<const void*>(romein_tiled<SEP, KSRC>);
}

const void* kernel_of(int separable, int ksrc) {
    if (separable)
        return ksrc == kFromTable   ? kernel_fn<true, kFromTable>()
               : ksrc == kFromChunk ? kernel_fn<true, kFromChunk>()
                                    : kernel_fn<true, kFromGlobal>();
    return ksrc == kFromTable   ? kernel_fn<false, kFromTable>()
           : ksrc == kFromChunk ? kernel_fn<false, kFromChunk>()
                                : kernel_fn<false, kFromGlobal>();
}

// Where the taps come from for a launch: a shared kernel with at most
// kTaps taps from the table, a shared per-visibility kernel whose chunks'
// taps fit kEntries from the chunk buffers, any other from device memory.
int kernel_source(int kvis, long long kps, int taps, int chunk) {
#ifdef ROMEIN_TAPS_GLOBAL
    return kFromGlobal;
#endif
    if (kps != 0) return kFromGlobal;
    if (!kvis) return taps <= kTaps ? kFromTable : kFromGlobal;
    return chunk * taps <= kEntries ? kFromChunk : kFromGlobal;
}

}  // namespace

extern "C" {

// Registers, spilled bytes per thread, static and dynamic shared memory
// per block and resident blocks per SM of one instantiation (`ksrc`: 0
// taps from device memory, 1 from a shared table, 2 staged with each
// chunk) for a plan whose fullest tile has `max_cells` cells with
// contributions; returns a CUDA error code (0 on success).
int romein_info(int separable, int ksrc, int max_cells, int* regs,
                int* local_bytes, int* smem_static, int* smem_dynamic,
                int* blocks_per_sm) {
    if (max_cells < 0 || max_cells > kCells) return (int)cudaErrorInvalidValue;
    const void* fn = kernel_of(separable, ksrc);
    const size_t smem = smem_bytes(max_cells);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, fn);
    if (err != cudaSuccess) return (int)err;
    *regs = fa.numRegs;
    *local_bytes = (int)fa.localSizeBytes;
    *smem_static = (int)fa.sharedSizeBytes;
    *smem_dynamic = (int)smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fn, kThreads, smem);
}

// Launch on `stream`; returns cudaGetLastError() after the launch (0 on
// success).  data: complex f32 pairs, plane p's visibility v at
// p * ps_in + v * vs_in; the tiled plan's tables (ops/romein.py
// `build_tiles`, cut for kTile and kWarps and for chunks of `chunk` slots
// that hold at most kEntries contributions, with `max_cells` the most
// cells with contributions in a tile, else cudaErrorInvalidValue);
// separable == 0: ka the m x m kernel planes (kb unused); separable != 0:
// ka = u, kb = v; kps: kernel plane stride in complex elements (0 when one
// plane is shared); kvis != 0 when kernels vary per visibility; out: plane p's cell c at p * ps_out + c * cs_out,
// overwritten, or added to when accumulate != 0.  Strides are in complex
// elements.
int romein_grid(const void* data, long long ps_in, long long vs_in,
                long long nplane, const int* tile_chunk0,
                const int* cellmap, const int* chunk_vis0, const int* svis,
                const int* wtab, const int* items, const int* tent,
                int max_cells, int ngrid, int chunk, const void* ka,
                const void* kb, long long kps, int kvis, int m,
                int separable, void* out,
                long long ps_out, long long cs_out, int accumulate,
                void* stream) {
    const int taps = m * m < kCells ? m * m : kCells;
    if (chunk <= 0 || chunk > kChunk || chunk * taps > kEntries || m <= 0 ||
        m >= 256 || max_cells < 0 || max_cells > kCells ||
        nplane > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    if (ngrid <= 0 || nplane <= 0) return 0;
    Args a;
    a.data = (const float2*)data;
    a.ps_in = ps_in;
    a.vs_in = vs_in;
    a.nplane = (int)nplane;
    a.ngrid = ngrid;
    a.ntx = (ngrid + kTile - 1) / kTile;
    a.m = m;
    a.taps = separable ? 2 * m : m * m;
    a.kvis = kvis;
    a.tile_chunk0 = tile_chunk0;
    a.cellmap = cellmap;
    a.max_cells = max_cells;
    a.chunk_vis0 = chunk_vis0;
    a.svis = svis;
    a.wtab = (const int2*)wtab;
    a.items = items;
    a.tent = (const unsigned*)tent;
    a.ka = (const float2*)ka;
    a.kb = (const float2*)kb;
    a.kps = kps;
    a.out = (float2*)out;
    a.ps_out = ps_out;
    a.cs_out = cs_out;
    a.accumulate = accumulate;
    const long long nblk = (long long)a.ntx * a.ntx * ((nplane + 31) / 32);
    if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const void* fn = kernel_of(separable,
                               kernel_source(kvis, kps, a.taps, chunk));
    const size_t smem = smem_bytes(max_cells);
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {&a};
    err = cudaLaunchKernel(fn, dim3((unsigned)nblk), dim3(kThreads), args,
                           smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

const char* romein_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
