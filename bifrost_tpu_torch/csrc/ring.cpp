// The port's ring engine (the port's copy of the JAX package's
// cpp/src/ring.cpp, with what it needs of common.cpp, internal.hpp and
// proclog.cpp; reference: src/ring_impl.cpp, src/bifrost/ring.h):
// monotonic uint64 offsets, a ghost region mirroring the head of each
// row so every span is one contiguous run, named and time-tagged
// sequences, guaranteed readers that hold the writer back, a resize that
// drains open spans, overwrite accounting for readers without a
// guarantee, in-order commits with a shrink of the final span, and one
// condition variable broadcast at every change.
//
// What differs from the JAX engine:
//  - BTP_SPACE_CUDA rings keep the offsets only (the JAX engine's
//    BT_SPACE_TPU): ring.py owns the device bytes and their ghost.  A
//    resize may `hold` such a ring closed to reserves and acquires until
//    ring.py has re-laid its bytes (btpRingResizeDone).
//  - A resize rounds the sizes up to the caller's element alignment, as
//    the port's rings always have, and hands the old host buffer to the
//    caller (btpRingTakeRetired) instead of freeing it: views of it may
//    outlive the resize.
//  - A reader's wait may return BTP_STATUS_PROGRESS at a commit that does
//    not end it, so that ring.py can stamp the reader's heartbeat (a
//    wait inside the engine cannot call Python).
//  - The geometry log is a file whose path ring.py names (its ProcLog,
//    under a name unique among the process's rings); the engine rewrites
//    it through a temporary file and a rename, as proclog.py does.

#include "ring_host.h"

#include <algorithm>
#include <cctype>
#include <condition_variable>
#include <cstdarg>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <deque>
#include <limits>
#include <memory>
#include <mutex>
#include <new>
#include <set>
#include <stdexcept>
#include <string>
#include <vector>

#include <dirent.h>
#include <pthread.h>
#include <sys/syscall.h>
#include <unistd.h>

namespace btpr {

thread_local std::string g_last_error;

void set_last_error(const char* fmt, ...) {
    char buf[1024];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(buf, sizeof(buf), fmt, ap);
    va_end(ap);
    g_last_error = buf;
}

}  // namespace btpr

#define BTPR_TRY_BEGIN try {
#define BTPR_TRY_END                                                   \
    }                                                                  \
    catch (const std::bad_alloc&) {                                    \
        btpr::set_last_error("out of memory in %s", __func__);         \
        return BTP_STATUS_MEM_ALLOC_FAILED;                            \
    }                                                                  \
    catch (const std::exception& e) {                                  \
        btpr::set_last_error("%s: %s", __func__, e.what());            \
        return BTP_STATUS_INTERNAL_ERROR;                              \
    }                                                                  \
    catch (...) {                                                      \
        btpr::set_last_error("unknown exception in %s", __func__);     \
        return BTP_STATUS_INTERNAL_ERROR;                              \
    }

#define BTPR_CHECK_PTR(p)                                              \
    do {                                                               \
        if ((p) == nullptr) {                                          \
            btpr::set_last_error("null pointer argument in %s", __func__); \
            return BTP_STATUS_INVALID_POINTER;                         \
        }                                                              \
    } while (0)

namespace {

constexpr uint64_t kNoEnd = std::numeric_limits<uint64_t>::max();

// Best-effort NUMA placement of a ring buffer near its bound core
// (reference ring_impl.cpp:165-172 binds ring memory to the ring's NUMA
// node): the raw mbind syscall with MPOL_PREFERRED, so no libnuma is
// needed, and a failure (one node, no CAP_SYS_NICE, no sysfs) leaves the
// default placement.  Only the page-aligned interior is bound.
void numa_bind_best_effort(void* addr, size_t len, int core) {
#ifdef SYS_mbind
    if (core < 0 || addr == nullptr || len == 0) return;
    char path[96];
    snprintf(path, sizeof(path), "/sys/devices/system/cpu/cpu%d", core);
    DIR* d = opendir(path);
    if (!d) return;
    int node = -1;
    while (struct dirent* e = readdir(d)) {
        if (strncmp(e->d_name, "node", 4) == 0 &&
            isdigit((unsigned char)e->d_name[4])) {
            node = atoi(e->d_name + 4);
            break;
        }
    }
    closedir(d);
    if (node < 0 || node >= 64) return;
    long page = sysconf(_SC_PAGESIZE);
    uintptr_t lo = ((uintptr_t)addr + page - 1) & ~(uintptr_t)(page - 1);
    uintptr_t hi = ((uintptr_t)addr + len) & ~(uintptr_t)(page - 1);
    if (hi <= lo) return;
    unsigned long mask = 1ul << node;
    constexpr int kMpolPreferred = 1;
    syscall(SYS_mbind, (void*)lo, (unsigned long)(hi - lo), kMpolPreferred,
            &mask, 64ul, 0ul);
#else
    (void)addr; (void)len; (void)core;
#endif
}

// Page-aligned host bytes (the pinned registration of a 'cuda_host'
// ring wants whole pages).
char* alloc_pages(uint64_t n) {
    long page = sysconf(_SC_PAGESIZE);
    uint64_t len = (n + page - 1) / page * page;
    void* p = nullptr;
    if (len == 0 || posix_memalign(&p, (size_t)page, len) != 0)
        return nullptr;
    return static_cast<char*>(p);
}

// Rewrite a log file whole through a temporary file and a rename, so a
// reader never sees a torn write (proclog.py ProcLog.update).  A log is
// observability only: a failure is ignored.
void write_log(const std::string& path, const char* text) {
    char tmp[4200];
    snprintf(tmp, sizeof(tmp), "%s.%lu.tmp", path.c_str(),
             (unsigned long)pthread_self());
    FILE* f = fopen(tmp, "w");
    if (!f) return;
    fputs(text, f);
    fclose(f);
    rename(tmp, path.c_str());
}

uint64_t round_up(uint64_t n, uint64_t m) {
    return m > 1 ? (n + m - 1) / m * m : n;
}

struct Sequence {
    uint64_t    id;
    std::string name;
    uint64_t    time_tag;
    std::vector<char> header;
    uint64_t    nringlet;
    uint64_t    begin;
    uint64_t    end = kNoEnd;  // kNoEnd while open
    bool finished() const { return end != kNoEnd; }
};
using SequencePtr = std::shared_ptr<Sequence>;

}  // namespace

struct BTPwspan_impl {
    BTPring_impl* ring;
    uint64_t begin;
    uint64_t size;
};

struct BTPrsequence_impl {
    BTPring_impl* ring;
    SequencePtr  seq;
    bool         has_guarantee = false;
    bool         guarantee_manual = false;  // the caller advances it
    uint64_t     guarantee_offset = 0;
};

// A read span names its ring itself, so that releasing it after its
// sequence closed is safe.
struct BTPrspan_impl {
    BTPring_impl* ring;
    uint64_t begin;
    uint64_t size;
};

struct BTPring_impl {
    std::string name;
    int         space = BTP_SPACE_SYSTEM;
    std::string log_path;          // empty: no geometry log

    std::mutex              mutex;
    std::condition_variable state_cond;

    char*    buf = nullptr;        // nullptr for BTP_SPACE_CUDA
    uint64_t capacity = 0;         // bytes per ringlet (main region)
    uint64_t ghost_size = 0;       // mirror of [0, ghost_size) per row
    uint64_t nringlet = 1;
    uint64_t stride() const { return capacity + ghost_size; }
    std::vector<char*> retired;    // old buffers the caller takes over

    uint64_t tail = 0;             // earliest valid offset
    uint64_t head = 0;             // committed frontier
    uint64_t reserve_head = 0;     // reserved frontier
    uint64_t ncommit = 0;

    bool writing = false;
    bool writing_ended = false;
    bool resizing = false;         // held closed by a resize (`hold`)
    // Generation-counted interrupts: a fire bumps intr_fired, an ack
    // raises intr_acked (never past intr_fired); one is PENDING while
    // intr_fired > intr_acked, so an ack bounded by the generation its
    // issuer saw never retires a later fire aimed at a peer.
    uint64_t intr_fired = 0;
    uint64_t intr_acked = 0;
    uint64_t intr_target = 0;
    int  nwaiters = 0;             // callers blocked in a wait

    bool intr_pending() const { return intr_fired > intr_acked; }

    int core = -1;                 // NUMA hint

    uint64_t next_seq_id = 0;
    std::deque<SequencePtr> sequences;   // live sequences
    SequencePtr open_wseq;               // the writer's current sequence

    std::deque<BTPwspan_impl*> open_wspans;   // reservation order
    int nread_open = 0;
    std::multiset<uint64_t> guarantees;

    struct timespec last_geom_log = {0, 0};

    ~BTPring_impl() {
        std::free(buf);
        for (char* p : retired) std::free(p);
    }

    // ---- helpers (call with the lock held) ----

    bool any_open_spans() const {
        return !open_wspans.empty() || nread_open > 0;
    }

    uint64_t min_guarantee() const {
        return guarantees.empty() ? kNoEnd : *guarantees.begin();
    }

    char* phys(uint64_t offset, uint64_t ringlet = 0) const {
        return buf + ringlet * stride() + (capacity ? offset % capacity : 0);
    }

    // `guarantee` is the slowest guaranteed reader's frontier, else the
    // head: tools read the backlog as reserve_head - guarantee.
    void format_geometry(char* txt, size_t cap) const {
        uint64_t g = min_guarantee();
        if (g == kNoEnd) g = head;
        snprintf(txt, cap,
                 "capacity : %llu\nghost : %llu\nnringlet : %llu\n"
                 "tail : %llu\nhead : %llu\nreserve_head : %llu\n"
                 "guarantee : %llu\nspace : %d\n",
                 (unsigned long long)capacity, (unsigned long long)ghost_size,
                 (unsigned long long)nringlet, (unsigned long long)tail,
                 (unsigned long long)head, (unsigned long long)reserve_head,
                 (unsigned long long)g, space);
    }

    // Ghost-mirror coherence.  The mirror of [0, ghost_size) after the
    // main region is read only by spans that straddle the capacity, so
    // the copy up into it is deferred: commits widen a dirty range, and
    // the copy runs when a straddling read span is acquired.
    uint64_t ghost_dirty_lo = UINT64_MAX;
    uint64_t ghost_dirty_hi = 0;

    void flush_ghost() {
        if (ghost_dirty_lo >= ghost_dirty_hi) return;
        // Never copy over the part of the ghost an open straddling write
        // span is filling without the lock: it stays dirty for later.
        uint64_t floor_ = 0;
        for (const auto* w : open_wspans) {
            uint64_t p = w->begin % capacity;
            if (p + w->size > capacity)
                floor_ = std::max(floor_,
                                  std::min(p + w->size - capacity,
                                           ghost_size));
        }
        uint64_t lo = std::max(ghost_dirty_lo, floor_);
        if (lo < ghost_dirty_hi) {
            uint64_t len = ghost_dirty_hi - lo;
            for (uint64_t r = 0; r < nringlet; ++r) {
                std::memcpy(buf + r * stride() + capacity + lo,
                            buf + r * stride() + lo, len);
            }
        }
        if (ghost_dirty_lo >= floor_) {
            ghost_dirty_lo = UINT64_MAX;
            ghost_dirty_hi = 0;
        } else {
            ghost_dirty_hi = std::min(ghost_dirty_hi, floor_);
        }
    }

    // Keep the mirror coherent for a newly committed [begin, begin + n).
    void sync_ghost(uint64_t begin, uint64_t n) {
        if (!buf || ghost_size == 0 || n == 0) return;
        uint64_t p = begin % capacity;
        // Written past the main region into the ghost: copied down to the
        // head of the row at once (readers of low offsets read there).
        if (p + n > capacity) {
            uint64_t glen = std::min(p + n - capacity, ghost_size);
            for (uint64_t r = 0; r < nringlet; ++r) {
                std::memcpy(buf + r * stride(),
                            buf + r * stride() + capacity, glen);
            }
            if (ghost_dirty_lo < glen)
                ghost_dirty_lo = std::min((uint64_t)glen, ghost_dirty_hi);
            if (ghost_dirty_lo >= ghost_dirty_hi) {
                ghost_dirty_lo = UINT64_MAX;
                ghost_dirty_hi = 0;
            }
        }
        // Written inside [0, ghost): the mirror is stale (lazy copy up).
        if (p < ghost_size) {
            uint64_t glen = std::min(n, ghost_size - p);
            ghost_dirty_lo = std::min(ghost_dirty_lo, p);
            ghost_dirty_hi = std::max(ghost_dirty_hi, p + glen);
        }
    }

    void prune_sequences() {
        while (!sequences.empty()) {
            const SequencePtr& s = sequences.front();
            if (s->finished() && s->end <= tail) {
                sequences.pop_front();
            } else {
                break;
            }
        }
    }

    // A wait that honours pending interrupts, counted so that destroy
    // can drain its waiters.  A call whose predicate holds never blocks,
    // so it proceeds with a generation pending.  With `progress` a commit
    // that does not make the predicate hold ends the wait as
    // BTP_STATUS_PROGRESS.
    template <typename Pred>
    BTPstatus wait_for(std::unique_lock<std::mutex>& lk, Pred pred,
                       bool progress = false) {
        if (pred()) return BTP_STATUS_SUCCESS;
        uint64_t n0 = ncommit;
        ++nwaiters;
        state_cond.wait(lk, [&] {
            return intr_pending() || pred() ||
                   (progress && ncommit != n0);
        });
        --nwaiters;
        if (intr_pending()) {
            state_cond.notify_all();  // let a draining destroy proceed
            return BTP_STATUS_INTERRUPTED;
        }
        return pred() ? BTP_STATUS_SUCCESS : BTP_STATUS_PROGRESS;
    }
};

extern "C" {

const char* btpRingGetLastError(void) { return btpr::g_last_error.c_str(); }

BTPstatus btpRingCreate(BTPring* ring, const char* name, int space,
                        const char* log_path) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(ring);
    BTPR_CHECK_PTR(name);
    if (space != BTP_SPACE_SYSTEM && space != BTP_SPACE_CUDA &&
        space != BTP_SPACE_CUDA_HOST) {
        btpr::set_last_error("ring '%s': unknown space %d", name, space);
        return BTP_STATUS_INVALID_SPACE;
    }
    auto* impl = new BTPring_impl;
    impl->name = name;
    impl->space = space;
    if (log_path) impl->log_path = log_path;
    *ring = impl;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingInterruptGen(BTPring ring, uint64_t target, uint64_t* gen) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(ring);
    uint64_t g;
    {
        std::lock_guard<std::mutex> lk(ring->mutex);
        g = ++ring->intr_fired;
        ring->intr_target = target;
    }
    ring->state_cond.notify_all();
    if (gen) *gen = g;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingAckInterrupt(BTPring ring, uint64_t gen) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(ring);
    {
        std::lock_guard<std::mutex> lk(ring->mutex);
        uint64_t bound = std::min(gen, ring->intr_fired);
        if (bound > ring->intr_acked) ring->intr_acked = bound;
    }
    ring->state_cond.notify_all();
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingDestroy(BTPring ring, void** buf) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(ring);
    btpRingInterruptGen(ring, 0, nullptr);
    {
        std::unique_lock<std::mutex> lk(ring->mutex);
        ring->state_cond.wait(lk, [&] { return ring->nwaiters == 0; });
        if (buf) {
            *buf = ring->buf;
            ring->buf = nullptr;
        }
    }
    delete ring;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingFree(void* buf) {
    std::free(buf);
    return BTP_STATUS_SUCCESS;
}

BTPstatus btpRingGetInfo(BTPring ring, BTPringInfo* info) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(ring);
    BTPR_CHECK_PTR(info);
    std::lock_guard<std::mutex> lk(ring->mutex);
    info->data = ring->buf;
    info->capacity = ring->capacity;
    info->ghost = ring->ghost_size;
    info->stride = ring->stride();
    info->nringlet = ring->nringlet;
    info->tail = ring->tail;
    info->head = ring->head;
    info->reserve_head = ring->reserve_head;
    info->intr_fired = ring->intr_fired;
    info->intr_acked = ring->intr_acked;
    info->intr_target = ring->intr_target;
    info->nwspan = (int32_t)ring->open_wspans.size();
    info->writing_ended = ring->writing_ended;
    info->core = ring->core;
    info->space = ring->space;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingSetAffinity(BTPring ring, int core) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(ring);
    std::lock_guard<std::mutex> lk(ring->mutex);
    ring->core = core;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingResize(BTPring ring, uint64_t contiguous, uint64_t total,
                        uint64_t nringlet, uint64_t align, int hold,
                        int* changed) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(ring);
    if (nringlet == 0) nringlet = 1;
    if (changed) *changed = 0;
    std::unique_lock<std::mutex> lk(ring->mutex);

    uint64_t new_ghost = round_up(std::max(ring->ghost_size, contiguous),
                                  align);
    uint64_t new_cap = round_up(std::max(ring->capacity,
                                         std::max(total, new_ghost)), align);
    uint64_t new_nring = std::max(ring->nringlet, nringlet);
    if (new_cap == ring->capacity && new_ghost == ring->ghost_size &&
        new_nring == ring->nringlet) {
        return BTP_STATUS_SUCCESS;  // already big enough
    }

    // Drain: no span may be open while the bytes are re-laid out.
    BTPstatus st = ring->wait_for(lk, [&] {
        return !ring->any_open_spans() && !ring->resizing;
    });
    if (st != BTP_STATUS_SUCCESS) return st;
    if (ring->reserve_head > ring->tail && ring->capacity > 0 &&
        new_nring != ring->nringlet) {
        btpr::set_last_error("cannot change nringlet while the ring holds "
                             "data");
        return BTP_STATUS_INVALID_STATE;
    }

    if (ring->space != BTP_SPACE_CUDA) {
        uint64_t new_stride = new_cap + new_ghost;
        char* nbuf = alloc_pages(new_nring * new_stride);
        if (!nbuf) {
            btpr::set_last_error("ring '%s': cannot allocate %llu bytes",
                                 ring->name.c_str(),
                                 (unsigned long long)(new_nring * new_stride));
            return BTP_STATUS_MEM_ALLOC_FAILED;
        }
        numa_bind_best_effort(nbuf, new_nring * new_stride, ring->core);
        std::memset(nbuf, 0, new_nring * new_stride);
        if (ring->buf && ring->reserve_head > ring->tail &&
            ring->capacity > 0) {
            // Re-map the live bytes [tail, reserve_head) into the new
            // layout, then rebuild the mirror whole.
            uint64_t lo = ring->tail, hi = ring->reserve_head;
            for (uint64_t off = lo; off < hi;) {
                uint64_t run = std::min(
                    {hi - off,
                     ring->capacity - off % ring->capacity,
                     new_cap - off % new_cap});
                for (uint64_t r = 0; r < ring->nringlet; ++r) {
                    std::memcpy(nbuf + r * new_stride + off % new_cap,
                                ring->phys(off, r), run);
                }
                off += run;
            }
            for (uint64_t r = 0; r < new_nring; ++r) {
                std::memcpy(nbuf + r * new_stride + new_cap,
                            nbuf + r * new_stride, new_ghost);
            }
        }
        if (ring->buf) ring->retired.push_back(ring->buf);
        ring->buf = nbuf;
    } else if (hold) {
        ring->resizing = true;
    }
    ring->capacity = new_cap;
    ring->ghost_size = new_ghost;
    ring->nringlet = new_nring;
    ring->ghost_dirty_lo = UINT64_MAX;
    ring->ghost_dirty_hi = 0;
    if (changed) *changed = 1;
    char txt[320];
    ring->format_geometry(txt, sizeof(txt));
    std::string log_path = ring->log_path;
    lk.unlock();
    ring->state_cond.notify_all();
    if (!log_path.empty()) write_log(log_path, txt);
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingResizeDone(BTPring ring) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(ring);
    {
        std::lock_guard<std::mutex> lk(ring->mutex);
        ring->resizing = false;
    }
    ring->state_cond.notify_all();
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingTakeRetired(BTPring ring, void** buf) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(ring); BTPR_CHECK_PTR(buf);
    std::lock_guard<std::mutex> lk(ring->mutex);
    *buf = nullptr;
    if (!ring->retired.empty()) {
        *buf = ring->retired.back();
        ring->retired.pop_back();
    }
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingBeginWriting(BTPring ring) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(ring);
    std::lock_guard<std::mutex> lk(ring->mutex);
    if (ring->writing) {
        btpr::set_last_error("ring '%s' already has a writer",
                             ring->name.c_str());
        return BTP_STATUS_INVALID_STATE;
    }
    ring->writing = true;
    ring->writing_ended = false;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingEndWriting(BTPring ring) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(ring);
    {
        std::lock_guard<std::mutex> lk(ring->mutex);
        if (ring->open_wseq && !ring->open_wseq->finished()) {
            // End at the committed frontier: bytes reserved but never
            // committed must not become readable.
            ring->open_wseq->end = ring->head;
        }
        ring->open_wseq.reset();
        ring->writing = false;
        ring->writing_ended = true;
    }
    ring->state_cond.notify_all();
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

/* ----------------------------------------------------------- write side */

BTPstatus btpRingSequenceBegin(BTPsequence* seq, BTPring ring,
                               const char* name, uint64_t time_tag,
                               uint64_t header_size, const void* header,
                               uint64_t nringlet) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(seq); BTPR_CHECK_PTR(ring);
    if (nringlet == 0) nringlet = 1;
    std::unique_lock<std::mutex> lk(ring->mutex);
    if (!ring->writing) {
        btpr::set_last_error("sequence_begin before begin_writing on '%s'",
                             ring->name.c_str());
        return BTP_STATUS_INVALID_STATE;
    }
    if (ring->open_wseq && !ring->open_wseq->finished()) {
        btpr::set_last_error("previous sequence still open on '%s'",
                             ring->name.c_str());
        return BTP_STATUS_INVALID_STATE;
    }
    if (nringlet > ring->nringlet) {
        btpr::set_last_error("sequence nringlet %llu exceeds ring nringlet "
                             "%llu \xe2\x80\x94 resize first",
                             (unsigned long long)nringlet,
                             (unsigned long long)ring->nringlet);
        return BTP_STATUS_INVALID_SHAPE;
    }
    auto s = std::make_shared<Sequence>();
    s->id = ring->next_seq_id++;
    s->name = name ? name : "";
    s->time_tag = time_tag;
    if (header && header_size) {
        s->header.assign(static_cast<const char*>(header),
                         static_cast<const char*>(header) + header_size);
    }
    s->nringlet = nringlet;
    s->begin = ring->reserve_head;
    ring->sequences.push_back(s);
    ring->open_wseq = s;
    lk.unlock();
    ring->state_cond.notify_all();
    *seq = new BTPrsequence_impl{ring, s};
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingSequenceEnd(BTPsequence h) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(h);
    BTPring ring = h->ring;
    {
        std::lock_guard<std::mutex> lk(ring->mutex);
        if (!h->seq->finished()) h->seq->end = ring->head;
        if (ring->open_wseq == h->seq) ring->open_wseq.reset();
    }
    ring->state_cond.notify_all();
    delete h;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingSpanReserve(BTPwspan* span, BTPring ring, uint64_t size,
                             int nonblocking, BTPspanInfo* info) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(span); BTPR_CHECK_PTR(ring);
    std::unique_lock<std::mutex> lk(ring->mutex);
    if (!ring->writing) {
        btpr::set_last_error("span_reserve before begin_writing");
        return BTP_STATUS_INVALID_STATE;
    }
    if (ring->capacity == 0) {
        btpr::set_last_error("ring '%s' has not been resized",
                             ring->name.c_str());
        return BTP_STATUS_INVALID_STATE;
    }
    if (size > ring->capacity || size > ring->ghost_size) {
        btpr::set_last_error("span size %llu exceeds ring geometry "
                             "(capacity %llu, ghost %llu) \xe2\x80\x94 "
                             "resize first",
                             (unsigned long long)size,
                             (unsigned long long)ring->capacity,
                             (unsigned long long)ring->ghost_size);
        return BTP_STATUS_INVALID_SHAPE;
    }
    if (ring->resizing) {
        if (nonblocking) return BTP_STATUS_WOULD_BLOCK;
        BTPstatus st = ring->wait_for(lk, [&] { return !ring->resizing; });
        if (st != BTP_STATUS_SUCCESS) return st;
    }
    uint64_t begin = ring->reserve_head;
    uint64_t new_reserve = begin + size;
    uint64_t needed_tail =
        new_reserve > ring->capacity ? new_reserve - ring->capacity : 0;
    if (needed_tail > ring->tail) {
        // Back-pressure: bytes a guaranteed reader still pins, or bytes
        // the writer has not committed, cannot be reclaimed.
        auto can_advance = [&] {
            uint64_t g = ring->min_guarantee();
            return (g == kNoEnd || g >= needed_tail) &&
                   ring->head >= needed_tail;
        };
        if (!can_advance()) {
            if (nonblocking) return BTP_STATUS_WOULD_BLOCK;
            BTPstatus st = ring->wait_for(lk, can_advance);
            if (st != BTP_STATUS_SUCCESS) return st;
        }
        ring->tail = needed_tail;
        ring->prune_sequences();
    }
    auto* w = new BTPwspan_impl{ring, begin, size};
    ring->reserve_head = new_reserve;
    ring->open_wspans.push_back(w);
    if (info) {
        info->base = ring->buf;
        info->offset = begin;
        info->size = size;
        info->capacity = ring->capacity;
        info->overwritten = 0;
    }
    lk.unlock();
    ring->state_cond.notify_all();
    *span = w;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingSpanCommit(BTPwspan span, uint64_t commit_size) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(span);
    BTPring ring = span->ring;
    std::unique_lock<std::mutex> lk(ring->mutex);
    if (commit_size > span->size) {
        btpr::set_last_error("commit larger than the reservation");
        return BTP_STATUS_INVALID_ARGUMENT;
    }
    // In-order commit: wait until every earlier reservation committed.
    BTPstatus st = ring->wait_for(lk, [&] {
        return !ring->open_wspans.empty() &&
               ring->open_wspans.front() == span;
    });
    if (st != BTP_STATUS_SUCCESS) return st;
    if (commit_size < span->size) {
        // Shrinking is legal for the final reservation only.
        if (span->begin + span->size != ring->reserve_head) {
            btpr::set_last_error("partial commit of a non-final span");
            return BTP_STATUS_INVALID_STATE;
        }
        ring->reserve_head = span->begin + commit_size;
        for (auto& s : ring->sequences) {
            if (s->finished() && s->end > ring->reserve_head) {
                s->end = ring->reserve_head;
            }
        }
    }
    ring->head = span->begin + commit_size;
    ring->ncommit++;
    ring->sync_ghost(span->begin, commit_size);
    // The geometry log at most every 0.25 s: the snapshot is taken under
    // the lock, the file written after it is released.
    char geom_txt[320];
    std::string log_path;
    if (!ring->log_path.empty()) {
        struct timespec now;
        clock_gettime(CLOCK_MONOTONIC, &now);
        double dt = (now.tv_sec - ring->last_geom_log.tv_sec) +
                    (now.tv_nsec - ring->last_geom_log.tv_nsec) * 1e-9;
        if (dt > 0.25) {
            ring->last_geom_log = now;
            log_path = ring->log_path;
            ring->format_geometry(geom_txt, sizeof(geom_txt));
        }
    }
    ring->open_wspans.pop_front();
    lk.unlock();
    ring->state_cond.notify_all();
    if (!log_path.empty()) write_log(log_path, geom_txt);
    delete span;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingSpanCancel(BTPwspan span) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(span);
    BTPring ring = span->ring;
    std::unique_lock<std::mutex> lk(ring->mutex);
    // Shrinking reserve_head under an open LATER span would take that
    // span's bytes: a batch is cancelled newest first.
    if (span->begin + span->size != ring->reserve_head) {
        btpr::set_last_error("ring '%s': cancel of a non-final span",
                             ring->name.c_str());
        return BTP_STATUS_INVALID_STATE;
    }
    ring->reserve_head = span->begin;
    for (auto& s : ring->sequences) {
        if (s->finished() && s->end > ring->reserve_head) {
            s->end = ring->reserve_head;
        }
    }
    for (auto it = ring->open_wspans.begin();
         it != ring->open_wspans.end(); ++it) {
        if (*it == span) {
            ring->open_wspans.erase(it);
            break;
        }
    }
    lk.unlock();
    ring->state_cond.notify_all();
    delete span;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

/* ------------------------------------------------------------ read side */

BTPstatus btpRingSequenceOpen(BTPsequence* seq, BTPring ring, int which,
                              const char* name, uint64_t time_tag,
                              BTPsequence cur, int guarantee,
                              int nonblocking, int progress) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(seq); BTPR_CHECK_PTR(ring);
    std::unique_lock<std::mutex> lk(ring->mutex);

    auto find = [&]() -> SequencePtr {
        switch (which) {
            case BTP_OPEN_EARLIEST:
                for (const auto& s : ring->sequences) {
                    if (!(s->finished() && s->end <= ring->tail)) return s;
                }
                return nullptr;
            case BTP_OPEN_LATEST:
                return ring->sequences.empty() ? nullptr
                                               : ring->sequences.back();
            case BTP_OPEN_BY_NAME:
                for (const auto& s : ring->sequences) {
                    if (name && name[0] && s->name == name) return s;
                }
                return nullptr;
            case BTP_OPEN_AT_TIME: {
                // The sequence CONTAINING time_tag: the latest whose tag
                // is <= it (reference ring_impl.cpp:353-369).
                SequencePtr best = nullptr;
                for (const auto& s : ring->sequences) {
                    if (s->time_tag <= time_tag) best = s;
                }
                return best;
            }
            case BTP_OPEN_NEXT: {
                if (!cur) return nullptr;
                uint64_t cur_id = cur->seq->id;
                for (const auto& s : ring->sequences) {
                    if (s->id > cur_id) return s;
                }
                return nullptr;
            }
            default:
                return nullptr;
        }
    };

    SequencePtr found = find();
    if (!found && which == BTP_OPEN_AT_TIME && !ring->sequences.empty()) {
        btpr::set_last_error("ring %s: time_tag %llu precedes every live "
                             "sequence", ring->name.c_str(),
                             (unsigned long long)time_tag);
        return BTP_STATUS_INVALID_ARGUMENT;
    }
    while (!found) {
        if (ring->writing_ended) return BTP_STATUS_END_OF_DATA;
        if (nonblocking) return BTP_STATUS_WOULD_BLOCK;
        BTPstatus st = ring->wait_for(lk, [&] {
            found = find();
            return found != nullptr || ring->writing_ended;
        }, progress != 0);
        if (st != BTP_STATUS_SUCCESS) return st;
        if (!found && ring->writing_ended) return BTP_STATUS_END_OF_DATA;
    }

    auto* h = new BTPrsequence_impl{ring, found};
    if (guarantee) {
        h->guarantee_offset = std::max(ring->tail, found->begin);
        ring->guarantees.insert(h->guarantee_offset);
        h->has_guarantee = true;
    }
    *seq = h;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingSequenceGuaranteeManual(BTPsequence h, int manual) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(h);
    std::lock_guard<std::mutex> lk(h->ring->mutex);
    h->guarantee_manual = (manual != 0);
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingSequenceAdvanceGuarantee(BTPsequence h, uint64_t offset) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(h);
    BTPring ring = h->ring;
    {
        std::lock_guard<std::mutex> lk(ring->mutex);
        if (!h->has_guarantee || offset <= h->guarantee_offset)
            return BTP_STATUS_SUCCESS;  // forward only
        auto it = ring->guarantees.find(h->guarantee_offset);
        if (it != ring->guarantees.end()) ring->guarantees.erase(it);
        h->guarantee_offset = offset;
        ring->guarantees.insert(offset);
    }
    ring->state_cond.notify_all();
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingSequenceClose(BTPsequence h) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(h);
    BTPring ring = h->ring;
    {
        std::lock_guard<std::mutex> lk(ring->mutex);
        if (h->has_guarantee) {
            auto it = ring->guarantees.find(h->guarantee_offset);
            if (it != ring->guarantees.end()) ring->guarantees.erase(it);
            h->has_guarantee = false;
        }
    }
    ring->state_cond.notify_all();
    delete h;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingSequenceGetInfo(BTPsequence h, const char** name,
                                 uint64_t* time_tag, const void** header,
                                 uint64_t* header_size, uint64_t* nringlet,
                                 uint64_t* begin) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(h);
    std::lock_guard<std::mutex> lk(h->ring->mutex);
    const Sequence& s = *h->seq;
    if (name)        *name = s.name.c_str();
    if (time_tag)    *time_tag = s.time_tag;
    if (header)      *header = s.header.empty() ? nullptr : s.header.data();
    if (header_size) *header_size = s.header.size();
    if (nringlet)    *nringlet = s.nringlet;
    if (begin)       *begin = s.begin;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingSequenceIsFinished(BTPsequence h, int* finished,
                                    uint64_t* end) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(h); BTPR_CHECK_PTR(finished);
    std::lock_guard<std::mutex> lk(h->ring->mutex);
    *finished = h->seq->finished() ? 1 : 0;
    if (end) *end = h->seq->end;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingSpanAcquire(BTPrspan* span, BTPsequence h, uint64_t offset,
                             uint64_t size, int nonblocking, int progress,
                             BTPspanInfo* info) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(span); BTPR_CHECK_PTR(h);
    BTPring ring = h->ring;
    std::unique_lock<std::mutex> lk(ring->mutex);
    const SequencePtr& s = h->seq;
    if (offset < s->begin) {
        btpr::set_last_error("acquire at %llu before its sequence's begin "
                             "%llu", (unsigned long long)offset,
                             (unsigned long long)s->begin);
        return BTP_STATUS_INVALID_ARGUMENT;
    }

    // The reader's guarantee follows its read position forward, so the
    // writer may reclaim everything before it; in manual mode the caller
    // moves it (AdvanceGuarantee).
    if (h->has_guarantee && !h->guarantee_manual &&
        offset > h->guarantee_offset) {
        auto it = ring->guarantees.find(h->guarantee_offset);
        if (it != ring->guarantees.end()) ring->guarantees.erase(it);
        h->guarantee_offset = offset;
        ring->guarantees.insert(offset);
        lk.unlock();
        ring->state_cond.notify_all();
        lk.lock();
    }

    auto ready = [&] {
        if (ring->resizing) return false;
        if (ring->head >= offset + size) return true;
        if (s->finished() &&
            ring->head >= std::min(offset + size, s->end)) return true;
        return ring->writing_ended;
    };
    if (!ready()) {
        if (nonblocking) return BTP_STATUS_WOULD_BLOCK;
        BTPstatus st = ring->wait_for(lk, ready, progress != 0);
        if (st != BTP_STATUS_SUCCESS) return st;
    }

    uint64_t limit = s->finished() ? s->end
                    : ring->writing_ended ? ring->head
                                          : offset + size;
    if (offset >= limit) return BTP_STATUS_END_OF_DATA;
    uint64_t eff = std::min(offset + size, limit) - offset;

    // A span across the capacity reads the mirror: any deferred copy up
    // into it lands now.
    if (ring->buf && ring->ghost_size &&
        (offset % ring->capacity) + eff > ring->capacity)
        ring->flush_ghost();

    auto* r = new BTPrspan_impl{ring, offset, eff};
    ring->nread_open++;
    if (info) {
        info->base = ring->buf;
        info->offset = offset;
        info->size = eff;
        info->capacity = ring->capacity;
        info->overwritten = ring->tail > offset
                                ? std::min(ring->tail - offset, eff) : 0;
    }
    *span = r;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

BTPstatus btpRingSpanRelease(BTPrspan span) {
    BTPR_TRY_BEGIN
    BTPR_CHECK_PTR(span);
    BTPring ring = span->ring;
    {
        std::lock_guard<std::mutex> lk(ring->mutex);
        ring->nread_open--;
    }
    ring->state_cond.notify_all();
    delete span;
    return BTP_STATUS_SUCCESS;
    BTPR_TRY_END
}

}  // extern "C"
