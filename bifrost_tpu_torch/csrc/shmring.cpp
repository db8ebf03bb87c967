/* Named cross-process shared-memory ring: the port's own copy of the JAX
 * package's shm ring engine (cpp/src/shmring.cpp), built with the host C++
 * compiler by build.load_host("shmring").
 *
 * The segment is a control block holding a process-shared robust mutex
 * and condvar, a monotonic write head, per-reader consumed tails (the
 * guarantee and back-pressure state) and the current sequence's time tag
 * and JSON header, then the header area and the data ring.  Its layout,
 * magic, name mangling ("/btshm_" + name, '/' -> '_'), the robust-mutex
 * recovery when a peer dies holding the lock and the liveness-gated reclaim
 * of dead readers' slots and of stale names are those of the JAX engine,
 * byte for byte, so a writer of either package and a reader of the other
 * attach to one segment.
 *
 * Single writer, up to BT_SHMRING_MAX_READERS guaranteed readers; the
 * writer blocks while the slowest attached reader would be overrun, readers
 * block for data and sequences on the shared condvar, and every wait is
 * bounded (100 ms slices) so interrupts and dead peers never hang a
 * process.  The C interface (btShmRing*) is the JAX engine's. */

#include "host_status.h"

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <stdexcept>
#include <string>

#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

typedef struct BTshmring_impl* BTshmring;
enum { BT_SHMRING_MAX_READERS = 8 };

#pragma GCC visibility push(hidden)

namespace {

constexpr uint64_t kMagic   = 0x42545348'4d523104ull;  // "BTSHMR"+ver 4
constexpr uint64_t kNoEnd   = ~0ull;
constexpr uint64_t kFreeTail = ~0ull;

struct ShmCtrl {
    uint64_t        magic;
    uint64_t        data_capacity;
    uint64_t        hdr_capacity;
    pthread_mutex_t mu;
    pthread_cond_t  cv;
    uint64_t        head;          // committed bytes (monotonic)
    uint64_t        tails[BT_SHMRING_MAX_READERS];  // kFreeTail = free slot
    uint64_t        seq_opened[BT_SHMRING_MAX_READERS];  // seqs seen/skipped
    uint64_t        seq_count;     // sequences begun so far
    uint64_t        cur_seq_begin;
    uint64_t        cur_seq_end;   // kNoEnd while the sequence is open
    uint64_t        cur_time_tag;
    uint64_t        cur_hdr_size;
    uint32_t        writing_ended;
    uint32_t        interrupt;     // segment-wide (every process)
    uint32_t        writer_pid;    // creator's pid: liveness for reclaim
    // per-slot reader pids: liveness for slot reclaim when a consumer
    // dies without ReaderClose (SIGKILL, crash) — otherwise its stale
    // tail back-pressures the writer forever
    uint32_t        reader_pids[BT_SHMRING_MAX_READERS];
    // (pid, start_time) pairs close the PID-reuse hole: kill(pid, 0)
    // alone would treat a recycled pid as a live peer, so peer-death
    // detection would silently never fire.  start_time is /proc/<pid>/
    // stat field 22 (jiffies since boot — unique per pid incarnation);
    // 0 where procfs is unavailable, degrading to pid-only liveness.
    uint64_t        writer_start;
    uint64_t        reader_starts[BT_SHMRING_MAX_READERS];
};

struct Lock {
    pthread_mutex_t* mu;
    explicit Lock(pthread_mutex_t* m) : mu(m) {
        int rc = pthread_mutex_lock(mu);
        if (rc == EOWNERDEAD) {
            // A peer died holding the lock; the ctrl state is only ever
            // mutated in small consistent steps, so mark it recovered.
            pthread_mutex_consistent(mu);
        } else if (rc != 0) {
            throw std::runtime_error("shmring mutex lock failed");
        }
    }
    ~Lock() { pthread_mutex_unlock(mu); }
};

uint64_t proc_start_time(pid_t pid) {
    // /proc/<pid>/stat field 22 (starttime).  Field 2 (comm) may contain
    // spaces and parentheses, so fields are counted from the LAST ')'.
    char path[64];
    snprintf(path, sizeof(path), "/proc/%d/stat", (int)pid);
    FILE* f = fopen(path, "re");
    if (!f) return 0;
    char buf[1024];
    size_t n = fread(buf, 1, sizeof(buf) - 1, f);
    fclose(f);
    buf[n] = '\0';
    const char* p = strrchr(buf, ')');
    if (!p) return 0;
    int field = 2;  // the token after each space is field `field + 1`
    for (const char* q = p + 1; *q; ++q) {
        if (*q == ' ') {
            ++field;
            if (field == 22) return strtoull(q + 1, nullptr, 10);
        }
    }
    return 0;
}

// Dead when the pid is gone, or when it is alive but belongs to a NEW
// process incarnation (start_time mismatch: the peer died and its pid was
// recycled).  start == 0 (no procfs at registration) falls back to
// pid-only liveness.
bool peer_dead(uint32_t pid, uint64_t start) {
    if (kill((pid_t)pid, 0) != 0 && errno == ESRCH) return true;
    if (start != 0) {
        uint64_t now = proc_start_time((pid_t)pid);
        if (now != 0 && now != start) return true;
    }
    return false;
}

std::string shm_name(const char* name) {
    std::string s = "/btshm_";
    for (const char* p = name; *p; ++p)
        s += (*p == '/' ? '_' : *p);
    return s;
}

}  // namespace

struct BTshmring_impl {
    ShmCtrl* ctrl = nullptr;
    uint8_t* hdr  = nullptr;
    uint8_t* data = nullptr;
    size_t   map_size = 0;
    bool     is_writer = false;
    uint64_t local_seen = 0;  // sequences this handle's reader has opened
    // Handle-local interrupt plane, generation-counted like the in-process
    // ring (ring.cpp): fires stay pending (fired > acked) until this
    // handle acknowledges them, so a supervised block can deadman-
    // interrupt its shm ring and later RESUME blocking use — a boolean
    // latch here could never be re-armed.
    volatile uint64_t local_intr_fired = 0;
    volatile uint64_t local_intr_acked = 0;
    std::string name;

    bool writer_dead() const {
        // A cleanly-closed writer zeroes writer_pid (its liveness claim);
        // nonzero + provably-dead (ESRCH, or a start-time mismatch from
        // pid recycling) means the producer died mid-stream.
        uint32_t pid = ctrl->writer_pid;
        return pid != 0 && (pid_t)pid != getpid() &&
               peer_dead(pid, ctrl->writer_start);
    }

    void reap_dead_readers() {
        // Free slots whose owning process is provably dead (kill(pid, 0)
        // == ESRCH): the writer's backpressure and sequence gates must
        // not wait on a consumer that can never drain.  Same-process
        // slots are skipped (a live process may hold several handles);
        // a dead process's pid cannot be ours.
        for (int i = 0; i < BT_SHMRING_MAX_READERS; ++i) {
            uint32_t pid = ctrl->reader_pids[i];
            if (ctrl->tails[i] == kFreeTail || pid == 0) continue;
            if ((pid_t)pid == getpid()) continue;
            if (peer_dead(pid, ctrl->reader_starts[i])) {
                ctrl->tails[i] = kFreeTail;
                ctrl->reader_pids[i] = 0;
                ctrl->reader_starts[i] = 0;
                pthread_cond_broadcast(&ctrl->cv);
            }
        }
    }

    uint64_t min_active_tail() const {
        uint64_t m = kFreeTail;
        for (int i = 0; i < BT_SHMRING_MAX_READERS; ++i)
            if (ctrl->tails[i] != kFreeTail && ctrl->tails[i] < m)
                m = ctrl->tails[i];
        return m;  // kFreeTail when no reader is attached
    }

    void wait(Lock&) {
        // Bounded waits so interrupt/peer-death never hangs a process.
        struct timespec ts;
        clock_gettime(CLOCK_REALTIME, &ts);
        ts.tv_nsec += 100 * 1000 * 1000;
        if (ts.tv_nsec >= 1000000000) { ts.tv_sec++; ts.tv_nsec -= 1000000000; }
        int rc = pthread_cond_timedwait(&ctrl->cv, &ctrl->mu, &ts);
        if (rc == EOWNERDEAD)
            pthread_mutex_consistent(&ctrl->mu);  // peer died mid-critical
    }

    bool interrupted() const {
        return ctrl->interrupt || local_intr_fired > local_intr_acked;
    }
};

#define SHM_CHECK_INT(ring)                                \
    do {                                                   \
        if ((ring)->interrupted()) {                       \
            set_last_error("shm ring interrupted");    \
            return BT_STATUS_INTERRUPTED;                  \
        }                                                  \
    } while (0)

static BTshmring_impl* map_ring(const char* name, bool create,
                                uint64_t data_capacity,
                                uint64_t hdr_capacity) {
    std::string sname = shm_name(name);
    int flags = create ? (O_CREAT | O_EXCL | O_RDWR) : O_RDWR;
    int fd = shm_open(sname.c_str(), flags, 0600);
    // On EEXIST, only reclaim a segment whose creator is provably dead:
    // unconditional unlink would silently destroy a live ring's name
    // binding and split its peers across two segments.  The loop closes
    // the unlink/re-create race between two creators reclaiming at once.
    for (int attempt = 0; fd < 0 && create && errno == EEXIST && attempt < 8;
         ++attempt) {
        int efd = shm_open(sname.c_str(), O_RDWR, 0600);
        if (efd < 0) {
            if (errno == ENOENT) {  // vanished under us: retry create
                fd = shm_open(sname.c_str(), flags, 0600);
                continue;
            }
            throw std::runtime_error(
                "shmring create: cannot inspect existing segment '" +
                sname + "': " + strerror(errno));
        }
        struct stat st;
        int live = 0, initializing = 0;
        if (fstat(efd, &st) != 0) {
            close(efd);
            throw std::runtime_error(
                "shmring create: cannot stat existing segment '" + sname +
                "': " + strerror(errno));
        }
        if (st.st_size < (off_t)sizeof(ShmCtrl)) {
            initializing = 1;  // created but not yet ftruncated
        } else {
            void* eb = mmap(nullptr, sizeof(ShmCtrl), PROT_READ,
                            MAP_SHARED, efd, 0);
            if (eb == MAP_FAILED) {
                // Cannot prove the segment dead: fail loudly rather than
                // unlink a possibly-live ring out from under its peers.
                close(efd);
                throw std::runtime_error(
                    "shmring create: cannot inspect existing segment '" +
                    sname + "': mmap: " + strerror(errno));
            }
            const ShmCtrl* ec = static_cast<const ShmCtrl*>(eb);
            if (ec->magic != kMagic) {
                initializing = 1;  // mid-init peer (or old version)
            } else if (ec->writer_pid != 0) {
                // Conservative direction here: EPERM (can't signal) counts
                // as live, and a start-time MATCH (or no recorded start)
                // keeps it live — only a provable pid recycle demotes an
                // apparently-alive writer to dead for name reclaim.
                if (kill((pid_t)ec->writer_pid, 0) == 0 || errno == EPERM) {
                    live = 1;
                    if (ec->writer_start != 0) {
                        uint64_t now = proc_start_time(
                            (pid_t)ec->writer_pid);
                        if (now != 0 && now != ec->writer_start) live = 0;
                    }
                }
            }
            munmap(eb, sizeof(ShmCtrl));
        }
        if (live) {
            close(efd);
            throw std::runtime_error(
                "shmring create: name '" + sname + "' is owned by a "
                "live writer; choose another name or unlink it "
                "explicitly");
        }
        if (initializing) {
            close(efd);
            if (attempt < 7) {
                // Give a racing creator time to finish (or prove stale).
                usleep(10 * 1000);
                fd = -1;
                errno = EEXIST;
                continue;
            }
            // Grace period exhausted and still unprovable (mid-init peer
            // stalled, or an incompatible/older version): fail loudly —
            // reclaiming here could unlink a live ring.
            throw std::runtime_error(
                "shmring create: existing segment '" + sname + "' is "
                "neither provably stale nor a compatible live ring "
                "(still initializing, or a different version); unlink it "
                "explicitly to reclaim the name");
        }
        // Provably stale (creator dead, or released its claim on clean
        // close).  Serialize reclaimers on the stale inode itself: unlink
        // only while holding its flock AND having re-verified the name
        // still binds to that inode — otherwise a racing reclaimer could
        // unlink the ring a faster peer just re-created (TOCTOU).
        if (flock(efd, LOCK_EX) != 0) {
            close(efd);
            throw std::runtime_error(
                "shmring create: flock on existing segment '" + sname +
                "': " + strerror(errno));
        }
        int nfd = shm_open(sname.c_str(), O_RDWR, 0600);
        bool still_bound = false;
        if (nfd >= 0) {
            struct stat st2;
            still_bound = (fstat(nfd, &st2) == 0 &&
                           st2.st_ino == st.st_ino &&
                           st2.st_dev == st.st_dev);
            close(nfd);
        }
        if (still_bound)
            shm_unlink(sname.c_str());
        close(efd);  // releases the flock
        // If the name was rebound, the loop re-inspects the new segment.
        fd = shm_open(sname.c_str(), flags, 0600);
    }
    if (fd < 0)
        throw std::runtime_error(std::string(create ? "shm_open create "
                                                    : "shm_open attach ") +
                                 sname + ": " + strerror(errno));
    size_t map_size = 0;
    if (create) {
        map_size = sizeof(ShmCtrl) + hdr_capacity + data_capacity;
        if (ftruncate(fd, (off_t)map_size) != 0) {
            int e = errno;
            close(fd);
            shm_unlink(sname.c_str());
            throw std::runtime_error(std::string("ftruncate: ") +
                                     strerror(e));
        }
    } else {
        struct stat st;
        if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(ShmCtrl)) {
            close(fd);
            throw std::runtime_error("shmring segment too small / stat "
                                     "failed");
        }
        map_size = (size_t)st.st_size;
    }
    void* base = mmap(nullptr, map_size, PROT_READ | PROT_WRITE,
                      MAP_SHARED, fd, 0);
    close(fd);
    if (base == MAP_FAILED)
        throw std::runtime_error(std::string("mmap: ") + strerror(errno));

    auto* r = new BTshmring_impl;
    r->ctrl = reinterpret_cast<ShmCtrl*>(base);
    r->map_size = map_size;
    r->is_writer = create;
    r->name = name;

    if (create) {
        memset(r->ctrl, 0, sizeof(ShmCtrl));
        r->ctrl->data_capacity = data_capacity;
        r->ctrl->hdr_capacity = hdr_capacity;
        r->ctrl->cur_seq_end = kNoEnd;
        r->ctrl->writer_pid = (uint32_t)getpid();
        r->ctrl->writer_start = proc_start_time(getpid());
        for (auto& t : r->ctrl->tails) t = kFreeTail;
        pthread_mutexattr_t ma;
        pthread_mutexattr_init(&ma);
        pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
        pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
        pthread_mutex_init(&r->ctrl->mu, &ma);
        pthread_mutexattr_destroy(&ma);
        pthread_condattr_t ca;
        pthread_condattr_init(&ca);
        pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
        pthread_cond_init(&r->ctrl->cv, &ca);
        pthread_condattr_destroy(&ca);
        __sync_synchronize();
        r->ctrl->magic = kMagic;  // publish last
    } else {
        // Wait briefly for the creator to finish initializing.
        for (int i = 0; i < 100 && r->ctrl->magic != kMagic; ++i)
            usleep(10 * 1000);
        if (r->ctrl->magic != kMagic) {
            munmap(base, map_size);
            delete r;
            throw std::runtime_error("shmring attach: segment not "
                                     "initialized");
        }
    }
    r->hdr = reinterpret_cast<uint8_t*>(base) + sizeof(ShmCtrl);
    r->data = r->hdr + r->ctrl->hdr_capacity;
    return r;
}

#pragma GCC visibility pop

BTH_API BTstatus btShmRingCreate(BTshmring* ring, const char* name,
                         uint64_t data_capacity, uint64_t hdr_capacity) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    BT_CHECK_PTR(name);
    if (data_capacity == 0) {
        set_last_error("shmring data_capacity must be > 0");
        return BT_STATUS_INVALID_ARGUMENT;
    }
    if (hdr_capacity == 0) hdr_capacity = 65536;
    *ring = map_ring(name, true, data_capacity, hdr_capacity);
    return BT_STATUS_SUCCESS;
    BT_TRY_END
}

BTH_API BTstatus btShmRingAttach(BTshmring* ring, const char* name) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    BT_CHECK_PTR(name);
    *ring = map_ring(name, false, 0, 0);
    return BT_STATUS_SUCCESS;
    BT_TRY_END
}

BTH_API BTstatus btShmRingClose(BTshmring ring) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    if (ring->is_writer) {
        // A cleanly-closed writer releases its liveness claim so the name
        // is reclaimable by a future creator; attached readers keep their
        // mapping and drain whatever was committed.
        Lock lk(&ring->ctrl->mu);
        ring->ctrl->writer_pid = 0;
        ring->ctrl->writer_start = 0;
    }
    munmap(ring->ctrl, ring->map_size);
    delete ring;
    return BT_STATUS_SUCCESS;
    BT_TRY_END
}

BTH_API BTstatus btShmRingUnlink(const char* name) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(name);
    shm_unlink(shm_name(name).c_str());
    return BT_STATUS_SUCCESS;
    BT_TRY_END
}

BTH_API BTstatus btShmRingInterrupt(BTshmring ring) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    // Interrupt THIS handle only: one process's pipeline shutdown must not
    // kill its peers.  Waits are 100 ms-bounded, so no cross-process signal
    // is needed; the local broadcast wakes this process's blocked threads.
    // Mutate under the (robust) segment mutex: fire/ack are
    // read-modify-writes from different threads of this process, and an
    // unlocked ack racing a fire could retire a generation its target
    // never observed.  Waiters re-check interrupted() every <=100 ms, so
    // taking the lock first costs nothing observable.
    Lock lk(&ring->ctrl->mu);
    ring->local_intr_fired = ring->local_intr_fired + 1;
    pthread_cond_broadcast(&ring->ctrl->cv);
    return BT_STATUS_SUCCESS;
    BT_TRY_END
}

BTH_API BTstatus btShmRingAckInterrupt(BTshmring ring) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    // Retire every fire this handle has seen so far (ack-all, the
    // compat-clear shape: the shm ABI carries no generation parameter
    // yet — callers serialize fire/ack through the same mutex, so an
    // ack can only retire fires that happened-before it).  Calls
    // blocked after this resume normally.
    Lock lk(&ring->ctrl->mu);
    ring->local_intr_acked = ring->local_intr_fired;
    pthread_cond_broadcast(&ring->ctrl->cv);
    return BT_STATUS_SUCCESS;
    BT_TRY_END
}

BTH_API BTstatus btShmRingSequenceBegin(BTshmring ring, uint64_t time_tag,
                                const void* header, uint64_t header_size) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    ShmCtrl* c = ring->ctrl;
    if (header_size > c->hdr_capacity) {
        set_last_error("shmring header (%llu B) exceeds capacity "
                           "(%llu B)",
                           (unsigned long long)header_size,
                           (unsigned long long)c->hdr_capacity);
        return BT_STATUS_INVALID_ARGUMENT;
    }
    Lock lk(&c->mu);
    if (c->cur_seq_end == kNoEnd && c->seq_count > 0) {
        set_last_error("previous sequence still open");
        return BT_STATUS_INVALID_STATE;
    }
    // One in-flight sequence: wait until every attached reader has consumed
    // the previous one — data drained AND the sequence itself observed
    // (seq_opened), so empty begin/end pairs are not silently overwritten.
    while (true) {
        SHM_CHECK_INT(ring);
        bool ready = true;
        for (int i = 0; i < BT_SHMRING_MAX_READERS; ++i) {
            if (c->tails[i] == kFreeTail) continue;
            if (c->tails[i] < c->head || c->seq_opened[i] < c->seq_count) {
                ready = false;
                break;
            }
        }
        if (ready) break;
        ring->reap_dead_readers();
        ring->wait(lk);
    }
    if (header_size)
        memcpy(ring->hdr, header, header_size);
    c->cur_hdr_size = header_size;
    c->cur_time_tag = time_tag;
    c->cur_seq_begin = c->head;
    c->cur_seq_end = kNoEnd;
    c->seq_count += 1;
    pthread_cond_broadcast(&c->cv);
    return BT_STATUS_SUCCESS;
    BT_TRY_END
}

BTH_API BTstatus btShmRingSequenceEnd(BTshmring ring) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    Lock lk(&ring->ctrl->mu);
    ring->ctrl->cur_seq_end = ring->ctrl->head;
    pthread_cond_broadcast(&ring->ctrl->cv);
    return BT_STATUS_SUCCESS;
    BT_TRY_END
}

BTH_API BTstatus btShmRingEndWriting(BTshmring ring) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    Lock lk(&ring->ctrl->mu);
    if (ring->ctrl->cur_seq_end == kNoEnd && ring->ctrl->seq_count > 0)
        ring->ctrl->cur_seq_end = ring->ctrl->head;
    ring->ctrl->writing_ended = 1;
    pthread_cond_broadcast(&ring->ctrl->cv);
    return BT_STATUS_SUCCESS;
    BT_TRY_END
}

BTH_API BTstatus btShmRingWrite(BTshmring ring, const void* buf,
                                uint64_t nbyte) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    BT_CHECK_PTR(buf);
    ShmCtrl* c = ring->ctrl;
    const uint8_t* src = static_cast<const uint8_t*>(buf);
    uint64_t cap = c->data_capacity;
    uint64_t done = 0;
    while (done < nbyte) {
        Lock lk(&c->mu);
        uint64_t chunk = 0;
        while (true) {
            SHM_CHECK_INT(ring);
            uint64_t tail = ring->min_active_tail();
            if (tail == kFreeTail) tail = c->head;  // no readers: free-run
            uint64_t space = tail + cap - c->head;
            if (space > 0) {
                chunk = nbyte - done;
                if (chunk > space) chunk = space;
                break;
            }
            ring->reap_dead_readers();
            ring->wait(lk);
        }
        uint64_t pos = c->head % cap;
        uint64_t first = chunk;
        if (pos + first > cap) first = cap - pos;
        memcpy(ring->data + pos, src + done, first);
        if (chunk > first)
            memcpy(ring->data, src + done + first, chunk - first);
        c->head += chunk;
        done += chunk;
        pthread_cond_broadcast(&c->cv);
    }
    return BT_STATUS_SUCCESS;
    BT_TRY_END
}

BTH_API BTstatus btShmRingWriteReserve(BTshmring ring, uint64_t nbyte,
                               void** ptr, uint64_t* got) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    BT_CHECK_PTR(ptr);
    BT_CHECK_PTR(got);
    ShmCtrl* c = ring->ctrl;
    uint64_t cap = c->data_capacity;
    if (nbyte == 0) {
        *ptr = nullptr;
        *got = 0;
        return BT_STATUS_SUCCESS;
    }
    Lock lk(&c->mu);
    uint64_t space = 0;
    while (true) {
        SHM_CHECK_INT(ring);
        uint64_t tail = ring->min_active_tail();
        if (tail == kFreeTail) tail = c->head;  // no readers: free-run
        space = tail + cap - c->head;
        if (space > 0) break;
        ring->reap_dead_readers();
        ring->wait(lk);
    }
    uint64_t pos = c->head % cap;
    uint64_t run = nbyte;
    if (run > space) run = space;
    if (pos + run > cap) run = cap - pos;   // contiguous up to the wrap
    // Writing into [head, head + run) without the lock is safe: readers
    // only consume bytes strictly below head, and head does not move
    // until the matching commit.
    *ptr = ring->data + pos;
    *got = run;
    return BT_STATUS_SUCCESS;
    BT_TRY_END
}

BTH_API BTstatus btShmRingWriteCommit(BTshmring ring, uint64_t nbyte) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    ShmCtrl* c = ring->ctrl;
    Lock lk(&c->mu);
    // Guard against publishing past the space the reserve proved free:
    // head may never overrun the slowest reader's tail + capacity.
    uint64_t tail = ring->min_active_tail();
    if (tail == kFreeTail) tail = c->head;
    if (nbyte > tail + c->data_capacity - c->head) {
        set_last_error("shmring commit of %llu B exceeds reserved "
                           "free space", (unsigned long long)nbyte);
        return BT_STATUS_INVALID_ARGUMENT;
    }
    c->head += nbyte;
    pthread_cond_broadcast(&c->cv);
    return BT_STATUS_SUCCESS;
    BT_TRY_END
}

BTH_API BTstatus btShmRingNumReaders(BTshmring ring, int* n) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    BT_CHECK_PTR(n);
    Lock lk(&ring->ctrl->mu);
    int count = 0;
    for (int i = 0; i < BT_SHMRING_MAX_READERS; ++i)
        if (ring->ctrl->tails[i] != kFreeTail) ++count;
    *n = count;
    return BT_STATUS_SUCCESS;
    BT_TRY_END
}

BTH_API BTstatus btShmRingReaderOpen(BTshmring ring, int* slot) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    BT_CHECK_PTR(slot);
    ShmCtrl* c = ring->ctrl;
    Lock lk(&c->mu);
    for (int i = 0; i < BT_SHMRING_MAX_READERS; ++i) {
        if (c->tails[i] == kFreeTail) {
            // Join at the current head: sequences begun after this point
            // are seen in full; an in-progress one is skipped unless no
            // data has flowed yet (then it is still joinable in full).
            c->tails[i] = c->head;
            c->reader_pids[i] = (uint32_t)getpid();
            c->reader_starts[i] = proc_start_time(getpid());
            ring->local_seen = c->seq_count;
            if (c->seq_count > 0 && c->cur_seq_begin == c->head &&
                    c->cur_seq_end == kNoEnd)
                ring->local_seen = c->seq_count - 1;
            c->seq_opened[i] = ring->local_seen;
            *slot = i;
            pthread_cond_broadcast(&c->cv);
            return BT_STATUS_SUCCESS;
        }
    }
    set_last_error("shmring: all %d reader slots in use",
                       BT_SHMRING_MAX_READERS);
    return BT_STATUS_INVALID_STATE;
    BT_TRY_END
}

BTH_API BTstatus btShmRingReaderClose(BTshmring ring, int slot) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    if (slot < 0 || slot >= BT_SHMRING_MAX_READERS)
        return BT_STATUS_INVALID_ARGUMENT;
    Lock lk(&ring->ctrl->mu);
    ring->ctrl->tails[slot] = kFreeTail;
    ring->ctrl->reader_pids[slot] = 0;
    ring->ctrl->reader_starts[slot] = 0;
    pthread_cond_broadcast(&ring->ctrl->cv);
    return BT_STATUS_SUCCESS;
    BT_TRY_END
}

BTH_API BTstatus btShmRingReadSequence(BTshmring ring, int slot,
                               void* header_buf, uint64_t header_cap,
                               uint64_t* header_size, uint64_t* time_tag) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    BT_CHECK_PTR(header_size);
    if (slot < 0 || slot >= BT_SHMRING_MAX_READERS)
        return BT_STATUS_INVALID_ARGUMENT;
    ShmCtrl* c = ring->ctrl;
    Lock lk(&c->mu);
    while (true) {
        SHM_CHECK_INT(ring);
        // A sequence is "next" for this reader when it was begun after the
        // last one this handle opened AND its begin offset is at or past
        // the reader's consumed tail (i.e. not yet consumed).
        if (c->seq_count > ring->local_seen &&
                c->cur_seq_begin >= c->tails[slot]) {
            if (header_buf != nullptr && c->cur_hdr_size > header_cap) {
                // Refuse WITHOUT consuming: the caller learns the true
                // size, grows its buffer, and retries the same sequence
                // (silent truncation would corrupt the JSON header).
                *header_size = c->cur_hdr_size;
                set_last_error(
                    "shmring header (%llu B) exceeds reader buffer "
                    "(%llu B)",
                    (unsigned long long)c->cur_hdr_size,
                    (unsigned long long)header_cap);
                return BT_STATUS_INSUFFICIENT_SPACE;
            }
            ring->local_seen = c->seq_count;
            c->seq_opened[slot] = c->seq_count;
            c->tails[slot] = c->cur_seq_begin;
            if (header_buf != nullptr && c->cur_hdr_size > 0) {
                uint64_t n = c->cur_hdr_size;
                if (n > header_cap) n = header_cap;
                memcpy(header_buf, ring->hdr, n);
            }
            *header_size = c->cur_hdr_size;
            if (time_tag) *time_tag = c->cur_time_tag;
            pthread_cond_broadcast(&c->cv);
            return BT_STATUS_SUCCESS;
        }
        if (c->writing_ended)
            return BT_STATUS_END_OF_DATA;
        if (ring->writer_dead()) {
            set_last_error("shmring %s: writer (pid %u) died "
                               "mid-stream", ring->name.c_str(),
                               (unsigned)c->writer_pid);
            return BT_STATUS_PEER_DIED;
        }
        // Waiting for a FUTURE sequence: any bytes between this reader's
        // tail and the head belong to sequences it skipped or consumed, so
        // release them — otherwise a reader that attached mid-sequence
        // back-pressures the writer forever (deadlock).
        if (c->tails[slot] < c->head) {
            c->tails[slot] = c->head;
            pthread_cond_broadcast(&c->cv);
        }
        if (c->seq_opened[slot] < c->seq_count) {
            c->seq_opened[slot] = c->seq_count;
            pthread_cond_broadcast(&c->cv);
        }
        ring->wait(lk);
    }
    BT_TRY_END
}

BTH_API BTstatus btShmRingRead(BTshmring ring, int slot, void* buf,
                               uint64_t nbyte,
                       uint64_t* nread) {
    BT_TRY_BEGIN
    BT_CHECK_PTR(ring);
    BT_CHECK_PTR(buf);
    BT_CHECK_PTR(nread);
    if (slot < 0 || slot >= BT_SHMRING_MAX_READERS)
        return BT_STATUS_INVALID_ARGUMENT;
    ShmCtrl* c = ring->ctrl;
    uint64_t cap = c->data_capacity;
    Lock lk(&c->mu);
    while (true) {
        SHM_CHECK_INT(ring);
        // The open sequence may already be one this reader has NOT opened:
        // after the reader drains sequence N (tail == head, seq_opened ==
        // seq_count) the writer's SequenceBegin gate passes, so N+1 can
        // begin — and possibly carry data — before a reader blocked here
        // wakes.  Recomputing `limit` from the new sequence would then hand
        // N+1's bytes to the N read call and skip N+1 in ReadSequence.
        // A read must never cross into an unopened sequence.
        if (c->seq_count > c->seq_opened[slot]) {
            *nread = 0;  // this reader's sequence is fully consumed
            return BT_STATUS_SUCCESS;
        }
        uint64_t tail = c->tails[slot];
        uint64_t limit = (c->cur_seq_end == kNoEnd) ? c->head
                                                    : c->cur_seq_end;
        if (limit > c->head) limit = c->head;
        if (tail < limit) {
            uint64_t n = limit - tail;
            if (n > nbyte) n = nbyte;
            uint64_t pos = tail % cap;
            uint64_t first = n;
            if (pos + first > cap) first = cap - pos;
            memcpy(buf, ring->data + pos, first);
            if (n > first)
                memcpy(static_cast<uint8_t*>(buf) + first, ring->data,
                       n - first);
            c->tails[slot] = tail + n;
            *nread = n;
            pthread_cond_broadcast(&c->cv);
            return BT_STATUS_SUCCESS;
        }
        if (c->cur_seq_end != kNoEnd && tail >= c->cur_seq_end) {
            *nread = 0;  // sequence consumed
            return BT_STATUS_SUCCESS;
        }
        if (c->writing_ended) {
            *nread = 0;
            return BT_STATUS_END_OF_DATA;
        }
        if (ring->writer_dead()) {
            set_last_error("shmring %s: writer (pid %u) died "
                               "mid-stream", ring->name.c_str(),
                               (unsigned)c->writer_pid);
            return BT_STATUS_PEER_DIED;
        }
        ring->wait(lk);
    }
    BT_TRY_END
}

BTH_API const char* btGetLastError(void) { return bth_last_error.c_str(); }
