// Batched UDP egress and the paced replay schedule walker (the port's
// copy of the JAX package's cpp/src/udp_transmit.cpp; reference:
// src/udp_transmit.cpp).  A schedule is one payload slab plus packed
// (offset, size, t_ns) records, walked on a thread of its own with
// sendmmsg batches and token-bucket pacing, so a seeded replay script
// compiles once and transmits with no per-packet work above C.

#include <atomic>
#include <cstring>
#include <pthread.h>
#include <sched.h>
#include <time.h>
#include <vector>

#include "udp_host.h"

namespace {

// Bounded retry budget for EAGAIN/ENOBUFS inside the walker: with the
// 16 MB SO_SNDBUF this only triggers under genuine sustained back-
// pressure.  2000 rounds x <=2 ms cap ~= 4 s of patience per stall
// before booking drops and moving on (a replay must not wedge forever
// on a dead receiver).
const unsigned kWalkerMaxRetries = 2000;
const long kWalkerBackoffMinNs = 50 * 1000;    // 50 us
const long kWalkerBackoffMaxNs = 2000 * 1000;  // 2 ms

int64_t elapsed_ns(const timespec& t0) {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (int64_t)(ts.tv_sec - t0.tv_sec) * 1000000000LL +
           ((int64_t)ts.tv_nsec - (int64_t)t0.tv_nsec);
}

void sleep_ns(long ns) {
    timespec req;
    req.tv_sec = ns / 1000000000L;
    req.tv_nsec = ns % 1000000000L;
    nanosleep(&req, nullptr);
}

}  // namespace

struct BTPudptransmit_impl {
    BTPsocket sock = nullptr;
    int core = -1;
    bool pinned = false;

    // Schedule walker state (one schedule at a time).
    pthread_t sched_thread;
    bool sched_active = false;            // thread created, not yet joined
    std::atomic<bool> sched_stop{false};
    std::atomic<int> sched_running{0};
    std::atomic<int> sched_status{BTP_STATUS_SUCCESS};
    std::atomic<uint64_t> sched_nsent{0};
    std::atomic<uint64_t> sched_nretry{0};
    std::atomic<uint64_t> sched_ndropped{0};
    std::atomic<uint64_t> sched_wall_ns{0};
    const uint8_t* sched_slab = nullptr;  // borrowed until Wait/Stop
    const BTPtransmitRecord* sched_recs = nullptr;
    uint64_t sched_nrec = 0;
    unsigned sched_batch = 64;

    BTPstatus pin_if_needed() {
        if (!pinned) {
            pinned = true;
            // Loud, not silent: a failed pin (invalid/offline core)
            // surfaces as this call's status with the core named in
            // btpGetLastError, instead of quietly running unpinned.
            if (core >= 0) return btpAffinitySetCore(core);
        }
        return BTP_STATUS_SUCCESS;
    }

    void walk();
    BTPstatus join_schedule() {
        if (!sched_active) return BTP_STATUS_INVALID_STATE;
        pthread_join(sched_thread, nullptr);
        sched_active = false;
        sched_slab = nullptr;
        sched_recs = nullptr;
        return (BTPstatus)sched_status.load();
    }
};

// The walker body: runs on its own thread, pinned to the transmit's core.
// Pacing is a token bucket whose refill follows the records' OWN
// timestamps: the walker sleeps until the next record is due, then drains
// every already-due record in sendmmsg batches of up to sched_batch
// packets — so the burst bound is the batch depth and the long-run rate
// is exactly the schedule's.
void BTPudptransmit_impl::walk() {
    pthread_setname_np(pthread_self(), "btp_tx_sched");
    if (core >= 0) {
        BTPstatus ps = btpAffinitySetCore(core);
        if (ps != BTP_STATUS_SUCCESS) {
            sched_status.store(ps);
            sched_running.store(0);
            return;
        }
    }
    const unsigned batch = sched_batch;
    std::vector<const void*> pkts(batch);
    std::vector<unsigned> sizes(batch);
    timespec t0;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    BTPstatus final_status = BTP_STATUS_SUCCESS;
    uint64_t i = 0;
    while (i < sched_nrec && !sched_stop.load(std::memory_order_relaxed)) {
        int64_t due = (int64_t)sched_recs[i].t_ns;
        int64_t wait = due - elapsed_ns(t0);
        if (wait > 0) {
            // Coarse nanosleep to just short of the deadline, then a
            // short yield-spin for the tail — the stop flag is checked
            // each round so Stop stays responsive mid-gap (pause events
            // compile to timestamp gaps).
            while (wait > 150000 &&
                   !sched_stop.load(std::memory_order_relaxed)) {
                sleep_ns(wait > 2000000 ? wait - 100000 : 100000);
                wait = due - elapsed_ns(t0);
            }
            while (due - elapsed_ns(t0) > 0 &&
                   !sched_stop.load(std::memory_order_relaxed))
                sched_yield();
            if (sched_stop.load(std::memory_order_relaxed)) break;
        }
        // Gather every record already due into one batch.
        int64_t elapsed = elapsed_ns(t0);
        unsigned n = 0;
        while (n < batch && i + n < sched_nrec &&
               (int64_t)sched_recs[i + n].t_ns <= elapsed) {
            const BTPtransmitRecord& r = sched_recs[i + n];
            pkts[n] = sched_slab + r.offset;
            sizes[n] = r.size;
            ++n;
        }
        // Deliver the batch, retrying back-pressure with bounded backoff.
        unsigned done = 0;
        unsigned attempts = 0;
        long backoff = kWalkerBackoffMinNs;
        while (done < n && !sched_stop.load(std::memory_order_relaxed)) {
            unsigned nsent = 0;
            BTPstatus s = btpSocketSendMany(sock, n - done, pkts.data() + done,
                                          sizes.data() + done, &nsent);
            if (s == BTP_STATUS_SUCCESS && nsent > 0) {
                done += nsent;
                sched_nsent.fetch_add(nsent, std::memory_order_relaxed);
                attempts = 0;
                backoff = kWalkerBackoffMinNs;
                continue;
            }
            if (s == BTP_STATUS_WOULD_BLOCK ||
                (s == BTP_STATUS_SUCCESS && nsent == 0)) {
                if (++attempts > kWalkerMaxRetries) {
                    sched_ndropped.fetch_add(n - done,
                                             std::memory_order_relaxed);
                    break;
                }
                sched_nretry.fetch_add(1, std::memory_order_relaxed);
                sleep_ns(backoff);
                if (backoff < kWalkerBackoffMaxNs) backoff *= 2;
                continue;
            }
            // Real I/O error: book the remainder and abort the walk.
            sched_ndropped.fetch_add(n - done, std::memory_order_relaxed);
            final_status = s;
            break;
        }
        if (final_status != BTP_STATUS_SUCCESS) break;
        i += n;
    }
    sched_wall_ns.store((uint64_t)elapsed_ns(t0));
    sched_status.store(final_status);
    sched_running.store(0);
}

extern "C" {

BTPstatus btpUdpTransmitCreate(BTPudptransmit* obj, BTPsocket sock, int core) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    BTP_CHECK_PTR(sock);
    auto* t = new BTPudptransmit_impl;
    t->sock = sock;
    t->core = core;  // applied on the sending thread's first call
    *obj = t;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpUdpTransmitDestroy(BTPudptransmit obj) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    if (obj->sched_active) {
        obj->sched_stop.store(true);
        obj->join_schedule();
    }
    delete obj;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpUdpTransmitSend(BTPudptransmit obj, const void* data,
                           unsigned size) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    BTP_CHECK_PTR(data);
    BTPstatus ps = obj->pin_if_needed();
    if (ps != BTP_STATUS_SUCCESS) return ps;
    const void* pkts[1] = {data};
    unsigned sizes[1] = {size};
    unsigned nsent = 0;
    BTPstatus s = btpSocketSendMany(obj->sock, 1, pkts, sizes, &nsent);
    if (s != BTP_STATUS_SUCCESS) return s;
    return nsent == 1 ? BTP_STATUS_SUCCESS : BTP_STATUS_IO_ERROR;
    BTP_TRY_END
}

BTPstatus btpUdpTransmitSendMany(BTPudptransmit obj, const void* data,
                               unsigned packet_size, unsigned npackets,
                               unsigned* nsent) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    BTP_CHECK_PTR(data);
    BTPstatus ps = obj->pin_if_needed();
    if (ps != BTP_STATUS_SUCCESS) return ps;
    // data is a contiguous array of npackets x packet_size
    std::vector<const void*> pkts(npackets);
    std::vector<unsigned> sizes(npackets, packet_size);
    for (unsigned i = 0; i < npackets; ++i) {
        pkts[i] = (const uint8_t*)data + (size_t)i * packet_size;
    }
    return btpSocketSendMany(obj->sock, npackets, pkts.data(), sizes.data(),
                            nsent);
    BTP_TRY_END
}

static void* walker_entry(void* arg) {
    ((BTPudptransmit_impl*)arg)->walk();
    return nullptr;
}

BTPstatus btpUdpTransmitScheduleRun(BTPudptransmit obj, const void* slab,
                                  uint64_t slab_nbyte,
                                  const BTPtransmitRecord* records,
                                  uint64_t nrecord, unsigned batch_npkt) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    if (nrecord > 0) BTP_CHECK_PTR(records);
    if (slab_nbyte > 0) BTP_CHECK_PTR(slab);
    if (obj->sched_active) {
        btp::set_last_error("a schedule is already running on this transmit");
        return BTP_STATUS_INVALID_STATE;
    }
    if (batch_npkt == 0 || batch_npkt > 4096) {
        btp::set_last_error("batch_npkt %u out of range [1, 4096]",
                           batch_npkt);
        return BTP_STATUS_INVALID_ARGUMENT;
    }
    // Validate up front so the walker never touches bytes outside the
    // slab and never has to reason about time going backwards.
    uint64_t prev_t = 0;
    for (uint64_t i = 0; i < nrecord; ++i) {
        const BTPtransmitRecord& r = records[i];
        if (r.flags != 0) {
            btp::set_last_error("record %llu: nonzero flags",
                               (unsigned long long)i);
            return BTP_STATUS_INVALID_ARGUMENT;
        }
        if (r.offset > slab_nbyte || r.size > slab_nbyte - r.offset) {
            btp::set_last_error(
                "record %llu: [%llu, +%u) outside slab of %llu bytes",
                (unsigned long long)i, (unsigned long long)r.offset,
                r.size, (unsigned long long)slab_nbyte);
            return BTP_STATUS_INVALID_ARGUMENT;
        }
        if (r.t_ns < prev_t) {
            btp::set_last_error("record %llu: t_ns decreases",
                               (unsigned long long)i);
            return BTP_STATUS_INVALID_ARGUMENT;
        }
        prev_t = r.t_ns;
    }
    obj->sched_slab = (const uint8_t*)slab;
    obj->sched_recs = records;
    obj->sched_nrec = nrecord;
    obj->sched_batch = batch_npkt;
    obj->sched_stop.store(false);
    obj->sched_status.store(BTP_STATUS_SUCCESS);
    obj->sched_nsent.store(0);
    obj->sched_nretry.store(0);
    obj->sched_ndropped.store(0);
    obj->sched_wall_ns.store(0);
    obj->sched_running.store(1);
    int rc = pthread_create(&obj->sched_thread, nullptr, walker_entry, obj);
    if (rc != 0) {
        obj->sched_running.store(0);
        btp::set_last_error("pthread_create: %s", strerror(rc));
        return BTP_STATUS_INTERNAL_ERROR;
    }
    obj->sched_active = true;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpUdpTransmitScheduleWait(BTPudptransmit obj) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    return obj->join_schedule();
    BTP_TRY_END
}

BTPstatus btpUdpTransmitScheduleStop(BTPudptransmit obj) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    if (!obj->sched_active) return BTP_STATUS_INVALID_STATE;
    obj->sched_stop.store(true);
    return obj->join_schedule();
    BTP_TRY_END
}

BTPstatus btpUdpTransmitScheduleStats(BTPudptransmit obj, uint64_t* nsent,
                                    uint64_t* nretry, uint64_t* ndropped,
                                    uint64_t* wall_ns, int* running) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    if (nsent) *nsent = obj->sched_nsent.load();
    if (nretry) *nretry = obj->sched_nretry.load();
    if (ndropped) *ndropped = obj->sched_ndropped.load();
    if (wall_ns) *wall_ns = obj->sched_wall_ns.load();
    if (running) *running = obj->sched_running.load();
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

}  // extern "C"
