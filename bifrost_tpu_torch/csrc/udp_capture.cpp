// UDP packet -> ring capture engine (the port's copy of the JAX package's
// cpp/src/udp_capture.cpp; reference: src/udp_capture.cpp).
//
// - pluggable decoder: the "simple" test format and a CHIPS-style header;
// - payloads scatter into TWO consecutive ring write spans (slots), so
//   moderately reordered packets still land;
// - per-slot missing-packet accounting, a per-(frame, source) dedup
//   bitmap, and a bound on forward sequence jumps;
// - a sequence callback lets Python supply the JSON sequence header, the
//   one call into Python, once a sequence;
// - the loop runs synchronously inside btpUdpCaptureRecv, on the calling
//   block's thread, and reserves and commits the ring through the port's
//   ring engine (ring.cpp) without the GIL;
// - the throttled `<capture>/stats` log, every 16,384 good payloads and
//   at the end of each sequence and of the engine, to the file udp.py
//   names.
//
// One change from the JAX engine: the stats log is a file path that
// udp.py gives (its ProcLog), written through a temporary file and a
// rename; and the engine counts the slot windows it committed
// (btpUdpCaptureGetWindows).

#include <cstdio>
#include <cstring>
#include <endian.h>
#include <netinet/in.h>
#include <pthread.h>
#include <string>
#include <vector>

#include "udp_host.h"

namespace {

struct PacketDesc {
    uint64_t seq = 0;
    int src = 0;
    const uint8_t* payload = nullptr;
    unsigned payload_size = 0;
};

// A ring call's failure carrying its status: an interrupted ring wait
// must reach Python as BTP_STATUS_INTERRUPTED (RingInterrupted), which
// supervision absorbs or restarts, not as a generic internal error.
struct status_error {
    BTPstatus status;
    const char* what;
};

// "simple" test format: {uint64 seq (LE), uint16 src (LE), uint16 pad},
// 12 bytes on the wire.
struct __attribute__((packed)) simple_hdr {
    uint64_t seq;
    uint16_t src;
    uint16_t pad;
};

// CHIPS-style format (reference udp_capture.cpp:383-393): big-endian
// chan0/seq, 1-based roach id; 16 bytes on the wire.
struct __attribute__((packed)) chips_hdr {
    uint8_t roach;
    uint8_t gbe;
    uint8_t nchan;
    uint8_t nsubband;
    uint8_t subband;
    uint8_t nroach;
    uint16_t chan0;  // big endian
    uint64_t seq;    // big endian, 1-based
};

class Decoder {
public:
    Decoder(int fmt, uint64_t nsrc, uint64_t src0)
        : fmt_(fmt), nsrc_(nsrc), src0_(src0) {}

    bool operator()(const uint8_t* p, unsigned size, PacketDesc* pkt) const {
        if (fmt_ == 0) {  // simple
            if (size < sizeof(simple_hdr)) return false;
            const simple_hdr* h = (const simple_hdr*)p;
            pkt->seq = h->seq;
            pkt->src = (int)h->src - (int)src0_;
            pkt->payload = p + sizeof(simple_hdr);
            pkt->payload_size = size - sizeof(simple_hdr);
        } else {  // chips
            if (size < sizeof(chips_hdr)) return false;
            const chips_hdr* h = (const chips_hdr*)p;
            pkt->seq = be64toh(h->seq) - 1;
            pkt->src = (int)(h->roach - 1) - (int)src0_;
            pkt->payload = p + sizeof(chips_hdr);
            pkt->payload_size = size - sizeof(chips_hdr);
        }
        return pkt->src >= 0 && pkt->src < (int)nsrc_;
    }

private:
    int fmt_;
    uint64_t nsrc_;
    uint64_t src0_;
};

void ring_call(BTPstatus status, const char* what) {
    if (status != BTP_STATUS_SUCCESS) throw status_error{status, what};
}

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

}  // namespace

struct BTPudpcapture_impl {
    BTPsocket sock = nullptr;
    BTPring ring = nullptr;
    Decoder decoder{0, 1, 0};
    uint64_t nsrc = 1;
    uint64_t payload_size = 0;   // bytes per (seq, src) cell
    uint64_t frame_nbyte = 0;    // nsrc * payload_size
    uint64_t slot_ntime = 0;     // frames per write span (reorder window)
    uint64_t buffer_ntime = 0;   // frames buffered in the ring
    BTPsequenceCallback callback = nullptr;
    void* user_data = nullptr;

    // live state
    bool writing = false;
    bool pinned = false;
    int core = -1;
    BTPsequence wseq = nullptr;
    uint64_t seq0 = 0;           // packet seq of sequence start
    uint64_t slot_seq = 0;       // packet seq of slot0 start
    BTPwspan spans[2] = {nullptr, nullptr};
    uint8_t* span_data[2] = {nullptr, nullptr};
    uint64_t filled[2] = {0, 0};  // good bytes per slot
    std::vector<uint8_t> cell_filled[2];  // per-(frame, src) dedup bitmap

    // Receive buffers: `batch` is the recvmmsg depth (the
    // capture_batch_npkt flag); the pointer/capacity arrays are laid out
    // once per batch change.
    unsigned batch = 64;
    std::vector<uint8_t> rxbuf;
    std::vector<void*> rxptrs;
    std::vector<unsigned> rxcaps;
    std::vector<unsigned> rxsizes;

    void layout_rxbuf() {
        unsigned pkt_cap = (unsigned)(payload_size + 64);
        rxbuf.resize((size_t)batch * pkt_cap);
        rxptrs.resize(batch);
        rxcaps.assign(batch, pkt_cap);
        rxsizes.assign(batch, 0);
        for (unsigned i = 0; i < batch; ++i)
            rxptrs[i] = rxbuf.data() + (size_t)i * pkt_cap;
    }

    // stats (reference PacketStats)
    uint64_t ngood = 0, nmissing = 0, ninvalid = 0, nlate = 0, nrepeat = 0;
    uint64_t nwindow = 0;        // ring commits (slot windows)
    std::string stats_path;      // "<capture>/stats" (empty: none)
    uint64_t last_logged_ngood = 0;

    void log_stats() {
        if (stats_path.empty()) return;
        // Throttled on progress, not time: once per 16k good payloads.
        if (ngood - last_logged_ngood < 16384 && last_logged_ngood) return;
        last_logged_ngood = ngood ? ngood : 1;
        char txt[256];
        snprintf(txt, sizeof(txt),
                 "ngood_bytes : %llu\nnmissing_bytes : %llu\n"
                 "ninvalid : %llu\nnlate : %llu\nnrepeat : %llu\n",
                 (unsigned long long)(ngood * payload_size),
                 (unsigned long long)(nmissing * payload_size),
                 (unsigned long long)ninvalid, (unsigned long long)nlate,
                 (unsigned long long)nrepeat);
        write_log(stats_path, txt);
    }

    void log_stats_forced() {
        last_logged_ngood = 0;
        log_stats();
    }

    void commit(BTPwspan span, uint64_t nbyte, const char* what) {
        ring_call(btpRingSpanCommit(span, nbyte), what);
        nwindow++;
    }

    void reserve_slot(int i) {
        BTPspanInfo info;
        ring_call(btpRingSpanReserve(&spans[i], ring,
                                     slot_ntime * frame_nbyte, 0, &info),
                  "reserve failed");
        span_data[i] = (uint8_t*)info.base + info.offset % info.capacity;
        std::memset(span_data[i], 0, slot_ntime * frame_nbyte);
        filled[i] = 0;
        cell_filled[i].assign(slot_ntime * nsrc, 0);
    }

    void commit_slot0() {
        uint64_t expected = slot_ntime * frame_nbyte;
        // Commit BEFORE accumulating: an interrupted commit unwinds to
        // the caller and may be retried (supervised restart), so stats
        // count only windows that were published.
        commit(spans[0], expected, "commit failed");
        ngood += filled[0] / payload_size;
        nmissing += (expected - filled[0]) / payload_size;
        spans[0] = spans[1];
        span_data[0] = span_data[1];
        filled[0] = filled[1];
        cell_filled[0].swap(cell_filled[1]);
        slot_seq += slot_ntime;
        // Close slot 1 BEFORE the reserve: if it unwinds (interrupted
        // wait under back-pressure) the two slots must not name the same
        // span, or the retrying end_sequence would commit it twice.
        spans[1] = nullptr;
        reserve_slot(1);
    }

    void begin_sequence(uint64_t pkt_seq) {
        uint64_t time_tag = pkt_seq;
        const void* hdr = nullptr;
        uint64_t hdr_size = 0;
        seq0 = pkt_seq;
        if (callback) {
            int rc = callback(seq0, &time_tag, &hdr, &hdr_size, user_data);
            if (rc != 0) throw std::runtime_error("sequence callback failed");
        }
        if (!writing) {
            ring_call(btpRingBeginWriting(ring), "begin writing failed");
            writing = true;
        }
        int changed = 0;
        ring_call(btpRingResize(ring, slot_ntime * frame_nbyte,
                                buffer_ntime * frame_nbyte, 1, 1, 0,
                                &changed), "resize failed");
        ring_call(btpRingSequenceBegin(&wseq, ring, "", time_tag, hdr_size,
                                       hdr, 1), "sequence begin failed");
        slot_seq = seq0;
        reserve_slot(0);
        reserve_slot(1);
    }

    void end_sequence() {
        if (!wseq) return;
        // Each slot retires on its own (commit -> count -> close), so an
        // interrupted commit retried by a supervised restart never
        // commits a published span again or counts it twice.
        uint64_t expected = slot_ntime * frame_nbyte;
        if (spans[0]) {
            commit(spans[0], expected, "final commit failed");
            ngood += filled[0] / payload_size;
            nmissing += (expected - filled[0]) / payload_size;
            spans[0] = nullptr;
        }
        if (spans[1]) {
            uint64_t f1 = filled[1];
            // Keep a partial final window (zero-filled gaps) instead of
            // dropping received data; an empty one commits away.
            commit(spans[1], f1 > 0 ? expected : 0, "final commit failed");
            if (f1 > 0) {
                ngood += f1 / payload_size;
                nmissing += (expected - f1) / payload_size;
            }
            spans[1] = nullptr;
        }
        ring_call(btpRingSequenceEnd(wseq), "sequence end failed");
        wseq = nullptr;
        log_stats_forced();
    }

    // Scatter one packet into the two-slot window; -> slots completed.
    int process(const PacketDesc& pkt) {
        if (pkt.payload_size != payload_size) {
            ninvalid++;
            return 0;
        }
        if (!wseq) begin_sequence(pkt.seq);
        int completed = 0;
        if (pkt.seq < slot_seq) {
            nlate++;
            return 0;
        }
        // Bound the forward jump: a corrupt or hostile seq far ahead must
        // not spin the commit loop for 2^50 slots (or flood the ring with
        // zero windows).
        if (pkt.seq >= slot_seq + 8 * buffer_ntime) {
            ninvalid++;
            return 0;
        }
        while (pkt.seq >= slot_seq + 2 * slot_ntime) {
            commit_slot0();
            completed++;
        }
        uint64_t rel = pkt.seq - slot_seq;
        int slot = rel >= slot_ntime ? 1 : 0;
        uint64_t in_slot = rel - slot * slot_ntime;
        uint8_t* cell = &cell_filled[slot][in_slot * nsrc + pkt.src];
        if (*cell) {
            nrepeat++;  // duplicate (seq, src): overwrite, don't recount
        } else {
            *cell = 1;
            filled[slot] += payload_size;
        }
        uint8_t* dst = span_data[slot] +
            in_slot * frame_nbyte + (uint64_t)pkt.src * payload_size;
        std::memcpy(dst, pkt.payload, payload_size);
        return completed;
    }
};

extern "C" {

BTPstatus btpUdpCaptureCreate(BTPudpcapture* obj, const char* format,
                              BTPsocket sock, BTPring ring,
                              uint64_t nsrc, uint64_t src0,
                              uint64_t max_payload_size,
                              uint64_t buffer_ntime, uint64_t slot_ntime,
                              BTPsequenceCallback callback, void* user_data,
                              int core, const char* stats_path) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    BTP_CHECK_PTR(format);
    BTP_CHECK_PTR(sock);
    BTP_CHECK_PTR(ring);
    int fmt;
    if (std::strcmp(format, "simple") == 0) fmt = 0;
    else if (std::strcmp(format, "chips") == 0) fmt = 1;
    else {
        btp::set_last_error("unknown capture format '%s'", format);
        return BTP_STATUS_INVALID_ARGUMENT;
    }
    if (slot_ntime == 0 || buffer_ntime < 3 * slot_ntime) {
        btp::set_last_error("buffer_ntime must be >= 3*slot_ntime");
        return BTP_STATUS_INVALID_ARGUMENT;
    }
    BTPringInfo info;
    if (btpRingGetInfo(ring, &info) != BTP_STATUS_SUCCESS ||
        info.space == BTP_SPACE_CUDA) {
        btp::set_last_error("the capture ring must hold host memory");
        return BTP_STATUS_INVALID_SPACE;
    }
    auto* c = new BTPudpcapture_impl;
    c->sock = sock;
    c->ring = ring;
    c->decoder = Decoder(fmt, nsrc, src0);
    c->nsrc = nsrc;
    c->payload_size = max_payload_size;
    c->frame_nbyte = nsrc * max_payload_size;
    c->slot_ntime = slot_ntime;
    c->buffer_ntime = buffer_ntime;
    c->callback = callback;
    c->user_data = user_data;
    c->layout_rxbuf();
    c->core = core;  // applied on the capture thread's first Recv
    if (stats_path) c->stats_path = stats_path;
    *obj = c;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpUdpCaptureDestroy(BTPudpcapture obj) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    try {
        obj->end_sequence();
    } catch (const status_error&) {
        // Interrupted final commit (shutdown): teardown proceeds, and
        // ending the writing below truncates the open sequence at the
        // committed frontier, the bytes that are valid.
    }
    if (obj->writing) btpRingEndWriting(obj->ring);
    obj->log_stats_forced();
    delete obj;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpUdpCaptureSetBatch(BTPudpcapture obj, unsigned batch_npkt) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    if (batch_npkt == 0 || batch_npkt > 4096) {
        btp::set_last_error("capture batch_npkt %u out of range [1, 4096]",
                            batch_npkt);
        return BTP_STATUS_INVALID_ARGUMENT;
    }
    obj->batch = batch_npkt;
    obj->layout_rxbuf();
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpUdpCaptureGetBatch(BTPudpcapture obj, unsigned* batch_npkt) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    BTP_CHECK_PTR(batch_npkt);
    *batch_npkt = obj->batch;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpUdpCaptureRecv(BTPudpcapture obj, int* result) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    BTP_CHECK_PTR(result);
    if (!obj->pinned) {
        // Pin the thread that runs the capture loop, loudly: a bad core
        // is this call's status, named in btpGetLastError.
        obj->pinned = true;
        if (obj->core >= 0) {
            BTPstatus ps = btpAffinitySetCore(obj->core);
            if (ps != BTP_STATUS_SUCCESS) return ps;
        }
    }
    // Receive batches until at least one slot commits (one buffer
    // window), the socket times out, or an error occurs.
    bool had_sequence = obj->wseq != nullptr;
    for (;;) {
        unsigned nrecv = 0;
        BTPstatus s = btpSocketRecvMany(obj->sock, obj->batch,
                                        obj->rxptrs.data(),
                                        obj->rxcaps.data(),
                                        obj->rxsizes.data(), &nrecv);
        if (s != BTP_STATUS_SUCCESS && s != BTP_STATUS_WOULD_BLOCK) return s;
        if (s == BTP_STATUS_WOULD_BLOCK || nrecv == 0) {
            *result = 3;  // would block / timeout
            return BTP_STATUS_SUCCESS;
        }
        int completed = 0;
        uint64_t invalid = 0;
        PacketDesc pkt;
        for (unsigned i = 0; i < nrecv; ++i) {
            if (!obj->decoder((const uint8_t*)obj->rxptrs[i],
                              obj->rxsizes[i], &pkt)) {
                ++invalid;
                continue;
            }
            completed += obj->process(pkt);
        }
        obj->ninvalid += invalid;
        if (completed > 0) {
            obj->log_stats();
            *result = had_sequence ? 1 : 0;  // continued : started
            return BTP_STATUS_SUCCESS;
        }
    }
    } catch (const status_error& e) {
        btp::set_last_error("udp capture: %s", e.what);
        return e.status;
    BTP_TRY_END
}

BTPstatus btpUdpCaptureSequenceEnd(BTPudpcapture obj) {
    // End ONLY the current packet sequence: the ring keeps its writer, so
    // readers see end-of-sequence and wait for the next one (the
    // supervised-restart seam); the next packet begins a fresh sequence.
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    obj->end_sequence();
    return BTP_STATUS_SUCCESS;
    } catch (const status_error& e) {
        btp::set_last_error("udp capture: %s", e.what);
        return e.status;
    BTP_TRY_END
}

BTPstatus btpUdpCaptureEnd(BTPudpcapture obj) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    obj->end_sequence();
    if (obj->writing) {
        ring_call(btpRingEndWriting(obj->ring), "end writing failed");
        obj->writing = false;
    }
    return BTP_STATUS_SUCCESS;
    } catch (const status_error& e) {
        btp::set_last_error("udp capture: %s", e.what);
        return e.status;
    BTP_TRY_END
}

BTPstatus btpUdpCaptureGetStats(BTPudpcapture obj, uint64_t* ngood,
                                uint64_t* nmissing, uint64_t* ninvalid,
                                uint64_t* nlate, uint64_t* nrepeat) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    if (ngood) *ngood = obj->ngood;
    if (nmissing) *nmissing = obj->nmissing;
    if (ninvalid) *ninvalid = obj->ninvalid;
    if (nlate) *nlate = obj->nlate;
    if (nrepeat) *nrepeat = obj->nrepeat;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpUdpCaptureGetWindows(BTPudpcapture obj, uint64_t* nwindow) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(obj);
    BTP_CHECK_PTR(nwindow);
    *nwindow = obj->nwindow;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

}  // extern "C"
