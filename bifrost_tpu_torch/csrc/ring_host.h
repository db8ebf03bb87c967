// The port's ring engine, host C++ (no CUDA): the port's copy of the JAX
// package's cpp/src/ring.cpp under btp* names.  Built by build.py with
// the host C++ compiler into its own shared library and loaded with
// ctypes.CDLL, so every blocking call runs without the GIL; the UDP
// capture engine (udp_capture.cpp) reserves and commits through it.
//
// Byte offsets only grow (tail <= head <= reserve_head); commits land in
// reservation order; guaranteed readers pin the tail; interrupts are
// generation-counted.  A ring in BTP_SPACE_CUDA keeps the offsets only:
// its bytes are a device tensor that ring.py owns.  Host rings own their
// bytes, (nringlet, capacity + ghost) laid out row by row, the ghost
// mirroring [0, ghost) after each row.
//
// Statuses are the JAX package's numbering (cpp/include/btcore.h), plus
// BTP_STATUS_PROGRESS: a reader's wait asked to report commits returns
// it at a commit that did not end the wait (ring.py stamps the reader's
// heartbeat and waits again).

#ifndef BTP_RING_HOST_H_
#define BTP_RING_HOST_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int BTPstatus;
enum {
    BTP_STATUS_SUCCESS = 0,
    BTP_STATUS_END_OF_DATA = 1,
    BTP_STATUS_WOULD_BLOCK = 2,
    BTP_STATUS_INVALID_POINTER = 8,
    BTP_STATUS_INVALID_ARGUMENT = 9,
    BTP_STATUS_INVALID_STATE = 10,
    BTP_STATUS_INVALID_SPACE = 11,
    BTP_STATUS_INVALID_SHAPE = 12,
    BTP_STATUS_MEM_ALLOC_FAILED = 16,
    BTP_STATUS_INTERRUPTED = 32,   // a ring wait was woken by an interrupt
    BTP_STATUS_PROGRESS = 35,      // a reader's wait saw a commit
    BTP_STATUS_IO_ERROR = 40,
    BTP_STATUS_INTERNAL_ERROR = 99,
};

// memory.SPACEMAP's numbering.
enum {
    BTP_SPACE_SYSTEM = 1,
    BTP_SPACE_CUDA = 2,       // offsets only: the bytes live on the card
    BTP_SPACE_CUDA_HOST = 3,  // host bytes, pinned by ring.py
};

// Sequence open modes.
enum {
    BTP_OPEN_EARLIEST = 0,
    BTP_OPEN_LATEST = 1,
    BTP_OPEN_BY_NAME = 2,
    BTP_OPEN_AT_TIME = 3,
    BTP_OPEN_NEXT = 4,
};

typedef struct BTPring_impl* BTPring;
typedef struct BTPrsequence_impl* BTPsequence;   // writer's or reader's
typedef struct BTPwspan_impl* BTPwspan;
typedef struct BTPrspan_impl* BTPrspan;

// One snapshot of a ring, taken under its lock.
typedef struct {
    void* data;              // the host bytes (NULL for BTP_SPACE_CUDA)
    uint64_t capacity;
    uint64_t ghost;
    uint64_t stride;         // capacity + ghost
    uint64_t nringlet;
    uint64_t tail;
    uint64_t head;
    uint64_t reserve_head;
    uint64_t intr_fired;
    uint64_t intr_acked;
    uint64_t intr_target;
    int32_t nwspan;          // open write spans
    int32_t writing_ended;
    int32_t core;            // the NUMA hint, -1 for none
    int32_t space;
} BTPringInfo;

// A span as reserve or acquire hands it over.
typedef struct {
    void* base;              // the ring's host bytes at the call
    uint64_t offset;
    uint64_t size;           // bytes available (acquire may shorten)
    uint64_t capacity;
    uint64_t overwritten;    // leading bytes the writer has overwritten
} BTPspanInfo;

// Detail of the last failure of a ring call on the calling thread.
const char* btpRingGetLastError(void);

// `log_path`: the file the ring's geometry log is written to (its
// directory exists), or NULL for none.
BTPstatus btpRingCreate(BTPring* ring, const char* name, int space,
                        const char* log_path);
// Wakes and drains every waiter, then frees the ring.  With `buf` the
// host bytes are handed to the caller (free them with btpRingFree);
// without, they are freed here.
BTPstatus btpRingDestroy(BTPring ring, void** buf);
BTPstatus btpRingFree(void* buf);
BTPstatus btpRingGetInfo(BTPring ring, BTPringInfo* info);
// The NUMA hint: the next allocation of host bytes prefers core's node.
BTPstatus btpRingSetAffinity(BTPring ring, int core);

// Grow to hold spans of `contiguous` bytes and `total` bytes in all per
// ringlet (never shrinks; sizes rounded up to `align`); waits until no
// span is open.  A host ring re-lays its live bytes into new memory and
// retires the old (btpRingTakeRetired).  With `hold`, a ring whose
// geometry changed stays closed to reserves and acquires until
// btpRingResizeDone: the caller re-lays its own bytes meanwhile.
BTPstatus btpRingResize(BTPring ring, uint64_t contiguous, uint64_t total,
                        uint64_t nringlet, uint64_t align, int hold,
                        int* changed);
BTPstatus btpRingResizeDone(BTPring ring);
// Hands over one retired host buffer (*buf NULL when there is none).
BTPstatus btpRingTakeRetired(BTPring ring, void** buf);

BTPstatus btpRingBeginWriting(BTPring ring);
BTPstatus btpRingEndWriting(BTPring ring);

// Fire an interrupt generation: every blocked caller returns
// BTP_STATUS_INTERRUPTED while a generation is pending.  Ack retires
// every generation <= gen, never a later fire.
BTPstatus btpRingInterruptGen(BTPring ring, uint64_t target,
                              uint64_t* gen);
BTPstatus btpRingAckInterrupt(BTPring ring, uint64_t gen);

BTPstatus btpRingSequenceBegin(BTPsequence* seq, BTPring ring,
                               const char* name, uint64_t time_tag,
                               uint64_t header_size, const void* header,
                               uint64_t nringlet);
BTPstatus btpRingSequenceEnd(BTPsequence seq);
BTPstatus btpRingSpanReserve(BTPwspan* span, BTPring ring, uint64_t size,
                             int nonblocking, BTPspanInfo* info);
// In reservation order; only the final reservation may commit fewer
// bytes than it reserved.
BTPstatus btpRingSpanCommit(BTPwspan span, uint64_t size);
// Retire the final reservation uncommitted (no in-order wait).
BTPstatus btpRingSpanCancel(BTPwspan span);

// `progress`: a wait returns BTP_STATUS_PROGRESS at a commit that does
// not end it.
BTPstatus btpRingSequenceOpen(BTPsequence* seq, BTPring ring, int which,
                              const char* name, uint64_t time_tag,
                              BTPsequence cur, int guarantee,
                              int nonblocking, int progress);
BTPstatus btpRingSequenceClose(BTPsequence seq);
BTPstatus btpRingSequenceGuaranteeManual(BTPsequence seq, int manual);
BTPstatus btpRingSequenceAdvanceGuarantee(BTPsequence seq, uint64_t offset);
// *header points into the engine's copy, valid while the sequence
// handle lives.
BTPstatus btpRingSequenceGetInfo(BTPsequence seq, const char** name,
                                 uint64_t* time_tag, const void** header,
                                 uint64_t* header_size, uint64_t* nringlet,
                                 uint64_t* begin);
BTPstatus btpRingSequenceIsFinished(BTPsequence seq, int* finished,
                                    uint64_t* end);
BTPstatus btpRingSpanAcquire(BTPrspan* span, BTPsequence seq,
                             uint64_t offset, uint64_t size,
                             int nonblocking, int progress,
                             BTPspanInfo* info);
BTPstatus btpRingSpanRelease(BTPrspan span);

#ifdef __cplusplus
}  // extern "C"
#endif

#endif  // BTP_RING_HOST_H_
