// The port's UDP data plane, host C++ (no CUDA): sockets, the packet ->
// ring capture engine and the packet transmitter with its replay
// schedule walker.  Built by build.py with the host C++ compiler into one
// shared library, loaded with ctypes.CDLL (the recv loop and the walker
// run without the GIL).
//
// Statuses are the JAX package's numbering (cpp/include/btcore.h), so a
// status means the same in both packages.  The capture engine writes a
// ring through the callback table `BTPringCallbacks`: the port's ring is
// Python (ring.py), and udp.py fills the table from it.

#ifndef BTP_UDP_HOST_H_
#define BTP_UDP_HOST_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int BTPstatus;
enum {
    BTP_STATUS_SUCCESS = 0,
    BTP_STATUS_WOULD_BLOCK = 2,
    BTP_STATUS_INVALID_POINTER = 8,
    BTP_STATUS_INVALID_ARGUMENT = 9,
    BTP_STATUS_INVALID_STATE = 10,
    BTP_STATUS_MEM_ALLOC_FAILED = 16,
    BTP_STATUS_INTERRUPTED = 32,   // a ring wait was woken by an interrupt
    BTP_STATUS_IO_ERROR = 40,
    BTP_STATUS_INTERNAL_ERROR = 99,
};

// Detail of the last failure on the calling thread.
const char* btpGetLastError(void);

// Pin the calling thread to one core (-1: every online core).  A failure
// names the core in btpGetLastError.
BTPstatus btpAffinitySetCore(int core);

// ------------------------------------------------------------- sockets
typedef struct BTPsocket_impl* BTPsocket;
BTPstatus btpSocketCreate(BTPsocket* sock);          // UDP, SO_REUSEADDR
BTPstatus btpSocketDestroy(BTPsocket sock);
BTPstatus btpSocketEnableReuseport(BTPsocket sock);  // before Bind
BTPstatus btpSocketBind(BTPsocket sock, const char* addr, int port);
BTPstatus btpSocketConnect(BTPsocket sock, const char* addr, int port);
BTPstatus btpSocketShutdown(BTPsocket sock);
BTPstatus btpSocketSetTimeout(BTPsocket sock, double secs);
BTPstatus btpSocketGetTimeout(BTPsocket sock, double* secs);
BTPstatus btpSocketGetMTU(BTPsocket sock, int* mtu);
BTPstatus btpSocketGetFD(BTPsocket sock, int* fd);
// Batched egress (sendmmsg); *nsent may be < npacket.  A buffer that
// takes no packet at all (EAGAIN/ENOBUFS) is WOULD_BLOCK, not an error.
BTPstatus btpSocketSendMany(BTPsocket sock, unsigned npacket,
                            const void* const* packets,
                            const unsigned* sizes, unsigned* nsent);
// Batched ingress (recvmmsg, MSG_WAITFORONE); WOULD_BLOCK on timeout.
BTPstatus btpSocketRecvMany(BTPsocket sock, unsigned npacket,
                            void* const* buffers, const unsigned* capacities,
                            unsigned* sizes, unsigned* nrecv);
// 1 = batched syscall works, 0 = per-packet fallback latched, -1 = not
// probed yet.
BTPstatus btpSocketBatchSupport(int* recvmmsg_ok, int* sendmmsg_ok);

// ------------------------------------------------------- capture engine
// The ring the engine writes, as callbacks into the port's Python ring.
// Each returns a status: BTP_STATUS_INTERRUPTED when a ring wait was
// interrupted (the supervision seam), another nonzero status for any
// other failure.  `reserve` hands back a writable host pointer to
// `nbyte` contiguous bytes and a span id that `commit` retires, in
// reservation order; `commit` may publish fewer bytes than reserved only
// for the final span.
typedef struct {
    void* user;
    int (*begin_writing)(void* user);
    int (*end_writing)(void* user);
    int (*resize)(void* user, uint64_t contiguous_nbyte,
                  uint64_t total_nbyte);
    int (*sequence_begin)(void* user, uint64_t time_tag, const void* hdr,
                          uint64_t hdr_size);
    int (*sequence_end)(void* user);
    int (*reserve)(void* user, uint64_t nbyte, void** data,
                   uint64_t* span);
    int (*commit)(void* user, uint64_t span, uint64_t nbyte);
} BTPringCallbacks;

// Called on the capture thread when a packet sequence starts at seq0: it
// writes the time tag and a pointer to a JSON header that must stay
// alive until the next call or the engine's destruction.  0 = success.
typedef int (*BTPsequenceCallback)(uint64_t seq0, uint64_t* time_tag,
                                   const void** hdr, uint64_t* hdr_size,
                                   void* user_data);

typedef struct BTPudpcapture_impl* BTPudpcapture;
BTPstatus btpUdpCaptureCreate(BTPudpcapture* obj,
                              const char* format,   // "simple" | "chips"
                              BTPsocket sock, const BTPringCallbacks* ring,
                              uint64_t nsrc, uint64_t src0,
                              uint64_t max_payload_size,
                              uint64_t buffer_ntime, uint64_t slot_ntime,
                              BTPsequenceCallback callback, void* user_data,
                              int core);
BTPstatus btpUdpCaptureDestroy(BTPudpcapture obj);
BTPstatus btpUdpCaptureSetBatch(BTPudpcapture obj, unsigned batch_npkt);
BTPstatus btpUdpCaptureGetBatch(BTPudpcapture obj, unsigned* batch_npkt);
// One buffer window: *result 0 = started a sequence, 1 = continued,
// 3 = would block / socket timeout.
BTPstatus btpUdpCaptureRecv(BTPudpcapture obj, int* result);
BTPstatus btpUdpCaptureSequenceEnd(BTPudpcapture obj);
BTPstatus btpUdpCaptureEnd(BTPudpcapture obj);
BTPstatus btpUdpCaptureGetStats(BTPudpcapture obj, uint64_t* ngood,
                                uint64_t* nmissing, uint64_t* ninvalid,
                                uint64_t* nlate, uint64_t* nrepeat);

// ----------------------------------------------------------- transmit
typedef struct BTPudptransmit_impl* BTPudptransmit;
BTPstatus btpUdpTransmitCreate(BTPudptransmit* obj, BTPsocket sock,
                               int core);
BTPstatus btpUdpTransmitDestroy(BTPudptransmit obj);
BTPstatus btpUdpTransmitSend(BTPudptransmit obj, const void* data,
                             unsigned size);
BTPstatus btpUdpTransmitSendMany(BTPudptransmit obj, const void* data,
                                 unsigned packet_size, unsigned npackets,
                                 unsigned* nsent);

// One datagram of a replay schedule: 24 bytes, little-endian (the numpy
// dtype udp.TRANSMIT_RECORD_DTYPE).
typedef struct {
    uint64_t offset;   // byte offset of the datagram in the slab
    uint32_t size;     // datagram length
    uint32_t flags;    // reserved, 0
    uint64_t t_ns;     // send time after the schedule's start, ascending
} BTPtransmitRecord;

// Walk a schedule on a thread of its own: due records go out in sendmmsg
// batches of up to batch_npkt, paced by the records' own timestamps.  The
// slab and the records are borrowed until Wait or Stop returns.
BTPstatus btpUdpTransmitScheduleRun(BTPudptransmit obj, const void* slab,
                                    uint64_t slab_nbyte,
                                    const BTPtransmitRecord* records,
                                    uint64_t nrecord, unsigned batch_npkt);
BTPstatus btpUdpTransmitScheduleWait(BTPudptransmit obj);
BTPstatus btpUdpTransmitScheduleStop(BTPudptransmit obj);
BTPstatus btpUdpTransmitScheduleStats(BTPudptransmit obj, uint64_t* nsent,
                                      uint64_t* nretry, uint64_t* ndropped,
                                      uint64_t* wall_ns, int* running);

#ifdef __cplusplus
}  // extern "C"

#include <new>
#include <stdexcept>

namespace btp {
// Record the calling thread's failure detail (btpGetLastError).
void set_last_error(const char* fmt, ...);
}  // namespace btp

// Every entry point maps C++ exceptions to statuses: nothing throws
// across the C interface.
#define BTP_TRY_BEGIN try {
#define BTP_TRY_END                                                    \
    }                                                                  \
    catch (const std::bad_alloc&) {                                    \
        btp::set_last_error("out of memory in %s", __func__);          \
        return BTP_STATUS_MEM_ALLOC_FAILED;                            \
    }                                                                  \
    catch (const std::exception& e) {                                  \
        btp::set_last_error("%s: %s", __func__, e.what());             \
        return BTP_STATUS_INTERNAL_ERROR;                              \
    }                                                                  \
    catch (...) {                                                      \
        btp::set_last_error("unknown exception in %s", __func__);      \
        return BTP_STATUS_INTERNAL_ERROR;                              \
    }

#define BTP_CHECK_PTR(p)                                               \
    do {                                                               \
        if ((p) == nullptr) {                                          \
            btp::set_last_error("null pointer argument in %s", __func__); \
            return BTP_STATUS_INVALID_POINTER;                         \
        }                                                              \
    } while (0)
#endif  // __cplusplus

#endif  // BTP_UDP_HOST_H_
