// UDP sockets of the port's data plane (the port's copy of the JAX
// package's cpp/src/socket.cpp, UDP only): create/bind/connect,
// timeouts, SO_REUSEPORT fanout and the batched sendmmsg/recvmmsg
// transfers the capture and transmit engines use.  Also the thread-local
// error detail and the core pin the engines share.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdarg>
#include <cstdio>
#include <cstring>
#include <netdb.h>
#include <netinet/in.h>
#include <pthread.h>
#include <sched.h>
#include <string>
#include <sys/socket.h>
#include <sys/time.h>
#include <sys/types.h>
#include <unistd.h>
#include <vector>

#include "udp_host.h"

namespace btp {

thread_local std::string g_last_error;

void set_last_error(const char* fmt, ...) {
    char buf[1024];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(buf, sizeof(buf), fmt, ap);
    va_end(ap);
    g_last_error = buf;
}

}  // namespace btp

namespace {

struct Resolved {
    sockaddr_storage addr;
    socklen_t len;
};

// recvmmsg availability, probed once per process on a fresh socket:
// sandboxed kernels reject the syscall (EINVAL/ENOSYS), and the engine
// then falls back to a recvmsg loop.  -1 unprobed, 1 works, 0 fallback.
int g_recvmmsg_ok = -1;

// sendmmsg availability, latched on the first real send (an unconnected
// socket cannot be probed without side effects).
int g_sendmmsg_ok = -1;

void probe_recvmmsg(int fd) {
    if (g_recvmmsg_ok >= 0) return;
    // On the fresh, unbound fd no packet can be queued: a working kernel
    // answers EAGAIN, a rejecting one EINVAL/ENOSYS.
    mmsghdr probe;
    iovec piov;
    std::memset(&probe, 0, sizeof(probe));
    char byte = 0;
    piov.iov_base = &byte;
    piov.iov_len = 1;
    probe.msg_hdr.msg_iov = &piov;
    probe.msg_hdr.msg_iovlen = 1;
    int got = ::recvmmsg(fd, &probe, 1, MSG_DONTWAIT, nullptr);
    g_recvmmsg_ok = (got < 0 && (errno == EINVAL || errno == ENOSYS)) ? 0 : 1;
}

Resolved resolve(const char* host, int port) {
    Resolved r;
    std::memset(&r.addr, 0, sizeof(r.addr));
    addrinfo hints;
    std::memset(&hints, 0, sizeof(hints));
    hints.ai_family = AF_UNSPEC;
    hints.ai_flags = AI_NUMERICSERV;
    addrinfo* res = nullptr;
    std::string service = std::to_string(port);
    int rc = ::getaddrinfo(host && host[0] ? host : nullptr, service.c_str(),
                           &hints, &res);
    if (rc != 0 || res == nullptr) {
        throw std::runtime_error(std::string("getaddrinfo: ") +
                                 gai_strerror(rc));
    }
    std::memcpy(&r.addr, res->ai_addr, res->ai_addrlen);
    r.len = res->ai_addrlen;
    ::freeaddrinfo(res);
    return r;
}

}  // namespace

struct BTPsocket_impl {
    int fd = -1;
    double timeout = -1.0;
};

extern "C" {

const char* btpGetLastError(void) { return btp::g_last_error.c_str(); }

BTPstatus btpAffinitySetCore(int core) {
    BTP_TRY_BEGIN
    cpu_set_t cpuset;
    CPU_ZERO(&cpuset);
    long ncore = sysconf(_SC_NPROCESSORS_ONLN);
    if (ncore <= 0) ncore = 1;
    if (core < 0) {
        for (long i = 0; i < ncore; ++i) CPU_SET(i, &cpuset);
    } else {
        if (core >= ncore) {
            btp::set_last_error("core %d out of range (%ld online)", core,
                                ncore);
            return BTP_STATUS_INVALID_ARGUMENT;
        }
        CPU_SET(core, &cpuset);
    }
    int rc = pthread_setaffinity_np(pthread_self(), sizeof(cpuset), &cpuset);
    if (rc != 0) {
        btp::set_last_error("cannot pin thread to core %d: "
                            "pthread_setaffinity_np: %s", core, strerror(rc));
        return rc == EINVAL ? BTP_STATUS_INVALID_ARGUMENT
                            : BTP_STATUS_INTERNAL_ERROR;
    }
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpSocketCreate(BTPsocket* sock) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(sock);
    int fd = ::socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0) {
        btp::set_last_error("socket(): %s", strerror(errno));
        return BTP_STATUS_IO_ERROR;
    }
    int one = 1;
    ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    probe_recvmmsg(fd);
    auto* s = new BTPsocket_impl;
    s->fd = fd;
    *sock = s;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpSocketDestroy(BTPsocket sock) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(sock);
    if (sock->fd >= 0) ::close(sock->fd);
    delete sock;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpSocketEnableReuseport(BTPsocket sock) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(sock);
    // The kernel flow-hashes datagrams across every socket bound to the
    // same addr:port, so several captures split one stream.
    int one = 1;
    if (::setsockopt(sock->fd, SOL_SOCKET, SO_REUSEPORT, &one,
                     sizeof(one)) != 0) {
        btp::set_last_error("setsockopt(SO_REUSEPORT): %s", strerror(errno));
        return BTP_STATUS_IO_ERROR;
    }
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpSocketBind(BTPsocket sock, const char* addr, int port) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(sock);
    Resolved r = resolve(addr, port);
    if (::bind(sock->fd, (sockaddr*)&r.addr, r.len) != 0) {
        btp::set_last_error("bind(%s:%d): %s", addr ? addr : "*", port,
                            strerror(errno));
        return BTP_STATUS_IO_ERROR;
    }
    // A large receive buffer for high-rate capture: it is what rides out
    // a capture thread the scheduler holds off the CPU.  SO_RCVBUFFORCE
    // passes net.core.rmem_max where the process may (CAP_NET_ADMIN);
    // elsewhere SO_RCVBUF takes what the cap allows.
    int bufsz = 64 * 1024 * 1024;
    if (::setsockopt(sock->fd, SOL_SOCKET, SO_RCVBUFFORCE, &bufsz,
                     sizeof(bufsz)) != 0)
        ::setsockopt(sock->fd, SOL_SOCKET, SO_RCVBUF, &bufsz, sizeof(bufsz));
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpSocketConnect(BTPsocket sock, const char* addr, int port) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(sock);
    Resolved r = resolve(addr, port);
    if (::connect(sock->fd, (sockaddr*)&r.addr, r.len) != 0) {
        btp::set_last_error("connect(%s:%d): %s", addr, port,
                            strerror(errno));
        return BTP_STATUS_IO_ERROR;
    }
    int bufsz = 16 * 1024 * 1024;
    ::setsockopt(sock->fd, SOL_SOCKET, SO_SNDBUF, &bufsz, sizeof(bufsz));
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpSocketShutdown(BTPsocket sock) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(sock);
    ::shutdown(sock->fd, SHUT_RDWR);
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpSocketSetTimeout(BTPsocket sock, double secs) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(sock);
    timeval tv;
    tv.tv_sec = (time_t)secs;
    tv.tv_usec = (suseconds_t)((secs - (double)tv.tv_sec) * 1e6);
    if (::setsockopt(sock->fd, SOL_SOCKET, SO_RCVTIMEO, &tv,
                     sizeof(tv)) != 0) {
        btp::set_last_error("SO_RCVTIMEO: %s", strerror(errno));
        return BTP_STATUS_IO_ERROR;
    }
    sock->timeout = secs;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpSocketGetTimeout(BTPsocket sock, double* secs) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(sock);
    BTP_CHECK_PTR(secs);
    *secs = sock->timeout;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpSocketGetMTU(BTPsocket sock, int* mtu) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(sock);
    BTP_CHECK_PTR(mtu);
#ifdef IP_MTU
    int val = 0;
    socklen_t len = sizeof(val);
    if (::getsockopt(sock->fd, IPPROTO_IP, IP_MTU, &val, &len) == 0) {
        *mtu = val;
        return BTP_STATUS_SUCCESS;
    }
#endif
    *mtu = 1500;  // conservative default
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpSocketGetFD(BTPsocket sock, int* fd) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(sock);
    BTP_CHECK_PTR(fd);
    *fd = sock->fd;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpSocketSendMany(BTPsocket sock, unsigned npacket,
                            const void* const* packets,
                            const unsigned* sizes, unsigned* nsent) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(sock);
    BTP_CHECK_PTR(packets);
    BTP_CHECK_PTR(sizes);
    if (nsent) *nsent = 0;
    if (npacket == 0) return BTP_STATUS_SUCCESS;
    // A full socket buffer is back-pressure, not an I/O fault: EAGAIN/
    // ENOBUFS with nothing sent reports WOULD_BLOCK, so a paced sender
    // backs off and retries.
    if (g_sendmmsg_ok != 0) {
        std::vector<mmsghdr> msgs(npacket);
        std::vector<iovec> iovs(npacket);
        std::memset(msgs.data(), 0, npacket * sizeof(mmsghdr));
        for (unsigned i = 0; i < npacket; ++i) {
            iovs[i].iov_base = const_cast<void*>(packets[i]);
            iovs[i].iov_len = sizes[i];
            msgs[i].msg_hdr.msg_iov = &iovs[i];
            msgs[i].msg_hdr.msg_iovlen = 1;
        }
        int sent = ::sendmmsg(sock->fd, msgs.data(), npacket, 0);
        if (sent >= 0) {
            g_sendmmsg_ok = 1;
            if (nsent) *nsent = (unsigned)sent;
            return BTP_STATUS_SUCCESS;
        }
        if (errno == EAGAIN || errno == EWOULDBLOCK || errno == ENOBUFS)
            return BTP_STATUS_WOULD_BLOCK;
        if (errno != EINVAL && errno != ENOSYS) {
            btp::set_last_error("sendmmsg: %s", strerror(errno));
            return BTP_STATUS_IO_ERROR;
        }
        // A kernel that rejects the syscall: latch the per-packet path.
        g_sendmmsg_ok = 0;
    }
    unsigned done = 0;
    while (done < npacket) {
        iovec iov;
        iov.iov_base = const_cast<void*>(packets[done]);
        iov.iov_len = sizes[done];
        msghdr mh;
        std::memset(&mh, 0, sizeof(mh));
        mh.msg_iov = &iov;
        mh.msg_iovlen = 1;
        ssize_t n = ::sendmsg(sock->fd, &mh, 0);
        if (n < 0) {
            if (errno == EINTR) continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK ||
                errno == ENOBUFS) {
                if (done) break;          // short send
                return BTP_STATUS_WOULD_BLOCK;
            }
            if (done) break;              // report what was delivered
            btp::set_last_error("sendmsg: %s", strerror(errno));
            return BTP_STATUS_IO_ERROR;
        }
        ++done;
    }
    if (nsent) *nsent = done;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpSocketBatchSupport(int* recvmmsg_ok, int* sendmmsg_ok) {
    BTP_TRY_BEGIN
    if (recvmmsg_ok) *recvmmsg_ok = g_recvmmsg_ok;
    if (sendmmsg_ok) *sendmmsg_ok = g_sendmmsg_ok;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

BTPstatus btpSocketRecvMany(BTPsocket sock, unsigned npacket,
                            void* const* buffers, const unsigned* capacities,
                            unsigned* sizes, unsigned* nrecv) {
    BTP_TRY_BEGIN
    BTP_CHECK_PTR(sock);
    BTP_CHECK_PTR(buffers);
    BTP_CHECK_PTR(capacities);
    BTP_CHECK_PTR(sizes);
    if (g_recvmmsg_ok != 0) {
        std::vector<mmsghdr> msgs(npacket);
        std::vector<iovec> iovs(npacket);
        std::memset(msgs.data(), 0, npacket * sizeof(mmsghdr));
        for (unsigned i = 0; i < npacket; ++i) {
            iovs[i].iov_base = buffers[i];
            iovs[i].iov_len = capacities[i];
            msgs[i].msg_hdr.msg_iov = &iovs[i];
            msgs[i].msg_hdr.msg_iovlen = 1;
        }
        int got = ::recvmmsg(sock->fd, msgs.data(), npacket, MSG_WAITFORONE,
                             nullptr);
        if (got >= 0) {
            for (int i = 0; i < got; ++i) sizes[i] = msgs[i].msg_len;
            if (nrecv) *nrecv = (unsigned)got;
            return BTP_STATUS_SUCCESS;
        }
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
            if (nrecv) *nrecv = 0;
            return BTP_STATUS_WOULD_BLOCK;
        }
        if (errno != EINVAL && errno != ENOSYS) {
            btp::set_last_error("recvmmsg: %s", strerror(errno));
            return BTP_STATUS_IO_ERROR;
        }
        g_recvmmsg_ok = 0;
    }
    // recvmsg fallback: block for the first packet (honouring
    // SO_RCVTIMEO as MSG_WAITFORONE does), then drain without blocking.
    unsigned got = 0;
    while (got < npacket) {
        iovec iov;
        iov.iov_base = buffers[got];
        iov.iov_len = capacities[got];
        msghdr mh;
        std::memset(&mh, 0, sizeof(mh));
        mh.msg_iov = &iov;
        mh.msg_iovlen = 1;
        ssize_t n = ::recvmsg(sock->fd, &mh, got ? MSG_DONTWAIT : 0);
        if (n < 0) {
            if (errno == EAGAIN || errno == EWOULDBLOCK) {
                if (got) break;
                if (nrecv) *nrecv = 0;
                return BTP_STATUS_WOULD_BLOCK;
            }
            if (errno == EINTR && !got) continue;
            if (got) break;
            btp::set_last_error("recvmsg: %s", strerror(errno));
            return BTP_STATUS_IO_ERROR;
        }
        sizes[got++] = (unsigned)n;
    }
    if (nrecv) *nrecv = got;
    return BTP_STATUS_SUCCESS;
    BTP_TRY_END
}

}  // extern "C"
