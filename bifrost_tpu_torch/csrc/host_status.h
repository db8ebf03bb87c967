/* Status codes, last-error text and the exception guard of the port's
 * host library of the inter-process plane (shmring.cpp).  The codes keep
 * the values of the JAX package's C core, so a status reads the same from
 * either package's binding.
 *
 * The library is one translation unit, so the error text and its setter
 * are `static`: nothing of it is exported, and no symbol of another
 * library loaded in the same process (the JAX package's, with the same
 * function names) can stand in for it.  `BTH_API` marks the C entry points,
 * the only symbols the library exports; the source compiles its internals
 * between `#pragma GCC visibility push(hidden)` and `pop`. */
#pragma once

#include <cstdarg>
#include <cstdio>
#include <exception>
#include <new>
#include <string>

typedef int BTstatus;
enum {
    BT_STATUS_SUCCESS            = 0,
    BT_STATUS_END_OF_DATA        = 1,
    BT_STATUS_WOULD_BLOCK        = 2,
    BT_STATUS_INVALID_POINTER    = 8,
    BT_STATUS_INVALID_ARGUMENT   = 9,
    BT_STATUS_INVALID_STATE      = 10,
    BT_STATUS_MEM_ALLOC_FAILED   = 16,
    BT_STATUS_INSUFFICIENT_SPACE = 18,
    BT_STATUS_INTERRUPTED        = 32,
    BT_STATUS_PEER_DIED          = 41,
    BT_STATUS_INTERNAL_ERROR     = 99,
};

#define BTH_API extern "C" __attribute__((visibility("default")))

static thread_local std::string bth_last_error;

static void set_last_error(const char* fmt, ...)
    __attribute__((format(printf, 1, 2)));
static void set_last_error(const char* fmt, ...) {
    char buf[1024];
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(buf, sizeof(buf), fmt, ap);
    va_end(ap);
    bth_last_error = buf;
}

#define BT_TRY_BEGIN try {
#define BT_TRY_END                                                   \
    }                                                                 \
    catch (const std::bad_alloc&) {                                   \
        set_last_error("out of memory in %s", __func__);              \
        return BT_STATUS_MEM_ALLOC_FAILED;                            \
    }                                                                 \
    catch (const std::exception& e) {                                 \
        set_last_error("%s: %s", __func__, e.what());                 \
        return BT_STATUS_INTERNAL_ERROR;                              \
    }                                                                 \
    catch (...) {                                                     \
        set_last_error("unknown exception in %s", __func__);          \
        return BT_STATUS_INTERNAL_ERROR;                              \
    }

#define BT_CHECK_PTR(p)                                               \
    do {                                                              \
        if ((p) == nullptr) {                                         \
            set_last_error("null pointer argument in %s", __func__);  \
            return BT_STATUS_INVALID_POINTER;                         \
        }                                                             \
    } while (0)
